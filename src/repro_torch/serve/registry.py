"""Tenant session registry: T tenants, K shapes, K compiles.

Each tenant owns a :class:`~repro_torch.api.KGEngine` session over its own
DIS (own sources, own vocab), on the registry's device. Built closures are
NOT per-tenant: the process-wide plan cache keys on the engine's
structural plan signature × capacity buckets, so tenants whose DISes are
structurally identical (same IR fingerprint, same emitter dictionary
codes, same static config) share one closure per bucket — the first
tenant of a shape builds, the rest hit. The registry makes that dedup
*observable*: it groups tenants by
:attr:`~repro_torch.api.KGEngine.plan_signature` and aggregates
:attr:`~repro_torch.api.KGEngine.builds` across sessions, so
``compile_dedup()`` can assert "T tenants over K shapes cost exactly K
compiles".

The shape key is the port's own ``plan_signature``, so ``shape_id``
digests differ from the reference's; the grouping of tenants into shapes
is the same. A configuration holding a mesh makes every session a mesh
session on that mesh's device (:class:`repro_torch.serve.FrontDoor` runs
it as leader and followers); every tenant of a registry shares one mesh.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Optional, Tuple

from repro_torch.api.config import EngineConfig
from repro_torch.api.engine import KGEngine
from repro_torch.core.schema import DIS
from repro_torch.device import DeviceLike, resolve_device

from .stats import LatencyWindow


@dataclasses.dataclass
class TenantSession:
    """One tenant's slot in the front door: its engine session plus the
    per-tenant serving counters ``serve_stats()['per_tenant']`` reports."""

    tenant_id: str
    engine: KGEngine
    shape_key: Tuple                  # engine.plan_signature
    latencies: LatencyWindow
    ingests: int = 0                  # flushes executed for this tenant
    requests: int = 0                 # accepted requests (pre-coalescing)
    rejected: int = 0                 # Overloaded responses returned
    rows: int = 0                     # delta rows folded in
    errors: int = 0                   # flushes that raised
    kg_triples: int = 0               # last reported KG size
    last_kg: object = None            # KG Table from the latest flush

    @property
    def shape_id(self) -> str:
        """Short stable digest of the shape key — the human-readable
        shape handle in stats and logs."""
        return hashlib.sha256(repr(self.shape_key).encode()) \
            .hexdigest()[:12]


class SessionRegistry:
    """Tenant-id → :class:`TenantSession` map with shape bookkeeping.

    ``default_config`` seeds every tenant that registers without an
    explicit :class:`~repro_torch.api.EngineConfig`; per-tenant configs
    may override (tenants under different configs simply land in different
    shape groups — the plan cache keeps them apart anyway). ``device`` is
    every session's device: the CUDA card unless ``"cpu"`` is passed, and
    the mesh's device when ``default_config`` holds a mesh (``mesh``; a
    tenant's config may not name another one).
    """

    def __init__(self, default_config: Optional[EngineConfig] = None,
                 latency_window: int = 4096, device: DeviceLike = None):
        self.default_config = default_config or EngineConfig()
        self.mesh = self.default_config.mesh
        if self.mesh is None:
            self.device = resolve_device(device)
        else:
            self.device = self.mesh.device
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device!r} differs from the "
                                 f"mesh's device {self.device}")
        self._latency_window = int(latency_window)
        self._sessions: Dict[str, TenantSession] = {}

    def register(self, tenant_id: str, dis: DIS,
                 config: Optional[EngineConfig] = None) -> TenantSession:
        """Create the tenant's engine session (plan + optimize now — build
        lazily on first ingest). Re-registering a live tenant id raises —
        silently replacing a session mid-stream would orphan its queued
        requests."""
        tenant_id = str(tenant_id)
        if tenant_id in self._sessions:
            raise ValueError(f"tenant {tenant_id!r} is already registered")
        if config is not None and config.mesh is not self.mesh:
            raise ValueError(f"tenant {tenant_id!r}'s config names another "
                             "mesh than the registry's: every tenant of a "
                             "front door shares one mesh (or none)")
        engine = KGEngine(dis, config=config or self.default_config,
                          device=self.device)
        session = TenantSession(
            tenant_id=tenant_id, engine=engine,
            shape_key=engine.plan_signature,
            latencies=LatencyWindow(self._latency_window))
        self._sessions[tenant_id] = session
        return session

    def get(self, tenant_id: str) -> TenantSession:
        try:
            return self._sessions[str(tenant_id)]
        except KeyError:
            raise KeyError(f"unknown tenant {tenant_id!r} — register the "
                           "tenant's DIS before submitting") from None

    def __contains__(self, tenant_id: str) -> bool:
        return str(tenant_id) in self._sessions

    def __len__(self) -> int:
        return len(self._sessions)

    def sessions(self) -> Tuple[TenantSession, ...]:
        return tuple(self._sessions.values())

    # -- compile dedup -------------------------------------------------------
    def shapes(self) -> Dict[Tuple, int]:
        """shape key → tenant count."""
        out: Dict[Tuple, int] = {}
        for s in self._sessions.values():
            out[s.shape_key] = out.get(s.shape_key, 0) + 1
        return out

    def compiles(self) -> int:
        """Closures actually built across every tenant session —
        plan-cache hits and plan-store rehydrations excluded."""
        return sum(s.engine.builds for s in self._sessions.values())

    def compile_dedup(self) -> Dict[str, object]:
        """The K-compiles-for-T-tenants story as numbers: with T tenants
        over K shapes all inside one capacity bucket, ``compiles == K``
        and ``ratio == T / K``; extra bucket crossings show up as
        ``compiles`` beyond ``shapes``."""
        compiles = self.compiles()
        tenants = len(self._sessions)
        return {"tenants": tenants, "shapes": len(self.shapes()),
                "compiles": compiles,
                "ratio": (tenants / compiles) if compiles else 0.0}
