"""``EngineConfig`` — the one frozen value that configures a session.

Every field is validated in ``__post_init__``: a bad ``engine``/``dedup``/
``mode``/``slack``/``verify`` raises ``ValueError`` naming the field before
any planning work starts. :meth:`EngineConfig.cache_sig` is the static
configuration component of the plan-cache key.

``verify`` is the static-verification level, as in the reference:
``"plan"`` (the default) gates every optimizer rewrite with its soundness
contract and verifies each annotated plan before it is compiled;
``"full"`` also audits the first execution of each new build
(:func:`repro_torch.analysis.audit_closure`); ``"off"`` skips both. The
KG does not depend on it, so it stays out of :meth:`EngineConfig.cache_sig`
(as in the reference): a ``"full"`` session that hits an entry another
session built audits nothing.

``mesh`` / ``mesh_axis`` / ``join_exchange`` / ``calibrate`` configure a
mesh session (:class:`repro_torch.launch.mesh.Mesh`), validated as in the
reference: a mesh must have ``mesh_axis`` among its axes, and
``join_exchange`` must be one of ``"gather"``, ``"repartition"`` or
``"auto"``. Without a mesh, ``join_exchange`` and ``calibrate`` are
accepted and ignored. The mesh's identity and the exchange knob enter the
plan-cache key through the engine's mesh signature, not
:meth:`EngineConfig.cache_sig`.

``plan_store`` is the persistent plan store
(:func:`repro_torch.api.store.resolve_store` normalizes it), as in the
reference: where a session's plans are kept across processes, not what
they compute, so it stays out of :meth:`EngineConfig.cache_sig`.

``jit`` is the reference's switch between a jitted and an eager closure.
The port's closures always run eagerly, so ``jit`` changes nothing in
execution. It is accepted as the reference accepts it (which checks no
value) and keyed in :meth:`EngineConfig.cache_sig`, so sessions that
differ only in ``jit`` never share a cache entry — just as in the
reference.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

#: δ strategies :func:`repro_torch.relalg.ops.dedup_rows` implements
#: (``None`` = engine default, :data:`repro_torch.relalg.DEFAULT_DEDUP`)
DEDUP_STRATEGIES = (None, "lex", "hash")


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Frozen configuration of one :class:`~repro_torch.api.KGEngine`
    session (field semantics are documented on ``KGEngine``)."""

    engine: str = "sdm"
    dedup: Optional[str] = None
    optimize: bool = True
    mode: str = "exact"
    slack: float = 1.0
    mesh: object = None
    mesh_axis: str = "data"
    jit: bool = True
    join_exchange: str = "auto"
    plan_store: object = None
    calibrate: object = False
    verify: str = "plan"

    def __post_init__(self):
        from repro_torch.plan.annotate import JOIN_EXCHANGES
        if self.engine not in ("rmlmapper", "sdm"):
            raise ValueError(f"unknown engine {self.engine!r} "
                             "(expected 'rmlmapper' or 'sdm')")
        if self.dedup not in DEDUP_STRATEGIES:
            raise ValueError(f"unknown dedup strategy {self.dedup!r} "
                             "(expected None, 'lex' or 'hash')")
        if self.mode not in ("exact", "bound"):
            raise ValueError(f"unknown annotate mode {self.mode!r} "
                             "(expected 'exact' or 'bound')")
        try:
            slack = float(self.slack)
        except (TypeError, ValueError):
            raise ValueError(f"bad slack {self.slack!r} (expected a finite "
                             "number >= 1)") from None
        if not math.isfinite(slack) or slack < 1.0:
            raise ValueError(f"bad slack {self.slack!r} (expected a finite "
                             "number >= 1 — capacities below the annotated "
                             "counts would truncate on the first run)")
        object.__setattr__(self, "slack", slack)
        if not isinstance(self.mesh_axis, str) or not self.mesh_axis:
            raise ValueError(f"bad mesh_axis {self.mesh_axis!r} "
                             "(expected a non-empty axis name)")
        if self.mesh is not None:
            axes = tuple(getattr(self.mesh, "shape", {}))
            if self.mesh_axis not in axes:
                raise ValueError(f"mesh_axis {self.mesh_axis!r} is not an "
                                 f"axis of the mesh (axes: {axes})")
        if self.join_exchange not in JOIN_EXCHANGES:
            raise ValueError(f"unknown join exchange "
                             f"{self.join_exchange!r} "
                             f"(expected one of {JOIN_EXCHANGES})")
        if self.verify not in ("off", "plan", "full"):
            raise ValueError(f"unknown verify level {self.verify!r} "
                             "(expected 'off', 'plan' or 'full')")

    def cache_sig(self) -> Tuple:
        """The static configuration component of the plan-cache key —
        every config field that changes the built program and is not
        already covered by the IR fingerprint, the emitter signature or
        the engine's mesh signature (``jit`` included, as in the
        reference, though it is a no-op here)."""
        return (self.engine, self.dedup, self.mode, self.slack, self.jit)
