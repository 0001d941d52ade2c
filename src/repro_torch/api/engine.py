"""``KGEngine`` — the stateful session front door to the MapSDI pipeline.

The paper's framework amortizes: extract knowledge from the mapping rules
once, then semantify large and *growing* sources cheaply::

    engine = KGEngine(dis, config=EngineConfig(engine="sdm", dedup="hash"))
    kg, stats = engine.create_kg()           # plan + build (or cache hit)
    kg, stats = engine.ingest(delta_sources) # micro-batch extension
    ans = engine.query(q)                    # BGP over the session KG
    engine.stats()                           # session counters

Two mechanisms, shared by creation and queries:

* **Plan cache** — built closures are keyed by the structural fingerprint
  of the optimized IR × the emitter's dictionary codes × engine × dedup ×
  the capacity *bucket* of every source extension
  (:data:`repro_torch.api.cache.PLAN_CACHE`). A structurally-identical
  DIS, or the same session re-executing after a within-bucket ingest,
  reuses one closure.
* **Overflow-safe re-execution** — capacities are sized per bucket
  (``annotate`` in ``"exact"`` or ``"bound"`` mode ×
  :func:`repro_torch.relalg.bucket_cap`); the closure reports a truncation
  flag, and the engine rebuilds into the next capacity bucket and re-runs,
  counting ``recompiles``. The KG is never silently wrong.

The session runs on the CUDA card unless ``device="cpu"`` is passed;
without a card and without ``device="cpu"`` it raises
:class:`repro_torch.device.NoCUDADeviceError`.

Static verification (``EngineConfig.verify``, default ``"plan"``) works
as in the reference: every optimizer rewrite is gated by its soundness
contract and every annotated plan is verified before it is compiled
(shard-locally on a mesh); ``"full"`` also audits the first execution of
each new build (:func:`repro_torch.analysis.audit_closure`: host syncs
against the counted reads the plan implies, collectives against the
exchange plan, dtype stability); ``"off"`` skips all of it.

**Mesh sessions** (``mesh=``, a :class:`repro_torch.launch.mesh.Mesh`):
SPMD, one process per shard, the same session in every rank. Every rank
parses the same DIS, keeps its own row block of each source and runs the
whole plan as one per-rank closure
(:func:`repro_torch.plan.mesh.compile_mesh_plan`) with shard-local
capacities (:func:`repro_torch.plan.annotate.annotate_local`); the cache
key extends to the mesh, the per-source shard-local capacity buckets and
the exchange knob, so recompile-on-overflow and bucket-crossing ingests
work as on one device. After each call the ranks agree on the overflow
flags and ``raw`` (one ``all_gather``), gather the KG shards and run one
δ over them, so every rank returns the single-device KG. BGP queries run
the same way (:func:`repro_torch.query.mesh.compile_query_mesh` over this
rank's block of the KG). Wherever a rank's next collective depends on a
decision (the overflow flags, a plan-store hit), the ranks agree on it
first, outside the audited call
(:func:`repro_torch.launch.mesh.gather_values` / ``agree``).

**The persistent plan store** (``plan_store=``, as the reference's second
tier behind the LRU): on a plan-cache miss the session
looks the key up in the store (:mod:`repro_torch.api.store`) before it
annotates, and after every build (overflow rebuilds included) it writes
the entry back. An entry is the plan's node-indexed counts and caps, not
an executable: a hit skips the exact annotation and its host reads, then
rebuilds the closure from the stored caps. Unless ``verify="off"`` the
rehydrated metadata is verified first (``stats()["verify"]
["store_checks"]``). Every failure to load, verify, build or run an entry
is one more ``store_rejects`` followed by a fresh build; caps too small
for the data take the normal exact rebuild. Only ``jit=True`` sessions use
the store, as in the reference. On a mesh the store key names the mesh's
axes and backend, not the rank or the card's index
(:meth:`repro_torch.launch.mesh.Mesh.signature`), so every rank looks up
one entry; each rank loads and checks it, and the entry is adopted only
if every rank got a hit that passed its checks, with the same metadata
(one agreement); otherwise every rank builds fresh. Rank 0 alone writes.
A mesh entry and a one-device entry never adopt each other.
"""
from __future__ import annotations

import functools
import hashlib
import json
import time
import warnings
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.analysis import (AuditReport, audit_closure,
                                  expected_collectives, expected_host_reads,
                                  expected_query_collectives, soundness_gate,
                                  verify_plan, verify_query_plan)
from repro_torch.core.rdfizer import RDFizer
from repro_torch.core.schema import DIS, TRIPLE_ATTRS
from repro_torch.core.transform import TransformStats, plan_mapsdi
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.plan.annotate import annotate, annotate_local
from repro_torch.plan.compile import compile_plan, input_names
from repro_torch.plan.explain import dump_plan, dump_root
from repro_torch.plan.ir import fingerprint
from repro_torch.plan.lower import LogicalPlan, lower
from repro_torch.query import (KG_SOURCE, Query, annotate_query,
                               annotate_query_local, compile_query,
                               compile_query_mesh, lower_query,
                               query_session_key)
from repro_torch.relalg import Table, append_rows, bucket_cap, host_int
from repro_torch.relalg.table import pad_rows

from .cache import PLAN_CACHE, CachedPlan
from .config import EngineConfig
from .store import (SESSION_KEY, canonical, pack_entry_meta, resolve_store,
                    store_envelope, store_key, unpack_entry_meta)

#: sentinel distinguishing "kwarg not passed" from every real value — a
#: bare ``KGEngine(dis)`` must not warn; an explicit legacy kwarg must
_UNSET = object()
_WARNED_LEGACY: set = set()


def _warn_legacy_kwargs(names: Tuple[str, ...]) -> None:
    """One ``DeprecationWarning`` per distinct legacy-kwarg combination
    per process — enough to steer migrations without drowning loops."""
    if names in _WARNED_LEGACY:
        return
    _WARNED_LEGACY.add(names)
    warnings.warn(
        "KGEngine keyword configuration (" + ", ".join(names) + ") is "
        "deprecated; pass config=EngineConfig(...) instead — the legacy "
        "kwargs will be removed once out-of-tree callers have migrated",
        DeprecationWarning, stacklevel=3)


def _to_bucket(table: Table) -> Table:
    """Pad a table's buffer up to its geometric capacity bucket (device
    concat, no host read) — the headroom that keeps small ingests
    shape-stable."""
    cap = bucket_cap(table.capacity)
    if cap == table.capacity:
        return table
    return Table(data=pad_rows(table.data, cap), count=table.count,
                 attrs=table.attrs)


def _emitter_signature(emitter: RDFizer) -> Tuple:
    """Every dictionary code the closure embeds, read off the emitter's
    pre-interned tables: two plans may only share a closure if these
    match."""
    return (emitter.dis.null_code, emitter.rdf_type_code,
            tuple(sorted(emitter._pred.items())),
            tuple(sorted(emitter._class.items())),
            tuple(sorted((str(k), v) for k, v in emitter._const.items())),
            tuple(sorted((str(k), v)
                         for k, v in emitter._subj_const.items())),
            tuple(sorted((str(k), v) for k, v in emitter._sel.items())),
            tuple(sorted(emitter._subject_tmpl.items())),
            tuple(sorted((repr(k), v)
                         for k, v in emitter._tmpl_ids.items())))


class KGEngine:
    """Stateful MapSDI session: cached plans, incremental ingestion,
    overflow-safe re-execution.

    Parameters
    ----------
    dis
        The data integration system. The engine owns a session *view* of
        its sources, moved to ``device`` (``dis`` itself is never
        mutated); ``ingest`` appends to the view.
    config
        An :class:`~repro_torch.api.EngineConfig`: ``engine`` (``"sdm"``
        duplicate-aware per-map δ, or ``"rmlmapper"`` blind generation),
        ``dedup`` (``"lex"`` | ``"hash"`` | None), ``optimize`` (run the
        Rule 1–3 + σ + CSE fixpoint), ``mode`` (``annotate`` mode,
        ``"exact"`` or ``"bound"``), ``slack`` (multiplier on annotated
        counts before bucketing), ``jit`` (keyed, no-op in the eager port),
        ``verify`` (``"plan"`` | ``"full"`` | ``"off"``, the static
        verification level), ``plan_store`` and the mesh fields below.
        The canonical spelling.
    engine, dedup, optimize, mode, slack, jit, verify, mesh, mesh_axis,
    join_exchange, plan_store, calibrate
        The reference's keyword spelling of the same fields: deprecated
        (one ``DeprecationWarning`` per combination per process), folded
        into an ``EngineConfig``; passing them together with ``config``
        raises ``ValueError``.
    mesh / mesh_axis
        A :class:`repro_torch.launch.mesh.Mesh` (made in every rank with
        :func:`repro_torch.launch.mesh.make_mesh`) runs the session SPMD
        over the ranks: see the module docstring. The session's device is
        the mesh's.
    join_exchange
        ⋈ exchange strategy on a mesh (ignored without one): ``"gather"``
        all-gathers the parent side, ``"repartition"`` hash-partitions
        both sides by join key, ``"auto"`` (default) lets the per-join
        cost model pick (:func:`repro_torch.plan.annotate
        .join_exchange_cost`). All three give bit-identical KGs; the knob
        is part of the plan-cache key.
    calibrate
        Measured-bandwidth cost model (ignored without a mesh): ``True``
        times ``all_gather``/``all_to_all`` over the mesh once at session
        start (memoized per process and mesh) and prices every ⋈ exchange
        with the fit; a :class:`repro_torch.launch.mesh.Calibration`
        injects known numbers; ``False`` keeps the static constants. The
        calibration's signature joins the plan-cache key.
    plan_store
        The persistent second tier behind the in-process LRU (see the
        module docstring): ``None`` (default) disables it; ``True`` or
        ``"default"`` uses ``$REPRO_TORCH_PLAN_STORE`` /
        ``~/.cache/repro-torch-plans``; a path or a
        :class:`repro_torch.api.store.PlanStore` uses that store. Requires
        ``jit=True`` (other sessions skip the store); on a mesh every
        rank passes the same store and rank 0 writes it.
    device
        ``None`` (the default) runs on the CUDA card (on a mesh: the
        mesh's device); ``"cpu"`` runs the plain PyTorch path on the CPU.
    """

    def __init__(self, dis: DIS, engine: str = _UNSET,
                 dedup: Optional[str] = _UNSET, *,
                 config: Optional[EngineConfig] = None,
                 device: DeviceLike = None,
                 optimize: bool = _UNSET, mode: str = _UNSET,
                 slack: float = _UNSET, jit: bool = _UNSET,
                 verify: str = _UNSET, mesh=_UNSET, mesh_axis: str = _UNSET,
                 join_exchange: str = _UNSET, plan_store=_UNSET,
                 calibrate=_UNSET):
        legacy = {name: value for name, value in (
            ("engine", engine), ("dedup", dedup), ("optimize", optimize),
            ("mode", mode), ("slack", slack), ("mesh", mesh),
            ("mesh_axis", mesh_axis), ("jit", jit),
            ("join_exchange", join_exchange), ("plan_store", plan_store),
            ("calibrate", calibrate), ("verify", verify))
            if value is not _UNSET}
        if config is not None:
            if legacy:
                raise ValueError(
                    "pass either config=EngineConfig(...) or the legacy "
                    "keyword arguments, not both (got config plus "
                    f"{sorted(legacy)})")
            if not isinstance(config, EngineConfig):
                raise TypeError("config must be an EngineConfig, got "
                                f"{type(config).__name__}")
        else:
            if legacy:
                _warn_legacy_kwargs(tuple(sorted(legacy)))
            config = EngineConfig(**legacy)   # validates every field
        self.config = config
        self.mesh, self.mesh_axis = config.mesh, config.mesh_axis
        self.join_exchange = config.join_exchange
        if self.mesh is None:
            self.device: torch.device = resolve_device(device)
        else:
            self.device = self.mesh.device
            if device is not None and resolve_device(device) != self.device:
                raise ValueError(f"device {device!r} differs from the "
                                 f"mesh's device {self.device}")
        # measured-bandwidth cost model (mesh only): True times the mesh's
        # collectives once (memoized per process and mesh); a Calibration
        # injects known numbers; False keeps the static constants
        self.calibration = None
        if self.mesh is not None and config.calibrate is not False:
            from repro_torch.launch.mesh import Calibration, calibrate_mesh
            self.calibration = (config.calibrate
                                if isinstance(config.calibrate, Calibration)
                                else calibrate_mesh(self.mesh,
                                                    self.mesh_axis))
        self.engine, self.dedup = config.engine, config.dedup
        self.optimize, self.mode = config.optimize, config.mode
        self.slack = config.slack
        # static verification level: "plan" (default) gates every rewrite
        # with its soundness contract and verifies each annotated plan
        # before compiling; "full" also audits the first execution of each
        # new build; "off" disables all of it
        self.verify = config.verify
        self._verify_plan_checks = 0
        self._verify_audits = 0
        self._verify_store_checks = 0
        self._store = resolve_store(config.plan_store)
        self.jit = config.jit
        # hits, misses and rejects of the KG tier and the query tier
        self._store_counts = {
            tier: dict.fromkeys(("hits", "misses", "rejects"), 0)
            for tier in ("kg", "query")}
        #: the report of the session's latest audit (``verify="full"``)
        self.last_audit: Optional[AuditReport] = None
        self._dis = dis.copy()
        # session view of the extensions, on the session device and
        # re-buffered into geometric capacity buckets so within-bucket
        # ingests never change shapes
        self._dis.sources = {name: _to_bucket(t.to(self.device))
                             for name, t in dis.sources.items()}
        self.sources: Dict[str, Table] = self._dis.sources
        self._tstats = TransformStats()
        t0 = time.perf_counter()
        self._plan = (plan_mapsdi(self._dis, stats=self._tstats,
                                  gate=self._rewrite_gate())
                      if self.optimize else lower(self._dis))
        # the session emitter is built over the rewritten maps, in the
        # reference's order, so vocab growth (and so every embedded code)
        # matches it
        view = self._dis.copy()
        view.maps = list(self._plan.maps)
        self._emitter = RDFizer(view, self.engine, join_caps={},
                                dedup=self.dedup)
        view.sources = {}   # cached closures must not pin device tables
        self._ir_fp = fingerprint(self._plan.emits())
        self._emit_sig = _emitter_signature(self._emitter)
        self._plan_seconds = time.perf_counter() - t0
        # mesh sessions keep each source's row block device-resident
        # between runs, keyed on the source Table's identity (an ingest's
        # append_rows replaces it, so it re-shards)
        self._shard_cache: Dict[str, Tuple] = {}
        self._scan_names_cache: Optional[Tuple[str, ...]] = None
        self._mesh_static = None if self.mesh is None else (
            self.mesh.key(), self.mesh_axis)
        # sticky per-session escalation: once key or hash skew forced a
        # safe-capacity rebuild, later builds start safe
        self._safe_exchange = False
        # mesh closure calls, and the collectives they ran by the count
        # expected_collectives (expected_query_collectives) gives each
        # creation (query) call
        self._mesh_calls = 0
        self._mesh_collectives: Dict[str, int] = {"all_gather": 0,
                                                   "all_to_all": 0}
        self._q_mesh_calls = 0
        self._q_mesh_collectives: Dict[str, int] = {"all_gather": 0,
                                                     "all_to_all": 0}
        if self.mesh is not None:
            self._check_ranks_agree()
        self._have_plan = False     # a closure has been obtained (any way)
        self._builds = 0            # closures built by this session
        self._recompiles = 0        # builds beyond the session's first
        self._executions = 0
        self._ingests = 0
        self._ingested_rows = 0
        self._cache_hits = 0
        self._cache_misses = 0
        self._last: Dict[str, object] = {}
        # query tier (KGEngine.query): the session KG the BGP engine reads,
        # its capacity-bucketed view (identity-keyed — a new KG from
        # run()/ingest() re-buckets), and the per-session query counters
        # surfaced as ``stats()["query"]``
        self._kg: Optional[Table] = None
        self._kg_bucket: Optional[Tuple[Table, Table]] = None
        # mesh: this rank's block of the bucketed KG (identity-keyed), and
        # the query tier's sticky safe-exchange escalation
        self._kg_shard: Optional[Tuple] = None
        self._q_safe_exchange = False
        self._q_executions = 0
        self._q_cache_hits = 0
        self._q_cache_misses = 0
        self._q_recompiles = 0
        self._q_last: Dict[str, object] = {}

    # -- plan cache ----------------------------------------------------------
    @property
    def plan(self) -> LogicalPlan:
        """The optimized :class:`~repro_torch.plan.lower.LogicalPlan`."""
        return self._plan

    @property
    def plan_signature(self) -> Tuple:
        """The session's *shape*: structural IR fingerprint × emitter
        dictionary codes × static config signature — every plan-cache key
        component except the (data-dependent) source capacity buckets. Two
        sessions with equal signatures share built closures
        bucket-for-bucket."""
        return (self._ir_fp, self._emit_sig) + self.config.cache_sig()

    @property
    def builds(self) -> int:
        """Closures built *by this session* (plan-cache hits and plan-store
        rehydrations excluded) — the denominator of the serve layer's
        compile-dedup ratio."""
        return self._builds

    @property
    def recompiles(self) -> int:
        """Builds beyond the session's first (capacity-bucket crossings,
        overflow rebuilds)."""
        return self._recompiles

    def explain(self) -> str:
        """Annotated plan tree over the session's current sources; unless
        ``verify="off"`` it carries the verifier's verdict and each node's
        ``cols=``. On a mesh session every ⋈ line also shows the exchange
        decision and the estimated per-device wire bytes of both
        strategies: once a closure has been built, the built entry's
        counts, caps and exchanges (what the closure runs); before that,
        a prediction with the session's mode, slack, bucketing and sticky
        safe-exchange state."""
        exchanges = None
        if self.mesh is None:
            counts, caps = annotate(self._plan)
        else:
            entry = self._last.get("entry") if self._last else None
            if entry is not None and entry.exchanges is not None:
                counts, caps = entry.counts, entry.caps
                exchanges = entry.exchanges
            else:
                counts, caps, exchanges = annotate_local(
                    self._plan, n_shards=self.n_shards,
                    cap_locals=self._cap_locals(self.sources),
                    mode=self.mode, slack=self.slack, cap_fn=bucket_cap,
                    sources=self.sources, join_exchange=self.join_exchange,
                    safe_exchange=self._safe_exchange,
                    calibration=self.calibration)
        schemas = verdict = None
        if self.verify != "off":
            report = verify_plan(
                self._plan, self.engine, counts=counts, caps=caps,
                sources=self.sources, shard_local=self.mesh is not None,
                slack=self.slack, check_canonical=self.optimize,
                check_cse=self.optimize)
            schemas, verdict = report.schemas, report.describe()
        return dump_plan(self._plan, self.engine, counts, caps, exchanges,
                         schemas=schemas, verdict=verdict)

    def _source_sig(self, sources: Mapping[str, Table]) -> Tuple:
        return tuple(sorted(
            (name, t.capacity, tuple(t.attrs), bucket_cap(host_int(t.count)))
            for name, t in sources.items()))

    @property
    def n_shards(self) -> int:
        """Ranks along the mesh axis (1 without a mesh)."""
        return 1 if self.mesh is None else int(self.mesh.shape[self.mesh_axis])

    def _cap_locals(self, sources: Mapping[str, Table]) -> Dict[str, int]:
        """Per-rank row-block capacity bucket per scanned source — part of
        the mesh cache key (a source crossing its shard-local bucket gets
        a freshly shaped closure)."""
        n = self.n_shards
        return {name: bucket_cap(-(-sources[name].capacity // n))
                for name in self._scan_names}

    @property
    def _scan_names(self) -> Tuple[str, ...]:
        """Source names the current plan scans (cached per plan)."""
        if self._scan_names_cache is None:
            from repro_torch.plan.mesh import plan_scans
            self._scan_names_cache = tuple(sorted(plan_scans(self._plan)))
        return self._scan_names_cache

    def _mesh_sig(self, sources: Mapping[str, Table]) -> Optional[Tuple]:
        """Mesh part of the cache key: the mesh's identity (static), the
        per-source shard-local capacity buckets, the u16-packability of
        the vocab (baked into every exchange's payload), the ⋈ exchange
        knob and the calibration's signature."""
        if self.mesh is None:
            return None
        cal_sig = (None if self.calibration is None
                   else self.calibration.signature())
        return self._mesh_static + (
            tuple(sorted(self._cap_locals(sources).items())),
            len(self._dis.vocab) < (1 << 16), self.join_exchange, cal_sig)

    def _key(self, sources: Mapping[str, Table]) -> Tuple:
        return (self._ir_fp, self._emit_sig) + self.config.cache_sig() + (
            self._mesh_sig(sources), self._source_sig(sources))

    def _check_ranks_agree(self) -> None:
        """Every rank parsed the same DIS: the plan fingerprint and the
        vocabulary size must agree across ranks (one ``all_gather``, at
        session start, outside any audited call), else raise."""
        from repro_torch.launch.mesh import agree
        try:
            agree(self.mesh, self.mesh_axis,
                  (int(self._ir_fp[:15], 16), len(self._dis.vocab)),
                  what="the plan fingerprint prefix and the vocab size")
        except RuntimeError as e:
            raise RuntimeError(
                f"the ranks of the mesh hold different plans or "
                f"vocabularies: {e}; every rank must parse the same DIS "
                "from the same inputs") from None

    def _rewrite_gate(self):
        """The optimizer's per-rewrite soundness hook (``None`` when
        verification is off)."""
        return None if self.verify == "off" else soundness_gate

    def _verify_built(self, counts, caps, sources) -> None:
        """Statically verify the annotated plan before it is compiled
        (shard-locally on a mesh); a failure raises
        :class:`repro_torch.analysis.PlanVerificationError` (a malformed
        plan must never reach the device, let alone a KG)."""
        if self.verify == "off":
            return
        verify_plan(self._plan, self.engine, counts=counts, caps=caps,
                    sources=sources, shard_local=self.mesh is not None,
                    slack=self.slack, check_canonical=self.optimize,
                    check_cse=self.optimize).raise_for_status()
        self._verify_plan_checks += 1

    def _replan(self) -> None:
        """Re-lower/re-optimize after a provenance change (σ-baked flags
        dropped by :meth:`ingest`); the cache key follows the new plan."""
        t0 = time.perf_counter()
        self._plan = (plan_mapsdi(self._dis, gate=self._rewrite_gate())
                      if self.optimize else lower(self._dis))
        self._ir_fp = fingerprint(self._plan.emits())
        self._scan_names_cache = None   # the new plan may scan differently
        self._plan_seconds += time.perf_counter() - t0

    def _slim_plan(self) -> LogicalPlan:
        """The plan as cache entries hold it: same nodes and maps, but a
        DIS stub without the source extensions."""
        stub = self._dis.copy()
        stub.sources = {}
        return LogicalPlan(dis=stub, maps=list(self._plan.maps),
                           inputs=dict(self._plan.inputs),
                           names=dict(self._plan.names),
                           preprocessed=self._plan.preprocessed,
                           sigma_baked=self._plan.sigma_baked)

    def _build(self, key: Tuple, sources: Mapping[str, Table],
               mode: Optional[str] = None,
               floor_caps: Optional[Mapping] = None,
               sink_slack: float = 1.0,
               safe_exchange: bool = False) -> CachedPlan:
        t0 = time.perf_counter()
        mode = mode or self.mode
        if self.mesh is None:
            counts, caps = annotate(self._plan, mode=mode, slack=self.slack,
                                    cap_fn=bucket_cap, sources=sources)
            exchanges = cap_locals = None
        else:
            safe_exchange = safe_exchange or self._safe_exchange
            self._safe_exchange = safe_exchange
            cap_locals = self._cap_locals(sources)
            counts, caps, exchanges = annotate_local(
                self._plan, n_shards=self.n_shards, cap_locals=cap_locals,
                mode=mode, slack=self.slack, cap_fn=bucket_cap,
                sources=sources, join_exchange=self.join_exchange,
                safe_exchange=safe_exchange, calibration=self.calibration)
        if floor_caps:  # growth must be monotone or overflow ping-pongs
            caps = {n: max(c, floor_caps.get(n, 0)) for n, c in caps.items()}
        self._verify_built(counts, caps, sources)
        plan = self._slim_plan()
        if self.mesh is None:
            fn = compile_plan(plan, self._emitter, engine=self.engine,
                              dedup=self.dedup, caps=caps,
                              report_overflow=True)
        else:
            from repro_torch.plan.mesh import compile_mesh_plan
            fn = compile_mesh_plan(
                plan, self._emitter, self.mesh, self.mesh_axis,
                engine=self.engine, dedup=self.dedup, caps=caps,
                cap_locals=cap_locals, sink_slack=sink_slack,
                pack_u16=len(self._dis.vocab) < (1 << 16),
                exchanges=exchanges, safe_exchange=safe_exchange)
        entry = CachedPlan(key=key, plan=plan, emitter=self._emitter,
                           counts=counts, caps=caps, fn=fn,
                           engine=self.engine, dedup=self.dedup, mode=mode,
                           build_seconds=time.perf_counter() - t0,
                           cap_locals=cap_locals, sink_slack=sink_slack,
                           exchanges=exchanges, safe_exchange=safe_exchange)
        PLAN_CACHE.put(key, entry)
        self._builds += 1
        if self.mesh is None:   # a mesh entry is saved after its first run
            self._store_save(entry)
        if self._have_plan:
            self._recompiles += 1
        return entry

    # -- persistent plan store ----------------------------------------------
    def _uses_store(self) -> bool:
        return self._store is not None and self.jit

    def _store_session_key(self, key: Tuple) -> Tuple:
        """The plan-cache key as the store keys it: on a mesh, the mesh's
        rank-free :meth:`~repro_torch.launch.mesh.Mesh.signature` in place
        of its in-process identity (which names the rank and the device
        index), so every rank computes one store key."""
        if self.mesh is None:
            return key
        mine, shared = self.mesh.key(), self.mesh.signature()

        def swap(x):
            if x == mine:
                return shared
            return tuple(swap(v) for v in x) if isinstance(x, tuple) else x
        return swap(key)

    def _store_save(self, entry: CachedPlan) -> None:
        """Write a freshly built entry back to the persistent store (on a
        mesh, rank 0 alone) — best-effort: any serialization or IO failure
        is counted, never raised (a full disk must not take the session
        down)."""
        if not self._uses_store() or (self.mesh is not None
                                      and self.mesh.rank != 0):
            return
        store = self._store
        try:
            env = store_envelope(self.device, self.calibration)
            skey = self._store_session_key(entry.key)
            store.save(store_key(skey, env), env,
                       pack_entry_meta(entry, entry.plan),
                       {SESSION_KEY: canonical(skey).encode()})
        except Exception:
            store.write_errors += 1

    def _store_load(self, tier: str, key: Tuple, plan, emitter, verify,
                    build, cap_locals=None) -> Optional[CachedPlan]:
        """Second-tier lookup of ``key`` for the ``tier`` (``"kg"`` or
        ``"query"``): validate the entry, unpack its node-indexed metadata
        against ``plan`` (this process's freshly lowered DAG), verify it
        unless ``verify="off"`` (``verify(counts, caps)`` returns a
        report), then build the closure with ``build(unpacked)`` — no
        annotation. ``cap_locals`` is what a mesh entry's shard layout
        must be (``None`` on one device). Returns ``None`` (and counts a
        miss or reject) whenever anything is off; the caller then builds
        fresh, so a bad store can delay but never corrupt a session.

        On a mesh the ranks then agree (one ``all_gather``): the entry is
        adopted only if every rank got a hit that passed its checks with
        the same metadata; otherwise every rank counts its own miss or
        reject (a hit that a peer did not share counts as a reject) and
        builds fresh, so no rank runs a closure another rank rejected."""
        if not self._uses_store():
            return None
        status, entry, digest = self._store_try(key, plan, emitter, verify,
                                                build, cap_locals)
        if self.mesh is not None:
            from repro_torch.launch.mesh import gather_values
            codes = {"hit": 0, "miss": 1, "reject": 2}
            rows = gather_values(self.mesh, self.mesh_axis,
                                 (codes[status], digest))
            if status == "hit" and not all(
                    int(r[0]) == 0 and int(r[1]) == digest for r in rows):
                status, entry = "reject", None
                self._store._reject("a peer rank missed or rejected the "
                                    "entry, or holds other metadata")
        self._store_counts[tier][{"hit": "hits", "miss": "misses",
                                  "reject": "rejects"}[status]] += 1
        if entry is not None:
            if entry.safe_exchange:   # keep the sticky escalation
                if tier == "kg":
                    self._safe_exchange = True
                else:
                    self._q_safe_exchange = True
            PLAN_CACHE.put(key, entry)
        return entry

    def _store_try(self, key: Tuple, plan, emitter, verify, build,
                   cap_locals) -> Tuple[str, Optional[CachedPlan], int]:
        """This rank's half of :meth:`_store_load`: ``(status, entry,
        digest)``, the digest a 62-bit tag of the adopted metadata (0
        unless a hit)."""
        try:
            env = store_envelope(self.device, self.calibration)
            skey = self._store_session_key(key)
            hkey = store_key(skey, env)
        except TypeError:       # a non-canonical key component: no store
            return "reject", None, 0
        res = self._store.load(hkey, env)
        if res.status != "hit":
            return res.status, None, 0
        t0 = time.perf_counter()
        try:
            meta = res.header["meta"]
            if res.payloads.get(SESSION_KEY) != canonical(skey).encode():
                raise ValueError("session key mismatch")
            if meta.get("engine") != self.engine or \
                    meta.get("dedup") != self.dedup:
                raise ValueError("entry engine/dedup mismatch")
            unpacked = unpack_entry_meta(meta, plan)
            if ("cap_locals" in unpacked) != (self.mesh is not None):
                raise ValueError("mesh/single-device entry mismatch")
            if cap_locals is not None and \
                    unpacked["cap_locals"] != dict(cap_locals):
                raise ValueError("stored shard layout differs from the "
                                 "session's")
            if any(c < 0 for c in unpacked["caps"].values()):
                # not a closure that can be built, whatever ``verify`` says
                raise ValueError("negative stored capacity")
            if self.verify != "off":
                # the stored node-index lists mapped onto THIS process's
                # DAG must still describe a well-formed plan — a colliding
                # or corrupted entry that slipped past the checksums
                # rejects here
                report = verify(unpacked["counts"], unpacked["caps"])
                if not report.ok:
                    raise ValueError(
                        "stored plan metadata failed static verification: "
                        + "; ".join(str(d) for d in report.diagnostics[:3]))
                self._verify_store_checks += 1
            fn = build(unpacked)
        except Exception as e:  # rehydration failure degrades to a build
            self._store._reject(f"rehydrate: {type(e).__name__}: {e}")
            return "reject", None, 0
        entry = CachedPlan(key=key, plan=plan, emitter=emitter,
                           counts=unpacked["counts"], caps=unpacked["caps"],
                           fn=fn, engine=self.engine, dedup=self.dedup,
                           mode=unpacked["mode"],
                           build_seconds=time.perf_counter() - t0,
                           cap_locals=unpacked.get("cap_locals"),
                           out_cap_local=unpacked.get("out_cap_local"),
                           sink_slack=unpacked.get("sink_slack", 1.0),
                           exchanges=unpacked.get("exchanges"),
                           safe_exchange=unpacked.get("safe_exchange",
                                                      False),
                           origin="store")
        tagged = {k: v for k, v in meta.items() if k != "build_seconds"}
        digest = int.from_bytes(hashlib.sha256(json.dumps(
            tagged, sort_keys=True).encode()).digest()[:8], "big") >> 2
        return "hit", entry, digest

    def _store_run_failed(self, tier: str, err: Exception) -> None:
        """A rehydrated entry whose closure failed to run here: one more
        reject of ``tier`` (the caller rebuilds fresh)."""
        self._store_counts[tier]["rejects"] += 1
        self._store._reject(f"run: {type(err).__name__}: {err}")

    def _ensure(self, sources: Mapping[str, Table]) -> Tuple[CachedPlan, bool]:
        key = self._key(sources)
        entry = PLAN_CACHE.get(key)
        hit = entry is not None
        if hit:
            self._cache_hits += 1
        else:
            self._cache_misses += 1
            entry = self._store_load(
                "kg", key, self._slim_plan(), self._emitter,
                lambda counts, caps: verify_plan(
                    self._plan, self.engine, counts=counts, caps=caps,
                    sources=sources, shard_local=self.mesh is not None,
                    slack=self.slack, check_canonical=self.optimize,
                    check_cse=self.optimize),
                self._rebuild_kg_closure,
                cap_locals=(None if self.mesh is None
                            else self._cap_locals(sources)))
            if entry is None:
                entry = self._build(key, sources)
        self._have_plan = True
        return entry, hit

    def _rebuild_kg_closure(self, unpacked: Mapping[str, object]):
        """The KG closure of a store entry, built from its stored caps
        (and, on a mesh, its shard layout and exchanges)."""
        plan = self._slim_plan()
        if self.mesh is None:
            return compile_plan(plan, self._emitter, engine=self.engine,
                                dedup=self.dedup, caps=unpacked["caps"],
                                report_overflow=True)
        from repro_torch.plan.mesh import compile_mesh_plan
        return compile_mesh_plan(
            plan, self._emitter, self.mesh, self.mesh_axis,
            engine=self.engine, dedup=self.dedup, caps=unpacked["caps"],
            cap_locals=unpacked["cap_locals"],
            sink_slack=unpacked["sink_slack"],
            pack_u16=len(self._dis.vocab) < (1 << 16),
            exchanges=unpacked["exchanges"],
            safe_exchange=unpacked["safe_exchange"])

    # -- execution -----------------------------------------------------------
    def _execute(self, step, args, fresh: bool, **expect):
        """``step(*args)``: one closure call (plus, on one device, the read
        of its overflow flag). Under ``verify="full"`` the first execution
        of a freshly built entry *is* the audited run (no extra
        execution), so the session's device work and counted reads equal
        an ``"off"`` session's. ``expect`` holds the audit's expectations
        (:func:`repro_torch.analysis.audit_closure`'s ``plan``/``engine``/
        ``n_shards``/``exchanges``/``expected_counts`` and
        ``expected_host_reads``)."""
        if not (fresh and self.verify == "full"):
            return step(*args)
        report = audit_closure(step, args, single_device=self.mesh is None,
                               **expect)
        result, report.result = report.result, None
        self.last_audit = report
        report.raise_for_status()
        self._verify_audits += 1
        return result

    def _run_entry(self, entry: CachedPlan, sources, fresh: bool):
        def step(srcs):
            kg, raw, over = entry.fn(srcs)
            return kg, raw, host_int(over)
        return self._execute(step, (sources,), fresh, plan=entry.plan,
                             engine=self.engine,
                             expected_host_reads=functools.partial(
                                 expected_host_reads, entry.plan,
                                 self.engine, self.dedup))

    def run(self, sources: Optional[Mapping[str, Table]] = None
            ) -> Tuple[Table, torch.Tensor]:
        """Execute the (cached) plan over ``sources`` (default: the session
        sources, others are moved to the session device); rebuilds into
        bigger capacities when the closure reports truncation. Returns
        ``(kg, raw_count)``."""
        sources = (self.sources if sources is None else
                   {name: t.to(self.device) for name, t in sources.items()})
        first = not self._have_plan
        t0 = time.perf_counter()
        entry, hit = self._ensure(sources)
        plan_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        if self.mesh is not None:
            kg, raw, entry, hit = self._run_mesh(entry, sources, hit)
        else:
            try:
                kg, raw, over = self._run_entry(
                    entry, sources, fresh=not hit and entry.origin == "build")
            except Exception as e:
                # a store entry whose caps build a closure that cannot run
                # here is one more store reject: rebuild fresh, never crash
                if entry.origin != "store":
                    raise
                self._store_run_failed("kg", e)
                hit = False
                entry = self._build(entry.key, sources)
                kg, raw, over = self._run_entry(entry, sources, fresh=True)
            if over:
                # some buffer was truncated: re-annotate exactly against
                # the *current* extension, grow caps monotonically, re-run
                # — the one rebuild per capacity-bucket crossing
                hit = False   # the hit did not serve this execution
                entry = self._build(entry.key, sources, mode="exact",
                                    floor_caps=entry.caps)
                kg, raw, over = self._run_entry(entry, sources, fresh=True)
                if over:  # exact caps cannot under-size
                    raise RuntimeError("capacity overflow persisted after "
                                       "rebuild — please report")
        exec_s = time.perf_counter() - t1
        self._executions += 1
        self._last = {"entry": entry, "cache_hit": hit, "first": first,
                      "plan_seconds": plan_s, "exec_seconds": exec_s,
                      "sources": sources}
        self._kg = kg          # the device-resident KG the query tier reads
        return kg, raw

    __call__ = run

    def create_kg(self) -> Tuple[Table, Dict[str, object]]:
        """Plan (or reuse) + execute; returns ``(KG, stats)`` with the
        Table-1-style sizes plus the session's cache/recompile counters.
        ``source_rows_after`` is recounted against the *current*
        extension."""
        before = {k: host_int(v.count) for k, v in self.sources.items()}
        kg, raw = self.run()
        return kg, self._run_stats(kg, raw, source_rows_before=before,
                                   exact_rows=True)

    def ingest(self, deltas: Mapping[str, Table]
               ) -> Tuple[Table, Dict[str, object]]:
        """Append extension rows and re-execute (micro-batch/streaming).

        ``deltas`` maps source names to tables of *new* rows (columns
        aligned by name, encoded with the session's vocab, e.g. via
        ``Table.from_records(..., vocab=engine.vocab)``). Appends are
        shape-stable inside a capacity bucket, so re-execution reuses the
        cached closure; crossing a bucket (or overflowing an interior
        buffer) costs exactly one rebuild. Returns ``(KG, stats)`` over the
        accumulated sources.
        """
        # validate the whole batch before touching any session state
        unknown = sorted(set(deltas) - set(self.sources))
        if unknown:
            raise KeyError(f"unknown source(s) {unknown}")
        # σ-baked provenance only certifies the *materialized* rows; raw
        # delta rows may violate the owning maps' selections
        tainted = {name for name in deltas
                   if name in self._dis.sigma_baked}
        if tainted:
            self._dis.sigma_baked -= tainted
            self._replan()
        for name, delta in deltas.items():
            self.sources[name] = append_rows(self.sources[name], delta)
            self._ingested_rows += host_int(delta.count)
        self._ingests += 1
        kg, raw = self.run()
        return kg, self._run_stats(kg, raw)

    # -- fused distributed execution -----------------------------------------
    def _shard_sources(self, sources: Mapping[str, Table],
                       cap_locals: Mapping[str, int]) -> Tuple[Dict, Dict]:
        """This rank's row block of each scanned source (the one place
        source rows are distributed). Session sources are cached
        device-side keyed on the Table object's identity, so a
        replacement (an ingest's ``append_rows``) or a shard-bucket change
        re-shards, while untouched sources reuse their blocks."""
        from repro_torch.core.distributed import shard_table
        own = sources is self.sources
        datas: Dict[str, torch.Tensor] = {}
        counts: Dict[str, torch.Tensor] = {}
        for name in sorted(cap_locals):
            cap, table = cap_locals[name], sources[name]
            if own:
                hit = self._shard_cache.get(name)
                if hit is not None and hit[0] == cap and hit[1] is table:
                    datas[name], counts[name] = hit[2], hit[3]
                    continue
            d, c, _ = shard_table(table, self.mesh, self.mesh_axis,
                                  cap_local=cap)
            if own:
                self._shard_cache[name] = (cap, table, d, c)
            datas[name], counts[name] = d, c
        return datas, counts

    def _run_mesh_entry(self, entry: CachedPlan, sources, fresh: bool):
        """One call of the per-rank closure, then the ranks' agreement:
        one ``all_gather`` of (raw, overflowed, sink overflowed, KG count)
        and one counted host read of it, both after the (audited) call.
        Returns ``(kg shard, KG counts per rank, raw, overflowed, sink
        overflowed)`` with the last three summed / or-ed over ranks. The
        first call of a freshly built entry gives its ``out_cap_local``
        (the rows of its output block), and then the entry is written to
        the plan store."""
        from repro_torch.launch.mesh import gather_values
        datas, counts = self._shard_sources(sources, entry.cap_locals)
        self._mesh_calls += 1
        for name, k in expected_collectives(
                entry.plan, self.engine, self.n_shards,
                entry.exchanges).items():
            self._mesh_collectives[name] += k
        kg_d, kg_c, raw, over, sink_over = self._execute(
            entry.fn, (datas, counts), fresh, plan=entry.plan,
            engine=self.engine, n_shards=self.n_shards,
            exchanges=entry.exchanges,
            expected_host_reads=functools.partial(
                expected_host_reads, entry.plan, self.engine, self.dedup,
                n_shards=self.n_shards))
        if entry.out_cap_local is None:
            # written before the agreement, so a peer that passes it finds
            # the entry on disk
            entry.out_cap_local = int(kg_d.shape[0])
            self._store_save(entry)
        agreed = gather_values(self.mesh, self.mesh_axis, torch.stack([
            raw.to(torch.int32), over.to(torch.int32),
            sink_over.to(torch.int32), kg_c.to(torch.int32)]))
        return (kg_d, [int(c) for c in agreed[:, 3]], int(agreed[:, 0].sum()),
                bool(agreed[:, 1].any()), bool(agreed[:, 2].any()))

    def _run_mesh(self, entry: CachedPlan, sources: Mapping[str, Table],
                  hit: bool):
        """Execute the per-rank closure; rebuild on (shard-local)
        capacity or exchange overflow (at most once, escalating to
        ``safe_exchange``: exact global counts as post-exchange caps and
        hard-safe exchange buckets are true bounds) or sink-δ bucket
        overflow (at most once more, 4× the sink slack); every rank takes
        the same branch, since the flags are agreed first. Then gather
        the KG shards and run one δ over them, which puts the rows in the
        single-device KG's order (both end in the same δ)."""
        import torch.distributed as dist

        from repro_torch.core.distributed import unshard_rows
        from repro_torch.relalg import distinct
        from repro_torch.relalg.table import round_cap
        kg_d, kg_counts, raw, over, sink_over = self._run_mesh_entry(
            entry, sources, fresh=not hit and entry.origin == "build")
        for _ in range(2):   # ≤1 capacity recompile + ≤1 sink-slack growth
            if not (over or sink_over):
                break
            hit = False   # the hit did not actually serve this execution
            # floors are the current entry's caps (growth must be
            # monotone), and a sink-only rebuild keeps the mode a
            # capacity rebuild escalated to
            entry = self._build(
                entry.key, sources, mode="exact" if over else entry.mode,
                floor_caps=entry.caps,
                sink_slack=entry.sink_slack * (4.0 if sink_over else 1.0),
                safe_exchange=over or entry.safe_exchange)
            kg_d, kg_counts, raw, over, sink_over = self._run_mesh_entry(
                entry, sources, fresh=True)
        if over:   # exact shard-local caps cannot under-size
            raise RuntimeError("mesh capacity overflow persisted after "
                               "recompile — please report")
        if sink_over:
            raise RuntimeError("distributed δ bucket overflow at "
                               f"slack={entry.sink_slack:g}")
        # the final KG: every rank's shard, then one δ
        shards = [torch.empty_like(kg_d) for _ in range(self.n_shards)]
        dist.all_gather(shards, kg_d.contiguous(),
                        group=self.mesh.group_for(self.mesh_axis))
        rows = unshard_rows(torch.cat(shards), kg_counts, kg_d.shape[0])
        total = rows.shape[0]
        kg = distinct(Table(data=pad_rows(rows, round_cap(total)),
                            count=torch.full((), total, dtype=torch.int32,
                                             device=self.device),
                            attrs=TRIPLE_ATTRS), dedup=self.dedup)
        raw_t = torch.full((), raw, dtype=torch.int32, device=self.device)
        return kg, raw_t, entry, hit

    # -- queries -------------------------------------------------------------
    def _kg_table(self, kg: Optional[Table]) -> Table:
        """Resolve + bucket the KG table a query reads: the session KG by
        default (materialized on first use), an explicit ``kg=`` override
        (moved to the session device) otherwise. The bucketed view is
        cached on the KG object's identity, so repeated queries over one
        KG share a buffer (and, on a mesh, this rank's block)."""
        if kg is None:
            if self._kg is None:
                self.run()          # materialize the session KG first
            kg = self._kg
        if tuple(kg.attrs) != TRIPLE_ATTRS:
            raise ValueError("query target must be a coded KG table with "
                             f"attrs {TRIPLE_ATTRS}, got {tuple(kg.attrs)}")
        hit = self._kg_bucket
        if hit is not None and hit[0] is kg:
            return hit[1]
        bucketed = _to_bucket(kg.to(self.device))
        self._kg_bucket = (kg, bucketed)
        return bucketed

    def _kg_cap_local(self, kg: Table) -> int:
        """One rank's block capacity of the bucketed KG: the bucket of
        ``ceil(capacity / n)``."""
        return bucket_cap(-(-kg.capacity // self.n_shards))

    def _shard_kg(self, table: Table, cap_local: int) -> Tuple:
        """This rank's block of the bucketed KG, cached on the table
        object's identity (a fresh KG from run()/ingest() re-shards)."""
        hit = self._kg_shard
        if hit is not None and hit[0] is table and hit[1] == cap_local:
            return hit[2], hit[3]
        from repro_torch.core.distributed import shard_table
        d, c, _ = shard_table(table, self.mesh, self.mesh_axis,
                              cap_local=cap_local)
        self._kg_shard = (table, cap_local, d, c)
        return d, c

    def _query_mesh_sig(self, kg: Table) -> Optional[Tuple]:
        """Query analogue of :meth:`_mesh_sig`: the same static mesh
        identity and exchange/calibration components, with the KG's
        shard-local capacity bucket as the (single) source term."""
        if self.mesh is None:
            return None
        cal_sig = (None if self.calibration is None
                   else self.calibration.signature())
        return self._mesh_static + (
            self._kg_cap_local(kg), len(self._dis.vocab) < (1 << 16),
            self.join_exchange, cal_sig)

    def _query_key(self, query: Query, kg: Table) -> Tuple:
        c = self.config
        return query_session_key(query, dedup=c.dedup, mode=c.mode,
                                 slack=c.slack, jit=c.jit,
                                 kg_bucket_cap=kg.capacity,
                                 mesh_sig=self._query_mesh_sig(kg))

    def _annotate_query(self, qplan, kg: Table, mode: str,
                        safe_exchange: bool):
        """(counts, caps, exchanges) of a query over ``kg``: global on one
        device (``exchanges`` None), shard-local on a mesh."""
        sources = {KG_SOURCE: kg}
        if self.mesh is None:
            counts, caps = annotate_query(qplan, sources, mode=mode,
                                          slack=self.slack,
                                          cap_fn=bucket_cap)
            return counts, caps, None
        return annotate_query_local(
            qplan, n_shards=self.n_shards,
            cap_locals={KG_SOURCE: self._kg_cap_local(kg)}, mode=mode,
            slack=self.slack, cap_fn=bucket_cap, sources=sources,
            join_exchange=self.join_exchange, safe_exchange=safe_exchange,
            calibration=self.calibration)

    def _compile_query(self, qplan, kg: Table, caps, exchanges,
                       safe_exchange: bool):
        """The query closure over ``caps``: single-device, or this rank's
        mesh closure (then with its ``out_cap_local``)."""
        if self.mesh is None:
            return compile_query(qplan, dedup=self.dedup, caps=caps), None
        return compile_query_mesh(
            qplan, self.mesh, self.mesh_axis, dedup=self.dedup, caps=caps,
            cap_local=self._kg_cap_local(kg),
            pack_u16=len(self._dis.vocab) < (1 << 16), exchanges=exchanges,
            safe_exchange=safe_exchange)

    def _build_query(self, key: Tuple, qplan, kg: Table,
                     mode: Optional[str] = None,
                     floor_caps: Optional[Mapping] = None,
                     safe_exchange: bool = False) -> CachedPlan:
        """Query sibling of :meth:`_build`: annotate (globally, or
        shard-locally on a mesh), statically verify, compile and write the
        entry back to the plan store."""
        t0 = time.perf_counter()
        safe_exchange = (safe_exchange or self._q_safe_exchange) \
            and self.mesh is not None
        self._q_safe_exchange = safe_exchange
        counts, caps, exchanges = self._annotate_query(
            qplan, kg, mode or self.mode, safe_exchange)
        if floor_caps:  # growth must be monotone or overflow ping-pongs
            caps = {n: max(c, floor_caps.get(n, 0)) for n, c in caps.items()}
        if self.verify != "off":
            verify_query_plan(qplan, counts=counts, caps=caps,
                              sources={KG_SOURCE: kg},
                              shard_local=self.mesh is not None,
                              slack=self.slack).raise_for_status()
            self._verify_plan_checks += 1
        fn, out_cap_local = self._compile_query(qplan, kg, caps, exchanges,
                                                safe_exchange)
        entry = CachedPlan(key=key, plan=qplan, emitter=None, counts=counts,
                           caps=caps, fn=fn, engine=self.engine,
                           dedup=self.dedup, mode=mode or self.mode,
                           build_seconds=time.perf_counter() - t0,
                           cap_locals=(None if self.mesh is None else
                                       {KG_SOURCE: self._kg_cap_local(kg)}),
                           out_cap_local=out_cap_local, exchanges=exchanges,
                           safe_exchange=safe_exchange)
        PLAN_CACHE.put(key, entry)
        self._builds += 1
        self._store_save(entry)
        return entry

    def _run_query_entry(self, entry: CachedPlan, sources, fresh: bool):
        def step(srcs):
            result, over = entry.fn(srcs)
            return result, host_int(over)
        return self._execute(step, (sources,), fresh,
                             expected_counts={"all_gather": 0,
                                              "all_to_all": 0},
                             expected_host_reads=functools.partial(
                                 expected_host_reads, entry.plan, None,
                                 self.dedup))

    def query(self, q: Query, kg: Optional[Table] = None) -> Table:
        """Evaluate a BGP :class:`~repro_torch.query.Query` over the
        device-resident KG; returns the answer :class:`Table`
        (``SELECT DISTINCT`` semantics, one ``v__t``/``v__v`` column pair
        per term variable, ``v__p`` per predicate variable).

        The query goes through the same machinery as creation: lowered to
        the relational IR (:func:`repro_torch.query.lower_query`),
        annotated with capacities, compiled to one closure on the session
        device (on a mesh, one per-rank closure over this rank's block of
        the KG), and cached in the process-wide plan cache under its own
        structural-fingerprint key tier. A truncation flag triggers one
        exact recompile at floored capacities, as in :meth:`run`.

        ``kg`` defaults to the session KG (materialized via :meth:`run` on
        first use); pass an explicit coded triple table to query something
        else (it shares the session's vocab codes by construction)."""
        t0 = time.perf_counter()
        table = self._kg_table(kg)
        qplan = lower_query(q)
        sources = {KG_SOURCE: table}
        key = self._query_key(q, table)
        entry = PLAN_CACHE.get(key)
        hit = entry is not None
        if hit:
            self._q_cache_hits += 1
        else:
            self._q_cache_misses += 1
            entry = self._store_load(
                "query", key, qplan, None,
                lambda counts, caps: verify_query_plan(
                    qplan, counts=counts, caps=caps, sources=sources,
                    shard_local=self.mesh is not None, slack=self.slack),
                lambda unpacked: self._compile_query(
                    qplan, table, unpacked["caps"],
                    unpacked.get("exchanges"),
                    unpacked.get("safe_exchange", False))[0],
                cap_locals=(None if self.mesh is None else
                            {KG_SOURCE: self._kg_cap_local(table)}))
            if entry is None:
                entry = self._build_query(key, qplan, table)
        plan_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        if self.mesh is not None:
            result, entry, hit = self._run_query_mesh(entry, qplan, table,
                                                      hit)
        else:
            result, entry, hit = self._run_query_one(entry, qplan, table,
                                                     hit)
        self._q_executions += 1
        self._q_last = {"entry": entry, "cache_hit": hit,
                        "plan_seconds": plan_s,
                        "exec_seconds": time.perf_counter() - t1}
        return result

    def _run_query_one(self, entry: CachedPlan, qplan, table: Table,
                       hit: bool):
        """Execute the single-device query closure; on overflow, one exact
        recompile at floored capacities."""
        sources = {KG_SOURCE: table}
        try:
            result, over = self._run_query_entry(
                entry, sources, fresh=not hit and entry.origin == "build")
        except Exception as e:
            # a store entry that cannot run here (see run())
            if entry.origin != "store":
                raise
            self._store_run_failed("query", e)
            hit = False
            entry = self._build_query(entry.key, qplan, table)
            result, over = self._run_query_entry(entry, sources, fresh=True)
        if over:
            hit = False   # the hit did not actually serve this query
            self._q_recompiles += 1
            entry = self._build_query(entry.key, qplan, table, mode="exact",
                                      floor_caps=entry.caps)
            result, over = self._run_query_entry(entry, sources, fresh=True)
            if over:  # exact caps cannot under-size
                raise RuntimeError("query capacity overflow persisted "
                                   "after recompile — please report")
        return result, entry, hit

    def _run_query_mesh_entry(self, entry: CachedPlan, table: Table,
                              fresh: bool):
        """One call of the per-rank query closure over this rank's block
        of the KG, then the ranks' agreement: one ``all_gather`` of
        (overflowed, answer count) and one counted host read, after the
        (audited) call. Returns ``(answer shard, answer counts per rank,
        overflowed on any rank)``."""
        from repro_torch.launch.mesh import gather_values
        data, count = self._shard_kg(table, entry.cap_locals[KG_SOURCE])
        want = expected_query_collectives(entry.plan, self.n_shards,
                                          exchanges=entry.exchanges)
        self._q_mesh_calls += 1
        for name, k in want.items():
            self._q_mesh_collectives[name] += k
        out_d, out_c, over = self._execute(
            entry.fn, (data, count), fresh, n_shards=self.n_shards,
            expected_counts=want,
            expected_host_reads=functools.partial(
                expected_host_reads, entry.plan, None, self.dedup,
                n_shards=self.n_shards))
        agreed = gather_values(self.mesh, self.mesh_axis, torch.stack([
            over.to(torch.int32), out_c.to(torch.int32)]))
        return out_d, [int(c) for c in agreed[:, 1]], bool(agreed[:, 0].any())

    def _run_query_mesh(self, entry: CachedPlan, qplan, table: Table,
                        hit: bool):
        """Execute the per-rank query closure; mirrors :meth:`_run_mesh`:
        every rank takes the same branch (the flags are agreed first), an
        overflow rebuilds once with exact caps and hard-safe exchange
        buckets, then the answer shards are gathered and one δ over them
        puts the rows in the single-device answer's order — which makes
        the mesh answer bit-identical to the single-device one."""
        import torch.distributed as dist

        from repro_torch.core.distributed import unshard_rows
        from repro_torch.relalg import distinct
        from repro_torch.relalg.table import round_cap
        out_d, out_counts, over = self._run_query_mesh_entry(
            entry, table, fresh=not hit and entry.origin == "build")
        if over:
            hit = False   # the hit did not actually serve this query
            self._q_recompiles += 1
            entry = self._build_query(entry.key, qplan, table, mode="exact",
                                      floor_caps=entry.caps,
                                      safe_exchange=True)
            out_d, out_counts, over = self._run_query_mesh_entry(
                entry, table, fresh=True)
            if over:   # exact caps + safe buckets cannot under-size
                raise RuntimeError("mesh query capacity overflow persisted "
                                   "after recompile — please report")
        shards = [torch.empty_like(out_d) for _ in range(self.n_shards)]
        dist.all_gather(shards, out_d.contiguous(),
                        group=self.mesh.group_for(self.mesh_axis))
        rows = unshard_rows(torch.cat(shards), out_counts, out_d.shape[0])
        total = rows.shape[0]
        result = distinct(Table(data=pad_rows(rows, round_cap(total)),
                                count=torch.full((), total,
                                                 dtype=torch.int32,
                                                 device=self.device),
                                attrs=entry.plan.out_attrs),
                          dedup=self.dedup)
        return result, entry, hit

    def explain_query(self, q: Query, kg: Optional[Table] = None) -> str:
        """Annotated query-plan tree — the query analogue of
        :meth:`explain`: per-node rows/caps from the session's annotation
        mode over the KG the query would read (shard-local on a mesh, with
        each ⋈'s exchange decision and wire-byte estimates), with the
        verifier's verdict and ``cols=`` unless ``verify="off"``."""
        table = self._kg_table(kg)
        qplan = lower_query(q)
        counts, caps, exchanges = self._annotate_query(
            qplan, table, self.mode, self._q_safe_exchange)
        schemas = verdict = None
        if self.verify != "off":
            report = verify_query_plan(qplan, counts=counts, caps=caps,
                                       sources={KG_SOURCE: table},
                                       shard_local=self.mesh is not None,
                                       slack=self.slack)
            schemas, verdict = report.schemas, report.describe()
        return dump_root(qplan.root, counts=counts, caps=caps,
                         exchanges=exchanges, schemas=schemas,
                         verdict=verdict)

    # -- stats ---------------------------------------------------------------
    @property
    def vocab(self):
        return self._dis.vocab

    def _run_stats(self, kg: Table, raw, source_rows_before=None,
                   exact_rows: bool = False) -> Dict[str, object]:
        entry: CachedPlan = self._last["entry"]
        names = input_names(entry.plan)
        counts = entry.counts
        if exact_rows and entry.mode == "exact" \
                and (self._last["cache_hit"] or entry.origin == "store"):
            # a hit reuses counts from whichever same-bucket extension
            # built the entry; recount for honest Table-1 reduced sizes
            counts, _ = annotate(entry.plan, mode="exact",
                                 sources=self._last["sources"])
        rows_after = {names[tm.name]: counts[entry.plan.inputs[tm.name]]
                      for tm in entry.plan.maps}
        pre_s = self._last["plan_seconds"]
        if self._last["first"]:
            pre_s += self._plan_seconds  # symbolic fixpoint, paid once
        return {
            "raw_triples": host_int(raw),
            "kg_triples": host_int(kg.count),
            "preprocess_seconds": pre_s,
            "semantify_seconds": self._last["exec_seconds"],
            "source_rows_before": (source_rows_before if source_rows_before
                                   is not None else
                                   {k: host_int(v.count)
                                    for k, v in self.sources.items()}),
            "source_rows_after": rows_after,
            "rule1": self._tstats.rule1_applications,
            "rule2": self._tstats.rule2_applications,
            "rule3": self._tstats.rule3_merges,
            "sigma": self._tstats.sigma_pushdowns,
            "cse_shared": self._tstats.cse_shared_subplans,
            "recompiles": self._recompiles,
            "plan_cache_hit": self._last["cache_hit"],
            "plan_cache_hits": self._cache_hits,
            "plan_cache_misses": self._cache_misses,
            **{f"store_{k}": v for k, v in self._store_counts["kg"].items()},
        }

    def stats(self) -> Dict[str, object]:
        """Session-level counters (no execution side effects)."""
        out = {
            "engine": self.engine, "dedup": self.dedup, "mode": self.mode,
            "slack": self.slack, "optimize": self.optimize,
            "join_exchange": self.join_exchange,
            "mesh": (None if self.mesh is None else
                     dict(self.mesh.describe(), axis=self.mesh_axis,
                          calls=self._mesh_calls,
                          collectives=dict(self._mesh_collectives),
                          query_calls=self._q_mesh_calls,
                          query_collectives=dict(
                              self._q_mesh_collectives))),
            "cost_model": ("static" if self.calibration is None
                           else self.calibration.source),
            "calibration": (None if self.calibration is None else {
                "all_gather_bw": self.calibration.all_gather_bw,
                "all_to_all_bw": self.calibration.all_to_all_bw,
                "launch_s": self.calibration.launch_s,
                "source": self.calibration.source,
            }),
            "verify": {"mode": self.verify,
                       "plan_checks": self._verify_plan_checks,
                       "audits": self._verify_audits,
                       "store_checks": self._verify_store_checks},
            "device": str(self.device),
            "executions": self._executions, "ingests": self._ingests,
            "ingested_rows": self._ingested_rows,
            "builds": self._builds,
            "recompiles": self._recompiles,
            "plan_cache_hits": self._cache_hits,
            "plan_cache_misses": self._cache_misses,
            "plan_cache": PLAN_CACHE.stats(),
            **{f"store_{k}": v for k, v in self._store_counts["kg"].items()},
            "plan_store": (None if self._store is None
                           else self._store.stats()),
            "plan_seconds": self._plan_seconds,
            "source_buckets": {k: v.capacity
                               for k, v in self.sources.items()},
            "rule1": self._tstats.rule1_applications,
            "rule2": self._tstats.rule2_applications,
            "rule3": self._tstats.rule3_merges,
            "sigma": self._tstats.sigma_pushdowns,
            "cse_shared": self._tstats.cse_shared_subplans,
            "query": {
                "executions": self._q_executions,
                "cache_hits": self._q_cache_hits,
                "cache_misses": self._q_cache_misses,
                "recompiles": self._q_recompiles,
                **{f"store_{k}": v
                   for k, v in self._store_counts["query"].items()},
            },
        }
        if self._last:
            out["last_preprocess_seconds"] = self._last["plan_seconds"]
            out["last_semantify_seconds"] = self._last["exec_seconds"]
        if self._q_last:
            out["query"]["last_plan_seconds"] = self._q_last["plan_seconds"]
            out["query"]["last_exec_seconds"] = self._q_last["exec_seconds"]
            out["query"]["last_cache_hit"] = self._q_last["cache_hit"]
        return out
