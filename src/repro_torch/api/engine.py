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

The port runs one device and keeps no persistent plan store: the
reference's ``mesh``/``mesh_axis``/``join_exchange``/``calibrate`` belong
to the multi-GPU slice and ``plan_store`` to the plan-store slice
(ROADMAP.md Queue 1 items 4 and 5).
"""
from __future__ import annotations

import time
import warnings
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core.rdfizer import RDFizer
from repro_torch.core.schema import DIS, TRIPLE_ATTRS
from repro_torch.core.transform import TransformStats, plan_mapsdi
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.plan.annotate import annotate
from repro_torch.plan.compile import compile_plan, input_names
from repro_torch.plan.explain import dump_plan, dump_root
from repro_torch.plan.ir import fingerprint
from repro_torch.plan.lower import LogicalPlan, lower
from repro_torch.query import (KG_SOURCE, Query, annotate_query,
                               compile_query, lower_query, query_session_key)
from repro_torch.relalg import Table, append_rows, bucket_cap, host_int
from repro_torch.relalg.table import pad_rows

from .cache import PLAN_CACHE, CachedPlan
from .config import EngineConfig

#: sentinel distinguishing "kwarg not passed" from every real value — a
#: bare ``KGEngine(dis)`` must not warn; an explicit legacy kwarg must
_UNSET = object()
_WARNED_LEGACY: set = set()

#: the reference's keywords for the slices not ported yet, with the value
#: that means "no mesh / no store" (accepted) and the ROADMAP.md Queue 1
#: item that ports the rest
_NOT_PORTED = {
    "mesh": (None, 4, "multi-GPU"),
    "mesh_axis": ("data", 4, "multi-GPU"),
    "join_exchange": ("auto", 4, "multi-GPU"),
    "calibrate": (False, 4, "multi-GPU"),
    "plan_store": (None, 5, "plan-store"),
}


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
        counts before bucketing), ``jit`` (keyed, no-op in the eager port)
        and ``verify``. The canonical spelling.
    engine, dedup, optimize, mode, slack, jit, verify
        The reference's keyword spelling of the same fields: deprecated
        (one ``DeprecationWarning`` per combination per process), folded
        into an ``EngineConfig``; passing them together with ``config``
        raises ``ValueError``.
    mesh, mesh_axis, join_exchange, calibrate, plan_store
        The reference's multi-device and plan-store keywords. Their
        single-device, storeless values (``None``, ``"data"``, ``"auto"``,
        ``False``, ``None``) are accepted; any other value raises
        ``NotImplementedError`` naming the ROADMAP.md item that ports it.
    device
        ``None`` (the default) runs on the CUDA card; ``"cpu"`` runs the
        plain PyTorch path on the CPU.
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
            names = tuple(sorted(legacy))
            for name in sorted(set(legacy) & set(_NOT_PORTED)):
                default, item, slice_name = _NOT_PORTED[name]
                value = legacy.pop(name)
                if value != default:
                    raise NotImplementedError(
                        f"KGEngine({name}={value!r}) is not ported yet: it "
                        f"belongs to the port's {slice_name} slice "
                        f"(ROADMAP.md Queue 1 item {item})")
            if names:
                _warn_legacy_kwargs(names)
            config = EngineConfig(**legacy)   # validates every field
        self.config = config
        self.device: torch.device = resolve_device(device)
        self.engine, self.dedup = config.engine, config.dedup
        self.optimize, self.mode = config.optimize, config.mode
        self.slack = config.slack
        self._dis = dis.copy()
        # session view of the extensions, on the session device and
        # re-buffered into geometric capacity buckets so within-bucket
        # ingests never change shapes
        self._dis.sources = {name: _to_bucket(t.to(self.device))
                             for name, t in dis.sources.items()}
        self.sources: Dict[str, Table] = self._dis.sources
        self._tstats = TransformStats()
        t0 = time.perf_counter()
        self._plan = (plan_mapsdi(self._dis, stats=self._tstats)
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
        """Closures built *by this session* (plan-cache hits excluded)."""
        return self._builds

    @property
    def recompiles(self) -> int:
        """Builds beyond the session's first (capacity-bucket crossings,
        overflow rebuilds)."""
        return self._recompiles

    def explain(self) -> str:
        """Annotated plan tree over the session's current sources (exact
        host-side annotation, one device)."""
        counts, caps = annotate(self._plan)
        return dump_plan(self._plan, self.engine, counts, caps)

    def _source_sig(self, sources: Mapping[str, Table]) -> Tuple:
        return tuple(sorted(
            (name, t.capacity, tuple(t.attrs), bucket_cap(host_int(t.count)))
            for name, t in sources.items()))

    def _key(self, sources: Mapping[str, Table]) -> Tuple:
        return (self._ir_fp, self._emit_sig) + self.config.cache_sig() + (
            self._source_sig(sources),)

    def _replan(self) -> None:
        """Re-lower/re-optimize after a provenance change (σ-baked flags
        dropped by :meth:`ingest`); the cache key follows the new plan."""
        t0 = time.perf_counter()
        self._plan = (plan_mapsdi(self._dis) if self.optimize
                      else lower(self._dis))
        self._ir_fp = fingerprint(self._plan.emits())
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
               floor_caps: Optional[Mapping] = None) -> CachedPlan:
        counts, caps = annotate(self._plan, mode=mode or self.mode,
                                slack=self.slack, cap_fn=bucket_cap,
                                sources=sources)
        if floor_caps:  # growth must be monotone or overflow ping-pongs
            caps = {n: max(c, floor_caps.get(n, 0)) for n, c in caps.items()}
        fn = compile_plan(self._slim_plan(), self._emitter,
                          engine=self.engine, dedup=self.dedup, caps=caps,
                          report_overflow=True)
        entry = CachedPlan(key=key, plan=self._slim_plan(),
                           emitter=self._emitter, counts=counts, caps=caps,
                           fn=fn, engine=self.engine, dedup=self.dedup,
                           mode=mode or self.mode)
        PLAN_CACHE.put(key, entry)
        self._builds += 1
        if self._have_plan:
            self._recompiles += 1
        return entry

    def _ensure(self, sources: Mapping[str, Table]) -> Tuple[CachedPlan, bool]:
        key = self._key(sources)
        entry = PLAN_CACHE.get(key)
        hit = entry is not None
        if hit:
            self._cache_hits += 1
        else:
            self._cache_misses += 1
            entry = self._build(key, sources)
        self._have_plan = True
        return entry, hit

    # -- execution -----------------------------------------------------------
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
        kg, raw, over = entry.fn(sources)
        if host_int(over):
            # some buffer was truncated: re-annotate exactly against the
            # *current* extension, grow caps monotonically, re-run — the
            # one rebuild per capacity-bucket crossing
            hit = False   # the hit did not actually serve this execution
            entry = self._build(entry.key, sources, mode="exact",
                                floor_caps=entry.caps)
            kg, raw, over = entry.fn(sources)
            if host_int(over):  # exact caps cannot under-size
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

    # -- queries -------------------------------------------------------------
    def _kg_table(self, kg: Optional[Table]) -> Table:
        """Resolve + bucket the KG table a query reads: the session KG by
        default (materialized on first use), an explicit ``kg=`` override
        (moved to the session device) otherwise. The bucketed view is
        cached on the KG object's identity, so repeated queries over one
        KG share a buffer."""
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

    def _query_key(self, query: Query, kg: Table) -> Tuple:
        c = self.config
        return query_session_key(query, dedup=c.dedup, mode=c.mode,
                                 slack=c.slack, jit=c.jit,
                                 kg_bucket_cap=kg.capacity, mesh_sig=None)

    def _build_query(self, key: Tuple, qplan, kg: Table,
                     mode: Optional[str] = None,
                     floor_caps: Optional[Mapping] = None) -> CachedPlan:
        """Query sibling of :meth:`_build`: annotate, then compile the
        single-device closure."""
        counts, caps = annotate_query(qplan, {KG_SOURCE: kg},
                                      mode=mode or self.mode,
                                      slack=self.slack, cap_fn=bucket_cap)
        if floor_caps:  # growth must be monotone or overflow ping-pongs
            caps = {n: max(c, floor_caps.get(n, 0)) for n, c in caps.items()}
        fn = compile_query(qplan, dedup=self.dedup, caps=caps)
        entry = CachedPlan(key=key, plan=qplan, emitter=None, counts=counts,
                           caps=caps, fn=fn, engine=self.engine,
                           dedup=self.dedup, mode=mode or self.mode)
        PLAN_CACHE.put(key, entry)
        self._builds += 1
        return entry

    def query(self, q: Query, kg: Optional[Table] = None) -> Table:
        """Evaluate a BGP :class:`~repro_torch.query.Query` over the
        device-resident KG; returns the answer :class:`Table`
        (``SELECT DISTINCT`` semantics, one ``v__t``/``v__v`` column pair
        per term variable, ``v__p`` per predicate variable).

        The query goes through the same machinery as creation: lowered to
        the relational IR (:func:`repro_torch.query.lower_query`),
        annotated with capacities, compiled to one closure on the session
        device, and cached in the process-wide plan cache under its own
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
            entry = self._build_query(key, qplan, table)
        plan_s = time.perf_counter() - t0
        t1 = time.perf_counter()
        result, over = entry.fn(sources)
        if host_int(over):
            hit = False   # the hit did not actually serve this query
            self._q_recompiles += 1
            entry = self._build_query(key, qplan, table, mode="exact",
                                      floor_caps=entry.caps)
            result, over = entry.fn(sources)
            if host_int(over):  # exact caps cannot under-size
                raise RuntimeError("query capacity overflow persisted "
                                   "after recompile — please report")
        self._q_executions += 1
        self._q_last = {"entry": entry, "cache_hit": hit,
                        "plan_seconds": plan_s,
                        "exec_seconds": time.perf_counter() - t1}
        return result

    def explain_query(self, q: Query, kg: Optional[Table] = None) -> str:
        """Annotated query-plan tree — the query analogue of
        :meth:`explain`: per-node rows/caps from the session's annotation
        mode over the KG the query would read."""
        table = self._kg_table(kg)
        qplan = lower_query(q)
        counts, caps = annotate_query(qplan, {KG_SOURCE: table},
                                      mode=self.mode, slack=self.slack,
                                      cap_fn=bucket_cap)
        return dump_root(qplan.root, counts=counts, caps=caps)

    # -- stats ---------------------------------------------------------------
    @property
    def vocab(self):
        return self._dis.vocab

    def _run_stats(self, kg: Table, raw, source_rows_before=None,
                   exact_rows: bool = False) -> Dict[str, object]:
        entry: CachedPlan = self._last["entry"]
        names = input_names(entry.plan)
        counts = entry.counts
        if exact_rows and entry.mode == "exact" and self._last["cache_hit"]:
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
        }

    def stats(self) -> Dict[str, object]:
        """Session-level counters (no execution side effects)."""
        out = {
            "engine": self.engine, "dedup": self.dedup, "mode": self.mode,
            "slack": self.slack, "optimize": self.optimize,
            "verify": self.config.verify, "device": str(self.device),
            "executions": self._executions, "ingests": self._ingests,
            "ingested_rows": self._ingested_rows,
            "builds": self._builds,
            "recompiles": self._recompiles,
            "plan_cache_hits": self._cache_hits,
            "plan_cache_misses": self._cache_misses,
            "plan_cache": PLAN_CACHE.stats(),
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
