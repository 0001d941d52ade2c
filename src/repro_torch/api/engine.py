"""``KGEngine`` — the stateful session front door to the MapSDI pipeline.

The paper's framework amortizes: extract knowledge from the mapping rules
once, then semantify large and *growing* sources cheaply::

    engine = KGEngine(dis, config=EngineConfig(engine="sdm", dedup="hash"))
    kg, stats = engine.create_kg()           # plan + build (or cache hit)
    kg, stats = engine.ingest(delta_sources) # micro-batch extension
    engine.stats()                           # session counters

Two mechanisms:

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
"""
from __future__ import annotations

import time
from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core.rdfizer import RDFizer
from repro_torch.core.schema import DIS
from repro_torch.core.transform import TransformStats, plan_mapsdi
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.plan.annotate import annotate
from repro_torch.plan.compile import compile_plan, input_names
from repro_torch.plan.explain import dump_plan
from repro_torch.plan.ir import fingerprint
from repro_torch.plan.lower import LogicalPlan, lower
from repro_torch.relalg import Table, append_rows, bucket_cap, host_int
from repro_torch.relalg.table import pad_rows

from .cache import PLAN_CACHE, CachedPlan
from .config import EngineConfig


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
        counts before bucketing) and ``verify``.
    device
        ``None`` (the default) runs on the CUDA card; ``"cpu"`` runs the
        plain PyTorch path on the CPU.
    """

    def __init__(self, dis: DIS, config: Optional[EngineConfig] = None, *,
                 device: DeviceLike = None):
        if config is None:
            config = EngineConfig()
        if not isinstance(config, EngineConfig):
            raise TypeError("config must be an EngineConfig, got "
                            f"{type(config).__name__}")
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
        return kg, raw

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
        }
        if self._last:
            out["last_preprocess_seconds"] = self._last["plan_seconds"]
            out["last_semantify_seconds"] = self._last["exec_seconds"]
        return out
