"""The session plan cache: content-keyed reuse of built plans.

A built plan is keyed by

* the **structural fingerprint** of the optimized IR
  (:func:`repro_torch.plan.ir.fingerprint`),
* the **emitter signature** (every dictionary code the closure embeds),
* engine × dedup × annotate mode/slack, and
* the **capacity-bucket signature** of the source extensions
  (:func:`repro_torch.relalg.bucket_cap` of each source's row count, plus
  its buffer capacity) — the quantization that lets *ranges* of extension
  sizes share one closure, and turns a growing source into O(log n)
  rebuilds.

Entries are replaced in place when the engine rebuilds on overflow (the
bigger capacities serve every smaller extension of the same bucket), and
evicted LRU beyond ``maxsize``.
"""
from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable, Dict, Optional, Tuple

from repro_torch.plan.ir import Node


@dataclasses.dataclass
class CachedPlan:
    """One built execution plan: the closure plus everything the session
    needs to report stats without re-planning."""

    key: Tuple
    plan: object                 # LogicalPlan, or a query's QueryPlan
    emitter: object              # RDFizer (None for a query entry)
    counts: Dict[Node, int]      # plan-time row counts (exact or bound)
    caps: Dict[Node, int]        # plan-time buffer capacities
    fn: Callable                 # sources -> (kg, raw, overflowed), or
    #                              (answer, overflowed) for a query, or
    #                              (datas, counts) -> (kg shard, kg count,
    #                              raw, overflowed, sink overflowed) on a
    #                              mesh, or (data, count) -> (answer
    #                              shard, count, overflowed) for a mesh
    #                              query
    engine: str
    dedup: Optional[str]
    mode: str
    build_seconds: float = 0.0
    # mesh entries only: the per-source shard-local block capacities, the
    # rows of one rank's output block (read off the closure's first
    # result for a KG entry; ``None`` before it), the sink δ's bucket
    # slack, the per-⋈ exchange decisions, and whether the exchanges were
    # sized hard-safe
    cap_locals: Optional[Dict[str, int]] = None
    out_cap_local: Optional[int] = None
    sink_slack: float = 1.0
    exchanges: Optional[Dict[Node, object]] = None
    safe_exchange: bool = False
    #: where the closure came from: ``"build"`` (annotated and built in
    #: this process) or ``"store"`` (rebuilt from the counts and caps of a
    #: persistent plan-store entry — the engine treats a failure to run
    #: such a closure as one more store reject and rebuilds fresh)
    origin: str = "build"


class PlanCache:
    """Tiny LRU keyed on the tuple above; shared across sessions."""

    def __init__(self, maxsize: int = 128):
        self.maxsize = maxsize
        self._entries: "OrderedDict[Tuple, CachedPlan]" = OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: Tuple) -> Optional[CachedPlan]:
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        return entry

    def put(self, key: Tuple, entry: CachedPlan) -> None:
        self._entries[key] = entry
        self._entries.move_to_end(key)
        while len(self._entries) > self.maxsize:
            self._entries.popitem(last=False)

    def __len__(self) -> int:
        return len(self._entries)

    def clear(self) -> None:
        self._entries.clear()
        self.hits = 0
        self.misses = 0

    def stats(self) -> Dict[str, int]:
        return {"hits": self.hits, "misses": self.misses,
                "size": len(self._entries)}


#: process-wide cache shared by every :class:`~repro_torch.api.KGEngine` session
PLAN_CACHE = PlanCache()


def clear_plan_cache() -> None:
    """Drop every cached plan (benchmarks use this to measure cold paths)."""
    PLAN_CACHE.clear()


def plan_cache_stats() -> Dict[str, int]:
    return PLAN_CACHE.stats()
