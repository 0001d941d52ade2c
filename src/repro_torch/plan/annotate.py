"""Plan-time cardinality annotation — ``plan_join_caps`` generalized to a
per-node capacity on the whole IR.

Two modes:

* ``mode="exact"`` (default) evaluates every *relation* node of the
  optimized DAG on the host (numpy, exact — the planning-time analogue of a
  cardinality estimator with perfect statistics). One host materialization
  per scanned source; capacities are exact for the planning extension.
* ``mode="bound"`` sizes every node from *structural upper bounds* with no
  host pass at all: a Scan is bounded by its buffer capacity (static shape
  metadata — no device read), π/σ/δ by their child, ∪ by the sum of its
  inputs. An ⋈ is the one operator whose true bound (|L|·|R|) is useless in
  practice, so it gets the FK-join heuristic ``|L| + |R|``; the compiled
  closure's overflow flag plus the engine's recompile-on-overflow make the
  heuristic safe.

``annotate(plan)`` returns ``(counts, caps)``:

* ``counts[node]`` — row count (exact or bound) of the node's output
  (``EquiJoin`` nodes get their match total, the quantity ``plan_join_caps``
  computed per (map, pom)).
* ``caps[node]``   — ``cap_fn(ceil(count * slack))``, the static buffer
  capacity the compiler sizes that node's output with. ``cap_fn`` defaults
  to :func:`round_cap` (exact fit); the ``KGEngine`` passes
  :func:`repro_torch.relalg.table.bucket_cap` so structurally-identical
  plans over same-bucket extensions share one compiled closure.

``sources`` overrides the extensions to annotate against (default:
``plan.dis.sources``) — the engine re-annotates against its *current*
session sources after ingestion.

``annotate_local`` is the mesh form: shard-local capacities and each
⋈'s exchange decision (:func:`join_exchange_cost`) for the fused
per-rank closure of :mod:`repro_torch.plan.mesh`.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.relalg.table import Table, round_cap

from .ir import (ColEq, Distinct, EmitTriples, EquiJoin, Node, Project,
                 Scan, Select, Union)
from .lower import LogicalPlan

Rows = Tuple[np.ndarray, Tuple[str, ...]]  # valid rows [n, k] + attr names

#: per-collective launch overhead (seconds) the exchange cost model adds on
#: top of wire time — the tie-breaker that keeps tiny relations on the
#: single-collective gather plan instead of the two-exchange repartition.
#: Measured on the card: the median time of one 4 KiB
#: ``all_to_all_single`` on a one-rank NCCL group, from the call to the
#: end of a device sync, on an H100 80GB HBM3 at 700.00 W
#: (``tools/collective_launch.py``; PERF.md section 6). A
#: one-card machine has no NVLink peer, so no multi-rank NCCL launch was
#: measured.
COLLECTIVE_LAUNCH_S = 6.44e-5

JOIN_EXCHANGES = ("gather", "repartition", "auto")


def poisson_shard_bound(total: int, n_shards: int) -> int:
    """Expected per-shard share of ``total`` hash-partitioned rows plus a
    Poisson tail: ``m + 6·sqrt(m) + 8`` with ``m = total / n_shards``,
    clamped to ``total`` (one shard can never receive more than everything,
    and on one shard the exchange is the identity). The same bound
    :func:`repro_torch.core.distributed.sink_bucket_cap` uses for the
    sink's buckets, applied to post-exchange *node* buffers; skew beyond
    the tail is caught by the runtime overflow flag and answered with a
    safe-capacity recompile (see ``annotate_local``)."""
    total = int(total)
    if n_shards <= 1:
        return total
    m = total / n_shards
    return min(total, int(math.ceil(m + 6.0 * math.sqrt(m) + 8)))


@dataclasses.dataclass(frozen=True)
class JoinExchange:
    """Per-⋈ exchange decision + the cost-model terms behind it.

    ``*_bytes`` are the estimated per-device wire bytes of each strategy
    (from the static buffer capacities that actually cross the links —
    fixed shapes, padding included — not from row counts); ``*_seconds``
    add the per-collective launch overhead. ``parent_fanout`` is the
    number of ⋈ sites sharing this join's parent node: the closure
    gathers a parent once and reuses it at every ⋈ on it, so the gather
    figures are the per-⋈ amortized share (total ÷ fanout);
    ``repartition_*`` stay per-⋈."""

    strategy: str               # "gather" | "repartition"
    gather_bytes: int
    repartition_bytes: int
    gather_seconds: float
    repartition_seconds: float
    cost_source: str = "static"  # "static" | "measured" bandwidth numbers
    parent_fanout: int = 1       # ⋈ sites sharing the gathered parent


def join_exchange_cost(child_cap_local: int, child_cols: int,
                       parent_cap_local: int, parent_cols: int,
                       n_shards: int, strategy: str = "auto",
                       word_bytes: int = 4,
                       calibration=None,
                       parent_fanout: int = 1) -> JoinExchange:
    """Price the two ⋈ exchange strategies and pick one.

    Inputs are the SHARD-LOCAL buffer capacities (rows) and widths of the
    child and parent relations. Per device, over an ``n_shards``-way
    axis:

    * ``gather`` — the parent block is all-gathered: receive ``(n-1) ·
      parent_cap_local · parent_cols`` words (one collective, shared by
      every ⋈ on the same parent node);
    * ``repartition`` — both sides are hash-partitioned on the join key
      and exchanged: ``(n-1)`` buckets of ``min(cap_local,
      sink_bucket_cap(cap_local, n))`` rows per side (two collectives),
      the buffers ``compile_mesh_plan`` allocates.

    Wire seconds default to NVLink's data-sheet rate
    (:data:`repro_torch.launch.mesh.NVLINK_BW`) plus
    :data:`COLLECTIVE_LAUNCH_S` per collective; a
    :class:`repro_torch.launch.mesh.Calibration` prices each collective
    with its own bandwidth and launch constant instead. ``strategy``
    forces the choice or lets the model decide (``"auto"``); one shard
    always gathers under ``"auto"``. ``parent_fanout`` > 1 amortizes the
    shared gather (wire time and its one launch) over the ⋈ sites that
    reuse it, before the ``"auto"`` comparison."""
    from repro_torch.core.distributed import sink_bucket_cap
    from repro_torch.launch.mesh import NVLINK_BW
    if strategy not in JOIN_EXCHANGES:
        raise ValueError(f"unknown join exchange {strategy!r} "
                         f"(expected one of {JOIN_EXCHANGES})")
    if calibration is None:
        gather_bw = a2a_bw = NVLINK_BW
        launch_s = COLLECTIVE_LAUNCH_S
        cost_source = "static"
    else:
        gather_bw = calibration.all_gather_bw
        a2a_bw = calibration.all_to_all_bw
        launch_s = calibration.launch_s
        cost_source = calibration.source
    n = max(1, int(n_shards))

    def bucket(cap_local: int) -> int:
        return min(int(cap_local), sink_bucket_cap(int(cap_local), n))

    fanout = max(1, int(parent_fanout))
    gather_total = (n - 1) * int(parent_cap_local) * parent_cols * word_bytes
    # the amortized per-⋈ share of the one shared all_gather (ceil so the
    # shares still sum to at least the total)
    gather_bytes = -(-gather_total // fanout)
    rep_rows = (bucket(child_cap_local) * child_cols
                + bucket(parent_cap_local) * parent_cols)
    repartition_bytes = (n - 1) * rep_rows * word_bytes
    gather_s = (gather_total / gather_bw + 1 * launch_s) / fanout
    repartition_s = repartition_bytes / a2a_bw + 2 * launch_s
    if strategy == "auto":
        strategy = ("repartition" if n > 1 and repartition_s < gather_s
                    else "gather")
    return JoinExchange(strategy=strategy, gather_bytes=gather_bytes,
                        repartition_bytes=repartition_bytes,
                        gather_seconds=gather_s,
                        repartition_seconds=repartition_s,
                        cost_source=cost_source,
                        parent_fanout=fanout)


def parent_fanouts(joins) -> Dict[Node, int]:
    """How many ⋈ sites share each parent node — the amortization divisor
    of :func:`join_exchange_cost`, keyed by the parent node itself (the
    key ``compile_mesh_plan`` memoizes the gathered replica under)."""
    fanout: Dict[Node, int] = {}
    for join in joins:
        fanout[join.right] = fanout.get(join.right, 0) + 1
    return fanout


def _eval_rows(node: Node, sources: Mapping[str, Table],
               memo: Dict[Node, Rows]) -> Rows:
    hit = memo.get(node)
    if hit is not None:
        return hit
    if isinstance(node, Scan):
        table = sources[node.source]
        rows: np.ndarray = table.to_codes()
        attrs = tuple(table.attrs)
    elif isinstance(node, Project):
        child, cattrs = _eval_rows(node.child, sources, memo)
        idx = [cattrs.index(a) for a, _ in node.spec]
        rows, attrs = child[:, idx], node.attrs
    elif isinstance(node, Select):
        child, cattrs = _eval_rows(node.child, sources, memo)
        keep = np.ones(len(child), dtype=bool)
        for p in node.preds:
            col = child[:, cattrs.index(p.attr)]
            if p.op == "eq":
                keep &= col == p.code
            else:  # 'neq' and 'notnull' both exclude one code
                keep &= col != p.code
        rows, attrs = child[keep], cattrs
    elif isinstance(node, ColEq):
        child, cattrs = _eval_rows(node.child, sources, memo)
        keep = (child[:, cattrs.index(node.left_attr)]
                == child[:, cattrs.index(node.right_attr)])
        rows, attrs = child[keep], cattrs
    elif isinstance(node, Distinct):
        child, cattrs = _eval_rows(node.child, sources, memo)
        rows, attrs = np.unique(child, axis=0), cattrs
    elif isinstance(node, EquiJoin):
        # materialized exact join — the creation path only ever needs the
        # match *total* (joins feed EmitTriples directly), but query DAGs
        # stack π/δ/ColEq on top of ⋈, so exact annotation needs the rows
        left, lattrs = _eval_rows(node.left, sources, memo)
        right, rattrs = _eval_rows(node.right, sources, memo)
        lk = left[:, lattrs.index(node.left_key)]
        rk = right[:, rattrs.index(node.right_key)]
        order = np.argsort(rk, kind="stable")
        rs = rk[order]
        lo = np.searchsorted(rs, lk, side="left")
        hi = np.searchsorted(rs, lk, side="right")
        match = hi - lo
        total = int(match.sum())
        li = np.repeat(np.arange(len(lk)), match)
        starts = np.repeat(np.cumsum(match) - match, match)
        ri = order[np.repeat(lo, match) + np.arange(total) - starts]
        rows = np.concatenate(
            [left[li], right[ri]], axis=1) if total else np.zeros(
            (0, left.shape[1] + right.shape[1]), dtype=left.dtype)
        attrs = node.attrs
    elif isinstance(node, Union):
        parts = []
        attrs = node.attrs
        for c in node.inputs:
            crows, cattrs = _eval_rows(c, sources, memo)
            parts.append(crows[:, [cattrs.index(a) for a in attrs]])
        rows = np.concatenate(parts, axis=0)
    else:
        raise TypeError(f"not a relation node: {type(node).__name__}")
    memo[node] = (rows, attrs)
    return rows, attrs


def join_match_total(lk: np.ndarray, rk: np.ndarray) -> int:
    """Exact equi-join output cardinality for two key columns — the
    estimation kernel shared with ``plan_join_caps``."""
    vals, counts = np.unique(rk, return_counts=True)
    if len(vals) == 0 or len(lk) == 0:
        return 0
    idx = np.clip(np.searchsorted(vals, lk), 0, len(vals) - 1)
    match = vals[idx] == lk
    return int(counts[idx][match].sum())


def _join_total(node: EquiJoin, sources: Mapping[str, Table],
                memo: Dict[Node, Rows]) -> int:
    left, lattrs = _eval_rows(node.left, sources, memo)
    right, rattrs = _eval_rows(node.right, sources, memo)
    return join_match_total(left[:, lattrs.index(node.left_key)],
                            right[:, rattrs.index(node.right_key)])


def _bound(node: Node, sources: Mapping[str, Table],
           memo: Dict[Node, int]) -> int:
    """Structural upper bound on a node's output rows — static shape
    metadata only, zero device *and* host reads."""
    hit = memo.get(node)
    if hit is not None:
        return hit
    if isinstance(node, Scan):
        out = sources[node.source].capacity
    elif isinstance(node, (Project, Select, ColEq, Distinct)):
        out = _bound(node.children()[0], sources, memo)
    elif isinstance(node, Union):
        out = sum(_bound(c, sources, memo) for c in node.inputs)
    elif isinstance(node, EquiJoin):
        # FK-join heuristic, NOT a true bound (that is |L|·|R|); the
        # runtime overflow flag + recompile-on-overflow covers the gap
        out = _bound(node.left, sources, memo) + \
            _bound(node.right, sources, memo)
    else:
        raise TypeError(f"not a relation node: {type(node).__name__}")
    memo[node] = out
    return out


def annotate(plan: LogicalPlan, mode: str = "exact", slack: float = 1.0,
             cap_fn: Callable[[int], int] = round_cap,
             sources: Optional[Mapping[str, Table]] = None,
             ) -> Tuple[Dict[Node, int], Dict[Node, int]]:
    """(counts, capacities) for every relation and join node reachable from
    the plan's emits — exact (one host read per scanned source) or
    structural bounds (no host pass); see the module docstring."""
    if mode not in ("exact", "bound"):
        raise ValueError(f"unknown annotate mode {mode!r}")
    sources = plan.dis.sources if sources is None else sources
    counts: Dict[Node, int] = {}
    if mode == "bound":
        bmemo: Dict[Node, int] = {}

        def count_of(node: Node) -> int:
            return _bound(node, sources, bmemo)

        def join_of(join: EquiJoin) -> int:
            return _bound(join, sources, bmemo)
    else:
        memo: Dict[Node, Rows] = {}

        def count_of(node: Node) -> int:
            return len(_eval_rows(node, sources, memo)[0])

        def join_of(join: EquiJoin) -> int:
            return _join_total(join, sources, memo)

    for emit in plan.emits():
        assert isinstance(emit, EmitTriples)
        for node in _relation_nodes(emit.input):
            if node not in counts:
                counts[node] = count_of(node)
        for _, join in emit.joins:
            for side in (join.left, join.right):
                for node in _relation_nodes(side):
                    if node not in counts:
                        counts[node] = count_of(node)
            if join not in counts:
                counts[join] = join_of(join)
    caps = {node: cap_fn(int(math.ceil(c * slack)))
            for node, c in counts.items()}
    return counts, caps


def annotate_local(plan: LogicalPlan, n_shards: int,
                   cap_locals: Mapping[str, int], mode: str = "exact",
                   slack: float = 1.0,
                   cap_fn: Callable[[int], int] = round_cap,
                   sources: Optional[Mapping[str, Table]] = None,
                   join_exchange: str = "gather",
                   safe_exchange: bool = False,
                   calibration=None,
                   ) -> Tuple[Dict[Node, int], Dict[Node, int],
                              Dict[Node, JoinExchange]]:
    """Shard-local (counts, capacities, exchanges) for the fused per-rank
    closure (:mod:`repro_torch.plan.mesh`).

    * ``counts`` are the GLOBAL counts of :func:`annotate` (exact or
      bound mode) — what the engine's stats report.
    * ``caps[node]`` are SHARD-LOCAL: ``min(global count, structural
      local bound)``, the local bound walking the subtree with Scans
      clamped to ``cap_locals`` (π/σ bounded by their child, ∪ by the
      sum). Every interior δ runs as a global hash repartition, so a δ is
      a redistribution point: its block holds the globally distinct rows
      hashing to the shard, bounded by :func:`poisson_shard_bound` of the
      global distinct count (the full count under ``safe_exchange``).
    * ``exchanges[join]`` is the :class:`JoinExchange` decision of
      :func:`join_exchange_cost` under ``join_exchange``, priced from the
      shard-local caps of the child and parent, amortized over the ⋈
      sites sharing a parent (:func:`parent_fanouts`). A repartitioned
      ⋈ is sized from its global match total like a δ; a gathered one
      keeps the global total in ``"exact"`` mode and the FK heuristic
      (shard-local left + global right) in ``"bound"`` mode.

    Skew past the Poisson tail trips the runtime overflow flag; the
    engine then rebuilds once with ``safe_exchange=True``, whose bounds
    are true bounds, so one recompile always suffices."""
    if join_exchange not in JOIN_EXCHANGES:
        raise ValueError(f"unknown join exchange {join_exchange!r} "
                         f"(expected one of {JOIN_EXCHANGES})")
    counts, _ = annotate(plan, mode=mode, slack=slack, cap_fn=cap_fn,
                         sources=sources)
    lmemo: Dict[Node, int] = {}

    def local_bound(node: Node) -> int:
        hit = lmemo.get(node)
        if hit is not None:
            return hit
        if isinstance(node, Scan):
            out = int(cap_locals[node.source])
        elif isinstance(node, Distinct):
            # executed as a global hash-repartition: the shard holds the
            # distinct rows hashing to it, not its pre-exchange slice
            out = (counts[node] if safe_exchange
                   else poisson_shard_bound(counts[node], n_shards))
        elif isinstance(node, (Project, Select, ColEq)):
            out = local_bound(node.children()[0])
        elif isinstance(node, Union):
            out = sum(local_bound(c) for c in node.inputs)
        else:
            raise TypeError(f"not a relation node: {type(node).__name__}")
        lmemo[node] = out
        return out

    caps: Dict[Node, int] = {}
    joins = []
    for node, c in counts.items():
        if isinstance(node, EquiJoin):
            joins.append(node)
            continue
        caps[node] = cap_fn(int(math.ceil(min(c, local_bound(node))
                                          * slack)))
    exchanges: Dict[Node, JoinExchange] = {}
    fanout = parent_fanouts(joins)
    for node in joins:
        c = counts[node]
        exch = join_exchange_cost(
            caps[node.left], len(node.left.attrs),
            caps[node.right], len(node.right.attrs),
            n_shards, strategy=join_exchange, calibration=calibration,
            parent_fanout=fanout[node.right])
        exchanges[node] = exch
        if exch.strategy == "repartition":
            local = c if safe_exchange else poisson_shard_bound(c, n_shards)
        elif mode == "exact":
            local = c
        else:
            local = min(c, local_bound(node.left) + counts[node.right])
        caps[node] = cap_fn(int(math.ceil(local * slack)))
    return counts, caps, exchanges


def _relation_nodes(root: Node):
    stack, seen = [root], set()
    while stack:
        n = stack.pop()
        if n in seen or isinstance(n, (EquiJoin, EmitTriples)):
            continue
        seen.add(n)
        stack.extend(n.children())
        yield n
