"""Capacity annotation for query DAGs.

The creation-path annotator (:mod:`repro_torch.plan.annotate`) walks
``plan.emits()`` and treats ⋈ as a leaf-adjacent special case (joins feed
``EmitTriples`` directly). Query DAGs stack π/δ/``ColEq`` *on top of*
joins, so :func:`annotate_query` walks the whole DAG in :func:`node_order`
post-order instead — reusing the same row evaluator, structural bounds,
Poisson shard bounds and ⋈ exchange cost model, so the capacity semantics
(exact vs bound mode, slack, bucketed cap_fn, overflow-recompile ladder,
gather-vs-repartition pricing) are identical to the creation path's.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

from repro_torch.plan.annotate import (JoinExchange, _bound, _eval_rows,
                                       join_exchange_cost, parent_fanouts,
                                       poisson_shard_bound)
from repro_torch.plan.ir import (ColEq, Distinct, EquiJoin, Node, Project,
                                 Scan, Select, Union, node_order)
from repro_torch.relalg.table import Table, round_cap

from .lower import QueryPlan


def annotate_query(plan: QueryPlan,
                   sources: Mapping[str, Table], mode: str = "exact",
                   slack: float = 1.0,
                   cap_fn: Callable[[int], int] = round_cap,
                   ) -> Tuple[Dict[Node, int], Dict[Node, int]]:
    """(counts, capacities) for every node of a query DAG.

    ``mode="exact"`` evaluates rows on the host (one counted read of the
    KG table; joins materialized — see
    :func:`repro_torch.plan.annotate._eval_rows`); ``mode="bound"`` uses
    the structural bounds (⋈ = FK heuristic, backstopped by the runtime
    overflow flag + recompile ladder exactly as for creation plans).
    """
    if mode not in ("exact", "bound"):
        raise ValueError(f"unknown annotate mode {mode!r}")
    counts: Dict[Node, int] = {}
    if mode == "bound":
        bmemo: Dict[Node, int] = {}

        def count_of(node: Node) -> int:
            return _bound(node, sources, bmemo)
    else:
        memo: Dict[Node, object] = {}

        def count_of(node: Node) -> int:
            return len(_eval_rows(node, sources, memo)[0])

    for node in node_order([plan.root]):
        counts[node] = count_of(node)
    caps = {node: cap_fn(int(math.ceil(c * slack)))
            for node, c in counts.items()}
    return counts, caps


def annotate_query_local(plan: QueryPlan, n_shards: int,
                         cap_locals: Mapping[str, int], mode: str = "exact",
                         slack: float = 1.0,
                         cap_fn: Callable[[int], int] = round_cap,
                         sources: Optional[Mapping[str, Table]] = None,
                         join_exchange: str = "gather",
                         safe_exchange: bool = False,
                         calibration=None,
                         ) -> Tuple[Dict[Node, int], Dict[Node, int],
                                    Dict[Node, JoinExchange]]:
    """Shard-local (counts, capacities, exchanges) for the per-rank mesh
    query closure (:func:`repro_torch.query.mesh.compile_query_mesh`) —
    the query-DAG analogue of :func:`repro_torch.plan.annotate
    .annotate_local`: the same global counts, the same post-exchange
    Poisson bounds for δ and a repartitioned ⋈, the same
    ``safe_exchange`` hard bounds, and the same cost-model inputs (the
    children's already-bucketed shard-local caps, amortized over the ⋈
    sites sharing a parent).
    """
    counts, _ = annotate_query(plan, sources, mode=mode, slack=slack,
                               cap_fn=cap_fn)
    locals_: Dict[Node, int] = {}
    caps: Dict[Node, int] = {}
    exchanges: Dict[Node, JoinExchange] = {}
    # gather amortization divisor per shared parent (BGP joins habitually
    # share the KG-pattern parent) — same grouping as the creation path
    fanout = parent_fanouts(n for n in node_order([plan.root])
                            if isinstance(n, EquiJoin))
    for node in node_order([plan.root]):    # post-order: children first
        c = counts[node]
        if isinstance(node, Scan):
            local = int(cap_locals[node.source])
        elif isinstance(node, Distinct):
            # executed as a global hash-repartition δ: the shard holds the
            # distinct rows hashing to it, not its pre-exchange slice
            local = c if safe_exchange else poisson_shard_bound(c, n_shards)
        elif isinstance(node, (Project, Select, ColEq)):
            local = locals_[node.children()[0]]
        elif isinstance(node, Union):
            local = sum(locals_[ch] for ch in node.inputs)
        elif isinstance(node, EquiJoin):
            exch = join_exchange_cost(
                caps[node.left], len(node.left.attrs),
                caps[node.right], len(node.right.attrs),
                n_shards, strategy=join_exchange, calibration=calibration,
                parent_fanout=fanout[node.right])
            exchanges[node] = exch
            if exch.strategy == "repartition":
                local = (c if safe_exchange
                         else poisson_shard_bound(c, n_shards))
            elif mode == "exact":
                local = c
            else:
                local = min(c, locals_[node.left] + counts[node.right])
        else:
            raise TypeError(f"cannot annotate {type(node).__name__}")
        locals_[node] = min(c, local)
        caps[node] = cap_fn(int(math.ceil(locals_[node] * slack)))
    return counts, caps, exchanges
