"""Capacity annotation for query DAGs.

The creation-path annotator (:mod:`repro_torch.plan.annotate`) walks
``plan.emits()`` and treats ⋈ as a leaf-adjacent special case (joins feed
``EmitTriples`` directly). Query DAGs stack π/δ/``ColEq`` *on top of*
joins, so :func:`annotate_query` walks the whole DAG in :func:`node_order`
post-order instead — reusing the same row evaluator and structural bounds,
so the capacity semantics (exact vs bound mode, slack, bucketed cap_fn,
overflow-recompile ladder) are identical to the creation path's.

The shard-local form (the reference's ``annotate_query_local``) waits for
the mesh queries (ROADMAP.md Queue 1 item 7); KG creation on a mesh is
ported.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Tuple

from repro_torch.plan.annotate import _bound, _eval_rows
from repro_torch.plan.ir import Node, node_order
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
