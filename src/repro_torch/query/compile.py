"""Compiling a lowered query DAG to device execution (single device).

Same machinery as :func:`repro_torch.plan.compile.compile_plan`, minus
the emitter/sink: the query root is already the δ the spec's set
semantics require, so the closure is ``{KG_SOURCE: Table} -> (result,
overflowed)`` with every capped node reporting the same truncation flag
the creation path uses — ``KGEngine.query`` answers an overflow with one
exact recompile at floored capacities, exactly like ``run()``.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

import torch

from repro_torch.plan.compile import execute_node
from repro_torch.plan.ir import Node
from repro_torch.relalg import Table

from .lower import QueryPlan


def compile_query(plan: QueryPlan, dedup: Optional[str] = None,
                  caps: Optional[Mapping[Node, int]] = None):
    """Lower a query DAG to one ``sources -> (result, overflowed)``
    closure. ``sources`` maps :data:`~repro_torch.query.spec.KG_SOURCE` to the
    coded KG table.

    The closure runs eagerly on the KG table's device, like
    :func:`~repro_torch.plan.compile.compile_plan` (so there is no ``jit``
    argument). Its host reads are the counted ones
    (:mod:`repro_torch.relalg.guard`): one flag read per hash δ call (the
    root δ, plus any δ the DAG holds), which picks the exact fallback the
    reference selects on the device (ROADMAP.md Queue 3). The overflow
    flag stays on the device for the caller to read. The reference's
    ``report_overflow`` switch is gone: its one caller,
    ``KGEngine.query``, always wants the flag.
    """
    root = plan.root

    def fn(sources: Mapping[str, Table]):
        memo: Dict[Node, Table] = {}
        flags: List[torch.Tensor] = []
        out = execute_node(root, sources, memo, None, dedup, caps, flags)
        over = (torch.any(torch.stack(flags)) if flags
                else torch.zeros((), dtype=torch.bool, device=out.device))
        return out, over

    return fn
