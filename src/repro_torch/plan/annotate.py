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
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.relalg.table import Table, round_cap

from .ir import (ColEq, Distinct, EmitTriples, EquiJoin, Node, Project,
                 Scan, Select, Union)
from .lower import LogicalPlan

Rows = Tuple[np.ndarray, Tuple[str, ...]]  # valid rows [n, k] + attr names


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


def _relation_nodes(root: Node):
    stack, seen = [root], set()
    while stack:
        n = stack.pop()
        if n in seen or isinstance(n, (EquiJoin, EmitTriples)):
            continue
        seen.add(n)
        stack.extend(n.children())
        yield n
