"""Compiling the optimized logical plan to device execution.

Two consumers:

* :func:`compile_plan` lowers the DAG to one ``sources -> (KG, raw)``
  closure executing pre-processing *and* semantification. It runs
  eagerly: every buffer has a plan-time capacity, so the shapes of one
  closure are fixed across calls (which keeps it capturable as a CUDA
  graph later). Shared subplans (CSE'd nodes, join parents) are evaluated
  once per call.
* :func:`materialize_plan` — the ``apply_mapsdi`` path: evaluate just the
  per-map relation inputs (one pass, shared subtrees computed once) and
  shrink the results into a concrete ``DIS'``.

Execution is memoized on the structurally-hashable node itself, so equal
subtrees collapse even if a rewrite produced them as separate objects.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.core.schema import DIS
from repro_torch.relalg import (Table, distinct, equi_join, project,
                                project_as, round_cap, select_mask,
                                shrink_to_fit)
from repro_torch.relalg.guard import host_int
from repro_torch.relalg.ops import _masked_data, compact
from repro_torch.relalg.table import pad_rows

from .ir import (ColEq, Distinct, EmitTriples, EquiJoin, Node, Project,
                 Scan, Select, Union, iter_nodes)
from .lower import LogicalPlan, selection_preds


def _fit(table: Table, cap: Optional[int]) -> Table:
    """Re-buffer a compacted table at a plan-time capacity (device only)."""
    if cap is None or cap == table.capacity:
        return table
    if cap < table.capacity:
        return Table(data=table.data[:cap],
                     count=torch.clamp(table.count, max=cap),
                     attrs=table.attrs)
    return Table(data=pad_rows(table.data, cap), count=table.count,
                 attrs=table.attrs)


def _pred_mask(table: Table, preds) -> torch.Tensor:
    mask = torch.ones((table.capacity,), dtype=torch.bool,
                      device=table.device)
    for p in preds:
        col = table.column(p.attr)
        if p.op == "eq":
            mask &= col == p.code
        else:  # 'neq' / 'notnull' both exclude one code
            mask &= col != p.code
    return mask


def execute_node(node: Node, sources: Mapping[str, Table],
                 memo: Dict[Node, Table], emitter=None,
                 dedup: Optional[str] = None,
                 caps: Optional[Mapping[Node, int]] = None,
                 overflow: Optional[List[torch.Tensor]] = None, *,
                 join_exchange=None, distinct_global=None) -> Table:
    """Evaluate one DAG node (and, via ``memo``, each shared subtree once).

    When ``overflow`` is a list, every capped operator appends a 0-d bool
    flag — "this node needed more rows than its plan-time capacity and was
    truncated" — exactly once per unique node. ``KGEngine`` reduces the
    flags to its recompile-on-overflow signal.

    ``join_exchange`` and ``distinct_global`` are the mesh hooks
    (:mod:`repro_torch.plan.mesh`); single-device execution leaves them
    ``None``:

    * ``join_exchange(node, left, right) -> (left, right)`` runs before
      every ⋈ — the per-rank closure either all-gathers the (rank-local)
      parent rows so a row-sharded child joins against the full parent,
      or hash-repartitions *both* sides by join key so each rank joins
      only its key range.
    * ``distinct_global(node, child) -> table`` replaces the local δ of a
      ``Distinct`` node with a global hash-repartition δ, so every
      interior relation stays an exact multiset partition of its
      single-device value. The result is still fitted to the node's
      plan-time capacity and flagged on truncation here.
    """
    hit = memo.get(node)
    if hit is not None:
        return hit
    caps = caps or {}

    def run(child: Node) -> Table:
        return execute_node(child, sources, memo, emitter, dedup, caps,
                            overflow, join_exchange=join_exchange,
                            distinct_global=distinct_global)

    def capped(table: Table) -> Table:
        cap = caps.get(node)
        if overflow is not None and cap is not None:
            overflow.append(table.count > cap)
        return _fit(table, cap)

    if isinstance(node, Scan):
        out = sources[node.source]
    elif isinstance(node, Project):
        out = project_as(run(node.child), list(node.spec))
    elif isinstance(node, Select):
        child = run(node.child)
        out = capped(select_mask(child, _pred_mask(child, node.preds)))
    elif isinstance(node, ColEq):
        child = run(node.child)
        mask = child.column(node.left_attr) == child.column(node.right_attr)
        out = capped(select_mask(child, mask))
    elif isinstance(node, Distinct):
        child = run(node.child)
        out = capped(distinct(child, dedup=dedup) if distinct_global is None
                     else distinct_global(node, child))
    elif isinstance(node, Union):
        parts = [run(c) for c in node.inputs]
        aligned = [parts[0]] + [project(p, parts[0].attrs) for p in parts[1:]]
        data = torch.cat([_masked_data(p) for p in aligned], dim=0)
        keep = torch.cat([p.valid_mask for p in aligned])
        data, count = compact(data, keep)
        out = Table(data=data, count=count, attrs=parts[0].attrs)
    elif isinstance(node, EquiJoin):
        left, right = run(node.left), run(node.right)
        if join_exchange is not None:
            left, right = join_exchange(node, left, right)
        cap = caps.get(node, round_cap(left.capacity * 4))
        out, total = equi_join(left, right, node.left_key, node.right_key,
                               out_capacity=cap,
                               right_suffix=node.right_suffix)
        if overflow is not None:
            overflow.append(total > cap)
    elif isinstance(node, EmitTriples):
        if emitter is None:
            raise ValueError("EmitTriples node needs an emitter")
        table = run(node.input)
        joins = {i: run(j) for i, j in node.joins}
        out = emitter.emit_triples(node.tm, table, joins)
    else:
        raise TypeError(f"cannot execute node {type(node).__name__}")
    memo[node] = out
    return out


def compile_plan(plan: LogicalPlan, emitter, engine: str = "rmlmapper",
                 dedup: Optional[str] = None,
                 caps: Optional[Mapping[Node, int]] = None,
                 report_overflow: bool = False):
    """Lower the DAG to one ``sources -> (kg, raw)`` closure. ``"sdm"``
    deduplicates each map's output as it is produced, ``"rmlmapper"`` only
    at the sink; the sink δ runs in either mode. ``raw`` is the engine's
    materialized triple count before the sink δ.

    Capacities in ``caps`` are sized for the planning-time extension; on
    extensions where more rows survive a node than planned, the node is
    truncated. With ``report_overflow=True`` the closure returns ``(kg,
    raw, overflowed)`` where ``overflowed`` is a 0-d bool — True iff any
    capped node was truncated — so ``KGEngine`` can rebuild and re-run
    instead of returning a truncated KG.

    The engine/sink semantics (per-map δ under sdm, δδ = δ for a single
    map, sink δ) stay in lockstep with :meth:`LogicalPlan.sink`. The
    mesh sibling is :func:`repro_torch.plan.mesh.compile_mesh_plan` (same
    DAG, one per-rank body, the sink δ fused as a repartition)."""
    emit_nodes = plan.emits()

    def fn(sources: Mapping[str, Table]):
        memo: Dict[Node, Table] = {}
        flags: Optional[List[torch.Tensor]] = [] if report_overflow else None
        per_map = [execute_node(e, sources, memo, emitter, dedup, caps,
                                flags)
                   for e in emit_nodes]
        if engine == "sdm":
            per_map = [distinct(t, dedup=dedup) for t in per_map]
        raw = torch.stack([t.count for t in per_map]).sum(dtype=torch.int32)

        def done(kg: Table):
            if not report_overflow:
                return kg, raw
            over = (torch.any(torch.stack(flags)) if flags
                    else torch.zeros((), dtype=torch.bool,
                                     device=raw.device))
            return kg, raw, over

        if engine == "sdm" and len(per_map) == 1:
            return done(per_map[0])     # δδ = δ: per-map δ IS the sink δ
        data = torch.cat([t.data for t in per_map], dim=0)
        mask = torch.cat([t.valid_mask for t in per_map])
        data, count = compact(data, mask)
        merged = Table(data=data, count=count, attrs=per_map[0].attrs)
        return done(distinct(merged, dedup=dedup))

    return fn


# ---------------------------------------------------------------------------
# materialization (the apply_mapsdi back end)
# ---------------------------------------------------------------------------

def input_names(plan: LogicalPlan) -> Dict[str, str]:
    """Deterministic materialization name per map: Rule-3 merges keep their
    recorded ``merged_*`` label, δπ(σ) chains derive ``src__pi_attrs`` (+
    ``__sigma``), untouched scans keep the source name."""
    names: Dict[str, str] = {}
    node_name: Dict[Node, str] = {}
    used: Dict[str, Node] = {}
    for tm in plan.maps:
        node = plan.inputs[tm.name]
        if node in node_name:
            names[tm.name] = node_name[node]
            continue
        if isinstance(node, Scan):
            name = node.source
        elif node in plan.names:
            name = plan.names[node]
        else:
            scans = sorted({n.source for n in iter_nodes(node)
                            if isinstance(n, Scan)})
            base = scans[0] if len(scans) == 1 else "plan"
            name = f"{base}__pi_" + "_".join(node.attrs)
            if any(isinstance(n, Select) for n in iter_nodes(node)):
                name += "__sigma"
        k, candidate = 0, name
        while candidate in used and used[candidate] != node:
            k += 1
            candidate = f"{name}_{k}"
        used[candidate] = node
        node_name[node] = candidate
        names[tm.name] = candidate
    return names


def materialize_plan(plan: LogicalPlan, dedup: Optional[str] = None
                     ) -> Tuple[DIS, Dict[str, int]]:
    """Evaluate the plan's relation inputs into a concrete ``DIS'``.

    All device work happens in one eager pass with one memo, so shared
    subtrees are evaluated once, on the device of the plan's sources. The
    host reads, all counted (:mod:`repro_torch.relalg.guard`), are one per
    source of ``DIS'`` — its row count, which for a new source also sizes
    the one ``shrink_to_fit`` that materializes it, mirroring the paper's
    pre-processed files — plus the one flag read of every hash δ call in
    the pass (ROADMAP Queue 3; the reference selects its δ fallbacks on
    the device).
    """
    dis = plan.dis
    names = input_names(plan)
    ordered: List[Node] = []
    for tm in plan.maps:
        node = plan.inputs[tm.name]
        if node not in ordered and not isinstance(node, Scan):
            ordered.append(node)

    memo: Dict[Node, Table] = {}
    tables = {node: execute_node(node, dis.sources, memo, dedup=dedup)
              for node in ordered}

    sources: Dict[str, Table] = {}
    preprocessed = set()
    sigma_baked: Dict[str, bool] = {}
    rows_after: Dict[str, int] = {}
    new_maps = []
    for tm in plan.maps:
        node, name = plan.inputs[tm.name], names[tm.name]
        if name not in sources:
            if isinstance(node, Scan):
                sources[name] = dis.sources[node.source]
                if node.source in plan.preprocessed:
                    preprocessed.add(name)
                rows_after[name] = host_int(sources[name].count)
            else:
                rows_after[name] = host_int(tables[node].count)
                sources[name] = shrink_to_fit(tables[node],
                                              count=rows_after[name])
                preprocessed.add(name)
        # σ-baked provenance: the materialized extension carries the map's
        # σ selections iff they were pushed into the materialized subtree
        # (or the source was already flagged). A source shared by several
        # maps is baked only if it is baked for every one of them.
        if isinstance(node, Scan):
            ok = node.source in plan.sigma_baked
        else:
            have = {p for n in iter_nodes(node)
                    if isinstance(n, Select) for p in n.preds}
            ok = all(p in have for p in selection_preds(dis, tm))
        sigma_baked[name] = sigma_baked.get(name, True) and ok
        new_maps.append(tm if tm.source == name
                        else dataclasses.replace(tm, source=name))

    out = dis.copy()
    out.sources = sources
    out.maps = new_maps
    out.preprocessed = preprocessed
    out.sigma_baked = {name for name, ok in sigma_baked.items() if ok}
    return out, rows_after
