"""``dump_plan`` / ``explain`` — human-readable plan trees.

Renders the full DAG (sink δ → ∪ → per-map emits → joins → relation
chains) as an indented text tree with per-node capacity/row annotations
from the annotation pass. Shared subtrees (CSE hits, join parents) print
once and show up as ``(shared #k)`` references afterwards, making the
common-subplan elimination visible. On a mesh, every ⋈ additionally
shows its cost-modelled exchange decision (gather vs repartition) and the
estimated per-device wire bytes of both strategies.
"""
from __future__ import annotations

from typing import Dict, List, Mapping, Optional

from .annotate import JoinExchange, annotate, annotate_local
from .ir import (ColEq, Distinct, EmitTriples, EquiJoin, Node, Project,
                 Scan, Select, Union)
from .lower import LogicalPlan


def _label(node: Node) -> str:
    if isinstance(node, Scan):
        return f"scan {node.source}({', '.join(node.attrs)})"
    if isinstance(node, Project):
        cols = ", ".join(s if s == d else f"{s}→{d}" for s, d in node.spec)
        return f"π [{cols}]"
    if isinstance(node, Select):
        return "σ [" + " ∧ ".join(p.describe() for p in node.preds) + "]"
    if isinstance(node, ColEq):
        return f"σ= [{node.left_attr} = {node.right_attr}]"
    if isinstance(node, Distinct):
        return "δ"
    if isinstance(node, Union):
        return f"∪ ({len(node.inputs)} inputs)"
    if isinstance(node, EquiJoin):
        return f"⋈ {node.left_key}={node.right_key}"
    if isinstance(node, EmitTriples):
        n_joins = len(node.joins)
        extra = f", {n_joins} join{'s' if n_joins != 1 else ''}" \
            if n_joins else ""
        return f"emit[{node.tm.name}] ({len(node.tm.poms)} poms{extra})"
    return type(node).__name__


def _fmt_bytes(n: int) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if n < 1024 or unit == "GiB":
            return f"{n:.1f}{unit}" if unit != "B" else f"{int(n)}B"
        n /= 1024
    return f"{n:.1f}GiB"  # pragma: no cover - unreachable


def dump_plan(plan: LogicalPlan, engine: str = "rmlmapper",
              counts: Optional[Mapping[Node, int]] = None,
              caps: Optional[Mapping[Node, int]] = None,
              exchanges: Optional[Mapping[Node, JoinExchange]] = None,
              schemas: Optional[Mapping[Node, object]] = None,
              verdict: Optional[str] = None) -> str:
    """Text tree of the whole plan DAG with per-node annotations
    (``rows=`` from ``counts``, ``cap=`` from ``caps``). ``exchanges`` (a
    mesh plan's per-⋈ decisions from ``annotate_local``) adds
    ``exchange=<strategy>`` plus the estimated per-device wire bytes of
    both strategies to every ⋈ line. ``schemas`` (the static verifier's
    per-node inference, ``repro_torch.analysis.verify_plan(...).schemas``)
    adds a ``cols=`` bit per node; ``verdict`` (e.g.
    ``report.describe()``) is printed as a header above the tree."""
    return dump_root(plan.sink(engine), counts=counts, caps=caps,
                     exchanges=exchanges, schemas=schemas, verdict=verdict)


def dump_root(root: Node,
              counts: Optional[Mapping[Node, int]] = None,
              caps: Optional[Mapping[Node, int]] = None,
              exchanges: Optional[Mapping[Node, JoinExchange]] = None,
              schemas: Optional[Mapping[Node, object]] = None,
              verdict: Optional[str] = None) -> str:
    """Root-generic body of :func:`dump_plan` — renders any IR DAG from
    its root node. Query plans (whose root is the answer δ rather than an
    engine sink) use this directly via ``KGEngine.explain_query``."""
    counts = counts or {}
    caps = caps or {}
    exchanges = exchanges or {}
    schemas = schemas or {}
    shared_ids: Dict[int, int] = {}
    seen_multi = _multi_referenced(root)
    lines: List[str] = []
    if verdict:
        lines.extend(verdict.splitlines())

    def annot(node: Node) -> str:
        bits = []
        schema = schemas.get(node)
        if schema is not None and not isinstance(node, Scan):
            bits.append(f"cols={schema.describe()}")
        if node in counts:
            bits.append(f"rows={counts[node]}")
        if node in caps:
            bits.append(f"cap={caps[node]}")
        exch = exchanges.get(node)
        if exch is not None:
            fanout = getattr(exch, "parent_fanout", 1)
            bits.append(f"exchange={exch.strategy}")
            # gather_bytes is the amortized per-⋈ share of the one shared
            # all_gather when several ⋈ reuse this parent's replica
            bits.append(f"gather≈{_fmt_bytes(exch.gather_bytes)}"
                        + (f" (÷{fanout} shared parent)" if fanout > 1
                           else ""))
            bits.append(f"all_to_all≈{_fmt_bytes(exch.repartition_bytes)}")
            bits.append(f"cost={getattr(exch, 'cost_source', 'static')}")
        return ("  [" + ", ".join(bits) + "]") if bits else ""

    def render(node: Node, prefix: str, is_last: bool, is_root: bool):
        branch = "" if is_root else ("└─ " if is_last else "├─ ")
        if id(node) in shared_ids:
            lines.append(f"{prefix}{branch}{_label(node)} "
                         f"(shared #{shared_ids[id(node)]})")
            return
        ref = ""
        if id(node) in seen_multi:
            shared_ids[id(node)] = len(shared_ids) + 1
            ref = f"  (#{shared_ids[id(node)]})"
        lines.append(f"{prefix}{branch}{_label(node)}{annot(node)}{ref}")
        kids = node.children()
        child_prefix = prefix if is_root else \
            prefix + ("   " if is_last else "│  ")
        for i, child in enumerate(kids):
            render(child, child_prefix, i == len(kids) - 1, False)

    render(root, "", True, True)
    return "\n".join(lines)


def _multi_referenced(root: Node) -> Dict[int, int]:
    # count references (not visits): a node with >1 incoming edge is shared
    refs: Dict[int, int] = {}
    stack: List[Node] = [root]
    visited = set()
    while stack:
        n = stack.pop()
        if id(n) in visited:
            continue
        visited.add(id(n))
        for c in n.children():
            refs[id(c)] = refs.get(id(c), 0) + 1
            stack.append(c)
    return {i: k for i, k in refs.items() if k > 1}


def explain(plan: LogicalPlan, engine: str = "rmlmapper",
            with_annotations: bool = True, n_shards: Optional[int] = None,
            join_exchange: str = "auto", calibration=None) -> str:
    """Convenience: annotate (host-side, exact) and dump the plan.

    With ``n_shards`` the annotation runs shard-locally
    (:func:`annotate_local`, per-shard source blocks derived from the
    plan's source capacities) and every ⋈ line shows the cost model's
    exchange decision under ``join_exchange`` plus the estimated wire
    bytes per strategy — what a mesh ``KGEngine`` session would build.
    Each ⋈ line's ``cost=`` bit says whether those numbers came from the
    static constants or a measured
    :class:`repro_torch.launch.mesh.Calibration` (pass one via
    ``calibration``)."""
    if not with_annotations:
        return dump_plan(plan, engine)
    if n_shards is None:
        counts, caps = annotate(plan)
        return dump_plan(plan, engine, counts, caps)
    from repro_torch.relalg.table import bucket_cap
    from .mesh import plan_scans
    cap_locals = {name: bucket_cap(-(-plan.dis.sources[name].capacity
                                     // n_shards))
                  for name in plan_scans(plan)}
    counts, caps, exchanges = annotate_local(
        plan, n_shards=n_shards, cap_locals=cap_locals,
        join_exchange=join_exchange, calibration=calibration)
    return dump_plan(plan, engine, counts, caps, exchanges)
