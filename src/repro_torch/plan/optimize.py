"""The optimizing planner: MapSDI Rules 1–3 as pure symbolic rewrites,
plus selection pushdown (the paper's σ) and common-subplan elimination.

Every pass maps ``plan.inputs`` / ``plan.maps`` to new immutable values —
no device work, no host syncs. The correspondence to the paper:

* :func:`push_projections` — Rules 1 & 2: each map's relation becomes
  ``δ(π_Z̄(R))`` with ``Z̄`` = referenced attrs (own + incoming join attrs).
* :func:`merge_maps` — Rule 3: join-free maps with equal heads collapse
  into one map over ``δ(∪ π_roles(R_i))``.
* :func:`push_selections` — σ: null-filters and constant-equality
  predicates implied by the term maps (and any explicit ``selections``)
  sink through δ/π/∪ to sit directly on the scans.
* :func:`cse` — hash-consing: arbitrary equal subplans (not just identical
  ``(source, attrs)`` projections) become one shared node, across maps and
  across join parents.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Set, Tuple

from repro_torch.core.analyze import merge_groups, referenced_attrs, \
    sorted_reference_poms
from repro_torch.core.schema import (PredicateObjectMap, RefObjectMap,
                                     TermMap, TripleMap)

from .ir import (Distinct, Node, Pred, Project, Scan, Select, Union,
                 intern, make_select, tree_size)
from .lower import LogicalPlan, selection_preds


@dataclasses.dataclass
class PlanStats:
    """Rewrite counters; mirrors TransformStats' rule accounting."""

    rule1_applications: int = 0
    rule2_applications: int = 0
    rule3_merges: int = 0
    sigma_pushdowns: int = 0
    cse_shared_subplans: int = 0


class _MapsView:
    """Duck-typed DIS for the analysis helpers (they only read ``.maps``)."""

    def __init__(self, maps: List[TripleMap]):
        self.maps = maps


def _join_parents(maps: List[TripleMap]) -> Set[str]:
    return {p.object.parent_map for m in maps for p in m.poms
            if isinstance(p.object, RefObjectMap)}


# ---------------------------------------------------------------------------
# Rules 1 & 2 — projection pushdown
# ---------------------------------------------------------------------------

def push_projections(plan: LogicalPlan, stats: PlanStats) -> None:
    """Each map's relation becomes ``δ(π_attrs(R))``; already-canonical
    inputs (a δ with exactly the needed attrs, or a Scan of a source the
    DIS marks pre-processed) are left alone, which makes the pass — and the
    fixpoint — idempotent."""
    needed = referenced_attrs(_MapsView(plan.maps))
    created: Dict[Node, None] = {}
    for tm in plan.maps:
        attrs = tuple(sorted(needed[tm.name]))
        node = plan.inputs[tm.name]
        if isinstance(node, Distinct) and \
                tuple(sorted(node.attrs)) == attrs:
            continue
        if isinstance(node, Scan) and node.source in plan.preprocessed and \
                attrs == tuple(sorted(node.attrs)):
            continue
        new = Distinct(Project(node, tuple((a, a) for a in attrs)))
        plan.inputs[tm.name] = new
        if new not in created:
            created[new] = None
            if tm.has_join:
                stats.rule2_applications += 1
            else:
                stats.rule1_applications += 1


# ---------------------------------------------------------------------------
# Rule 3 — merging sources with equivalent attributes
# ---------------------------------------------------------------------------

def merge_maps(plan: LogicalPlan, stats: PlanStats) -> None:
    """Every mergeable group collapses to one map over
    ``δ(∪_i π_roles(R_i))``. Join parents stay separate (their names are
    referenced by other maps); canonical role attrs are ``__m0`` (subject)
    and ``__m{i}`` for the i-th predicate-sorted object reference."""
    parents = _join_parents(plan.maps)
    for gi, group in enumerate(merge_groups(_MapsView(plan.maps))):
        group = [tm for tm in group if tm.name not in parents]
        if len(group) < 2:
            continue
        lead = group[0]
        canon_poms: List[PredicateObjectMap] = []
        r_nonconst = 0
        for idx, term in sorted_reference_poms(lead):
            pom = lead.poms[idx]
            if term.kind == "constant":
                canon_poms.append(pom)
            else:
                r_nonconst += 1
                canon_poms.append(PredicateObjectMap(
                    predicate=pom.predicate,
                    object=dataclasses.replace(term,
                                               attr=f"__m{r_nonconst}")))

        parts: List[Node] = []
        for tm in group:
            spec: List[Tuple[str, str]] = []
            if tm.subject.referenced_attr:
                spec.append((tm.subject.referenced_attr, "__m0"))
            r_nonconst = 0
            for idx, term in sorted_reference_poms(tm):
                if term.kind == "constant":
                    continue
                spec.append((term.attr, f"__m{r_nonconst + 1}"))
                r_nonconst += 1
            parts.append(Project(plan.inputs[tm.name], tuple(spec)))
        merged = Distinct(parts[0] if len(parts) == 1 else
                          Union(tuple(parts)))
        merged_name = f"merged_{gi}_" + "_".join(tm.name for tm in group)

        subject = (dataclasses.replace(lead.subject, attr="__m0")
                   if lead.subject.referenced_attr else lead.subject)
        merged_map = TripleMap(
            name=f"TM_merged_{gi}", source=merged_name, subject=subject,
            subject_class=lead.subject_class, poms=tuple(canon_poms))

        group_names = {tm.name for tm in group}
        plan.maps = [m for m in plan.maps if m.name not in group_names]
        plan.maps.append(merged_map)
        for name in group_names:
            plan.inputs.pop(name, None)
        plan.inputs[merged_map.name] = merged
        plan.names[merged] = merged_name
        stats.rule3_merges += 1


# ---------------------------------------------------------------------------
# σ — selection pushdown (the paper's "selects relevant entries")
# ---------------------------------------------------------------------------

def _required_preds(plan: LogicalPlan, tm: TripleMap,
                    parents: Set[str]) -> Tuple[Pred, ...]:
    """Predicates implied by the term maps that suppress *every* triple the
    map (and every join against it) would emit — exactly the rows σ may
    remove from the logical source without changing the KG."""
    preds: List[Pred] = list(selection_preds(plan.dis, tm))
    null = plan.dis.null_code
    if null is not None:
        # every block of a map is masked by subject validity, and joins
        # against it null-mask the parent subject too
        if tm.subject.referenced_attr:
            preds.append(Pred(tm.subject.referenced_attr, "notnull", null))
        # single-block map: the lone object's null-mask is also universal —
        # but not for join parents, whose rows feed other maps' joins
        if (tm.name not in parents and tm.subject_class is None
                and len(tm.poms) == 1):
            obj = tm.poms[0].object
            if isinstance(obj, TermMap) and obj.referenced_attr:
                preds.append(Pred(obj.referenced_attr, "notnull", null))
    return tuple(preds)


def _sink_preds(node: Node, preds: Tuple[Pred, ...]) -> Node:
    """Push σ predicates through δ/π/∪ until they sit on the scans."""
    if not preds:
        return node
    if isinstance(node, (Scan, Select)):
        return make_select(node, preds)
    if isinstance(node, Distinct):
        return Distinct(_sink_preds(node.child, preds))   # σδ = δσ
    if isinstance(node, Project):
        back = {dst: src for src, dst in node.spec}
        if any(p.attr not in back for p in preds):
            return make_select(node, preds)               # rename lost — stop
        renamed = tuple(dataclasses.replace(p, attr=back[p.attr])
                        for p in preds)
        return Project(_sink_preds(node.child, renamed), node.spec)
    if isinstance(node, Union):
        return Union(tuple(_sink_preds(c, preds) for c in node.inputs))
    return make_select(node, preds)


def push_selections(plan: LogicalPlan, stats: PlanStats) -> None:
    parents = _join_parents(plan.maps)
    for tm in plan.maps:
        node = plan.inputs[tm.name]
        if isinstance(node, Scan) and node.source in plan.preprocessed:
            continue  # σ already baked into the pre-processed extension
        preds = tuple(p for p in _required_preds(plan, tm, parents)
                      if p.attr in node.attrs)
        new = _sink_preds(node, preds)
        if new != node:
            plan.inputs[tm.name] = new
            stats.sigma_pushdowns += 1


# ---------------------------------------------------------------------------
# common-subplan elimination + the driving fixpoint
# ---------------------------------------------------------------------------

def cse(plan: LogicalPlan, stats: PlanStats) -> None:
    """Hash-cons every input relation so equal subplans are one object;
    records how many node instances the sharing saves."""
    memo: Dict[Node, Node] = {}
    for name in list(plan.inputs):
        plan.inputs[name] = intern(plan.inputs[name], memo)
    plan.names = {intern(n, memo): label for n, label in plan.names.items()}
    instances = sum(tree_size(n) for n in plan.inputs.values())
    stats.cse_shared_subplans = instances - len(
        {id(n) for root in plan.inputs.values() for n in _iter_ids(root)})


def _iter_ids(root: Node):
    seen = set()
    stack = [root]
    while stack:
        n = stack.pop()
        if id(n) in seen:
            continue
        seen.add(id(n))
        stack.extend(n.children())
        yield n


def optimize(plan: LogicalPlan, max_iters: int = 8,
             stats: Optional[PlanStats] = None,
             gate: Optional[Callable[
                 [str, Tuple[List[TripleMap], Dict[str, Node]], LogicalPlan],
                 None]] = None) -> PlanStats:
    """Run all rewrite passes to a fixpoint (paper: "until a fixed point
    over S' and M' is reached"), then hash-cons. Purely symbolic.

    ``gate``, when given, is called as ``gate(pass_name, (maps_before,
    inputs_before), plan)`` after every pass *that changed the plan* —
    the hook point for :func:`repro_torch.analysis.soundness_gate`, which
    asserts each rewrite's lossless precondition and names the offending
    pass on violation."""
    stats = stats if stats is not None else PlanStats()

    def run(name, pass_fn):
        before = ((list(plan.maps), dict(plan.inputs))
                  if gate is not None else None)
        pass_fn(plan, stats)
        if gate is not None and (before[0] != plan.maps or
                                 before[1] != plan.inputs):
            gate(name, before, plan)

    for _ in range(max_iters):
        sig = (tuple(plan.maps), dict(plan.inputs))
        run("merge_maps", merge_maps)
        run("push_projections", push_projections)
        run("push_selections", push_selections)
        if (tuple(plan.maps), plan.inputs) == sig:
            break
    run("cse", cse)
    return stats
