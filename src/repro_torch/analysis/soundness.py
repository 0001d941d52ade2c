"""Pass 2 — rewrite-soundness gates over the optimizer fixpoint.

Each ``optimize.py`` rewrite declares its lossless precondition in
:data:`CONTRACTS`; :func:`soundness_gate` plugs into the ``gate=`` hook of
:func:`repro_torch.plan.optimize.optimize` and asserts, after every pass that
changed the plan, (a) the pass-specific schema-equivalence condition and
(b) the generic structural invariants (:func:`~repro_torch.analysis.verify
.verify_plan` minus the hash-consing checks, which only hold after CSE).
A violation raises :class:`RewriteSoundnessError` **naming the offending
rewrite** — a planner bug surfaces at plan time, not as a bit-mismatch
deep inside a differential run.

The conditions mirror the paper's losslessness argument:

* Rules 1 & 2 (``push_projections``) never *invent* columns — the new
  input projects a subset of the old schema that still covers every
  referenced attribute, so ``δ(π_Z̄(R))`` loses no triple-relevant data.
* Rule 3 (``merge_maps``) must put merged maps in the canonical role
  schema (``__m0`` subject, ``__m{i}`` for the i-th predicate-sorted
  non-constant object) so equal heads really do read equal columns.
* σ-pushdown (``push_selections``) is a pure filter: the relation schema
  is preserved exactly; only rows that could never emit a triple go.
* CSE (``cse``) is sharing only: every input must remain *structurally*
  equal to its pre-pass value, and the maps untouched.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from repro_torch.core.analyze import referenced_attrs, sorted_reference_poms
from repro_torch.plan.ir import Node
from repro_torch.plan.lower import LogicalPlan
from repro_torch.plan.optimize import PlanStats, optimize

from .verify import Diagnostic, verify_plan

#: pass name -> the lossless precondition it promises (rendered in error
#: messages; the reference's docs/analysis.md has the same table)
CONTRACTS: Dict[str, str] = {
    "merge_maps": (
        "Rule 3: merged maps use the canonical role schema (__m0 subject, "
        "__m{i} for the i-th predicate-sorted non-constant object) and "
        "their merged input provides every role column"),
    "push_projections": (
        "Rules 1 & 2: a rewritten input's schema is a subset of the old "
        "schema that still covers every attribute the map references"),
    "push_selections": (
        "σ-pushdown: the input schema is preserved exactly — only "
        "triple-irrelevant rows are filtered"),
    "cse": (
        "CSE: pure sharing — every input stays structurally equal to its "
        "pre-pass value and the maps are untouched"),
}


class RewriteSoundnessError(ValueError):
    """A rewrite violated its declared precondition; ``.rewrite`` names
    the offending pass, ``.diagnostics`` holds the findings."""

    def __init__(self, rewrite: str, diagnostics: List[Diagnostic]):
        contract = CONTRACTS.get(rewrite, "(no declared contract)")
        lines = [f"rewrite {rewrite!r} violated its soundness contract",
                 f"  contract: {contract}"]
        lines += [f"  {d}" for d in diagnostics]
        super().__init__("\n".join(lines))
        self.rewrite = rewrite
        self.diagnostics = diagnostics


class _MapsView:
    def __init__(self, maps):
        self.maps = maps


def _check_push_projections(before, plan: LogicalPlan,
                            out: List[Diagnostic]) -> None:
    maps_before, inputs_before = before
    if maps_before != plan.maps:
        out.append(Diagnostic(
            "rewrite", "push_projections",
            "pass modified the triple maps — it may only rewrite inputs"))
        return
    needed = referenced_attrs(_MapsView(plan.maps))
    for tm in plan.maps:
        old, new = inputs_before.get(tm.name), plan.inputs.get(tm.name)
        if new is None or old is None or new == old:
            continue
        old_attrs, new_attrs = set(old.attrs), set(new.attrs)
        missing = needed[tm.name] - new_attrs
        if missing:
            out.append(Diagnostic(
                "rewrite", f"map {tm.name!r}",
                f"projection dropped referenced attrs {sorted(missing)}"))
        invented = new_attrs - old_attrs
        if invented:
            out.append(Diagnostic(
                "rewrite", f"map {tm.name!r}",
                f"projection invented attrs {sorted(invented)} absent "
                "from the original schema"))


def _check_push_selections(before, plan: LogicalPlan,
                           out: List[Diagnostic]) -> None:
    maps_before, inputs_before = before
    if maps_before != plan.maps:
        out.append(Diagnostic(
            "rewrite", "push_selections",
            "pass modified the triple maps — it may only add σ filters"))
        return
    for tm in plan.maps:
        old, new = inputs_before.get(tm.name), plan.inputs.get(tm.name)
        if new is None or old is None or new == old:
            continue
        if tuple(new.attrs) != tuple(old.attrs):
            out.append(Diagnostic(
                "rewrite", f"map {tm.name!r}",
                f"σ-pushdown changed the schema {tuple(old.attrs)} -> "
                f"{tuple(new.attrs)} — a filter must be schema-preserving"
            ))


def _check_merge_maps(before, plan: LogicalPlan,
                      out: List[Diagnostic]) -> None:
    maps_before, _ = before
    old_names = {m.name for m in maps_before}
    for tm in plan.maps:
        if tm.name in old_names:
            continue
        # a freshly merged map: canonical role schema
        sub = tm.subject.referenced_attr
        if sub is not None and sub != "__m0":
            out.append(Diagnostic(
                "rewrite", f"map {tm.name!r}",
                f"merged subject reads {sub!r}, not the canonical '__m0'"))
        want = 0
        for idx, term in sorted_reference_poms(tm):
            if term.kind == "constant":
                continue
            want += 1
            if term.attr != f"__m{want}":
                out.append(Diagnostic(
                    "rewrite", f"map {tm.name!r}",
                    f"merged POM #{idx} reads {term.attr!r}, not the "
                    f"canonical '__m{want}'"))
        node = plan.inputs.get(tm.name)
        if node is None:
            out.append(Diagnostic(
                "rewrite", f"map {tm.name!r}",
                "merged map has no input relation"))
            continue
        roles = {f"__m{i}" for i in range(want + 1)} if sub else \
            {f"__m{i}" for i in range(1, want + 1)}
        missing = roles - set(node.attrs)
        if missing:
            out.append(Diagnostic(
                "rewrite", f"map {tm.name!r}",
                f"merged input lacks role columns {sorted(missing)}"))


def _check_cse(before, plan: LogicalPlan, out: List[Diagnostic]) -> None:
    maps_before, inputs_before = before
    if maps_before != plan.maps:
        out.append(Diagnostic("rewrite", "cse",
                              "CSE modified the triple maps"))
    if set(inputs_before) != set(plan.inputs):
        out.append(Diagnostic(
            "rewrite", "cse",
            f"CSE changed the input set {sorted(inputs_before)} -> "
            f"{sorted(plan.inputs)}"))
        return
    for name, old in inputs_before.items():
        if plan.inputs[name] != old:
            out.append(Diagnostic(
                "rewrite", f"map {name!r}",
                "CSE changed the input's structure — it may only re-share "
                "equal subplans"))


_PASS_CHECKS = {
    "merge_maps": _check_merge_maps,
    "push_projections": _check_push_projections,
    "push_selections": _check_push_selections,
    "cse": _check_cse,
}


def soundness_gate(name: str,
                   before: Tuple[List, Dict[str, Node]],
                   plan: LogicalPlan) -> None:
    """The ``gate=`` callback for :func:`repro_torch.plan.optimize.optimize`:
    assert pass ``name``'s contract over the (maps, inputs) snapshot taken
    before it ran. Raises :class:`RewriteSoundnessError` on violation."""
    out: List[Diagnostic] = []
    check = _PASS_CHECKS.get(name)
    if check is None:
        out.append(Diagnostic(
            "rewrite", name,
            "unknown rewrite pass — no soundness contract declared"))
    else:
        check(before, plan, out)
    # generic structural invariants; hash-consing form only holds post-CSE
    report = verify_plan(plan, check_cse=(name == "cse"))
    out.extend(report.errors())
    if out:
        raise RewriteSoundnessError(name, out)


def checked_optimize(plan: LogicalPlan, max_iters: int = 8,
                     stats: Optional[PlanStats] = None) -> PlanStats:
    """:func:`repro_torch.plan.optimize.optimize` with every rewrite gated by
    :func:`soundness_gate`."""
    return optimize(plan, max_iters=max_iters, stats=stats,
                    gate=soundness_gate)
