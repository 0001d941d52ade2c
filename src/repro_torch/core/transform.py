"""MapSDI Transformation Rules 1–3 and their fixpoint.

Rewrites ``DIS_G = <O, S, M>`` into ``DIS'_G = <O, S', M'>`` with
``RDFize(DIS) == RDFize(DIS')`` (set semantics) and less work for the
semantification engine:

* Rule 1 (projection of attributes) — join-free maps get a projected +
  deduplicated copy of their source restricted to the referenced attrs.
* Rule 2 (pushing projections into joins) — the same projection applied to
  the child and parent sources of join conditions, keeping the ``Z̄`` set
  (head attrs + join attrs) of the formalization.
* Rule 3 (merging sources with equivalent attributes) — join-free maps with
  equal heads over different sources are merged: project each source to the
  referenced attrs under canonical role names, union, dedup; the maps
  collapse into one.

Two fixpoint loops share that rule set:

* :func:`apply_mapsdi` (the default) plans **symbolically**: the DIS is
  lowered to the logical IR (:mod:`repro_torch.plan`), Rules 1–3 +
  selection pushdown + CSE run as pure rewrites with no device work and no
  host syncs, and the final plan is materialized once
  (:func:`repro_torch.plan.compile.materialize_plan`): shared subplans
  computed once, then one ``shrink_to_fit`` per new source.
* :func:`apply_mapsdi_eager` is the historical loop: each rewrite
  materializes + shrinks its sources (host sync) every iteration. It is
  the independent oracle for the planner.

Every device operation runs where the DIS's sources live.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.relalg import (Table, distinct, project_as, round_cap,
                                shrink_to_fit, union)
from repro_torch.relalg.guard import host_int

from .analyze import merge_groups, referenced_attrs, sorted_reference_poms
from .schema import DIS, PredicateObjectMap, RefObjectMap, TripleMap

__all__ = [
    "TransformStats", "apply_mapsdi", "apply_mapsdi_eager", "apply_merge",
    "apply_projection", "plan_mapsdi", "round_cap", "shrink_to_fit",
]


@dataclasses.dataclass
class TransformStats:
    rule1_applications: int = 0
    rule2_applications: int = 0
    rule3_merges: int = 0
    sigma_pushdowns: int = 0
    cse_shared_subplans: int = 0
    source_rows_before: Dict[str, int] = dataclasses.field(default_factory=dict)
    source_rows_after: Dict[str, int] = dataclasses.field(default_factory=dict)


# ---------------------------------------------------------------------------
# Rules 1 & 2: projection (+dedup) pushdown (eager form)
# ---------------------------------------------------------------------------

def apply_projection(dis: DIS, stats: Optional[TransformStats] = None,
                     dedup: Optional[str] = None) -> DIS:
    """Rules 1 and 2. Each map's source is replaced by
    ``δ(π_{referenced}(S))``; identical (source, attr-set) projections are
    shared between maps. Maps are rewritten in place (attr names survive,
    so only ``TripleMap.source`` changes). ``dedup`` picks the δ strategy
    (``"lex"`` | ``"hash"``; None = engine default)."""
    needed = referenced_attrs(dis)
    out = dis.copy()
    shared: Dict[Tuple[str, Tuple[str, ...]], str] = {}
    new_maps: List[TripleMap] = []
    for tm in dis.maps:
        attrs = tuple(sorted(needed[tm.name]))
        src = dis.sources[tm.source]
        if tm.source in dis.preprocessed and attrs == tuple(sorted(src.attrs)):
            new_maps.append(tm)  # already in projected+dedup'd form
            continue
        key = (tm.source, attrs)
        if key not in shared:
            proj = distinct(project_as(src, [(a, a) for a in attrs]),
                            dedup=dedup)
            proj = shrink_to_fit(proj)
            name = f"{tm.source}__pi_" + "_".join(attrs)
            out.sources[name] = proj
            out.preprocessed.add(name)
            shared[key] = name
            if stats is not None:
                if tm.has_join:
                    stats.rule2_applications += 1
                else:
                    stats.rule1_applications += 1
        new_maps.append(dataclasses.replace(tm, source=shared[key]))
    out.maps = new_maps
    # drop now-unreferenced originals
    used = {m.source for m in out.maps}
    out.sources = {k: v for k, v in out.sources.items() if k in used}
    return out


# ---------------------------------------------------------------------------
# Rule 3: merging sources with equivalent attributes (eager form)
# ---------------------------------------------------------------------------

def _join_parents(dis: DIS) -> Set[str]:
    return {p.object.parent_map for m in dis.maps for p in m.poms
            if isinstance(p.object, RefObjectMap)}


def apply_merge(dis: DIS, stats: Optional[TransformStats] = None,
                dedup: Optional[str] = None) -> DIS:
    """Rule 3 on every mergeable group. Maps that serve as join parents are
    conservatively kept separate (their names are referenced by other maps).
    Canonical role attrs are ``__m0`` (subject) and ``__m{i}`` for the i-th
    (predicate-sorted) non-constant object reference. ``dedup`` picks the
    δ strategy for the merged-source set-union."""
    parents = _join_parents(dis)
    out = dis.copy()
    merged_any = False
    for gi, group in enumerate(merge_groups(dis)):
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

        # project every member source to the role schema, union + dedup
        merged: Optional[Table] = None
        for tm in group:
            spec: List[Tuple[str, str]] = []
            if tm.subject.referenced_attr:
                spec.append((tm.subject.referenced_attr, "__m0"))
            r_nonconst = 0
            for idx, term in sorted_reference_poms(tm):
                if term.kind == "constant":
                    continue
                r_nonconst += 1
                spec.append((term.attr, f"__m{r_nonconst}"))
            part = project_as(dis.sources[tm.source], spec)
            merged = part if merged is None else union(merged, part)
        assert merged is not None
        merged = shrink_to_fit(distinct(merged, dedup=dedup))
        merged_name = f"merged_{gi}_" + "_".join(tm.name for tm in group)

        subject = (dataclasses.replace(lead.subject, attr="__m0")
                   if lead.subject.referenced_attr else lead.subject)
        merged_map = TripleMap(
            name=f"TM_merged_{gi}", source=merged_name, subject=subject,
            subject_class=lead.subject_class, poms=tuple(canon_poms))

        out.sources[merged_name] = merged
        out.preprocessed.add(merged_name)
        group_names = {tm.name for tm in group}
        out.maps = [m for m in out.maps if m.name not in group_names]
        out.maps.append(merged_map)
        merged_any = True
        if stats is not None:
            stats.rule3_merges += 1
    if merged_any:
        used = {m.source for m in out.maps} | {
            out.map_by_name(p.object.parent_map).source
            for m in out.maps for p in m.poms
            if isinstance(p.object, RefObjectMap)}
        out.sources = {k: v for k, v in out.sources.items() if k in used}
    return out


# ---------------------------------------------------------------------------
# fixpoint loops
# ---------------------------------------------------------------------------

def _dis_signature(dis: DIS) -> Tuple:
    from .rml import triple_map_to_json
    maps_sig = tuple(sorted(str(triple_map_to_json(m)) for m in dis.maps))
    src_sig = tuple(sorted((k, v.attrs, v.capacity, host_int(v.count))
                           for k, v in dis.sources.items()))
    return maps_sig, src_sig


def plan_mapsdi(dis: DIS, max_iters: int = 8,
                stats: Optional[TransformStats] = None, gate=None):
    """Symbolic fixpoint: lower the DIS and run the optimizer (Rules 1–3 +
    σ pushdown + CSE) to convergence. Pure host-side rewriting — no device
    work, no host syncs. Returns the optimized
    :class:`~repro_torch.plan.lower.LogicalPlan`. ``gate`` is forwarded to
    :func:`repro_torch.plan.optimize.optimize` (the rewrite-soundness
    hook)."""
    from repro_torch.plan.lower import lower
    from repro_torch.plan.optimize import optimize
    plan = lower(dis)
    pstats = optimize(plan, max_iters=max_iters, gate=gate)
    if stats is not None:
        stats.rule1_applications += pstats.rule1_applications
        stats.rule2_applications += pstats.rule2_applications
        stats.rule3_merges += pstats.rule3_merges
        stats.sigma_pushdowns += pstats.sigma_pushdowns
        stats.cse_shared_subplans += pstats.cse_shared_subplans
    return plan


def apply_mapsdi(dis: DIS, max_iters: int = 8,
                 stats: Optional[TransformStats] = None,
                 dedup: Optional[str] = None
                 ) -> Tuple[DIS, TransformStats]:
    """Rules 1–3 (+ σ pushdown, CSE) to a fixpoint, planner-backed: the
    fixpoint runs entirely on the symbolic plan and the result is
    materialized once at the end. ``dedup`` picks the δ strategy used by
    the single materialization."""
    from repro_torch.plan.compile import materialize_plan
    stats = stats or TransformStats()
    plan = plan_mapsdi(dis, max_iters=max_iters, stats=stats)
    out, rows_after = materialize_plan(plan, dedup=dedup)
    stats.source_rows_before = {k: host_int(v.count)
                                for k, v in dis.sources.items()}
    stats.source_rows_after = rows_after
    return out, stats


def apply_mapsdi_eager(dis: DIS, max_iters: int = 8,
                       stats: Optional[TransformStats] = None,
                       dedup: Optional[str] = None
                       ) -> Tuple[DIS, TransformStats]:
    """The historical materializing fixpoint: every iteration rewrites and
    shrinks sources on device with host syncs in between. Oracle for the
    planner."""
    stats = stats or TransformStats()
    stats.source_rows_before = {k: host_int(v.count)
                                for k, v in dis.sources.items()}
    cur = dis
    prev_sig = None
    for _ in range(max_iters):
        cur = apply_merge(cur, stats, dedup=dedup)
        cur = apply_projection(cur, stats, dedup=dedup)
        sig = _dis_signature(cur)
        if sig == prev_sig:
            break
        prev_sig = sig
    stats.source_rows_after = {k: host_int(v.count)
                               for k, v in cur.sources.items()}
    return cur, stats
