"""Lowering: a ``DIS`` becomes one logical-plan DAG.

``lower(dis)`` produces a :class:`LogicalPlan` whose per-map relation inputs
start as bare :class:`~repro_torch.plan.ir.Scan` nodes; the optimizer then rewrites
those inputs symbolically (Rules 1–3 + σ pushdown + CSE) without touching a
single device array. ``plan.emits()`` / ``plan.sink(engine)`` extend the DAG
over semantification — join POMs become :class:`EquiJoin` nodes over the
*current* inputs, every map an :class:`EmitTriples`, and the whole KG is
``δ(∪ emits)`` — so one DAG covers pre-processing *and* semantification.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.schema import DIS, RefObjectMap, TripleMap, map_by_name

from .ir import (Distinct, EmitTriples, EquiJoin, Node, Pred, Project, Scan,
                 Select, Union, iter_nodes, make_select)


def selection_preds(dis: DIS, tm: TripleMap) -> Tuple[Pred, ...]:
    """The map's explicit σ selections as IR predicates (codes interned)."""
    preds: List[Pred] = []
    for sel in tm.selections:
        if sel.op == "notnull":
            if dis.null_code is None:
                continue
            preds.append(Pred(sel.attr, "notnull", dis.null_code))
        else:
            preds.append(Pred(sel.attr, sel.op, dis.vocab.intern(sel.value)))
    return tuple(preds)


@dataclasses.dataclass
class LogicalPlan:
    """Symbolic state of the planner: rewritten maps + per-map relations.

    ``inputs[name]`` is the relation the map named ``name`` semantifies;
    ``names`` remembers materialization names chosen during rewrites (e.g.
    Rule-3 merged sources). ``preprocessed`` carries the provenance flags of
    the source DIS so re-planning an already-minimized DIS is a no-op.
    """

    dis: DIS
    maps: List[TripleMap]
    inputs: Dict[str, Node]
    names: Dict[Node, str] = dataclasses.field(default_factory=dict)
    preprocessed: frozenset = frozenset()
    # sources whose extension already satisfies the owning maps' σ
    # selections (planner-materialized DIS' — σ was pushed below the
    # materialization; eager-materialized DIS' never bakes σ)
    sigma_baked: frozenset = frozenset()

    def map_by_name(self, name: str) -> TripleMap:
        return map_by_name(self.maps, name)

    # -- DAG construction over semantification ------------------------------
    def join_node(self, tm: TripleMap, pom_idx: int) -> EquiJoin:
        """⋈ feeding the join POM ``tm.poms[pom_idx]``: child relation
        against the parent relation projected to (subject, join key) under
        the reserved ``__ps``/``__pk`` names. Parent σ selections are
        applied here — unless the optimizer already sank them into the
        parent's relation (re-selecting an already-filtered table would
        cost a full compact per join per run)."""
        rom = tm.poms[pom_idx].object
        assert isinstance(rom, RefObjectMap)
        parent_tm = self.map_by_name(rom.parent_map)
        parent_in = self.inputs[parent_tm.name]
        if isinstance(parent_in, Scan) and \
                parent_in.source in self.sigma_baked:
            preds: Tuple[Pred, ...] = ()  # σ-baked provenance: the
            # materialized extension is already filtered, skip the
            # (idempotent) re-select and its full compact per join per run
        else:
            have = {p for n in iter_nodes(parent_in)
                    if isinstance(n, Select) for p in n.preds}
            preds = tuple(p for p in selection_preds(self.dis, parent_tm)
                          if p not in have)
        parent_in = make_select(parent_in, preds)
        spec = (((parent_tm.subject.attr, "__ps"),)
                if parent_tm.subject.attr else ()) + \
            ((rom.parent_attr, "__pk"),)
        right = Project(parent_in, spec)
        return EquiJoin(self.inputs[tm.name], right, rom.child_attr, "__pk")

    def emit_node(self, tm: TripleMap) -> EmitTriples:
        joins = tuple((i, self.join_node(tm, i))
                      for i, pom in enumerate(tm.poms)
                      if isinstance(pom.object, RefObjectMap))
        return EmitTriples(tm, self.inputs[tm.name], joins)

    def emits(self) -> List[EmitTriples]:
        return [self.emit_node(tm) for tm in self.maps]

    def sink(self, engine: str = "rmlmapper") -> Node:
        """The full-pipeline DAG: δ over the union of every map's triples
        (per-map δ first under the duplicate-aware ``"sdm"`` engine). A
        single-map sdm plan needs no sink δ on top of its per-map δ
        (δδ = δ). Must mirror the execution semantics in
        :func:`repro_torch.plan.compile.compile_plan`."""
        outs: List[Node] = list(self.emits())
        if engine == "sdm":
            outs = [Distinct(e) for e in outs]
        merged = outs[0] if len(outs) == 1 else Union(tuple(outs))
        return merged if isinstance(merged, Distinct) else Distinct(merged)


def lower(dis: DIS) -> LogicalPlan:
    """``DIS -> LogicalPlan`` with identity (Scan) relation inputs."""
    inputs: Dict[str, Node] = {}
    for tm in dis.maps:
        src = dis.sources[tm.source]
        inputs[tm.name] = Scan(tm.source, tuple(src.attrs))
    return LogicalPlan(dis=dis, maps=list(dis.maps), inputs=inputs,
                       preprocessed=frozenset(dis.preprocessed),
                       sigma_baked=frozenset(dis.sigma_baked))
