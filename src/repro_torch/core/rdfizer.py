"""The semantification engine: evaluates triple maps into device triples.

``RDFizer`` turns a DIS into a closure ``sources -> (kg_triples,
raw_count)``. Two engine modes mirror the paper's two studied engines:

* ``"rmlmapper"`` — blind generation: every map emits every triple
  (duplicates included); duplicate elimination happens once at the sink.
* ``"sdm"`` — duplicate-aware: each map's output is deduplicated as it is
  produced (the SDM-RDFizer strategy), so the sink δ sees far fewer rows.

A triple is a row of the 5-column table ``(s_t, s_v, p, o_t, o_v)`` — see
:mod:`repro_torch.core.schema` for term encoding.

The interior is the plan executor (:mod:`repro_torch.plan.compile`): the
DIS is lowered to the logical IR and compiled to one closure; the RDFizer
only provides the ``EmitTriples`` semantics (term columns, null and σ
masks, block assembly). ``__init__`` pre-interns every constant an
execution could need, and the lookup helpers raise instead of interning,
so running a plan never grows the vocabulary.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.relalg import Table, round_cap
from repro_torch.relalg.guard import host_get, host_int
from repro_torch.relalg.ops import compact

from .schema import (DIS, RDF_TYPE, RefObjectMap, TMPL_CONSTANT,
                     TMPL_LITERAL, TermMap, TRIPLE_ATTRS, TripleMap)

Engine = str  # 'rmlmapper' | 'sdm'


def plan_join_caps(dis: DIS) -> Dict[Tuple[str, int], int]:
    """Exact output capacity per (map, pom_index) join — host-side
    planning, the analogue of cardinality estimation in a query
    optimizer."""
    from repro_torch.plan.annotate import join_match_total
    caps: Dict[Tuple[str, int], int] = {}
    for tm in dis.maps:
        child = dis.sources[tm.source]
        for i, pom in enumerate(tm.poms):
            if not isinstance(pom.object, RefObjectMap):
                continue
            parent_tm = dis.map_by_name(pom.object.parent_map)
            parent = dis.sources[parent_tm.source]
            c = host_get(child.column(pom.object.child_attr))[
                :host_int(child.count)]
            p = host_get(parent.column(pom.object.parent_attr))[
                :host_int(parent.count)]
            caps[(tm.name, i)] = round_cap(join_match_total(c, p))
    return caps


class RDFizer:
    """Evaluator for ``RDFize(DIS)``. Structure (maps, templates,
    capacities) is fixed; source *extensions* are the runtime argument, so
    the closure can be re-run as sources change."""

    def __init__(self, dis: DIS, engine: Engine = "rmlmapper",
                 join_caps: Optional[Dict[Tuple[str, int], int]] = None,
                 dedup: Optional[str] = None):
        if engine not in ("rmlmapper", "sdm"):
            raise ValueError(f"unknown engine {engine!r}")
        self.dis = dis
        self.engine = engine
        self.dedup = dedup  # δ strategy: 'lex' | 'hash' | None (default)
        self.join_caps = plan_join_caps(dis) if join_caps is None else join_caps
        self.rdf_type_code = dis.vocab.intern(RDF_TYPE)
        # pre-intern EVERY constant an execution could touch (the lookups
        # below raise instead of interning)
        self._pred = {p.predicate: dis.vocab.intern(p.predicate)
                      for m in dis.maps for p in m.poms}
        self._class = {m.subject_class: dis.vocab.intern(m.subject_class)
                       for m in dis.maps if m.subject_class}
        self._const = {p.object.constant: dis.vocab.intern(p.object.constant)
                       for m in dis.maps for p in m.poms
                       if isinstance(p.object, TermMap)
                       and p.object.kind == "constant"}
        self._subj_const = {m.subject.constant:
                            dis.vocab.intern(m.subject.constant)
                            for m in dis.maps if m.subject.kind == "constant"}
        self._sel = {sel.value: dis.vocab.intern(sel.value)
                     for m in dis.maps for sel in m.selections
                     if sel.op in ("eq", "neq")}
        self._subject_tmpl = {m.name: self._term_tmpl(m.subject)
                              for m in dis.maps}
        # pre-register every object template id too — template_id mutates
        # dis.templates on a new template
        self._tmpl_ids = {t: self._term_tmpl(t) for m in dis.maps
                          for t in [m.subject] + [p.object for p in m.poms
                                                  if isinstance(p.object,
                                                                TermMap)]}
        self._plan_caps = None  # (plan, node caps), built lazily
        self._compiled = None   # sources -> (kg, raw), built lazily

    # -- static helpers ------------------------------------------------------
    def _term_tmpl(self, t: TermMap) -> int:
        if t.kind == "reference":
            return TMPL_LITERAL
        if t.kind == "constant":
            return TMPL_CONSTANT
        return self.dis.template_id(t.template)

    def _code(self, table: Dict, value, what: str) -> int:
        code = table.get(value)
        if code is None:
            raise RuntimeError(
                f"{what} {value!r} was not pre-interned; executing a plan "
                "must not grow the vocabulary — register it on the DIS "
                "before building the RDFizer")
        return code

    def _null_ok(self, col: torch.Tensor) -> torch.Tensor:
        if self.dis.null_code is None:
            return torch.ones_like(col, dtype=torch.bool)
        return col != self.dis.null_code

    # -- evaluation ----------------------------------------------------------
    def _term_cols(self, t: TermMap, table: Table
                   ) -> Tuple[int, torch.Tensor, torch.Tensor]:
        """(tmpl_id, value column, validity) for a non-join term map."""
        cap = table.capacity
        if t.kind == "constant":
            code = self._code(self._const, t.constant, "constant")
            col = torch.full((cap,), code, dtype=torch.int32,
                             device=table.device)
            return TMPL_CONSTANT, col, torch.ones((cap,), dtype=torch.bool,
                                                  device=table.device)
        col = table.column(t.attr)
        tmpl = self._tmpl_ids.get(t)
        if tmpl is None:
            raise RuntimeError(
                f"term map {t!r} was not pre-registered — build the "
                "RDFizer over a DIS that contains this map")
        return tmpl, col, self._null_ok(col)

    def _selection_mask(self, tm: TripleMap, table: Table) -> torch.Tensor:
        """σ mask of the map's explicit selections over ``table`` (which may
        be the source relation or a join output carrying its attrs)."""
        mask = torch.ones((table.capacity,), dtype=torch.bool,
                          device=table.device)
        for sel in tm.selections:
            col = table.column(sel.attr)
            if sel.op == "notnull":
                if self.dis.null_code is not None:
                    mask &= col != self.dis.null_code
            elif sel.op == "eq":
                mask &= col == self._code(self._sel, sel.value,
                                          "selection value")
            else:
                mask &= col != self._code(self._sel, sel.value,
                                          "selection value")
        return mask

    def _block(self, s_t: int, s_v: torch.Tensor, p: int, o_t: int,
               o_v: torch.Tensor, mask: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        cap, dev = s_v.shape[0], s_v.device

        def const(v: int) -> torch.Tensor:
            return torch.full((cap,), v, dtype=torch.int32, device=dev)

        data = torch.stack([const(s_t), s_v.to(torch.int32), const(p),
                            const(o_t), o_v.to(torch.int32)], dim=1)
        return data, mask

    def _const_col(self, value, n: int, device) -> torch.Tensor:
        code = self._code(self._subj_const, value, "subject constant")
        return torch.full((n,), code, dtype=torch.int32, device=device)

    def emit_triples(self, tm: TripleMap, table: Table,
                     joins: Dict[int, Table]) -> Table:
        """All triples of one map (bag semantics). ``table`` is the map's
        relation; ``joins[i]`` is the pre-joined table for join POM ``i``
        (child attrs + ``__ps`` = parent subject)."""
        s_t = self._subject_tmpl[tm.name]
        if tm.subject.attr:
            s_v = table.column(tm.subject.attr)
        else:  # constant subject (legal but unusual)
            s_v = self._const_col(tm.subject.constant, table.capacity,
                                  table.device)
        s_ok = table.valid_mask & self._null_ok(s_v) & \
            self._selection_mask(tm, table)

        blocks: List[Tuple[torch.Tensor, torch.Tensor]] = []
        if tm.subject_class:
            cls = self._class[tm.subject_class]
            blocks.append(self._block(
                s_t, s_v, self.rdf_type_code, TMPL_CONSTANT,
                torch.full((table.capacity,), cls, dtype=torch.int32,
                           device=table.device), s_ok))

        for i, pom in enumerate(tm.poms):
            p_code = self._pred[pom.predicate]
            if isinstance(pom.object, RefObjectMap):
                joined = joins[i]
                parent_tm = self.dis.map_by_name(pom.object.parent_map)
                if tm.subject.attr:
                    s_vj = joined.column(tm.subject.attr)
                else:  # constant child subject
                    s_vj = self._const_col(tm.subject.constant,
                                           joined.capacity, joined.device)
                if parent_tm.subject.attr:
                    o_v = joined.column("__ps")
                else:  # constant parent subject (not carried by the ⋈)
                    o_v = self._const_col(parent_tm.subject.constant,
                                          joined.capacity, joined.device)
                mask = joined.valid_mask & self._null_ok(s_vj) & \
                    self._null_ok(o_v) & self._selection_mask(tm, joined)
                blocks.append(self._block(
                    s_t, s_vj, p_code, self._subject_tmpl[parent_tm.name],
                    o_v, mask))
            else:
                o_t, o_v, o_ok = self._term_cols(pom.object, table)
                blocks.append(self._block(s_t, s_v, p_code, o_t, o_v,
                                          s_ok & o_ok))

        if not blocks:  # a map with neither class nor POMs emits nothing
            return Table.empty(TRIPLE_ATTRS, 8, device=table.device)
        data = torch.cat([b[0] for b in blocks], dim=0)
        mask = torch.cat([b[1] for b in blocks], dim=0)
        data, count = compact(data, mask)
        return Table(data=data, count=count, attrs=TRIPLE_ATTRS)

    # -- plan construction ---------------------------------------------------
    def _build_plan(self):
        if self._plan_caps is None:
            from repro_torch.plan import lower
            plan = lower(self.dis)
            caps = {}
            for tm in plan.maps:
                for i, pom in enumerate(tm.poms):
                    if isinstance(pom.object, RefObjectMap):
                        node = plan.join_node(tm, i)
                        cap = self.join_caps.get((tm.name, i))
                        if cap is not None:
                            caps[node] = cap
            self._plan_caps = (plan, caps)
        return self._plan_caps

    def __call__(self, sources: Optional[Dict[str, Table]] = None
                 ) -> Tuple[Table, torch.Tensor]:
        """Evaluate all maps; returns (deduplicated KG, raw triple count).

        ``raw`` counts the triples materialized *before* the sink dedup.
        """
        from repro_torch.plan.compile import compile_plan
        if self._compiled is None:
            plan, caps = self._build_plan()
            self._compiled = compile_plan(plan, self, engine=self.engine,
                                          dedup=self.dedup, caps=caps)
        sources = self.dis.sources if sources is None else sources
        return self._compiled(sources)


def rdfize(dis: DIS, engine: Engine = "rmlmapper",
           dedup: Optional[str] = None) -> Tuple[Table, int]:
    """DEPRECATED eager wrapper: ``RDFize(DIS)`` -> (KG, raw count).

    .. deprecated:: removal target — goes away together with the
       ``repro_torch.core.pipeline`` shims (``make_planned_fn``,
       ``make_mapsdi_fn``).

    Delegates to a :class:`repro_torch.api.KGEngine` session with
    ``optimize=False`` (blind evaluation of the un-rewritten rules — the
    semantics ``raw`` has always measured) on the DIS's device, so
    repeated rdfize calls over structurally-identical DISes share one
    cached closure. Use ``KGEngine(dis, config=EngineConfig(engine=...,
    dedup=..., optimize=False))`` directly for session state (ingestion,
    stats)."""
    from repro_torch.api import EngineConfig, KGEngine
    from .pipeline import _warn_once
    _warn_once("rdfize",
               "KGEngine(dis, config=EngineConfig(optimize=False)).run()")
    config = EngineConfig(engine=engine, dedup=dedup, optimize=False)
    kg, raw = KGEngine(dis, config=config, device=dis.device).run()
    return kg, host_int(raw)


# -- host-side sink (strings only at the edge) -------------------------------

def triples_to_ntriples(kg: Table, dis: DIS) -> List[str]:
    """Decode device triples to N-Triples-ish text lines (host sink)."""
    inv_tmpl = {v: k for k, v in dis.templates.items()}
    out = []
    for s_t, s_v, p, o_t, o_v in kg.to_codes():
        out.append(f"{_term(inv_tmpl, dis, s_t, s_v)} "
                   f"<{dis.vocab.decode(p)}> "
                   f"{_term(inv_tmpl, dis, o_t, o_v)} .")
    return out


def _term(inv_tmpl, dis: DIS, t: int, v: int) -> str:
    val = dis.vocab.decode(v)
    if t == TMPL_LITERAL:
        return f'"{val}"'
    if t == TMPL_CONSTANT:
        return f"<{val}>"
    return f"<{inv_tmpl[int(t)].format(val)}>"
