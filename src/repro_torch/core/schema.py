"""Data model of a data integration system ``DIS_G = <O, S, M>``.

Mirrors the paper's §3 formalization: a unified schema ``O`` (classes and
properties derived from the mapping rules), sources ``S`` with signatures
(attribute sets) and extensions (:class:`~repro_torch.relalg.Table`), and
mapping rules ``M`` expressed in an RML subset (triples maps with subject/
predicate-object maps and join conditions).

RDF terms on device are int32 pairs ``(tmpl_id, val_id)``:

* ``tmpl_id == TMPL_LITERAL`` (0): plain literal whose text is
  ``vocab.decode(val_id)`` — produced by ``rml:reference`` object maps.
* ``tmpl_id == TMPL_CONSTANT`` (1): constant IRI ``vocab.decode(val_id)`` —
  produced by ``rr:constant`` (and ``rr:class``/predicates).
* ``tmpl_id >= TMPL_BASE`` (2): IRI from an ``rr:template`` with a single
  placeholder; the IRI text is ``template.format(vocab.decode(val_id))``.

Two terms are equal iff their pairs are equal; distinct templates are assumed
not to collide textually (standard in RML practice).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.device import DeviceLike
from repro_torch.relalg import Table, Vocab

TMPL_LITERAL = 0
TMPL_CONSTANT = 1
TMPL_BASE = 2

RDF_TYPE = "rdf:type"

TRIPLE_ATTRS = ("s_t", "s_v", "p", "o_t", "o_v")


def map_by_name(maps, name: str) -> "TripleMap":
    """Look a triple map up by name in any map collection (shared by DIS
    and the planner's LogicalPlan)."""
    for m in maps:
        if m.name == name:
            return m
    raise KeyError(f"no triple map named {name!r}")


@dataclasses.dataclass(frozen=True)
class TermMap:
    """rr:subjectMap / rr:objectMap — one of reference/template/constant."""

    kind: str  # 'reference' | 'template' | 'constant'
    attr: Optional[str] = None        # for reference/template
    template: Optional[str] = None    # for template (single {placeholder})
    constant: Optional[object] = None  # for constant

    def __post_init__(self):
        if self.kind not in ("reference", "template", "constant"):
            raise ValueError(f"bad TermMap kind {self.kind!r}")
        if self.kind in ("reference", "template") and self.attr is None:
            raise ValueError(f"{self.kind} TermMap needs attr")
        if self.kind == "template" and self.template is None:
            raise ValueError("template TermMap needs template string")

    @property
    def referenced_attr(self) -> Optional[str]:
        return self.attr if self.kind in ("reference", "template") else None

    def signature(self) -> Tuple:
        """Merge-compatibility signature — attr *names* excluded (Rule 3
        merges maps whose attrs differ only in name)."""
        if self.kind == "reference":
            return ("reference",)
        if self.kind == "template":
            return ("template", self.template)
        return ("constant", self.constant)


@dataclasses.dataclass(frozen=True)
class RefObjectMap:
    """rr:parentTriplesMap + rr:joinCondition (single child==parent pair)."""

    parent_map: str
    child_attr: str
    parent_attr: str


@dataclasses.dataclass(frozen=True)
class Selection:
    """σ predicate on a map's logical source (the paper's selection of
    relevant entries). Filters every triple the map emits, including rows it
    contributes to joins as a parent."""

    attr: str
    op: str                          # 'eq' | 'neq' | 'notnull'
    value: Optional[object] = None   # for eq/neq; interned via the vocab

    def __post_init__(self):
        if self.op not in ("eq", "neq", "notnull"):
            raise ValueError(f"bad Selection op {self.op!r}")
        if self.op in ("eq", "neq") and self.value is None:
            raise ValueError(f"{self.op} Selection needs a value")


@dataclasses.dataclass(frozen=True)
class PredicateObjectMap:
    predicate: str
    object: Union[TermMap, RefObjectMap]

    @property
    def is_join(self) -> bool:
        return isinstance(self.object, RefObjectMap)


@dataclasses.dataclass(frozen=True)
class TripleMap:
    """One RML triples map (a GAV conjunctive rule in the paper's algebra)."""

    name: str
    source: str                      # key into DIS.sources
    subject: TermMap
    subject_class: Optional[str] = None   # rr:class -> (s, rdf:type, class)
    poms: Tuple[PredicateObjectMap, ...] = ()
    selections: Tuple[Selection, ...] = ()  # σ over the logical source

    @property
    def join_poms(self) -> List[PredicateObjectMap]:
        return [p for p in self.poms if p.is_join]

    @property
    def has_join(self) -> bool:
        return any(p.is_join for p in self.poms)


@dataclasses.dataclass
class DIS:
    """A data integration system: sources S (+extensions) and rules M.

    ``O`` (the unified schema) is implicit: ``classes()`` / ``properties()``
    enumerate the signature induced by the rules, as in GAV.
    """

    sources: Dict[str, Table]
    maps: List[TripleMap]
    vocab: Vocab
    templates: Dict[str, int] = dataclasses.field(default_factory=dict)
    null_code: Optional[int] = None
    # names of sources known to be projected+deduplicated already (MapSDI
    # provenance — makes the transformation rules idempotent)
    preprocessed: set = dataclasses.field(default_factory=set)
    # names of sources whose extension already satisfies the owning maps'
    # σ selections (set by the planner's materialization, where σ is pushed
    # below the final shrink; the eager driver never bakes σ, so its DIS'
    # keeps the join-time parent re-select)
    sigma_baked: set = dataclasses.field(default_factory=set)

    def template_id(self, template: str) -> int:
        tid = self.templates.get(template)
        if tid is None:
            tid = TMPL_BASE + len(self.templates)
            self.templates[template] = tid
        return tid

    def map_by_name(self, name: str) -> TripleMap:
        return map_by_name(self.maps, name)

    @property
    def device(self):
        """The device the sources' extensions live on (None for a DIS
        without sources): the port's entry points over a DIS run there."""
        devices = {t.device for t in self.sources.values()}
        if len(devices) > 1:
            raise ValueError(f"the DIS's sources lie on several devices: "
                             f"{sorted(map(str, devices))}")
        return next(iter(devices), None)

    # -- unified schema O ---------------------------------------------------
    def classes(self) -> List[str]:
        return sorted({m.subject_class for m in self.maps if m.subject_class})

    def properties(self) -> List[str]:
        return sorted({p.predicate for m in self.maps for p in m.poms})

    @classmethod
    def from_numpy(cls, sources: Mapping[str, Tuple], vocab_terms: Sequence,
                   maps: Sequence[Mapping], *,
                   device: DeviceLike = None) -> "DIS":
        """A DIS from plain data: ``sources[name] = (codes, attrs)`` or
        ``(codes, attrs, capacity)`` with ``codes`` an [n, k] int array,
        the vocabulary's terms in id order, and the maps in the JSON form
        :func:`repro_torch.core.rml.parse_dis` takes. The null code is
        the id of ``None`` when the vocabulary holds it, and templates are
        registered in the order ``parse_dis`` registers them, so the same
        pieces give the same codes as the DIS they were taken from."""
        from .rml import parse_triple_map, register_constants
        vocab = Vocab()
        for term in vocab_terms:
            vocab.intern(term)
        if len(vocab) != len(vocab_terms):
            raise ValueError("vocab_terms holds a duplicate term")
        tables = {}
        for name, src in sources.items():
            codes, attrs = src[0], src[1]
            capacity = src[2] if len(src) > 2 else None
            tables[name] = Table.from_codes(np.asarray(codes), attrs,
                                            capacity, device=device)
        dis = cls(sources=tables, maps=[parse_triple_map(m) for m in maps],
                  vocab=vocab,
                  null_code=vocab.lookup(None) if None in vocab else None)
        register_constants(dis)
        return dis

    def copy(self) -> "DIS":
        return DIS(sources=dict(self.sources), maps=list(self.maps),
                   vocab=self.vocab, templates=dict(self.templates),
                   null_code=self.null_code,
                   preprocessed=set(self.preprocessed),
                   sigma_baked=set(self.sigma_baked))
