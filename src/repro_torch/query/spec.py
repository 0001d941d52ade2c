"""BGP query specs + their structural fingerprints and cache keys.

A :class:`Query` is a basic graph pattern over the coded KG table: a
conjunction of :class:`TriplePattern`\\ s whose subject/predicate/object
positions hold either a *constant* (dictionary codes — a ``(template,
value)`` pair for subject/object terms, a single code for predicates) or a
*variable* (a ``"?name"`` string), plus optional :class:`QueryFilter`\\ s
and a projection. Semantics are SPARQL ``SELECT DISTINCT`` restricted to
connected BGPs (every pattern must share a variable with the patterns
before it — there is no cartesian-product operator in the IR).

This module is also the query tier's **cache-key module**: fingerprints and
session keys derived here must be process-stable (no ``id()``/``hash()``,
sorted iteration only) because they feed the plan cache exactly like
:func:`repro_torch.plan.ir.fingerprint` does for creation plans, and they
equal the reference's keys for the same query.
"""
from __future__ import annotations

import dataclasses
import hashlib
import re
from typing import Dict, Optional, Tuple, Union

from repro_torch.core.schema import TRIPLE_ATTRS

#: the reserved source name the query DAG's Scan reads the KG table under
KG_SOURCE = "__kg__"

_VAR_RE = re.compile(r"^\?[A-Za-z][A-Za-z0-9_]*$")

Term = Union[str, int, Tuple[int, int]]


def is_var(term) -> bool:
    """True iff ``term`` is a variable (``"?name"`` string)."""
    return isinstance(term, str)


def var_name(term: str) -> str:
    return term[1:]


def _check_var(term: str, where: str) -> None:
    if not _VAR_RE.match(term):
        raise ValueError(f"bad query variable {term!r} in {where} "
                         "(expected '?name', name = [A-Za-z][A-Za-z0-9_]*)")
    if term[1:].startswith("r_"):
        raise ValueError(f"bad query variable {term!r} in {where} "
                         "(names starting with 'r_' collide with the ⋈ "
                         "rename suffix)")


def _check_term_const(term, where: str) -> None:
    if not (isinstance(term, tuple) and len(term) == 2
            and all(isinstance(c, int) and not isinstance(c, bool)
                    for c in term)):
        raise ValueError(f"bad term constant {term!r} in {where} "
                         "(expected a (template, value) code pair or a "
                         "'?var')")


@dataclasses.dataclass(frozen=True)
class TriplePattern:
    """One BGP triple pattern over coded terms.

    ``s``/``o`` are ``"?var"`` or an ``(template_code, value_code)`` int
    pair; ``p`` is ``"?var"`` or a single predicate code. A variable may
    appear in term (subject/object) positions or in predicate positions,
    never both (the coded spaces differ: terms are column pairs,
    predicates single codes).
    """

    s: Term
    p: Term
    o: Term

    def __post_init__(self):
        for pos, term in (("s", self.s), ("o", self.o)):
            if is_var(term):
                _check_var(term, f"pattern position {pos!r}")
            else:
                _check_term_const(term, f"pattern position {pos!r}")
        if is_var(self.p):
            _check_var(self.p, "pattern position 'p'")
        elif not (isinstance(self.p, int) and not isinstance(self.p, bool)):
            raise ValueError(f"bad predicate constant {self.p!r} "
                             "(expected a single code or a '?var')")

    def vars(self) -> Tuple[str, ...]:
        """Distinct variable names in s, p, o order."""
        out = []
        for term in (self.s, self.p, self.o):
            if is_var(term) and var_name(term) not in out:
                out.append(var_name(term))
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class QueryFilter:
    """One filter conjunct: ``?var <op> constant`` over coded terms.

    ``op`` is ``"eq"`` or ``"neq"``; ``term`` is a ``(template, value)``
    pair when ``var`` binds terms, a single code when it binds predicates
    (checked against the query's variable kinds at :class:`Query`
    construction).
    """

    var: str
    op: str
    term: Union[int, Tuple[int, int]]

    def __post_init__(self):
        _check_var(self.var, "filter")
        if self.op not in ("eq", "neq"):
            raise ValueError(f"bad filter op {self.op!r} "
                             "(expected 'eq' or 'neq')")


@dataclasses.dataclass(frozen=True)
class Query:
    """A BGP query: patterns + optional filters and projection.

    ``project`` selects (and orders) the answer variables; ``None`` means
    every variable, sorted by name. Results always have set semantics
    (``SELECT DISTINCT``). A query with no variables is an existence check:
    it must be a single all-constant pattern and returns the matching
    triple rows themselves (0 or 1 after δ).
    """

    patterns: Tuple[TriplePattern, ...]
    filters: Tuple[QueryFilter, ...] = ()
    project: Optional[Tuple[str, ...]] = None

    def __post_init__(self):
        object.__setattr__(self, "patterns", tuple(self.patterns))
        object.__setattr__(self, "filters", tuple(self.filters))
        if self.project is not None:
            object.__setattr__(self, "project", tuple(self.project))
        if not self.patterns:
            raise ValueError("empty query (no triple patterns)")
        kinds = self.var_kinds()
        for f in self.filters:
            name = var_name(f.var)
            kind = kinds.get(name)
            if kind is None:
                raise ValueError(f"filter on unknown variable {f.var!r}")
            if kind == "term":
                _check_term_const(f.term, f"filter on {f.var!r}")
            elif not (isinstance(f.term, int)
                      and not isinstance(f.term, bool)):
                raise ValueError(f"filter on predicate variable {f.var!r} "
                                 "needs a single predicate code, got "
                                 f"{f.term!r}")
        if self.project is not None:
            if not self.project:
                raise ValueError("empty projection (project=None selects "
                                 "all variables)")
            for v in self.project:
                _check_var(v, "projection")
                if var_name(v) not in kinds:
                    raise ValueError(f"projected variable {v!r} not bound "
                                     "by any pattern")
            if len(set(self.project)) != len(self.project):
                raise ValueError("duplicate variable in projection")

    def var_kinds(self) -> Dict[str, str]:
        """``{name: "term" | "pred"}`` for every variable, validating that
        no variable is used in both position kinds."""
        kinds: Dict[str, str] = {}

        def seen(term, kind: str):
            if not is_var(term):
                return
            name = var_name(term)
            if kinds.setdefault(name, kind) != kind:
                raise ValueError(
                    f"variable ?{name} used in both predicate and term "
                    "positions (the coded spaces are incomparable)")

        for pat in self.patterns:
            seen(pat.s, "term")
            seen(pat.p, "pred")
            seen(pat.o, "term")
        return kinds

    def answer_vars(self) -> Tuple[str, ...]:
        """Projected variable names, in output order."""
        if self.project is not None:
            return tuple(var_name(v) for v in self.project)
        return tuple(sorted(self.var_kinds()))

    def answer_attrs(self) -> Tuple[str, ...]:
        """Result-table attr names: ``(v__t, v__v)`` per term variable,
        ``v__p`` per predicate variable, in answer order — or the 5 triple
        attrs for a variable-free existence query."""
        kinds = self.var_kinds()
        if not kinds:
            return TRIPLE_ATTRS
        out = []
        for name in self.answer_vars():
            out.extend(var_attrs(name, kinds[name]))
        return tuple(out)

    def fingerprint(self) -> str:
        """Deterministic structural digest (sha1 hex) — what the query
        plan-cache/store key tiers key on. Two queries fingerprint equal
        iff they lower to the same IR DAG over the same codes."""
        lines = []
        for pat in self.patterns:
            lines.append(f"pattern {pat.s!r} {pat.p!r} {pat.o!r}")
        for f in self.filters:
            lines.append(f"filter {f.var!r} {f.op} {f.term!r}")
        lines.append(f"project {self.project!r}")
        return hashlib.sha1("\n".join(lines).encode()).hexdigest()


def var_attrs(name: str, kind: str) -> Tuple[str, ...]:
    """The relation columns carrying variable ``name``."""
    if kind == "pred":
        return (f"{name}__p",)
    return (f"{name}__t", f"{name}__v")


def query_session_key(query: Query, *, dedup, mode: str, slack: float,
                      jit: bool, kg_bucket_cap: int,
                      mesh_sig=None) -> tuple:
    """The in-process plan-cache key of one compiled query closure.

    Everything that changes the built closure is in here: the query's
    structural fingerprint, the δ strategy of the final Distinct, the
    annotation mode/slack (they size the capacities), ``jit`` (a no-op in
    the eager port, keyed as in the reference so sessions that differ in it
    never share an entry), the KG table's capacity bucket (the Scan's
    static shape), and ``mesh_sig`` — ``None`` on one device; on a mesh,
    the mesh's static identity, its exchange and calibration, and the KG's
    shard-local capacity bucket (``KGEngine._query_mesh_sig``).
    Components are plain ints, strings, floats, bools and tuples, so the
    tuple equals the reference's.
    """
    return ("bgp", query.fingerprint(), dedup, mode, float(slack),
            bool(jit), int(kg_bucket_cap), mesh_sig)
