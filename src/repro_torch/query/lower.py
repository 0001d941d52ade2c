"""Lowering: a BGP :class:`~repro_torch.query.spec.Query` becomes one IR DAG.

The query compiler reuses the creation path's relational IR unchanged —
plus :class:`~repro_torch.plan.ir.ColEq`, the column-vs-column σ — over a single
synthetic source: the coded KG table, scanned under
:data:`~repro_torch.query.spec.KG_SOURCE` with the 5 triple attrs.

Per pattern: constants become ``eq`` predicates on the term columns
(``make_select``), a variable repeated *within* the pattern becomes
``ColEq`` between its column pairs, and a π renames the surviving columns
to variable-derived names (``x__t``/``x__v`` for term variables, ``x__p``
for predicate variables). Patterns then join left-deep in input order on
the first shared variable's value column, with ``ColEq`` equating the
remaining shared columns (template columns of the join variable, both
columns of every further shared variable) and a π dropping the
``r_``-renamed duplicates. Filters lower to σ (term-``neq`` as the
disjoint ∪ of the two conjunctive branches), the projection to a final π,
and the root is always δ — query results have set semantics.

Hash-consing (:func:`repro_torch.plan.ir.intern`) runs over the finished DAG, so
every pattern shares one KG Scan and structurally-equal pattern relations
collapse — the query-side analogue of the creation planner's CSE.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

from repro_torch.core.schema import TRIPLE_ATTRS
from repro_torch.plan.ir import (Distinct, EquiJoin, Node, Pred, Project,
                                 Scan, Union, intern, iter_nodes, make_coleq,
                                 make_select)

from .spec import KG_SOURCE, Query, is_var, var_attrs, var_name

#: the KG columns carrying each pattern position
_POS_COLS = {"s": ("s_t", "s_v"), "p": ("p",), "o": ("o_t", "o_v")}


@dataclasses.dataclass
class QueryPlan:
    """A lowered query: the DAG root plus the spec it came from.

    ``emits()`` returns the root as a one-element list, so code that
    enumerates nodes via :func:`repro_torch.plan.ir.node_order` over
    ``plan.emits()`` works on query plans exactly as on creation plans.
    """

    query: Query
    root: Node
    out_attrs: Tuple[str, ...]

    def emits(self) -> List[Node]:
        return [self.root]


def _pattern_relation(pat, kinds: Dict[str, str]) -> Tuple[Node, Tuple[str, ...]]:
    """One pattern's relation: σ(constants) → ColEq(repeats) → π(vars).
    Returns ``(node, bound_var_names)``."""
    base: Node = Scan(KG_SOURCE, TRIPLE_ATTRS)
    preds: List[Pred] = []
    var_cols: Dict[str, List[Tuple[str, ...]]] = {}
    for pos, term in (("s", pat.s), ("p", pat.p), ("o", pat.o)):
        cols = _POS_COLS[pos]
        if is_var(term):
            var_cols.setdefault(var_name(term), []).append(cols)
        elif pos == "p":
            preds.append(Pred(cols[0], "eq", int(term)))
        else:
            preds.append(Pred(cols[0], "eq", int(term[0])))
            preds.append(Pred(cols[1], "eq", int(term[1])))
    node = make_select(base, tuple(preds))
    for name in sorted(var_cols):
        first, *rest = var_cols[name]
        for other in rest:     # same var twice in one pattern (?x p ?x)
            for a, b in zip(first, other):
                node = make_coleq(node, a, b)
    if not var_cols:
        return node, ()        # all-constant: keep the triple columns
    spec: List[Tuple[str, str]] = []
    for name in sorted(var_cols):
        src = var_cols[name][0]
        for col, out in zip(src, var_attrs(name, kinds[name])):
            spec.append((col, out))
    return Project(node, tuple(spec)), tuple(sorted(var_cols))


def _join(left: Node, left_vars: Tuple[str, ...], right: Node,
          right_vars: Tuple[str, ...], kinds: Dict[str, str]) -> Node:
    """Left-deep BGP join step: ⋈ on the first shared variable's value
    column, ColEq the rest, π away the ``r_``-renamed duplicates."""
    shared = sorted(set(left_vars) & set(right_vars))
    key = shared[0]
    key_col = var_attrs(key, kinds[key])[-1]   # x__v (term) or x__p (pred)
    node: Node = EquiJoin(left, right, key_col, key_col)
    # remaining equalities: the join variable's template column, plus every
    # column of every further shared variable (the ⋈ equated one column)
    for name in shared:
        for col in var_attrs(name, kinds[name]):
            if name == key and col == key_col:
                continue
            node = make_coleq(node, col, "r_" + col)
    left_set = set(left.attrs)
    keep = left.attrs + tuple(a for a in right.attrs if a not in left_set)
    return Project(node, tuple((a, a) for a in keep))


def _filter(node: Node, f, kinds: Dict[str, str]) -> Node:
    name = var_name(f.var)
    cols = var_attrs(name, kinds[name])
    if kinds[name] == "pred":
        return make_select(node, (Pred(cols[0], f.op, int(f.term)),))
    t_col, v_col = cols
    t_code, v_code = int(f.term[0]), int(f.term[1])
    if f.op == "eq":
        return make_select(node, (Pred(t_col, "eq", t_code),
                                  Pred(v_col, "eq", v_code)))
    # term ≠ const  ≡  (t ≠ tc) ∪ (t = tc ∧ v ≠ vc) — disjoint branches,
    # so the bag ∪ introduces no duplicates
    return Union((make_select(node, (Pred(t_col, "neq", t_code),)),
                  make_select(node, (Pred(t_col, "eq", t_code),
                                     Pred(v_col, "neq", v_code)))))


def lower_query(query: Query) -> QueryPlan:
    """``Query -> QueryPlan`` (see the module docstring for the shape).

    Raises ``ValueError`` for disconnected BGPs: every pattern after the
    first must share a variable with the accumulated relation (the IR has
    no cartesian product, and unconstrained cross products are almost
    always a query bug).
    """
    kinds = query.var_kinds()
    rels = [_pattern_relation(p, kinds) for p in query.patterns]
    if not kinds:
        if len(rels) > 1:
            raise ValueError("disconnected BGP: all-constant existence "
                             "queries must be a single pattern")
        root: Node = Distinct(rels[0][0])
        return QueryPlan(query, intern(root), TRIPLE_ATTRS)
    if any(not vars_ for _, vars_ in rels):
        raise ValueError("disconnected BGP: an all-constant pattern "
                         "cannot join the variable-bearing patterns")

    acc, acc_vars = rels[0]
    bound = set(acc_vars)
    pending = list(rels[1:])
    while pending:
        idx = next((i for i, (_, vs) in enumerate(pending)
                    if bound & set(vs)), None)
        if idx is None:
            missing = sorted(set(v for _, vs in pending for v in vs) - bound)
            raise ValueError("disconnected BGP: no shared variable links "
                             f"the patterns binding {missing} to the rest "
                             "(cartesian products are not supported)")
        right, right_vars = pending.pop(idx)
        acc = _join(acc, tuple(sorted(bound)), right, right_vars, kinds)
        bound |= set(right_vars)

    for f in query.filters:
        acc = _filter(acc, f, kinds)

    out_attrs = query.answer_attrs()
    if acc.attrs != out_attrs:
        acc = Project(acc, tuple((a, a) for a in out_attrs))
    return QueryPlan(query, intern(Distinct(acc)), out_attrs)


def query_scan(plan: QueryPlan) -> Scan:
    """The (single) KG Scan of a lowered query — what the mesh compiler
    (:func:`repro_torch.query.mesh.compile_query_mesh`) shards."""
    for node in iter_nodes(plan.root):
        if isinstance(node, Scan):
            return node
    raise ValueError("query plan has no Scan")  # pragma: no cover
