"""Logical relational-algebra IR for the MapSDI planner.

Nodes are immutable, hashable, and compared *structurally*: two plan
fragments that compute the same relation the same way are equal (and, after
:func:`intern`, identical objects). That single property carries most of the
optimizer:

* common-subplan elimination is hash-consing (:func:`intern`);
* the Rule 1–3 fixpoint terminates when a rewrite pass maps every node to an
  equal node;
* the executor memoizes on the node itself, so shared subtrees — including
  a join parent's relation reused by several child maps — are evaluated
  exactly once per run.

The node set mirrors the operators the paper's §3 algebra uses: ``Scan``
(a source extension), ``Project`` (π with rename), ``Select`` (σ),
``Distinct`` (δ), ``Union`` (∪, bag), ``EquiJoin`` (⋈ on one attr pair) and
``EmitTriples`` (semantification of one triple map — the only non-classical
operator, producing the 5-column triple relation). The query compiler adds
``ColEq`` (σ= between two columns).
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterator, Optional, Sequence, Tuple

from repro_torch.core.schema import TRIPLE_ATTRS, TripleMap


@dataclasses.dataclass(frozen=True)
class Pred:
    """One σ conjunct: ``attr <op> code`` over dictionary codes."""

    attr: str
    op: str                    # 'notnull' | 'eq' | 'neq'
    code: Optional[int] = None  # vocab code for eq/neq; null code for notnull

    def __post_init__(self):
        if self.op not in ("notnull", "eq", "neq"):
            raise ValueError(f"bad Pred op {self.op!r}")

    def describe(self) -> str:
        if self.op == "notnull":
            return f"{self.attr}≠∅"
        sym = "=" if self.op == "eq" else "≠"
        return f"{self.attr}{sym}#{self.code}"


class Node:
    """Base class for IR nodes. Subclasses are frozen dataclasses."""

    @property
    def attrs(self) -> Tuple[str, ...]:  # pragma: no cover - abstract
        raise NotImplementedError

    def children(self) -> Tuple["Node", ...]:
        return ()


@dataclasses.dataclass(frozen=True)
class Scan(Node):
    """A named source extension (leaf)."""

    source: str
    scan_attrs: Tuple[str, ...]

    @property
    def attrs(self) -> Tuple[str, ...]:
        return self.scan_attrs


@dataclasses.dataclass(frozen=True)
class Select(Node):
    """σ — keep rows satisfying every predicate (conjunction)."""

    child: Node
    preds: Tuple[Pred, ...]    # canonical: sorted, duplicate-free

    @property
    def attrs(self) -> Tuple[str, ...]:
        return self.child.attrs

    def children(self) -> Tuple[Node, ...]:
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Project(Node):
    """π with rename: ``spec`` is ``((src_attr, out_attr), ...)``."""

    child: Node
    spec: Tuple[Tuple[str, str], ...]

    @property
    def attrs(self) -> Tuple[str, ...]:
        return tuple(dst for _, dst in self.spec)

    def children(self) -> Tuple[Node, ...]:
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class Distinct(Node):
    """δ — duplicate elimination (set semantics)."""

    child: Node

    @property
    def attrs(self) -> Tuple[str, ...]:
        return self.child.attrs

    def children(self) -> Tuple[Node, ...]:
        return (self.child,)


@dataclasses.dataclass(frozen=True)
class ColEq(Node):
    """σ= — keep rows whose ``left_attr`` column equals ``right_attr``.

    The column-vs-column counterpart of :class:`Select`'s column-vs-constant
    predicates. The query compiler (:mod:`repro_torch.query`) needs it
    because a coded RDF term is a (template, value) column *pair* while
    :class:`EquiJoin` equates a single column pair: a BGP join on a shared
    variable joins on the value columns and then checks the template
    columns (and any further shared variables) with ``ColEq``. Attrs are
    kept in sorted order so structurally-equal filters hash-cons.
    """

    child: Node
    left_attr: str
    right_attr: str

    def __post_init__(self):
        if self.left_attr == self.right_attr:
            raise ValueError(f"ColEq on a single column {self.left_attr!r}")

    @property
    def attrs(self) -> Tuple[str, ...]:
        return self.child.attrs

    def children(self) -> Tuple[Node, ...]:
        return (self.child,)


def make_coleq(child: Node, left_attr: str, right_attr: str) -> Node:
    """Canonicalizing ``ColEq`` constructor: orders the attr pair so the
    commutative filter has one structural form."""
    if left_attr > right_attr:
        left_attr, right_attr = right_attr, left_attr
    return ColEq(child, left_attr, right_attr)


@dataclasses.dataclass(frozen=True)
class Union(Node):
    """∪ — n-ary bag union; children share an attr *set* (aligned by name
    to the first child's order at execution)."""

    inputs: Tuple[Node, ...]

    @property
    def attrs(self) -> Tuple[str, ...]:
        return self.inputs[0].attrs

    def children(self) -> Tuple[Node, ...]:
        return self.inputs


@dataclasses.dataclass(frozen=True)
class EquiJoin(Node):
    """⋈ — single-pair equi-join; output attrs follow
    :func:`repro_torch.relalg.ops.equi_join` (left attrs, then right attrs with
    colliding names prefixed by ``right_suffix``)."""

    left: Node
    right: Node
    left_key: str
    right_key: str
    right_suffix: str = "r_"

    @property
    def attrs(self) -> Tuple[str, ...]:
        left_names = set(self.left.attrs)
        right = tuple((self.right_suffix + a) if a in left_names else a
                      for a in self.right.attrs)
        return self.left.attrs + right

    def children(self) -> Tuple[Node, ...]:
        return (self.left, self.right)


@dataclasses.dataclass(frozen=True)
class EmitTriples(Node):
    """Semantification of one triple map over its (pre-processed) relation.

    ``joins`` holds, per join-carrying POM index, the :class:`EquiJoin`
    feeding that POM; non-join POMs read ``input`` directly.
    """

    tm: TripleMap
    input: Node
    joins: Tuple[Tuple[int, EquiJoin], ...] = ()

    @property
    def attrs(self) -> Tuple[str, ...]:
        return TRIPLE_ATTRS

    def children(self) -> Tuple[Node, ...]:
        return (self.input,) + tuple(j for _, j in self.joins)


# ---------------------------------------------------------------------------
# traversal + hash-consing
# ---------------------------------------------------------------------------

def iter_nodes(root: Node) -> Iterator[Node]:
    """Post-order over *unique* nodes of a DAG."""
    seen: Dict[Node, bool] = {}

    def walk(n: Node):
        if n in seen:
            return
        seen[n] = True
        for c in n.children():
            yield from walk(c)
        yield n

    yield from walk(root)


def tree_size(root: Node) -> int:
    """Number of node *instances* counting repeats (no sharing)."""
    total = 1
    for c in root.children():
        total += tree_size(c)
    return total


def intern(node: Node, memo: Optional[Dict[Node, Node]] = None) -> Node:
    """Hash-cons: return a structurally-equal DAG where equal subtrees are
    the *same object*. ``memo`` shares the intern table across roots, which
    is what dedups common subplans across different triple maps."""
    memo = {} if memo is None else memo

    def go(n: Node) -> Node:
        hit = memo.get(n)
        if hit is not None:
            return hit
        if isinstance(n, Select):
            out: Node = Select(go(n.child), n.preds)
        elif isinstance(n, ColEq):
            out = ColEq(go(n.child), n.left_attr, n.right_attr)
        elif isinstance(n, Project):
            out = Project(go(n.child), n.spec)
        elif isinstance(n, Distinct):
            out = Distinct(go(n.child))
        elif isinstance(n, Union):
            out = Union(tuple(go(c) for c in n.inputs))
        elif isinstance(n, EquiJoin):
            out = EquiJoin(go(n.left), go(n.right), n.left_key, n.right_key,
                           n.right_suffix)
        elif isinstance(n, EmitTriples):
            out = EmitTriples(n.tm, go(n.input),
                              tuple((i, go(j)) for i, j in n.joins))
        else:
            out = n
        return memo.setdefault(out, out)

    return go(node)


def fingerprint(roots: Sequence[Node]) -> str:
    """Deterministic structural digest (sha1 hex) of a plan DAG.

    Two plans fingerprint equal iff they would compile to the same program
    over the same dictionary codes: node structure, σ predicate *codes*,
    π/⋈ attribute wiring, and — for :class:`EmitTriples` — the full triple
    map (templates, constants, selections as their source strings). Shared
    subtrees are serialized once, so the digest is DAG-shaped, stable
    across processes (no ``id()``/``hash()`` salting), and what the
    ``KGEngine`` plan cache keys on. Equal to the reference's digest for
    the same plan, since the triple-map dataclasses repr the same.
    """
    memo: Dict[Node, int] = {}
    lines: list = []

    def visit(n: Node) -> int:
        hit = memo.get(n)
        if hit is not None:
            return hit
        if isinstance(n, Scan):
            desc = f"scan {n.source} {n.scan_attrs}"
        elif isinstance(n, Select):
            preds = tuple((p.attr, p.op, p.code) for p in n.preds)
            desc = f"select {visit(n.child)} {preds}"
        elif isinstance(n, ColEq):
            desc = (f"coleq {visit(n.child)} "
                    f"{n.left_attr} {n.right_attr}")
        elif isinstance(n, Project):
            desc = f"project {visit(n.child)} {n.spec}"
        elif isinstance(n, Distinct):
            desc = f"distinct {visit(n.child)}"
        elif isinstance(n, Union):
            desc = f"union {tuple(visit(c) for c in n.inputs)}"
        elif isinstance(n, EquiJoin):
            desc = (f"join {visit(n.left)} {visit(n.right)} "
                    f"{n.left_key} {n.right_key} {n.right_suffix}")
        elif isinstance(n, EmitTriples):
            joins = tuple((i, visit(j)) for i, j in n.joins)
            desc = f"emit {visit(n.input)} {joins} {n.tm!r}"
        else:  # pragma: no cover - future node kinds must opt in explicitly
            raise TypeError(f"cannot fingerprint {type(n).__name__}")
        out = memo[n] = len(lines)
        lines.append(desc)
        return out

    for r in roots:
        visit(r)
    return hashlib.sha1("\n".join(lines).encode()).hexdigest()


def node_order(roots: Sequence[Node]) -> list:
    """Deterministic enumeration of a plan DAG's unique nodes.

    The visit order is exactly :func:`fingerprint`'s (post-order over
    ``children()``, shared subtrees once), so two plans that fingerprint
    equal assign every node the same index — which is what lets node-keyed
    metadata (counts, capacities) be compared or stored as plain index
    lists.
    """
    return list(dict.fromkeys(n for r in roots for n in iter_nodes(r)))


def make_select(child: Node, preds: Tuple[Pred, ...]) -> Node:
    """σ constructor that canonicalizes (sort, dedup) and flattens a direct
    Select child; returns ``child`` unchanged for an empty predicate set."""
    if isinstance(child, Select):
        preds = preds + child.preds
        child = child.child
    uniq = tuple(sorted(set(preds), key=lambda p: (p.attr, p.op, p.code
                                                   if p.code is not None
                                                   else -1)))
    if not uniq:
        return child
    return Select(child, uniq)
