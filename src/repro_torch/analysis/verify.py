"""Pass 1 — the schema-typed IR verifier (``verify_plan``).

Bottom-up schema/type inference over the plan DAG: every node gets an
inferred :class:`NodeSchema` (column set + per-column dtype, propagated
from the source extensions), and a battery of structural checks rejects
malformed plans with *named* diagnostics instead of letting them surface
as shape errors deep inside the device closure — or worse, as a silently
wrong KG. The checks (the reference's ``docs/analysis.md`` has the full
invariant table):

* **references** — ``Project``/``Select``/``EquiJoin`` columns must exist
  in the child schema; join keys must agree on dtype; ``Union`` children
  must share one attribute set; ``Scan`` attrs must match the source.
* **semantification** — every ``EmitTriples`` term map must resolve
  against its input schema, each join POM must have a matching ⋈ carrying
  the reserved ``__ps``/``__pk`` columns, and a map that can emit nothing
  (no class, no POMs) is flagged.
* **annotations** — plan-time counts must be monotone under the algebra
  (σ/π/δ never grow their child, ∪ is bounded by its inputs' sum) and
  capacities must be consistent (a buffer must hold its planned rows; a
  node's cap must not exceed what its parents can produce). Shard-local
  capacities (``annotate_local``) are checked mode-aware: a post-exchange
  δ block may legitimately exceed its child's *local* cap (rows
  redistribute), so only the redistribution-free relations are compared.
* **shape** — cycles (a frozen dataclass DAG can still be made cyclic
  through ``object.__setattr__``) and non-canonical forms CSE relies on
  (nested/unsorted/duplicated σ, ``Distinct(Distinct)``, unary ∪, equal
  subplans left as distinct objects).

``verify_plan`` returns a :class:`VerifyReport`; callers that want the
raise-on-failure contract use :meth:`VerifyReport.raise_for_status`
(:class:`PlanVerificationError` carries the report).

Source columns are typed from each extension's ``data.dtype``: a
``torch.Tensor`` (the port's :class:`~repro_torch.relalg.Table`) or a
numpy-backed stand-in. Torch dtypes are mapped to numpy dtypes
(:func:`numpy_dtype`), so :class:`NodeSchema` carries numpy dtypes and its
``describe()`` text matches the reference's letter for letter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.schema import RefObjectMap, TermMap
from repro_torch.plan.ir import (ColEq, Distinct, EmitTriples, EquiJoin,
                                 Node, Project, Scan, Select, Union)
from repro_torch.plan.lower import LogicalPlan

#: dtype every Table column carries by construction
#: (:meth:`repro_torch.relalg.Table.from_codes` forces int32)
DEFAULT_DTYPE = np.dtype(np.int32)


#: torch dtype -> numpy dtype for the column types a source can carry
_NUMPY_OF_TORCH = {torch.bool: np.bool_, torch.uint8: np.uint8,
                   torch.int8: np.int8, torch.int16: np.int16,
                   torch.int32: np.int32, torch.int64: np.int64,
                   torch.float16: np.float16, torch.float32: np.float32,
                   torch.float64: np.float64}


def numpy_dtype(dtype) -> np.dtype:
    """The numpy dtype of a torch or numpy dtype (``np.dtype`` does not
    take a ``torch.dtype``)."""
    if isinstance(dtype, torch.dtype):
        return np.dtype(_NUMPY_OF_TORCH[dtype])
    return np.dtype(dtype)


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One named verifier finding: ``code`` is the stable machine-readable
    diagnostic name tests and tools key on, ``where`` locates the node.

    ``severity`` is ``"error"`` (fails verification) or ``"warning"``
    (reported, but a plan carrying only warnings still verifies — e.g. a
    degenerate triples map that legitimately emits zero triples)."""

    code: str
    where: str
    message: str
    severity: str = "error"

    def __str__(self) -> str:
        tag = self.code if self.severity == "error" else f"{self.code}/warn"
        return f"[{tag}] {self.where}: {self.message}"


@dataclasses.dataclass(frozen=True)
class NodeSchema:
    """Inferred output schema of one node: ordered columns + dtypes."""

    attrs: Tuple[str, ...]
    dtypes: Tuple[np.dtype, ...]

    def dtype_of(self, attr: str) -> Optional[np.dtype]:
        try:
            return self.dtypes[self.attrs.index(attr)]
        except ValueError:
            return None

    def describe(self) -> str:
        if all(dt == DEFAULT_DTYPE for dt in self.dtypes):
            return ",".join(self.attrs)
        return ",".join(f"{a}:{dt}" for a, dt in zip(self.attrs, self.dtypes))


@dataclasses.dataclass
class VerifyReport:
    """Outcome of one ``verify_plan`` run."""

    diagnostics: List[Diagnostic]
    schemas: Dict[Node, NodeSchema]
    nodes_checked: int = 0

    @property
    def ok(self) -> bool:
        return not self.errors()

    def errors(self) -> List[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    def codes(self) -> Tuple[str, ...]:
        return tuple(sorted({d.code for d in self.diagnostics}))

    def describe(self) -> str:
        if self.ok:
            n_warn = len(self.diagnostics)
            suffix = f", {n_warn} warning(s)" if n_warn else ""
            lines = [f"verify: ok ({self.nodes_checked} nodes{suffix})"]
            lines += [f"  {d}" for d in self.diagnostics]
            return "\n".join(lines)
        lines = [f"verify: FAILED ({len(self.errors())} diagnostic(s) "
                 f"over {self.nodes_checked} nodes)"]
        lines += [f"  {d}" for d in self.diagnostics]
        return "\n".join(lines)

    def raise_for_status(self) -> "VerifyReport":
        if not self.ok:
            raise PlanVerificationError(self)
        return self


class PlanVerificationError(ValueError):
    """A plan failed static verification; ``.report`` has the findings."""

    def __init__(self, report: VerifyReport):
        super().__init__(report.describe())
        self.report = report


def _label(node: Node) -> str:
    from repro_torch.plan.explain import _label as lab
    return lab(node)


# ---------------------------------------------------------------------------
# traversal
# ---------------------------------------------------------------------------

def _postorder(roots: List[Node], out: List[Diagnostic]
               ) -> Optional[List[Node]]:
    """Iterative post-order over unique node *objects*, with an on-path
    set so a cyclic DAG — impossible through the public constructors,
    reachable via ``object.__setattr__`` or a buggy rewrite — reports
    ``cycle`` instead of recursing forever. All bookkeeping is by
    ``id()``: even structural ``__hash__`` diverges on a cyclic node, so
    nothing may hash a node before acyclicity is established. Returns
    ``None`` when a cycle was found (no safe order exists)."""
    order: List[Node] = []
    done: set = set()
    on_path: set = set()
    for root in roots:
        stack: List[Tuple[Node, bool]] = [(root, False)]
        while stack:
            node, expanded = stack.pop()
            if expanded:
                on_path.discard(id(node))
                if id(node) not in done:
                    done.add(id(node))
                    order.append(node)
                continue
            if id(node) in done:
                continue
            if id(node) in on_path:
                out.append(Diagnostic(
                    "cycle", _label(node),
                    "plan DAG contains a cycle through this node"))
                return None
            on_path.add(id(node))
            stack.append((node, True))
            for child in node.children():
                stack.append((child, False))
    return order


# ---------------------------------------------------------------------------
# schema inference + structural checks
# ---------------------------------------------------------------------------

def _infer(node: Node, schemas: Dict[Node, NodeSchema],
           sources: Mapping[str, object], out: List[Diagnostic]) -> None:
    """Infer ``schemas[node]`` from its children (already inferred) and
    append reference/arity/dtype diagnostics. Inference is best-effort on
    error so one bad column does not cascade into spurious findings."""
    where = _label(node)

    def schema_of(child: Node) -> NodeSchema:
        return schemas[child]

    if isinstance(node, Scan):
        dtype = DEFAULT_DTYPE
        src = sources.get(node.source)
        if src is None:
            if sources:
                out.append(Diagnostic(
                    "unknown-source", where,
                    f"scans source {node.source!r} which is not among the "
                    f"extensions {sorted(sources)}"))
        else:
            dtype = numpy_dtype(src.data.dtype)
            if tuple(src.attrs) != tuple(node.scan_attrs):
                out.append(Diagnostic(
                    "scan-schema-drift", where,
                    f"scan attrs {node.scan_attrs} != source extension "
                    f"attrs {tuple(src.attrs)}"))
        schemas[node] = NodeSchema(node.scan_attrs,
                                   (dtype,) * len(node.scan_attrs))
        return

    if isinstance(node, Project):
        child = schema_of(node.child)
        if not node.spec:
            out.append(Diagnostic("empty-projection", where,
                                  "projection with an empty column spec"))
        seen_dst: Dict[str, str] = {}
        dtypes = []
        for src_attr, dst in node.spec:
            if src_attr not in child.attrs:
                out.append(Diagnostic(
                    "unknown-column", where,
                    f"projects {src_attr!r} which is not in the child "
                    f"schema [{child.describe()}]"))
            if dst in seen_dst:
                out.append(Diagnostic(
                    "duplicate-column", where,
                    f"output column {dst!r} produced twice"))
            seen_dst[dst] = src_attr
            dtypes.append(child.dtype_of(src_attr) or DEFAULT_DTYPE)
        schemas[node] = NodeSchema(node.attrs, tuple(dtypes))
        return

    if isinstance(node, Select):
        child = schema_of(node.child)
        for p in node.preds:
            if p.attr not in child.attrs:
                out.append(Diagnostic(
                    "unknown-column", where,
                    f"σ predicate references {p.attr!r} which is not in "
                    f"the child schema [{child.describe()}]"))
        schemas[node] = child
        return

    if isinstance(node, ColEq):
        child = schema_of(node.child)
        for attr in (node.left_attr, node.right_attr):
            if attr not in child.attrs:
                out.append(Diagnostic(
                    "unknown-column", where,
                    f"σ= references {attr!r} which is not in the child "
                    f"schema [{child.describe()}]"))
        lt = child.dtype_of(node.left_attr)
        rt = child.dtype_of(node.right_attr)
        if lt is not None and rt is not None and lt != rt:
            out.append(Diagnostic(
                "coleq-dtype", where,
                f"σ= column dtypes differ: {node.left_attr}:{lt} vs "
                f"{node.right_attr}:{rt}"))
        schemas[node] = child
        return

    if isinstance(node, Distinct):
        schemas[node] = schema_of(node.child)
        return

    if isinstance(node, Union):
        first = schema_of(node.inputs[0]) if node.inputs else \
            NodeSchema((), ())
        for c in node.inputs[1:]:
            cs = schema_of(c)
            if set(cs.attrs) != set(first.attrs) or \
                    len(cs.attrs) != len(first.attrs):
                out.append(Diagnostic(
                    "union-arity", where,
                    f"∪ input schema [{cs.describe()}] does not match the "
                    f"first input's [{first.describe()}]"))
        schemas[node] = first
        return

    if isinstance(node, EquiJoin):
        left, right = schema_of(node.left), schema_of(node.right)
        for key, side, name in ((node.left_key, left, "left"),
                                (node.right_key, right, "right")):
            if key not in side.attrs:
                out.append(Diagnostic(
                    "unknown-column", where,
                    f"{name} join key {key!r} is not in the {name} schema "
                    f"[{side.describe()}]"))
        lk, rk = left.dtype_of(node.left_key), right.dtype_of(node.right_key)
        if lk is not None and rk is not None and lk != rk:
            out.append(Diagnostic(
                "join-key-dtype", where,
                f"join key dtypes differ: {node.left_key}:{lk} vs "
                f"{node.right_key}:{rk}"))
        schemas[node] = NodeSchema(node.attrs,
                                   left.dtypes + right.dtypes)
        return

    if isinstance(node, EmitTriples):
        schemas[node] = NodeSchema(node.attrs,
                                   (DEFAULT_DTYPE,) * len(node.attrs))
        return

    out.append(Diagnostic("unknown-node", where,
                          f"unrecognized node type {type(node).__name__}"))
    schemas[node] = NodeSchema((), ())


def _check_canonical(node: Node, out: List[Diagnostic]) -> None:
    """Canonical-form invariants the optimizer's CSE (hash-consing)
    depends on: equal relations must be *structurally* equal, which only
    holds if σ is flattened/sorted/deduplicated (``make_select``), δ is
    not stacked, and ∪ is genuinely n-ary."""
    where = _label(node)
    if isinstance(node, Select):
        if not node.preds:
            out.append(Diagnostic("non-canonical", where,
                                  "σ with an empty predicate set"))
        if isinstance(node.child, Select):
            out.append(Diagnostic(
                "non-canonical", where,
                "nested σ(σ(..)) — make_select flattens these"))
        key = [(p.attr, p.op, p.code if p.code is not None else -1)
               for p in node.preds]
        if key != sorted(key):
            out.append(Diagnostic(
                "non-canonical", where,
                "σ predicates are not in canonical sorted order"))
        if len(set(node.preds)) != len(node.preds):
            out.append(Diagnostic("non-canonical", where,
                                  "σ carries duplicate predicates"))
    elif isinstance(node, ColEq):
        if node.left_attr > node.right_attr:
            out.append(Diagnostic(
                "non-canonical", where,
                "σ= attr pair is not in canonical sorted order — "
                "make_coleq orders it"))
    elif isinstance(node, Distinct):
        if isinstance(node.child, Distinct):
            out.append(Diagnostic("non-canonical", where,
                                  "δ(δ(..)) — the inner δ is redundant"))
    elif isinstance(node, Union):
        if len(node.inputs) < 2:
            out.append(Diagnostic(
                "non-canonical", where,
                f"∪ with {len(node.inputs)} input(s) — must be n-ary"))


def _check_emit(node: EmitTriples, plan: LogicalPlan,
                schemas: Dict[Node, NodeSchema],
                out: List[Diagnostic]) -> None:
    tm = node.tm
    where = _label(node)
    input_schema = schemas[node.input]
    map_names = {m.name for m in plan.maps}

    def need(attr: Optional[str], schema: NodeSchema, what: str) -> None:
        if attr is not None and attr not in schema.attrs:
            out.append(Diagnostic(
                "emit-unresolved", where,
                f"{what} references {attr!r} which is not in the input "
                f"schema [{schema.describe()}]"))

    if tm.subject_class is None and not tm.poms:
        out.append(Diagnostic(
            "emit-empty", where,
            f"map {tm.name!r} has neither a subject class nor POMs — it "
            "resolves to nothing (emits zero triples)",
            severity="warning"))
    need(tm.subject.referenced_attr, input_schema, "subject term map")
    for sel in tm.selections:
        need(sel.attr, input_schema, "σ selection")

    join_nodes = dict(node.joins)
    want_joins = {i for i, pom in enumerate(tm.poms)
                  if isinstance(pom.object, RefObjectMap)}
    if set(join_nodes) != want_joins:
        out.append(Diagnostic(
            "emit-unresolved", where,
            f"join POM indices {sorted(want_joins)} do not match the "
            f"attached ⋈ nodes {sorted(join_nodes)}"))
    for i, pom in enumerate(tm.poms):
        obj = pom.object
        if isinstance(obj, RefObjectMap):
            if obj.parent_map not in map_names:
                out.append(Diagnostic(
                    "emit-unresolved", where,
                    f"join POM #{i} references parent map "
                    f"{obj.parent_map!r} which is not in the plan"))
                continue
            join = join_nodes.get(i)
            if join is None:
                continue
            joined = schemas[join]
            need(tm.subject.referenced_attr, joined,
                 f"join POM #{i} (child subject)")
            parent_tm = plan.map_by_name(obj.parent_map)
            if parent_tm.subject.referenced_attr is not None and \
                    "__ps" not in joined.attrs:
                out.append(Diagnostic(
                    "emit-unresolved", where,
                    f"join POM #{i}: ⋈ output lacks the reserved parent-"
                    "subject column '__ps'"))
            for sel in tm.selections:
                need(sel.attr, joined, f"join POM #{i} σ selection")
        elif isinstance(obj, TermMap):
            need(obj.referenced_attr, input_schema, f"POM #{i} object")


def _check_annotations(order: List[Node],
                       counts: Optional[Mapping[Node, int]],
                       caps: Optional[Mapping[Node, int]],
                       shard_local: bool, slack: float,
                       out: List[Diagnostic]) -> None:
    """Count monotonicity + capacity consistency (see module docstring).

    Count relations hold for BOTH annotate modes — exact counts obey the
    algebra and ``mode="bound"`` computes exactly these bounds. ⋈ uses
    ``max(|L|·|R|, |L|+|R|)`` because bound mode applies the FK heuristic
    ``|L|+|R|``, which exceeds the true product when a side is empty.
    Capacity comparisons assume one monotone ``cap_fn`` sized the whole
    plan; shard-local caps skip every redistribution-crossing comparison
    (δ Poisson bounds, ∪ of differently-clamped slices)."""
    counts = counts or {}
    caps = caps or {}
    # with slack >= 1 a buffer must at least hold its planned count; a
    # deliberate under-sizing (slack < 1) only demands the slacked share
    hold = min(1.0, slack)

    def c(n: Node) -> Optional[int]:
        return counts.get(n)

    for node in order:
        where = _label(node)
        cnt, cap = counts.get(node), caps.get(node)
        if cnt is not None and cnt < 0:
            out.append(Diagnostic("capacity", where,
                                  f"negative planned count {cnt}"))
        if cap is not None and cap < 0:
            out.append(Diagnostic("capacity", where,
                                  f"negative planned capacity {cap}"))
        if cnt is not None:
            kids = [c(k) for k in node.children()]
            if isinstance(node, (Project, Select, ColEq, Distinct)) and \
                    kids and kids[0] is not None and cnt > kids[0]:
                out.append(Diagnostic(
                    "capacity", where,
                    f"count {cnt} exceeds its child's count {kids[0]} — "
                    "π/σ/δ can never grow a relation"))
            elif isinstance(node, Union) and all(k is not None
                                                 for k in kids):
                if cnt > sum(kids):
                    out.append(Diagnostic(
                        "capacity", where,
                        f"count {cnt} exceeds the sum of its inputs "
                        f"({sum(kids)})"))
            elif isinstance(node, EquiJoin) and all(k is not None
                                                    for k in kids):
                bound = max(kids[0] * kids[1], kids[0] + kids[1])
                if cnt > bound:
                    out.append(Diagnostic(
                        "capacity", where,
                        f"⋈ match total {cnt} exceeds every admissible "
                        f"bound ({bound})"))
        if cap is None:
            continue
        if not shard_local:
            if cnt is not None and cap < int(math.ceil(cnt * hold)):
                out.append(Diagnostic(
                    "capacity", where,
                    f"capacity {cap} cannot hold the node's own planned "
                    f"count {cnt}"))
            kid_caps = [caps.get(k) for k in node.children()]
            if isinstance(node, (Project, Select, ColEq, Distinct)) and \
                    kid_caps and kid_caps[0] is not None and \
                    cap > kid_caps[0]:
                out.append(Diagnostic(
                    "capacity", where,
                    f"capacity {cap} exceeds its child's capacity "
                    f"{kid_caps[0]} — more than the parent can produce"))
            elif isinstance(node, Union) and all(k is not None
                                                 for k in kid_caps):
                limit = 2 * sum(kid_caps) + 64
                if cap > limit:
                    out.append(Diagnostic(
                        "capacity", where,
                        f"capacity {cap} exceeds what the ∪ inputs can "
                        f"produce (≤ {limit})"))
        else:
            # shard-local caps: only π/σ stay below their child (δ and ⋈
            # redistribute rows across shards; ∪ mixes clamped slices)
            kid_caps = [caps.get(k) for k in node.children()]
            if isinstance(node, (Project, Select, ColEq)) and kid_caps and \
                    kid_caps[0] is not None and cap > kid_caps[0]:
                out.append(Diagnostic(
                    "capacity", where,
                    f"shard-local capacity {cap} exceeds its child's "
                    f"{kid_caps[0]} — π/σ never grow their block"))


def _check_cse(roots: List[Node], out: List[Diagnostic]) -> None:
    """After hash-consing, structurally-equal subplans must be the same
    object across the given roots (the executor memoizes by value, so
    aliasing is a missed-sharing bug, not a correctness one — but it
    breaks the canonical form every cache key assumes)."""
    by_value: Dict[Node, int] = {}
    stack = list(roots)
    seen_ids = set()
    while stack:
        n = stack.pop()
        if id(n) in seen_ids:
            continue
        seen_ids.add(id(n))
        prev = by_value.get(n)
        if prev is not None and prev != id(n):
            out.append(Diagnostic(
                "cse-alias", _label(n),
                "structurally-equal subplans are distinct objects — the "
                "plan is not in hash-consed (CSE) canonical form"))
        else:
            by_value[n] = id(n)
        stack.extend(n.children())


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def verify_plan(plan: LogicalPlan, engine: str = "rmlmapper", *,
                counts: Optional[Mapping[Node, int]] = None,
                caps: Optional[Mapping[Node, int]] = None,
                sources: Optional[Mapping[str, object]] = None,
                shard_local: bool = False, slack: float = 1.0,
                check_canonical: bool = True,
                check_cse: bool = True) -> VerifyReport:
    """Statically verify a lowered (and usually optimized) plan.

    Parameters mirror how the :class:`~repro_torch.api.engine.KGEngine` calls
    it: ``counts``/``caps`` are the annotation pass's outputs (checked for
    consistency when given), ``sources`` the extensions to type against
    (default ``plan.dis.sources``; an empty mapping — e.g. a cache entry's
    slim plan — skips source-existence checks and types every column
    int32), ``shard_local=True`` relaxes the capacity comparisons that do
    not hold for per-shard buffers, and ``check_cse``/``check_canonical``
    gate the hash-consing invariants (off for un-optimized plans, whose
    inputs are never interned). Returns a :class:`VerifyReport`; use
    ``.raise_for_status()`` for the raising contract.
    """
    diags: List[Diagnostic] = []
    schemas: Dict[Node, NodeSchema] = {}
    sources = plan.dis.sources if sources is None else sources
    roots: List[Node] = list(plan.emits())
    roots.append(plan.sink(engine))
    order = _postorder(roots, diags)
    if order is None:        # cyclic: no safe inference order exists
        return VerifyReport(diags, schemas, nodes_checked=0)
    for node in order:
        _infer(node, schemas, sources, diags)
        if check_canonical:
            _check_canonical(node, diags)
        if isinstance(node, EmitTriples):
            _check_emit(node, plan, schemas, diags)
    _check_annotations(order, counts, caps, shard_local, slack, diags)
    if check_cse and check_canonical:
        _check_cse(list(plan.inputs.values()), diags)
    # the sink wraps fresh EmitTriples objects around the shared subtrees,
    # so emit-level findings can surface once per root — dedupe, keep order
    diags = list(dict.fromkeys(diags))
    return VerifyReport(diags, schemas, nodes_checked=len(order))


def verify_query_plan(plan, *,
                      counts: Optional[Mapping[Node, int]] = None,
                      caps: Optional[Mapping[Node, int]] = None,
                      sources: Optional[Mapping[str, object]] = None,
                      shard_local: bool = False,
                      slack: float = 1.0) -> VerifyReport:
    """Statically verify a lowered BGP query DAG
    (:class:`repro_torch.query.lower.QueryPlan`, duck-typed via
    ``emits()``).

    Runs the same schema inference, canonical-form, CSE and annotation
    checks as :func:`verify_plan` over the query root — there is no
    emitter/sink, so the emit checks are replaced by one query-specific
    invariant: the root must be a δ (query results have set semantics; a
    non-δ root would leak bag duplicates into the answer). ``sources``
    defaults to empty (the KG scan is typed int32 without a table in
    hand); pass ``{KG_SOURCE: kg_table}`` to also check scan-schema drift.
    """
    diags: List[Diagnostic] = []
    schemas: Dict[Node, NodeSchema] = {}
    roots: List[Node] = list(plan.emits())
    for root in roots:
        if not isinstance(root, Distinct):
            diags.append(Diagnostic(
                "query-root", _label(root),
                f"query root is {type(root).__name__}, expected δ — "
                "answers must have set semantics"))
    order = _postorder(roots, diags)
    if order is None:        # cyclic: no safe inference order exists
        return VerifyReport(diags, schemas, nodes_checked=0)
    for node in order:
        _infer(node, schemas, sources or {}, diags)
        _check_canonical(node, diags)
        if isinstance(node, EmitTriples):
            diags.append(Diagnostic(
                "query-root", _label(node),
                "EmitTriples inside a query DAG — queries read the KG, "
                "they never semantify"))
    _check_annotations(order, counts, caps, shard_local, slack, diags)
    _check_cse(roots, diags)
    diags = list(dict.fromkeys(diags))
    return VerifyReport(diags, schemas, nodes_checked=len(order))
