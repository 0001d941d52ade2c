"""Pass 3 — the closure auditor (``audit_closure``), the torch counterpart
of the reference's jaxpr auditor.

The reference inspects a lowered closure's jaxpr without executing it.
The port's closures run eagerly and have no jaxpr, so
:func:`audit_closure` **runs the closure once**, on its arguments' device,
under a recording :class:`~torch.utils._python_dispatch.TorchDispatchMode`
(every aten op passes through unchanged, so the audited run's result is
the unaudited one bit for bit) and a counted-transfer ledger
(:func:`repro_torch.relalg.guard.count_transfers`). It asserts the same
three invariants:

* **host syncs** — every aten op that reads a device value to the host or
  makes the host wait for the device (:func:`sync_kind`) must sit inside a
  counted read (:func:`~repro_torch.relalg.guard.host_int` /
  :func:`~repro_torch.relalg.guard.host_get`); one that does not is a
  ``host-transfer``. On a CUDA device the auditor also switches on
  ``torch.cuda.set_sync_debug_mode("warn")`` and counts PyTorch's own
  warnings, which must equal the ledger's count: that catches syncs made
  below the dispatcher (the host-to-device copy inside
  ``torch.tensor(..., device="cuda")`` never reaches a dispatch mode). The
  ledger's count must equal what the plan implies
  (:func:`expected_host_reads`), else ``host-read-mismatch``. The
  reference's ``host-callback`` has no torch counterpart (a Python
  callback is not an op): ``AuditReport.host_callbacks`` stays empty.
* **collective accounting** — ops in the ``c10d`` / ``_c10d_functional``
  namespaces are counted under the reference's keys (``all_gather``,
  ``all_to_all``) and held against :func:`expected_collectives` or an
  explicit expectation (``collective-mismatch``); a single-device closure
  must run none. A mesh closure runs ``dist.all_to_all_single`` /
  ``dist.all_gather``, which reach the dispatcher as ``c10d`` ops.
* **dtype stability** — no float64 anywhere; no int64 value outside the
  port functions of :data:`INT64_SITES`, which carry hashes (uint32 values
  held in int64, since PyTorch has no usable uint32 arithmetic on the
  CPU) and sort/gather indices (PyTorch's index dtype); and every column
  of every ``Table`` the closure returns is int32 or bool
  (``dtype-promotion``).

The hand-written kernels launch through ``ctypes``, below the dispatcher:
their launches are read off the port's launch counters
(:func:`repro_torch.kernels.launch_counts`) and reported in
``primitive_counts`` under each kernel's name.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import time
import warnings
from collections import Counter
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import launch_counts
from repro_torch.plan.ir import Distinct, EquiJoin, Node, iter_nodes
from repro_torch.plan.lower import LogicalPlan
from repro_torch.relalg import guard
from repro_torch.relalg.ops import (RADIX_DEDUP_MIN_ROWS, _resolve_dedup,
                                    hash_dedup_counts)
from repro_torch.relalg.table import Table

from .verify import Diagnostic, numpy_dtype

#: the collectives a mesh lowering may use (c10d op names contain these)
COLLECTIVE_PRIMITIVES = ("all_gather", "all_to_all", "allreduce",
                         "broadcast", "reduce_scatter")
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")

#: eqn fan-out per exchange site: one key-repartition lowers to 2
#: ``all_to_all`` (row payload + per-bucket counts), one table gather to
#: 2 ``all_gather`` (rows + counts) — the reference's measured values,
#: which the port's mesh closure keeps (``core/distributed.py``,
#: ``plan/mesh.py``)
EQNS_PER_REPARTITION = 2
EQNS_PER_GATHER = 2

#: aten ops that make the host wait for device data: a scalar read, or an
#: output whose shape depends on the data
_SYNC_OPS = frozenset({
    "aten._local_scalar_dense", "aten.nonzero", "aten.masked_select",
    "aten._unique2", "aten.unique_consecutive", "aten.unique_dim",
})
#: indexing ops that sync when an index is boolean (a hidden ``nonzero``)
_BOOL_INDEX_OPS = frozenset({"aten.index", "aten.index_put",
                             "aten.index_put_", "aten._index_put_impl_"})

#: The port functions allowed to make int64 values, each with the reason.
#: Keyed by (file under ``repro_torch/``, function); an int64 output is
#: attributed to the innermost frame outside PyTorch, the call site.
INT64_SITES: Dict[Tuple[str, str], str] = {
    ("kernels/rowhash/ref.py", "rowhash_ref"):
        "row hash: uint32 values in int64 (no CPU uint32 arithmetic)",
    ("kernels/rowhash/ref.py", "_mul32"):
        "row hash: exact 32-bit products in int64",
    ("kernels/rowhash/ref.py", "fmix32"):
        "row hash: murmur3 finalizer on int64-held uint32",
    ("kernels/rowhash/ref.py", "hash_neighbor_flags_ref"):
        "row hash of sorted rows (int64-held uint32)",
    ("kernels/rowhash/kernel.py", "rowhash_kernel"):
        "the kernel's int64 hash output buffer",
    ("kernels/rowhash/kernel.py", "hash_neighbor_flags_kernel"):
        "the kernel's int64 hash output buffer",
    ("kernels/radix_partition/ref.py", "bucket_targets_ref"):
        "bucket ids from the int64-held row hash",
    ("kernels/radix_partition/ref.py", "radix_partition_ref"):
        "bucket ids from the int64-held hash, stable ranks (sort indices)",
    ("kernels/radix_partition/kernel.py", "radix_partition_kernel"):
        "the kernel's int64 tile-status scratch",
    ("relalg/ops.py", "_distinct_hashed_sorted"):
        "hash keys (int64-held uint32) and their sort permutation",
    ("relalg/ops.py", "_distinct_hashed_radix"):
        "per-bucket hash keys and their sort permutation",
    ("relalg/ops.py", "_lex_perm"):
        "lexicographic sort permutation (PyTorch's index dtype)",
    ("relalg/ops.py", "compact"):
        "scatter destinations (PyTorch's index dtype)",
    ("relalg/ops.py", "equi_join"):
        "sort permutation and gather indices of the right side",
    ("relalg/ops.py", "append_rows"):
        "append destinations (PyTorch's index dtype)",
}

_TORCH_DIR = os.path.dirname(torch.__file__)
_PORT_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_READ_CODES = (guard.host_int.__code__, guard.host_get.__code__)
#: the warning ``set_sync_debug_mode("warn")`` gives per synchronizing call
#: (setting the mode also warns, once, that it is a prototype)
_SYNC_WARNING = "called a synchronizing CUDA operation"


@dataclasses.dataclass
class AuditReport:
    """Outcome of one ``audit_closure`` run.

    ``primitive_counts`` holds aten op counts by name plus each
    hand-written kernel's launches by kernel name; ``transfers`` the sync
    ops made outside a counted read; ``host_reads`` the ledger's count and
    ``expected_host_reads`` the plan's; ``sync_warnings`` PyTorch's
    sync-debug warnings (CUDA only, else ``None``); ``seconds`` the audited
    run's host time, ending in a device sync; ``result`` the closure's
    return value."""

    primitive_counts: Dict[str, int]
    collectives: Dict[str, int]
    expected: Optional[Dict[str, int]]
    host_callbacks: Tuple[str, ...]
    transfers: Tuple[str, ...]
    promotions: Tuple[str, ...]
    diagnostics: List[Diagnostic]
    host_reads: int = 0
    expected_host_reads: Optional[int] = None
    sync_warnings: Optional[int] = None
    seconds: float = 0.0
    result: object = dataclasses.field(default=None, repr=False)

    @property
    def ok(self) -> bool:
        return not self.diagnostics

    def describe(self) -> str:
        coll = ", ".join(f"{k}={v}" for k, v in
                         sorted(self.collectives.items())) or "none"
        head = f"audit: {'ok' if self.ok else 'FAILED'} (collectives: {coll}"
        if self.expected is not None:
            exp = ", ".join(f"{k}={v}" for k, v in
                            sorted(self.expected.items()))
            head += f"; expected: {exp}"
        head += f"; host reads: {self.host_reads}"
        if self.expected_host_reads is not None:
            head += f" of {self.expected_host_reads} expected"
        if self.sync_warnings is not None:
            head += f"; sync warnings: {self.sync_warnings}"
        lines = [head + ")"]
        lines += [f"  {d}" for d in self.diagnostics]
        return "\n".join(lines)

    def raise_for_status(self) -> "AuditReport":
        if not self.ok:
            raise ClosureAuditError(self)
        return self


class ClosureAuditError(ValueError):
    """An audited closure failed; ``.report`` has the findings."""

    def __init__(self, report: AuditReport):
        super().__init__(report.describe())
        self.report = report


# ---------------------------------------------------------------------------
# what the plan implies
# ---------------------------------------------------------------------------

def expected_collectives(plan: LogicalPlan, engine: str = "rmlmapper",
                         n_shards: int = 1,
                         exchanges: Optional[Mapping[Node, object]] = None,
                         single_device: bool = False) -> Dict[str, int]:
    """Collective eqn counts the annotated exchange plan implies.

    Mirrors ``compile_mesh_plan``'s memoization exactly: repartition ⋈
    sides dedupe on ``(side_node, key)``, gathers on the parent node, the
    per-value global-δ exchanges are gated on ``n_shards > 1``, the sdm
    sink runs one per-map rowhash exchange (``n_shards > 1``) while the
    rmlmapper fused sink always repartitions (once, even on one shard).
    ``single_device=True`` describes the meshless ``compile_plan`` path,
    which must contain no collectives at all.
    """
    if single_device:
        return {"all_gather": 0, "all_to_all": 0}
    strategies = {node: getattr(x, "strategy", x)
                  for node, x in (exchanges or {}).items()}
    repart_sides: set = set()
    gather_parents: set = set()
    distincts: set = set()
    emit_nodes = plan.emits()
    for emit in emit_nodes:
        for node in iter_nodes(emit):
            if isinstance(node, EquiJoin):
                if strategies.get(node) == "repartition":
                    repart_sides.add((node.left, node.left_key))
                    repart_sides.add((node.right, node.right_key))
                else:
                    gather_parents.add(node.right)
            elif isinstance(node, Distinct):
                distincts.add(node)
    sites = len(repart_sides)
    if n_shards > 1:
        sites += len(distincts)
        if engine == "sdm":
            sites += len(emit_nodes)
    if engine != "sdm":
        sites += 1  # fused rowhash sink exchange, unconditional
    return {"all_gather": EQNS_PER_GATHER * len(gather_parents),
            "all_to_all": EQNS_PER_REPARTITION * sites}


def expected_query_collectives(plan, n_shards: int = 1,
                               exchanges: Optional[Mapping[Node, object]]
                               = None,
                               single_device: bool = False
                               ) -> Dict[str, int]:
    """Collective eqn counts a fused query closure implies — the query-DAG
    sibling of :func:`expected_collectives`: same per-site fan-out and
    memoization (repartition ⋈ sides dedupe on ``(side_node, key)``,
    gathers on the parent node, every δ — including the root — is one
    rowhash exchange when ``n_shards > 1``), no emitter/sink terms.
    ``plan`` is duck-typed via ``emits()`` (a
    :class:`repro_torch.query.lower.QueryPlan`)."""
    if single_device:
        return {"all_gather": 0, "all_to_all": 0}
    strategies = {node: getattr(x, "strategy", x)
                  for node, x in (exchanges or {}).items()}
    repart_sides: set = set()
    gather_parents: set = set()
    distincts: set = set()
    for root in plan.emits():
        for node in iter_nodes(root):
            if isinstance(node, EquiJoin):
                if strategies.get(node) == "repartition":
                    repart_sides.add((node.left, node.left_key))
                    repart_sides.add((node.right, node.right_key))
                else:
                    gather_parents.add(node.right)
            elif isinstance(node, Distinct):
                distincts.add(node)
    sites = len(repart_sides)
    if n_shards > 1:
        sites += len(distincts)
    return {"all_gather": EQNS_PER_GATHER * len(gather_parents),
            "all_to_all": EQNS_PER_REPARTITION * sites}


def expected_host_reads(plan, engine: Optional[str] = "rmlmapper",
                        dedup: Optional[str] = None, *,
                        dedup_calls: Optional[Mapping[Tuple, int]] = None,
                        n_shards: Optional[int] = None) -> int:
    """Counted host reads one run of a single-device closure makes, plus
    the caller's read of its overflow flag:

        reads = δ sites + radix re-runs + 1

    With ``n_shards`` it counts one rank's run of a mesh closure
    (:func:`repro_torch.plan.mesh.compile_mesh_plan`) instead: every
    global δ is a local δ, the exchange and a second local δ (the
    exchange only when ``n_shards > 1``), the sdm sink is one local δ
    after the per-map global δs (even for one map), the rmlmapper sink
    two, and there is no ``+ 1``: the engine reads the flags after the
    ranks have agreed on them, outside the closure.

    * **δ sites** — under the hash strategy each δ evaluation reads one
      0-d fallback flag (``relalg/ops.py``; the reference picks the
      fallback on the device). The sites are the structurally distinct
      ``Distinct`` nodes reachable from the plan's roots (the executor
      memoizes by structure, so each runs once per call), plus, for a KG
      plan (``engine`` not ``None``), one per-map δ per emitted map under
      ``"sdm"`` and the sink δ (which ``"sdm"`` with one map skips:
      δδ = δ). ``dedup="lex"`` makes no reads. A query plan is passed
      with ``engine=None``: its root is its δ.
    * **radix re-runs** — a radix-layout δ (an input of at least
      ``RADIX_DEDUP_MIN_ROWS`` rows) whose flag calls for the exact path
      re-runs the sorted layout, which reads its own flag. They are read
      off the run's δ counters (``dedup_calls``, the delta of
      ``hash_dedup_counts()["calls"]``): the sorted-layout calls at a
      radix capacity.
    * **the overflow read** — the step's read of the closure's
      truncation flag (``KGEngine`` makes it after every call).
    """
    if _resolve_dedup(dedup) == "lex":
        sites = 0
    elif n_shards is not None:
        per_global = 2 if n_shards > 1 else 1
        distincts = {n for root in plan.emits() for n in iter_nodes(root)
                     if isinstance(n, Distinct)}
        sites = per_global * len(distincts)
        if engine == "sdm":
            sites += per_global * len(plan.emits()) + 1
        elif engine is not None:    # a query closure has no sink
            sites += 2
    else:
        distincts = {n for root in plan.emits() for n in iter_nodes(root)
                     if isinstance(n, Distinct)}
        sites = len(distincts)
        if engine is not None:
            n_maps = len(plan.emits())
            if engine == "sdm":
                sites += n_maps
            if not (engine == "sdm" and n_maps == 1):
                sites += 1
    reruns = sum(n for (layout, cap, _k), n in (dedup_calls or {}).items()
                 if layout == "sorted" and cap >= RADIX_DEDUP_MIN_ROWS)
    return sites + reruns + (0 if n_shards is not None else 1)


# ---------------------------------------------------------------------------
# the recording mode
# ---------------------------------------------------------------------------

def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def sync_kind(name: str, args, kwargs, out) -> Optional[str]:
    """Why op ``name`` (``"aten.<op>"``) makes the host wait for the
    device, or ``None``: a scalar read or data-dependent output shape
    (:data:`_SYNC_OPS`), a boolean index, ``repeat_interleave`` without
    ``output_size``, a copy between the host and a device (either way:
    PyTorch's blocking copies synchronise the stream), a host tensor of
    more than one element handed to a device op (copied in first), or a
    fresh ``torch.tensor`` built on a device (from host data)."""
    if name in _SYNC_OPS:
        return name.split(".", 1)[1]
    ins = list(_tensors((args, kwargs)))
    if name in _BOOL_INDEX_OPS and any(t.dtype == torch.bool for t in ins):
        return "bool-index"
    if name == "aten.repeat_interleave" and \
            kwargs.get("output_size") is None:
        return "repeat_interleave"
    outs = list(_tensors(out))
    devices = {t.device.type for t in ins + outs}
    if name == "aten.lift_fresh" and "cpu" not in devices:
        return "host-to-device"
    if len(devices) > 1:
        if name in ("aten._to_copy", "aten.copy_", "aten.copy"):
            # _to_copy(src) -> out; copy_(dst, src)
            src = ins[0] if name == "aten._to_copy" else ins[1]
            return ("host-to-device" if src.device.type == "cpu"
                    else "device-to-host")
        # a 0-d host tensor rides along as a scalar; a bigger one is copied
        if any(t.device.type == "cpu" and t.dim() > 0 for t in ins):
            return "host-to-device"
    return None


def _call_site(frame) -> Optional[Tuple[str, str]]:
    """(file under the port, function) of the innermost frame outside
    PyTorch and this module, or ``None`` if that frame is not the port's."""
    while frame is not None:
        fname = frame.f_code.co_filename
        if not fname.startswith(_TORCH_DIR) and fname != __file__:
            break
        frame = frame.f_back
    if frame is None:
        return None
    fname = os.path.abspath(frame.f_code.co_filename)
    if not fname.startswith(_PORT_DIR + os.sep):
        return None
    rel = fname[len(_PORT_DIR) + 1:].replace(os.sep, "/")
    return rel, frame.f_code.co_name


def _site_text(frame, depth: int = 1,
               skip: Tuple[str, ...] = (__file__,)) -> str:
    """``file:line function`` of the innermost ``depth`` frames outside
    PyTorch, ``warnings`` and the files in ``skip``, innermost first."""
    sites = []
    while frame is not None and len(sites) < depth:
        fname = frame.f_code.co_filename
        if not (fname.startswith(_TORCH_DIR) or fname in skip or
                fname == warnings.__file__):
            if fname.startswith(_PORT_DIR + os.sep):
                fname = "repro_torch/" + fname[len(_PORT_DIR) + 1:]
            sites.append(f"{fname}:{frame.f_lineno} {frame.f_code.co_name}")
        frame = frame.f_back
    return " <- ".join(sites) or "?"


def _in_counted_read(frame) -> bool:
    while frame is not None:
        if frame.f_code in _READ_CODES:
            return True
        frame = frame.f_back
    return False


class _Recorder(TorchDispatchMode):
    """Counts every aten op, classifies syncs and wide outputs, and runs
    the op unchanged."""

    @classmethod
    def _should_skip_dynamo(cls) -> bool:
        # PyTorch wraps a mode's hook in a dynamo guard, whose first call
        # imports torch._dynamo (seconds); the recorder is never compiled
        return False

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()
        self.uncounted: Dict[str, int] = {}
        self.promotions: Dict[str, str] = {}
        self.collectives: Counter = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        name = str(func.overloadpacket)
        self.counts[name] += 1
        if func.namespace in _COLLECTIVE_NAMESPACES:
            # c10d spells them alltoall_base_ / allgather_
            plain = name.replace("alltoall", "all_to_all").replace(
                "allgather", "all_gather")
            for key in COLLECTIVE_PRIMITIVES:
                if key in plain:
                    self.collectives[key] += 1
                    break
            else:
                self.collectives[name] += 1
        kind = sync_kind(name, args, kwargs, out)
        if kind is not None:
            frame = sys._getframe(1)
            if not _in_counted_read(frame):
                key = f"{name} ({kind}) at {_site_text(frame)}"
                self.uncounted[key] = self.uncounted.get(key, 0) + 1
        for t in _tensors(out):
            if t.dtype.itemsize <= 4:
                continue
            if t.dtype == torch.int64 and \
                    _call_site(sys._getframe(1)) in INT64_SITES:
                continue
            key = f"{name} -> {numpy_dtype(t.dtype)}"
            self.promotions.setdefault(key, _site_text(sys._getframe(1)))
        return out


def _output_tables(tree):
    if isinstance(tree, Table):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _output_tables(x)
    elif isinstance(tree, Mapping):
        for x in tree.values():
            yield from _output_tables(x)


def audit_closure(fn, args: Sequence, *,
                  plan: Optional[LogicalPlan] = None,
                  engine: str = "rmlmapper", n_shards: int = 1,
                  exchanges: Optional[Mapping[Node, object]] = None,
                  single_device: bool = False,
                  expected_counts: Optional[Dict[str, int]] = None,
                  expected_host_reads: Optional[
                      int | Callable[..., int]] = None
                  ) -> AuditReport:
    """Run ``fn(*args)`` once under the recorder and audit what it did.

    With ``plan`` given, the observed collective counts are cross-checked
    against :func:`expected_collectives`; ``expected_counts`` supplies the
    expectation directly instead (the query path passes
    :func:`expected_query_collectives`). ``expected_host_reads`` is the
    ledger count the run must make: an int, or a callable taking the
    run's hash-δ call counts as ``dedup_calls=`` (the delta of
    ``hash_dedup_counts()["calls"]``), such as a partial of
    :func:`expected_host_reads`. Without these only the residency and
    dtype invariants are asserted. The report's ``result`` is ``fn``'s
    return value."""
    cuda = any(t.is_cuda for t in _tensors(list(args))) or any(
        t.data.is_cuda for t in _output_tables(list(args)))
    calls_before = Counter(hash_dedup_counts()["calls"])
    launches_before = launch_counts()
    recorder = _Recorder()
    # PyTorch's sync warnings, by whether a counted read is on the stack
    # (with the sites of those that are not); other warnings pass through
    warned = {"counted": 0, "uncounted": Counter()}
    others: List[tuple] = []

    def show(message, category, filename, lineno, file=None, line=None):
        if _SYNC_WARNING not in str(message):
            others.append((message, category, filename, lineno))
            return
        frame = sys._getframe(1)
        if _in_counted_read(frame):
            warned["counted"] += 1
        else:
            warned["uncounted"][_site_text(frame, 3, skip=())] += 1

    t0 = time.perf_counter()
    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = show
        prev = torch.cuda.get_sync_debug_mode() if cuda else None
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("warn")
        try:
            with guard.count_transfers() as ledger, recorder:
                result = fn(*args)
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(prev)
    if cuda:
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for other in others:
        warnings.warn_explicit(*other)
    uncounted_warned = warned["uncounted"]
    sync_warnings = (warned["counted"] + sum(uncounted_warned.values())
                     if cuda else None)
    calls = Counter(hash_dedup_counts()["calls"])
    calls.subtract(calls_before)
    dedup_calls = {k: v for k, v in calls.items() if v}
    launches_after = launch_counts()
    counts = dict(recorder.counts)
    counts.update({k: launches_after[k] - launches_before[k]
                   for k in launches_after
                   if launches_after[k] != launches_before[k]})
    diags: List[Diagnostic] = []

    transfers = tuple(sorted(recorder.uncounted))
    for key in transfers:
        diags.append(Diagnostic(
            "host-transfer", key,
            f"{recorder.uncounted[key]} sync(s) outside a counted read "
            "(guard.host_int / host_get) — the closure must read the host "
            "only through the ledger"))
    reads = ledger.device_to_host
    for site, n in sorted(uncounted_warned.items()):
        diags.append(Diagnostic(
            "host-transfer", f"sync-debug at {site}",
            f"PyTorch reported {n} synchronizing call(s) outside a counted "
            "read — a sync below the dispatcher (a host-to-device copy, a "
            "list index) bypassed the ledger"))
    if sync_warnings is not None and warned["counted"] != reads:
        diags.append(Diagnostic(
            "host-transfer", "sync-debug",
            f"PyTorch reported {warned['counted']} synchronizing call(s) "
            f"inside counted reads but the ledger counted {reads}"))
    want_reads = (expected_host_reads(dedup_calls=dedup_calls)
                  if callable(expected_host_reads) else expected_host_reads)
    if want_reads is not None and want_reads != reads:
        diags.append(Diagnostic(
            "host-read-mismatch", "ledger",
            f"the closure made {reads} counted host read(s) but the plan "
            f"implies {want_reads}"))

    promotions = tuple(sorted(recorder.promotions))
    for key in promotions:
        diags.append(Diagnostic(
            "dtype-promotion", key,
            f"64-bit value at {recorder.promotions[key]} in a closure that "
            "is int32/bool by construction (int64 only at the hash and "
            "index sites of INT64_SITES)"))
    out_promotions = []
    for table in _output_tables(result):
        for t, what in ((table.data, "columns"), (table.count, "count")):
            if t.dtype not in (torch.int32, torch.bool):
                key = f"output {what} {tuple(table.attrs)} -> " \
                      f"{numpy_dtype(t.dtype)}"
                out_promotions.append(key)
                diags.append(Diagnostic(
                    "dtype-promotion", key,
                    "a returned Table must hold int32 (or bool) values"))
    promotions += tuple(out_promotions)

    collectives = {name: recorder.collectives.get(name, 0)
                   for name in ("all_gather", "all_to_all")}
    expected = expected_counts
    if expected is None and plan is not None:
        expected = expected_collectives(plan, engine, n_shards,
                                        exchanges=exchanges,
                                        single_device=single_device)
    if expected is not None:
        for name in sorted(set(expected) | set(collectives)):
            want, got = expected.get(name, 0), collectives.get(name, 0)
            if want != got:
                diags.append(Diagnostic(
                    "collective-mismatch", name,
                    f"closure contains {got} {name} eqn(s) but the "
                    f"annotated exchange plan implies {want}"))
        if single_device:
            stray = {k: v for k, v in recorder.collectives.items()
                     if k not in collectives and v}
            for name, v in sorted(stray.items()):
                diags.append(Diagnostic(
                    "collective-mismatch", name,
                    f"single-device plan contains {v} {name} eqn(s) — "
                    "it must lower collective-free"))
    return AuditReport(primitive_counts=counts, collectives=collectives,
                       expected=expected, host_callbacks=(),
                       transfers=transfers, promotions=promotions,
                       diagnostics=diags, host_reads=reads,
                       expected_host_reads=want_reads,
                       sync_warnings=sync_warnings, seconds=seconds,
                       result=result)
