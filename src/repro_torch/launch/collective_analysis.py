"""Collective traffic of a traced step, per device.

The port's counterpart of the reference's ``launch/hlo_analysis.py``,
which parses the compiled per-device HLO module and sums the operand
bytes of each collective instruction. The port has no compiled module:
its step runs eagerly, so the dry-run traces it once on fake tensors
(``launch/specs.py::CostMode``) and counts each collective op as rank 0
dispatches it:

* the ``_c10d_functional`` ops DTensor issues for a redistribute
  (``all_gather_into_tensor``, ``reduce_scatter_tensor``, ``all_reduce``,
  ``all_to_all_single``, their coalesced and autograd forms);
* the ``c10d`` ops the port's own helpers call (``launch/mesh.py``'s
  ``all_reduce``, ``all_gather_into``, ``reduce_scatter``,
  ``all_to_all``, ``gather_values``), counted where they are called.

Each counts its **operand** bytes, as the reference's parse does (an
all-gather's local shard, a reduce-scatter's whole input), under the
reference's op names. The ``wait_tensor`` that completes an async
collective is not a collective: each collective counts once.
``cross_pod_bytes`` sums the operands of collectives whose group holds
ranks on both sides of the pod boundary (the reference's
``groups_span_boundary``).

The reference's ``while_trip_counts`` and ``collective_bytes_scaled``
have no counterpart: they scale collectives inside a compiled
scan-over-layers by its trip count, and the port's layers are a Python
loop, so the trace meets every layer's collectives one by one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Sequence, Tuple

import torch

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: collective op (namespace-free name) -> (XLA op name, index of the
#: operand argument)
_OPS = {
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "all_reduce_coalesced_": ("all-reduce", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "all_to_all_single": ("all-to-all", 0),
    # c10d (the process-group API)
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "_allgather_base_": ("all-gather", 1),
    "allgather_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_base_": ("all-to-all", 1),
    "alltoall_": ("all-to-all", 1),
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d")


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.nbytes
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(v) for v in x)
    return 0


def _group_ranks(args, kwargs) -> Optional[Sequence[int]]:
    """The global ranks of the op's process group (a functional op's
    ``group_name`` string, or a c10d op's ProcessGroup argument)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    for a in list(args) + list(kwargs.values()):
        if isinstance(a, torch.ScriptObject):
            try:
                pg = dist.ProcessGroup.unbox(a)
            except RuntimeError:        # another class (a ReduceOp)
                continue
            return dist.get_process_group_ranks(pg)
    name = kwargs.get("group_name", args[-1] if args else None)
    if isinstance(name, str):
        return dist.get_process_group_ranks(_resolve_process_group(name))
    return None


def collective_of(func, args, kwargs) -> Optional[Tuple[str, int,
                                                        Optional[Sequence[
                                                            int]]]]:
    """(XLA op name, operand bytes, group ranks) of a collective op, or
    None for any other op."""
    ns, _, name = func._schema.name.partition("::")
    if ns not in _NAMESPACES or name not in _OPS:
        return None
    op, i = _OPS[name]
    return op, _nbytes(args[i]), _group_ranks(args, kwargs)


def spans_boundary(ranks: Optional[Sequence[int]], boundary: int) -> bool:
    """Whether a group holds ranks on both sides of ``boundary`` (pod 0 =
    ranks below it); an unknown group counts as spanning, as the
    reference's unknown replica-group formats do."""
    if not ranks:
        return True
    return min(ranks) < boundary <= max(ranks)


@dataclasses.dataclass
class CollectiveStats:
    by_op: Dict[str, int]
    by_op_count: Dict[str, int]
    cross_pod_bytes: int = -1      # -1 = not classified (single pod)

    @property
    def total_bytes(self) -> int:
        return sum(self.by_op.values())

    def to_dict(self) -> Dict[str, object]:
        d = {"bytes_by_op": dict(self.by_op),
             "count_by_op": dict(self.by_op_count),
             "total_bytes": self.total_bytes}
        if self.cross_pod_bytes >= 0:
            d["cross_pod_bytes"] = self.cross_pod_bytes
        return d


class CollectiveCounter:
    """Running per-op sums of a trace's collectives; ``pod_boundary``
    (the first rank of pod 1) classifies cross-pod traffic."""

    def __init__(self, pod_boundary: Optional[int] = None):
        self.pod_boundary = pod_boundary
        self.by_op = {c: 0 for c in COLLECTIVES}
        self.by_count = {c: 0 for c in COLLECTIVES}
        self.cross = 0

    def add(self, op: str, nbytes: int,
            ranks: Optional[Sequence[int]]) -> None:
        self.by_op[op] += nbytes
        self.by_count[op] += 1
        if self.pod_boundary is not None and \
                spans_boundary(ranks, self.pod_boundary):
            self.cross += nbytes

    def stats(self) -> CollectiveStats:
        return CollectiveStats(dict(self.by_op), dict(self.by_count),
                               self.cross if self.pod_boundary is not None
                               else -1)
