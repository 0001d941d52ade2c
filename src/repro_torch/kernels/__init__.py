"""Dispatch policy and launch bookkeeping shared by every kernel package.

Each kernel package keeps the ref/ops/kernel triple:

* ``ref.py``    — the plain PyTorch version of the function;
* ``kernel.py`` — the wrapper around the hand-written CUDA kernel
  (``csrc/*.cu``, built at first use by :mod:`repro_torch.kernels._lib`);
* ``ops.py``    — the dispatcher the relational operators and the
  language models call.

The policy, defined once here: a CUDA tensor always goes to the kernel,
a CPU tensor to the plain version. There is no fallback: a CUDA launch
that cannot be made raises. ``use_kernel=True`` demands the kernel (and
so raises for a CPU tensor).

Every kernel wrapper adds one to its entry of the launch counts each time
it launches its kernel, and nowhere else, so a run can show that it went
through the kernels.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional

import torch

_LAUNCHES: Dict[str, int] = {"rowhash": 0, "hash_neighbor_flags": 0,
                             "radix_partition": 0, "rwkv6": 0,
                             "mamba2_ssd": 0, "flash_attention": 0}


def count_launch(name: str) -> None:
    _LAUNCHES[name] += 1


def launch_counts() -> Dict[str, int]:
    """Launches per kernel wrapper since the last reset."""
    return dict(_LAUNCHES)


def reset_launch_counts() -> None:
    for name in _LAUNCHES:
        _LAUNCHES[name] = 0


#: whether fake CPU tensors stand for CUDA ones (:func:`card_trace`)
_CARD_TRACE = contextvars.ContextVar("card_trace", default=False)


@contextlib.contextmanager
def card_trace():
    """Within this context, fake tensors (``FakeTensorMode``) on the CPU
    take the card's route, as CUDA tensors do: the float kernels' ops,
    whose fake implementations give their outputs. The dry-run traces the
    card's program so where PyTorch is built without CUDA, which cannot
    index a fake CUDA tensor (it asks the device for a guard). A real
    tensor's route never changes."""
    token = _CARD_TRACE.set(True)
    try:
        yield
    finally:
        _CARD_TRACE.reset(token)


def on_card(x: torch.Tensor) -> bool:
    """Whether ``x`` takes the kernels' route: a CUDA tensor, or a fake
    tensor inside :func:`card_trace`."""
    if x.device.type == "cuda":
        return True
    if not _CARD_TRACE.get():
        return False
    from torch._subclasses.fake_tensor import is_fake
    return is_fake(x)


def resolve_use_kernel(x: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    """Kernel for a CUDA tensor, plain version for a CPU tensor.

    ``use_kernel=True`` on a CPU tensor and ``use_kernel=False`` on a CUDA
    tensor raise: the plain version is taken only because the tensor lies
    on the CPU.
    """
    on_cuda = on_card(x)
    if use_kernel is None:
        return on_cuda
    if use_kernel and not on_cuda:
        raise ValueError(f"kernel requested for a tensor on {x.device}; "
                         "the CUDA kernels take CUDA tensors only")
    if not use_kernel and on_cuda:
        raise ValueError("a CUDA tensor always takes the kernel")
    return bool(use_kernel)


#: dtype codes of the float kernels' C entry points
_FLOAT_CODES = {torch.float32: 0, torch.bfloat16: 1}


def float_code(x: torch.Tensor, what: str) -> int:
    """The C entry points' code for a float32 or bfloat16 tensor."""
    if x.dtype not in _FLOAT_CODES:
        raise ValueError(f"{what}: float32 or bfloat16 required, got "
                         f"{x.dtype}")
    return _FLOAT_CODES[x.dtype]


def aligned16(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a contiguous tensor whose data starts on a 16-byte boundary.

    The kernels that copy 16-byte pieces (flash attention, rwkv6,
    mamba2_ssd, radix partition) take their inputs through this, and no
    other code makes the decision: an aligned contiguous tensor is passed
    as it is, a view that starts elsewhere is copied to fresh memory (the
    allocator aligns every allocation).
    """
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


#: DTensor sharding rules of the float kernels' ops, registered with the
#: first DeviceMesh (:func:`register_mesh_rules`): importing DTensor costs
#: every process a second, and only a mesh needs them
_MESH_RULES: list = []


def register_head_sharding(op, batch, heads, outputs: int) -> None:
    """DTensor's sharding rule for a float kernel's op whose (batch, head)
    pairs run alone: all inputs whole, or each input sharded on its dim in
    ``batch`` (one per argument; None: whole), or on its dim in
    ``heads``; the ``outputs`` outputs take the same batch or head dim
    (0 or 1). A mesh then runs the op on each rank's shards. The rule is
    registered by :func:`register_mesh_rules`."""
    _MESH_RULES.append((op, batch, heads, outputs))


def register_mesh_rules() -> None:
    """Register the pending rules of :func:`register_head_sharding` with
    DTensor (``launch/mesh.py`` calls this wherever it builds a
    DeviceMesh, before any DTensor meets an op)."""
    if not _MESH_RULES:
        return
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import register_sharding
    while _MESH_RULES:
        op, batch, heads, outputs = _MESH_RULES.pop()

        def strategy(*args, batch=batch, heads=heads, outputs=outputs):
            def spec(dims):
                return [None if a is None else Replicate() if d is None
                        else Shard(d) for a, d in zip(args, dims)]
            return [([Replicate()] * outputs, spec([None] * len(args))),
                    ([Shard(0)] * outputs, spec(batch)),
                    ([Shard(1)] * outputs, spec(heads))]

        register_sharding(op)(strategy)


def refuse_grad(what: str, *xs: torch.Tensor) -> None:
    """The float kernels have no backward: an input that requires a
    gradient raises instead of getting a silently wrong one."""
    if any(x is not None and x.requires_grad for x in xs):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward; call "
                           "it on tensors that do not require grad (e.g. "
                           "under torch.inference_mode())")
