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


def resolve_use_kernel(x: torch.Tensor, use_kernel: Optional[bool]) -> bool:
    """Kernel for a CUDA tensor, plain version for a CPU tensor.

    ``use_kernel=True`` on a CPU tensor and ``use_kernel=False`` on a CUDA
    tensor raise: the plain version is taken only because the tensor lies
    on the CPU.
    """
    on_cuda = x.device.type == "cuda"
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


def refuse_grad(what: str, *xs: torch.Tensor) -> None:
    """The float kernels have no backward: an input that requires a
    gradient raises instead of getting a silently wrong one."""
    if any(x is not None and x.requires_grad for x in xs):
        raise RuntimeError(f"{what}: the CUDA kernel has no backward; call "
                           "it on tensors that do not require grad (e.g. "
                           "under torch.inference_mode())")
