"""Dispatcher: the CUDA kernel for a CUDA tensor, the plain version for a
CPU tensor (policy: :func:`repro_torch.kernels.resolve_use_kernel`)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import resolve_use_kernel

from .kernel import flash_attention_kernel
from .ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    scale: Optional[float] = None,
                    kv_len: Optional[int] = None,
                    use_kernel: Optional[bool] = None) -> torch.Tensor:
    """Flash attention. ``window`` and ``kv_len`` are Python ints (static,
    as the reference's kernel takes them); the kernel's wrapper checks
    0 <= kv_len <= Sk."""
    for name, val in (("window", window), ("kv_len", kv_len)):
        if val is not None and not isinstance(val, int):
            raise TypeError(f"flash_attention: {name} must be an int or "
                            f"None, got {type(val).__name__}")
    if resolve_use_kernel(q, use_kernel):
        return flash_attention_kernel(q, k, v, causal=causal, window=window,
                                      scale=scale, kv_len=kv_len)
    return attention_ref(q, k, v, causal=causal, window=window, scale=scale,
                         kv_len=kv_len)
