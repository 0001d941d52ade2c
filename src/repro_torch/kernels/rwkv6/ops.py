"""Dispatcher: the CUDA kernel for a CUDA tensor, the plain version for a
CPU tensor (policy: :func:`repro_torch.kernels.resolve_use_kernel`)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import resolve_use_kernel

from .kernel import rwkv6_kernel
from .ref import rwkv6_chunked


def rwkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
          w: torch.Tensor, u: torch.Tensor,
          state: Optional[torch.Tensor] = None, *, chunk: int = 32,
          use_kernel: Optional[bool] = None
          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """RWKV6 time mix. Returns (y, final_state). Any T and any initial
    state take the same route (the reference's Pallas kernel takes zero
    state and T a chunk multiple only, its jnp path the rest)."""
    if resolve_use_kernel(r, use_kernel):
        return rwkv6_kernel(r, k, v, w, u, state, chunk=chunk)
    return rwkv6_chunked(r, k, v, w, u, state, chunk=chunk)
