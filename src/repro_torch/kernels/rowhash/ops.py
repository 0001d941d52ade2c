"""Dispatchers: the CUDA kernel for a CUDA tensor, the plain version for a
CPU tensor (policy: :func:`repro_torch.kernels.resolve_use_kernel`)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import resolve_use_kernel

from .kernel import hash_neighbor_flags_kernel, rowhash_kernel
from .ref import hash_neighbor_flags_ref, rowhash_ref


def rowhash(x: torch.Tensor, *, use_kernel: Optional[bool] = None
            ) -> torch.Tensor:
    """[N, K] int32 -> [N] int64 row hashes (uint32 values)."""
    if resolve_use_kernel(x, use_kernel):
        return rowhash_kernel(x.contiguous())
    return rowhash_ref(x)


def hash_neighbor_flags(rows: torch.Tensor, *,
                        use_kernel: Optional[bool] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused ``(hash, keep, collide)`` over hash-sorted ``rows[N, K]``."""
    if resolve_use_kernel(rows, use_kernel):
        return hash_neighbor_flags_kernel(rows.contiguous())
    return hash_neighbor_flags_ref(rows)
