"""Dispatcher: the CUDA radix partition for a CUDA tensor, the plain
version for a CPU tensor. A CUDA shape the kernel does not take raises
(:func:`.kernel.kernel_feasible`); it never gives way to the plain
version."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import resolve_use_kernel

from .kernel import radix_partition_kernel
from .ref import radix_partition_ref


def radix_partition(data: torch.Tensor, count, *, n_buckets: int,
                    cap_bucket: int,
                    key_cols: Optional[Tuple[int, ...]] = None,
                    order_preserving: bool = False,
                    use_kernel: Optional[bool] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partition ``data[cap_local, K]``'s first ``count`` rows into
    ``n_buckets`` hash buckets of ``cap_bucket`` rows each.

    Returns ``(buckets [n_buckets, cap_bucket, K], counts [n_buckets],
    overflow)`` with rows in original relative order inside each bucket,
    PAD elsewhere, counts clamped, and ``overflow`` raised (never silent)
    when a bucket's true occupancy exceeds ``cap_bucket``.
    """
    cols = None if key_cols is None else tuple(key_cols)
    if resolve_use_kernel(data, use_kernel):
        return radix_partition_kernel(
            data.contiguous(), count, n_buckets=n_buckets,
            cap_bucket=cap_bucket, key_cols=cols,
            order_preserving=order_preserving)
    return radix_partition_ref(data, count, n_buckets=n_buckets,
                               cap_bucket=cap_bucket, key_cols=cols,
                               order_preserving=order_preserving)
