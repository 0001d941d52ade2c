"""Wrapper around the CUDA radix partition (``csrc/radix_partition.cu``).

The wrapper allocates the PAD-filled output, the raw per-bucket counts and
the per-block scratch histogram, launches the three kernels of the C entry
point on the current stream, and derives the clamped counts and the
overflow flag on the device. ``count`` stays on the device: no host sync.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _lib, count_launch
from repro_torch.kernels.rowhash.kernel import _stream, check_rows

from .ref import PAD_ID, bucket_shift

#: rows per block of the histogram and scatter kernels (``kThreads``)
BLOCK_ROWS = 256
#: the scatter's shared table holds 8 warps x (n_buckets + 1) counts, and
#: the scan launches one block per bucket
MAX_BUCKETS = 1024
#: key columns are passed packed, one byte each, in two 64-bit words
MAX_KEY_COLS = 16
MAX_KEY_COL_INDEX = 255
INT32_MAX = 2**31 - 1


def kernel_feasible(n: int, k: int, n_buckets: int, cap_bucket: int,
                    key_cols: Optional[Tuple[int, ...]] = None) -> bool:
    """True iff the CUDA kernel takes this shape.

    A power-of-two bucket count in [2, MAX_BUCKETS] (the exchange-mode
    modulo is a mask, and the scatter's shared table is sized by it), at
    most MAX_KEY_COLS key columns of index <= MAX_KEY_COL_INDEX, and row
    and slot indices that fit int32.
    """
    cols = tuple(range(k)) if key_cols is None else tuple(key_cols)
    if n < 1 or k < 1 or cap_bucket < 1:
        return False
    if n_buckets < 2 or n_buckets & (n_buckets - 1) or \
            n_buckets > MAX_BUCKETS:
        return False
    if not 1 <= len(cols) <= MAX_KEY_COLS or \
            any(c < 0 or c >= k or c > MAX_KEY_COL_INDEX for c in cols):
        return False
    return n <= INT32_MAX - BLOCK_ROWS and n_buckets * cap_bucket <= INT32_MAX


def _pack_cols(cols: Tuple[int, ...]) -> Tuple[int, int]:
    lo = hi = 0
    for j, c in enumerate(cols):
        if j < 8:
            lo |= c << (8 * j)
        else:
            hi |= c << (8 * (j - 8))
    return lo, hi


def radix_partition_kernel(data: torch.Tensor, count, *, n_buckets: int,
                           cap_bucket: int,
                           key_cols: Optional[Tuple[int, ...]] = None,
                           order_preserving: bool = False
                           ) -> Tuple[torch.Tensor, torch.Tensor,
                                      torch.Tensor]:
    """Kernel twin of :func:`.ref.radix_partition_ref`; raises for a shape
    outside :func:`kernel_feasible`."""
    check_rows(data, "radix_partition")
    n, k = data.shape
    if not kernel_feasible(n, k, n_buckets, cap_bucket, key_cols):
        raise ValueError(
            f"radix_partition kernel does not take n={n} k={k} "
            f"n_buckets={n_buckets} cap_bucket={cap_bucket} "
            f"key_cols={key_cols}")
    cols = tuple(range(k)) if key_cols is None else tuple(key_cols)
    shift = bucket_shift(n_buckets) if order_preserving else 0
    dev = data.device
    count_t = torch.as_tensor(count, dtype=torch.int32, device=dev
                              ).reshape(())
    n_blocks = -(-n // BLOCK_ROWS)
    scratch = torch.empty(n_blocks * n_buckets, dtype=torch.int32,
                          device=dev)
    raw = torch.empty(n_buckets, dtype=torch.int32, device=dev)
    out = torch.full((n_buckets * cap_bucket, k), PAD_ID, dtype=torch.int32,
                     device=dev)
    lo, hi = _pack_cols(cols)
    rc = _lib.lib().mapsdi_radix_partition(
        data.data_ptr(), count_t.data_ptr(), n, k, n_buckets, cap_bucket,
        shift, len(cols), lo, hi, scratch.data_ptr(), raw.data_ptr(),
        out.data_ptr(), dev.index or 0, _stream(data))
    _lib.check(rc, "radix_partition")
    count_launch("radix_partition")
    return (out.reshape(n_buckets, cap_bucket, k),
            torch.clamp(raw, max=cap_bucket), torch.any(raw > cap_bucket))
