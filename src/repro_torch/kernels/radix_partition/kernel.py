"""Wrapper around the CUDA radix partition (``csrc/radix_partition.cu``).

The wrapper allocates the output, the counts, the overflow flag and the
scratch (a tile ticket and one status word per bucket and tile) with
``torch.empty``; the C entry point clears the scratch and launches the
one-pass kernel on the current stream (two CUDA launches), which writes
every element of the outputs, PAD tails, clamped counts and the flag
included. ``count`` stays on the device: no host sync.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import _lib, aligned16, count_launch
from repro_torch.kernels.rowhash.kernel import _stream, check_rows

from .ref import bucket_shift

#: rows per tile the ``.cu`` is compiled for (it refuses any other)
TILE_ROWS = (1024, 512, 256, 128, 64, 32)
#: shared memory a staged tile of R rows x K int32 may take
STAGE_BYTES = 40 * 1024
#: the kernel's shared tables hold up to 8 warps x n_buckets counts
MAX_BUCKETS = 1024
#: key columns are passed packed, one byte each, in two 64-bit words
MAX_KEY_COLS = 16
MAX_KEY_COL_INDEX = 255
INT32_MAX = 2**31 - 1


def tiles(k: int) -> Tuple[int, bool]:
    """(rows per tile R, staged) at K columns: the most rows of
    ``TILE_ROWS`` whose R x K int32 tile fits ``STAGE_BYTES``. Past
    K = 320 no tile of 32 rows fits; the tile is then not staged (R = 32)
    and the kernel reads its rows from device memory."""
    for rows in TILE_ROWS:
        if rows * k * 4 <= STAGE_BYTES:
            return rows, True
    return TILE_ROWS[-1], False


def kernel_feasible(n: int, k: int, n_buckets: int, cap_bucket: int,
                    key_cols: Optional[Tuple[int, ...]] = None,
                    order_preserving: bool = False) -> bool:
    """True iff the CUDA kernel takes this shape.

    A bucket count in [1, MAX_BUCKETS] (exchange mode takes any count: one
    bucket per shard; the order-preserving mode's top-bits target needs a
    power of two of at least 2), at most MAX_KEY_COLS key columns of index
    <= MAX_KEY_COL_INDEX, and row and slot indices that fit int32.
    """
    cols = tuple(range(k)) if key_cols is None else tuple(key_cols)
    if n < 1 or k < 1 or cap_bucket < 1:
        return False
    if n_buckets < 1 or n_buckets > MAX_BUCKETS:
        return False
    if order_preserving and (n_buckets < 2 or n_buckets & (n_buckets - 1)):
        return False
    if not 1 <= len(cols) <= MAX_KEY_COLS or \
            any(c < 0 or c >= k or c > MAX_KEY_COL_INDEX for c in cols):
        return False
    return n <= INT32_MAX and n_buckets * cap_bucket <= INT32_MAX


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
    if not kernel_feasible(n, k, n_buckets, cap_bucket, key_cols,
                           order_preserving):
        raise ValueError(
            f"radix_partition kernel does not take n={n} k={k} "
            f"n_buckets={n_buckets} cap_bucket={cap_bucket} "
            f"key_cols={key_cols}")
    data = aligned16(data)         # tiles are copied 16 bytes at a time
    cols = tuple(range(k)) if key_cols is None else tuple(key_cols)
    shift = bucket_shift(n_buckets) if order_preserving else 0
    dev = data.device
    count_t = torch.as_tensor(count, dtype=torch.int32, device=dev
                              ).reshape(())
    rows, staged = tiles(k)
    # the tile ticket, then one status word per (bucket, tile)
    scratch = torch.empty(1 + -(-n // rows) * n_buckets, dtype=torch.int64,
                          device=dev)
    out = torch.empty((n_buckets * cap_bucket, k), dtype=torch.int32,
                      device=dev)
    counts = torch.empty(n_buckets, dtype=torch.int32, device=dev)
    overflow = torch.empty((), dtype=torch.bool, device=dev)
    lo, hi = _pack_cols(cols)
    rc = _lib.lib().mapsdi_radix_partition(
        data.data_ptr(), count_t.data_ptr(), n, k, n_buckets, cap_bucket,
        shift, len(cols), lo, hi, rows, int(staged), scratch.data_ptr(),
        scratch.numel() * 8, out.data_ptr(), counts.data_ptr(),
        overflow.data_ptr(), dev.index or 0, _stream(data))
    _lib.check(rc, "radix_partition")
    count_launch("radix_partition")
    return out.reshape(n_buckets, cap_bucket, k), counts, overflow
