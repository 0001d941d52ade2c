"""Plain PyTorch version of the radix partition: bucket targets, a stable
grouping by target, and a scatter into fixed-capacity buckets.

Output semantics (bit-identical to the reference oracle): rows within a
bucket keep their original relative order, unused slots are PAD rows,
counts are clamped to ``cap_bucket``, and ``overflow`` is True iff some
bucket's true occupancy exceeded ``cap_bucket`` (rows are never dropped
silently).

Two target modes: ``target = rowhash(row) % n_buckets`` (exchange mode) or,
with ``order_preserving=True``, ``target = rowhash(row) >> (32 - log2
n_buckets)``, so concatenating the buckets in index order yields rows in
non-decreasing hash order (what the radix layout of the hash δ needs).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels.rowhash.ref import rowhash_ref

#: padding sentinel — equals :data:`repro_torch.relalg.PAD_ID` (kernels do
#: not import relalg: relalg imports kernels). Pinned by a test.
PAD_ID = 2**31 - 1


def bucket_shift(n_buckets: int) -> int:
    """Top-bits shift for ``order_preserving`` mode; validates the
    power-of-two requirement."""
    bits = int(n_buckets).bit_length() - 1
    if n_buckets < 1 or n_buckets != 1 << bits:
        raise ValueError(f"order-preserving radix partition needs a "
                         f"power-of-two bucket count, got {n_buckets}")
    return 32 - bits


def bucket_targets_ref(data: torch.Tensor, count, n_buckets: int,
                       key_cols: Optional[Tuple[int, ...]] = None,
                       order_preserving: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(masked data, per-row target bucket) — invalid rows are forced to
    PAD rows and get the sentinel target ``n_buckets``."""
    cap_local = data.shape[0]
    valid = torch.arange(cap_local, dtype=torch.int32,
                         device=data.device) < count
    masked = torch.where(valid[:, None], data,
                         torch.tensor(PAD_ID, dtype=torch.int32,
                                      device=data.device))
    keyed = masked if key_cols is None else masked[:, list(key_cols)]
    h = rowhash_ref(keyed)
    if order_preserving:
        t = h >> bucket_shift(n_buckets)
    else:
        t = h % n_buckets
    return masked, torch.where(valid, t, n_buckets)


def radix_partition_ref(data: torch.Tensor, count, *, n_buckets: int,
                        cap_bucket: int,
                        key_cols: Optional[Tuple[int, ...]] = None,
                        order_preserving: bool = False
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Partition ``data[cap_local, K]``'s ``count`` valid rows into
    ``n_buckets`` buckets of ``cap_bucket`` rows.

    Returns ``(buckets [n_buckets, cap_bucket, K] int32, counts
    [n_buckets] int32, overflow 0-d bool)``.
    """
    n, k = data.shape
    nb, cb = n_buckets, cap_bucket
    masked, target = bucket_targets_ref(data, count, nb, key_cols,
                                        order_preserving)
    # stable grouping: a row's slot is its rank among same-bucket rows in
    # original order (the exclusive running count of its bucket)
    order = torch.sort(target, stable=True).indices
    per_bin = torch.zeros(nb + 1, dtype=torch.int64, device=data.device
                          ).scatter_add_(0, target, torch.ones_like(target))
    starts = torch.cumsum(per_bin, 0) - per_bin
    rank = torch.empty_like(target)
    rank[order] = (torch.arange(n, device=data.device)
                   - starts[target[order]])
    counts = per_bin[:nb]
    overflow = torch.any(counts > cb)
    ok = (target < nb) & (rank < cb)
    dest = torch.where(ok, target * cb + rank, nb * cb)
    flat = torch.full((nb * cb + 1, k), PAD_ID, dtype=torch.int32,
                      device=data.device)
    flat[dest] = masked
    return (flat[:nb * cb].reshape(nb, cb, k),
            torch.clamp(counts, max=cb).to(torch.int32), overflow)
