"""Plain PyTorch versions of the row-hash kernel family.

FNV/murmur-style 32-bit mixing hash over the columns of an int32 row
matrix, plus the fused hash+neighbor-flag pass behind hash-first duplicate
elimination. Bit-identical to the reference's uint32 arithmetic.

PyTorch on the CPU has no uint32 ``+``, ``>>`` or ``%``, so the hash is
computed in int64 and masked to 32 bits. Every product stays exact: a
32-bit value times a 32-bit constant would overflow int64's sign bit, so
constants are split into 16-bit halves (:func:`_mul32`). A hash is returned
as an int64 tensor holding the uint32 value, which is also what the single-
key sorts of the hash δ take as their key.
"""
from __future__ import annotations

from typing import Tuple

import torch

FNV_OFFSET = 2166136261
FNV_PRIME = 16777619
GOLDEN = 0x9E3779B9
MASK32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32), exactly:
    each partial product is below 2**48."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & MASK32


def fmix32(x: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64-held uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def rowhash_ref(x: torch.Tensor) -> torch.Tensor:
    """[N, K] int32 -> [N] int64 holding the uint32 row hash."""
    if x.dim() != 2:
        raise ValueError(f"rowhash expects [N, K], got {tuple(x.shape)}")
    n, k = x.shape
    u = x.to(torch.int64) & MASK32
    h = torch.full((n,), FNV_OFFSET, dtype=torch.int64, device=x.device)
    for col in range(k):
        salt = (GOLDEN * (col + 1)) & MASK32
        v = fmix32((u[:, col] + salt) & MASK32)
        h = _mul32(h ^ v, FNV_PRIME)
    return fmix32(h)


def hash_neighbor_flags_ref(rows: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Fused pass over hash-sorted rows: ``(hash, keep, collide)``.

    * ``hash[i]``    — the row hash (int64 holding the uint32 value),
    * ``keep[i]``    — 1 iff row i differs from row i-1 in hash or content
                       (row 0 always 1),
    * ``collide[i]`` — 1 iff hash[i] == hash[i-1] but the rows differ
                       (row 0 always 0).
    """
    h = rowhash_ref(rows)
    prev_rows = torch.roll(rows, 1, dims=0)
    prev_h = torch.roll(h, 1)
    row_eq = torch.all(rows == prev_rows, dim=1)
    hash_eq = h == prev_h
    keep = ~(hash_eq & row_eq)
    collide = hash_eq & ~row_eq
    if rows.shape[0]:
        keep[0] = True
        collide[0] = False
    return h, keep.to(torch.int32), collide.to(torch.int32)
