"""Wrappers around the CUDA row-hash kernels (``csrc/rowhash.cu``,
``csrc/hash_neighbor_flags.cu``).

Each wrapper checks its input, allocates the outputs with ``torch.empty``,
launches on the current stream without synchronising, raises if the launch
reported a CUDA error, and adds one to its launch count.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _lib, count_launch


def check_rows(x: torch.Tensor, what: str) -> None:
    """The kernels take a contiguous [N, K] int32 CUDA tensor."""
    if x.device.type != "cuda":
        raise ValueError(f"{what}: CUDA tensor required, got {x.device}")
    if x.dtype != torch.int32 or x.dim() != 2:
        raise ValueError(f"{what}: [N, K] int32 required, got "
                         f"{tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{what}: contiguous rows required")
    if x.shape[1] < 1:
        raise ValueError(f"{what}: at least one column required")


def _stream(x: torch.Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def rowhash_kernel(x: torch.Tensor) -> torch.Tensor:
    """[N, K] int32 -> [N] int64 (uint32 hash values) on the card."""
    check_rows(x, "rowhash")
    n, k = x.shape
    out = torch.empty(n, dtype=torch.int64, device=x.device)
    rc = _lib.lib().mapsdi_rowhash(x.data_ptr(), out.data_ptr(), n, k,
                                   x.device.index or 0, _stream(x))
    _lib.check(rc, "rowhash")
    count_launch("rowhash")
    return out


def hash_neighbor_flags_kernel(rows: torch.Tensor
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """``(hash, keep, collide)`` over hash-sorted ``rows[N, K]`` on the
    card; semantics of :func:`.ref.hash_neighbor_flags_ref`."""
    check_rows(rows, "hash_neighbor_flags")
    n, k = rows.shape
    h = torch.empty(n, dtype=torch.int64, device=rows.device)
    keep = torch.empty(n, dtype=torch.int32, device=rows.device)
    coll = torch.empty(n, dtype=torch.int32, device=rows.device)
    rc = _lib.lib().mapsdi_hash_neighbor_flags(
        rows.data_ptr(), h.data_ptr(), keep.data_ptr(), coll.data_ptr(), n,
        k, rows.device.index or 0, _stream(rows))
    _lib.check(rc, "hash_neighbor_flags")
    count_launch("hash_neighbor_flags")
    return h, keep, coll
