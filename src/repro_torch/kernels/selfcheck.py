"""Kernel-versus-plain checks on the card, shared by ``chip_smoke.py`` and
the CUDA-only tests.

Each case feeds the same CUDA tensors to a kernel's wrapper and to its
plain PyTorch version and counts the output elements that differ. The
comparison is bit for bit (tolerance 0): the kernels are integer code.
Inputs come from ``numpy.random.default_rng(seed)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

from repro_torch.relalg.guard import host_int
from repro_torch.relalg.ops import RADIX_DEDUP_BUCKETS, _radix_dedup_cap

from .radix_partition.kernel import radix_partition_kernel
from .radix_partition.ref import PAD_ID, radix_partition_ref
from .rowhash.kernel import hash_neighbor_flags_kernel, rowhash_kernel
from .rowhash.ref import hash_neighbor_flags_ref, rowhash_ref

#: distinct K=2 rows with identical 32-bit row hashes (brute-forced)
COLLIDING_PAIRS = [
    ([573955, 771106], [1046201, 851388]),
    ([371750, 616302], [385810, 783927]),
    ([111516, 1026830], [628226, 432961]),
    ([225467, 153997], [397535, 951855]),
]


@dataclasses.dataclass
class Case:
    kernel: str          # "rowhash" | "hash_neighbor_flags" | "radix_partition"
    label: str
    kernel_fn: Callable[[], Tuple[torch.Tensor, ...]]
    plain_fn: Callable[[], Tuple[torch.Tensor, ...]]


def _rows(rng, n: int, k: int, hi: int = 1 << 20) -> np.ndarray:
    return rng.integers(0, hi, size=(n, k)).astype(np.int32)


def _pad_tail(x: np.ndarray, count: int) -> np.ndarray:
    x = x.copy()
    x[count:] = PAD_ID
    return x


def _hash_sorted(x: np.ndarray) -> np.ndarray:
    h = rowhash_ref(torch.from_numpy(x)).numpy()
    return x[np.argsort(h, kind="stable")]


def _tuple(x) -> Tuple[torch.Tensor, ...]:
    return x if isinstance(x, tuple) else (x,)


def cases(device: torch.device, n_main: int, ks=(5, 10),
          path_shapes: Sequence[Tuple[int, int]] = (),
          seed: int = 0) -> List[Case]:
    """Every kernel at the main path's shapes and at the edge cases.

    ``n_main`` rows at each K in ``ks``, and each ``(capacity, K)`` in
    ``path_shapes`` (the shapes a run handed the hash δ), each with the δ's
    own radix bucket capacity; then N not a multiple of the block, count <
    N, N = 1, every row in one bucket, rows whose content is all PAD, and
    real 32-bit collisions for the neighbour flags."""
    rng = np.random.default_rng(seed)
    out: List[Case] = []

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    def add_hash(label: str, x: np.ndarray) -> None:
        t = dev(x)
        out.append(Case("rowhash", label, lambda: rowhash_kernel(t),
                        lambda: rowhash_ref(t)))

    def add_flags(label: str, x: np.ndarray) -> None:
        t = dev(x)
        out.append(Case("hash_neighbor_flags", label,
                        lambda: hash_neighbor_flags_kernel(t),
                        lambda: hash_neighbor_flags_ref(t)))

    def add_radix(label: str, x: np.ndarray, count: int, nb: int, cb: int,
                  key_cols=None, order_preserving=True) -> None:
        t = dev(x)
        c = torch.tensor(count, dtype=torch.int32, device=device)
        kw = dict(n_buckets=nb, cap_bucket=cb, key_cols=key_cols,
                  order_preserving=order_preserving)
        out.append(Case("radix_partition", label,
                        lambda: radix_partition_kernel(t, c, **kw),
                        lambda: radix_partition_ref(t, c, **kw)))

    nb = RADIX_DEDUP_BUCKETS
    odd = n_main - n_main // 7 + 3          # not a multiple of 256
    for k in ks:
        main = _rows(rng, n_main, k, hi=n_main // 4)   # duplicate-heavy
        masked = _pad_tail(main, n_main - n_main // 3)
        add_hash(f"N={n_main} K={k}", main)
        add_hash(f"N={odd} K={k}", main[:odd])
        add_hash(f"count<N K={k}", masked)
        add_flags(f"N={n_main} K={k} hash-sorted",
                  _hash_sorted(_rows(rng, n_main, k, hi=16)))
        add_flags(f"N={odd} K={k}", _hash_sorted(main[:odd]))
        add_flags(f"count<N K={k}", _hash_sorted(masked))
        cb = _radix_dedup_cap(n_main, nb)
        add_radix(f"N={n_main} K={k} nb={nb}", main, n_main, nb, cb)
        add_radix(f"N={odd} K={k} nb={nb}", main[:odd], odd, nb, cb)
        add_radix(f"count<N K={k} nb={nb}", main, n_main - n_main // 3, nb,
                  cb)
        key_cols = (1, 0) if k > 1 else (0,)
        add_radix(f"N={n_main} K={k} nb=64 exchange key_cols={key_cols}",
                  main, n_main, 64, n_main // 32, key_cols=key_cols,
                  order_preserving=False)
    for n, k in path_shapes:
        rows = _rows(rng, n, k, hi=max(2, n // 4))
        count = n - n // 3
        add_hash(f"path N={n} K={k}", rows)
        add_flags(f"path N={n} K={k} hash-sorted",
                  _hash_sorted(_pad_tail(rows, count)))
        add_radix(f"path N={n} K={k} count={count} nb={nb}", rows, count,
                  nb, _radix_dedup_cap(n, nb))
    one = _rows(rng, 1, 5)
    add_hash("N=1", one)
    add_flags("N=1", one)
    add_radix("N=1", one, 1, 8, 8)
    same = np.repeat(_rows(rng, 1, 3), 4096, axis=0)
    add_hash("one row value", same)
    add_flags("one row value", same)
    add_radix("every row in one bucket (overflow)", same, 4096, 8, 1000)
    pad = np.full((2048, 3), PAD_ID, dtype=np.int32)
    pad[:1024] = _rows(rng, 1024, 3, hi=7)
    add_hash("all-PAD content rows", pad)
    add_flags("all-PAD content rows", _hash_sorted(pad))
    add_radix("all-PAD content rows", pad, 2048, 8, 512)
    coll = np.asarray([r for a, b in COLLIDING_PAIRS for r in (a, b, a, b)],
                      dtype=np.int32)
    add_flags("32-bit collisions", _hash_sorted(coll))
    return out


def mismatches(case: Case) -> int:
    """Output elements where the kernel and the plain version differ
    (shape or dtype disagreement counts every element)."""
    got, want = _tuple(case.kernel_fn()), _tuple(case.plain_fn())
    torch.cuda.synchronize()
    bad = 0
    for g, w in zip(got, want):
        w = w.to(g.dtype) if w.dtype == torch.bool else w
        if g.shape != w.shape or g.dtype != w.dtype:
            bad += max(g.numel(), w.numel(), 1)
        else:
            bad += host_int((g != w).sum())
    return bad + abs(len(got) - len(want))
