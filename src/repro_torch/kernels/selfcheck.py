"""Kernel-versus-plain checks on the card, shared by ``chip_smoke.py`` and
the CUDA-only tests.

Each case feeds the same CUDA tensors to a kernel's wrapper and to its
plain PyTorch version and counts the output elements that differ. For the
integer kernels (``cases``) the comparison is bit for bit (tolerance 0).
For the float kernels (``recurrence_cases``, ``attention_cases``) an
element passes when
``|kernel - plain| <= rtol * |plain| + atol_frac * max|plain|``: both
compute in float32 and differ in summation order and in the last bit of
``exp``/``log``; a bfloat16 output may then round to the neighbouring
value, one bfloat16 step (at most 2**-7 of the value). Inputs come from
``numpy.random.default_rng(seed)``.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.relalg.guard import host_int
from repro_torch.relalg.ops import RADIX_DEDUP_BUCKETS, _radix_dedup_cap

from .flash_attention.kernel import flash_attention_kernel, tiles
from .flash_attention.ref import attention_ref
from .mamba2.kernel import CHUNK as SSD_CHUNK
from .mamba2.kernel import SEGMENT_CHUNKS as SSD_SEGMENT_CHUNKS
from .mamba2.kernel import mamba2_ssd_kernel
from .mamba2.ref import mamba2_ssd_ref
from .radix_partition.kernel import radix_partition_kernel, tiles
from .radix_partition.ref import PAD_ID, radix_partition_ref
from .rowhash.kernel import hash_neighbor_flags_kernel, rowhash_kernel
from .rowhash.ref import hash_neighbor_flags_ref, rowhash_ref
from .rwkv6.kernel import CHUNK as RWKV6_CHUNK
from .rwkv6.kernel import SEGMENT_CHUNKS as RWKV6_SEGMENT_CHUNKS
from .rwkv6.kernel import rwkv6_kernel
from .rwkv6.ref import rwkv6_chunked

#: distinct K=2 rows with identical 32-bit row hashes (brute-forced)
COLLIDING_PAIRS = [
    ([573955, 771106], [1046201, 851388]),
    ([371750, 616302], [385810, 783927]),
    ([111516, 1026830], [628226, 432961]),
    ([225467, 153997], [397535, 951855]),
]
#: exchange-mode bucket counts checked beside the power-of-two ones: a
#: mesh's exchanges take one bucket per shard, for any shard count
EXCHANGE_BUCKETS = (1, 3, 4, 6)


@dataclasses.dataclass
class Case:
    kernel: str          # a key of repro_torch.kernels.launch_counts()
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


@dataclasses.dataclass
class RadixSpec:
    """One radix partition check: the rows, ``count`` and the keywords of
    :func:`.radix_partition.ref.radix_partition_ref`; ``offset`` hands
    the kernel a view that starts 4 bytes past a 16-byte boundary."""
    label: str
    data: np.ndarray
    count: int
    n_buckets: int
    cap_bucket: int
    key_cols: Optional[Tuple[int, ...]] = None
    order_preserving: bool = True
    offset: bool = False

    def kwargs(self) -> dict:
        return dict(n_buckets=self.n_buckets, cap_bucket=self.cap_bucket,
                    key_cols=self.key_cols,
                    order_preserving=self.order_preserving)


def largest_staged_k() -> int:
    """The largest K whose tile ``tiles`` still stages (at its fewest
    rows); one column more and the kernel reads its rows from device
    memory."""
    k = 1
    while tiles(k + 1)[1]:
        k += 1
    return k


def _int_inputs(n_main: int, ks, path_shapes: Sequence[Tuple[int, int]],
                seed: int, exchange_shapes: Sequence[Tuple] = ()):
    """The integer kernels' inputs: ``(label, rows)`` pairs for the row
    hash and for the neighbour flags, and every radix partition check.

    ``n_main`` rows at each K in ``ks``, and each ``(capacity, K)`` in
    ``path_shapes`` (the shapes a run handed the hash δ; the radix checks
    take the δ's own bucket capacity); then N not a multiple of the
    block, count < N, exchange mode on a key-column subset, N = 1, every
    row in one bucket, rows whose content is all PAD, and real 32-bit
    collisions for the neighbour flags. Last, drawn after every other
    input so that those stay as they were, the edges of the one-pass
    radix kernel's tiles (``kernel.tiles``): N = one tile + 1, ``count``
    on a tile boundary, every row in one bucket across many tiles, 1024
    buckets in exchange mode, the largest K that is staged and the first
    that is not, and an input view off a 16-byte boundary. Then exchange
    mode at :data:`EXCHANGE_BUCKETS` buckets on a key-column subset (and
    one overflowing), and each ``(N, K, n_buckets, cap_bucket, key_cols)``
    of ``exchange_shapes`` (the shapes a mesh run's exchanges handed the
    kernel) on random rows, ``count`` a fifth below N."""
    rng = np.random.default_rng(seed)
    hashes: List[Tuple[str, np.ndarray]] = []
    flags: List[Tuple[str, np.ndarray]] = []
    radix: List[RadixSpec] = []
    nb = RADIX_DEDUP_BUCKETS
    odd = n_main - n_main // 7 + 3          # not a multiple of 256
    for k in ks:
        main = _rows(rng, n_main, k, hi=n_main // 4)   # duplicate-heavy
        masked = _pad_tail(main, n_main - n_main // 3)
        hashes += [(f"N={n_main} K={k}", main), (f"N={odd} K={k}", main[:odd]),
                   (f"count<N K={k}", masked)]
        flags += [(f"N={n_main} K={k} hash-sorted",
                   _hash_sorted(_rows(rng, n_main, k, hi=16))),
                  (f"N={odd} K={k}", _hash_sorted(main[:odd])),
                  (f"count<N K={k}", _hash_sorted(masked))]
        cb = _radix_dedup_cap(n_main, nb)
        key_cols = (1, 0) if k > 1 else (0,)
        radix += [
            RadixSpec(f"N={n_main} K={k} nb={nb}", main, n_main, nb, cb),
            RadixSpec(f"N={odd} K={k} nb={nb}", main[:odd], odd, nb, cb),
            RadixSpec(f"count<N K={k} nb={nb}", main, n_main - n_main // 3,
                      nb, cb),
            RadixSpec(f"N={n_main} K={k} nb=64 exchange key_cols={key_cols}",
                      main, n_main, 64, n_main // 32, key_cols=key_cols,
                      order_preserving=False)]
    for n, k in path_shapes:
        rows = _rows(rng, n, k, hi=max(2, n // 4))
        count = n - n // 3
        hashes.append((f"path N={n} K={k}", rows))
        flags.append((f"path N={n} K={k} hash-sorted",
                      _hash_sorted(_pad_tail(rows, count))))
        radix.append(RadixSpec(f"path N={n} K={k} count={count} nb={nb}",
                               rows, count, nb, _radix_dedup_cap(n, nb)))
    one = _rows(rng, 1, 5)
    same = np.repeat(_rows(rng, 1, 3), 4096, axis=0)
    pad = np.full((2048, 3), PAD_ID, dtype=np.int32)
    pad[:1024] = _rows(rng, 1024, 3, hi=7)
    hashes += [("N=1", one), ("one row value", same),
               ("all-PAD content rows", pad)]
    coll = np.asarray([r for a, b in COLLIDING_PAIRS for r in (a, b, a, b)],
                      dtype=np.int32)
    flags += [("N=1", one), ("one row value", same),
              ("all-PAD content rows", _hash_sorted(pad)),
              ("32-bit collisions", _hash_sorted(coll))]
    radix += [RadixSpec("N=1", one, 1, 8, 8),
              RadixSpec("every row in one bucket (overflow)", same, 4096, 8,
                        1000),
              RadixSpec("all-PAD content rows", pad, 2048, 8, 512)]
    # the one-pass kernel's tiles
    k = 5
    r = tiles(k)[0]
    x = _rows(rng, r + 1, k, hi=1 << 12)
    radix.append(RadixSpec(f"N={r + 1} (one tile + 1) K={k}", x, r + 1, nb,
                           _radix_dedup_cap(r + 1, nb)))
    x = _rows(rng, 3 * r + 100, k, hi=1 << 12)
    radix.append(RadixSpec(f"count={2 * r} on a tile boundary "
                           f"N={3 * r + 100}", x, 2 * r, nb,
                           _radix_dedup_cap(3 * r + 100, nb)))
    n = 20 * r + 7
    radix.append(RadixSpec(f"every row in one bucket across {-(-n // r)} "
                           f"tiles", np.repeat(_rows(rng, 1, k), n, axis=0),
                           n, nb, n))
    x = _rows(rng, n_main, k, hi=1 << 30)
    radix.append(RadixSpec(f"N={n_main} nb=1024 exchange", x, n_main, 1024,
                           _radix_dedup_cap(n_main, 1024),
                           order_preserving=False))
    big = largest_staged_k()
    for kk, label in ((big, "the largest staged K"),
                      (big + 1, "the first unstaged K")):
        rows = tiles(kk)[0]
        n = 5 * rows + 7
        x = _rows(rng, n, kk, hi=64)
        cols = (min(kk - 1, 255), 0, kk // 2)
        radix.append(RadixSpec(f"K={kk} ({label}, R={rows}) key_cols={cols}",
                               x, n - 3, nb, _radix_dedup_cap(n, nb),
                               key_cols=cols))
    x = _rows(rng, odd, k, hi=n_main // 4)
    radix.append(RadixSpec(f"view off a 16-byte boundary N={odd} K={k}", x,
                           odd - 5, nb, _radix_dedup_cap(odd, nb),
                           offset=True))
    # exchange mode at the bucket counts of 1-, 3-, 4- and 6-rank meshes
    # (one bucket a shard, so any count) on a key-column subset, one of
    # them overflowing
    x = _rows(rng, odd, k, hi=n_main // 8)
    for nb_x in EXCHANGE_BUCKETS:
        radix.append(RadixSpec(
            f"N={odd} K={k} nb={nb_x} exchange key_cols=(2, 0)", x, odd - 9,
            nb_x, _radix_dedup_cap(odd, nb_x), key_cols=(2, 0),
            order_preserving=False))
    radix.append(RadixSpec(
        f"N={odd} K={k} nb=3 exchange key_cols=(2,) (overflow)", x, odd,
        3, odd // 4, key_cols=(2,), order_preserving=False))
    # the shapes a mesh run's exchanges handed the kernel
    for n, kk, nb_x, cb, cols in exchange_shapes:
        x = _rows(rng, n, kk, hi=max(2, n // 2))
        radix.append(RadixSpec(
            f"mesh N={n} K={kk} nb={nb_x} cap={cb} key_cols={cols}", x,
            n - n // 5, nb_x, cb, key_cols=cols, order_preserving=False))
    return hashes, flags, radix


def radix_specs(n_main: int, ks=(5, 10),
                path_shapes: Sequence[Tuple[int, int]] = (),
                seed: int = 0,
                exchange_shapes: Sequence[Tuple] = ()) -> List[RadixSpec]:
    """Every radix partition check of :func:`cases` with the same
    arguments, on the same inputs (see ``_int_inputs``)."""
    return _int_inputs(n_main, ks, path_shapes, seed, exchange_shapes)[2]


def offset_view(x: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``x`` whose data starts one element past its
    allocation's start (off a 16-byte boundary for 2- to 8-byte
    elements)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    y = buf[1:].view(x.shape)
    y.copy_(x)
    return y


def cases(device: torch.device, n_main: int, ks=(5, 10),
          path_shapes: Sequence[Tuple[int, int]] = (),
          seed: int = 0,
          exchange_shapes: Sequence[Tuple] = ()) -> List[Case]:
    """Every integer kernel at the main path's shapes and at the edge
    cases of ``_int_inputs``."""
    hashes, flags, radix = _int_inputs(n_main, ks, path_shapes, seed,
                                       exchange_shapes)
    out: List[Case] = []

    def dev(a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    for label, x in hashes:
        t = dev(x)
        out.append(Case("rowhash", label, lambda t=t: rowhash_kernel(t),
                        lambda t=t: rowhash_ref(t)))
    for label, x in flags:
        t = dev(x)
        out.append(Case("hash_neighbor_flags", label,
                        lambda t=t: hash_neighbor_flags_kernel(t),
                        lambda t=t: hash_neighbor_flags_ref(t)))
    for spec in radix:
        t = dev(spec.data)
        x = offset_view(t) if spec.offset else t
        c = torch.tensor(spec.count, dtype=torch.int32, device=device)
        kw = spec.kwargs()
        out.append(Case("radix_partition", spec.label,
                        lambda x=x, c=c, kw=kw:
                        radix_partition_kernel(x, c, **kw),
                        lambda t=t, c=c, kw=kw:
                        radix_partition_ref(t, c, **kw)))
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


# ---------------------------------------------------------------------------
# float recurrences
# ---------------------------------------------------------------------------

#: per-element tolerance by output dtype: (rtol, atol as a fraction of the
#: output's largest magnitude)
TOLERANCE = {torch.bfloat16: (2.0 ** -7, 1e-5), torch.float32: (1e-4, 1e-5)}


def rwkv6_inputs(device, b: int, h: int, t: int, *, dtype=torch.bfloat16,
                 w=None, state: bool = False, zero_run=None, seed: int = 0):
    """(r, k, v, w, u, state) shaped as the model hands them to the WKV6
    scan: w = exp(-exp(z)) for z in [-6, 2] (decays from 6e-4 to 0.9975)
    unless ``w`` (a float) fixes every decay; ``zero_run = (start, length)``
    then sets w = 0 on those positions."""
    rng = np.random.default_rng(seed)
    n = 64

    def mk(a, dt):
        return torch.from_numpy(a.astype(np.float32)).to(device, dt)

    r = mk(rng.normal(0, 1, (b, h, t, n)), dtype)
    k = mk(rng.normal(0, 0.3, (b, h, t, n)), dtype)
    v = mk(rng.normal(0, 1, (b, h, t, n)), dtype)
    wa = (np.exp(-np.exp(rng.uniform(-6, 2, (b, h, t, n)))) if w is None
          else np.full((b, h, t, n), w))
    if zero_run is not None:
        wa[:, :, zero_run[0]:zero_run[0] + zero_run[1]] = 0.0
    wt = mk(wa, dtype)
    u = mk(rng.normal(0, 0.3, (h, n)), torch.float32)
    s0 = mk(rng.normal(0, 1, (b, h, n, n)), torch.float32) if state else None
    return r, k, v, wt, u, s0


def ssd_inputs(device, b: int, h: int, t: int, *, dtype=torch.bfloat16,
               la=None, state: bool = False, seed: int = 0):
    """(xdt, la, b, c, state) shaped as the model hands them to the SSD
    scan: xdt = x * dt rounded to ``dtype``, la = dt * A with dt in
    [0.01, 3] and A in [-4, -0.25], unless ``la`` (a float) fixes it."""
    rng = np.random.default_rng(seed)
    n = p = 64

    def mk(a, dt):
        return torch.from_numpy(a.astype(np.float32)).to(device, dt)

    dt = rng.uniform(0.01, 3.0, (b, h, t))
    xdt = mk(rng.normal(0, 1, (b, h, t, p)) * dt[..., None], dtype)
    la_a = (dt * -rng.uniform(0.25, 4.0, (h,))[None, :, None] if la is None
            else np.full((b, h, t), la))
    bm = mk(rng.normal(0, 1, (b, t, n)), dtype)
    cm = mk(rng.normal(0, 1, (b, t, n)), dtype)
    s0 = mk(rng.normal(0, 1, (b, h, n, p)), torch.float32) if state else None
    return xdt, mk(la_a, torch.float32), bm, cm, s0


#: the serving shapes: a decode step (T = 1 from a state) and a 4-token
#: prefill, for 4 prompts at the models' head counts
SERVE_BATCH = 4
RWKV6_HEADS, SSD_HEADS = 64, 80


def recurrence_cases(device: torch.device,
                     rwkv6_shape: Tuple[int, int, int] = (2, 64, 2048),
                     ssd_shape: Tuple[int, int, int] = (2, 80, 2048),
                     seed: int = 0) -> List[Case]:
    """Both float kernels at the main path's (B, H, T) in bfloat16, and at
    the edge cases: T not a chunk multiple, T = one chunk, T = 1, float32
    inputs, an initial state, and decays at 0 and near 1; the bf16 route's
    segments (T = two segments and one token, from a state; a block count
    that leaves the card's last wave partial; a run of 35 zero decays
    across a segment boundary; mamba2's decay to 0 from a state); and the
    serving shapes."""
    out: List[Case] = []

    def add_rwkv6(label: str, b, h, t, **kw) -> None:
        x = rwkv6_inputs(device, b, h, t, seed=seed + len(out), **kw)
        out.append(Case("rwkv6", label, lambda: rwkv6_kernel(*x),
                        lambda: rwkv6_chunked(*x)))

    def add_ssd(label: str, b, h, t, **kw) -> None:
        x = ssd_inputs(device, b, h, t, seed=seed + len(out), **kw)
        out.append(Case("mamba2_ssd", label, lambda: mamba2_ssd_kernel(*x),
                        lambda: mamba2_ssd_ref(*x)))

    b, h, t = rwkv6_shape
    add_rwkv6(f"path B={b} H={h} T={t} bf16", b, h, t)
    add_rwkv6("T=40 (not a chunk multiple)", 1, 3, 40)
    add_rwkv6("T=32 (one chunk)", 2, 2, 32)
    add_rwkv6("T=1", 2, 2, 1)
    add_rwkv6("f32 T=100", 1, 4, 100, dtype=torch.float32)
    add_rwkv6("initial state T=96", 2, 2, 96, state=True)
    add_rwkv6("w = 0", 1, 2, 64, w=0.0, dtype=torch.float32)
    add_rwkv6("w = 1e-38", 1, 2, 64, w=1e-38, dtype=torch.float32)
    add_rwkv6("w = 1 - 6e-8", 1, 2, 128, w=1.0 - 6e-8, dtype=torch.float32)
    add_rwkv6("w = 1 bf16", 1, 2, 64, w=1.0)
    b, h, t = ssd_shape
    add_ssd(f"path B={b} H={h} T={t} bf16", b, h, t)
    add_ssd("T=40 (not a chunk multiple)", 1, 3, 40)
    add_ssd("T=64 (one chunk)", 2, 2, 64)
    add_ssd("T=1", 2, 2, 1)
    add_ssd("f32 T=150", 1, 4, 150, dtype=torch.float32)
    add_ssd("initial state T=128", 2, 2, 128, state=True)
    add_ssd("la = 0 (no decay)", 1, 2, 128, la=0.0, dtype=torch.float32)
    add_ssd("la = -80 (decay to 0)", 1, 2, 128, la=-80.0,
            dtype=torch.float32)
    # the bf16 route's segments and the serving shapes (after the cases
    # above, whose seeds stay as they were)
    seg = RWKV6_SEGMENT_CHUNKS * RWKV6_CHUNK
    add_rwkv6(f"T={2 * seg + 1} (two segments + 1) initial state", 1, 3,
              2 * seg + 1, state=True)
    add_rwkv6("B=3 H=47 T=300 (partial last wave)", 3, 47, 300)
    add_rwkv6(f"w = 0 at {seg - 16}..{seg + 18} (35 across a segment) "
              "T=600", 1, 2, 600, zero_run=(seg - 16, 35))
    add_rwkv6(f"serve B={SERVE_BATCH} T=1 initial state", SERVE_BATCH,
              RWKV6_HEADS, 1, state=True)
    add_rwkv6(f"serve B={SERVE_BATCH} T=4", SERVE_BATCH, RWKV6_HEADS, 4)
    seg = SSD_SEGMENT_CHUNKS * SSD_CHUNK
    add_ssd(f"T={2 * seg + 1} (two segments + 1) initial state", 1, 3,
            2 * seg + 1, state=True)
    add_ssd("B=3 H=47 T=300 (partial last wave)", 3, 47, 300)
    add_ssd("la = -80 initial state T=300", 1, 2, 300, la=-80.0, state=True)
    add_ssd(f"serve B={SERVE_BATCH} T=1 initial state", SERVE_BATCH,
            SSD_HEADS, 1, state=True)
    add_ssd(f"serve B={SERVE_BATCH} T=4", SERVE_BATCH, SSD_HEADS, 4)
    return out


def attention_inputs(device, b: int, h: int, kh: int, s_q: int, s_k: int,
                     d: int, *, dtype=torch.bfloat16, seed: int = 0):
    """(q [B,H,Sq,D], k, v [B,KH,Sk,D]): standard normal entries, as the
    reference's kernel tests draw them."""
    rng = np.random.default_rng(seed)

    def mk(shape):
        return torch.from_numpy(rng.normal(0, 1, shape).astype(
            np.float32)).to(device, dtype)

    return mk((b, h, s_q, d)), mk((b, kh, s_k, d)), mk((b, kh, s_k, d))


#: the flash kernel's shapes on the models' paths: (label, B, H, KH, Sq,
#: Sk, D, causal). The dense, MoE and VLM forwards at B = 2, T = 2048:
#: GQA 2:1 (qwen3, gemma3's global layers; internvl2's is qwen3's shape),
#: MHA (olmoe), 6:1 (internlm2), 8:1 (kimi) and 12:1 (mistral); head
#: sizes 128, 256 and 112
ATTENTION_PATH_SHAPES = (
    ("whisper encoder", 4, 20, 20, 1500, 1500, 64, False),
    ("whisper decoder", 4, 20, 20, 448, 448, 64, True),
    ("zamba2 shared block", 2, 32, 32, 2048, 2048, 80, True),
    ("qwen3", 2, 16, 8, 2048, 2048, 128, True),
    ("gemma3 global", 2, 8, 4, 2048, 2048, 256, True),
    ("olmoe", 2, 16, 16, 2048, 2048, 128, True),
    ("internlm2", 2, 48, 8, 2048, 2048, 128, True),
    ("mistral", 2, 96, 8, 2048, 2048, 128, True),
    ("kimi", 2, 64, 8, 2048, 2048, 112, True),
)


def attention_specs(path_shapes=ATTENTION_PATH_SHAPES, seed: int = 0):
    """The flash kernel's checks as ``(label, (B, H, KH, Sq, Sk, D), dtype,
    kwargs, seed)``: the paths' shapes in bfloat16 (the models' dtype), and
    the edge cases in float32 and bfloat16: the reference kernel tests'
    MHA, GQA 2:1, MQA, windows 32 and 128, a kv_len mask with Sq = 1 and
    S = 200 (not a tile multiple); non-causal, every head size the kernel
    takes, Sq < Sk with kv_len < Sk, a window narrower than a tile, and
    rows that no key reaches (kv_len < Sq, kv_len = 0). Then the edges of
    the bf16 route's tiles (``kernel.tiles``): Sk one k tile + 1 and
    Sk = 1 (the copy's zero fill), D = 256 across its own k tiles, GQA 4:1
    causal with Sq < Sk and kv_len < Sk, Sq not a q tile multiple under
    the causal schedule, and a sharp softmax (scores of standard deviation
    about 20, as random-init whisper gives them)."""
    out = []

    def add(label, b, h, kh, s_q, s_k, d, dtype=torch.float32, **kw):
        name = "bf16" if dtype == torch.bfloat16 else "f32"
        out.append((f"{label} {name}", (b, h, kh, s_q, s_k, d), dtype, kw,
                    seed + len(out)))

    for label, b, h, kh, s_q, s_k, d, causal in path_shapes:
        add(f"path {label} B={b} H={h} S={s_q} D={d}", b, h, kh, s_q, s_k,
            d, torch.bfloat16, causal=causal)
    for dtype in (torch.float32, torch.bfloat16):
        add("MHA S=256", 1, 4, 4, 256, 256, 64, dtype)
        add("GQA 2:1 S=128", 2, 4, 2, 128, 128, 64, dtype)
        add("MQA S=256 D=32", 1, 8, 1, 256, 256, 32, dtype)
        add("window 32", 1, 2, 2, 256, 256, 64, dtype, window=32)
        add("window 128", 1, 2, 2, 256, 256, 64, dtype, window=128)
        add("Sq=1 kv_len=200 non-causal", 1, 2, 2, 1, 384, 64, dtype,
            causal=False, kv_len=200)
        add("S=200 (not a tile multiple)", 1, 2, 2, 200, 200, 64, dtype)
        add("non-causal S=200 D=80", 2, 3, 3, 200, 200, 80, dtype,
            causal=False)
        add("D=80 causal S=150", 1, 4, 2, 150, 150, 80, dtype)
        add("Sq=100 < Sk=300 kv_len=250 causal", 1, 2, 1, 100, 300, 64,
            dtype, kv_len=250)
        add("window 5 < tile kv_len=90 Sq=70", 1, 2, 2, 70, 130, 64, dtype,
            window=5, kv_len=90)
        add("rows no key reaches: kv_len=40 < Sq=100", 1, 2, 2, 100, 64, 64,
            dtype, kv_len=40)
        add("kv_len=0", 1, 2, 2, 10, 64, 64, dtype, causal=False, kv_len=0)
        add("Sq=1 causal decode Sk=77", 2, 4, 2, 1, 77, 128, dtype)
        for d in (16, 112, 256):
            add(f"D={d} S=130", 1, 2, 2, 130, 130, d, dtype)
    # the bf16 route's tile edges (after the cases above, whose seeds stay
    # as they were)
    for dtype in (torch.float32, torch.bfloat16):
        for d in (64, 256):
            block_q, block_k = tiles(d)
            add(f"Sk={block_k + 1} (one k tile + 1) non-causal D={d}", 1, 2,
                2, 40, block_k + 1, d, dtype, causal=False)
            add(f"Sq={3 * block_q + 17} (not a q tile multiple) causal "
                f"D={d}", 1, 2, 1, 3 * block_q + 17, 3 * block_q + 17, d,
                dtype)
        add("Sk=1 non-causal", 2, 2, 2, 5, 1, 64, dtype, causal=False)
        add("Sk=1 causal Sq=1", 1, 4, 2, 1, 1, 80, dtype)
        add("D=256 S=300 causal", 1, 2, 2, 300, 300, 256, dtype)
        add("GQA 4:1 causal Sq=90 < Sk=260 kv_len=200", 1, 8, 2, 90, 260,
            80, dtype, kv_len=200)
        add("sharp softmax (scores sd 20) S=333", 1, 4, 4, 333, 333, 64,
            dtype, scale=20 / 8)
        add("sharp softmax (scores sd 20) non-causal D=80", 2, 2, 2, 150,
            300, 80, dtype, causal=False, scale=20 / 80 ** 0.5)
    return out


def attention_cases(device: torch.device,
                    path_shapes=ATTENTION_PATH_SHAPES,
                    seed: int = 0) -> List[Case]:
    """Every check of ``attention_specs`` as a kernel-versus-plain case on
    ``device``."""
    out: List[Case] = []
    for label, shape, dtype, kw, case_seed in attention_specs(path_shapes,
                                                              seed):
        x = attention_inputs(device, *shape, dtype=dtype, seed=case_seed)
        out.append(Case("flash_attention", label,
                        lambda x=x, kw=kw: flash_attention_kernel(*x, **kw),
                        lambda x=x, kw=kw: attention_ref(*x, **kw)))
    return out


def float_mismatches(case: Case) -> Tuple[int, float]:
    """(elements out of tolerance, largest absolute difference) between
    the kernel and the plain version; a shape or dtype disagreement counts
    every element."""
    got, want = _tuple(case.kernel_fn()), _tuple(case.plain_fn())
    torch.cuda.synchronize()
    return out_of_tolerance(got, want)


def out_of_tolerance(got: Sequence[torch.Tensor],
                     want: Sequence[torch.Tensor]) -> Tuple[int, float]:
    """(elements of ``got`` out of ``TOLERANCE`` against ``want``, largest
    absolute difference); a shape or dtype disagreement counts every
    element."""
    bad, err = abs(len(got) - len(want)), 0.0
    for g, w in zip(got, want):
        if g.shape != w.shape or g.dtype != w.dtype:
            bad += max(g.numel(), w.numel(), 1)
            continue
        if not w.numel():
            continue
        rtol, atol_frac = TOLERANCE[w.dtype]
        g, w = g.float(), w.float()
        diff = (g - w).abs()
        limit = rtol * w.abs() + atol_frac * float(w.abs().max())
        bad += host_int((~(diff <= limit)).sum())
        err = max(err, float(diff.max()))
    return bad, err
