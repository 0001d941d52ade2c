"""The work each float kernel's function needs, from its shapes.

One source for three readers: the kernels' FLOP formulas
(``torch.utils.flop_counter``, registered beside each op in its
``kernel.py``), the dry-run's per-device bytes and FLOPs
(``launch/specs.py``) and ``chip_smoke.py``'s bounds. Bytes count each
input read once and each output written once (a kernel's workspace is
not the function's work); operations count what these inputs need:
attention's fully masked (q, k) pairs need none, a causal chunk's upper
triangle is zero.

``products`` are the matrix products in flop-equivalents (a multiply-add
counts two), per product kind, before the passes a kernel's bf16 route
takes on the tensor cores (``chip_smoke.py`` multiplies by those);
``elementwise`` the float32 operations beside them; ``exp`` the
exponentials. The FLOP formula of an op is the sum of its products, as a
matrix product's FLOPs are ``2·M·N·K``.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

#: the recurrence kernels' chunk lengths, head sizes and state sizes
#: (``rwkv6/kernel.py``, ``mamba2/kernel.py``)
RWKV6_CHUNK, RWKV6_HEAD = 32, 64
MAMBA2_CHUNK, MAMBA2_HEAD, MAMBA2_STATE = 64, 64, 64


def attention_pairs(s_q: int, s_k: int, causal: bool,
                    window: Optional[int] = None,
                    kv_len: Optional[int] = None) -> int:
    """Unmasked (q, k) pairs of one (batch, head): query ``i`` sits at
    key position ``i + kv - s_q`` and sees keys ``lo..hi``."""
    kv = s_k if kv_len is None else kv_len
    qp = np.arange(s_q, dtype=np.int64) + (kv - s_q)
    hi = np.minimum(kv - 1, qp) if causal else np.full(s_q, kv - 1)
    lo = np.maximum(0, qp - window + 1) if window else np.zeros(s_q,
                                                                np.int64)
    return int(np.maximum(0, hi - lo + 1).sum())


def attention_work(b: int, h: int, kh: int, s_q: int, s_k: int, d: int,
                   causal: bool, window: Optional[int] = None,
                   kv_len: Optional[int] = None,
                   itemsize: int = 2) -> Dict[str, int]:
    """Flash attention, q [B,H,Sq,D], k/v [B,KH,Sk,D] -> o [B,H,Sq,D]:
    q, k, v read once and o written once; per unmasked pair two
    multiply-adds over D (scores and p·v) and one exponential."""
    pairs = b * h * attention_pairs(s_q, s_k, causal, window, kv_len)
    return {"bytes": itemsize * (2 * b * h * s_q * d + 2 * b * kh * s_k * d),
            "products": {"q k^T": 2 * pairs * d, "p v": 2 * pairs * d},
            "elementwise": 0, "exp": pairs}


def rwkv6_work(b: int, h: int, t: int, state: bool = False,
               itemsize: int = 2) -> Dict[str, object]:
    """RWKV6 over chunks of 32: r, k, v, w read and y written in the
    inputs' dtype, u [H, 64] float32, the float32 state [B,H,64,64]
    written (and read when given). Per chunk of length L: the causal
    scores' lower triangle times v, q·S and (k·w)^T v; a score's
    exp(a - b)·r·k counts four elementwise operations and one exp."""
    n, ln = RWKV6_HEAD, RWKV6_CHUNK
    chunks = b * h * (-(-t // ln))
    tri = ln * (ln - 1) // 2
    prods = {"scores v": 2 * tri * n, "q S": 2 * ln * n * n,
             "kw^T v": 2 * ln * n * n}
    return {"bytes": (5 * b * h * t * n * itemsize + h * n * 4
                      + (1 + state) * b * h * n * n * 4),
            "products": {k: chunks * v for k, v in prods.items()},
            "elementwise": chunks * (4 * tri * n + 8 * ln * n + 2 * n * n),
            "exp": chunks * (tri * n + 2 * ln * n + n)}


def mamba2_work(b: int, h: int, t: int, state: bool = False,
                itemsize: int = 2) -> Dict[str, object]:
    """Mamba2 SSD over chunks of 64: xdt [B,H,T,64] read and y written in
    the inputs' dtype, la [B,H,T] float32, b and c [B,T,64], the float32
    state [B,H,64,64] written (and read when given). Per chunk: the
    causal scores times xdt, c·S and (b·w)^T xdt; c b^T is shared by the
    heads of a batch row and counted once per row."""
    n = p = ln = MAMBA2_CHUNK
    row_chunks = -(-t // ln)
    chunks = b * h * row_chunks
    tri = ln * (ln + 1) // 2
    prods = {"scores xdt": 2 * tri * p, "c S": 2 * ln * n * p,
             "bw^T xdt": 2 * ln * n * p}
    products = {k: chunks * v for k, v in prods.items()}
    products["c b^T"] = b * row_chunks * 2 * tri * n
    return {"bytes": (2 * b * h * t * p * itemsize + b * h * t * 4
                      + 2 * b * t * n * itemsize
                      + (1 + state) * b * h * n * p * 4),
            "products": products,
            "elementwise": chunks * (2 * tri + 3 * ln * n + 2 * n * p),
            "exp": chunks * (tri + 2 * ln + 1)}


def flops(work: Dict[str, object]) -> int:
    """The FLOP count of a work record: its products' sum."""
    return int(sum(work["products"].values()))
