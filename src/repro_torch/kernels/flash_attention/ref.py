"""Plain PyTorch version of flash attention (causal / sliding window /
GQA / ``kv_len`` mask), the path a CPU tensor takes.

q [B, H, Sq, D], k/v [B, KH, Sk, D] with H % KH == 0; q row i sits at
absolute position ``i + kv_len - Sq`` (the end of the kv timeline). The
full score matrix in float32, masked with ``MASK_VALUE``, a softmax, and
the output in q's dtype: the JAX package's ``attention_ref``, with one
difference that the reference's own kernel and oracle disagree on: a row
that no key reaches gives 0, as the reference's Pallas kernel (and the
port's CUDA kernel) give it, where the reference's oracle spreads the
softmax evenly over the masked scores. Every other row is unchanged.
"""
from __future__ import annotations

from typing import Optional

import torch

MASK_VALUE = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: Optional[int] = None,
                  scale: Optional[float] = None,
                  kv_len: Optional[int] = None) -> torch.Tensor:
    b, h, s_q, d = q.shape
    _, kh, s_k, _ = k.shape
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    group = h // kh
    scale = (d ** -0.5) if scale is None else scale
    if group > 1:
        k = torch.repeat_interleave(k, group, dim=1)
        v = torch.repeat_interleave(v, group, dim=1)

    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    dev = q.device
    k_pos = torch.arange(s_k, device=dev)[None, :]
    # when s_q < s_k (decode), q aligns to the END of the kv timeline
    offset = (kv_len if kv_len is not None else s_k) - s_q
    q_abs = torch.arange(s_q, device=dev)[:, None] + offset
    mask = torch.ones((s_q, s_k), dtype=torch.bool, device=dev)
    if causal:
        mask &= q_abs >= k_pos
    if window is not None and window > 0:
        mask &= (q_abs - k_pos) < window
    if kv_len is not None:
        mask &= k_pos < kv_len
    scores = torch.where(mask, scores, MASK_VALUE)
    probs = torch.where(mask, torch.softmax(scores, dim=-1), 0.0)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v.float())
    return out.to(q.dtype)
