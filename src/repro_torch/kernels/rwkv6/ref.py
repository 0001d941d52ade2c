"""Plain PyTorch versions of the RWKV6 (Finch) time-mix recurrence.

Per head (key/value dim N): data-dependent per-channel decay ``w_t`` and
bonus ``u``::

    S_{t+1} = diag(w_t) S_t + k_t v_t^T
    y_t     = (S_t + diag(u) k_t v_t^T)^T r_t

``rwkv6_scan_ref`` is the per-token oracle (tests only).
``rwkv6_chunked`` is the chunked matrix form the CUDA kernel computes
(``csrc/rwkv6.cu``), and the path a CPU tensor takes: per chunk of L
tokens, exact log-space intra-chunk decay, the bonus term, the
contribution of the state entering the chunk, and the state update, in
float32. Chunks run in order, as in the kernel (the JAX package's jnp
form combines chunk summaries with an associative scan instead; the
arithmetic per chunk is the same).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def rwkv6_scan_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   w: torch.Tensor, u: torch.Tensor,
                   state: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w: [B,H,T,N] (w = decay in (0,1)), u: [H,N].
    Returns (y [B,H,T,N] in r's dtype, final state [B,H,N,N] f32)."""
    b, h, t, n = r.shape
    s = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    uf = u.float()[None, :, :, None]
    ys = []
    for i in range(t):
        kv = kf[:, :, i, :, None] * vf[:, :, i, None, :]       # [B,H,N,N]
        ys.append(torch.einsum("bhi,bhij->bhj", rf[:, :, i], s + uf * kv))
        s = wf[:, :, i, :, None] * s + kv
    y = torch.stack(ys, dim=2) if ys else rf.new_zeros((b, h, 0, n))
    return y.to(r.dtype), s


def rwkv6_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  w: torch.Tensor, u: torch.Tensor,
                  state: Optional[torch.Tensor] = None, *,
                  chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked RWKV6, the plain version of ``rwkv6_kernel`` (same
    signature and semantics as the scan oracle). T need not be a chunk
    multiple: the tail is padded with r = k = v = 0 and w = 1, which
    leaves the first T outputs and the final state unchanged."""
    b, h, t, n = r.shape
    s = (torch.zeros((b, h, n, n), dtype=torch.float32, device=r.device)
         if state is None else state.float())
    pad = (-t) % chunk
    rf, kf, vf = (F.pad(x.float(), (0, 0, 0, pad)) for x in (r, k, v))
    wf = F.pad(w.float(), (0, 0, 0, pad), value=1.0)
    # keep log(w) finite when w underflows to 0 (decay saturated anyway)
    lw = torch.log(torch.clamp_min(wf, 1e-30))
    uf = u.float()[None, :, None, :]                            # [1,H,1,N]
    lower = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                  device=r.device), diagonal=-1)
    ys = []
    for c0 in range(0, t + pad, chunk):
        rc, kc, vc, lwc = (x[:, :, c0:c0 + chunk] for x in (rf, kf, vf, lw))
        cum = torch.cumsum(lwc, dim=2)                          # inclusive
        cum_excl = cum - lwc                                    # exclusive
        # [B,H,L,L,N] exponent cum_excl[t] - cum[s] <= 0 for s < t
        diff = cum_excl[:, :, :, None, :] - cum[:, :, None, :, :]
        diff = torch.where(lower[:, :, None], diff, -1e30)
        scores = (torch.exp(diff) * rc[:, :, :, None, :]
                  * kc[:, :, None, :, :]).sum(-1)               # [B,H,L,L]
        bonus = (rc * uf * kc).sum(-1)                          # [B,H,L]
        q = rc * torch.exp(cum_excl)
        ys.append(scores @ vc + bonus[..., None] * vc + q @ s)
        last = cum[:, :, -1]                                    # [B,H,N]
        m = (kc * torch.exp(last[:, :, None, :] - cum)).transpose(-1, -2) @ vc
        s = torch.exp(last)[..., None] * s + m
    y = torch.cat(ys, dim=2) if ys else rf
    return y[:, :, :t].to(r.dtype), s
