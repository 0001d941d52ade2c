"""Plain PyTorch versions of the Mamba2 SSD (state-space dual) recurrence.

Per head (headdim P, state N), scalar decay per step ``a_t = exp(dt_t A)``::

    h_t = a_t h_{t-1} + B_t (dt_t x_t)^T        h: [N, P]
    y_t = C_t^T h_t

B/C are shared across the heads of a batch row (ngroups = 1): [B, T, N].

``ssd_scan_ref`` is the per-token oracle and ``ssd_chunked`` the JAX
package's chunked jnp form (x * dt kept in float32); tests only.
``mamba2_ssd_ref`` is the plain version of the CUDA kernel
(``csrc/mamba2_ssd.cu``) and the path a CPU tensor takes: it takes
``(xdt, la, b, c)`` exactly as the kernel does and runs the chunked
matrix form, chunk after chunk, in float32.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def _xdt_la(x, dt, a):
    la = dt.float() * a.float()[None, :, None]
    return x.float() * dt.float()[..., None], la


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                 b: torch.Tensor, c: torch.Tensor,
                 state: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [B,H,T,P]; dt [B,H,T]; a (log-decay coef A) [H]; b/c [B,T,N].
    Returns (y [B,H,T,P] in x's dtype, final state [B,H,N,P] f32)."""
    bb, h, t, p = x.shape
    n = b.shape[-1]
    s = (torch.zeros((bb, h, n, p), dtype=torch.float32, device=x.device)
         if state is None else state.float())
    xdt, la = _xdt_la(x, dt, a)
    bf, cf = b.float(), c.float()
    ys = []
    for i in range(t):
        s = (torch.exp(la[:, :, i])[..., None, None] * s
             + bf[:, None, i, :, None] * xdt[:, :, i, None, :])
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, i], s))
    y = torch.stack(ys, dim=2) if ys else xdt
    return y.to(x.dtype), s


def mamba2_ssd_ref(xdt: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
                   c: torch.Tensor, state: Optional[torch.Tensor] = None, *,
                   chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt [B,H,T,P] (= x*dt); la [B,H,T] (= dt*A); b/c [B,T,N].
    Returns (y [B,H,T,P] in xdt's dtype, state [B,H,N,P] f32). T need not
    be a chunk multiple: the tail is padded with xdt = b = c = 0 and
    la = 0, which leaves the first T outputs and the final state
    unchanged."""
    bb, h, t, p = xdt.shape
    n = b.shape[-1]
    s = (torch.zeros((bb, h, n, p), dtype=torch.float32, device=xdt.device)
         if state is None else state.float())
    pad = (-t) % chunk
    xf = F.pad(xdt.float(), (0, 0, 0, pad))
    lf = F.pad(la.float(), (0, pad))
    bf, cf = (F.pad(m.float(), (0, 0, 0, pad)) for m in (b, c))
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool,
                                 device=xdt.device))
    ys = []
    for c0 in range(0, t + pad, chunk):
        xc = xf[:, :, c0:c0 + chunk]                            # [B,H,L,P]
        cum = torch.cumsum(lf[:, :, c0:c0 + chunk], dim=-1)     # [B,H,L]
        bc, cc = bf[:, c0:c0 + chunk], cf[:, c0:c0 + chunk]     # [B,L,N]
        diff = cum[..., :, None] - cum[..., None, :]            # [B,H,L,L]
        decay = torch.where(mask, torch.exp(torch.where(mask, diff, 0.0)),
                            0.0)
        scores = (cc @ bc.transpose(-1, -2))[:, None] * decay
        q = cc[:, None] * torch.exp(cum)[..., None]             # [B,H,L,N]
        ys.append(scores @ xc + q @ s)
        bw = bc[:, None] * torch.exp(cum[..., -1:] - cum)[..., None]
        s = torch.exp(cum[..., -1])[..., None, None] * s \
            + bw.transpose(-1, -2) @ xc
    y = torch.cat(ys, dim=2) if ys else xf
    return y[:, :, :t].to(xdt.dtype), s


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                b: torch.Tensor, c: torch.Tensor,
                state: Optional[torch.Tensor] = None, *,
                chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's chunked route: x*dt kept in float32 (the Pallas
    route, which the port's dispatcher follows, rounds it to x's dtype)."""
    xdt, la = _xdt_la(x, dt, a)
    y, s = mamba2_ssd_ref(xdt, la, b, c, state, chunk=chunk)
    return y.to(x.dtype), s
