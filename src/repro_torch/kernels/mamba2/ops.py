"""Dispatcher: the CUDA kernel for a CUDA tensor, the plain version for a
CPU tensor (policy: :func:`repro_torch.kernels.resolve_use_kernel`)."""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import resolve_use_kernel

from .kernel import mamba2_ssd_kernel
from .ref import mamba2_ssd_ref


def mamba2_ssd(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
               b: torch.Tensor, c: torch.Tensor,
               state: Optional[torch.Tensor] = None, *, chunk: int = 64,
               use_kernel: Optional[bool] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD. x [B,H,T,P]; dt [B,H,T]; a [H]; b/c [B,T,N].

    Both devices follow the reference's Pallas route: ``x*dt`` is rounded
    to x's dtype before the scan (its chunked jnp route keeps it in
    float32; see :func:`.ref.ssd_chunked`)."""
    la = dt.float() * a.float()[None, :, None]
    xdt = (x.float() * dt.float()[..., None]).to(x.dtype)
    if resolve_use_kernel(x, use_kernel):
        return mamba2_ssd_kernel(xdt, la, b, c, state, chunk=chunk)
    return mamba2_ssd_ref(xdt, la, b, c, state, chunk=chunk)
