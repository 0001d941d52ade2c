"""Wrapper around the CUDA Mamba2 SSD kernel (``csrc/mamba2_ssd.cu``).

It checks its inputs, copies any that does not start on a 16-byte boundary
(:func:`repro_torch.kernels.aligned16`), allocates the outputs and the
kernel's workspace (the bf16 route's c b^T per chunk and per-segment
transitions) with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reported a CUDA error, and adds one to
its launch count (one call, though the bf16 route runs three CUDA
kernels).
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import (_lib, aligned16, count_launch, float_code,
                                 refuse_grad)

#: the kernel's compiled chunk, head dim and state size
CHUNK = 64
HEAD_DIM = 64
STATE = 64
#: chunks per segment on the bf16 route, passed to the kernel: segments
#: run in parallel, joined by their transitions
SEGMENT_CHUNKS = 4


def workspace_bytes(b: int, h: int, t: int) -> int:
    """Bytes of the bf16 route's workspace, float32: c b^T [L, L] per
    (batch row, chunk), then the transition (M [N, P] and D) of every
    segment but the last, per (batch, head)."""
    chunks = -(-t // CHUNK)
    segments = max(1, -(-chunks // SEGMENT_CHUNKS))
    return 4 * (b * chunks * CHUNK * CHUNK
                + b * h * (segments - 1) * (STATE * HEAD_DIM + 1))


def mamba2_ssd_kernel(xdt: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
                      c: torch.Tensor, state: Optional[torch.Tensor] = None,
                      *, chunk: int = CHUNK
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xdt [B,H,T,64] and b/c [B,T,64] (one dtype: float32 or bfloat16),
    la [B,H,T] float32, state [B,H,64,64] float32 or None (zeros) ->
    (y [B,H,T,64] in that dtype, final state float32), on the card;
    semantics of :func:`.ref.mamba2_ssd_ref` for any T."""
    what = "mamba2_ssd"
    refuse_grad(what, xdt, la, b, c, state)
    bb, h, t, p = xdt.shape
    n = b.shape[-1]
    if chunk != CHUNK or p != HEAD_DIM or n != STATE:
        raise ValueError(f"{what}: the kernel takes chunk {CHUNK}, head dim "
                         f"{HEAD_DIM} and state {STATE}, got {chunk}, {p} "
                         f"and {n}")
    for x in (la, b, c):
        if x.device != xdt.device or x.device.type != "cuda":
            raise ValueError(f"{what}: CUDA tensors on one device required")
    if tuple(la.shape) != (bb, h, t) or la.dtype != torch.float32:
        raise ValueError(f"{what}: la must be [B, H, T] float32")
    if tuple(b.shape) != (bb, t, n) or tuple(c.shape) != (bb, t, n):
        raise ValueError(f"{what}: b and c must be [B, T, N]")
    if b.dtype != xdt.dtype or c.dtype != xdt.dtype:
        raise ValueError(f"{what}: xdt, b and c must share a dtype")
    if state is not None and (state.dtype != torch.float32 or
                              tuple(state.shape) != (bb, h, n, p) or
                              state.device != xdt.device):
        raise ValueError(f"{what}: state must be [B, H, N, P] float32 on "
                         "xdt's device")
    code = float_code(xdt, what)
    xdt, la, b, c = (aligned16(x) for x in (xdt, la, b, c))
    s0 = None if state is None else aligned16(state)
    y = torch.empty_like(xdt)
    s_out = torch.empty((bb, h, n, p), dtype=torch.float32,
                        device=xdt.device)
    if bb * h == 0:
        return y, s_out
    work = torch.empty(workspace_bytes(bb, h, t)
                       if xdt.dtype == torch.bfloat16 else 0,
                       dtype=torch.uint8, device=xdt.device)
    rc = _lib.lib().mapsdi_mamba2_ssd(
        xdt.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(),
        s_out.data_ptr(), work.data_ptr() if work.numel() else None,
        work.numel(), bb, h, t, p, n, chunk, SEGMENT_CHUNKS, code,
        xdt.device.index or 0,
        torch.cuda.current_stream(xdt.device).cuda_stream)
    _lib.check(rc, what)
    count_launch(what)
    return y, s_out
