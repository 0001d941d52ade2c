"""Wrapper around the CUDA Mamba2 SSD kernel (``csrc/mamba2_ssd.cu``), as
the custom op ``torch.ops.repro_torch.mamba2_ssd``.

The wrapper checks its inputs and calls the op. The op's CUDA
implementation copies any input that does not start on a 16-byte
boundary (:func:`repro_torch.kernels.aligned16`), allocates the outputs
and the kernel's workspace (the bf16 route's c b^T per chunk and
per-segment transitions) with ``torch.empty``, launches on the current
stream without synchronising, raises if the launch reported a CUDA
error, and adds one to its launch count (one call, though the bf16 route
runs three CUDA kernels). Its fake implementation, FLOP formula and
DTensor sharding (by batch, or by head with b and c whole) let it trace
on fake tensors and meshes, as the dry-run does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import (_lib, aligned16, count_launch, float_code,
                                 on_card, refuse_grad,
                                 register_head_sharding, work)

#: the kernel's compiled chunk, head dim and state size
CHUNK = work.MAMBA2_CHUNK
HEAD_DIM = work.MAMBA2_HEAD
STATE = work.MAMBA2_STATE
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
        if x.device != xdt.device or not on_card(x):
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
    float_code(xdt, what)
    return _OP(xdt, la, b, c, state)


torch.library.define(
    "repro_torch::mamba2_ssd",
    "(Tensor xdt, Tensor la, Tensor b, Tensor c, Tensor? state) "
    "-> (Tensor, Tensor)")
_OP = torch.ops.repro_torch.mamba2_ssd.default


@torch.library.impl("repro_torch::mamba2_ssd", "CUDA")
def _launch(xdt: torch.Tensor, la: torch.Tensor, b: torch.Tensor,
            c: torch.Tensor, state: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch, on inputs :func:`mamba2_ssd_kernel` checked."""
    what = "mamba2_ssd"
    bb, h, t, p = xdt.shape
    n = b.shape[-1]
    code = float_code(xdt, what)
    xdt, la, b, c = (aligned16(x) for x in (xdt, la, b, c))
    s0 = None if state is None else aligned16(state)
    y = torch.empty_like(xdt)
    s_out = torch.empty((bb, h, n, p), dtype=torch.float32,
                        device=xdt.device)
    if bb * h == 0:
        return y, s_out
    work_buf = torch.empty(workspace_bytes(bb, h, t)
                           if xdt.dtype == torch.bfloat16 else 0,
                           dtype=torch.uint8, device=xdt.device)
    rc = _lib.lib().mapsdi_mamba2_ssd(
        xdt.data_ptr(), la.data_ptr(), b.data_ptr(), c.data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(),
        s_out.data_ptr(),
        work_buf.data_ptr() if work_buf.numel() else None,
        work_buf.numel(), bb, h, t, p, n, CHUNK, SEGMENT_CHUNKS, code,
        xdt.device.index or 0,
        torch.cuda.current_stream(xdt.device).cuda_stream)
    _lib.check(rc, what)
    count_launch(what)
    return y, s_out


@torch.library.register_fake("repro_torch::mamba2_ssd")
def _fake(xdt, la, b, c, state):
    bb, h, _, p = xdt.shape
    return (torch.empty_like(xdt),
            xdt.new_empty((bb, h, b.shape[-1], p), dtype=torch.float32))


@register_flop_formula(_OP.overloadpacket)
def _flops(xdt_shape, la_shape, b_shape, c_shape, state_shape, *,
           out_shape=None, **kwargs) -> int:
    bb, h, t, _ = xdt_shape
    return work.flops(work.mamba2_work(bb, h, t))


# xdt [B,H,T,P], la [B,H,T] and the state [B,H,N,P] by batch or head; b
# and c [B,T,N] by batch, or whole
register_head_sharding(_OP, batch=(0, 0, 0, 0, 0),
                       heads=(1, 1, None, None, 1), outputs=2)
