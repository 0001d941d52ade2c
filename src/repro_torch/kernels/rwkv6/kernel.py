"""Wrapper around the CUDA RWKV6 kernel (``csrc/rwkv6.cu``), as the
custom op ``torch.ops.repro_torch.rwkv6``.

The wrapper checks its inputs and calls the op. The op's CUDA
implementation copies any input that does not start on a 16-byte
boundary (:func:`repro_torch.kernels.aligned16`), allocates the outputs
and the kernel's workspace (the bf16 route's per-segment transitions)
with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reported a CUDA error, and adds one
to its launch count (one call, though the bf16 route runs two CUDA
kernels). Its fake implementation, FLOP formula and DTensor sharding
(each (batch, head) runs alone: batch or head shards run locally) let
it trace on fake tensors and meshes, as the dry-run does.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import (_lib, aligned16, count_launch, float_code,
                                 on_card, refuse_grad,
                                 register_head_sharding, work)

#: the kernel's compiled chunk and head size
CHUNK = work.RWKV6_CHUNK
HEAD_SIZE = work.RWKV6_HEAD
#: chunks per segment on the bf16 route, passed to the kernel: segments
#: run in parallel, joined by their transitions
SEGMENT_CHUNKS = 16


def workspace_bytes(b: int, h: int, t: int) -> int:
    """Bytes of the bf16 route's workspace: the float32 transition (M
    [N, N] and D [N]) of every segment but the last, per (batch, head)."""
    chunks = -(-t // CHUNK)
    segments = max(1, -(-chunks // SEGMENT_CHUNKS))
    return b * h * (segments - 1) * (HEAD_SIZE * HEAD_SIZE + HEAD_SIZE) * 4


def rwkv6_kernel(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 w: torch.Tensor, u: torch.Tensor,
                 state: Optional[torch.Tensor] = None, *,
                 chunk: int = CHUNK) -> Tuple[torch.Tensor, torch.Tensor]:
    """r/k/v/w [B,H,T,64] (one dtype: float32 or bfloat16), u [H,64]
    float32, state [B,H,64,64] float32 or None (zeros) -> (y [B,H,T,64]
    in that dtype, final state float32), on the card; semantics of
    :func:`.ref.rwkv6_chunked` for any T."""
    what = "rwkv6"
    refuse_grad(what, r, k, v, w, u, state)
    b, h, t, n = r.shape
    if chunk != CHUNK or n != HEAD_SIZE:
        raise ValueError(f"{what}: the kernel takes chunk {CHUNK} and head "
                         f"size {HEAD_SIZE}, got {chunk} and {n}")
    for x in (r, k, v, w):
        if x.device != r.device or not on_card(x):
            raise ValueError(f"{what}: CUDA tensors on one device required")
        if tuple(x.shape) != (b, h, t, n):
            raise ValueError(f"{what}: r/k/v/w shapes differ")
    if any(x.dtype != r.dtype for x in (k, v, w)):
        raise ValueError(f"{what}: r, k, v and w must share a dtype")
    if u.dtype != torch.float32 or tuple(u.shape) != (h, n) \
            or u.device != r.device:
        raise ValueError(f"{what}: u must be [H, N] float32 on r's device")
    if state is not None and (state.dtype != torch.float32 or
                              tuple(state.shape) != (b, h, n, n) or
                              state.device != r.device):
        raise ValueError(f"{what}: state must be [B, H, N, N] float32 on r's "
                         "device")
    float_code(r, what)
    return _OP(r, k, v, w, u, state)


torch.library.define(
    "repro_torch::rwkv6",
    "(Tensor r, Tensor k, Tensor v, Tensor w, Tensor u, Tensor? state) "
    "-> (Tensor, Tensor)")
_OP = torch.ops.repro_torch.rwkv6.default


@torch.library.impl("repro_torch::rwkv6", "CUDA")
def _launch(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            w: torch.Tensor, u: torch.Tensor, state: Optional[torch.Tensor]
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The launch, on inputs :func:`rwkv6_kernel` checked."""
    what = "rwkv6"
    b, h, t, n = r.shape
    code = float_code(r, what)
    r, k, v, w, u = (aligned16(x) for x in (r, k, v, w, u))
    s0 = None if state is None else aligned16(state)
    y = torch.empty_like(r)
    s_out = torch.empty((b, h, n, n), dtype=torch.float32, device=r.device)
    if b * h == 0:
        return y, s_out
    work_buf = torch.empty(workspace_bytes(b, h, t)
                           if r.dtype == torch.bfloat16 else 0,
                           dtype=torch.uint8, device=r.device)
    rc = _lib.lib().mapsdi_rwkv6(
        r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
        None if s0 is None else s0.data_ptr(), y.data_ptr(),
        s_out.data_ptr(),
        work_buf.data_ptr() if work_buf.numel() else None,
        work_buf.numel(), b, h, t, n, CHUNK, SEGMENT_CHUNKS, code,
        r.device.index or 0, torch.cuda.current_stream(r.device).cuda_stream)
    _lib.check(rc, what)
    count_launch(what)
    return y, s_out


@torch.library.register_fake("repro_torch::rwkv6")
def _fake(r, k, v, w, u, state):
    b, h, _, n = r.shape
    return (torch.empty_like(r),
            r.new_empty((b, h, n, n), dtype=torch.float32))


@register_flop_formula(_OP.overloadpacket)
def _flops(r_shape, k_shape, v_shape, w_shape, u_shape, state_shape, *,
           out_shape=None, **kwargs) -> int:
    b, h, t, _ = r_shape
    return work.flops(work.rwkv6_work(b, h, t))


# r, k, v, w [B,H,T,N] and the state [B,H,N,N] by batch or head; u [H,N]
# whole, or by head
register_head_sharding(_OP, batch=(0, 0, 0, 0, None, 0),
                       heads=(1, 1, 1, 1, 0, 1), outputs=2)
