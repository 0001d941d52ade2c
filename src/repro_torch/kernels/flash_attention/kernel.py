"""Wrapper around the CUDA flash-attention kernel
(``csrc/flash_attention.cu``), as the custom op
``torch.ops.repro_torch.flash_attention``.

The wrapper checks its inputs and calls the op. The op's CUDA
implementation copies any input that does not start on a 16-byte
boundary (:func:`repro_torch.kernels.aligned16`), allocates the output
with ``torch.empty``, launches on the current stream without
synchronising, raises if the launch reported a CUDA error, and adds one
to its launch count. Its fake implementation gives the output's shape
and dtype, so the op traces on fake tensors (``FakeTensorMode``, the
dry-run) without a card, as the reference's ``pallas_call`` traces
abstractly; its FLOP formula (``torch.utils.flop_counter``) comes from
:mod:`repro_torch.kernels.work`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import (_lib, aligned16, count_launch, float_code,
                                 on_card, refuse_grad, work)

#: head sizes the kernel is compiled for (every ``d_head`` of the configs,
#: and the reduced configs' 16)
HEAD_SIZES = (16, 32, 64, 80, 112, 128, 256)


def tiles(d: int) -> Tuple[int, int]:
    """(block_q, block_k) of the bf16 route at head size ``d``: q rows per
    block (16 per warp, 4 warps) and k/v rows per tile, passed to the
    kernel. k tiles of 64 rows, 32 at D = 256, where the output
    accumulators take 128 registers a thread (at 64 rows ptxas spills).
    The float32 route keeps tiles of its own."""
    return 64, (32 if d > 128 else 64)


def flash_attention_kernel(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           *, causal: bool = True,
                           window: Optional[int] = None,
                           scale: Optional[float] = None,
                           kv_len: Optional[int] = None) -> torch.Tensor:
    """q [B,H,Sq,D], k/v [B,KH,Sk,D] (one dtype: float32 or bfloat16) ->
    o [B,H,Sq,D] in that dtype, on the card; semantics of
    :func:`.ref.attention_ref`."""
    what = "flash_attention"
    refuse_grad(what, q, k, v)
    b, h, s_q, d = q.shape
    _, kh, s_k, _ = k.shape
    if tuple(k.shape) != (b, kh, s_k, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"{what}: k and v must be [B, KH, Sk, D] with q's "
                         "B and D")
    if kh == 0 or h % kh:
        raise ValueError(f"{what}: {h} query heads do not group over {kh} kv "
                         "heads")
    if d not in HEAD_SIZES:
        raise ValueError(f"{what}: the kernel takes head sizes {HEAD_SIZES}, "
                         f"got {d}")
    if b * h > 65535:
        raise ValueError(f"{what}: at most 65535 (batch, head) pairs")
    kv = s_k if kv_len is None else int(kv_len)
    if not 0 <= kv <= s_k:
        raise ValueError(f"{what}: kv_len {kv} outside [0, {s_k}]")
    for x in (q, k, v):
        if x.device != q.device or not on_card(x):
            raise ValueError(f"{what}: CUDA tensors on one device required")
        if x.dtype != q.dtype:
            raise ValueError(f"{what}: q, k and v must share a dtype")
    float_code(q, what)
    scale = d ** -0.5 if scale is None else float(scale)
    return _OP(q, k, v, bool(causal), int(window or 0), scale, kv)


torch.library.define(
    "repro_torch::flash_attention",
    "(Tensor q, Tensor k, Tensor v, bool causal, int window, float scale, "
    "int kv_len) -> Tensor")
_OP = torch.ops.repro_torch.flash_attention.default


@torch.library.impl("repro_torch::flash_attention", "CUDA")
def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
            window: int, scale: float, kv_len: int) -> torch.Tensor:
    """The launch, on inputs :func:`flash_attention_kernel` checked."""
    what = "flash_attention"
    b, h, s_q, d = q.shape
    kh, s_k = k.shape[1], k.shape[2]
    code = float_code(q, what)
    q, k, v = (aligned16(x) for x in (q, k, v))
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    block_q, block_k = tiles(d)
    rc = _lib.lib().mapsdi_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), b, h, kh,
        s_q, s_k, d, kv_len, int(causal), window, scale, block_q,
        block_k, code, q.device.index or 0,
        torch.cuda.current_stream(q.device).cuda_stream)
    _lib.check(rc, what)
    count_launch(what)
    return o


@torch.library.register_fake("repro_torch::flash_attention")
def _fake(q, k, v, causal, window, scale, kv_len):
    return torch.empty_like(q)


@register_flop_formula(_OP.overloadpacket)
def _flops(q_shape, k_shape, v_shape, causal, window, scale, kv_len, *,
           out_shape=None, **kwargs) -> int:
    b, h, s_q, d = q_shape
    return work.flops(work.attention_work(
        b, h, k_shape[1], s_q, k_shape[2], d, causal, window or None,
        kv_len))
