"""Zamba2 hybrid: Mamba2 (SSD) backbone + a weight-shared attention block.

54 Mamba2 layers in 9 groups of 6; ONE shared transformer block (attn+MLP,
its own parameters reused at every invocation) runs at the start of each
group on ``concat(hidden, original_embedding)`` projected back to d_model.
Mamba2 parameters are stacked [groups, layers per group, ...] as in the
JAX package; the port loops over them. The SSD scan runs the CUDA kernel
on the card (``kernels/mamba2``), and so does the shared block's
full-sequence attention (``kernels/flash_attention``, the reference's
``use_pallas=True`` route). ``apply(..., train=True)`` is the training
route: the shared block's attention on the blockwise path, each Mamba2
layer under ``cfg.remat``, as the reference's differentiated scans take
them; the SSD scan keeps its dispatcher, whose CUDA kernel has no
backward and refuses inputs that require grad.

Serving: ``prefill`` fills the conv/SSD states and the shared block's
per-group KV cache; ``decode_step`` appends one token. The cache's
``index`` is a 0-d device tensor. ``decode_step`` updates the KV cache
in place.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import ParamSpec, spec_tree_map
from repro_torch.kernels.mamba2 import mamba2_ssd

from .layers import (Params, ShardCtx, attention, attn_out, attn_qkv,
                     attn_specs, cache_update, cache_zeros, constrain,
                     embed, embed_specs,
                     layer_params, mlp, mlp_specs, norm_specs, remat,
                     rms_norm, shard_scope, stack_specs, unembed, unstack)

CONV_K = 4
F32 = torch.float32


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _mamba_specs(cfg) -> Params:
    d = cfg.d_model
    di = cfg.d_inner
    n = cfg.ssm_state
    hd = cfg.ssm_head_dim
    h = di // hd
    conv_ch = di + 2 * n
    return {
        "ln": norm_specs(d),
        "in_proj": ParamSpec((d, 2 * di + 2 * n + h),
                             ("embed", "ssm_inner"), init="scaled"),
        "conv_w": ParamSpec((CONV_K, conv_ch), (None, "ssm_inner"), F32,
                            "normal", 0.2),
        "conv_b": ParamSpec((conv_ch,), ("ssm_inner",), F32, "zeros"),
        "a_log": ParamSpec((h,), ("heads",), F32, "zeros"),
        "dt_bias": ParamSpec((h,), ("heads",), F32, "zeros"),
        "d_skip": ParamSpec((h,), ("heads",), F32, "zeros"),
        "norm_w": ParamSpec((di,), ("ssm_inner",), F32, "zeros"),
        "out_proj": ParamSpec((di, d), ("ssm_inner", "embed"),
                              init="scaled"),
    }


def _shared_block_specs(cfg) -> Params:
    d = cfg.d_model
    return {
        "in_proj": ParamSpec((2 * d, d), ("embed_cat", "embed"),
                             init="scaled"),
        "ln_attn": norm_specs(d),
        "attn": attn_specs(d, cfg.n_heads, cfg.n_kv_heads, cfg.d_head),
        "ln_mlp": norm_specs(d),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff),
        "out_proj": ParamSpec((d, d), ("embed", "embed_out"),
                              init="scaled"),
    }


def n_groups(cfg) -> int:
    if cfg.n_layers % cfg.shared_attn_every:
        raise ValueError(f"{cfg.n_layers} layers do not split into groups "
                         f"of {cfg.shared_attn_every}")
    return cfg.n_layers // cfg.shared_attn_every


def param_specs(cfg) -> Params:
    per_group = stack_specs(_mamba_specs(cfg), cfg.shared_attn_every)
    return {
        "embed": embed_specs(cfg.vocab_padded, cfg.d_model, tied=True),
        "shared": _shared_block_specs(cfg),
        "groups": stack_specs(per_group, n_groups(cfg)),
        "ln_f": norm_specs(cfg.d_model),
    }


# ---------------------------------------------------------------------------
# mamba2 block
# ---------------------------------------------------------------------------

def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 conv_state: Optional[torch.Tensor]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv1d. x [B,S,C]; w [K,C]; conv_state [B,K-1,C]
    (trailing inputs of the previous call) or None (zeros). Returns
    (y [B,S,C], new_state [B,K-1,C])."""
    bsz, s, ch = x.shape
    k = w.shape[0]
    prev = (x.new_zeros((bsz, k - 1, ch)) if conv_state is None
            else conv_state.to(x.dtype))
    xp = torch.cat([prev, x], dim=1)                  # [B, S+K-1, C]
    wx = w.to(x.dtype)
    y = xp[:, 0:s] * wx[0]
    for i in range(1, k):
        y = y + xp[:, i:i + s] * wx[i]
    y = y + b.to(x.dtype)
    return y, xp[:, -(k - 1):]


def mamba_block(cfg, p: Params, x: torch.Tensor, state,
                ctx: Optional[ShardCtx] = None
                ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """state = (conv [B,K-1,C], ssd [B,H,N,P]) or (None, None)."""
    bsz, s, d = x.shape
    di, n = cfg.d_inner, cfg.ssm_state
    hd = cfg.ssm_head_dim
    h = di // hd
    conv_in, ssd_in = state

    hin = rms_norm(x, p["ln"])
    zxbcdt = constrain(ctx, hin @ p["in_proj"], "batch", "seq", "ssm_inner")
    z, xbc, dt_raw = torch.split(zxbcdt, [di, di + 2 * n, h], dim=-1)
    xbc, conv_out = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_in)
    xbc = F.silu(xbc.float()).to(x.dtype)
    xs, bmat, cmat = torch.split(xbc, [di, n, n], dim=-1)

    dt = F.softplus(dt_raw.float() + p["dt_bias"][None, None])   # [B,S,H]
    a = -torch.exp(p["a_log"].float())                           # [H]
    xh = xs.reshape(bsz, s, h, hd).transpose(1, 2)               # [B,H,S,P]
    xh = constrain(ctx, xh, "batch", "heads", "seq", "state")
    y, ssd_out = mamba2_ssd(xh, dt.transpose(1, 2), a, bmat, cmat,
                            state=ssd_in)
    # bf16 + f32 promotes to f32, as in the reference: the gate, the norm
    # and out_proj's product run in float32
    y = y + p["d_skip"].float()[None, :, None, None] * xh
    y = y.transpose(1, 2).reshape(bsz, s, di)
    y = rms_norm(y, p["norm_w"]) * F.silu(z.float()).to(y.dtype)
    out = (y @ p["out_proj"].to(y.dtype)).to(x.dtype)
    return (x + constrain(ctx, out, "batch", "seq", "embed"),
            (conv_out, ssd_out))


# ---------------------------------------------------------------------------
# shared attention block
# ---------------------------------------------------------------------------

def shared_block(cfg, p: Params, x: torch.Tensor, x0: torch.Tensor,
                 positions: torch.Tensor, kv=None, index=None, kv_len=None,
                 train: bool = False, ctx: Optional[ShardCtx] = None
                 ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """kv = (ck, cv), one invocation's cache slice, or None for the
    full-sequence form (the flash kernel's path; with ``train`` the
    blockwise path)."""
    cat = torch.cat([x, x0], dim=-1)
    hin = cat @ p["in_proj"]
    hin = rms_norm(hin, p["ln_attn"])
    q, k, v = attn_qkv(p["attn"], hin, positions, rope_theta=cfg.rope_theta,
                       ctx=ctx)
    if kv is None:
        o = attention(q, k, v, causal=True, use_pallas=not train)
        new_kv = None
    else:
        ck, cv = cache_update(kv[0], kv[1], k, v, index)
        ck = constrain(ctx, ck, "batch", "kv_heads", "kv_seq", "head_dim")
        cv = constrain(ctx, cv, "batch", "kv_heads", "kv_seq", "head_dim")
        o = attention(q, ck, cv, causal=True, kv_len=kv_len,
                      use_pallas=False)
        new_kv = (ck, cv)
    hin = hin + attn_out(p["attn"], o, ctx)
    hin = hin + mlp(p["mlp"], rms_norm(hin, p["ln_mlp"]), ctx)
    out = constrain(ctx, hin @ p["out_proj"], "batch", "seq", "embed")
    return x + out, new_kv


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def _mamba_layer(cfg, p: Params, x: torch.Tensor,
                 ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    return mamba_block(cfg, p, x, (None, None), ctx)[0]


def apply(cfg, params: Params, tokens: torch.Tensor,
          train: bool = False,
          ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """tokens [B,S] -> logits [B,S,vocab_padded]; ``train`` takes the
    training route."""
    with shard_scope(ctx):
        x = embed(params["embed"], tokens, ctx)
        x0 = x
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = constrain(ctx, x, "batch", "seq_sp", "embed")
        layer = remat(cfg, _mamba_layer, train)
        for group in unstack(params["groups"], n_groups(cfg)):
            x, _ = shared_block(cfg, params["shared"], x, x0, positions,
                                train=train, ctx=ctx)
            for p in unstack(group, cfg.shared_attn_every):
                x = layer(cfg, p, x, ctx)
        x = rms_norm(x, params["ln_f"])
        return unembed(params["embed"], x, ctx)


def cache_specs(cfg, batch: int, max_len: int) -> Params:
    g = n_groups(cfg)
    e = cfg.shared_attn_every
    di, nst = cfg.d_inner, cfg.ssm_state
    h = di // cfg.ssm_head_dim
    conv_ch = di + 2 * nst
    kv = ParamSpec((g, batch, cfg.n_kv_heads, max_len, cfg.d_head),
                   ("groups", "batch", "kv_heads", "kv_seq", "head_dim"),
                   torch.bfloat16, "zeros")
    return {
        "conv": ParamSpec((g, e, batch, CONV_K - 1, conv_ch),
                          ("groups", "layers", "batch", None, "ssm_inner"),
                          torch.bfloat16, "zeros"),
        "ssd": ParamSpec((g, e, batch, h, nst, cfg.ssm_head_dim),
                         ("groups", "layers", "batch", "heads", "state",
                          "state"), F32, "zeros"),
        "k": kv, "v": kv,
        "x0": ParamSpec((batch, 1, cfg.d_model), ("batch", None, "embed"),
                        torch.bfloat16, "zeros"),
        "index": ParamSpec((), (), torch.int32, "zeros"),
    }


def _run_with_state(cfg, params: Params, tokens: torch.Tensor, cache,
                    ctx: Optional[ShardCtx] = None):
    x = embed(params["embed"], tokens, ctx)
    # the concat-skip takes this call's embedding (the reference's x0)
    x0 = x
    index = cache["index"]
    s = tokens.shape[1]
    positions = index + torch.arange(s, device=x.device)[None, :]
    kv_len = index + s
    conv, ssd = [], []
    for g in range(n_groups(cfg)):
        x, _ = shared_block(cfg, params["shared"], x, x0, positions,
                            (cache["k"][g], cache["v"][g]), index, kv_len,
                            ctx=ctx)
        for i in range(cfg.shared_attn_every):
            conv_in = cache["conv"][g, i]
            x, (cv_out, sd_out) = mamba_block(
                cfg, layer_params(params["groups"], g, i), x,
                (conv_in, cache["ssd"][g, i]), ctx)
            conv.append(cv_out.to(conv_in.dtype))
            ssd.append(sd_out)
    x = rms_norm(x, params["ln_f"])
    logits = unembed(params["embed"], x[:, -1:], ctx)
    shape = (n_groups(cfg), cfg.shared_attn_every)
    return logits, {
        "conv": torch.stack(conv).reshape(shape + conv[0].shape),
        "ssd": torch.stack(ssd).reshape(shape + ssd[0].shape),
        "k": cache["k"], "v": cache["v"],     # updated in place
        "x0": x0[:, -1:].to(torch.bfloat16),
        "index": index + s}


def prefill(cfg, params: Params, tokens: torch.Tensor,
            ctx: Optional[ShardCtx] = None):
    """tokens [B,S] -> (last-position logits [B,1,V], cache of length S)."""
    zero = spec_tree_map(
        lambda sp: cache_zeros(ctx, sp, tokens.device),
        cache_specs(cfg, tokens.shape[0], tokens.shape[1]))
    with shard_scope(ctx):
        return _run_with_state(cfg, params, tokens, zero, ctx)


def decode_step(cfg, params: Params, cache, tokens: torch.Tensor,
                ctx: Optional[ShardCtx] = None):
    """tokens [B,1] -> (logits [B,1,V], cache one position longer)."""
    with shard_scope(ctx):
        return _run_with_state(cfg, params, tokens, cache, ctx)
