"""RWKV6 "Finch" (attention-free, data-dependent decay) — rwkv6-7b.

Block = time-mix (WKV6 recurrence over [H, N, N] states) + channel-mix
(token-shift gated MLP). Both mixes use token-shift (previous-token
lerp); the decay ``w`` is data-dependent via a small LoRA. The WKV6
recurrence runs the CUDA kernel on the card (``kernels/rwkv6``).

``apply(..., train=True)`` is the training route: each block under
``cfg.remat``, as the reference's differentiated scan takes it; the
recurrence keeps its dispatcher, whose CUDA kernel has no backward and
refuses inputs that require grad.

Serving: ``prefill`` runs the prompt from zero state and returns the
token-shift and WKV states; ``decode_step`` carries them one token on.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import ParamSpec, spec_tree_map
from repro_torch.kernels.rwkv6 import rwkv6 as wkv6

from .layers import (Params, ShardCtx, constrain, embed, embed_specs,
                     layer_norm, layer_params, remat, shard_scope,
                     stack_specs, unembed, unstack)

F32 = torch.float32


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def _ln_specs(d: int) -> Params:
    return {"w": ParamSpec((d,), ("embed",), F32, "ones"),
            "b": ParamSpec((d,), ("embed",), F32, "zeros")}


def layer_specs(cfg) -> Params:
    d = cfg.d_model
    n = cfg.ssm_head_dim                    # head size (64)
    h = d // n
    lora = 64
    return {
        "ln1": _ln_specs(d), "ln2": _ln_specs(d),
        "tmix": {
            # token-shift lerp ratios per stream
            "mu_r": ParamSpec((d,), ("embed",), F32, "zeros"),
            "mu_k": ParamSpec((d,), ("embed",), F32, "zeros"),
            "mu_v": ParamSpec((d,), ("embed",), F32, "zeros"),
            "mu_w": ParamSpec((d,), ("embed",), F32, "zeros"),
            "mu_g": ParamSpec((d,), ("embed",), F32, "zeros"),
            "w_r": ParamSpec((d, d), ("embed", "heads_flat"),
                              init="scaled"),
            "w_k": ParamSpec((d, d), ("embed", "heads_flat"),
                              init="scaled"),
            "w_v": ParamSpec((d, d), ("embed", "heads_flat"),
                              init="scaled"),
            "w_g": ParamSpec((d, d), ("embed", "heads_flat"),
                              init="scaled"),
            "w_o": ParamSpec((d, d), ("heads_flat", "embed"),
                             init="scaled"),
            # data-dependent decay LoRA (Finch): w = exp(-exp(w0 + B tanh(A x)))
            "decay_a": ParamSpec((d, lora), ("embed", None), init="scaled"),
            "decay_b": ParamSpec((lora, d), (None, "heads_flat"),
                                 init="scaled"),
            "decay_w0": ParamSpec((d,), ("heads_flat",), F32, "zeros"),
            "bonus_u": ParamSpec((h, n), ("heads", "state"), F32, "zeros"),
            "ln_x_w": ParamSpec((d,), ("heads_flat",), F32, "ones"),
            "ln_x_b": ParamSpec((d,), ("heads_flat",), F32, "zeros"),
        },
        "cmix": {
            "mu_k": ParamSpec((d,), ("embed",), F32, "zeros"),
            "mu_r": ParamSpec((d,), ("embed",), F32, "zeros"),
            "w_k": ParamSpec((d, cfg.d_ff), ("embed", "ffn"), init="scaled"),
            "w_v": ParamSpec((cfg.d_ff, d), ("ffn", "embed"), init="scaled"),
            "w_r": ParamSpec((d, d), ("embed", "embed_out"), init="scaled"),
        },
    }


def param_specs(cfg) -> Params:
    return {
        "embed": embed_specs(cfg.vocab_padded, cfg.d_model, tied=False),
        "ln_in": _ln_specs(cfg.d_model),
        "layers": stack_specs(layer_specs(cfg), cfg.n_layers),
        "ln_f": _ln_specs(cfg.d_model),
    }


# ---------------------------------------------------------------------------
# block forward
# ---------------------------------------------------------------------------

def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """Token shift: x[t] -> x[t-1]; position 0 gets ``prev`` (or zeros)."""
    first = (torch.zeros_like(x[:, :1]) if prev is None
             else prev[:, None].to(x.dtype))
    return torch.cat([first, x[:, :-1]], dim=1)


def _lerp(x, xx, mu):
    return x + (xx - x) * mu.to(x.dtype)


def time_mix(cfg, p: Params, x: torch.Tensor, shift_state, wkv_state,
             ctx: Optional[ShardCtx] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, s, d = x.shape
    n = cfg.ssm_head_dim
    h = d // n
    xx = _shift(x, shift_state)
    xr, xk, xv, xw, xg = (_lerp(x, xx, p[f"mu_{c}"]) for c in "rkvwg")
    r = xr @ p["w_r"]
    k = xk @ p["w_k"]
    v = xv @ p["w_v"]
    g = xg @ p["w_g"]
    # Finch data-dependent decay
    dd = torch.tanh(xw @ p["decay_a"]) @ p["decay_b"]
    w = torch.exp(-torch.exp(
        (p["decay_w0"].float() + dd.float()).clamp(-10.0, 5.0)))

    def heads(t):
        return constrain(ctx, t.reshape(b, s, h, n).transpose(1, 2),
                         "batch", "heads", "seq", "state")

    y, wkv_out = wkv6(heads(r), heads(k), heads(v), heads(w.to(x.dtype)),
                      p["bonus_u"], state=wkv_state)
    y = y.transpose(1, 2).reshape(b, s, d)
    y = layer_norm(y, p["ln_x_w"], p["ln_x_b"])   # per-token group norm
    y = y * F.silu(g.float()).to(y.dtype)
    out = constrain(ctx, y @ p["w_o"], "batch", "seq", "embed")
    return out, x[:, -1], wkv_out


def channel_mix(cfg, p: Params, x: torch.Tensor, shift_state,
                ctx: Optional[ShardCtx] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    xx = _shift(x, shift_state)
    xk = _lerp(x, xx, p["mu_k"])
    xr = _lerp(x, xx, p["mu_r"])
    k = xk @ p["w_k"]
    k = torch.square(torch.relu(k.float())).to(x.dtype)
    k = constrain(ctx, k, "batch", "seq", "ffn")
    v = k @ p["w_v"]
    r = torch.sigmoid((xr @ p["w_r"]).float())
    return v * r.to(v.dtype), x[:, -1]


def block_fwd(cfg, p: Params, x, state, ctx: Optional[ShardCtx] = None):
    """state = None (full sequence) or (shift_t [B,D], shift_c [B,D],
    wkv [B,H,N,N])."""
    st, sc, wkv_in = state if state is not None else (None, None, None)
    y, st_out, wkv_out = time_mix(cfg, p["tmix"],
                                  layer_norm(x, p["ln1"]["w"], p["ln1"]["b"]),
                                  st, wkv_in, ctx)
    x = x + y
    y, sc_out = channel_mix(cfg, p["cmix"],
                            layer_norm(x, p["ln2"]["w"], p["ln2"]["b"]), sc,
                            ctx)
    x = constrain(ctx, x + y, "batch", "seq_sp", "embed")
    return x, (st_out, sc_out, wkv_out)


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def _block(cfg, p: Params, x: torch.Tensor,
           ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    return block_fwd(cfg, p, x, None, ctx)[0]


def apply(cfg, params: Params, tokens: torch.Tensor,
          train: bool = False,
          ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """tokens [B,S] -> logits [B,S,vocab_padded]; ``train`` takes the
    training route."""
    with shard_scope(ctx):
        x = embed(params["embed"], tokens, ctx)
        x = layer_norm(x, params["ln_in"]["w"], params["ln_in"]["b"])
        x = constrain(ctx, x, "batch", "seq_sp", "embed")
        block = remat(cfg, _block, train)
        for p in unstack(params["layers"], cfg.n_layers):
            x = block(cfg, p, x, ctx)
        x = layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"])
        return unembed(params["embed"], x, ctx)


def cache_specs(cfg, batch: int, max_len: int) -> Params:
    d = cfg.d_model
    n = cfg.ssm_head_dim
    h = d // n
    L = cfg.n_layers
    return {
        "shift_t": ParamSpec((L, batch, d), ("layers", "batch", "embed"),
                             torch.bfloat16, "zeros"),
        "shift_c": ParamSpec((L, batch, d), ("layers", "batch", "embed"),
                             torch.bfloat16, "zeros"),
        "wkv": ParamSpec((L, batch, h, n, n),
                         ("layers", "batch", "heads", "state", "state"),
                         F32, "zeros"),
        "index": ParamSpec((), (), torch.int32, "zeros"),
    }


def _run_with_state(cfg, params: Params, tokens: torch.Tensor, cache,
                    ctx: Optional[ShardCtx] = None):
    x = embed(params["embed"], tokens, ctx)
    x = layer_norm(x, params["ln_in"]["w"], params["ln_in"]["b"])
    st, sc, wkv = [], [], []
    for i in range(cfg.n_layers):
        x, (st_i, sc_i, wkv_i) = block_fwd(
            cfg, layer_params(params["layers"], i), x,
            (cache["shift_t"][i], cache["shift_c"][i], cache["wkv"][i]),
            ctx)
        st.append(st_i)
        sc.append(sc_i)
        wkv.append(wkv_i)
    x = layer_norm(x, params["ln_f"]["w"], params["ln_f"]["b"])
    logits = unembed(params["embed"], x[:, -1:], ctx)
    return logits, {
        "shift_t": torch.stack(st).to(cache["shift_t"].dtype),
        "shift_c": torch.stack(sc).to(cache["shift_c"].dtype),
        "wkv": torch.stack(wkv),
        "index": cache["index"] + tokens.shape[1]}


def prefill(cfg, params: Params, tokens: torch.Tensor,
            ctx: Optional[ShardCtx] = None):
    """tokens [B,S] -> (last-position logits [B,1,V], recurrent state)."""
    zero = spec_tree_map(
        lambda sp: torch.zeros(sp.shape, dtype=sp.dtype, device=tokens.device),
        cache_specs(cfg, tokens.shape[0], tokens.shape[1]))
    with shard_scope(ctx):
        return _run_with_state(cfg, params, tokens, zero, ctx)


def decode_step(cfg, params: Params, cache, tokens: torch.Tensor,
                ctx: Optional[ShardCtx] = None):
    """tokens [B,1] -> (logits [B,1,V], state one token on)."""
    with shard_scope(ctx):
        return _run_with_state(cfg, params, tokens, cache, ctx)
