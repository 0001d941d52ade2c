"""Whisper-style encoder-decoder (the ``encdec`` family) — whisper-large-v3.

The conv frontend is a stub, as in the JAX package: the model takes
precomputed frame embeddings [B, n_enc_frames, d_model] (what the two
conv layers would emit). Encoder: non-causal self-attention, GELU MLP,
sinusoidal positions. Decoder: causal self-attention + cross-attention to
the encoder output, learned positions. LayerNorm (with bias) throughout,
MHA (n_kv_heads == n_heads), no rope.

The full-sequence self-attention of the encoder and of the training
decoder runs the flash kernel on the card (``kernels/flash_attention``;
the reference's ``use_pallas=True`` route); cached self-attention and
cross-attention take the plain paths, as the reference hard-codes.
Layers are a Python loop over the stacked ``[L]`` weights. With
``train=True`` (the training route, the one the reference's
differentiated scans take) the full-sequence self-attention runs the
blockwise path and every encoder and decoder layer runs under
``cfg.remat``.

Decode state: per-layer self KV cache (grows, updated in place by
``decode_step``) + per-layer cross K/V (computed once at prefill from the
encoder output); ``index`` is a 0-d device tensor.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.distributed.sharding import ParamSpec

from .layers import (Params, ShardCtx, attention, attn_out, attn_specs,
                     cache_update, cache_zeros, constrain, embed,
                     embed_specs, gelu, kv_cache_specs,
                     layer_norm, layer_params, mlp, mlp_specs, remat,
                     shard_scope, sinusoidal_positions, stack_specs,
                     unembed, unstack)

F32 = torch.float32
#: rows of the learned decoder positions
MAX_DEC_POS = 32768


def _ln(d: int) -> Params:
    return {"w": ParamSpec((d,), ("embed",), F32, "ones"),
            "b": ParamSpec((d,), ("embed",), F32, "zeros")}


def _qkv_noro(p: Params, x: torch.Tensor, ctx: Optional[ShardCtx] = None
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("bsd,dhk->bhsk", x, p["wq"])
    q = constrain(ctx, q, "batch", "heads", "seq", "head_dim")
    k = torch.einsum("bsd,dhk->bhsk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bhsk", x, p["wv"])
    return q, k, v


def _norm(x: torch.Tensor, p: Params) -> torch.Tensor:
    return layer_norm(x, p["w"], p["b"])


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def enc_layer_specs(cfg) -> Params:
    return {"ln_attn": _ln(cfg.d_model),
            "attn": attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                               cfg.d_head),
            "ln_mlp": _ln(cfg.d_model),
            "mlp": mlp_specs(cfg.d_model, cfg.d_ff, gated=False)}


def dec_layer_specs(cfg) -> Params:
    s = enc_layer_specs(cfg)
    s["ln_cross"] = _ln(cfg.d_model)
    s["cross"] = attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                            cfg.d_head)
    return s


def param_specs(cfg) -> Params:
    return {
        "embed": embed_specs(cfg.vocab_padded, cfg.d_model, tied=True),
        "dec_pos": ParamSpec((MAX_DEC_POS, cfg.d_model), (None, "embed"),
                             torch.bfloat16, "normal", 0.01),
        "enc": {"layers": stack_specs(enc_layer_specs(cfg), cfg.n_layers),
                "ln_f": _ln(cfg.d_model)},
        "dec": {"layers": stack_specs(dec_layer_specs(cfg), cfg.n_layers),
                "ln_f": _ln(cfg.d_model)},
    }


# ---------------------------------------------------------------------------
# encoder
# ---------------------------------------------------------------------------

def _enc_layer(p: Params, x: torch.Tensor, train: bool,
               ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    q, k, v = _qkv_noro(p["attn"], _norm(x, p["ln_attn"]), ctx)
    o = attention(q, k, v, causal=False, use_pallas=not train)
    x = x + attn_out(p["attn"], o, ctx)
    x = x + mlp(p["mlp"], _norm(x, p["ln_mlp"]), ctx, act=gelu)
    return constrain(ctx, x, "batch", "seq_sp", "embed")


def encode(cfg, params: Params, frames: torch.Tensor,
           train: bool = False,
           ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """frames [B, n_enc_frames, d_model] (stub frontend output), cast to
    the weights' dtype: bf16 as in the reference (whose encoder runs in
    bf16 only), or float32 for float32 weights."""
    x = frames.to(params["embed"]["embedding"].dtype)
    x = x + sinusoidal_positions(x.shape[1], cfg.d_model,
                                 x.device)[None].to(x.dtype)
    x = constrain(ctx, x, "batch", "seq_sp", "embed")
    layer = remat(cfg, _enc_layer, train)
    for p in unstack(params["enc"]["layers"], cfg.n_layers):
        x = layer(p, x, train, ctx)
    return _norm(x, params["enc"]["ln_f"])


# ---------------------------------------------------------------------------
# decoder
# ---------------------------------------------------------------------------

def _dec_layer(cfg, p: Params, x: torch.Tensor, enc_kv, self_kv, index,
               kv_len, train: bool = False,
               ctx: Optional[ShardCtx] = None):
    """enc_kv = (ek, ev) cross K/V [B,H,Senc,Dh]; self_kv None (full
    causal: the flash kernel, or with ``train`` the blockwise path) or
    (ck, cv) cache slices."""
    q, k, v = _qkv_noro(p["attn"], _norm(x, p["ln_attn"]), ctx)
    if self_kv is None:
        o = attention(q, k, v, causal=True, use_pallas=not train)
        new_self = None
    else:
        ck, cv = cache_update(self_kv[0], self_kv[1], k, v, index)
        ck = constrain(ctx, ck, "batch", "kv_heads", "kv_seq", "head_dim")
        cv = constrain(ctx, cv, "batch", "kv_heads", "kv_seq", "head_dim")
        o = attention(q, ck, cv, causal=True, kv_len=kv_len,
                      use_pallas=False)
        new_self = (ck, cv)
    x = x + attn_out(p["attn"], o, ctx)

    cq = torch.einsum("bsd,dhk->bhsk", _norm(x, p["ln_cross"]),
                      p["cross"]["wq"])
    o = attention(cq, enc_kv[0], enc_kv[1], causal=False, use_pallas=False)
    x = x + attn_out(p["cross"], o, ctx)

    x = x + mlp(p["mlp"], _norm(x, p["ln_mlp"]), ctx, act=gelu)
    return constrain(ctx, x, "batch", "seq", "embed"), new_self


def cross_kv(cfg, params: Params, enc_out: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cross K/V for all decoder layers: [L, B, H, Senc, Dh] each (one
    product batched over the stacked layers)."""
    cross = params["dec"]["layers"]["cross"]
    k = torch.einsum("bsd,ldhk->lbhsk", enc_out, cross["wk"])
    v = torch.einsum("bsd,ldhk->lbhsk", enc_out, cross["wv"])
    return k, v


def decode_train(cfg, params: Params, tokens: torch.Tensor,
                 enc_out: torch.Tensor, train: bool = False,
                 ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    x = embed(params["embed"], tokens, ctx)
    x = x + params["dec_pos"][:x.shape[1]][None].to(x.dtype)
    x = constrain(ctx, x, "batch", "seq_sp", "embed")
    ek, ev = cross_kv(cfg, params, enc_out)

    def body(p, x, k, v):
        return _dec_layer(cfg, p, x, (k, v), None, None, None, train,
                          ctx)[0]

    layer = remat(cfg, body, train)
    for p, k, v in zip(unstack(params["dec"]["layers"], cfg.n_layers),
                       ek.unbind(0), ev.unbind(0)):
        x = layer(p, x, k, v)
    x = _norm(x, params["dec"]["ln_f"])
    return unembed(params["embed"], x, ctx)


def apply(cfg, params: Params, tokens: torch.Tensor,
          frames: Optional[torch.Tensor] = None,
          train: bool = False,
          ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """tokens [B,S], frames [B,n_enc_frames,d_model] -> logits
    [B,S,vocab_padded]; ``train`` takes the training route."""
    if frames is None:
        raise ValueError("enc-dec apply() needs `frames`")
    with shard_scope(ctx):
        return decode_train(cfg, params, tokens,
                            encode(cfg, params, frames, train, ctx), train,
                            ctx)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def cache_specs(cfg, batch: int, max_len: int) -> Params:
    L = cfg.n_layers
    kv = ParamSpec((L, batch, cfg.n_kv_heads, max_len, cfg.d_head),
                   ("layers", "batch", "kv_heads", "kv_seq", "head_dim"),
                   torch.bfloat16, "zeros")
    ckv = ParamSpec((L, batch, cfg.n_kv_heads, cfg.n_enc_frames, cfg.d_head),
                    ("layers", "batch", "kv_heads", None, "head_dim"),
                    torch.bfloat16, "zeros")
    return {"k": kv, "v": kv, "ek": ckv, "ev": ckv,
            "index": ParamSpec((), (), torch.int32, "zeros")}


def _run_decoder(cfg, params: Params, tokens: torch.Tensor, cache, index,
                 ctx: Optional[ShardCtx] = None):
    s = tokens.shape[1]
    x = embed(params["embed"], tokens, ctx)
    pos_ids = torch.clamp(index + torch.arange(s, device=x.device),
                          max=MAX_DEC_POS - 1)
    x = x + params["dec_pos"][pos_ids][None].to(x.dtype)
    kv_len = index + s
    for i in range(cfg.n_layers):
        x, _ = _dec_layer(cfg, layer_params(params["dec"]["layers"], i), x,
                          (cache["ek"][i], cache["ev"][i]),
                          (cache["k"][i], cache["v"][i]), index, kv_len,
                          ctx=ctx)
    x = _norm(x, params["dec"]["ln_f"])
    return unembed(params["embed"], x[:, -1:], ctx)


def prefill(cfg, params: Params, tokens: torch.Tensor,
            frames: Optional[torch.Tensor] = None,
            ctx: Optional[ShardCtx] = None):
    """tokens [B,S], frames -> (last-position logits [B,1,V], cache of
    length S)."""
    if frames is None:
        raise ValueError("enc-dec prefill() needs `frames`")
    b, s = tokens.shape
    dev = tokens.device
    with shard_scope(ctx):
        ek, ev = cross_kv(cfg, params, encode(cfg, params, frames, ctx=ctx))
        kv = kv_cache_specs(cfg.n_layers, b, cfg.n_kv_heads, s,
                            cfg.d_head)["k"]
        index = torch.zeros((), dtype=torch.int32, device=dev)
        cache = {"k": cache_zeros(ctx, kv, dev),
                 "v": cache_zeros(ctx, kv, dev),
                 "ek": ek.to(torch.bfloat16), "ev": ev.to(torch.bfloat16),
                 "index": index}
        logits = _run_decoder(cfg, params, tokens, cache, index, ctx)
        return logits, dict(cache, index=index + s)


def decode_step(cfg, params: Params, cache, tokens: torch.Tensor,
                ctx: Optional[ShardCtx] = None):
    """tokens [B,1] -> (logits [B,1,V], cache one position longer; its
    self K/V are updated in place)."""
    with shard_scope(ctx):
        index = cache["index"]
        logits = _run_decoder(cfg, params, tokens, cache, index, ctx)
        return logits, dict(cache, index=index + tokens.shape[1])
