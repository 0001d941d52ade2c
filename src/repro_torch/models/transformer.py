"""Dense GQA transformer family (internlm2 / qwen3 / gemma3 / mistral /
the internvl2 text backbone).

Parameters are stacked over layers as in the JAX package; the port runs
the layers as a Python loop, so each layer's sliding window
(:func:`layer_windows`: gemma3's 5 local : 1 global pattern) is a Python
int. The full-sequence attention of :func:`apply` therefore takes the
flash kernel (``kernels/flash_attention``: the CUDA kernel on the card,
its plain version on the CPU), the reference's ``use_pallas=True`` route
for a static window; where the reference scans a traced window, it
computes the same function with its blockwise path. gemma3's local
layers take :func:`~.layers.banded_local_attention` (plain PyTorch, as
in the reference) where :func:`_banded_ok` holds, in the period
structure of the reference's ``scan_layers_banded``.

``apply(..., train=True)`` is the training route, the one the
reference's differentiated scan takes: the full-sequence attention runs
the blockwise path (the flash kernel has no backward), and each layer
runs under ``cfg.remat`` (:func:`~.layers.remat`).

``prefill`` and ``decode_step`` run every layer against its slice of the
KV cache with the reference's ``use_pallas=False``: the blockwise path
for a prefill, the dense decode path for a step; they launch no kernel.
The cache's ``index`` is a 0-d device tensor and ``decode_step`` updates
the cache in place.

The MoE family reuses this module's layer loops with its own
feed-forward block (``ffn``).

Every entry point takes the reference's ``ctx`` (``layers.ShardCtx``)
and places activations at the reference's seven ``constrain`` sites;
``ctx=None`` changes nothing.
"""
from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import torch

from .layers import (Params, ShardCtx, attention, attn_out, attn_qkv,
                     attn_specs, banded_local_attention, cache_update,
                     cache_zeros,
                     constrain, embed, embed_specs, kv_cache_specs,
                     layer_params, mlp, mlp_specs, norm_specs, remat,
                     rms_norm, shard_scope, stack_specs, unembed, unstack)

#: the feed-forward half of a layer: (layer params, normed x, ctx) -> delta
FFN = Callable[[Params, torch.Tensor, Optional[ShardCtx]], torch.Tensor]


def dense_ffn(p: Params, h: torch.Tensor,
              ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    return mlp(p["mlp"], h, ctx)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def layer_specs(cfg) -> Params:
    return {
        "attn": attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                           cfg.d_head, qk_norm=cfg.qk_norm),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff),
        "ln_attn": norm_specs(cfg.d_model),
        "ln_mlp": norm_specs(cfg.d_model),
    }


def param_specs(cfg) -> Params:
    return {
        "embed": embed_specs(cfg.vocab_padded, cfg.d_model,
                             tied=cfg.tied_embeddings),
        "layers": stack_specs(layer_specs(cfg), cfg.n_layers),
        "ln_f": norm_specs(cfg.d_model),
    }


def layer_windows(cfg) -> List[int]:
    """Per-layer sliding-window widths (0 = full/global attention).

    gemma3 pattern: every (local_global+1)-th layer is global, the rest use
    ``window_size`` — layers i with (i+1) % (local_global+1) == 0 global."""
    if not cfg.local_global:
        return [0] * cfg.n_layers
    period = cfg.local_global + 1
    return [0 if (i + 1) % period == 0 else cfg.window_size
            for i in range(cfg.n_layers)]


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------

def layer_fwd(cfg, p: Params, x: torch.Tensor, positions: torch.Tensor,
              window: int, ffn: FFN = dense_ffn, train: bool = False,
              ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Full-sequence causal layer: attention on the flash kernel's route,
    or with ``train`` on the blockwise path."""
    h = rms_norm(x, p["ln_attn"])
    q, k, v = attn_qkv(p["attn"], h, positions, rope_theta=cfg.rope_theta,
                       ctx=ctx)
    o = attention(q, k, v, causal=True, window=window,
                  use_pallas=not train)
    x = x + attn_out(p["attn"], o, ctx)
    x = x + ffn(p, rms_norm(x, p["ln_mlp"]), ctx)
    return constrain(ctx, x, "batch", "seq_sp", "embed")


def _banded_ok(cfg, seq_len: int) -> bool:
    if not (cfg.local_global and cfg.banded_local and cfg.window_size):
        return False
    if cfg.seq_shard_activations:      # banded reshapes the seq dim
        return False
    block = max(cfg.window_size, min(1024, seq_len))
    return seq_len % block == 0 and seq_len > cfg.window_size


def _local_layer_fwd(cfg, p: Params, x: torch.Tensor,
                     positions: torch.Tensor,
                     ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Local layer on the static-window banded path (computes only the
    band)."""
    h = rms_norm(x, p["ln_attn"])
    q, k, v = attn_qkv(p["attn"], h, positions, rope_theta=cfg.rope_theta,
                       ctx=ctx)
    block = max(cfg.window_size, min(1024, q.shape[2]))
    o = banded_local_attention(q, k, v, window=cfg.window_size, block=block)
    x = x + attn_out(p["attn"], o, ctx)
    x = x + mlp(p["mlp"], rms_norm(x, p["ln_mlp"]), ctx)
    return constrain(ctx, x, "batch", "seq_sp", "embed")


def run_layers(cfg, layers: Params, x: torch.Tensor,
               positions: torch.Tensor, ffn: FFN = dense_ffn,
               banded: bool = False, train: bool = False,
               ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Every layer of the stack in order. With ``banded`` (the reference's
    ``scan_layers_banded``): each period of ``local_global`` local layers
    and one global layer runs its local layers banded and its global
    layer on the flash route with window 0; the trailing local layers of
    a partial period (gemma3: 34 = 5·6 + 4) run banded too. With
    ``train``: the blockwise path in place of the flash route, every
    layer under ``cfg.remat``."""
    windows = layer_windows(cfg)
    for p, window in zip(unstack(layers, len(windows)), windows):
        if banded and window:
            def body(p, x):
                return _local_layer_fwd(cfg, p, x, positions, ctx)
        else:
            def body(p, x, window=window):
                return layer_fwd(cfg, p, x, positions, window, ffn, train,
                                 ctx)
        x = remat(cfg, body, train)(p, x)
    return x


# ---------------------------------------------------------------------------
# train / prefill / decode
# ---------------------------------------------------------------------------

def _embed(params: Params, tokens: torch.Tensor,
           inputs_embeds: Optional[torch.Tensor],
           ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    x = embed(params["embed"], tokens, ctx)
    if inputs_embeds is not None:
        x = torch.cat([inputs_embeds.to(x.dtype), x], dim=1)
    return x


def apply(cfg, params: Params, tokens: torch.Tensor,
          inputs_embeds: Optional[torch.Tensor] = None,
          train: bool = False,
          ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """tokens [B,S] -> logits [B,S,V_padded]. ``inputs_embeds`` (vlm) is
    prepended before the token embeddings; ``train`` takes the training
    route."""
    with shard_scope(ctx):
        x = _embed(params, tokens, inputs_embeds, ctx)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = constrain(ctx, x, "batch", "seq_sp", "embed")
        x = run_layers(cfg, params["layers"], x, positions,
                       banded=_banded_ok(cfg, x.shape[1]), train=train,
                       ctx=ctx)
        x = rms_norm(x, params["ln_f"])
        return unembed(params["embed"], x, ctx)


def cache_specs(cfg, batch: int, max_len: int) -> Params:
    return kv_cache_specs(cfg.n_layers, batch, cfg.n_kv_heads, max_len,
                          cfg.d_head)


def _decode_layer(cfg, p: Params, ck: torch.Tensor, cv: torch.Tensor,
                  x: torch.Tensor, positions: torch.Tensor, index, kv_len,
                  window: int, ffn: FFN, ctx: Optional[ShardCtx] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One layer against one layer's cache slice (written in place);
    returns (x, ck, cv)."""
    h = rms_norm(x, p["ln_attn"])
    q, k, v = attn_qkv(p["attn"], h, positions, rope_theta=cfg.rope_theta,
                       ctx=ctx)
    ck, cv = cache_update(ck, cv, k, v, index)
    ck = constrain(ctx, ck, "batch", "kv_heads", "kv_seq", "head_dim")
    cv = constrain(ctx, cv, "batch", "kv_heads", "kv_seq", "head_dim")
    o = attention(q, ck, cv, causal=True, window=window, kv_len=kv_len,
                  use_pallas=False)
    x = x + attn_out(p["attn"], o, ctx)
    x = x + ffn(p, rms_norm(x, p["ln_mlp"]), ctx)
    return constrain(ctx, x, "batch", "seq", "embed"), ck, cv


def run_cached(cfg, params: Params, cache: Params, x: torch.Tensor,
               positions: torch.Tensor, index, kv_len,
               ffn: FFN = dense_ffn,
               ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """Every layer against its cache slice, in place."""
    for i, window in enumerate(layer_windows(cfg)):
        x, _, _ = _decode_layer(cfg, layer_params(params["layers"], i),
                                cache["k"][i], cache["v"][i], x, positions,
                                index, kv_len, window, ffn, ctx)
    return x


def prefill(cfg, params: Params, tokens: torch.Tensor,
            inputs_embeds: Optional[torch.Tensor] = None,
            ffn: FFN = dense_ffn,
            ctx: Optional[ShardCtx] = None) -> Tuple[torch.Tensor, Params]:
    """Forward that fills the KV cache; returns (last-position logits
    [B,1,V], cache of max_len = the prompt's length)."""
    with shard_scope(ctx):
        x = _embed(params, tokens, inputs_embeds, ctx)
        b, s = x.shape[:2]
        dev = x.device
        kv = kv_cache_specs(cfg.n_layers, b, cfg.n_kv_heads, s,
                            cfg.d_head)["k"]
        cache = {"k": cache_zeros(ctx, kv, dev),
                 "v": cache_zeros(ctx, kv, dev)}
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        positions = torch.arange(s, device=dev)[None, :]
        x = constrain(ctx, x, "batch", "seq_sp", "embed")
        x = run_cached(cfg, params, cache, x, positions, zero, s, ffn, ctx)
        x = rms_norm(x[:, -1:], params["ln_f"])
        cache["index"] = zero + s
        return unembed(params["embed"], x, ctx), cache


def decode_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
                ffn: FFN = dense_ffn, ctx: Optional[ShardCtx] = None
                ) -> Tuple[torch.Tensor, Params]:
    """tokens [B,1] + cache -> (logits [B,1,V], the cache one position
    longer)."""
    with shard_scope(ctx):
        index = cache["index"]
        positions = index + torch.zeros_like(tokens)
        x = embed(params["embed"], tokens, ctx)
        x = run_cached(cfg, params, cache, x, positions, index,
                       index + tokens.shape[1], ffn, ctx)
        x = rms_norm(x, params["ln_f"])
        return unembed(params["embed"], x, ctx), {
            "k": cache["k"], "v": cache["v"],      # updated in place
            "index": index + tokens.shape[1]}
