"""InternVL2-style VLM: stub ViT frontend + dense LM backbone.

The modality frontend is a stub, as in the JAX package: the caller gives
precomputed patch embeddings [B, n_prepend, VIT_DIM] (what InternViT
would emit after pixel shuffle). This module owns only the MLP projector
and delegates everything else to the dense transformer (``transformer.py``):
the projected patches are prepended to the token embeddings, so
positions run over the patches and then the text, and a decode step
continues from the cache's ``index``, which counts the patches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.sharding import ParamSpec

from . import transformer as tf
from .layers import Params, ShardCtx, constrain, layer_norm, shard_scope

VIT_DIM = 1024


def param_specs(cfg) -> Params:
    base = tf.param_specs(cfg)
    base["projector"] = {
        "ln_w": ParamSpec((VIT_DIM,), (None,), torch.float32, "ones"),
        "ln_b": ParamSpec((VIT_DIM,), (None,), torch.float32, "zeros"),
        "w1": ParamSpec((VIT_DIM, cfg.d_model), (None, "embed"),
                        init="scaled"),
        "b1": ParamSpec((cfg.d_model,), ("embed",), torch.float32, "zeros"),
    }
    return base


def project_patches(p: Params, patches: torch.Tensor,
                    ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """[B, n_prepend, VIT_DIM] -> [B, n_prepend, d_model] (bf16)."""
    h = layer_norm(patches.float(), p["ln_w"], p["ln_b"])
    out = h @ p["w1"].float()
    out = (out + p["b1"][None, None]).to(torch.bfloat16)
    return constrain(ctx, out, "batch", "seq", "embed")


def apply(cfg, params: Params, tokens: torch.Tensor,
          patches: Optional[torch.Tensor] = None,
          train: bool = False,
          ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """tokens [B, S - n_prepend]; patches [B, n_prepend, VIT_DIM].
    Returns logits over ALL positions (the caller masks the patch span);
    ``train`` takes the dense family's training route."""
    if patches is None:
        raise ValueError("vlm apply() needs `patches`")
    with shard_scope(ctx):
        emb = project_patches(params["projector"], patches, ctx)
        return tf.apply(cfg, params, tokens, inputs_embeds=emb, train=train,
                        ctx=ctx)


cache_specs = tf.cache_specs


def prefill(cfg, params: Params, tokens: torch.Tensor,
            patches: Optional[torch.Tensor] = None,
            ctx: Optional[ShardCtx] = None):
    if patches is None:
        raise ValueError("vlm prefill() needs `patches`")
    with shard_scope(ctx):
        emb = project_patches(params["projector"], patches, ctx)
        return tf.prefill(cfg, params, tokens, inputs_embeds=emb, ctx=ctx)


def decode_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
                ctx: Optional[ShardCtx] = None):
    return tf.decode_step(cfg, params, cache, tokens, ctx=ctx)
