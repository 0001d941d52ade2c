"""Serving entry points: prefill + single-token serve step per family.

The cache layout (KV caches for attention, recurrent states for rwkv and
hybrid) is owned by the family module (``cache_specs``). Everything runs
under ``torch.inference_mode()`` (the kernels have no backward), or on a
mesh under ``torch.no_grad()`` (a DTensor made outside inference mode
cannot be viewed inside it); a serve step updates the attention caches
it is given in place.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.models import get_model
from repro_torch.models.layers import ShardCtx


def _no_grad(ctx: Optional[ShardCtx]):
    return torch.inference_mode() if ctx is None else torch.no_grad()


def make_prefill(cfg, ctx: Optional[ShardCtx] = None) -> Callable:
    """(params, batch) -> (last-position logits, cache). Batch: tokens
    [B, S] (+ patches / frames for vlm / encdec). On a mesh (``ctx``) the
    parameters and the batch are DTensors placed by ``ctx.rules``."""
    model = get_model(cfg.family)

    def prefill(params, batch):
        kwargs = {}
        if cfg.family == "vlm":
            kwargs["patches"] = batch["patches"]
        if cfg.family == "encdec":
            kwargs["frames"] = batch["frames"]
        with _no_grad(ctx):
            return model.prefill(cfg, params, batch["tokens"], ctx=ctx,
                                 **kwargs)

    return prefill


def make_serve_step(cfg, ctx: Optional[ShardCtx] = None) -> Callable:
    """(params, cache, tokens [B,1]) -> (logits [B,1,V], cache); on a
    mesh as :func:`make_prefill`."""
    model = get_model(cfg.family)

    def serve_step(params, cache, tokens):
        with _no_grad(ctx):
            return model.decode_step(cfg, params, cache, tokens, ctx=ctx)

    return serve_step


def grow_cache(cache, n_new: int):
    """The prefill cache with ``n_new`` more positions in its attention
    K/V (zeros; the caches' ``kv_len`` masks them until written)."""
    if "k" in cache and cache["k"].dim() >= 4:
        pad = [0, 0] * cache["k"].dim()
        pad[3] = n_new                      # the sequence axis, dim -2
        cache = dict(cache, k=F.pad(cache["k"], pad),
                     v=F.pad(cache["v"], pad))
    return cache


def greedy_generate(cfg, params, batch: Dict[str, torch.Tensor],
                    n_new: int) -> torch.Tensor:
    """Prefill + ``n_new`` greedy tokens [B, n_new] (int32). The prefill
    cache holds the prompt; the attention caches grow by ``n_new``
    positions before the first step, as the reference grows them."""
    prefill = make_prefill(cfg)
    step = make_serve_step(cfg)
    with torch.inference_mode():
        logits, cache = prefill(params, batch)
        tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
        out = [tok]
        cache = grow_cache(cache, n_new)
        for _ in range(n_new - 1):
            logits, cache = step(params, cache, tok)
            tok = torch.argmax(logits[:, -1:], dim=-1).to(torch.int32)
            out.append(tok)
        return torch.cat(out, dim=1)
