"""The loss of the language models: the forward pass and a mean
next-token cross-entropy, run without autograd.

The JAX package's train step differentiates this loss; the port's
kernels have no backward yet, so the gradient step is queued in
ROADMAP.md and ``make_loss_fn`` runs under ``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.models import get_model
from repro_torch.models.layers import softmax_xent

Batch = Dict[str, torch.Tensor]


def make_loss_fn(cfg) -> Callable:
    """(params, batch) -> 0-d float32 loss. Batch keys by family:
    dense/moe/rwkv/hybrid: tokens, labels [B,S] (+ loss_mask);
    vlm: + patches [B,n_prepend,VIT_DIM], labels cover the text only;
    encdec: + frames [B,n_enc_frames,d_model]."""
    model = get_model(cfg.family)

    def loss_fn(params, batch: Batch) -> torch.Tensor:
        kwargs = {}
        if cfg.family == "vlm":
            kwargs["patches"] = batch["patches"]
        if cfg.family == "encdec":
            kwargs["frames"] = batch["frames"]
        with torch.inference_mode():
            logits = model.apply(cfg, params, batch["tokens"], **kwargs)
            if cfg.family == "vlm":  # logits cover patches + text
                logits = logits[:, cfg.n_prepend:]
            loss = softmax_xent(logits, batch["labels"],
                                batch.get("loss_mask"), cfg.vocab_size)
            if cfg.family == "moe":
                # the reference adds no router penalty either
                # (``moe.aux_load_loss`` is ported, outside the loss)
                loss = loss + 0.0
            return loss

    return loss_fn
