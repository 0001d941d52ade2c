"""The language models' loss and train step.

Two losses with the reference's semantics (mean next-token
cross-entropy; the VLM's logits sliced to the text; the MoE's ``+ 0.0``):

* :func:`make_loss_fn` — the forward-only loss, under
  ``torch.inference_mode()``: the models' forward route, with the flash
  and recurrence kernels on the card;
* :func:`make_grad_loss_fn` — the differentiable loss: the models'
  training route (``apply(..., train=True)``: blockwise attention and
  ``cfg.remat``, as the reference's differentiated scans take them).

:func:`make_train_step` differentiates the second: microbatches split
along the batch axis, gradients accumulated in ``accum_dtype``, an
optional ``grad_compress`` hook, then the optimizer. The kernels have no
backward, as the reference's Pallas kernels have none: on the card the
rwkv6 and mamba2 recurrences refuse inputs that require grad, so those
two families' train step raises there.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.models import get_model
from repro_torch.models.layers import softmax_xent

from .optimizer import (Optimizer, make_optimizer, tree_from_leaves,
                        tree_leaves, tree_map)

Batch = Dict[str, torch.Tensor]


def _loss(cfg, model, params, batch: Batch, train: bool) -> torch.Tensor:
    kwargs = {}
    if cfg.family == "vlm":
        kwargs["patches"] = batch["patches"]
    if cfg.family == "encdec":
        kwargs["frames"] = batch["frames"]
    logits = model.apply(cfg, params, batch["tokens"], train=train,
                         **kwargs)
    if cfg.family == "vlm":  # logits cover patches + text
        logits = logits[:, cfg.n_prepend:]
    loss = softmax_xent(logits, batch["labels"], batch.get("loss_mask"),
                        cfg.vocab_size)
    if cfg.family == "moe":
        # the reference adds no router penalty either
        # (``moe.aux_load_loss`` is ported, outside the loss)
        loss = loss + 0.0
    return loss


def make_loss_fn(cfg) -> Callable:
    """(params, batch) -> 0-d float32 loss, forward only. Batch keys by
    family: dense/moe/rwkv/hybrid: tokens, labels [B,S] (+ loss_mask);
    vlm: + patches [B,n_prepend,VIT_DIM], labels cover the text only;
    encdec: + frames [B,n_enc_frames,d_model]."""
    model = get_model(cfg.family)

    def loss_fn(params, batch: Batch) -> torch.Tensor:
        with torch.inference_mode():
            return _loss(cfg, model, params, batch, train=False)

    return loss_fn


def make_grad_loss_fn(cfg) -> Callable:
    """(params, batch) -> 0-d float32 loss on the training route, with
    autograd recording (the batch keys of :func:`make_loss_fn`)."""
    model = get_model(cfg.family)

    def loss_fn(params, batch: Batch) -> torch.Tensor:
        return _loss(cfg, model, params, batch, train=True)

    return loss_fn


def value_and_grad(loss_fn, params, batch):
    """(loss, grads): the gradient of ``loss_fn`` with respect to every
    parameter, each in its parameter's dtype (``jax.value_and_grad``)."""
    paths = [p for p, _ in tree_leaves(params)]
    leaves = [x.detach().requires_grad_(True) for _, x in tree_leaves(params)]
    loss = loss_fn(tree_from_leaves(paths, leaves), batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    # a parameter the loss never reads gets zeros, as under JAX
    return loss.detach(), tree_from_leaves(paths, [
        torch.zeros_like(x) if g is None else g
        for x, g in zip(leaves, grads)])


def make_train_step(cfg, *, n_microbatches: int = 1,
                    optimizer: Optional[Optimizer] = None,
                    accum_dtype: torch.dtype = torch.float32,
                    grad_compress: Optional[Callable] = None):
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``. The optimizer state is updated in place (the
    reference's jitted step donates it); the parameters come back as new
    tensors. ``metrics`` = {"loss", "grad_norm"}, 0-d float32 tensors on
    the parameters' device."""
    optimizer = optimizer or make_optimizer(cfg.optimizer)
    loss_fn = make_grad_loss_fn(cfg)

    def train_step(params, opt_state, batch: Batch, step):
        if n_microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            n = n_microbatches
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=accum_dtype, device=p.device), params)
            loss = None
            for i in range(n):
                mb = {k: v.reshape((n, v.shape[0] // n) + v.shape[1:])[i]
                      for k, v in batch.items()}
                mb_loss, g = value_and_grad(loss_fn, params, mb)
                grads = tree_map(lambda a, b: a + b.to(accum_dtype),
                                 grads, g)
                loss = mb_loss if loss is None else loss + mb_loss
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)

        if grad_compress is not None:
            grads, opt_state = grad_compress(grads, opt_state)

        new_params, new_opt, gnorm = optimizer.update(
            grads, opt_state, params, step)
        metrics = {"loss": loss.float(), "grad_norm": gnorm}
        return new_params, new_opt, metrics

    return train_step
