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

On a mesh (``ctx``, a ``layers.ShardCtx``) the parameters are DTensors
placed by the rule table and each rank passes its shard of the global
batch (:func:`local_batch`): the step is the reference's GSPMD step.
The loss is the **global** masked mean over the whole batch, the
gradients are synced to the parameters' placements (an all-reduce over
the replicating axes, a reduce-scatter onto FSDP shards) before the
hook and the optimizer, and every rank ends the step with the same
parameters. Microbatches split each rank's shard, not the global batch.

:func:`with_error_feedback` is the reference's pod-decoupled step: no
``ctx``, replicated plain parameters in every rank and its batch shard;
the hook owns the whole sync, so the result is the mean of per-rank
means (not the global masked mean of the GSPMD step).
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from repro_torch.models import get_model
from repro_torch.distributed.sharding import is_dtensor, replica_scope
from repro_torch.models.layers import ShardCtx, softmax_xent

from .optimizer import (Optimizer, make_optimizer, tree_from_leaves,
                        tree_leaves, tree_map)

Batch = Dict[str, torch.Tensor]


def local_batch(ctx: ShardCtx, batch: Batch) -> Batch:
    """This rank's shard of a global batch: its rows of the batch axis
    (the rows ``auto_rules``' batch axes give it), every other dim
    whole."""
    n, index = 1, 0
    for a in _batch_axes(ctx):
        n *= ctx.mesh.shape[a]
        index = index * ctx.mesh.shape[a] + ctx.mesh.coords[a]
    return {k: v.chunk(n, dim=0)[index] for k, v in batch.items()}


def _shard_batch(ctx: Optional[ShardCtx], batch: Batch) -> Batch:
    """Each rank's batch shard as a DTensor laid out by the rule table
    (batch rows over the batch axes, every other dim replicated)."""
    if ctx is None:
        return batch
    from torch.distributed.tensor import DTensor
    from repro_torch.distributed.sharding import logical_sharding
    out = {}
    for k, v in batch.items():
        sharding = logical_sharding(ctx.mesh, ctx.rules, "batch",
                                    *([None] * (v.dim() - 1)))
        out[k] = DTensor.from_local(v, ctx.mesh.device_mesh,
                                    sharding.placements, run_check=False)
    return out


def _gathered(ctx: ShardCtx, params):
    """The parameters whole over the batch's mesh axes, each gathered
    once a step where the rules shard it there (FSDP), its gradient
    reduce-scattered back onto its shard by the backward; without this
    every op that meets an FSDP shard gathers it again (the embedding in
    the lookup and the logits, each layer again in the recompute)."""
    from torch.distributed.tensor import Replicate
    axes = _batch_axes(ctx)
    on = [i for i, a in enumerate(ctx.mesh.axis_names) if a in axes]

    def whole(p):
        if not is_dtensor(p) or not any(p.placements[i].is_shard()
                                        for i in on):
            return p
        return p.redistribute(p.device_mesh, [
            Replicate() if i in on else q
            for i, q in enumerate(p.placements)])

    return tree_map(whole, params)


def _batch_axes(ctx: ShardCtx):
    """The mesh axes the rules shard the batch over."""
    spec = ctx.rules.spec_for(("batch",))
    if not spec or spec[0] is None:
        return ()
    return (spec[0],) if isinstance(spec[0], str) else tuple(spec[0])


def _loss(cfg, model, params, batch: Batch, train: bool,
          ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    batch = _shard_batch(ctx, batch)
    if ctx is not None:
        params = _gathered(ctx, params)
    kwargs = {}
    if cfg.family == "vlm":
        kwargs["patches"] = batch["patches"]
    if cfg.family == "encdec":
        kwargs["frames"] = batch["frames"]
    if ctx is not None:
        kwargs["ctx"] = ctx
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


def make_loss_fn(cfg, ctx: Optional[ShardCtx] = None) -> Callable:
    """(params, batch) -> 0-d float32 loss, forward only. Batch keys by
    family: dense/moe/rwkv/hybrid: tokens, labels [B,S] (+ loss_mask);
    vlm: + patches [B,n_prepend,VIT_DIM], labels cover the text only;
    encdec: + frames [B,n_enc_frames,d_model]."""
    model = get_model(cfg.family)

    def loss_fn(params, batch: Batch) -> torch.Tensor:
        with torch.inference_mode():
            return _loss(cfg, model, params, batch, False, ctx)

    return loss_fn


def make_grad_loss_fn(cfg, ctx: Optional[ShardCtx] = None) -> Callable:
    """(params, batch) -> 0-d float32 loss on the training route, with
    autograd recording (the batch keys of :func:`make_loss_fn`)."""
    model = get_model(cfg.family)

    def loss_fn(params, batch: Batch) -> torch.Tensor:
        return _loss(cfg, model, params, batch, True, ctx)

    return loss_fn


def _synced(g: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A DTensor gradient in its parameter's placements (the data-axis
    all-reduce, or the reduce-scatter onto an FSDP shard)."""
    if is_dtensor(g):
        return g.redistribute(x.device_mesh, x.placements)
    return g


def value_and_grad(loss_fn, params, batch):
    """(loss, grads): the gradient of ``loss_fn`` with respect to every
    parameter, each in its parameter's dtype (``jax.value_and_grad``); on
    a mesh the loss is a plain 0-d tensor and each gradient a DTensor in
    its parameter's placements."""
    paths = [p for p, _ in tree_leaves(params)]
    leaves = [x.detach().requires_grad_(True) for _, x in tree_leaves(params)]
    loss = loss_fn(tree_from_leaves(paths, leaves), batch)
    # the backward recomputes remat'ed layers: on a mesh, under the
    # forward's rule that plain tensors mixing with DTensors are replicas
    with replica_scope() if is_dtensor(loss) else contextlib.nullcontext():
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    loss = loss.detach()
    # a parameter the loss never reads gets zeros, as under JAX
    return (loss.full_tensor() if is_dtensor(loss) else loss), \
        tree_from_leaves(paths, [
            torch.zeros_like(x) if g is None else _synced(g, x)
            for x, g in zip(leaves, grads)])


def make_train_step(cfg, *, n_microbatches: int = 1,
                    optimizer: Optional[Optimizer] = None,
                    ctx: Optional[ShardCtx] = None,
                    accum_dtype: torch.dtype = torch.float32,
                    grad_compress: Optional[Callable] = None):
    """Returns ``train_step(params, opt_state, batch, step) -> (params,
    opt_state, metrics)``. The optimizer state is updated in place (the
    reference's jitted step donates it); the parameters come back as new
    tensors. ``metrics`` = {"loss", "grad_norm"}, 0-d float32 tensors on
    the parameters' device. With ``ctx`` the batch is this rank's shard
    (:func:`local_batch`)."""
    optimizer = optimizer or make_optimizer(cfg.optimizer)
    loss_fn = make_grad_loss_fn(cfg, ctx)

    def train_step(params, opt_state, batch: Batch, step):
        if n_microbatches == 1:
            loss, grads = value_and_grad(loss_fn, params, batch)
        else:
            n = n_microbatches
            grads = tree_map(lambda p: torch.zeros_like(
                p, dtype=accum_dtype), params)
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


# ---------------------------------------------------------------------------
# error feedback (the pod-decoupled step)
# ---------------------------------------------------------------------------

def with_error_feedback(optimizer: Optimizer, n_inner: int,
                        pod_axis: str = "pod", inner_axis: str = "data",
                        *, mesh):
    """Wrap an optimizer + build the ``grad_compress`` hook for the
    hierarchical compressed gradient sync (reduce-scatter over
    ``inner_axis`` -> int8+EF quantize -> sum over ``pod_axis`` ->
    all-gather) on ``mesh``. The optimizer state becomes ``{"opt": ...,
    "ef": ...}`` with EF buffers on the reduce-scattered shard (each
    rank's own). The step runs in every rank with replicated plain
    parameters and the rank's batch shard, no ``ctx``: the hook owns the
    whole sync. Requires replicated, non-FSDP params."""
    from repro_torch.train.grad_compress import (
        hierarchical_compress_allreduce, init_scattered_error_buffers)
    if int(mesh.shape[inner_axis]) != n_inner:
        raise ValueError(f"n_inner={n_inner} but the mesh's {inner_axis!r} "
                         f"axis has {mesh.shape[inner_axis]} ranks")

    def init(params):
        return {"opt": optimizer.init(params),
                "ef": init_scattered_error_buffers(params, n_inner)}

    def update(grads, state, params, step):
        new_params, new_opt, gnorm = optimizer.update(
            grads, state["opt"], params, step)
        return new_params, dict(state, opt=new_opt), gnorm

    def hook(grads, opt_state):
        new_g, new_ef = hierarchical_compress_allreduce(
            grads, opt_state["ef"], mesh=mesh, pod_axis=pod_axis,
            inner_axis=inner_axis)
        return new_g, dict(opt_state, ef=new_ef)

    return Optimizer(init, update, optimizer.name + "+ef"), hook
