"""Optimizers as (init, update) pairs over parameter trees.

* ``adamw`` — float32 first/second moments + float32 master weights (the
  standard mixed-precision recipe; 16 bytes/param of state).
* ``adafactor`` — factored second moment for >=2D tensors (row+col
  accumulators), no momentum, no master copy: O(rows+cols) state.

A parameter tree is nested dicts of tensors, as the models declare it;
the state keeps the JAX package's layout (``{"mu", "nu", "master"}`` and
``{"v": {...}}``) so a checkpoint holds the same leaves. ``update``
updates the state's tensors in place (the reference's jitted step
donates them) and returns new parameter tensors.

On a mesh the parameters, gradients and state are DTensors in the
parameters' placements (gradients already synced to them): the update is
elementwise per shard, the global norm counts each element once (a
replicated leaf once, not once per rank), and Adafactor's row and column
means over a sharded dim are reduced across its ranks.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Iterator, Tuple, Union

import torch

from repro_torch.distributed.sharding import is_dtensor, replica_scope

Step = Union[int, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class Optimizer:
    """update(grads, state, params, step) -> (params, state, grad_norm)."""

    init: Callable[[Any], Any]
    update: Callable[[Any, Any, Any, Step], Tuple[Any, Any, torch.Tensor]]
    name: str = "opt"


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts (and of trees of the same
    structure in ``rest``), keys in sorted order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree, path=()) -> Iterator[Tuple[tuple, Any]]:
    """(key path, leaf) pairs in the order JAX flattens a tree of dicts."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k], path + (k,))
    else:
        yield path, tree


def tree_from_leaves(paths, leaves):
    """The tree of dicts whose leaf at each key path is the matching
    entry of ``leaves`` (the inverse of :func:`tree_leaves`)."""
    tree: dict = {}
    for path, leaf in zip(paths, leaves):
        _set(tree, path, leaf)
    return tree


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value as a plain tensor (a plain one as is)."""
    return x.full_tensor() if is_dtensor(x) else x


def _scope(tree):
    """Where a tree holds DTensors: plain 0-d tensors (the norm, the bias
    corrections) mix with them as replicated values."""
    if any(is_dtensor(x) for _, x in tree_leaves(tree)):
        return replica_scope()
    return contextlib.nullcontext()


def _global_norm(tree) -> torch.Tensor:
    sq = [_whole(torch.sum(torch.square(x.float())))
          for _, x in tree_leaves(tree)]
    return torch.sqrt(sum(sq[1:], sq[0]))


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, each in its
    own dtype; the norm before clipping)."""
    norm = _global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _path_name(path) -> str:
    """A key path as JAX prints it: ``['layers']/['tmix']/['decay_b']``."""
    return "/".join(f"[{k!r}]" for k in path)


def _wd_mask(path) -> bool:
    """No weight decay on norms / biases / 1-D params: substrings of the
    JAX key path's string, so ``decay_b`` (``_b``) and ``ln_x_w``
    (``ln``) get none."""
    name = _path_name(path)
    return not any(s in name for s in ("ln", "norm", "bias", "_b"))


def _t(step: Step, device) -> torch.Tensor:
    """``step + 1`` as a float32 tensor (the reference's ``t``)."""
    return torch.as_tensor(step, device=device).to(torch.float32) + 1.0


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------

def adamw(lr: float = 3e-4, b1: float = 0.9, b2: float = 0.95,
          eps: float = 1e-8, weight_decay: float = 0.1,
          clip_norm: float = 1.0) -> Optimizer:
    def init(params):
        return {
            "mu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "nu": tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                           params),
            "master": tree_map(lambda p: p.to(torch.float32, copy=True),
                               params),
        }

    def update(grads, state, params, step):
        with _scope(grads):
            return _update(grads, state, params, step)

    def _update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        t = _t(step, gnorm.device)
        c1 = 1.0 - torch.tensor(b1, device=t.device) ** t
        c2 = 1.0 - torch.tensor(b2, device=t.device) ** t
        new_params = {}
        for path, g in tree_leaves(grads):
            m, v, w = (_at(state[k], path) for k in ("mu", "nu", "master"))
            gf = g.float()
            # the reference's arithmetic, with a leaf-sized temporary or
            # two rather than one per operation
            m.mul_(b1).add_(gf, alpha=1 - b1)
            v.mul_(b2).addcmul_(gf, gf, value=1 - b2)
            upd = torch.div(m, c1).div_(torch.div(v, c2).sqrt_().add_(eps))
            if weight_decay and _wd_mask(path):
                upd.add_(w, alpha=weight_decay)
            w.sub_(upd.mul_(lr))
            _set(new_params, path,
                 w.to(_at(params, path).dtype, copy=True))
        return new_params, state, gnorm

    return Optimizer(init, update, "adamw")


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def _set(tree, path, value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


# ---------------------------------------------------------------------------
# Adafactor (factored second moment, no momentum, no master)
# ---------------------------------------------------------------------------

def adafactor(lr: float = 1e-3, decay: float = 0.8, eps: float = 1e-30,
              clip_norm: float = 1.0, weight_decay: float = 0.0
              ) -> Optimizer:
    def _factored(shape) -> bool:
        return len(shape) >= 2

    def init(params):
        def per(p):
            if _factored(p.shape):
                return {"vr": _zeros_without(p, p.dim() - 1),
                        "vc": _zeros_without(p, p.dim() - 2)}
            return {"v": torch.zeros_like(p, dtype=torch.float32)}
        return {"v": tree_map(per, params)}

    def update(grads, state, params, step):
        with _scope(grads):
            return _update(grads, state, params, step)

    def _update(grads, state, params, step):
        grads, gnorm = clip_by_global_norm(grads, clip_norm)
        t = _t(step, gnorm.device)
        beta = 1.0 - t ** (-decay)
        new_params = {}
        for path, g in tree_leaves(grads):
            w, v = _at(params, path), _at(state["v"], path)
            gf = g.float()
            g2 = torch.square(gf) + eps
            if _factored(g.shape):
                v["vr"].mul_(beta).add_((1 - beta) * g2.mean(dim=-1))
                v["vc"].mul_(beta).add_((1 - beta) * g2.mean(dim=-2))
                vr, vc = v["vr"], v["vc"]
                denom = (vr[..., None] * vc[..., None, :]
                         / torch.clamp(vr.mean(dim=-1)[..., None, None],
                                       min=eps))
                upd = gf * torch.rsqrt(torch.clamp(denom, min=eps))
            else:
                v["v"].mul_(beta).add_((1 - beta) * g2)
                upd = gf * torch.rsqrt(torch.clamp(v["v"], min=eps))
            # relative-scale update clipping (Adafactor d=1)
            rms = torch.sqrt(torch.mean(torch.square(upd)))
            upd = upd / torch.clamp(rms, min=1.0)
            wf = w.float()
            if weight_decay and _wd_mask(path):
                upd = upd + weight_decay * wf
            _set(new_params, path, (wf - lr * upd).to(w.dtype))
        return new_params, state, gnorm

    return Optimizer(init, update, "adafactor")


def _zeros_without(p: torch.Tensor, dim: int) -> torch.Tensor:
    """float32 zeros of ``p``'s shape without ``dim``; on a mesh placed as
    ``p`` is, a shard of ``dim`` becoming a replica."""
    shape = p.shape[:dim] + p.shape[dim + 1:]
    if not is_dtensor(p):
        return torch.zeros(shape, dtype=torch.float32, device=p.device)
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor import zeros as dzeros
    places = [Replicate() if q.is_shard() and q.dim == dim
              else Shard(q.dim - 1) if q.is_shard() and q.dim > dim else q
              for q in p.placements]
    return dzeros(shape, dtype=torch.float32, device_mesh=p.device_mesh,
                  placements=places)


def make_optimizer(name: str, lr: float = 3e-4) -> Optimizer:
    if name == "adamw":
        return adamw(lr=lr)
    if name == "adafactor":
        return adafactor(lr=lr)
    raise KeyError(f"unknown optimizer {name!r}")
