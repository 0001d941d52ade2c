"""Mixture-of-experts family (olmoe 64e top-8, kimi-k2 384e top-8).

The dense transformer's attention (``transformer.py``: the flash kernel's
route in the forward, the cached plain paths in prefill and decode) with
a sort-based MoE feed-forward block: the (token, expert) pairs are sorted
by expert into a capacity-bounded [E, C, D] buffer, so the expert
products do only the real work; pairs past an expert's capacity are
dropped, as the reference drops them.

Determinism, which the serving paths need (``greedy_generate`` and the
step-by-step path must give the same tokens on the card):

* top-k takes the larger probability first and, between equal ones, the
  lower expert (``lax.top_k``'s order), by a stable sort;
* pairs are sorted by expert with a stable sort, so within an expert's
  run they keep their pair order (the reference's ``lax.sort`` is stable
  too); that order decides which pairs fall past the capacity;
* the combine adds each token's k weighted expert outputs in bf16 in the
  sorted order (by expert), as the reference's scatter-add does, by a
  gather through the inverse permutation: no atomics.

On a mesh (``ctx``): experts are sharded over the ``model`` axis, and
under FSDP the per-expert ffn dim also over ``data``.
:func:`moe_block_local` (``cfg.moe_impl == "local"``) is the reference's
``shard_map`` dispatch: its two bodies run on each rank's local shards
(``to_local``) with one explicit collective, a bf16 all-reduce over
``model`` per layer, and the expert products between them on DTensors.
The global :func:`moe_block` on a mesh routes the whole batch in every
rank and places its expert buffer by the rule table.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import ParamSpec

from . import transformer as tf
from .layers import (Params, ShardCtx, constrain, embed_specs, local_shard,
                     mlp, mlp_specs, norm_specs, rms_norm, round_up,
                     shard_scope, stack_specs, sum_over, unembed)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def moe_mlp_specs(cfg) -> Params:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    s: Params = {
        "router": ParamSpec((d, e), ("embed", "expert"), torch.float32,
                            "scaled"),
        "w_gate": ParamSpec((e, d, f), ("expert", "embed", "expert_ffn"),
                            init="scaled"),
        "w_up": ParamSpec((e, d, f), ("expert", "embed", "expert_ffn"),
                          init="scaled"),
        "w_down": ParamSpec((e, f, d), ("expert", "expert_ffn", "embed"),
                            init="scaled"),
    }
    if cfg.n_shared_experts:
        s["shared"] = mlp_specs(cfg.d_model,
                                cfg.d_ff * cfg.n_shared_experts)
    return s


def layer_specs(cfg) -> Params:
    base = tf.layer_specs(cfg)
    base["moe"] = moe_mlp_specs(cfg)
    del base["mlp"]
    return base


def param_specs(cfg) -> Params:
    return {
        "embed": embed_specs(cfg.vocab_padded, cfg.d_model,
                             tied=cfg.tied_embeddings),
        "layers": stack_specs(layer_specs(cfg), cfg.n_layers),
        "ln_f": norm_specs(cfg.d_model),
    }


def capacity(cfg, n_tokens: int) -> int:
    per = n_tokens * cfg.top_k / cfg.n_experts
    return max(8, round_up(int(per * cfg.capacity_factor), 8))


# ---------------------------------------------------------------------------
# sort-based dispatch MoE block
# ---------------------------------------------------------------------------

def _router_probs(router: torch.Tensor, xl: torch.Tensor) -> torch.Tensor:
    return torch.softmax(xl.float() @ router, dim=-1)


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(values, indices) of the k largest per row, largest first, the
    lower index first between equal values (``lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route_and_sort(cfg, router: torch.Tensor, xl: torch.Tensor, cap: int):
    """xl [t,d] -> (dest, tok_sorted, w_sorted, order). dest[i] is the
    slot in the flat [E*cap] buffer of the i-th (token, expert) pair
    sorted by expert, or the E*cap sentinel when it is over capacity;
    ``order`` maps sorted positions to pairs (pair = token * k + j)."""
    t = xl.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    weights, sel = _top_k(_router_probs(router, xl), k)            # [t,k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True),
                                    min=1e-9)
    e_sorted, order = torch.sort(sel.reshape(t * k), stable=True)
    ar = torch.arange(t * k, device=xl.device)
    tok_sorted = order // k
    run_start = torch.searchsorted(e_sorted, e_sorted, side="left")
    pos = ar - run_start
    keep = pos < cap
    dest = torch.where(keep, e_sorted * cap + pos, e * cap)
    w_sorted = torch.where(keep, weights.reshape(t * k)[order], 0.0)
    return dest, tok_sorted, w_sorted, order


def _combine_order(order: torch.Tensor, t: int, k: int) -> torch.Tensor:
    """[t, k]: the sorted positions of each token's k pairs, in sorted
    order (the pairs of one token are sorted by expert)."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=order.device)
    return torch.sort(inv.reshape(t, k), dim=1).values


def _dispatch(xf: torch.Tensor, dest: torch.Tensor,
              tok_sorted: torch.Tensor, rows: int) -> torch.Tensor:
    """The [rows, d] expert buffer: row ``dest[i]`` takes token
    ``tok_sorted[i]``; row ``rows`` (the sentinel) takes the dropped
    pairs and is cut off."""
    buf = xf.new_zeros((rows + 1, xf.shape[1]))
    buf[dest] = xf[tok_sorted]
    return buf[:rows]


def _combine(contrib: torch.Tensor, order: torch.Tensor, t: int,
             k: int) -> torch.Tensor:
    """Each token's k contributions added in sorted order, by a gather
    through the inverse permutation (no atomics)."""
    per_tok = contrib[_combine_order(order, t, k)]           # [t,k,d]
    out = per_tok[:, 0]
    for j in range(1, k):
        out = out + per_tok[:, j]
    return out


def _moe_block_plain(cfg, p: Params, x: torch.Tensor,
                     ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    xf = x.reshape(t, d)
    dest, tok_sorted, w_sorted, order = _route_and_sort(cfg, p["router"],
                                                        xf, cap)

    # gather tokens into the [E,C,D] buffer
    buf = _dispatch(xf, dest, tok_sorted, e * cap).reshape(e, cap, d)
    buf = constrain(ctx, buf, "expert", None, "embed")

    # expert compute (real work only)
    gate = torch.bmm(buf, p["w_gate"])
    up = torch.bmm(buf, p["w_up"])
    h = F.silu(gate.float()).to(x.dtype) * up
    h = constrain(ctx, h, "expert", None, "expert_ffn")
    out_buf = torch.bmm(h, p["w_down"])
    if ctx is not None:
        out_buf = local_shard(ctx.replicated(out_buf))
    out_buf = out_buf.reshape(e * cap, d)

    # combine: each token's k weighted outputs, added in bf16 in sorted
    # order (the pairs of one token are sorted by expert)
    contrib = (out_buf[torch.clamp(dest, max=e * cap - 1)]
               * w_sorted[:, None].to(x.dtype))
    out = _combine(contrib, order, t, k)

    if "shared" in p:
        out = out + mlp(p["shared"], xf[None])[0]
    return out.reshape(b, s, d)


def moe_block(cfg, p: Params, x: torch.Tensor,
              ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """x [B,S,D] -> [B,S,D]; top-k routing, capacity C per expert. On a
    mesh with ``cfg.moe_impl == "local"`` and experts sharded over
    ``model``, :func:`moe_block_local` (the reference's condition);
    otherwise every rank routes the whole batch."""
    if (cfg.moe_impl == "local" and ctx is not None
            and _expert_sharded_over_model(ctx)
            and (x.shape[0] * x.shape[1])
            % max(1, _n_batch_shards(ctx)) == 0):
        return moe_block_local(cfg, p, x, ctx)
    if ctx is None:
        return _moe_block_plain(cfg, p, x)
    # routing, dispatch and combine on the whole batch in every rank;
    # the expert buffer is placed by the rule table between them
    params = dict(p, router=local_shard(ctx.replicated(p["router"])))
    if "shared" in p:
        params["shared"] = {n: local_shard(ctx.replicated(w))
                            for n, w in p["shared"].items()}
    out = _moe_block_plain(cfg, params, local_shard(ctx.replicated(x)), ctx)
    return constrain(ctx, out, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# the local dispatch on a mesh (the reference's two shard_map bodies)
# ---------------------------------------------------------------------------

def _batch_mesh_axes(ctx: Optional[ShardCtx]) -> Tuple[str, ...]:
    """Mesh axes the `batch` logical axis maps to (tuple), or ()."""
    if ctx is None:
        return ()
    spec = ctx.rules.spec_for(("batch",))
    if not len(spec) or spec[0] is None:
        return ()
    ax = spec[0]
    return (ax,) if isinstance(ax, str) else tuple(ax)


def _expert_sharded_over_model(ctx: Optional[ShardCtx]) -> bool:
    if ctx is None or "model" not in ctx.mesh.shape:
        return False
    spec = ctx.rules.spec_for(("expert",))
    return len(spec) > 0 and spec[0] == "model"


def _n_batch_shards(ctx: Optional[ShardCtx]) -> int:
    n = 1
    for a in _batch_mesh_axes(ctx):
        n *= ctx.mesh.shape[a]
    return n


def moe_block_local(cfg, p: Params, x: torch.Tensor,
                    ctx: ShardCtx) -> torch.Tensor:
    """The local dispatch: routing never leaves the data shard, the
    expert products are (data x model)-sharded, and the combine is a
    masked float32 accumulation plus ONE bf16 all-reduce over ``model``
    per layer, as the reference's ``shard_map`` bodies.

    The routing is computed in every rank of a data shard (replicated
    over ``model``); the dispatch builds only this rank's expert slice,
    ``E_local*C + 1`` rows with the sentinel last, for the capacity of
    ``t_local`` tokens (one data shard's)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    mesh = ctx.mesh
    dm = mesh.device_mesh
    dn = _batch_mesh_axes(ctx)
    t_local = t // _n_batch_shards(ctx)
    cap = capacity(cfg, t_local)
    e_local = e // mesh.shape["model"]
    e0 = mesh.coords["model"] * e_local

    # the layouts of the bodies' inputs and outputs, per mesh axis: batch
    # rows over `dn`, experts over `model`; a replicated input's gradient
    # is partial over the axes whose ranks each see part of its use
    def places(batch_dim, model_place):
        return [Shard(batch_dim) if a in dn
                else model_place if a == "model" else Replicate()
                for a in mesh.axis_names]

    def grads_of(batch_dim):
        return [Shard(batch_dim) if a in dn
                else Partial() if a == "model" else Replicate()
                for a in mesh.axis_names]

    # --- dispatch body --------------------------------------------------------
    x_in = ctx.constrain(x, "batch", "seq", "embed")
    xl = local_shard(x_in, grads_of(0)).reshape(t_local, d)
    router = local_shard(ctx.replicated(p["router"]), [
        Partial() if a in dn or a == "model" else Replicate()
        for a in mesh.axis_names])
    dest, tok_sorted, w_sorted, order = _route_and_sort(cfg, router, xl, cap)
    local = dest - e0 * cap
    oob = torch.where((local >= 0) & (local < e_local * cap), local,
                      e_local * cap)
    buf = _dispatch(xl, oob, tok_sorted, e_local * cap)
    buf = DTensor.from_local(buf.reshape(1, e_local, cap, d), dm,
                             places(0, Shard(1)), run_check=False)

    # --- expert compute: [x(data), e(model), c, d] x [e(model), d, f] ---------
    buf = constrain(ctx, buf, "batch", "expert", None, "embed")
    gate = torch.einsum("xecd,edf->xecf", buf, p["w_gate"])
    up = torch.einsum("xecd,edf->xecf", buf, p["w_up"])
    h = F.silu(gate.float()).to(x.dtype) * up
    h = constrain(ctx, h, "batch", "expert", None, "expert_ffn")
    out_buf = torch.einsum("xecf,efd->xecd", h, p["w_down"])
    out_buf = constrain(ctx, out_buf, "batch", "expert", None, "embed")

    # --- combine body ---------------------------------------------------------
    flat = local_shard(out_buf).reshape(e_local * cap, d)
    expert_of = dest // cap
    mine = (expert_of >= e0) & (expert_of < e0 + e_local) & (dest < e * cap)
    li = torch.where(mine, (expert_of - e0) * cap + dest % cap, 0)
    contrib = flat[li].float() * torch.where(mine, w_sorted, 0.0)[:, None]
    out = _combine(contrib, order, t_local, k)
    # local accumulation in f32; the cross-rank sum rides the wire in
    # bf16 (each token has at most top_k contributions), as the reference
    out = sum_over(out.to(torch.bfloat16),
                              mesh.group_for("model"))
    out = DTensor.from_local(out.to(x.dtype), dm, places(0, Replicate()),
                             run_check=False)

    if "shared" in p:
        xf = x_in.reshape(t, d)
        out = out + mlp(p["shared"], xf[None], ctx)[0]
    out = out.reshape(b, s, d)
    return constrain(ctx, out, "batch", "seq", "embed")


def aux_load_loss(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Switch-style load-balance penalty (the reference's training loss
    does not add it either)."""
    b, s, d = x.shape
    probs = _router_probs(p["router"], x.reshape(b * s, d))
    _, sel = _top_k(probs, cfg.top_k)
    frac = torch.bincount(sel.reshape(-1), minlength=cfg.n_experts).float() \
        / (b * s * cfg.top_k)
    imp = probs.mean(0)
    return cfg.n_experts * torch.sum(frac * imp)


# ---------------------------------------------------------------------------
# model entry points (dense attention + MoE mlp)
# ---------------------------------------------------------------------------

def _ffn(cfg) -> tf.FFN:
    return lambda p, h, ctx=None: moe_block(cfg, p["moe"], h, ctx)


def apply(cfg, params: Params, tokens: torch.Tensor,
          train: bool = False,
          ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """tokens [B,S] -> logits [B,S,V_padded] (no banded route, as in the
    reference); ``train`` takes the dense family's training route."""
    with shard_scope(ctx):
        x = tf._embed(params, tokens, None, ctx)
        positions = torch.arange(x.shape[1], device=x.device)[None, :]
        x = constrain(ctx, x, "batch", "seq_sp", "embed")
        x = tf.run_layers(cfg, params["layers"], x, positions, _ffn(cfg),
                          train=train, ctx=ctx)
        return unembed(params["embed"], rms_norm(x, params["ln_f"]), ctx)


cache_specs = tf.cache_specs


def prefill(cfg, params: Params, tokens: torch.Tensor,
            ctx: Optional[ShardCtx] = None):
    return tf.prefill(cfg, params, tokens, ffn=_ffn(cfg), ctx=ctx)


def decode_step(cfg, params: Params, cache: Params, tokens: torch.Tensor,
                ctx: Optional[ShardCtx] = None):
    return tf.decode_step(cfg, params, cache, tokens, ffn=_ffn(cfg),
                          ctx=ctx)
