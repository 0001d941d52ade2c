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

The GSPMD dispatch of the JAX package (``moe_block_local``, its
``shard_map`` over the mesh) is not ported: the port runs one device.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import ParamSpec

from . import transformer as tf
from .layers import (Params, embed_specs, mlp, mlp_specs, norm_specs,
                     rms_norm, round_up, stack_specs, unembed)


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------

def moe_mlp_specs(cfg) -> Params:
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    s: Params = {
        "router": ParamSpec((d, e), torch.float32, "scaled"),
        "w_gate": ParamSpec((e, d, f), init="scaled"),
        "w_up": ParamSpec((e, d, f), init="scaled"),
        "w_down": ParamSpec((e, f, d), init="scaled"),
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


def moe_block(cfg, p: Params, x: torch.Tensor) -> torch.Tensor:
    """x [B,S,D] -> [B,S,D]; top-k routing, capacity C per expert."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = capacity(cfg, t)
    xf = x.reshape(t, d)
    dest, tok_sorted, w_sorted, order = _route_and_sort(cfg, p["router"],
                                                        xf, cap)

    # gather tokens into the [E,C,D] buffer; row E*C takes the dropped
    # pairs and is cut off
    buf = x.new_zeros((e * cap + 1, d))
    buf[dest] = xf[tok_sorted]
    buf = buf[:e * cap].reshape(e, cap, d)

    # expert compute (real work only)
    gate = torch.bmm(buf, p["w_gate"])
    up = torch.bmm(buf, p["w_up"])
    h = F.silu(gate.float()).to(x.dtype) * up
    out_buf = torch.bmm(h, p["w_down"]).reshape(e * cap, d)

    # combine: each token's k weighted outputs, added in bf16 in sorted
    # order (the pairs of one token are sorted by expert)
    contrib = (out_buf[torch.clamp(dest, max=e * cap - 1)]
               * w_sorted[:, None].to(x.dtype))
    inv = torch.empty_like(order)
    inv[order] = torch.arange(t * k, device=x.device)
    ranks = torch.sort(inv.reshape(t, k), dim=1).values      # [t,k]
    per_tok = contrib[ranks]                                 # [t,k,d]
    out = per_tok[:, 0]
    for j in range(1, k):
        out = out + per_tok[:, j]

    if "shared" in p:
        out = out + mlp(p["shared"], xf[None])[0]
    return out.reshape(b, s, d)


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
    return lambda p, h: moe_block(cfg, p["moe"], h)


def apply(cfg, params: Params, tokens: torch.Tensor,
          train: bool = False) -> torch.Tensor:
    """tokens [B,S] -> logits [B,S,V_padded] (no banded route, as in the
    reference); ``train`` takes the dense family's training route."""
    x = tf._embed(params, tokens, None)
    positions = torch.arange(x.shape[1], device=x.device)[None, :]
    x = tf.run_layers(cfg, params["layers"], x, positions, _ffn(cfg),
                      train=train)
    return unembed(params["embed"], rms_norm(x, params["ln_f"]))


cache_specs = tf.cache_specs


def prefill(cfg, params: Params, tokens: torch.Tensor):
    return tf.prefill(cfg, params, tokens, ffn=_ffn(cfg))


def decode_step(cfg, params: Params, cache: Params, tokens: torch.Tensor):
    return tf.decode_step(cfg, params, cache, tokens, ffn=_ffn(cfg))
