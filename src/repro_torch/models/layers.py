"""Shared building blocks of the language models.

Functional, as in the JAX package: a layer is a ``*_specs`` builder of
ParamSpecs and a forward function over a dict of tensors.

Sharding is *logical*, as in the reference: model code places
activations through :class:`ShardCtx` (a mesh of ranks and its
``AxisRules``). With ``ctx=None`` the constraints are no-ops and every
tensor is a plain tensor; with a context the parameters and the batch
are DTensors (``torch.distributed.tensor``) and :func:`constrain`
redistributes an activation to the layout its logical axes name, where
the reference's ``with_sharding_constraint`` is a hint to GSPMD. Ops
with no DTensor rule (the loss's gather and log-sum-exp over a sharded
vocab) gather their operand first, beside the call.

Dtypes follow the reference op for op: bf16 activations and weights,
norms, softmax and activations computed in float32 and cast back.

A decode position (``index``, ``kv_len``) may be a 0-d device tensor:
the masks, positions and cache writes built from it stay on the device,
so a decode step reads nothing back to the host.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.distributed.sharding import (AxisRules, ParamSpec,
                                              is_dtensor, logical_sharding,
                                              replica_scope, spec_tree_map,
                                              spec_zeros)
from repro_torch.kernels.flash_attention import flash_attention

Params = Dict[str, Any]

MASK_VALUE = -1e30


# ---------------------------------------------------------------------------
# sharding context
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Threaded through forward passes to place activations: a mesh of
    ranks (``launch.mesh.Mesh``) and its axis rules."""

    mesh: Any
    rules: AxisRules

    def constrain(self, x: torch.Tensor,
                  *logical: Optional[str]) -> torch.Tensor:
        """``x`` redistributed to the layout of ``logical``; a plain
        tensor is taken as the same whole value in every rank (its
        gradient comes back whole too)."""
        sharding = logical_sharding(self.mesh, self.rules, *logical)
        dm = self.mesh.device_mesh
        if not is_dtensor(x):
            from torch.distributed.tensor import DTensor, Replicate
            x = DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                                   run_check=False)
        return x.redistribute(dm, sharding.placements)

    def replicated(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` whole in every rank (a DTensor replicated over the mesh)."""
        return self.constrain(x, *([None] * x.dim()))

def constrain(ctx: Optional[ShardCtx], x: torch.Tensor,
              *logical: Optional[str]) -> torch.Tensor:
    return x if ctx is None else ctx.constrain(x, *logical)


def shard_scope(ctx: Optional[ShardCtx]):
    """``sharding.replica_scope`` on a mesh, nothing without one."""
    return contextlib.nullcontext() if ctx is None else replica_scope()


class _SumOver(torch.autograd.Function):
    """All-reduce (sum) over a group, forward only: every rank's partial
    feeds the one value the group holds replicated, so each rank's
    gradient is that value's (the backward is the identity)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        from repro_torch.launch import mesh as mesh_ops
        x = x.clone()
        mesh_ops.all_reduce(x, group)
        return x

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def sum_over(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` summed over ``group``'s ranks (a local tensor; see
    :class:`_SumOver`)."""
    return _SumOver.apply(x, group)


class _ContiguousGrad(torch.autograd.Function):
    """Identity whose backward makes the gradient contiguous: a DTensor's
    view ops in the backward read its local tensor's strides."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return grad.contiguous()


def local_shard(x: torch.Tensor, grad_placements=None) -> torch.Tensor:
    """A DTensor's local shard (``to_local``), with a contiguous gradient
    handed back to the DTensor."""
    return _ContiguousGrad.apply(x.to_local(grad_placements=grad_placements))


def on_shards(fn: Callable, q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor, **kw) -> torch.Tensor:
    """``fn(q, k, v, **kw)`` (an attention over [B, H|KH, S, D]) on each
    rank's shards of DTensor q/k/v: attention is independent per batch
    row and per kv-head group, as GSPMD partitions it. The batch dim
    keeps its shard; the head dims keep theirs where q's and k's agree
    (the same mesh axes, so each rank holds whole GQA groups), and are
    gathered otherwise. The output is laid out as q."""
    from torch.distributed.tensor import DTensor, Replicate
    dm = q.device_mesh

    def keep(p, other):
        if p.is_shard() and p.dim == 0 and other.is_shard() \
                and other.dim == 0:
            return p
        if p.is_shard() and p.dim == 1 and other == p:
            return p
        return Replicate()

    q_to = [keep(a, b) for a, b in zip(q.placements, k.placements)]
    k_to = [keep(b, a) for a, b in zip(q.placements, k.placements)]
    # a replicated position (a decode step's kv_len) is the same value in
    # every rank
    kw = {n: a.full_tensor() if is_dtensor(a) else a for n, a in kw.items()}
    out = fn(local_shard(q.redistribute(dm, q_to)),
             local_shard(k.redistribute(dm, k_to)),
             local_shard(v.redistribute(dm, k_to)), **kw)
    return DTensor.from_local(out, dm, q_to, run_check=False)


def layer_unroll(cfg):
    """The reference's ``lax.scan`` ``unroll`` argument for scans over
    layers (fully unrolled when the config asks for it, else 1). An XLA
    unroll factor: the port runs its layers as a Python loop and ignores
    it."""
    return True if getattr(cfg, "unroll_layers", False) else 1


def attn_block_unroll(cfg, n_blocks: int) -> int:
    """The reference's partial-unroll factor for the blockwise-attention
    kv scan, capped at 32 (a divisor of ``n_blocks``). An XLA unroll
    factor: the port's Python loop over kv blocks ignores it."""
    if not getattr(cfg, "unroll_layers", False):
        return 1
    cap = 32
    u = min(n_blocks, cap)
    while n_blocks % u:
        u -= 1
    return max(u, 1)


# ---------------------------------------------------------------------------
# spec helpers
# ---------------------------------------------------------------------------

def stack_specs(specs, n: int):
    """Prepend a stacked ``layers`` dim to every ParamSpec in a tree."""
    return spec_tree_map(
        lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.logical_axes,
                            s.dtype, s.init, s.init_scale), specs)


def dense_spec(d_in: int, d_out: int, ax_in: str, ax_out: str,
               dtype=torch.bfloat16) -> ParamSpec:
    return ParamSpec((d_in, d_out), (ax_in, ax_out), dtype, "scaled")


def layer_params(tree, *index: int):
    """One layer's parameters out of a stacked tree (``tree[...][index]``
    on every leaf; the reference scans over the leading axes instead)."""
    if isinstance(tree, torch.Tensor):
        return tree[index]
    return {k: layer_params(v, *index) for k, v in tree.items()}


def unstack(tree, n: int) -> List[Any]:
    """The ``n`` layers of a stacked tree as a list of trees of views
    (``torch.unbind`` on every leaf): the training route's per-layer
    parameters, whose gradients come back as one stack per leaf."""
    if isinstance(tree, torch.Tensor):
        return list(torch.unbind(tree, 0))
    per_key = {k: unstack(v, n) for k, v in tree.items()}
    return [{k: per_key[k][i] for k in tree} for i in range(n)]


# ---------------------------------------------------------------------------
# recomputation in the backward (the reference's jax.checkpoint)
# ---------------------------------------------------------------------------

def _save_dots(ctx, op, *args, **kwargs):
    """The ``"dots"`` policy: keep the matrix products' outputs
    (``jax.checkpoint_policies.checkpoint_dots``), recompute the rest."""
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


_DOTS = {torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default, torch.ops.aten.baddbmm.default}


def remat(cfg, fn: Callable, train: bool = True) -> Callable:
    """A layer under ``cfg.remat`` on the training route, as the
    reference's ``_remat``: ``"none"`` runs it as it is, ``"dots"`` saves
    the matrix products' outputs and recomputes the rest in the backward,
    any other value (``"full"``) saves only the layer's inputs. Off the
    training route (``train`` false) ``fn`` itself."""
    if not train or cfg.remat == "none":
        return fn
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            create_selective_checkpoint_contexts, _save_dots)
    return functools.partial(checkpoint, fn, use_reentrant=False, **kw)


def recomputed(fn: Callable, *inputs: torch.Tensor) -> Callable:
    """``fn`` with its intermediates recomputed in the backward (the
    reference's ``jax.checkpoint`` around an attention scan body) when
    autograd records ``inputs``; ``fn`` itself otherwise, so forward-only
    calls are unchanged."""
    if not any(x.requires_grad for x in inputs):
        return fn
    return functools.partial(checkpoint, fn, use_reentrant=False)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    var = xf.square().mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + w.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = (xf - mu).square().mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * w.float() + b.float()).to(x.dtype)


def norm_specs(d: int) -> ParamSpec:
    # rms_norm weight stored as offset-from-1 (init zeros)
    return ParamSpec((d,), ("embed",), torch.float32, "zeros")


# ---------------------------------------------------------------------------
# rotary embedding
# ---------------------------------------------------------------------------

def rope_freqs(d_head: int, theta: float = 10000.0,
               device=None) -> torch.Tensor:
    exps = torch.arange(0, d_head, 2, dtype=torch.float32,
                        device=device) / d_head
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x: [..., S, n_heads, d_head]; positions: [..., S] (broadcastable)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                     # [d/2]
    ang = positions[..., None].float() * freqs                 # [..., S, d/2]
    sin = torch.sin(ang)[..., None, :]                         # [..., S, 1, d/2]
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(n: int, d: int, device=None) -> torch.Tensor:
    pos = torch.arange(n, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(-torch.log(torch.tensor(10000.0)) * torch.arange(
        0, d, 2, dtype=torch.float32, device=device) / d)
    ang = pos * inv[None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# attention (blockwise online softmax and decode shapes in plain PyTorch;
# the flash kernel on the card)
# ---------------------------------------------------------------------------

def blockwise_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        kv_len=None, scale: Optional[float] = None,
                        block_k: int = 1024) -> torch.Tensor:
    """Online-softmax attention over kv blocks (O(S·block) live memory).

    q [B,H,Sq,D]; k/v [B,KH,Sk,D]; GQA by head groups; q rows sit at the
    end of the kv timeline (``kv_len - Sq``; an int or a 0-d tensor);
    ``window`` 0/None => full.
    """
    b, h, s_q, d = q.shape
    _, kh, s_k, _ = k.shape
    if h % kh:
        raise ValueError(f"{h} query heads do not group over {kh} kv heads")
    group = h // kh
    scale = (d ** -0.5) if scale is None else scale
    if kv_len is None:
        kv_len = s_k
    elif isinstance(kv_len, torch.Tensor):
        kv_len = torch.clamp(kv_len, max=s_k)
    else:
        kv_len = min(s_k, kv_len)
    window = window or 0
    q_off = kv_len - s_q
    if s_k % block_k:     # pad kv to a block multiple; kv_len masks the tail
        pad = block_k - s_k % block_k
        k = F.pad(k, (0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, pad))
        s_k += pad

    dev = q.device
    qf = (q.float() * scale).reshape(b, kh, group * s_q, d)
    qp = (q_off + torch.arange(s_q, device=dev)).repeat(group)[:, None]
    m = torch.full((b, kh, group * s_q), MASK_VALUE, device=dev)
    l_sum = torch.zeros((b, kh, group * s_q), device=dev)
    acc = torch.zeros((b, kh, group * s_q, d), device=dev)

    def step(m, l_sum, acc, kc, vc, start: int):
        s = qf @ kc.float().transpose(-1, -2)
        k_pos = start + torch.arange(block_k, device=dev)
        mask = k_pos[None, :] < kv_len
        if causal:
            mask = mask & (qp >= k_pos[None, :])
        if window > 0:
            mask = mask & ((qp - k_pos[None, :]) < window)
        s = torch.where(mask, s, MASK_VALUE)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        p = torch.where(mask, p, 0.0)
        alpha = torch.exp(m - m_new)
        return (m_new, alpha * l_sum + p.sum(-1),
                acc * alpha[..., None] + p @ vc.float())

    # the backward recomputes each block's scores, as the reference's
    # checkpointed scan body does: O(S·block) saved, not O(S·S)
    step = recomputed(step, q, k, v)
    for start in range(0, s_k, block_k):
        m, l_sum, acc = step(m, l_sum, acc, k[:, :, start:start + block_k],
                             v[:, :, start:start + block_k], start)
    l_sum = torch.where(l_sum == 0.0, 1.0, l_sum)
    out = (acc / l_sum[..., None]).reshape(b, h, s_q, d)
    return out.to(q.dtype)


def banded_local_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *, window: int,
                           block: int = 1024) -> torch.Tensor:
    """Sliding-window causal attention that computes only the band: each
    q block attends its own and the previous kv block (``window <=
    block``), one q block at a time, as the reference's scan does.

    q/k/v: [B, H|KH, S, D], S % block == 0, full self-attention shapes.
    """
    if is_dtensor(q):
        return on_shards(banded_local_attention, q, k, v, window=window,
                         block=block)
    b, h, s, d = q.shape
    kh = k.shape[1]
    group = h // kh
    if s % block or not 0 < window <= block:
        raise ValueError(f"banded attention needs S % block == 0 and "
                         f"0 < window <= block (S={s}, block={block}, "
                         f"window={window})")
    nb = s // block
    scale = d ** -0.5
    dev = q.device
    qb = (q.float() * scale).reshape(b, kh, group, nb, block, d)
    kb = k.reshape(b, kh, nb, block, d)
    vb = v.reshape(b, kh, nb, block, d)
    q_pos = torch.arange(block, device=dev)[:, None]
    k_pos = torch.arange(2 * block, device=dev)[None, :] - block
    band = (q_pos >= k_pos) & (q_pos - k_pos < window)

    def band_block(qi, ki, vi, first: bool):
        mask = band & (k_pos >= 0) if first else band
        sc = torch.einsum("bkgqd,bksd->bkgqs", qi, ki.float())
        sc = torch.where(mask, sc, MASK_VALUE)
        p = torch.where(mask, torch.softmax(sc, dim=-1), 0.0)
        return torch.einsum("bkgqs,bksd->bkgqd", p, vi.float())

    band_block = recomputed(band_block, q, k, v)   # one band saved
    out = []
    for i in range(nb):
        # the previous kv block (zeros before the first, masked) + this one
        prev_k = kb[:, :, i - 1] if i else torch.zeros_like(kb[:, :, 0])
        prev_v = vb[:, :, i - 1] if i else torch.zeros_like(vb[:, :, 0])
        out.append(band_block(qb[:, :, :, i],
                              torch.cat([prev_k, kb[:, :, i]], dim=2),
                              torch.cat([prev_v, vb[:, :, i]], dim=2),
                              i == 0))
    return torch.stack(out, dim=3).reshape(b, h, s, d).to(q.dtype)


def dense_decode_attention(q: torch.Tensor, k: torch.Tensor,
                           v: torch.Tensor, *,
                           window: Optional[int] = None, kv_len=None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Decode-shape attention (small Sq): one masked product over the whole
    kv timeline. Causal; ``kv_len`` (int or 0-d tensor) masks the unwritten
    cache tail. k/v stay in their dtype and are promoted per product."""
    b, h, s_q, d = q.shape
    _, kh, s_k, _ = k.shape
    group = h // kh
    scale = (d ** -0.5) if scale is None else scale
    kv_len = s_k if kv_len is None else kv_len
    dev = q.device
    qf = (q.float() * scale).reshape(b, kh, group * s_q, d)
    s = qf @ k.float().transpose(-1, -2)
    k_pos = torch.arange(s_k, device=dev)
    q_pos = kv_len - s_q + torch.arange(s_q, device=dev)
    qp = q_pos.repeat(group)[:, None]
    mask = (k_pos[None, :] < kv_len) & (qp >= k_pos[None, :])
    if window is not None and window > 0:
        mask = mask & ((qp - k_pos[None, :]) < window)
    s = torch.where(mask, s, MASK_VALUE)
    p = torch.where(mask, torch.softmax(s, dim=-1), 0.0)
    out = p @ v.float()
    return out.reshape(b, h, s_q, d).to(q.dtype)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, window=None, kv_len=None,
              scale: Optional[float] = None, use_pallas: bool = False,
              block_k: int = 1024) -> torch.Tensor:
    """Model-facing attention, the reference's branches in its order:
    the dense path for decode shapes (Sq <= 8, causal, Sk > Sq); with
    ``use_pallas`` and a static window (a Python int or None) the flash
    kernel (``kernels.flash_attention``: the CUDA kernel on the card, its
    plain version on the CPU); the blockwise path otherwise. The models
    pass ``use_pallas=True`` where the reference passes
    ``cfg.use_pallas or False``, and False where it hard-codes False.
    DTensor q/k/v (a mesh) run :func:`on_shards`."""
    if is_dtensor(q):
        return on_shards(attention, q, k, v, causal=causal, window=window,
                         kv_len=kv_len, scale=scale, use_pallas=use_pallas,
                         block_k=block_k)
    if q.shape[2] <= 8 and causal and k.shape[2] > q.shape[2]:
        return dense_decode_attention(q, k, v, window=window, kv_len=kv_len,
                                      scale=scale)
    if use_pallas and isinstance(window, (int, type(None))):
        return flash_attention(q, k, v, causal=causal, window=window,
                               scale=scale, kv_len=kv_len)
    bk = min(block_k, k.shape[2])
    return blockwise_attention(q, k, v, causal=causal, window=window,
                               kv_len=kv_len, scale=scale, block_k=bk)


# ---------------------------------------------------------------------------
# attention block (GQA + qk_norm + rope)
# ---------------------------------------------------------------------------

def attn_specs(d_model: int, n_heads: int, n_kv_heads: int, d_head: int,
               qk_norm: bool = False) -> Params:
    s: Params = {
        "wq": ParamSpec((d_model, n_heads, d_head),
                        ("embed", "heads", "head_dim"), init="scaled"),
        "wk": ParamSpec((d_model, n_kv_heads, d_head),
                        ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wv": ParamSpec((d_model, n_kv_heads, d_head),
                        ("embed", "kv_heads", "head_dim"), init="scaled"),
        "wo": ParamSpec((n_heads, d_head, d_model),
                        ("heads", "head_dim", "embed"), init="scaled"),
    }
    if qk_norm:
        s["q_norm"] = ParamSpec((d_head,), ("head_dim",), torch.float32,
                                "zeros")
        s["k_norm"] = ParamSpec((d_head,), ("head_dim",), torch.float32,
                                "zeros")
    return s


def attn_qkv(p: Params, x: torch.Tensor, positions: torch.Tensor, *,
             rope_theta: float = 10000.0, use_rope: bool = True,
             ctx: Optional[ShardCtx] = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x [B,S,D] -> q [B,H,S,Dh], k/v [B,KH,S,Dh] (rope + qk_norm applied)."""
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    q = constrain(ctx, q, "batch", "seq", "heads", "head_dim")
    k = constrain(ctx, k, "batch", "seq", "kv_heads", "head_dim")
    if "q_norm" in p:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    if use_rope:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions, rope_theta)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def attn_out(p: Params, o: torch.Tensor,
             ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    """o [B,H,S,Dh] -> [B,S,D]."""
    out = torch.einsum("bhsk,hkd->bsd", o, p["wo"])
    return constrain(ctx, out, "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def mlp_specs(d_model: int, d_ff: int, gated: bool = True) -> Params:
    s: Params = {
        "w_up": ParamSpec((d_model, d_ff), ("embed", "ffn"), init="scaled"),
        "w_down": ParamSpec((d_ff, d_model), ("ffn", "embed"),
                            init="scaled"),
    }
    if gated:
        s["w_gate"] = ParamSpec((d_model, d_ff), ("embed", "ffn"),
                                init="scaled")
    return s


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def mlp(p: Params, x: torch.Tensor, ctx: Optional[ShardCtx] = None,
        act=F.silu) -> torch.Tensor:
    up = x @ p["w_up"]
    if "w_gate" in p:
        gate = x @ p["w_gate"]
        h = act(gate.float()).to(x.dtype) * up
    else:
        h = act(up.float()).to(x.dtype)
    h = constrain(ctx, h, "batch", "seq", "ffn")
    return constrain(ctx, h @ p["w_down"], "batch", "seq", "embed")


# ---------------------------------------------------------------------------
# embedding / unembedding / loss
# ---------------------------------------------------------------------------

def round_up(n: int, mult: int) -> int:
    return ((n + mult - 1) // mult) * mult


def embed_specs(vocab_padded: int, d_model: int,
                tied: bool = True) -> Params:
    s: Params = {"embedding": ParamSpec((vocab_padded, d_model),
                                        ("vocab", "embed"), init="normal")}
    if not tied:
        s["unembed"] = ParamSpec((d_model, vocab_padded),
                                 ("embed", "vocab"), init="scaled")
    return s


def embed(p: Params, tokens: torch.Tensor,
          ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    if ctx is None:
        return p["embedding"][tokens]
    # the lookup keeps the table's vocab shard (a masked partial sum) and
    # gathers any other (FSDP's embed shard) first
    from torch.distributed.tensor import Replicate
    table = p["embedding"]
    table = table.redistribute(table.device_mesh, [
        q if q.is_shard() and q.dim == 0 else Replicate()
        for q in table.placements])
    return constrain(ctx, F.embedding(tokens, table), "batch", "seq", "embed")


def unembed(p: Params, x: torch.Tensor,
            ctx: Optional[ShardCtx] = None) -> torch.Tensor:
    if "unembed" in p:
        logits = x @ p["unembed"]
    else:
        logits = x @ p["embedding"].T
    return constrain(ctx, logits, "batch", "seq", "vocab")


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None,
                 vocab_size: Optional[int] = None) -> torch.Tensor:
    """Mean next-token cross-entropy (float32). ``vocab_size`` masks padded
    vocab rows. On a mesh (DTensor logits) the mean is over the global
    batch, as the reference's GSPMD loss, and a vocab dim sharded over
    one mesh axis stays sharded: :func:`_vocab_parallel_nll` (the
    reference's logsumexp lowers to partial reductions + all-reduce)."""
    lf = logits.float()
    nll = (_vocab_parallel_nll(lf, labels, vocab_size) if is_dtensor(lf)
           else _nll(lf, labels, vocab_size))
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def _nll(lf: torch.Tensor, labels: torch.Tensor,
         vocab_size: Optional[int]) -> torch.Tensor:
    """Per-token NLL of float32 logits whose vocab dim is whole."""
    if vocab_size is not None and vocab_size < lf.shape[-1]:
        pad = torch.arange(lf.shape[-1], device=lf.device) >= vocab_size
        lf = lf.masked_fill(pad, MASK_VALUE)
    lse = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    return lse - gold


def _vocab_parallel_nll(lf: torch.Tensor, labels: torch.Tensor,
                        vocab_size: Optional[int]) -> torch.Tensor:
    """Per-token NLL of DTensor float32 logits [B,S,V] as a DTensor laid
    out as their other dims. Where one mesh axis shards the vocab dim
    (and nothing is partial), each rank takes its columns' max, sum of
    exponentials and gold logit, and the vocab axis's group sums them (a
    max, then two sums of [B,S] values); otherwise the vocab dim is
    gathered first."""
    from torch.distributed.tensor import DTensor, Replicate
    dm, places = lf.device_mesh, list(lf.placements)
    last = lf.dim() - 1
    vocab_dims = [i for i, p in enumerate(places)
                  if p.is_shard() and p.dim == last]
    v_total = lf.shape[-1]
    if len(vocab_dims) != 1 or any(p.is_partial() for p in places):
        return _nll(lf.redistribute(dm, [
            Replicate() if p.is_partial() or (p.is_shard() and p.dim == last)
            else p for p in places]), labels, vocab_size)
    from repro_torch.launch import mesh as mesh_ops
    axis = vocab_dims[0]
    group = dm.get_group(axis)
    n = dm.size(axis)
    local = local_shard(lf, places)
    labels = labels.to_local() if is_dtensor(labels) else labels
    v_local = v_total // n
    v0 = dm.get_local_rank(axis) * v_local
    if vocab_size is not None and vocab_size < v_total:
        pad = v0 + torch.arange(v_local, device=local.device) >= vocab_size
        local = local.masked_fill(pad, MASK_VALUE)
    m = local.detach().amax(-1)
    mesh_ops.all_reduce(m, group, op=torch.distributed.ReduceOp.MAX)
    lse = torch.log(sum_over(torch.exp(local - m[..., None]).sum(-1),
                             group)) + m
    rel = labels.long() - v0
    mine = (rel >= 0) & (rel < v_local)
    gold = torch.gather(local, -1, rel.clamp(0, v_local - 1)[..., None])
    gold = sum_over(torch.where(mine, gold[..., 0], 0.0), group)
    return DTensor.from_local(
        lse - gold, dm, [Replicate() if i == axis else p
                         for i, p in enumerate(places)], run_check=False)


# ---------------------------------------------------------------------------
# KV cache helpers (decode)
# ---------------------------------------------------------------------------

def kv_cache_specs(n_layers: int, batch: int, n_kv_heads: int, max_len: int,
                   d_head: int, dtype=torch.bfloat16) -> Params:
    """Stacked [L, B, KH, S, Dh] cache + write index. The cache ``seq``
    dim is ``kv_seq``: ``auto_rules`` gives it the ``model`` axis when
    the kv heads cannot use it."""
    kv = ParamSpec((n_layers, batch, n_kv_heads, max_len, d_head),
                   ("layers", "batch", "kv_heads", "kv_seq", "head_dim"),
                   dtype, "zeros")
    return {"k": kv, "v": kv,
            "index": ParamSpec((), (), torch.int32, "zeros")}


def cache_zeros(ctx: Optional[ShardCtx], spec: ParamSpec,
                device) -> torch.Tensor:
    """A fresh cache leaf of ``spec``: zeros, on a mesh a DTensor whose
    rank holds its shard only."""
    return (spec_zeros(spec, device) if ctx is None
            else spec_zeros(spec, device, ctx.mesh, ctx.rules))


def _cache_write(cache: torch.Tensor, new: torch.Tensor,
                 index) -> torch.Tensor:
    """``new`` [B,KH,S_new,Dh] written at ``index`` into each rank's
    shard of a DTensor cache [B,KH,S_max,Dh], in place, as GSPMD
    partitions ``dynamic_update_slice``: ``new`` is laid out as the
    cache's shard but whole along the sequence, and where the cache's
    sequence is sharded (``kv_seq``) each rank takes the positions that
    fall in its part."""
    from torch.distributed.tensor import DTensor, Replicate
    from repro_torch.distributed.sharding import shard_extent
    dm, places = cache.device_mesh, cache.placements
    s_new, s_max = new.shape[2], cache.shape[2]
    to = [Replicate() if p.is_shard() and p.dim == 2 else p for p in places]
    if not is_dtensor(new):
        new = DTensor.from_local(new, dm, [Replicate()] * dm.ndim,
                                 run_check=False)
    src = new.redistribute(dm, to).to_local().to(cache.dtype)
    local = cache.to_local()
    if is_dtensor(index):             # a replicated 0-d position
        index = index.full_tensor()
    start = torch.clamp(torch.as_tensor(index, device=local.device),
                        0, s_max - s_new)
    if to == list(places):            # the sequence is whole in each rank
        pos = start + torch.arange(s_new, device=local.device)
        local.index_copy_(2, pos, src)
        return cache
    _, offset = shard_extent(cache.shape, dm, places)
    j = (offset[2] + torch.arange(local.shape[2], device=local.device)
         - start)
    mine = ((j >= 0) & (j < s_new))[None, None, :, None]
    rows = src.index_select(2, torch.clamp(j, 0, s_new - 1))
    local.copy_(torch.where(mine, rows, local))
    return cache


def cache_update(cache_k: torch.Tensor, cache_v: torch.Tensor,
                 k: torch.Tensor, v: torch.Tensor, index
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Write k/v [B,KH,S_new,Dh] at position ``index`` (an int or a 0-d
    tensor) of one layer's cache [B,KH,S_max,Dh], clamped to fit as
    ``lax.dynamic_update_slice`` clamps it. The cache is updated in place
    (the reference's jit does the same to its buffer) and returned; a
    DTensor cache (a mesh) in each rank's shard (:func:`_cache_write`)."""
    if is_dtensor(cache_k):
        return (_cache_write(cache_k, k, index),
                _cache_write(cache_v, v, index))
    s_new, s_max = k.shape[2], cache_k.shape[2]
    start = torch.clamp(torch.as_tensor(index, device=cache_k.device),
                        0, s_max - s_new)
    pos = start + torch.arange(s_new, device=cache_k.device)
    cache_k.index_copy_(2, pos, k.to(cache_k.dtype))
    cache_v.index_copy_(2, pos, v.to(cache_v.dtype))
    return cache_k, cache_v
