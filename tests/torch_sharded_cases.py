"""Rank bodies of the sharded-training tests (``test_torch_grad_compress``
and ``test_torch_sharded_train``), run by ``launch_ranks`` in spawned
ranks: module-level functions of a module that imports no JAX. Each
returns numpy arrays and floats for the test process to compare."""
import dataclasses
import io
import contextlib

import numpy as np
import torch


def _np(x):
    return _t(x).detach().float().cpu().numpy()


def _tree_np(tree):
    if isinstance(tree, dict):
        return {k: _tree_np(v) for k, v in tree.items()}
    return _np(tree)


# ---------------------------------------------------------------------------
# gradient compression
# ---------------------------------------------------------------------------

def _tensors(tree):
    return {k: torch.from_numpy(np.array(v, np.float32)).to(
        torch.bfloat16 if k.startswith("bf16") else torch.float32)
        for k, v in tree.items()}


def compress_case(grads, errs, shape, axes, hierarchical):
    """Each rank's grads/errs (row ``rank`` of each stacked array) through
    ``compress_allreduce`` over ``pod`` (or the hierarchical sync over
    ``(pod, data)``), twice, the second with the first's error buffers;
    also this rank's int8 payload summed over the pods."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train import grad_compress as GC
    mesh = make_mesh(shape, axes, device="cpu")
    r = dist.get_rank()
    g = _tensors({k: v[r] for k, v in grads.items()})
    e = {k: torch.from_numpy(np.array(v[r], np.float32))
         for k, v in errs.items()}
    out = {}
    for it in range(2):
        if hierarchical:
            g2, e = GC.hierarchical_compress_allreduce(g, e, mesh=mesh)
        else:
            g2, e = GC.compress_allreduce(g, e, mesh=mesh)
        out[f"grads{it}"] = {k: _np(v) for k, v in g2.items()}
        out[f"errs{it}"] = {k: _np(v) for k, v in e.items()}
    if not hierarchical:
        sums = {}
        for k, v in g.items():
            q, scale, _ = GC.quantize_leaf(
                v, torch.zeros(v.shape, dtype=torch.float32))
            q_sum, _ = GC._sum_over_pods(q, scale, mesh.group_for("pod"),
                                         mesh.shape["pod"])
            sums[k] = q_sum.numpy()
        out["q_sum"] = sums
    return out


# ---------------------------------------------------------------------------
# sharded training
# ---------------------------------------------------------------------------

def _cfg(arch, fsdp=False, local=False):
    from repro_torch.configs import get_config, reduced_config
    cfg = reduced_config(get_config(arch))
    if fsdp:
        cfg = dataclasses.replace(cfg, fsdp=True)
    if local:
        cfg = dataclasses.replace(cfg, moe_impl="local",
                                  capacity_factor=float(cfg.n_experts))
    return cfg


def _state(cfg, weights, ctx, lr):
    """(params laid out by ``ctx``'s rules or whole, optimizer, state)."""
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.models import get_model
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.train.optimizer import make_optimizer, tree_map
    params = params_from_numpy(weights, device="cpu")
    if ctx is not None:
        specs = get_model(cfg.family).param_specs(cfg)
        shard = param_shardings(specs, ctx.mesh, ctx.rules)
        params = tree_map(lambda p, s: s.shard(p), params, shard)
    opt = make_optimizer(cfg.optimizer, lr=lr)
    return params, opt, opt.init(params)


def _step_out(params, state, metrics):
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": _tree_np(params), "mu": _tree_np(state["mu"])}


def _train_case(arch, weights, batch, lr, fsdp=False, local=False,
                one_rank=False):
    """One step of ``arch`` on the (data=2, model=2) mesh (``auto_rules``,
    with ``cfg.fsdp`` for FSDP), and on rank 0 the one-rank step on the
    whole tensors."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import auto_rules
    from repro_torch.models.layers import ShardCtx
    from repro_torch.train.train_step import local_batch, make_train_step
    cfg = _cfg(arch, fsdp, local)
    mesh = make_local_mesh(model=2, device="cpu")
    ctx = ShardCtx(mesh, auto_rules(cfg, mesh))
    tb = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    params, opt, state = _state(cfg, weights, ctx, lr)
    step = make_train_step(cfg, optimizer=opt, ctx=ctx)
    new, state, metrics = step(params, state, local_batch(ctx, tb), 0)
    out = {"sharded": _step_out(new, state, metrics),
           "placements": {"wq": str(params["layers"]["attn"]["wq"]
                                    .placements),
                          "embedding": str(params["embed"]["embedding"]
                                           .placements)}}
    if one_rank:
        p1, opt1, s1 = _state(cfg, weights, None, lr)
        n1, s1, m1 = make_train_step(cfg, optimizer=opt1)(p1, s1, tb, 0)
        out["one_rank"] = _step_out(n1, s1, m1)
    return out


def _moe_case(weights, x_np):
    """``moe_block_local`` on the mesh against the one-device block, and
    its gradients."""
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import auto_rules
    from repro_torch.models import moe as M
    from repro_torch.models.convert import params_from_numpy
    from repro_torch.models.layers import ShardCtx, shard_scope
    from repro_torch.train.optimizer import tree_leaves, tree_map
    cfg = _cfg("olmoe-1b-7b", local=True)
    mesh = make_local_mesh(model=2, device="cpu")
    ctx = ShardCtx(mesh, auto_rules(cfg, mesh))
    specs = M.moe_mlp_specs(cfg)
    # the block in its own dtypes (bf16 experts, a float32 router)
    whole = tree_map(lambda w, s: w.to(s.dtype),
                     params_from_numpy(weights, device="cpu"), specs)
    shard = param_shardings(specs, mesh, ctx.rules)
    p = tree_map(lambda w, s: s.shard(w).detach().requires_grad_(True),
                 whole, shard)
    x = torch.from_numpy(np.array(x_np)).to(torch.bfloat16)
    with shard_scope(ctx):
        xd = ctx.constrain(x, "batch", "seq", "embed")
        local = M.moe_block(cfg, p, xd, ctx)
        local.float().sum().backward()
    glob = M.moe_block(dataclasses.replace(cfg, moe_impl="global"),
                       whole, x)
    return {"local": _np(local), "global": _np(glob),
            "grads_finite": all(bool(torch.isfinite(
                _t(v.grad)).all()) for _, v in tree_leaves(p)),
            "grad_norms": {"/".join(k): float(_t(v.grad).float().norm())
                           for k, v in tree_leaves(p)}}


def _t(x):
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def _ef_case(weights, batch, lr):
    """The pod-decoupled error-feedback step on (pod=2, data=2): every
    rank's replicated params and its quarter of the batch."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.train.train_step import (make_train_step,
                                              with_error_feedback)
    cfg = _cfg("qwen3-1.7b")
    mesh = make_mesh((2, 2), ("pod", "data"), device="cpu")
    params, opt, _ = _state(cfg, weights, None, lr)
    ef_opt, hook = with_error_feedback(opt, 2, mesh=mesh)
    state = ef_opt.init(params)
    r = dist.get_rank()
    tb = {k: torch.from_numpy(np.array(v)).chunk(4, dim=0)[r]
          for k, v in batch.items()}
    step = make_train_step(cfg, optimizer=ef_opt, grad_compress=hook)
    new, state, metrics = step(params, state, tb, 0)
    return {"loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": _tree_np(new), "ef": _tree_np(state["ef"])}


def _elastic_case(weights, batches, lr, root):
    """A checkpoint written by one rank after a one-device step, restored
    onto the (data=2, model=2) mesh; the mesh's next step against the
    uninterrupted one-device run's."""
    import torch.distributed as dist
    from repro_torch.distributed import checkpoint as C
    from repro_torch.distributed.sharding import param_shardings
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import auto_rules, get_model
    from repro_torch.models.layers import ShardCtx
    from repro_torch.train.train_step import local_batch, make_train_step
    cfg = _cfg("qwen3-1.7b")
    tbs = [{k: torch.from_numpy(np.array(v)) for k, v in b.items()}
           for b in batches]
    out = {}
    if dist.get_rank() == 0:
        p1, opt1, s1 = _state(cfg, weights, None, lr)
        step1 = make_train_step(cfg, optimizer=opt1)
        p1, s1, _ = step1(p1, s1, tbs[0], 0)
        C.save_checkpoint(root, 0, (p1, s1), extra={"step": 0})
        p1, s1, m1 = step1(p1, s1, tbs[1], 1)
        out["uninterrupted"] = _step_out(p1, s1, m1)
    dist.barrier()
    mesh = make_local_mesh(model=2, device="cpu")
    ctx = ShardCtx(mesh, auto_rules(cfg, mesh))
    specs = get_model(cfg.family).param_specs(cfg)
    params, opt, state = _state(cfg, weights, ctx, lr)
    shardings = param_shardings(specs, mesh, ctx.rules)
    like = (params, state)
    (params, state), extra = C.restore_checkpoint(
        root, like, device="cpu",
        shardings=(shardings, {"mu": shardings, "nu": shardings,
                               "master": shardings}))
    out["placements_kept"] = all(
        a.placements == b.placements for a, b in zip(
            _leaves(params), _leaves(like[0])))
    step = make_train_step(cfg, optimizer=opt, ctx=ctx)
    params, state, metrics = step(params, state,
                                  local_batch(ctx, tbs[1]),
                                  int(extra["step"]) + 1)
    out["restored"] = _step_out(params, state, metrics)
    out["shard_shape"] = tuple(params["layers"]["mlp"]["w_up"]
                               .to_local().shape)
    return out


def _leaves(tree):
    from repro_torch.train.optimizer import tree_leaves
    return [x for _, x in tree_leaves(tree)]


def _driver_case(argv):
    """``launch/train.py``'s ``main`` in this rank (stdout kept), and
    ``--model-parallel 3``'s refusal."""
    from repro_torch.launch import train as T
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        T.main(argv + ["--model-parallel", "2"])
    try:
        T.main(argv + ["--model-parallel", "3"])
        refused = ""
    except SystemExit as e:
        refused = str(e)
    return {"stdout": buf.getvalue(), "refused": refused}


def sharded_train_cases(inputs):
    """Every case of ``test_torch_sharded_train`` in one group of 4
    ranks (``inputs`` from the test process)."""
    torch.manual_seed(0)
    lr = inputs["lr"]
    out = {}
    for name, (arch, fsdp, local) in inputs["train"].items():
        out[name] = _train_case(arch, inputs["weights"][name],
                                inputs["batch"][name], lr, fsdp, local,
                                one_rank=True)
    out["moe_block"] = _moe_case(inputs["moe_weights"], inputs["moe_x"])
    out["ef"] = _ef_case(inputs["weights"]["dense"], inputs["batch"]["dense"],
                         lr)
    out["elastic"] = _elastic_case(inputs["weights"]["dense"],
                                   inputs["elastic_batches"], lr,
                                   inputs["ckpt_root"])
    out["driver"] = _driver_case(inputs["driver_argv"])
    return out
