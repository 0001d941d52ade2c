"""Sharded training on 4 gloo CPU ranks against the reference's sharded
step (4 virtual devices) and against the port's own one-rank step.

One group of 4 ranks runs every case of
``torch_sharded_cases.sharded_train_cases`` once (a 120 s limit, so a
hang fails instead of stalling the suite), while one subprocess runs the
reference's jitted steps; both start from the same numpy-seeded float32
weights and batches (``params_from_numpy`` on the port's side):

* one train step on ``(data=2, model=2)`` under ``auto_rules`` of qwen3
  (dense), gemma3 (``cfg.fsdp``: FSDP rules, ``embed`` over ``data``)
  and olmoe (``moe_impl="local"``, ``capacity_factor = n_experts`` as the
  reference's own test sets it): the loss, the gradient norm and the
  updated parameters against the reference's GSPMD step, and against the
  port's one-rank step on the whole tensors;
* ``moe_block_local`` against the one-device block within 0.02 (the
  reference's ``test_optimized_paths.py`` bound), with finite gradients;
* the error-feedback step on ``(pod=2, data=2)`` (``with_error_feedback``:
  replicated parameters, a quarter of the batch per rank) against the
  reference's pod-decoupled ``shard_map`` step;
* elastic restore: a checkpoint written by one rank after a one-device
  step, restored onto the 4-rank mesh, gives the uninterrupted run's next
  step;
* ``launch/train.py --model-parallel 2`` trains (the loss falls) and
  ``--model-parallel 3`` fails as the reference's mesh construction does.

Tolerances (float32 weights; the reference's CPU backend fuses and
reorders float32 reductions, GSPMD sums partial products in another
order): the loss to 1e-5, the gradient norm to 1e-4 relative, each
updated parameter within 2.05·lr (AdamW's first step moves a weight by
lr·g/(|g| + eps), about ±lr, so a near-zero gradient may move it either
way) with at most 0.5% of the elements off by more than 1e-5. olmoe's
combine sums over ``model`` in bfloat16 in both packages (the reference's
``psum`` of bf16): the loss to 1e-4, the gradient norm to 1e-2 relative,
and against the port's one-rank block (which never rounds to bfloat16
there) 2% of the elements may move apart (``MOE_ONE_RANK_MOVED``).
"""
import os
import pickle
import subprocess
import sys
import tempfile
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import random_lm_batch
from repro_torch.launch.mesh import launch_ranks
from repro_torch.models import get_model
from repro_torch.models import moe as M
from torch_families import leaves
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = 120
B, S, LR = 4, 32, 1e-3
#: name -> (arch, cfg.fsdp, local MoE dispatch)
TRAIN = {"dense": ("qwen3-1.7b", False, False),
         "fsdp": ("gemma3-4b", True, False),
         "moe": ("olmoe-1b-7b", False, True)}
#: name -> (loss, relative gradient norm, share of the elements moved by
#: more than 1e-5)
TOL = {"dense": (1e-5, 1e-4, 0.005), "fsdp": (1e-5, 1e-4, 0.005),
       "moe": (1e-4, 1e-2, 0.005)}
#: the local MoE dispatch against the one-rank (global) block: the local
#: combine rounds each layer's output to bfloat16 for the wire (0.95% of
#: the elements moved, measured)
MOE_ONE_RANK_MOVED = 0.02


def _weights(specs, seed):
    """float32 numpy weights of a ParamSpec tree, drawn per leaf in
    sorted-key order (normal inits at the spec's scale)."""
    rng = np.random.default_rng(seed)
    out = {}
    for path, s in leaves(specs):
        if s.init == "zeros":
            w = np.zeros(s.shape, np.float32)
        elif s.init == "ones":
            w = np.ones(s.shape, np.float32)
        else:
            scale = (s.shape[-1] ** -0.5 if s.init == "scaled"
                     else s.init_scale)
            w = (rng.normal(0, 1, s.shape) * scale).astype(np.float32)
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = w
    return out


def _cfg(arch, fsdp, local):
    import dataclasses
    cfg = reduced_config(get_config(arch))
    if fsdp:
        cfg = dataclasses.replace(cfg, fsdp=True)
    if local:
        cfg = dataclasses.replace(cfg, moe_impl="local",
                                  capacity_factor=float(cfg.n_experts))
    return cfg


REF = textwrap.dedent("""
    import dataclasses, pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.configs.base import get_config, reduced_config
    from repro.distributed.sharding import param_shardings
    from repro.models import auto_rules, get_model
    from repro.models.layers import ShardCtx
    from repro.train.optimizer import make_optimizer
    from repro.train.train_step import make_train_step, with_error_feedback
    with open(sys.argv[1], "rb") as f:
        inp = pickle.load(f)
    lr = inp["lr"]
    tree = jax.tree_util.tree_map
    out = {}

    def cfg_of(arch, fsdp, local):
        cfg = reduced_config(get_config(arch))
        if fsdp:
            cfg = dataclasses.replace(cfg, fsdp=True)
        if local:
            cfg = dataclasses.replace(cfg, moe_impl="local",
                                      capacity_factor=float(cfg.n_experts))
        return cfg

    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    mesh = Mesh(devs, ("data", "model"))
    for name, (arch, fsdp, local) in inp["train"].items():
        cfg = cfg_of(arch, fsdp, local)
        rules = auto_rules(cfg, mesh)
        specs = get_model(cfg.family).param_specs(cfg)
        params = jax.device_put(tree(jnp.asarray, inp["weights"][name]),
                                param_shardings(specs, mesh, rules))
        opt = make_optimizer(cfg.optimizer, lr=lr)
        step = jax.jit(make_train_step(cfg, optimizer=opt,
                                       ctx=ShardCtx(mesh, rules)))
        batch = {k: jnp.asarray(v) for k, v in inp["batch"][name].items()}
        new, st, m = step(params, opt.init(params), batch,
                          jnp.asarray(0, jnp.int32))
        out[name] = {"loss": float(m["loss"]),
                     "grad_norm": float(m["grad_norm"]),
                     "params": tree(lambda a: np.asarray(a, np.float32), new)}

    # the pod-decoupled error-feedback step (launch/specs.py's wrapper)
    mesh2 = Mesh(devs, ("pod", "data"))
    cfg = cfg_of("qwen3-1.7b", False, False)
    opt = make_optimizer(cfg.optimizer, lr=lr)
    ef_opt, hook = with_error_feedback(opt, 2)
    inner = make_train_step(cfg, optimizer=ef_opt, grad_compress=hook)
    weights = tree(jnp.asarray, inp["weights"]["dense"])
    ef0 = tree(lambda w: jnp.zeros((4, (w.size + 1) // 2), jnp.float32),
               weights)

    def body(params, ef, batch):
        state = {"opt": opt.init(params), "ef": tree(lambda e: e[0], ef)}
        new, st, m = inner(params, state, batch, jnp.asarray(0, jnp.int32))
        return (new, tree(lambda e: e[None], st["ef"]), m["loss"][None],
                m["grad_norm"][None])

    rep, sh = P(), P(("pod", "data"))
    fn = jax.jit(shard_map(
        body, mesh=mesh2, axis_names=frozenset({"pod", "data"}),
        in_specs=(tree(lambda _: rep, weights), tree(lambda _: sh, ef0),
                  {k: sh for k in inp["batch"]["dense"]}),
        out_specs=(tree(lambda _: rep, weights), tree(lambda _: sh, ef0),
                   sh, sh), check_vma=False))
    new, ef, loss, gn = fn(weights, ef0, {k: jnp.asarray(v) for k, v in
                                          inp["batch"]["dense"].items()})
    out["ef"] = {"params": tree(lambda a: np.asarray(a, np.float32), new),
                 "ef": tree(np.asarray, ef), "loss": np.asarray(loss),
                 "grad_norm": np.asarray(gn)}
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
    print("OK")
""")


@pytest.fixture(scope="module")
def runs():
    weights, batches = {}, {}
    for i, (name, (arch, fsdp, local)) in enumerate(TRAIN.items()):
        cfg = _cfg(arch, fsdp, local)
        weights[name] = _weights(get_model(cfg.family).param_specs(cfg), i)
        batches[name] = random_lm_batch(np.random.default_rng(10 + i), cfg,
                                        B, S)
    moe_cfg = _cfg("olmoe-1b-7b", False, True)
    inputs = {"lr": LR, "train": TRAIN, "weights": weights,
              "batch": batches,
              "moe_weights": _weights(M.moe_mlp_specs(moe_cfg), 7),
              "moe_x": np.random.default_rng(8).normal(
                  0, 1, (B, S, moe_cfg.d_model)).astype(np.float32),
              "elastic_batches": [random_lm_batch(
                  np.random.default_rng(20 + i),
                  _cfg(*TRAIN["dense"]), B, S) for i in range(2)],
              "driver_argv": ["--arch", "qwen3-1.7b", "--reduced",
                              "--steps", "6", "--batch", "4", "--seq", "32",
                              "--device", "cpu"]}
    with tempfile.TemporaryDirectory(prefix="sharded_train_") as tmp:
        inputs["ckpt_root"] = os.path.join(tmp, "ckpt")
        inp, outp = os.path.join(tmp, "in.pkl"), os.path.join(tmp, "out.pkl")
        with open(inp, "wb") as f:
            pickle.dump({k: inputs[k] for k in ("lr", "train", "weights",
                                                "batch")}, f)
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.path.join(REPO, "src")
        proc = subprocess.Popen([sys.executable, "-c", REF, inp, outp],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        from torch_sharded_cases import sharded_train_cases
        ranks = launch_ranks(sharded_train_cases, 4, device="cpu",
                             timeout=GROUP_TIMEOUT, args=(inputs,))
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        with open(outp, "rb") as f:
            ref = pickle.load(f)
    return {"ranks": ranks, "ref": ref}


def _check_params(got, want, what, moved_share=0.005):
    moved = total = 0
    for (path, a), (_, b) in zip(leaves(got), leaves(want)):
        d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
        assert d.max() <= 2.05 * LR, (what, path, d.max())
        moved += int((d > 1e-5).sum())
        total += d.size
    assert moved <= moved_share * total, (what, moved, total)


def _check_step(got, want, name, what, moved_share=None):
    loss_tol, gn_tol, share = TOL[name]
    assert abs(got["loss"] - want["loss"]) <= loss_tol, what
    assert abs(got["grad_norm"] - want["grad_norm"]) <= \
        gn_tol * want["grad_norm"], what
    _check_params(got["params"], want["params"], what,
                  share if moved_share is None else moved_share)


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_sharded_step_equals_the_reference(runs, name):
    for r, rank in enumerate(runs["ranks"]):
        _check_step(rank[name]["sharded"], runs["ref"][name], name,
                    f"{name} rank {r}")


@pytest.mark.parametrize("name", sorted(TRAIN))
def test_sharded_step_equals_the_one_rank_step(runs, name):
    rank0 = runs["ranks"][0][name]
    _check_step(rank0["sharded"], rank0["one_rank"], name, name,
                MOE_ONE_RANK_MOVED if name == "moe" else None)
    # every rank holds the same parameters after the step
    for rank in runs["ranks"][1:]:
        for (path, a), (_, b) in zip(leaves(rank[name]["sharded"]["params"]),
                                     leaves(rank0["sharded"]["params"])):
            np.testing.assert_array_equal(a, b, err_msg=str(path))


def test_rules_place_the_parameters(runs):
    # qwen3's 4 q heads over model=2; gemma3's embed dim over data (FSDP)
    got = runs["ranks"][0]
    assert got["dense"]["placements"]["wq"] == \
        "(Replicate(), Shard(dim=2))"
    assert got["dense"]["placements"]["embedding"] == \
        "(Replicate(), Shard(dim=0))"
    assert got["fsdp"]["placements"]["wq"] == \
        "(Shard(dim=1), Shard(dim=2))"


def test_local_moe_against_the_global_block(runs):
    for rank in runs["ranks"]:
        moe = rank["moe_block"]
        assert np.abs(moe["local"] - moe["global"]).max() <= 0.02
        assert moe["grads_finite"]
        assert all(v > 0 for v in moe["grad_norms"].values())


def test_error_feedback_step_equals_the_reference(runs):
    ref = runs["ref"]["ef"]
    for r, rank in enumerate(runs["ranks"]):
        ef = rank["ef"]
        assert abs(ef["loss"] - float(ref["loss"][r])) <= 1e-5, r
        assert abs(ef["grad_norm"] - float(ref["grad_norm"][r])) <= \
            1e-4 * float(ref["grad_norm"][r]), r
        _check_params(ef["params"], ref["params"], f"ef rank {r}")
        for (path, a), (_, b) in zip(leaves(ef["ef"]), leaves(ref["ef"])):
            # the residual of one quantization step (|e| <= scale / 2):
            # the same in both packages but where a value sits on a
            # rounding boundary and moves by one scale step
            bound = 1e-6 + 2.05 * np.abs(b[r]).max()
            assert np.abs(a - b[r]).max() <= bound, (r, path)


def test_elastic_restore_continues_the_run(runs):
    for rank in runs["ranks"]:
        el = rank["elastic"]
        assert el["placements_kept"]
        assert el["shard_shape"][2] == \
            reduced_config(get_config("qwen3-1.7b")).d_ff // 2
    want = runs["ranks"][0]["elastic"]["uninterrupted"]
    for rank in runs["ranks"]:
        _check_step(rank["elastic"]["restored"], want, "dense", "elastic")


def test_driver_trains_with_model_parallel(runs):
    out = runs["ranks"][0]["driver"]
    assert "loss decreased" in out["stdout"], out["stdout"]
    assert "[mapsdi]" in out["stdout"]
    # the other ranks print nothing
    assert runs["ranks"][1]["driver"]["stdout"] == ""
    for rank in runs["ranks"]:
        assert "need 3 ranks" in rank["driver"]["refused"]
