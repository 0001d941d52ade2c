"""Shared parity checks of the train step (``tests/test_torch_train_step
.py`` and ``tests/test_torch_train_step_families.py``): one step of an
architecture's ``reduced_config`` (B = 2, S = 64, as ``tests/test_archs.py``
runs it) against the reference's jitted ``make_train_step`` on the same
weights (``init_params(..., PRNGKey(0))`` carried over by
``params_from_numpy``), the same ``random_lm_batch`` and the
architecture's optimizer at lr 1e-3.

Weights are float32 for nine architectures: both packages then compute
the same function, so what differs is float32 rounding. whisper runs on
bf16 weights (the reference's encoder casts its input to bf16 and cannot
run float32 weights through its scan), and qwen3 also on bf16 weights,
the models' own dtype. Tolerances, with reasons and the largest values
measured on these cases:

* float32: the loss to 1e-5 (2e-7 measured), the gradient norm to 1e-5
  relative (8e-7), the optimizer's moments (AdamW's ``mu`` and ``nu``,
  Adafactor's factored ``v``) to 1e-3 in relative L2 norm per leaf
  (4.3e-5: rwkv6's);
* bf16: each package rounds other intermediates (the reference's CPU
  backend keeps fused elementwise chains in float32): the loss to 2e-3
  (4.5e-4), the gradient norm to 2% (0.3%), the moments to 0.15 in
  relative L2 (0.077: whisper's);
* the parameters after the step (AdamW's float32 master weights are the
  same numbers), every element: AdamW's first step moves a weight by
  lr·g/(|g| + eps), about ±lr, so where a gradient is near zero the two
  packages may move it opposite ways: within 2.05·lr, plus one bf16 step
  of the weight for bf16 weights. At most 0.5% (float32; 0.07% measured)
  and 10% (bf16; 6.6%) of the elements differ by more than 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs.base import get_config as j_get_config
from repro.configs.base import reduced_config as j_reduced_config
from repro.data.pipeline import random_lm_batch as j_random_lm_batch
from repro.distributed.sharding import init_params as j_init_params
from repro.models import get_model as j_get_model
from repro.train.optimizer import make_optimizer as j_make_optimizer
from repro.train.train_step import make_train_step as j_make_train_step
from repro_torch.configs import get_config, reduced_config
from repro_torch.data.pipeline import random_lm_batch
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.optimizer import make_optimizer, tree_leaves
from repro_torch.train.train_step import make_train_step

B, S, LR = 2, 64, 1e-3
TOL = {"float32": {"loss": 1e-5, "gnorm": 1e-5, "state": 1e-3,
                   "moved_share": 0.005},
       "bfloat16": {"loss": 2e-3, "gnorm": 0.02, "state": 0.15,
                    "moved_share": 0.10}}


def reference_step(memo, arch, dtype, n_mb=1):
    """The reference's step for (arch, weights' dtype, microbatches),
    traced and compiled once per ``memo`` (a module fixture's dict)."""
    key = (arch, dtype, n_mb)
    if key not in memo:
        jcfg = j_reduced_config(j_get_config(arch))
        specs = j_get_model(jcfg.family).param_specs(jcfg)
        params = jax.jit(lambda k: j_init_params(specs, k))(
            jax.random.PRNGKey(0))
        if dtype == "float32":
            params = jax.tree_util.tree_map(
                lambda a: a.astype(jnp.float32), params)
        batch = j_random_lm_batch(np.random.default_rng(0), jcfg, B, S)
        if n_mb > 1:
            batch["loss_mask"] = uneven_mask(batch["labels"].shape)
        opt = j_make_optimizer(jcfg.optimizer, lr=LR)
        state = opt.init(params)
        weights = jax.tree_util.tree_map(np.asarray, params)
        step = jax.jit(j_make_train_step(jcfg, optimizer=opt,
                                         n_microbatches=n_mb))
        new_params, new_state, metrics = step(
            params, state, {k: jnp.asarray(v) for k, v in batch.items()},
            jnp.asarray(0, jnp.int32))
        memo[key] = {
            "weights": weights, "batch": batch,
            "loss": float(metrics["loss"]),
            "grad_norm": float(metrics["grad_norm"]),
            "params": _flat(new_params), "state": _flat(new_state)}
    return memo[key]


def uneven_mask(shape):
    """A loss mask that counts 4x the tokens in the first microbatch that
    it counts in the second: a microbatched loss (the mean of the
    microbatches' means) then weighs the tokens otherwise than the
    unsplit one, and its gradient differs."""
    mask = np.ones(shape, np.float32)
    mask[shape[0] // 2:, : 3 * shape[1] // 4] = 0.0
    return mask


def _flat(tree):
    """{key path: float32 numpy leaf} of a JAX tree of dicts."""
    return {tuple(k.key for k in path): np.asarray(leaf, np.float32)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def rel(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def port_step(arch, ref, n_mb=1):
    """(params, (new params, state, metrics)) of the port's step on the
    reference's weights and batch."""
    cfg = reduced_config(get_config(arch))
    params = params_from_numpy(ref["weights"], device="cpu")
    own = random_lm_batch(np.random.default_rng(0), cfg, B, S)
    for k, v in own.items():                   # the same numpy batch
        assert np.array_equal(ref["batch"][k], v), k
    batch = {k: torch.from_numpy(v) for k, v in ref["batch"].items()}
    opt = make_optimizer(cfg.optimizer, lr=LR)
    step = make_train_step(cfg, optimizer=opt, n_microbatches=n_mb)
    return params, step(params, opt.init(params), batch, 0)


def check_step(ref, params, out, dtype):
    tol = TOL[dtype]
    new_params, state, metrics = out
    assert metrics["loss"].dtype == torch.float32
    assert np.isfinite(float(metrics["loss"])) and float(metrics["loss"]) > 0
    assert abs(float(metrics["loss"]) - ref["loss"]) <= tol["loss"]
    assert abs(float(metrics["grad_norm"]) - ref["grad_norm"]) <= \
        tol["gnorm"] * ref["grad_norm"]
    got_state = {p: t.numpy() for p, t in tree_leaves(state)}
    assert sorted(got_state) == sorted(ref["state"])
    for path, want in ref["state"].items():
        if path[0] != "master":         # the parameters, checked below
            assert rel(got_state[path], want) <= tol["state"], path
    before = dict(tree_leaves(params))
    moved = total = 0
    for path, t in tree_leaves(new_params):
        assert t.dtype == before[path].dtype, path
        assert t.shape == before[path].shape, path
        got, want = t.float().numpy(), ref["params"][path]
        if t.dtype == torch.float32 and ("master",) + path in got_state:
            assert np.array_equal(got_state[("master",) + path], got), path
        bound = 2.05 * LR + (2.0 ** -8 * np.abs(want)
                             if t.dtype == torch.bfloat16 else 0.0)
        diff = np.abs(got - want)
        assert (diff <= bound).all(), (path, float(diff.max()))
        moved += int((diff > 1e-5).sum())
        total += diff.size
    assert moved <= tol["moved_share"] * total, (moved, total)
