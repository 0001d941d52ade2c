"""Port of the train step (``train/train_step.py`` and the models'
training route, ``apply(..., train=True)``) for the dense, MoE and VLM
families: one step of each architecture's reduced config against the
reference's jitted ``make_train_step`` (``tests/torch_train.py`` states
the cases and tolerances), a microbatched step against the reference's,
and, for all ten architectures, the three remat modes and the
forward-only loss against the differentiable one.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ARCH_IDS
from repro_torch.data.pipeline import random_lm_batch
from repro_torch.distributed.sharding import init_params
from repro_torch.models import get_model
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.train_step import (make_grad_loss_fn, make_loss_fn,
                                          value_and_grad)
from torch_parity import isolated_plan_caches
from torch_train import B, S, check_step, port_step, reference_step, rel

torch.set_num_threads(1)

#: (arch, weights' dtype) of the step cases; the rwkv, hybrid and encdec
#: families' are in tests/test_torch_train_step_families.py
STEP_CASES = [("qwen3_1p7b", "float32"), ("qwen3_1p7b", "bfloat16"),
              ("internlm2_20b", "float32"), ("gemma3_4b", "float32"),
              ("mistral_large_123b", "float32"), ("olmoe_1b_7b", "float32"),
              ("kimi_k2_1t_a32b", "float32"), ("internvl2_2b", "float32")]


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


@pytest.fixture(scope="module")
def reference():
    """The reference's steps, each traced and compiled once per module."""
    return {}


@pytest.mark.parametrize("arch,dtype", STEP_CASES)
def test_one_train_step_matches_the_reference(arch, dtype, reference):
    ref = reference_step(reference, arch, dtype)
    params, out = port_step(arch, ref)
    check_step(ref, params, out, dtype)


def test_microbatched_step_matches_the_reference(reference):
    ref = reference_step(reference, "qwen3_1p7b", "float32", n_mb=2)
    params, out = port_step("qwen3_1p7b", ref, n_mb=2)
    check_step(ref, params, out, "float32")
    # the uneven loss mask makes the split observable: the unsplit step
    # on the same batch has other first moments
    _, unsplit = port_step("qwen3_1p7b", ref, n_mb=1)
    mu = ("mu", "embed", "embedding")
    assert rel(unsplit[1]["mu"]["embed"]["embedding"].numpy(),
               ref["state"][mu]) > 0.1


def _f32(tree):
    if isinstance(tree, dict):
        return {k: _f32(v) for k, v in tree.items()}
    return tree.float() if tree.is_floating_point() else tree


def _f32_setup(arch):
    cfg = reduced_config(get_config(arch))
    params = init_params(get_model(cfg.family).param_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in random_lm_batch(
        np.random.default_rng(1), cfg, B, S).items()}
    return cfg, _f32(params), batch


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_modes_give_the_same_gradients(arch):
    # the backward recomputes the same float32 forward on the CPU, so the
    # gradients are equal bit for bit
    base, params, batch = _f32_setup(arch)
    grads = {}
    for mode in ("none", "dots", "full"):
        cfg = dataclasses.replace(base, remat=mode)
        loss, g = value_and_grad(make_grad_loss_fn(cfg), params, batch)
        grads[mode] = (float(loss), list(tree_leaves(g)))
    for mode in ("dots", "full"):
        assert grads[mode][0] == grads["none"][0], mode
        for (p, a), (_, b) in zip(grads[mode][1], grads["none"][1]):
            assert torch.equal(a, b), (mode, p)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_forward_only_loss_equals_the_differentiable_loss(arch):
    # the forward route (flash attention's plain version on the CPU) and
    # the training route (blockwise) on float32 weights: float32 rounding
    cfg, params, batch = _f32_setup(arch)
    fwd = make_loss_fn(cfg)(params, batch)
    tracked = {k: v for k, v in params.items()}
    tracked["embed"] = {k: v.detach().requires_grad_(True)
                        for k, v in params["embed"].items()}
    diff = make_grad_loss_fn(cfg)(tracked, batch)
    assert fwd.dtype == diff.dtype == torch.float32
    assert not fwd.requires_grad and diff.requires_grad
    assert abs(float(fwd) - float(diff.detach())) <= 1e-5
