"""The port's dry-run inputs against the reference's, on the CPU.

``repro_torch.configs.base`` (``SHAPES``, ``shape_supported``,
``microbatches``), ``repro_torch.launch.specs`` (``opt_state_specs``,
``model_param_counts``, ``build_cell``) and ``repro_torch.launch.roofline``
(``depth_points``, ``extrapolate``, ``model_flops``) held to
``repro.configs.base``, ``repro.launch.specs`` and ``repro.launch.roofline``,
exactly (tolerance 0: shapes, counts and the same float arithmetic):

* for all ten archs, every shape and data-shard count;
* rank 0's local shape and dtype of every ``build_cell`` argument leaf,
  for every supported arch x shape on the one-pod (16, 16) and the
  two-pod (2, 16, 16) mesh, and of the pod-decoupled error-feedback
  cell's tree, against the reference's per-device ``shard_shape`` — so
  the per-device argument bytes too.

Both sides run in fresh processes started together
(``tests/torch_launch_cases.py``): the reference with 512 forced host
devices, never compiled; the port on its fake 512-rank world.
"""
import json
import math
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, get_config,
                                      reduced_config)
from repro_torch.distributed.sharding import ParamSpec, init_params
from repro_torch.launch.roofline import depth_points, extrapolate, model_flops
from repro_torch.launch.specs import model_param_counts, opt_state_specs
from repro_torch.models import get_model
from repro_torch.train.optimizer import make_optimizer

from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = os.path.join(REPO, "tests", "torch_launch_cases.py")
ITEMSIZE = {"bfloat16": 2, "float32": 4, "int32": 4, "float16": 2,
            "int8": 1}


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


@pytest.fixture(scope="module")
def sides(tmp_path_factory):
    """Both sides' JSON, their processes run together."""
    tmp = tmp_path_factory.mktemp("launch_specs")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    env.pop("XLA_FLAGS", None)
    procs = {side: subprocess.Popen(
        [sys.executable, CASES, side, str(tmp / f"{side}.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for side in ("ref", "port")}
    out = {}
    for side, proc in procs.items():
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, f"{side}: {err[-3000:]}"
        with open(tmp / f"{side}.json") as f:
            out[side] = json.load(f)
    return out


def _spec_leaves(tree, path=""):
    if isinstance(tree, ParamSpec):
        return {path: [list(tree.shape), str(tree.dtype).replace("torch.",
                                                                 ""),
                       list(tree.logical_axes)]}
    out = {}
    for k in sorted(tree):
        out.update(_spec_leaves(tree[k], f"{path}[{k!r}]"))
    return out


def _bytes(leaves) -> int:
    return sum(math.prod(shape) * ITEMSIZE[dtype]
               for shape, dtype in leaves.values())


def test_shapes_equal_reference(sides):
    ref = sides["ref"]
    assert {k: [v.seq_len, v.global_batch, v.kind]
            for k, v in SHAPES.items()} == ref["shapes"]
    assert [get_config(a).name for a in ARCH_IDS] == [
        get_config(a).name for a in ref["archs"]]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shape_rules_and_counts_equal_reference(sides, arch):
    from torch_launch_cases import DATA_SHARDS
    cfg = get_config(arch)
    want = sides["ref"]["per_arch"][cfg.name]
    assert {s: cfg.shape_supported(v) for s, v in SHAPES.items()} == \
        want["supported"]
    assert {s: {str(n): cfg.microbatches(v, n) for n in DATA_SHARDS}
            for s, v in SHAPES.items()} == want["microbatches"]
    params = model_param_counts(cfg)
    assert params == want["param_counts"]
    assert list(depth_points(cfg)) == want["depth_points"]
    assert {s: {str(n): model_flops(cfg, v, n, params)
                for n in (1, 256, 512)}
            for s, v in SHAPES.items()} == want["model_flops"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_opt_state_specs_equal_reference(sides, arch):
    cfg = get_config(arch)
    specs = get_model(cfg.family).param_specs(cfg)
    for opt in ("adamw", "adafactor"):
        assert _spec_leaves(opt_state_specs(opt, specs)) == \
            sides["ref"]["per_arch"][cfg.name]["opt_specs"][opt], opt


@pytest.mark.parametrize("arch,opt", [("qwen3-1.7b", "adamw"),
                                      ("mistral-large-123b", "adafactor")])
def test_opt_state_specs_match_init(arch, opt):
    """The specs' tree, shapes and dtypes are ``make_optimizer(opt).init``'s
    (the reference's ``test_opt_state_specs_match_init_structure``)."""
    cfg = reduced_config(get_config(arch))
    specs = get_model(cfg.family).param_specs(cfg)
    params = init_params(specs, torch.Generator().manual_seed(0),
                         device="cpu")
    state = make_optimizer(opt).init(params)

    def real(tree, path=""):
        if isinstance(tree, torch.Tensor):
            return {path: [list(tree.shape), str(tree.dtype)]}
        out = {}
        for k in sorted(tree):
            out.update(real(tree[k], f"{path}[{k!r}]"))
        return out

    want = {p: [s, f"torch.{d}"] for p, (s, d, _) in
            _spec_leaves(opt_state_specs(opt, specs)).items()}
    assert real(state) == want


def test_extrapolate_equals_reference(sides):
    f0 = {"flops": 10.0, "bytes": 4.0, "coll_bytes": 3.0}
    f1 = {"flops": 18.0, "bytes": 5.0, "coll_bytes": 7.5}
    assert extrapolate(f0, f1, 4, 8, 28) == sides["ref"]["extrapolate"]


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cell_argument_shards_equal_reference(sides, arch):
    """Rank 0's local shape and dtype of every argument leaf, per
    supported shape and mesh, and the per-device argument bytes."""
    name = get_config(arch).name
    ref, port = sides["ref"]["cells"], sides["port"]["cells"]
    keys = sorted(k for k in ref if k.startswith(name + "|"))
    assert keys == sorted(k for k in port if k.startswith(name + "|"))
    assert keys
    for key in keys:
        assert port[key] == ref[key], key
        assert _bytes(port[key]) == _bytes(ref[key]) > 0


def test_error_feedback_cell_argument_shards_equal_reference(sides):
    """The pod-decoupled int8 error-feedback train step on the two-pod
    mesh: parameters and AdamW state sharded over ``model``, the EF
    buffers one shard per (pod, data) rank, the batch per rank."""
    ref, port = sides["ref"]["ef_cell"], sides["port"]["ef_cell"]
    assert port == ref
    assert any("'ef'" in p for p in port)
