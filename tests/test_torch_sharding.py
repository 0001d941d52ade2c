"""The port's logical-axis sharding against the reference's.

* every parameter and cache leaf of the ten architectures (full size:
  spec construction only) carries the reference's logical axes;
* ``AxisRules.spec_for`` gives the reference's ``PartitionSpec`` entries
  for every such leaf under ``DEFAULT_RULES``, ``FSDP_RULES`` and
  ``auto_rules`` on shape-only meshes ``(1,1)``, ``(2,2)``, ``(1,4)``,
  ``(16,16)`` of ``(data, model)`` and ``(2,16,16)`` of ``(pod, data,
  model)``, each with and without a ``ShapeSpec``;
* ``auto_rules``' tables equal the reference's exactly;
* the rule table's placements, a one-rank mesh's ``init_params`` equal to
  the one-device draw bit for bit, and the ``Mesh`` of several axes.

``auto_rules`` reads only ``mesh.shape``, so both packages get the same
shape-only mesh. No Hypothesis, no ranks.
"""
import itertools
import types

import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.distributed import sharding as JS
from repro.models import auto_rules as j_auto_rules
from repro.models import get_model as j_get_model
from repro_torch.configs import get_config, reduced_config
from repro_torch.configs.base import ARCH_IDS
from repro_torch.distributed import sharding as TS
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import auto_rules, get_model
from torch_families import leaves
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield

ARCHS = tuple(i.replace("_", "-") for i in ARCH_IDS)
MESHES = {
    "1x1": {"data": 1, "model": 1},
    "2x2": {"data": 2, "model": 2},
    "1x4": {"data": 1, "model": 4},
    "16x16": {"data": 16, "model": 16},
    "pod2x16x16": {"pod": 2, "data": 16, "model": 16},
}
#: (global batch, seq len) of the ShapeSpec cases: one that every batch
#: axis divides, one that only ``data`` of 16 does, one (B = 1) that none
#: does
SHAPES = {"none": None, "b256": (256, 4096), "b16": (16, 2048),
          "b1": (1, 4096)}


def _shape_only(axes):
    return types.SimpleNamespace(shape=dict(axes))


def _specs(pkg_get_config, get, arch, with_cache):
    cfg = pkg_get_config(arch)
    model = get(cfg.family)
    tree = {"params": model.param_specs(cfg)}
    if with_cache:
        tree["cache"] = model.cache_specs(cfg, 8, 64)
    return cfg, tree


def _leaf_pairs(arch):
    jcfg, jtree = _specs(j_get_config, j_get_model, arch, True)
    cfg, ttree = _specs(get_config, get_model, arch, True)
    jl, tl = list(leaves(jtree)), list(leaves(ttree))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    return jcfg, cfg, [(p, j, t) for (p, j), (_, t) in zip(jl, tl)]


@pytest.mark.parametrize("arch", ARCHS)
def test_logical_axes_equal_the_reference(arch):
    _, _, pairs = _leaf_pairs(arch)
    for path, j, t in pairs:
        assert isinstance(t, TS.ParamSpec), path
        assert t.logical_axes == tuple(j.logical_axes), path
        assert t.shape == tuple(j.shape), path


def test_paramspec_checks_its_axes():
    with pytest.raises(ValueError):
        TS.ParamSpec((4, 8), ("embed",))
    assert TS.ParamSpec((), ()).logical_axes == ()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_spec_for_equals_the_reference(arch, mesh):
    jcfg, cfg, pairs = _leaf_pairs(arch)
    shape_mesh = _shape_only(MESHES[mesh])
    tables = [(JS.DEFAULT_RULES, TS.DEFAULT_RULES),
              (JS.FSDP_RULES, TS.FSDP_RULES)]
    for name, shape in SHAPES.items():
        jshape = tshape = None
        if shape is not None:
            jshape = JShapeSpec(name, shape[1], shape[0], "train")
            tshape = types.SimpleNamespace(global_batch=shape[0],
                                           seq_len=shape[1])
        j_rules = j_auto_rules(jcfg, shape_mesh, jshape)
        t_rules = auto_rules(cfg, shape_mesh, tshape)
        # the tables themselves, entry for entry
        assert t_rules.rules == tuple(
            (lg, tuple(m) if isinstance(m, tuple) else m)
            for lg, m in j_rules.rules), name
        tables.append((j_rules, t_rules))
    for (j_rules, t_rules), (path, j, t) in itertools.product(tables, pairs):
        assert t_rules.spec_for(t) == tuple(j_rules.spec_for(j)), path
    # activation axes too (the seven constrain sites' tuples)
    for axes in (("batch", "seq", "heads", "head_dim"),
                 ("batch", "seq_sp", "embed"), ("batch", "seq", "vocab"),
                 ("batch", "kv_heads", "kv_seq", "head_dim"),
                 ("batch", "expert", None, "expert_ffn"), ("batch",)):
        for j_rules, t_rules in tables:
            assert t_rules.spec_for(axes) == tuple(j_rules.spec_for(axes))


def test_rule_tables_and_overrides():
    assert TS.DEFAULT_RULES.rules == JS.DEFAULT_RULES.rules
    assert TS.FSDP_RULES.rules == JS.FSDP_RULES.rules
    got = TS.make_rules(fsdp=True, overrides=[("ffn", None)])
    want = JS.make_rules(fsdp=True, overrides=[("ffn", None)])
    assert got.rules == want.rules
    assert TS.make_rules().candidates("batch") == \
        JS.make_rules().candidates("batch")
    # the first unused mesh axes win; a used axis falls through
    rules = TS.AxisRules((("a", "model"), ("b", "model"), ("b", "data")))
    assert rules.spec_for(("a", "b")) == ("model", "data")
    assert rules.spec_for(("b", "a")) == ("model",)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(axis_names=("pod", "data", "model"))
    s = TS.Sharding(mesh, (("pod", "data"), None, "model"))
    assert s.placements == (Shard(0), Shard(0), Shard(2))
    assert TS.Sharding(mesh, ()).placements == (Replicate(),) * 3


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b",
                                  "zamba2-2.7b"])
def test_one_rank_mesh_init_equals_the_one_device_draw(arch):
    cfg = reduced_config(get_config(arch))
    specs = get_model(cfg.family).param_specs(cfg)
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    rules = auto_rules(cfg, mesh)
    sharded = TS.init_params(specs, torch.Generator().manual_seed(3), "cpu",
                             mesh=mesh, rules=rules)
    plain = TS.init_params(specs, torch.Generator().manual_seed(3), "cpu")
    for (path, a), (_, b) in zip(leaves(sharded), leaves(plain)):
        assert a.placements == TS.Sharding(
            mesh, rules.spec_for(_at(specs, path))).placements, path
        assert torch.equal(a.full_tensor(), b), path


def test_shard_to_keeps_this_ranks_block():
    # a (1, 1) mesh keeps the whole tensor whatever the placements
    from torch.distributed.tensor import Shard
    mesh = make_mesh((1, 1), ("data", "model"), device="cpu")
    full = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    d = TS.shard_to(full, mesh.device_mesh, (Shard(0), Shard(1)))
    assert torch.equal(d.to_local(), full)
    assert tuple(d.shape) == (4, 6)
    with pytest.raises(ValueError):
        TS.init_params({"w": TS.ParamSpec((4,), ("embed",))},
                       torch.Generator(), "cpu", mesh=mesh)


def test_several_axis_mesh_in_one_process():
    mesh = make_mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")
    assert mesh.coords == {"pod": 0, "data": 0, "model": 0}
    assert mesh.group_for("model") is mesh.group
    assert mesh.device_mesh.mesh_dim_names == ("pod", "data", "model")
    # one-axis meshes keep their plan-store identity
    one = make_mesh((1,), ("data",), device="cpu")
    assert one.signature() == ((("data", 1),), "gloo")


def _at(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_stacked_leaves_never_shard_their_layer_axis():
    cfg = get_config("qwen3-1.7b")
    specs = get_model(cfg.family).param_specs(cfg)
    rules = auto_rules(cfg, _shape_only(MESHES["16x16"]))
    wq = specs["layers"]["attn"]["wq"]
    assert wq.logical_axes[0] == "layers"
    assert rules.spec_for(wq) == (None, None, "model")
