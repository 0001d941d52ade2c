"""Port of the optimizers (``train/optimizer.py``): AdamW and Adafactor
against the JAX package's over three steps from the same numpy
parameters, gradients and state; ``clip_by_global_norm``; the
weight-decay mask over every architecture's reduced parameter tree.

Tolerances, with reasons: float32 parameters and state agree to 1e-6
relative, elementwise and to the leaf's largest magnitude (both packages
run the same float32 elementwise arithmetic; a power or a square root
may differ in its last bit, 6e-8 relative, and ``w - lr * upd`` near zero
keeps that error in absolute terms: 1.4e-9 on a weight of 3e-3); bf16
parameters come back rounded from the same float32 master or update, so
they agree to one bf16 step (2**-7 relative) where the float32 values
straddle a rounding boundary, and are equal elsewhere.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ARCH_IDS
from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.models import get_model as j_get_model
from repro.train import optimizer as jopt
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import get_model
from repro_torch.train import optimizer as topt
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

F32_RTOL = 1e-6
BF16_STEP = 2.0 ** -7
STEPS = 3


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _tree(rng, dtype):
    """A parameter tree with every kind of leaf the mask tells apart: a
    stacked matrix, an embedding, norms (``ln_*``, ``*_norm``), a bias
    (``*_b``) and a 1-D vector, in ``dtype`` where the models keep bf16
    and float32 where they keep float32."""
    def n(*shape, dt=dtype):
        return rng.normal(0, 0.5, shape).astype(np.float32).astype(dt)
    f32 = np.float32
    return {"embed": {"embedding": n(16, 8)},
            "layers": {"attn": {"wq": n(2, 8, 3, 4), "q_norm": n(4, dt=f32)},
                       "ln_attn": n(2, 8, dt=f32),
                       "decay_b": n(2, 5, 8),
                       "mu_r": n(2, 8, dt=f32)},
            "ln_f": n(8, dt=f32)}


def _to_jax(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _to_torch(tree):
    return topt.tree_map(lambda a: torch.from_numpy(
        np.asarray(a, np.float32)).to(torch.bfloat16)
        if a.dtype.name == "bfloat16" else torch.from_numpy(np.array(a)),
        tree)


def _pairs(jtree, ttree):
    """(path, reference leaf as float32 numpy, port leaf as float32 numpy,
    dtype name) over both trees, in JAX's flattening order."""
    jl = jax.tree_util.tree_flatten_with_path(jtree)[0]
    tl = list(topt.tree_leaves(ttree))
    assert [tuple(k.key for k in p) for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        assert str(t.dtype).split(".")[-1] == j.dtype.name, path
        yield path, np.asarray(j, np.float32), t.float().numpy(), j.dtype.name


def _assert_close(jtree, ttree, what):
    for path, j, t, dtype in _pairs(jtree, ttree):
        if dtype == "bfloat16":
            np.testing.assert_allclose(t, j, rtol=BF16_STEP, atol=0,
                                       err_msg=f"{what} {path}")
        else:
            np.testing.assert_allclose(
                t, j, rtol=F32_RTOL, atol=F32_RTOL * np.abs(j).max(),
                err_msg=f"{what} {path}")


def _optimizers(name):
    if name == "adamw":
        return jopt.adamw(lr=1e-2), topt.adamw(lr=1e-2)
    # weight decay on, so the mask is exercised under Adafactor too
    return (jopt.adafactor(lr=1e-2, weight_decay=0.1),
            topt.adafactor(lr=1e-2, weight_decay=0.1))


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_updates_match_the_reference_over_three_steps(name, dtype):
    rng = np.random.default_rng(0)
    np_dtype = np.float32 if dtype == "float32" else jnp.bfloat16
    params = _tree(rng, np_dtype)
    jo, to = _optimizers(name)
    jp, tp = _to_jax(params), _to_torch(params)
    js, ts = jo.init(jp), to.init(tp)
    _assert_close(js, ts, "init state")
    update = jax.jit(jo.update)
    for step in range(STEPS):
        # gradients in the parameters' dtypes; the third step's are large
        # enough that the clip scales them
        scale = 0.1 if step < 2 else 10.0
        grads = jax.tree_util.tree_map(
            lambda a: (rng.normal(0, scale, a.shape).astype(np.float32)
                       .astype(a.dtype)), params)
        jp, js, jn = update(_to_jax(grads), js, jp,
                            jnp.asarray(step, jnp.int32))
        tp, ts, tn = to.update(_to_torch(grads), ts, tp, step)
        np.testing.assert_allclose(float(tn), float(jn), rtol=F32_RTOL)
        _assert_close(jp, tp, f"params after step {step}")
        _assert_close(js, ts, f"state after step {step}")
    assert float(tn) > 1.0        # the last step was clipped


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_by_global_norm_matches_the_reference(max_norm):
    grads = _tree(np.random.default_rng(1), jnp.bfloat16)
    jg, jn = jopt.clip_by_global_norm(_to_jax(grads), max_norm)
    tg, tn = topt.clip_by_global_norm(_to_torch(grads), max_norm)
    np.testing.assert_allclose(float(tn), float(jn), rtol=F32_RTOL)
    _assert_close(jg, tg, "clipped")
    assert (float(jn) > max_norm) == (max_norm == 0.5)


#: leaves with no weight decay, per architecture's reduced tree (a
#: sample: qwen3's include its q_norm and k_norm, rwkv6's its decay_b
#: (``_b``) and ln_x_w (``ln``))
NO_DECAY = {"rwkv6_7b": 11, "qwen3_1p7b": 5, "zamba2_2p7b": 7}


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_weight_decay_mask_matches_the_reference(arch):
    jcfg = j_reduced_config(j_get_config(arch))
    cfg = reduced_config(get_config(arch))
    jspecs = j_get_model(jcfg.family).param_specs(jcfg)
    tspecs = get_model(cfg.family).param_specs(cfg)
    jl = jax.tree_util.tree_flatten_with_path(jspecs)[0]
    tl = list(topt.tree_leaves(tspecs))
    assert [tuple(k.key for k in p) for p, _ in jl] == [p for p, _ in tl]
    want = [jopt._wd_mask(p) for p, _ in jl]
    got = [topt._wd_mask(p) for p, _ in tl]
    assert got == want
    assert all(topt._path_name(p) == "/".join(str(k) for k in jp)
               for (jp, _), (p, _) in zip(jl, tl))
    if arch in NO_DECAY:
        assert got.count(False) == NO_DECAY[arch]
    if arch == "qwen3_1p7b":
        off = {p[-1] for (p, _), m in zip(tl, got) if not m}
        assert {"q_norm", "k_norm"} <= off
    if arch == "rwkv6_7b":
        off = {p[-1] for (p, _), m in zip(tl, got) if not m}
        assert {"decay_b", "ln_x_w", "ln_x_b"} <= off
        assert "decay_a" not in off


def test_make_optimizer_names():
    assert topt.make_optimizer("adamw").name == "adamw"
    assert topt.make_optimizer("adafactor", lr=1e-3).name == "adafactor"
    with pytest.raises(KeyError):
        topt.make_optimizer("sgd")
