"""Port of the rwkv and hybrid language models: configs, parameter specs
and initialisation, the weight converter, and ``apply`` and the loss of
``reduced_config(rwkv6-7b)`` and ``reduced_config(zamba2-2.7b)`` against
the JAX package on the same weights (``init_params(..., PRNGKey(0))``
carried over by ``params_from_numpy``) and the same numpy tokens.

The reference runs two routes: ``use_pallas=True`` (its Pallas kernels in
interpret mode where T is a chunk multiple) and its default CPU route
(the jnp forms; mamba2 keeps ``x*dt`` in float32 there, the port rounds
it to bf16 as the Pallas route does). Tolerances, with reasons:

* float32 weights (no bf16 rounding anywhere, so both routes compute
  the same function): logits to 5e-4 absolute (magnitude ~2; float32
  summation order and ``exp``/``tanh``/``log`` in each of 4 layers; 1e-4
  measured);
* bf16 weights, the models' own dtype: the port rounds every op to bf16
  as the reference's semantics say, while the reference's CPU backend
  keeps fused elementwise chains in float32. Logits agree to 3% of their
  RMS in RMS and to 8% of their largest magnitude at worst (the port's
  own bf16-versus-float32 gap is 1.9% and 6% on these inputs); the loss
  to 2e-3.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.distributed.sharding import ParamSpec as JParamSpec
from repro.distributed.sharding import init_params as j_init_params
from repro.models import get_model as j_get_model
from repro.train.train_step import make_loss_fn as j_make_loss_fn
from repro_torch.configs import get_config, reduced_config
from repro_torch.distributed.sharding import ParamSpec, init_params
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.train.train_step import make_loss_fn
from torch_parity import (BF16_MAX_FRAC, BF16_RMS_FRAC, F32_LOGIT_ATOL,
                          LOSS_ATOL, isolated_plan_caches)

torch.set_num_threads(1)

ARCHS = ("rwkv6-7b", "zamba2-2.7b")


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


@pytest.fixture(scope="module")
def reference():
    """Per arch: the reduced configs of both packages, the reference's
    bf16 weights and a memo of its outputs (each reference forward is
    traced once per module)."""
    out = {}
    for arch in ARCHS:
        jcfg = j_reduced_config(j_get_config(arch))
        model = j_get_model(jcfg.family)
        specs = model.param_specs(jcfg)
        params = jax.jit(lambda key, s=specs: j_init_params(s, key))(
            jax.random.PRNGKey(0))
        out[arch] = {"jcfg": jcfg, "cfg": reduced_config(get_config(arch)),
                     "model": model, "params": params, "memo": {}}
    return out


def _tokens(t, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, t)).astype(np.int32),
            rng.integers(0, 256, (2, t)).astype(np.int32))


def _ref_logits(ref, t, pallas, f32=False):
    key = (t, pallas, f32)
    if key not in ref["memo"]:
        params = ref["params"]
        if f32:
            params = jax.tree_util.tree_map(
                lambda a: a.astype(jnp.float32), params)
        cfg = dataclasses.replace(ref["jcfg"], use_pallas=pallas)
        ref["memo"][key] = np.asarray(
            ref["model"].apply(cfg, params, jnp.asarray(_tokens(t)[0])),
            np.float32)
    return ref["memo"][key]


def _port_params(ref, f32=False):
    tree = jax.tree_util.tree_map(np.asarray, ref["params"])
    if f32:
        tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    return params_from_numpy(tree, device="cpu")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def _rms(a):
    return float(np.sqrt(np.mean(np.square(a))))


# ---------------------------------------------------------------------------
# configs, specs, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    for j, t in ((j_get_config(arch), get_config(arch)),
                 (j_reduced_config(j_get_config(arch)),
                  reduced_config(get_config(arch)))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.vocab_padded, j.d_inner) == (t.vocab_padded, t.d_inner)


def test_other_architectures_and_families_are_queued():
    # nothing is queued any more: every architecture and family of the
    # reference resolves in the port (the other families' parity tests
    # are tests/test_torch_{dense,moe,vlm}.py)
    from repro.configs.base import ARCH_IDS as J_ARCH_IDS
    from repro.models import MODEL_FAMILIES as J_FAMILIES
    from repro_torch.configs.base import ARCH_IDS
    from repro_torch.models import MODEL_FAMILIES
    assert ARCH_IDS == J_ARCH_IDS
    for arch in ARCH_IDS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(j_get_config(arch))
    assert sorted(MODEL_FAMILIES) == sorted(J_FAMILIES)
    for family in MODEL_FAMILIES:
        assert get_model(family) is MODEL_FAMILIES[family]
    with pytest.raises(KeyError):
        get_config("no-such-arch")
    with pytest.raises(KeyError):
        get_model("no-such-family")


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_specs_match_the_reference(arch, reduced):
    jcfg, cfg = j_get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = j_reduced_config(jcfg), reduced_config(cfg)
    jspecs = j_get_model(jcfg.family).param_specs(jcfg)
    tspecs = get_model(cfg.family).param_specs(cfg)
    jl, tl = list(_leaves(jspecs)), list(_leaves(tspecs))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        assert isinstance(j, JParamSpec) and isinstance(t, ParamSpec), path
        assert (j.shape, j.init, j.init_scale) == \
            (t.shape, t.init, t.init_scale), path
        assert np.dtype(j.dtype).name == str(t.dtype).split(".")[-1], path


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_each_kind_from_the_generator(arch):
    cfg = reduced_config(get_config(arch))
    specs = get_model(cfg.family).param_specs(cfg)

    def draw():
        return init_params(specs, torch.Generator().manual_seed(0), "cpu")

    a, b = draw(), draw()
    for (path, spec), (_, x), (_, y) in zip(_leaves(specs), _leaves(a),
                                            _leaves(b)):
        assert x.shape == spec.shape and x.dtype == spec.dtype, path
        assert torch.equal(x, y), path
        if spec.init in ("zeros", "ones"):
            assert torch.equal(x, torch.full_like(
                x, 0.0 if spec.init == "zeros" else 1.0)), path
        else:
            scale = (spec.shape[-1] ** -0.5 if spec.init == "scaled"
                     else spec.init_scale)
            std = float(x.float().std())
            assert abs(std / scale - 1) < 0.15, (path, std, scale)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_round_trips_exactly(arch, reference):
    ref = reference[arch]
    tree = jax.tree_util.tree_map(np.asarray, ref["params"])
    port = params_from_numpy(tree, device="cpu")
    n = 0
    for (path, a), (_, t) in zip(_leaves(tree), _leaves(port)):
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).split(".")[-1] == a.dtype.name, path
        back = t.float().numpy().astype(a.dtype)
        assert back.tobytes() == a.tobytes(), path
        n += 1
    assert n == len(jax.tree_util.tree_leaves(ref["params"]))


@pytest.mark.parametrize("h,kh,s_q,s_k,window,kv_len,block_k", [
    (4, 4, 40, 40, None, None, 16),     # several kv blocks, padded tail
    (4, 2, 24, 24, 8, None, 32),        # GQA, sliding window
    (2, 1, 4, 40, None, 30, 16),        # q at the end of a masked timeline
])
def test_blockwise_attention_matches_the_reference(h, kh, s_q, s_k, window,
                                                   kv_len, block_k):
    from repro.models.layers import blockwise_attention as j_attention
    from repro_torch.models.layers import blockwise_attention
    rng = np.random.default_rng(h + s_q + s_k)
    q = rng.normal(0, 1, (2, h, s_q, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, kh, s_k, 16)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=True, window=window, kv_len=kv_len, block_k=block_k)
    want = np.asarray(j_attention(*map(jnp.asarray, (q, k, v)), **kw))
    got = blockwise_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# apply and the loss against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("pallas", [True, False])
def test_apply_in_float32_matches_the_reference(arch, pallas, reference):
    ref = reference[arch]
    want = _ref_logits(ref, 64, pallas=pallas, f32=True)
    got = get_model(ref["cfg"].family).apply(
        ref["cfg"], _port_params(ref, f32=True),
        torch.from_numpy(_tokens(64)[0]))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_LOGIT_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("t", [64, 40])
@pytest.mark.parametrize("pallas", [True, False])
def test_apply_in_bf16_matches_the_reference(arch, t, pallas, reference):
    ref = reference[arch]
    cfg = ref["cfg"]
    reset_launch_counts()
    got = get_model(cfg.family).apply(cfg, _port_params(ref),
                                      torch.from_numpy(_tokens(t)[0]))
    assert launch_counts() == {k: 0 for k in launch_counts()}
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, t, cfg.vocab_padded)
    got = got.float().numpy()
    want = _ref_logits(ref, t, pallas)
    assert _rms(got - want) <= BF16_RMS_FRAC * _rms(want)
    assert np.abs(got - want).max() <= BF16_MAX_FRAC * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_reference(arch, reference):
    ref = reference[arch]
    tokens, labels = _tokens(40, seed=5)
    mask = (np.arange(40)[None, :] < np.array([[40], [25]])).astype(
        np.float32)
    jcfg = dataclasses.replace(ref["jcfg"], use_pallas=True)
    want = float(j_make_loss_fn(jcfg)(ref["params"], {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
        "loss_mask": jnp.asarray(mask)}))
    got = make_loss_fn(ref["cfg"])(_port_params(ref), {
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(labels),
        "loss_mask": torch.from_numpy(mask)})
    assert got.dtype == torch.float32 and got.dim() == 0
    assert got.is_inference() and not got.requires_grad
    assert abs(float(got) - want) <= LOSS_ATOL
    assert abs(want - np.log(ref["cfg"].vocab_size)) < 0.5
