"""Port of the enc-dec family (whisper-large-v3): config, parameter specs,
the weight converter, ``apply`` and the loss, ``prefill``, teacher-forced
``decode_step`` and ``greedy_generate`` on ``reduced_config(whisper-large-v3)``
against the JAX package on the same weights (``init_params(...,
PRNGKey(0))`` carried over by ``params_from_numpy``), numpy tokens and
numpy frames.

The reference runs two routes: ``use_pallas=True`` (its flash kernel in
interpret mode, forced by ``REPRO_PALLAS_INTERPRET=1``) and its default
(the blockwise jnp attention). The port takes the first on both devices.
The reference's encoder casts the frames to bf16, so its forward runs in
the models' bf16 only; float32 weights are compared through the decoder
(``decode_train`` from a float32 encoder output, and ``decode_step`` from
a float32 cache). Tolerances are those of ``tests/test_torch_lm_models.py``
(``torch_parity``): float32 logits to 5e-4; bf16 logits to 3% of their RMS
in RMS and 8% of their largest magnitude (over all steps together for
decoding: see ``tests/test_torch_serve.py``); the loss to 2e-3. Greedy
tokens are compared up to the first step where the reference's top-2
logit margin is under the bf16 logit tolerance; random weights give flat
logits, so that is the first step or two here, and the test also holds
each greedy token to the argmax of the port's own teacher-forced
decoding of the generated sequence.
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
from repro_torch.distributed.sharding import ParamSpec
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import encdec, get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import greedy_generate, make_prefill, make_serve_step
from repro_torch.serve.decode import grow_cache
from repro_torch.train.train_step import make_loss_fn
from torch_parity import (BF16_MAX_FRAC, F32_LOGIT_ATOL, LOSS_ATOL,
                          agreeing_prefix, assert_bf16_logits_close,
                          isolated_plan_caches)

torch.set_num_threads(1)

ARCH = "whisper-large-v3"
PROMPT, STEPS = 5, 4


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


@pytest.fixture(scope="module")
def ref():
    jcfg = j_reduced_config(j_get_config(ARCH))
    model = j_get_model("encdec")
    specs = model.param_specs(jcfg)
    params = jax.jit(lambda key: j_init_params(specs, key))(
        jax.random.PRNGKey(0))
    return {"jcfg": jcfg, "cfg": reduced_config(get_config(ARCH)),
            "model": model, "params": params,
            "step": jax.jit(model.decode_step, static_argnums=0)}


@pytest.fixture
def interpret(monkeypatch):
    """Run the reference's use_pallas=True route through its kernel."""
    def route(pallas):
        if pallas:
            monkeypatch.setenv("REPRO_PALLAS_INTERPRET", "1")
        else:
            monkeypatch.delenv("REPRO_PALLAS_INTERPRET", raising=False)
    return route


def _inputs(cfg, t, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (2, t)).astype(np.int32),
            rng.integers(0, 256, (2, t)).astype(np.int32),
            rng.normal(0, 1, (2, cfg.n_enc_frames, cfg.d_model)).astype(
                np.float32))


def _port_params(params, f32=False):
    tree = jax.tree_util.tree_map(np.asarray, params)
    if f32:
        tree = jax.tree_util.tree_map(lambda a: a.astype(np.float32), tree)
    return params_from_numpy(tree, device="cpu")


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


# ---------------------------------------------------------------------------
# configs, specs, weights
# ---------------------------------------------------------------------------

def test_config_matches_the_reference():
    for j, t in ((j_get_config(ARCH), get_config(ARCH)),
                 (j_reduced_config(j_get_config(ARCH)),
                  reduced_config(get_config(ARCH)))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    cfg = get_config("whisper_large_v3")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.d_head, cfg.d_ff, cfg.vocab_size, cfg.n_enc_frames) == \
        (32, 1280, 20, 20, 64, 5120, 51866, 1500)
    assert get_model(cfg.family) is encdec


@pytest.mark.parametrize("reduced", [False, True])
def test_param_and_cache_specs_match_the_reference(reduced):
    jcfg, cfg = j_get_config(ARCH), get_config(ARCH)
    if reduced:
        jcfg, cfg = j_reduced_config(jcfg), reduced_config(cfg)
    jm = j_get_model("encdec")
    for jspecs, tspecs in ((jm.param_specs(jcfg), encdec.param_specs(cfg)),
                           (jm.cache_specs(jcfg, 2, 64),
                            encdec.cache_specs(cfg, 2, 64))):
        jl, tl = list(_leaves(jspecs)), list(_leaves(tspecs))
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (path, j), (_, t) in zip(jl, tl):
            assert isinstance(j, JParamSpec) and isinstance(t, ParamSpec)
            assert (j.shape, j.init, j.init_scale) == \
                (t.shape, t.init, t.init_scale), path
            assert np.dtype(j.dtype).name == str(t.dtype).split(".")[-1], path


def test_params_from_numpy_round_trips_exactly(ref):
    tree = jax.tree_util.tree_map(np.asarray, ref["params"])
    port = params_from_numpy(tree, device="cpu")
    for (path, a), (_, t) in zip(_leaves(tree), _leaves(port)):
        assert tuple(t.shape) == a.shape, path
        assert t.float().numpy().astype(a.dtype).tobytes() == a.tobytes(), \
            path


def test_sinusoidal_positions_match_the_reference():
    from repro.models.layers import sinusoidal_positions as j_sin
    from repro_torch.models.layers import sinusoidal_positions
    np.testing.assert_allclose(sinusoidal_positions(1500, 64).numpy(),
                               np.asarray(j_sin(1500, 64)), rtol=0,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# forward and loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pallas", [True, False])
def test_decode_train_in_float32_matches_the_reference(pallas, ref,
                                                       interpret):
    cfg = ref["cfg"]
    tokens, _, _ = _inputs(cfg, 24, seed=2)
    enc = np.random.default_rng(3).normal(
        0, 1, (2, cfg.n_enc_frames, cfg.d_model)).astype(np.float32)
    interpret(pallas)
    jcfg = dataclasses.replace(ref["jcfg"], use_pallas=pallas)
    params = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                    ref["params"])
    want = np.asarray(ref["model"].decode_train(
        jcfg, params, jnp.asarray(tokens), jnp.asarray(enc), None))
    got = encdec.decode_train(cfg, _port_params(ref["params"], f32=True),
                              torch.from_numpy(tokens),
                              torch.from_numpy(enc))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=F32_LOGIT_ATOL)


@pytest.mark.parametrize("t", [24, 9])
@pytest.mark.parametrize("pallas", [True, False])
def test_apply_in_bf16_matches_the_reference(t, pallas, ref, interpret):
    cfg = ref["cfg"]
    tokens, _, frames = _inputs(cfg, t)
    interpret(pallas)
    jcfg = dataclasses.replace(ref["jcfg"], use_pallas=pallas)
    want = np.asarray(ref["model"].apply(jcfg, ref["params"],
                                         jnp.asarray(tokens),
                                         jnp.asarray(frames)), np.float32)
    reset_launch_counts()
    got = encdec.apply(cfg, _port_params(ref["params"]),
                       torch.from_numpy(tokens), torch.from_numpy(frames))
    assert launch_counts() == {k: 0 for k in launch_counts()}
    assert got.dtype == torch.bfloat16
    assert got.shape == (2, t, cfg.vocab_padded)
    assert_bf16_logits_close(got.float().numpy(), want)


def test_apply_needs_frames(ref):
    with pytest.raises(ValueError, match="frames"):
        encdec.apply(ref["cfg"], {}, torch.zeros((1, 2), dtype=torch.int32))


@pytest.mark.parametrize("pallas", [True, False])
def test_loss_matches_the_reference(pallas, ref, interpret):
    cfg = ref["cfg"]
    tokens, labels, frames = _inputs(cfg, 20, seed=5)
    mask = (np.arange(20)[None, :] < np.array([[20], [13]])).astype(
        np.float32)
    interpret(pallas)
    jcfg = dataclasses.replace(ref["jcfg"], use_pallas=pallas)
    want = float(j_make_loss_fn(jcfg)(ref["params"], {
        "tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels),
        "frames": jnp.asarray(frames), "loss_mask": jnp.asarray(mask)}))
    got = make_loss_fn(cfg)(_port_params(ref["params"]), {
        "tokens": torch.from_numpy(tokens),
        "labels": torch.from_numpy(labels),
        "frames": torch.from_numpy(frames),
        "loss_mask": torch.from_numpy(mask)})
    assert got.dtype == torch.float32 and got.dim() == 0
    assert got.is_inference() and not got.requires_grad
    assert abs(float(got) - want) <= LOSS_ATOL
    assert abs(want - np.log(cfg.vocab_size)) < 0.5


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def test_decode_step_in_float32_matches_the_reference(ref):
    # a float32 cache from a float32 encoder output; teacher-forced steps
    # from position 0 through a cache one slot longer than needed
    cfg = ref["cfg"]
    tokens, _, _ = _inputs(cfg, 8, seed=6)
    enc = np.random.default_rng(7).normal(
        0, 1, (2, cfg.n_enc_frames, cfg.d_model)).astype(np.float32)
    jparams = jax.tree_util.tree_map(lambda a: a.astype(jnp.float32),
                                     ref["params"])
    params = _port_params(ref["params"], f32=True)
    jek, jev = ref["model"].cross_kv(ref["jcfg"], jparams, jnp.asarray(enc),
                                     None)
    ek, ev = encdec.cross_kv(cfg, params, torch.from_numpy(enc))
    np.testing.assert_allclose(ek.numpy(), np.asarray(jek), rtol=0,
                               atol=1e-5)
    kv = (cfg.n_layers, 2, cfg.n_kv_heads, 9, cfg.d_head)
    jcache = {"k": jnp.zeros(kv), "v": jnp.zeros(kv), "ek": jek, "ev": jev,
              "index": jnp.zeros((), jnp.int32)}
    cache = {"k": torch.zeros(kv), "v": torch.zeros(kv), "ek": ek, "ev": ev,
             "index": torch.zeros((), dtype=torch.int32)}
    step = make_serve_step(cfg)
    full = encdec.decode_train(cfg, params, torch.from_numpy(tokens),
                               torch.from_numpy(enc))
    for i in range(8):
        tok = tokens[:, i:i + 1]
        want, jcache = ref["step"](ref["jcfg"], jparams, jcache,
                                   jnp.asarray(tok))
        got, cache = step(params, cache, torch.from_numpy(tok))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=F32_LOGIT_ATOL, err_msg=f"step {i}")
        np.testing.assert_allclose(got[:, 0].numpy(), full[:, i].numpy(),
                                   rtol=0, atol=F32_LOGIT_ATOL)
    assert int(cache["index"]) == 8


def test_prefill_and_teacher_forced_decode_match_the_reference(ref):
    cfg = ref["cfg"]
    tokens, _, frames = _inputs(cfg, PROMPT + STEPS, seed=8)
    logits, jcache = ref["model"].prefill(
        ref["jcfg"], ref["params"], jnp.asarray(tokens[:, :PROMPT]),
        frames=jnp.asarray(frames))
    want = [np.asarray(logits, np.float32)]
    pad = [(0, 0)] * 5
    pad[-2] = (0, STEPS)
    jcache = dict(jcache, k=jnp.pad(jcache["k"], pad),
                  v=jnp.pad(jcache["v"], pad))
    for i in range(PROMPT, PROMPT + STEPS):
        logits, jcache = ref["step"](ref["jcfg"], ref["params"], jcache,
                                     jnp.asarray(tokens[:, i:i + 1]))
        want.append(np.asarray(logits, np.float32))

    params = _port_params(ref["params"])
    reset_launch_counts()
    logits, cache = make_prefill(cfg)(params, {
        "tokens": torch.from_numpy(tokens[:, :PROMPT]),
        "frames": torch.from_numpy(frames)})
    assert launch_counts() == {k: 0 for k in launch_counts()}
    for key, spec in encdec.cache_specs(cfg, 2, PROMPT).items():
        assert tuple(cache[key].shape) == spec.shape, key
        assert cache[key].dtype == spec.dtype, key
    got = [logits.float().numpy()]
    cache = grow_cache(cache, STEPS)
    step = make_serve_step(cfg)
    for i in range(PROMPT, PROMPT + STEPS):
        logits, cache = step(params, cache,
                             torch.from_numpy(tokens[:, i:i + 1]))
        got.append(logits.float().numpy())
    assert int(cache["index"]) == PROMPT + STEPS
    assert_bf16_logits_close(np.stack(got), np.stack(want))


def test_greedy_generate_matches_the_reference(ref):
    cfg = ref["cfg"]
    prompt, _, frames = _inputs(cfg, PROMPT, seed=9)
    n_new = 6
    logits, cache = ref["model"].prefill(ref["jcfg"], ref["params"],
                                         jnp.asarray(prompt),
                                         frames=jnp.asarray(frames))
    pad = [(0, 0)] * 5
    pad[-2] = (0, n_new)
    cache = dict(cache, k=jnp.pad(cache["k"], pad),
                 v=jnp.pad(cache["v"], pad))
    steps, toks = [], []
    for i in range(n_new):
        if i:
            logits, cache = ref["step"](ref["jcfg"], ref["params"], cache,
                                        toks[-1])
        steps.append(np.asarray(logits[:, -1], np.float32))
        toks.append(jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32))
    want = np.asarray(jnp.concatenate(toks, axis=1))
    got = greedy_generate(cfg, _port_params(ref["params"]),
                          {"tokens": torch.from_numpy(prompt),
                           "frames": torch.from_numpy(frames)}, n_new)
    assert got.dtype == torch.int32 and got.shape == (2, n_new)
    atol = BF16_MAX_FRAC * float(np.abs(np.stack(steps)).max())
    n = agreeing_prefix(np.stack(steps), atol)
    np.testing.assert_array_equal(got.numpy()[:, :n], want[:, :n])

    # every generated token is the argmax of the port's prefill and
    # teacher-forced steps over the prompt and the tokens before it
    params = _port_params(ref["params"])
    logits, cache = make_prefill(cfg)(params, {
        "tokens": torch.from_numpy(prompt),
        "frames": torch.from_numpy(frames)})
    cache = grow_cache(cache, n_new)
    step = make_serve_step(cfg)
    for i in range(n_new):
        if i:
            logits, cache = step(params, cache, got[:, i - 1:i])
        assert torch.equal(logits[:, -1].argmax(-1).to(torch.int32),
                           got[:, i])
