"""Port of the serving entry points of the rwkv and hybrid families
(``cache_specs``, ``prefill``, ``decode_step``) and of
``serve/decode.py`` (``make_prefill``, ``make_serve_step``,
``greedy_generate``), against the JAX package on
``reduced_config(rwkv6-7b)`` and ``reduced_config(zamba2-2.7b)``: the same
weights (``init_params(..., PRNGKey(0))`` carried over by
``params_from_numpy``) and the same numpy tokens.

Prefill and decode are compared under teacher forcing: the same token
goes into both packages at every step, and the logits of every step are
compared. Greedy decoding, in float32 weights, is compared token for token up to
the first step where the reference's top-2 logit margin is under the
logit tolerance (beyond it, a port within tolerance may take the other
token); with random bf16 weights the margins are mostly under the bf16
tolerance, which would leave next to nothing to compare.
Tolerances are those of ``tests/test_torch_lm_models.py``
(``torch_parity``): float32 logits to 5e-4 at every step; bf16 logits to
3% of their RMS in RMS and 8% of their largest magnitude, over all steps
together, as the forward's test takes them over all positions. One
step's logits alone (two rows) are too few for that RMS: there the
reference's own bf16 logits stray up to 4.3% (RMS) from its float32
ones (rwkv6, tokens of seed 4, last step), where the port's stray 2.3%.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.distributed.sharding import init_params as j_init_params
from repro.models import get_model as j_get_model
from repro_torch.configs import get_config, reduced_config
from repro_torch.distributed.sharding import init_params
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import greedy_generate, make_prefill, make_serve_step
from repro_torch.serve.decode import grow_cache
from torch_parity import (F32_LOGIT_ATOL, agreeing_prefix,
                          assert_bf16_logits_close, isolated_plan_caches)

torch.set_num_threads(1)

ARCHS = ("rwkv6-7b", "zamba2-2.7b")
PROMPT, STEPS = 7, 5


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


@pytest.fixture(scope="module")
def reference():
    out = {}
    for arch in ARCHS:
        jcfg = j_reduced_config(j_get_config(arch))
        model = j_get_model(jcfg.family)
        specs = model.param_specs(jcfg)
        params = jax.jit(lambda key, s=specs: j_init_params(s, key))(
            jax.random.PRNGKey(0))
        out[arch] = {
            "jcfg": jcfg, "cfg": reduced_config(get_config(arch)),
            "model": model, "params": params,
            "prefill": jax.jit(model.prefill, static_argnums=0),
            "step": jax.jit(model.decode_step, static_argnums=0)}
    return out


def _tokens(n, seed=3):
    return np.random.default_rng(seed).integers(0, 256, (2, n)).astype(
        np.int32)


def _f32(tree):
    return jax.tree_util.tree_map(lambda a: a.astype(jnp.float32), tree)


def _port_params(params):
    return params_from_numpy(jax.tree_util.tree_map(np.asarray, params),
                             device="cpu")


def _grow_ref(cache, n):
    if "k" in cache:
        pad = [(0, 0)] * cache["k"].ndim
        pad[-2] = (0, n)
        cache = dict(cache, k=jnp.pad(cache["k"], pad),
                     v=jnp.pad(cache["v"], pad))
    return cache


def _ref_teacher_forced(ref, params, toks):
    logits, cache = ref["prefill"](ref["jcfg"], params,
                                   jnp.asarray(toks[:, :PROMPT]))
    out = [np.asarray(logits, np.float32)]
    cache = _grow_ref(cache, STEPS)
    for i in range(PROMPT, PROMPT + STEPS):
        logits, cache = ref["step"](ref["jcfg"], params, cache,
                                    jnp.asarray(toks[:, i:i + 1]))
        out.append(np.asarray(logits, np.float32))
    return out


def _port_teacher_forced(cfg, params, toks):
    prefill, step = make_prefill(cfg), make_serve_step(cfg)
    logits, cache = prefill(params, {"tokens": torch.from_numpy(
        toks[:, :PROMPT])})
    out = [logits.float().numpy()]
    cache = grow_cache(cache, STEPS)
    for i in range(PROMPT, PROMPT + STEPS):
        logits, cache = step(params, cache,
                             torch.from_numpy(toks[:, i:i + 1]))
        out.append(logits.float().numpy())
    return out, cache


# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_cache_specs_match_the_reference(arch, reference):
    ref = reference[arch]
    for jcfg, cfg in ((ref["jcfg"], ref["cfg"]),
                      (j_get_config(arch), get_config(arch))):
        jspecs = ref["model"].cache_specs(jcfg, 2, 64)
        specs = get_model(cfg.family).cache_specs(cfg, 2, 64)
        assert sorted(jspecs) == sorted(specs)
        for key, j in jspecs.items():
            t = specs[key]
            assert (j.shape, j.init) == (t.shape, t.init), key
            assert np.dtype(j.dtype).name == str(t.dtype).split(".")[-1], key


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_cache_has_the_specs_shapes(arch, reference):
    ref = reference[arch]
    cfg = ref["cfg"]
    model = get_model(cfg.family)
    params = init_params(model.param_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    logits, cache = model.prefill(cfg, params,
                                  torch.from_numpy(_tokens(PROMPT)))
    assert logits.shape == (2, 1, cfg.vocab_padded)
    for key, spec in model.cache_specs(cfg, 2, PROMPT).items():
        assert tuple(cache[key].shape) == spec.shape, key
        assert cache[key].dtype == spec.dtype, key
    assert int(cache["index"]) == PROMPT


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_in_float32_matches_the_reference(arch,
                                                                reference):
    ref = reference[arch]
    toks = _tokens(PROMPT + STEPS)
    want = _ref_teacher_forced(ref, _f32(ref["params"]), toks)
    reset_launch_counts()
    got, cache = _port_teacher_forced(ref["cfg"],
                                      _port_params(_f32(ref["params"])), toks)
    assert launch_counts() == {k: 0 for k in launch_counts()}
    assert int(cache["index"]) == PROMPT + STEPS
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape == (2, 1, ref["cfg"].vocab_padded)
        np.testing.assert_allclose(g, w, rtol=0, atol=F32_LOGIT_ATOL,
                                   err_msg=f"step {i}")


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_in_bf16_matches_the_reference(arch,
                                                             reference):
    ref = reference[arch]
    toks = _tokens(PROMPT + STEPS, seed=4)
    want = _ref_teacher_forced(ref, ref["params"], toks)
    got, _ = _port_teacher_forced(ref["cfg"], _port_params(ref["params"]),
                                  toks)
    assert_bf16_logits_close(np.stack(got), np.stack(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_continues_the_full_sequence_forward(arch, reference):
    # rwkv6: prefill + steps equal apply over the whole sequence. zamba2's
    # prefill reads its keys and values back from the bf16 KV cache, so it
    # equals apply to the reference's own tolerance for that
    # (tests/test_archs.py, 3e-2); its decode takes the current token's
    # embedding as its concat-skip (the reference's choice), not apply's
    ref = reference[arch]
    cfg = ref["cfg"]
    params = _port_params(_f32(ref["params"]))
    toks = _tokens(PROMPT + STEPS, seed=5)
    full = get_model(cfg.family).apply(cfg, params,
                                       torch.from_numpy(toks)).numpy()
    got, _ = _port_teacher_forced(cfg, params, toks)
    tol = (dict(rtol=0, atol=F32_LOGIT_ATOL) if cfg.family == "rwkv"
           else dict(rtol=3e-2, atol=3e-2))
    np.testing.assert_allclose(got[0][:, 0], full[:, PROMPT - 1], **tol)
    if cfg.family == "rwkv":
        for i, g in enumerate(got[1:]):
            np.testing.assert_allclose(g[:, 0], full[:, PROMPT + i], rtol=0,
                                       atol=F32_LOGIT_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_the_reference(arch, reference):
    ref = reference[arch]
    prompt = _tokens(PROMPT, seed=6)
    n_new = 6
    params = _f32(ref["params"])
    # the reference's greedy loop, keeping each step's logits
    logits, cache = ref["prefill"](ref["jcfg"], params, jnp.asarray(prompt))
    cache = _grow_ref(cache, n_new)
    steps, toks = [], []
    for i in range(n_new):
        if i:
            logits, cache = ref["step"](ref["jcfg"], params, cache, toks[-1])
        steps.append(np.asarray(logits[:, -1], np.float32))
        toks.append(jnp.argmax(logits[:, -1:], axis=-1).astype(jnp.int32))
    want = np.asarray(jnp.concatenate(toks, axis=1))
    got = greedy_generate(ref["cfg"], _port_params(params),
                          {"tokens": torch.from_numpy(prompt)}, n_new)
    assert got.dtype == torch.int32 and got.shape == (2, n_new)
    n = agreeing_prefix(np.stack(steps), F32_LOGIT_ATOL)
    np.testing.assert_array_equal(got.numpy()[:, :n], want[:, :n])


@pytest.mark.parametrize("index", [0, 3, 6])
def test_cache_update_matches_the_reference(index):
    # index 6 with 3 new positions in a cache of 8: the write is clamped
    # to fit, as lax.dynamic_update_slice clamps it
    from repro.models.layers import cache_update as j_cache_update
    from repro.models.layers import kv_cache_specs as j_kv_cache_specs
    from repro_torch.models.layers import cache_update, kv_cache_specs
    rng = np.random.default_rng(index)
    ck, cv = (rng.normal(0, 1, (2, 3, 8, 4)).astype(np.float32)
              for _ in range(2))
    k, v = (rng.normal(0, 1, (2, 3, 3, 4)).astype(np.float32)
            for _ in range(2))
    want = j_cache_update(*map(jnp.asarray, (ck, cv, k, v)),
                          jnp.asarray(index, jnp.int32))
    tck, tcv = torch.from_numpy(ck), torch.from_numpy(cv)
    got = cache_update(tck, tcv, torch.from_numpy(k), torch.from_numpy(v),
                       torch.tensor(index, dtype=torch.int32))
    assert got[0] is tck and got[1] is tcv          # updated in place
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    jspecs, specs = j_kv_cache_specs(4, 2, 3, 8, 16), kv_cache_specs(
        4, 2, 3, 8, 16)
    assert {n: (s.shape, s.init) for n, s in jspecs.items()} == \
        {n: (s.shape, s.init) for n, s in specs.items()}


# ---------------------------------------------------------------------------
# the registries and the batched serving driver (launch/serve.py)
# ---------------------------------------------------------------------------

ALL_ARCHS = ("rwkv6-7b", "internlm2-20b", "qwen3-1.7b", "gemma3-4b",
             "mistral-large-123b", "olmoe-1b-7b", "kimi-k2-1t-a32b",
             "internvl2-2b", "zamba2-2.7b", "whisper-large-v3")
DRIVER_ARGS = ["--requests", "5", "--slots", "2", "--prompt-len", "8",
               "--gen-len", "4"]


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_every_architecture_and_family_resolves(arch):
    import dataclasses
    from repro_torch.models import MODEL_FAMILIES
    cfg = get_config(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(j_get_config(arch))
    model = get_model(cfg.family)
    assert model is MODEL_FAMILIES[cfg.family]
    assert type(j_get_model(cfg.family)).__name__ == type(model).__name__
    for name in ("param_specs", "apply", "cache_specs", "prefill",
                 "decode_step"):
        assert callable(getattr(model, name)), name
    assert len(MODEL_FAMILIES) == 6


def _driver_lines(capsys):
    out = capsys.readouterr().out.splitlines()
    assert len(out) == 2, out
    assert out[0].startswith("served 5 requests / 20 tokens in ")
    assert out[0].endswith(" tok/s)")
    assert out[1].startswith("latency p50=") and " p99=" in out[1]
    return out


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b", "rwkv6-7b",
                                  "zamba2-2.7b"])
def test_serve_driver_runs_on_the_cpu(arch, capsys):
    from repro_torch.launch import serve as driver
    reset_launch_counts()
    assert driver.main(["--device", "cpu", "--arch", arch] +
                       DRIVER_ARGS) == 0
    _driver_lines(capsys)
    assert launch_counts() == {k: 0 for k in launch_counts()}


@pytest.mark.parametrize("arch", ["internvl2-2b", "whisper-large-v3"])
def test_serve_driver_refuses_vlm_and_encdec(arch):
    from repro_torch.launch import serve as driver
    with pytest.raises(SystemExit, match="token-only"):
        driver.main(["--device", "cpu", "--arch", arch] + DRIVER_ARGS)


def test_serve_driver_runs_on_the_card_by_default():
    from repro_torch.device import NoCUDADeviceError
    from repro_torch.launch import serve as driver
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device is valid")
    with pytest.raises(NoCUDADeviceError):
        driver.main(DRIVER_ARGS)


def test_serve_driver_forwards_kg_to_kg_serve(capsys):
    from repro_torch.launch import serve as driver
    assert driver.main(["--kg", "--device", "cpu", "--rows", "40",
                        "--tenants", "2", "--shapes", "1", "--batches", "2",
                        "--batch-rows", "8"]) == 0
    out = capsys.readouterr().out
    assert "compiles" in out and "served" not in out.split("\n")[0][:6]


def _reference_step_indices(monkeypatch, argv):
    """The reference driver's decode steps: each one's cache index, input
    tokens and greedy output tokens, recorded around its jitted step
    function."""
    import types

    import repro.launch.serve as j_driver
    real = j_driver.make_serve_step
    seen = []

    def recording(cfg):
        step = jax.jit(real(cfg))

        def call(params, cache, tok):
            logits, cache_out = step(params, cache, tok)
            seen.append((int(cache["index"]), np.asarray(tok)[:, 0].tolist(),
                         np.asarray(jnp.argmax(logits[:, -1], axis=-1))
                         .tolist()))
            return logits, cache_out

        call.recording = True
        return call

    monkeypatch.setattr(j_driver, "make_serve_step", recording)
    monkeypatch.setattr(j_driver, "jax", types.SimpleNamespace(
        jit=lambda f: f if getattr(f, "recording", False) else jax.jit(f),
        random=jax.random, tree_util=jax.tree_util))
    assert j_driver.main(argv) == 0
    return seen


def test_cache_index_across_waves_pinned(monkeypatch, capsys):
    # 5 requests over 2 slots: three admission waves of 4 decode steps.
    # The reference keeps the live cache's 0-d index when it merges a
    # wave, so its later waves decode from the first wave's end (12, then
    # 16), past the grown cache's length 12, where each write is clamped
    # into the last position; and a later wave's first step takes the
    # tokens the slots' previous requests ended with, not its prefill's.
    # The port takes the admitted cache's index when every slot is
    # replaced (the only case with one --gen-len) and the prefill's
    # tokens (test_serve_driver_matches_greedy_generate_per_wave).
    from repro_torch.launch import serve as driver
    ref = _reference_step_indices(monkeypatch, DRIVER_ARGS)
    _driver_lines(capsys)
    assert [i for i, _, _ in ref] == list(range(8, 20))
    assert ref[4][1] == ref[3][2]            # wave 2: both slots
    assert ref[8][1][0] == ref[7][2][0]      # wave 3: its one request
    real = driver.make_serve_step
    seen = []

    def recording(cfg):
        step = real(cfg)

        def call(params, cache, tok):
            seen.append(int(cache["index"]))
            return step(params, cache, tok)

        return call

    monkeypatch.setattr(driver, "make_serve_step", recording)
    cfg = reduced_config(get_config("qwen3-1.7b"))
    model = get_model(cfg.family)
    params = init_params(model.param_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(0).integers(0, cfg.vocab_size, (5, 8))
    run = driver.serve_requests(cfg, params, prompts, 2, 4,
                                torch.device("cpu"))
    assert seen == [8, 9, 10, 11] * 3
    assert sorted(run["done"]) == [0, 1, 2, 3, 4]
    assert all(len(v) == 4 for v in run["done"].values())
    assert run["n_tokens"] == 20


def test_serve_driver_matches_greedy_generate_per_wave():
    # with the index taken from each wave, every request's tokens are
    # greedy_generate's over its own prompt
    from repro_torch.launch import serve as driver
    cfg = reduced_config(get_config("qwen3-1.7b"))
    model = get_model(cfg.family)
    params = init_params(model.param_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (4, 8))
    run = driver.serve_requests(cfg, params, prompts, 2, 4,
                                torch.device("cpu"))
    for r in range(4):
        # the same batch of two prompts, and the same cache length (8 + 4):
        # greedy_generate's tokens 1..3 are the driver's first three (the
        # driver feeds the prefill's token to its first step)
        pair = np.stack([prompts[r], prompts[r ^ 1]])
        first = greedy_generate(cfg, params, {"tokens": torch.as_tensor(
            pair, dtype=torch.int32)}, 4)
        assert run["done"][r][:3] == first[0, 1:].tolist(), r
