"""Port of the dense transformer family (``models/transformer.py``, the
banded local attention of ``models/layers.py``, the configs of qwen3-1.7b,
gemma3-4b, internlm2-20b and mistral-large-123b) against the JAX package
at each architecture's ``reduced_config``: ``apply``, the loss,
``prefill`` and its cache, teacher-forced ``decode_step`` and
``greedy_generate`` on the reference's weights. Tolerances are stated in
``tests/torch_families.py``; ``layer_windows`` and the routes are exact.

gemma3's banded route is decided per sequence length by ``_banded_ok``:
at the reduced config (window 32, block ``max(32, min(1024, S))``) it
holds at S = 64 and not at S = 24, and both are compared. The port's
forward takes the flash kernel's route where the reference scans a traced
window (its blockwise path): the same function, compared here.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.transformer as j_tf
from repro.models.layers import banded_local_attention as j_banded
from repro_torch.models import transformer as tf
from repro_torch.models.layers import banded_local_attention
from torch_families import (Family, check_configs, check_param_specs,
                            check_round_trip, count_flash)
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

ARCHS = ("qwen3-1.7b", "gemma3-4b", "internlm2-20b", "mistral-large-123b")
#: a prompt and one decode step
PROMPT_AND_ONE = 8


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


@pytest.fixture(scope="module")
def families():
    return {arch: Family(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def gemma_tail():
    # a period of 5 local + 1 global, then a tail of 4 local layers (the
    # full config's 34 = 5·6 + 4)
    return Family("gemma3-4b", n_layers=10)


# ---------------------------------------------------------------------------
# configs, specs, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    check_configs(arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_specs_match_the_reference(arch, reduced):
    check_param_specs(arch, reduced)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_round_trips_exactly(arch, families):
    port = check_round_trip(families[arch])
    cfg = families[arch].cfg
    assert ("unembed" in port["embed"]) != cfg.tied_embeddings
    assert ("q_norm" in port["layers"]["attn"]) == cfg.qk_norm


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_windows_match_the_reference(arch, families, gemma_tail):
    for fam in (families[arch], gemma_tail):
        for cfg, jcfg in ((fam.cfg, fam.jcfg),
                          (tf_config(fam.arch), j_tf_config(fam.arch))):
            want = np.asarray(j_tf.layer_windows(jcfg)).tolist()
            assert tf.layer_windows(cfg) == want


def tf_config(arch):
    from repro_torch.configs import get_config
    return get_config(arch)


def j_tf_config(arch):
    from repro.configs import get_config
    return get_config(arch)


def test_full_gemma3_windows_and_routes():
    cfg = tf_config("gemma3-4b")
    windows = tf.layer_windows(cfg)
    assert len(windows) == 34 and windows.count(0) == 5
    assert [i for i, w in enumerate(windows) if w == 0] == [5, 11, 17, 23,
                                                            29]
    assert set(windows[30:]) == {1024}              # the local tail
    assert tf._banded_ok(cfg, 2048) and not tf._banded_ok(cfg, 1536)
    for arch in ARCHS:
        for s in (24, 64, 1024, 2048, 4096):
            assert tf._banded_ok(tf_config(arch), s) == \
                j_tf._banded_ok(j_tf_config(arch), s)


@pytest.mark.parametrize("s,window,block,h,kh", [
    (64, 32, 64, 4, 2),          # the reduced gemma3's banded route
    (96, 32, 32, 4, 1),          # three blocks, window = block
    (48, 5, 16, 2, 2),           # a window narrower than a block
])
def test_banded_local_attention_matches_the_reference(s, window, block, h,
                                                      kh):
    rng = np.random.default_rng(s + window)
    q = rng.normal(0, 1, (2, h, s, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (2, kh, s, 16)).astype(np.float32)
            for _ in range(2))
    want = np.asarray(j_banded(*map(jnp.asarray, (q, k, v)), window=window,
                               block=block))
    got = banded_local_attention(*map(torch.from_numpy, (q, k, v)),
                                 window=window, block=block)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="banded"):
        banded_local_attention(*map(torch.from_numpy, (q, k, v)),
                               window=block + 1, block=block)


# ---------------------------------------------------------------------------
# apply, loss, prefill, decode, greedy
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_apply_matches_the_reference(arch, f32, families):
    families[arch].check_apply(64, 1, f32)


@pytest.mark.parametrize("s", [64, 24])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_gemma3_banded_and_unbanded_routes_match(s, f32, families,
                                                 monkeypatch):
    fam = families["gemma3-4b"]
    assert tf._banded_ok(fam.cfg, s) == (s == 64)
    calls = count_flash(monkeypatch)
    fam.check_apply(s, 2, f32)
    # banded: only the global layer takes the flash route (window 0);
    # unbanded: every layer, the local ones with their window
    assert calls == ([0] if s == 64 else tf.layer_windows(fam.cfg))


@pytest.mark.parametrize("s", [64, 24])
def test_gemma3_local_tail_matches(s, gemma_tail, monkeypatch):
    # float32 weights: at 10 random bf16 layers each package's own
    # bf16-against-float32 gap is 4-8% of the logits' RMS, over the bf16
    # bar, so the route is held to the float32 tolerance only
    assert tf.layer_windows(gemma_tail.cfg) == [32] * 5 + [0] + [32] * 4
    calls = count_flash(monkeypatch)
    gemma_tail.check_apply(s, 3, True)
    assert calls == ([0] if s == 64 else tf.layer_windows(gemma_tail.cfg))


@pytest.mark.parametrize("arch", ARCHS)
def test_flash_route_once_per_layer(arch, families, monkeypatch):
    fam = families[arch]
    calls = count_flash(monkeypatch)
    fam.port_apply(24, 1, f32=True)
    assert len(calls) == fam.cfg.n_layers
    calls.clear()
    toks, _ = fam.inputs(PROMPT_AND_ONE, 1)
    _, cache = tf.prefill(fam.cfg, fam.port_params(True),
                          torch.from_numpy(toks[:, :-1]))
    tf.decode_step(fam.cfg, fam.port_params(True),
                   {"k": torch.nn.functional.pad(cache["k"], (0, 0, 0, 1)),
                    "v": torch.nn.functional.pad(cache["v"], (0, 0, 0, 1)),
                    "index": cache["index"]},
                   torch.from_numpy(toks[:, -1:]))
    assert calls == []           # cached attention takes the plain paths


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_matches_the_reference(arch, families):
    families[arch].check_loss()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_the_reference(arch, families):
    families[arch].check_prefill_cache()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_teacher_forced_decode_matches_the_reference(arch, f32, families):
    families[arch].check_teacher_forced(f32)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_the_reference(arch, families):
    families[arch].check_greedy()


def test_decode_continues_the_full_sequence_forward(families):
    # prefill + steps over a sequence give apply's logits at the same
    # positions, to the bf16 cache's rounding (the reference's own
    # tolerance for this: tests/test_archs.py, 3e-2)
    fam = families["qwen3-1.7b"]
    toks, _ = fam.inputs(12, 9)
    full = fam.port_apply(12, 9, f32=True).numpy()
    got, _, _ = fam.port_teacher_forced(toks, None, True)
    for i, g in enumerate(got):
        np.testing.assert_allclose(g[:, 0], full[:, 6 + i], rtol=3e-2,
                                   atol=3e-2)
