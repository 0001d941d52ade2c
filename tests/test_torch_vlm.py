"""Port of the VLM family (``models/vlm.py``: the projector, ``apply``,
``prefill`` and ``decode_step`` over the dense backbone; the config of
internvl2-2b) against the JAX package at its ``reduced_config`` (8 patch
embeddings of width 1024, then the text), on the reference's weights and
the same numpy-seeded tokens and patches. Tolerances are stated in
``tests/torch_families.py``; the projector in float32 to 1e-5.

The patches come first, so positions run over the patches and then the
text; the prefill's cache ``index`` counts the patches and a decode step
continues from it; the loss's labels cover the text only (the logits are
sliced past the patches, as in the reference). internvl2's vocab (92553)
pads to 92672: ``softmax_xent`` masks the padding as the reference does,
checked at the full vocab and in a reduced loss whose vocab pads.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.vlm as j_vlm
from repro.models.layers import softmax_xent as j_softmax_xent
from repro_torch.configs import get_config
from repro_torch.models import vlm
from repro_torch.models.layers import softmax_xent
from torch_families import (PROMPT, STEPS, VIT_DIM, Family, check_configs,
                            check_param_specs, check_round_trip, count_flash)
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

ARCH = "internvl2-2b"


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


@pytest.fixture(scope="module")
def fam():
    return Family(ARCH)


# ---------------------------------------------------------------------------
# configs, specs, weights, projector
# ---------------------------------------------------------------------------

def test_config_matches_the_reference():
    check_configs(ARCH)
    assert vlm.VIT_DIM == j_vlm.VIT_DIM == VIT_DIM


@pytest.mark.parametrize("reduced", [False, True])
def test_param_specs_match_the_reference(reduced):
    specs = check_param_specs(ARCH, reduced)
    assert specs[("projector", "w1")].shape[0] == VIT_DIM
    assert specs[("projector", "ln_w")].init == "ones"


def test_params_from_numpy_round_trips_exactly(fam):
    port = check_round_trip(fam)
    proj = port["projector"]
    assert tuple(proj["w1"].shape) == (VIT_DIM, fam.cfg.d_model)
    assert proj["w1"].dtype == torch.bfloat16
    assert {proj[k].dtype for k in ("ln_w", "ln_b", "b1")} == {
        torch.float32}


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_project_patches_matches_the_reference(fam, f32):
    _, patches = fam.inputs(4, 21)
    tree = fam.params32 if f32 else fam.params
    want = np.asarray(j_vlm.project_patches(tree["projector"],
                                            jnp.asarray(patches), None),
                      np.float32)
    got = vlm.project_patches(fam.port_params(f32)["projector"],
                              torch.from_numpy(patches))
    assert got.dtype == torch.bfloat16 and got.shape == want.shape
    # bf16 output: one rounding of float32 values that agree to ~1e-6
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2.0 ** -7,
                               atol=1e-5)


def test_apply_and_prefill_need_patches(fam):
    toks = torch.from_numpy(fam.inputs(4, 1)[0])
    params = fam.port_params()
    with pytest.raises(ValueError, match="patches"):
        vlm.apply(fam.cfg, params, toks)
    with pytest.raises(ValueError, match="patches"):
        vlm.prefill(fam.cfg, params, toks)


# ---------------------------------------------------------------------------
# whole model
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [64, 24])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_apply_matches_the_reference(n, f32, fam, monkeypatch):
    calls = count_flash(monkeypatch)
    fam.check_apply(n, 1, f32)
    assert calls == [0] * fam.cfg.n_layers


def test_loss_matches_the_reference(fam):
    fam.check_loss()


def test_loss_covers_the_text_only(fam):
    # the port's loss equals softmax_xent over the logits past the patches
    toks, patches = fam.inputs(17, 8)
    params = fam.port_params(True)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]),
             "labels": torch.from_numpy(toks[:, 1:]),
             "patches": torch.from_numpy(patches)}
    from repro_torch.train.train_step import make_loss_fn
    loss = make_loss_fn(fam.cfg)(params, batch)
    logits = vlm.apply(fam.cfg, params, batch["tokens"], batch["patches"])
    assert logits.shape[1] == fam.cfg.n_prepend + 16
    want = softmax_xent(logits[:, fam.cfg.n_prepend:], batch["labels"],
                        None, fam.cfg.vocab_size)
    assert float(loss) == float(want)


def test_padded_vocab_loss_matches_the_reference():
    # internvl2's vocab pads from 92553 to 92672: the padding is masked
    cfg = get_config(ARCH)
    assert (cfg.vocab_size, cfg.vocab_padded) == (92553, 92672)
    rng = np.random.default_rng(30)
    logits = rng.normal(0, 3, (2, 3, cfg.vocab_padded)).astype(np.float32)
    logits[..., cfg.vocab_size:] += 20.0     # padding that would dominate
    labels = rng.integers(0, cfg.vocab_size, (2, 3)).astype(np.int32)
    want = float(j_softmax_xent(jnp.asarray(logits), jnp.asarray(labels),
                                None, cfg.vocab_size))
    got = float(softmax_xent(torch.from_numpy(logits),
                             torch.from_numpy(labels), None,
                             cfg.vocab_size))
    assert abs(got - want) <= 1e-5 * abs(want)
    unmasked = float(softmax_xent(torch.from_numpy(logits),
                                  torch.from_numpy(labels)))
    assert unmasked > got + 5


def test_reduced_loss_with_a_padded_vocab_matches():
    # the reduced config with vocab 250 (padded to 256): the loss masks the
    # six padded logits in both packages
    padded = Family(ARCH, vocab_size=250)
    assert padded.cfg.vocab_padded == 256
    got, want = padded.check_loss(seed=7, f32=True)
    assert abs(got - want) <= 2e-3


def test_prefill_logits_and_cache_match_the_reference(fam):
    fam.check_prefill_cache()


@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_teacher_forced_decode_matches_the_reference(f32, fam):
    fam.check_teacher_forced(f32)


def test_decode_continues_after_the_patches(fam):
    # the cache index counts the patches; a decode step writes its key at
    # that position and takes it as its rope position, so prefill + steps
    # give apply's logits over the same patches and tokens (to the bf16
    # cache's rounding, the reference's own tolerance: tests/test_archs.py)
    toks, patches = fam.inputs(PROMPT + STEPS, 9)
    full = fam.model.apply(fam.cfg, fam.port_params(True),
                           torch.from_numpy(toks),
                           torch.from_numpy(patches)).numpy()
    got, first, index = fam.port_teacher_forced(toks, patches, True)
    n_p = fam.cfg.n_prepend
    assert int(first["index"]) == n_p + PROMPT and index == n_p + PROMPT + \
        STEPS
    for i, g in enumerate(got):
        np.testing.assert_allclose(g[:, 0], full[:, n_p + PROMPT - 1 + i],
                                   rtol=3e-2, atol=3e-2)


def test_greedy_generate_matches_the_reference(fam):
    fam.check_greedy()


def test_make_prefill_passes_the_patches(fam):
    from repro_torch.serve import make_prefill
    toks, patches = fam.inputs(PROMPT, 2)
    params = fam.port_params(True)
    logits, cache = make_prefill(fam.cfg)(params, {
        "tokens": torch.from_numpy(toks),
        "patches": torch.from_numpy(patches)})
    want, _ = vlm.prefill(fam.cfg, params, torch.from_numpy(toks),
                          torch.from_numpy(patches))
    assert torch.equal(logits, want)
    assert int(cache["index"]) == fam.cfg.n_prepend + PROMPT
