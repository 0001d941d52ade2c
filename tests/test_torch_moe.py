"""Port of the MoE family (``models/moe.py``: ``capacity``,
``_route_and_sort``, ``moe_block``, ``aux_load_loss``, the forward,
prefill and decode; the configs of olmoe-1b-7b and kimi-k2-1t-a32b, whose
shared expert is covered) against the JAX package at each architecture's
``reduced_config``, on the reference's weights.

Tolerances, with reasons:

* routing (``dest``, ``tok_sorted``, top-k indices, the expert counts
  of ``aux_load_loss``): exact. The reference sorts with ``lax.sort``,
  which is stable by default; the port sorts stably, so within an
  expert's run the pairs keep their order, and the same pairs fall past
  the capacity. Ties in top-k go to the lower expert in both.
* router weights: 1e-6 (float32 softmax and normalisation);
* ``moe_block`` on the same bf16 input: within one bf16 step (2**-7 of
  the output's largest magnitude; bit-equal on this box); in float32 to
  1e-5;
* whole models on float32 weights (``apply``, the loss, prefill and its
  cache, decode, greedy tokens): the family tolerances of
  ``tests/torch_families.py``;
* whole models on bf16 weights: logits within 12% of their RMS in RMS
  and 40% of their largest magnitude. Each package rounds the attention
  and norms differently in bf16 (the reference's CPU backend keeps fused
  chains in float32), and a token whose router probabilities nearly tie
  takes another expert under the other rounding. The reference's own
  bf16 logits lie 4-10% (RMS) and 10-49% (largest magnitude) from its
  float32 ones on these inputs; the port's lie up to 7.1% and 24% from the
  reference's. The loss on bf16 weights, a mean over tokens, to 1e-2
  (measured: up to 3.9e-3). The function itself is held by the float32
  comparisons and by ``moe_block``'s bf16 comparison on the same input.
* the reference's CPU backend flushes subnormal floats to zero, and the
  port's CPU keeps them: where a router logit trails the largest by ~90
  or more, its probability is subnormal (below ~1.2e-38), and the
  reference ties it at 0 with the others, breaking the tie toward the
  lower expert. ``test_subnormal_router_probabilities_pinned`` pins both
  packages' choices; every other case keeps its probabilities normal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.models.moe as j_moe
from repro_torch.models import moe
from repro_torch.models.layers import layer_params
from torch_families import (PROMPT, STEPS, Family, check_configs,
                            check_param_specs, check_round_trip, count_flash)
from torch_parity import LOSS_ATOL, isolated_plan_caches, rms

torch.set_num_threads(1)

ARCHS = ("olmoe-1b-7b", "kimi-k2-1t-a32b")
MOE_BF16_RMS_FRAC, MOE_BF16_MAX_FRAC, MOE_BF16_LOSS_ATOL = 0.12, 0.40, 1e-2
#: the skew that sends most tokens to expert 0 and overflows its
#: capacity, with every router probability normal (logit gaps ~8)
SKEW = 3.0


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


@pytest.fixture(scope="module")
def families():
    return {arch: Family(arch) for arch in ARCHS}


def _layer0(fam, f32=False):
    """Layer 0's MoE parameters in both packages."""
    jp = jax.tree_util.tree_map(
        lambda a: a[0], (fam.params32 if f32 else fam.params)["layers"]
        ["moe"])
    return jp, layer_params(fam.port_params(f32)["layers"]["moe"], 0)


def _x(fam, t, seed, skew=0.0, dtype=np.float32):
    """[1, t, d] standard normal rows, plus ``skew`` times router column
    0's direction (which sends most tokens to expert 0)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (1, t, fam.cfg.d_model)).astype(np.float32)
    if skew:
        col = np.asarray(fam.params["layers"]["moe"]["router"][0, :, 0],
                         np.float32)
        x += skew * col / np.linalg.norm(col)
    return x


# ---------------------------------------------------------------------------
# configs, specs, weights
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_the_reference(arch):
    check_configs(arch)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("reduced", [False, True])
def test_param_specs_match_the_reference(arch, reduced):
    specs = check_param_specs(arch, reduced)
    e = 8 if reduced else {"olmoe-1b-7b": 64, "kimi-k2-1t-a32b": 384}[arch]
    assert specs[("layers", "moe", "w_gate")].shape[1] == e
    assert specs[("layers", "moe", "router")].dtype == torch.float32
    assert (("layers", "moe", "shared", "w_up") in specs) == \
        (arch == "kimi-k2-1t-a32b")


@pytest.mark.parametrize("arch", ARCHS)
def test_params_from_numpy_round_trips_exactly(arch, families):
    # stacked [L, E, D, F] expert weights, the float32 router
    port = check_round_trip(families[arch])
    cfg = families[arch].cfg
    m = port["layers"]["moe"]
    assert tuple(m["w_gate"].shape) == (cfg.n_layers, cfg.n_experts,
                                        cfg.d_model, cfg.d_ff)
    assert tuple(m["w_down"].shape) == (cfg.n_layers, cfg.n_experts,
                                        cfg.d_ff, cfg.d_model)
    assert m["router"].dtype == torch.float32
    assert m["w_gate"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# routing, the block, the load loss
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_capacity_matches_the_reference(arch, families):
    fam = families[arch]
    for cfg, jcfg in ((fam.cfg, fam.jcfg),):
        for t in (1, 2, 8, 24, 64, 100, 4096, 65536):
            assert moe.capacity(cfg, t) == j_moe.capacity(jcfg, t)
    from repro.configs import get_config as jg
    from repro_torch.configs import get_config
    for t in (2, 8, 4096):
        assert moe.capacity(get_config(arch), t) == \
            j_moe.capacity(jg(arch), t)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("t,skew", [(24, 0.0), (64, 0.0), (64, SKEW)],
                         ids=["t24", "t64", "t64-overflow"])
def test_route_and_sort_matches_the_reference_exactly(arch, t, skew,
                                                      families):
    fam = families[arch]
    jp, tp = _layer0(fam)
    cap = moe.capacity(fam.cfg, t)
    x = _x(fam, t, seed=t, skew=skew)[0]
    for dtype, tdtype in ((jnp.float32, torch.float32),
                          (jnp.bfloat16, torch.bfloat16)):
        want = [np.asarray(a) for a in j_moe._route_and_sort(
            fam.jcfg, jp["router"], jnp.asarray(x).astype(dtype), cap)]
        dest, tok, w, _ = moe._route_and_sort(
            fam.cfg, tp["router"], torch.from_numpy(x).to(tdtype), cap)
        np.testing.assert_array_equal(dest.numpy(), want[0])
        np.testing.assert_array_equal(tok.numpy(), want[1])
        np.testing.assert_allclose(w.numpy(), want[2], rtol=0, atol=1e-6)
    dropped = (dest == fam.cfg.n_experts * cap).numpy()
    # the skewed case overflows expert 0: some pairs are dropped, with
    # weight 0
    assert dropped.any() == bool(skew)
    assert (w.numpy()[dropped] == 0).all()


def test_top_k_breaks_ties_toward_the_lower_expert():
    # equal probabilities: lax.top_k takes the lower index first
    probs = np.array([[0.1, 0.3, 0.3, 0.3],
                      [0.25, 0.25, 0.25, 0.25],
                      [0.4, 0.1, 0.4, 0.1]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = moe._top_k(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.tolist() == [[1, 2], [0, 1], [0, 2]]


def test_route_and_sort_with_tied_experts_matches(families):
    # two identical router columns: every token's probabilities for
    # experts 2 and 5 tie exactly
    fam = families["olmoe-1b-7b"]
    jp, tp = _layer0(fam, f32=True)
    router = np.asarray(jp["router"]).copy()
    router[:, 5] = router[:, 2]
    x = _x(fam, 32, seed=9)[0]
    cap = moe.capacity(fam.cfg, 32)
    want = [np.asarray(a) for a in j_moe._route_and_sort(
        fam.jcfg, jnp.asarray(router), jnp.asarray(x), cap)]
    dest, tok, w, _ = moe._route_and_sort(
        fam.cfg, torch.from_numpy(router), torch.from_numpy(x), cap)
    np.testing.assert_array_equal(dest.numpy(), want[0])
    np.testing.assert_array_equal(tok.numpy(), want[1])
    np.testing.assert_allclose(w.numpy(), want[2], rtol=0, atol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("skew", [0.0, SKEW], ids=["plain", "overflow"])
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_moe_block_matches_the_reference(arch, skew, f32, families):
    fam = families[arch]
    jp, tp = _layer0(fam, f32)
    x = _x(fam, 40, seed=11, skew=skew).reshape(2, 20, -1)
    jdt, tdt = ((jnp.float32, torch.float32) if f32
                else (jnp.bfloat16, torch.bfloat16))
    want = np.asarray(j_moe.moe_block(fam.jcfg, jp,
                                      jnp.asarray(x).astype(jdt)),
                      np.float32)
    got = moe.moe_block(fam.cfg, tp, torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt and got.shape == x.shape
    got = got.float().numpy()
    if f32:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.0 ** -7 * np.abs(want).max())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("skew", [0.0, SKEW], ids=["plain", "skewed"])
def test_aux_load_loss_matches_the_reference(arch, skew, families):
    fam = families[arch]
    jp, tp = _layer0(fam)
    x = _x(fam, 48, seed=13, skew=skew).reshape(2, 24, -1)
    want = float(j_moe.aux_load_loss(fam.jcfg, jp, jnp.asarray(x)))
    got = moe.aux_load_loss(fam.cfg, tp, torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.dim() == 0
    assert abs(float(got) - want) <= 1e-5 * max(1.0, abs(want))


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_apply_in_float32_matches_the_reference(arch, families,
                                                monkeypatch):
    calls = count_flash(monkeypatch)
    families[arch].check_apply(64, 1, True)
    assert calls == [0] * families[arch].cfg.n_layers


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("s,seed", [(64, 1), (24, 2)])
def test_apply_in_bf16_matches_the_reference(arch, s, seed, families):
    fam = families[arch]
    got = fam.port_apply(s, seed, False)
    assert got.dtype == torch.bfloat16
    got, want = got.float().numpy(), fam.ref_apply(s, seed, False)
    assert rms(got - want) <= MOE_BF16_RMS_FRAC * rms(want)
    assert np.abs(got - want).max() <= \
        MOE_BF16_MAX_FRAC * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("f32", [True, False], ids=["f32", "bf16"])
def test_loss_matches_the_reference(arch, f32, families):
    families[arch].check_loss(f32=f32,
                              atol=LOSS_ATOL if f32 else MOE_BF16_LOSS_ATOL)


def test_subnormal_router_probabilities_pinned(families):
    # router logits ~100 above the rest: the reference flushes the
    # others' subnormal probabilities to 0 and takes the lowest expert
    # among them as the second choice; the port keeps them and takes the
    # largest
    fam = families["olmoe-1b-7b"]
    jp, tp = _layer0(fam)
    x = _x(fam, 64, seed=64, skew=40.0)[0]
    jprobs = np.asarray(jax.nn.softmax(jnp.einsum(
        "td,de->te", jnp.asarray(x), jp["router"]), axis=-1))
    tprobs = moe._router_probs(tp["router"], torch.from_numpy(x)).numpy()
    tiny = np.finfo(np.float32).tiny
    sub = (tprobs > 0) & (tprobs < tiny)
    assert sub.any() and (jprobs[sub] == 0).all()
    jsel = np.asarray(jax.lax.top_k(jnp.asarray(jprobs), 2)[1])
    tsel = moe._top_k(torch.from_numpy(tprobs), 2)[1].numpy()
    differ = (jsel != tsel).any(axis=1)
    assert differ.any()
    # every disagreement is a second choice among flushed probabilities
    for t in np.flatnonzero(differ):
        assert (jsel[t, 0], tsel[t, 0]) == (0, 0)
        assert jprobs[t, jsel[t, 1]] == 0 and sub[t, tsel[t, 1]]
        assert jsel[t, 1] == np.flatnonzero(jprobs[t] == 0)[0]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits_and_cache_match_the_reference(arch, families):
    families[arch].check_prefill_cache()


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_in_float32_matches_the_reference(arch,
                                                                families):
    families[arch].check_teacher_forced(True)


@pytest.mark.parametrize("arch", ARCHS)
def test_teacher_forced_decode_in_bf16_matches_the_reference(arch,
                                                             families):
    fam = families[arch]
    toks, _ = fam.inputs(PROMPT + STEPS, 4)
    want, _, _ = fam.ref_teacher_forced(toks, None, False)
    got, _, _ = fam.port_teacher_forced(toks, None, False)
    got, want = np.stack(got), np.stack(want)
    assert rms(got - want) <= MOE_BF16_RMS_FRAC * rms(want)
    assert np.abs(got - want).max() <= \
        MOE_BF16_MAX_FRAC * np.abs(want).max()


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_generate_matches_the_reference(arch, families):
    families[arch].check_greedy()
