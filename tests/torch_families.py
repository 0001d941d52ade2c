"""Shared parity checks of the dense, MoE and VLM families
(``tests/test_torch_{dense,moe,vlm}.py``): each architecture's
``reduced_config`` in both packages, the reference's weights
(``init_params(..., PRNGKey(0))``) carried into the port by
``params_from_numpy``, and the same numpy-seeded tokens (and, for the VLM,
patch embeddings) into both.

Tolerances, with reasons:

* ``apply`` on float32 weights: logits to 5e-4 absolute (magnitude ~2),
  those of ``tests/test_torch_lm_models.py`` (``torch_parity``);
* ``apply`` on bf16 weights: logits within 3% of their RMS in RMS and 8%
  of their largest magnitude, over all positions; the loss to 2e-3
  (``torch_parity``; the MoE family states its own, in its test);
* prefill and decode on float32 weights: the KV cache is bf16 in both
  packages, and each layer's attention reads its keys and values back
  from it. Where the two packages' float32 k or v (which agree to ~1e-6)
  straddle a bf16 rounding boundary, the entries differ by one bf16
  step, which moves the later layers' inputs by up to ~1e-3 relative. So
  the cache's entries agree to two bf16 steps (2**-6 of their magnitude,
  plus 1e-6 near zero), and at most 5% of them differ at all (measured on
  the seven architectures: 2 steps, 1.7%); the logits of the prefill and
  of every decode step to 3e-3 absolute (measured: 1.5e-3). Greedy
  tokens agree up to the first step whose reference top-2 margin is under
  that tolerance (``agreeing_prefix``);
* prefill and decode on bf16 weights: the bf16 logit fractions above,
  over all steps together.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.configs import reduced_config as j_reduced_config
from repro.distributed.sharding import init_params as j_init_params
from repro.models import get_model as j_get_model
from repro.train.train_step import make_loss_fn as j_make_loss_fn
from repro_torch.configs import get_config, reduced_config
from repro_torch.models import get_model
from repro_torch.models.convert import params_from_numpy
from repro_torch.serve import greedy_generate, make_prefill, make_serve_step
from repro_torch.serve.decode import grow_cache
from repro_torch.train.train_step import make_loss_fn
from torch_parity import (F32_LOGIT_ATOL, LOSS_ATOL, agreeing_prefix,
                          assert_bf16_logits_close)

#: teacher-forced decoding: prompt tokens, then decode steps
PROMPT, STEPS = 7, 5
#: the stub ViT's patch width (``models/vlm.py::VIT_DIM``)
VIT_DIM = 1024
#: float32 weights through the bf16 KV cache: logits, cache entries
#: (two bf16 steps, relative) and the share of cache entries that differ
F32_CACHED_LOGIT_ATOL = 3e-3
CACHE_RTOL, CACHE_DIFF_SHARE = 2.0 ** -6, 0.05


class Family:
    """One architecture's reference: reduced configs of both packages,
    the reference's bf16 weights, its prefill and decode step under
    ``jax.jit``, and a memo of its outputs."""

    def __init__(self, arch, **replace):
        self.arch = arch
        self.jcfg = dataclasses.replace(
            j_reduced_config(j_get_config(arch)), **replace)
        self.cfg = dataclasses.replace(reduced_config(get_config(arch)),
                                       **replace)
        self.jmodel = j_get_model(self.jcfg.family)
        self.model = get_model(self.cfg.family)
        specs = self.jmodel.param_specs(self.jcfg)
        self.params = jax.jit(lambda key: j_init_params(specs, key))(
            jax.random.PRNGKey(0))
        self.params32 = jax.tree_util.tree_map(
            lambda a: a.astype(jnp.float32), self.params)
        self.prefill = jax.jit(self.jmodel.prefill, static_argnums=0)
        self.step = jax.jit(self.jmodel.decode_step, static_argnums=0)
        self.memo = {}

    @property
    def vlm(self):
        return self.cfg.family == "vlm"

    def port_params(self, f32=False):
        tree = self.params32 if f32 else self.params
        return params_from_numpy(jax.tree_util.tree_map(np.asarray, tree),
                                 device="cpu")

    def inputs(self, n, seed):
        """(tokens [2, n], patches [2, n_prepend, VIT_DIM] or None)."""
        rng = np.random.default_rng(seed)
        toks = rng.integers(0, self.cfg.vocab_size, (2, n)).astype(np.int32)
        patches = (rng.normal(0, 1, (2, self.cfg.n_prepend, VIT_DIM))
                   .astype(np.float32) if self.vlm else None)
        return toks, patches

    def _jkw(self, patches):
        return {} if patches is None else {"patches": jnp.asarray(patches)}

    def _tkw(self, patches):
        return {} if patches is None else {
            "patches": torch.from_numpy(patches)}

    # -- apply ------------------------------------------------------------

    def ref_apply(self, n, seed, f32):
        key = ("apply", n, seed, f32)
        if key not in self.memo:
            toks, patches = self.inputs(n, seed)
            self.memo[key] = np.asarray(self.jmodel.apply(
                self.jcfg, self.params32 if f32 else self.params,
                jnp.asarray(toks), **self._jkw(patches)), np.float32)
        return self.memo[key]

    def port_apply(self, n, seed, f32):
        toks, patches = self.inputs(n, seed)
        with torch.inference_mode():
            return self.model.apply(self.cfg, self.port_params(f32),
                                    torch.from_numpy(toks),
                                    **self._tkw(patches))

    def check_apply(self, n, seed, f32):
        got = self.port_apply(n, seed, f32)
        want = self.ref_apply(n, seed, f32)
        assert got.dtype == (torch.float32 if f32 else torch.bfloat16)
        positions = n + (self.cfg.n_prepend if self.vlm else 0)
        assert got.shape == (2, positions, self.cfg.vocab_padded)
        if f32:
            np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                       atol=F32_LOGIT_ATOL)
        else:
            assert_bf16_logits_close(got.float().numpy(), want)

    # -- loss -------------------------------------------------------------

    def check_loss(self, n=24, seed=5, f32=False, atol=LOSS_ATOL):
        toks, patches = self.inputs(n + 1, seed)
        tokens, labels = toks[:, :-1], toks[:, 1:]
        mask = (np.arange(n)[None, :] < np.array([[n], [n - 9]])).astype(
            np.float32)
        want = float(j_make_loss_fn(self.jcfg)(
            self.params32 if f32 else self.params, dict(
            tokens=jnp.asarray(tokens), labels=jnp.asarray(labels),
            loss_mask=jnp.asarray(mask), **self._jkw(patches))))
        got = make_loss_fn(self.cfg)(self.port_params(f32), dict(
            tokens=torch.from_numpy(tokens),
            labels=torch.from_numpy(labels),
            loss_mask=torch.from_numpy(mask), **self._tkw(patches)))
        assert got.dtype == torch.float32 and got.dim() == 0
        assert abs(float(got) - want) <= atol, (float(got), want)
        return float(got), want

    # -- prefill and decode ------------------------------------------------

    def ref_teacher_forced(self, toks, patches, f32):
        params = self.params32 if f32 else self.params
        logits, cache = self.prefill(self.jcfg, params,
                                     jnp.asarray(toks[:, :PROMPT]),
                                     **self._jkw(patches))
        out = [np.asarray(logits, np.float32)]
        first = {k: np.asarray(v) for k, v in cache.items()}
        cache = grow_ref(cache, STEPS)
        for i in range(PROMPT, PROMPT + STEPS):
            logits, cache = self.step(self.jcfg, params, cache,
                                      jnp.asarray(toks[:, i:i + 1]))
            out.append(np.asarray(logits, np.float32))
        return out, first, int(cache["index"])

    def port_teacher_forced(self, toks, patches, f32):
        params = self.port_params(f32)
        prefill, step = make_prefill(self.cfg), make_serve_step(self.cfg)
        logits, cache = prefill(params, dict(
            tokens=torch.from_numpy(toks[:, :PROMPT]), **self._tkw(patches)))
        out = [logits.float().numpy()]
        first = {k: v.clone() for k, v in cache.items()}
        cache = grow_cache(cache, STEPS)
        for i in range(PROMPT, PROMPT + STEPS):
            logits, cache = step(params, cache,
                                 torch.from_numpy(toks[:, i:i + 1]))
            out.append(logits.float().numpy())
        return out, first, int(cache["index"])

    def check_prefill_cache(self, seed=3):
        toks, patches = self.inputs(PROMPT + STEPS, seed)
        want, wcache, _ = self.ref_teacher_forced(toks, patches, True)
        got, gcache, _ = self.port_teacher_forced(toks, patches, True)
        np.testing.assert_allclose(got[0], want[0], rtol=0,
                                   atol=F32_CACHED_LOGIT_ATOL)
        n_pos = PROMPT + (self.cfg.n_prepend if self.vlm else 0)
        assert sorted(gcache) == sorted(wcache) == ["index", "k", "v"]
        assert int(gcache["index"]) == int(wcache["index"]) == n_pos
        specs = self.model.cache_specs(self.cfg, 2, n_pos)
        for name in ("k", "v"):
            g, w = gcache[name], wcache[name]
            assert tuple(g.shape) == w.shape == specs[name].shape, name
            assert g.dtype == torch.bfloat16 and w.dtype.name == "bfloat16"
            g, w = g.float().numpy(), w.astype(np.float32)
            np.testing.assert_allclose(g, w, rtol=CACHE_RTOL, atol=1e-6,
                                       err_msg=name)
            assert (g != w).mean() <= CACHE_DIFF_SHARE, name

    def check_teacher_forced(self, f32, seed=4):
        toks, patches = self.inputs(PROMPT + STEPS, seed)
        want, _, widx = self.ref_teacher_forced(toks, patches, f32)
        got, _, gidx = self.port_teacher_forced(toks, patches, f32)
        assert gidx == widx == PROMPT + STEPS + (
            self.cfg.n_prepend if self.vlm else 0)
        for i, (g, w) in enumerate(zip(got, want)):
            assert g.shape == w.shape == (2, 1, self.cfg.vocab_padded)
            if f32:
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=F32_CACHED_LOGIT_ATOL,
                                           err_msg=f"step {i}")
        if not f32:
            assert_bf16_logits_close(np.stack(got), np.stack(want))

    def check_greedy(self, n_new=6, seed=6):
        prompt, patches = self.inputs(PROMPT, seed)
        params = self.params32
        logits, cache = self.prefill(self.jcfg, params, jnp.asarray(prompt),
                                     **self._jkw(patches))
        cache = grow_ref(cache, n_new)
        steps, toks = [], []
        for i in range(n_new):
            if i:
                logits, cache = self.step(self.jcfg, params, cache,
                                          toks[-1])
            steps.append(np.asarray(logits[:, -1], np.float32))
            toks.append(jnp.argmax(logits[:, -1:], axis=-1).astype(
                jnp.int32))
        want = np.asarray(jnp.concatenate(toks, axis=1))
        got = greedy_generate(self.cfg, self.port_params(True), dict(
            tokens=torch.from_numpy(prompt), **self._tkw(patches)), n_new)
        assert got.dtype == torch.int32 and got.shape == (2, n_new)
        n = agreeing_prefix(np.stack(steps), F32_CACHED_LOGIT_ATOL)
        assert n >= 1
        np.testing.assert_array_equal(got.numpy()[:, :n], want[:, :n])
        return n


def grow_ref(cache, n):
    pad = [(0, 0)] * cache["k"].ndim
    pad[-2] = (0, n)
    return dict(cache, k=jnp.pad(cache["k"], pad), v=jnp.pad(cache["v"], pad))


def leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], prefix + (k,))
    else:
        yield prefix, tree


def check_configs(arch):
    for j, t in ((j_get_config(arch), get_config(arch)),
                 (j_reduced_config(j_get_config(arch)),
                  reduced_config(get_config(arch)))):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
        assert (j.vocab_padded, j.d_inner) == (t.vocab_padded, t.d_inner)


def check_param_specs(arch, reduced):
    from repro.distributed.sharding import ParamSpec as JParamSpec
    from repro_torch.distributed.sharding import ParamSpec
    jcfg, cfg = j_get_config(arch), get_config(arch)
    if reduced:
        jcfg, cfg = j_reduced_config(jcfg), reduced_config(cfg)
    jl = list(leaves(j_get_model(jcfg.family).param_specs(jcfg)))
    tl = list(leaves(get_model(cfg.family).param_specs(cfg)))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, j), (_, t) in zip(jl, tl):
        assert isinstance(j, JParamSpec) and isinstance(t, ParamSpec), path
        assert (j.shape, j.init, j.init_scale) == \
            (t.shape, t.init, t.init_scale), path
        assert np.dtype(j.dtype).name == str(t.dtype).split(".")[-1], path
    return dict(tl)


def check_round_trip(fam):
    """``params_from_numpy`` reproduces the reference's tree: paths,
    shapes, dtypes and bytes. Returns the port's tree."""
    tree = jax.tree_util.tree_map(np.asarray, fam.params)
    port = params_from_numpy(tree, device="cpu")
    jl, tl = list(leaves(tree)), list(leaves(port))
    assert [p for p, _ in jl] == [p for p, _ in tl]
    for (path, a), (_, t) in zip(jl, tl):
        assert tuple(t.shape) == a.shape, path
        assert str(t.dtype).split(".")[-1] == a.dtype.name, path
        assert t.float().numpy().astype(a.dtype).tobytes() == a.tobytes(), \
            path
    return port


def count_flash(monkeypatch):
    """Calls of the flash kernel's dispatcher from the models' attention
    (the card's launches: on the CPU it runs the plain version)."""
    import repro_torch.models.layers as layers
    calls = []
    real = layers.flash_attention

    def counted(*a, **kw):
        calls.append(kw.get("window"))
        return real(*a, **kw)

    monkeypatch.setattr(layers, "flash_attention", counted)
    return calls
