"""The port's int8 error-feedback gradient compression against the
reference's (``repro.train.grad_compress``).

* ``quantize_leaf``/``dequantize_leaf`` bit-equal to the reference's,
  round-half-to-even ties included, over several error-feedback steps;
* the reference's convergence test (``test_optimized_paths.py``) on the
  port;
* ``compress_allreduce`` on 2 gloo ranks (``pod``) and
  ``hierarchical_compress_allreduce`` on ``(pod=2, data=2)``, two steps
  each (the second with the first's error buffers), with leaves whose
  size the inner axis does not divide, against the reference's
  ``shard_map`` bodies on 2 and 4 virtual devices (one subprocess, run
  while the ranks run): the pods' int8 sum exactly equal, the gradients
  equal (the bfloat16 leaf to one bfloat16 rounding step), the error
  buffers to one float32 rounding (``ERR_ATOL``: the reference's jit
  fuses the residual into a multiply-add);
* the payload's dtype: float16 holds every sum of 16 pods' int8 values
  exactly, not of 17, where the payload is int32.

Inputs are numpy-seeded; no Hypothesis.
"""
import os
import subprocess
import sys
import tempfile
import textwrap
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.train import grad_compress as JG
from repro_torch.launch.mesh import launch_ranks
from repro_torch.train import grad_compress as TG
from torch_sharded_cases import compress_case
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = 60
#: the error buffers' tolerance against the reference's jitted bodies: one
#: rounding of ``g + err`` (|g + err| < 4 here, a float32 step of 4.8e-7
#: at most; 3.0e-7 measured)
ERR_ATOL = 1e-6
#: leaves of 35, 7 and 48 elements: the first two do not divide over 2
SHAPES = {"w": (5, 7), "b": (7,), "bf16_m": (4, 4, 3)}


def _grads(n, seed):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(0, 1, (n,) + s).astype(np.float32)
            for k, s in SHAPES.items()}


def _errs(n, seed, scattered):
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in SHAPES.items():
        size = int(np.prod(s))
        shape = ((size + 1) // 2,) if scattered else s
        out[k] = rng.normal(0, 0.01, (n,) + shape).astype(np.float32)
    return out


REF = textwrap.dedent("""
    import sys
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh, PartitionSpec as P
    from repro.compat import shard_map
    from repro.train.grad_compress import (
        compress_allreduce, hierarchical_compress_allreduce, quantize_leaf)
    inp = dict(np.load(sys.argv[1], allow_pickle=True))
    out = {}

    def cast(k, v):
        return v.astype(jnp.bfloat16) if k.startswith("bf16") else v

    def run(mesh, axes, g, e, body):
        spec = P(axes)
        def f(g, e):
            g = {k: cast(k, v[0]) for k, v in g.items()}
            e = {k: v[0] for k, v in e.items()}
            g2, e2 = body(g, e)
            return ({k: v.astype(jnp.float32)[None] for k, v in g2.items()},
                    {k: v[None] for k, v in e2.items()})
        sm = shard_map(f, mesh=mesh, in_specs=(spec, spec),
                       out_specs=(spec, spec), check_vma=False,
                       axis_names=frozenset(axes))
        return jax.jit(sm)(g, e)

    for name, axes, shape, body in (
            ("flat", ("pod",), (2,), compress_allreduce),
            ("hier", ("pod", "data"), (2, 2),
             hierarchical_compress_allreduce)):
        n = int(np.prod(shape))
        mesh = Mesh(np.array(jax.devices()[:n]).reshape(shape), axes)
        g = {k[len(name) + 3:]: v for k, v in inp.items()
             if k.startswith(name + "_g")}
        e = {k[len(name) + 3:]: v for k, v in inp.items()
             if k.startswith(name + "_e")}
        for it in range(2):
            g2, e = run(mesh, axes, g, e, body)
            for k in g2:
                out[f"{name}_grads{it}_{k}"] = np.asarray(g2[k])
                out[f"{name}_errs{it}_{k}"] = np.asarray(e[k])
        if name == "flat":
            for k, v in g.items():
                qs = [np.asarray(quantize_leaf(
                    cast(k, v[i]), jnp.zeros(v.shape[1:], jnp.float32))[0])
                    for i in range(n)]
                out[f"qsum_{k}"] = np.sum(np.stack(qs).astype(np.int64),
                                          axis=0)
    np.savez(sys.argv[2], **out)
    print("OK")
""")


@pytest.fixture(scope="module")
def runs():
    """The two rank groups and the reference's subprocess, together."""
    flat_g, flat_e = _grads(2, 1), _errs(2, 2, False)
    hier_g, hier_e = _grads(4, 3), _errs(4, 4, True)
    with tempfile.TemporaryDirectory(prefix="gc_ref_") as tmp:
        inp = os.path.join(tmp, "in.npz")
        np.savez(inp, **{f"flat_g_{k}": v for k, v in flat_g.items()},
                 **{f"flat_e_{k}": v for k, v in flat_e.items()},
                 **{f"hier_g_{k}": v for k, v in hier_g.items()},
                 **{f"hier_e_{k}": v for k, v in hier_e.items()})
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.path.join(REPO, "src")
        outp = os.path.join(tmp, "out.npz")
        proc = subprocess.Popen([sys.executable, "-c", REF, inp, outp],
                                env=env, stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True)
        with ThreadPoolExecutor(2) as ex:
            flat = ex.submit(launch_ranks, compress_case, 2, device="cpu",
                             timeout=GROUP_TIMEOUT, args=(
                                 flat_g, flat_e, (2,), ("pod",), False))
            hier = ex.submit(launch_ranks, compress_case, 4, device="cpu",
                             timeout=GROUP_TIMEOUT, args=(
                                 hier_g, hier_e, (2, 2), ("pod", "data"),
                                 True))
            flat, hier = flat.result(), hier.result()
        _, err = proc.communicate(timeout=300)
        assert proc.returncode == 0, err[-3000:]
        ref = dict(np.load(outp))
    return {"flat": flat, "hier": hier, "ref": ref}


def _close(got, want, key):
    if key.startswith("bf16"):
        # the same float32 result rounded once to bfloat16 by each package
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)
    else:
        np.testing.assert_array_equal(got, want)


def test_quantize_bit_equal_with_ties():
    # scale = 0.125 exactly (the 1e-12 is below float32's resolution
    # there), so these values divide to exact halves: round half to even
    g = np.array([127, 0.5, 1.5, 2.5, -2.5, -0.5, 3.5, 0], np.float32) / 8
    q, scale, err = TG.quantize_leaf(torch.from_numpy(g),
                                     torch.zeros(g.shape))
    jq, jscale, jerr = JG.quantize_leaf(jnp.asarray(g), jnp.zeros(g.shape))
    assert q.tolist() == [127, 0, 2, 2, -2, 0, 4, 0]
    assert q.numpy().tolist() == np.asarray(jq).tolist()
    assert float(scale) == float(jscale)
    np.testing.assert_array_equal(err.numpy(), np.asarray(jerr))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_dequantize_bit_equal_over_steps(dtype):
    rng = np.random.default_rng(11)
    e_t = torch.zeros(300)
    e_j = jnp.zeros(300, jnp.float32)
    for _ in range(5):
        g = rng.normal(0, 1, 300).astype(np.float32)
        gt = torch.from_numpy(g).to(getattr(torch, dtype))
        gj = jnp.asarray(g).astype(getattr(jnp, dtype))
        q, s, e_t = TG.quantize_leaf(gt, e_t)
        jq, js, e_j = JG.quantize_leaf(gj, e_j)
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(e_t.numpy(), np.asarray(e_j))
        np.testing.assert_array_equal(
            TG.dequantize_leaf(q, s).numpy(),
            np.asarray(JG.dequantize_leaf(jq, js)))


def test_error_feedback_converges():
    """EF accumulates residuals: the mean of the compressed gradients over
    steps approaches the true gradient (the reference's test)."""
    g = torch.from_numpy(np.random.default_rng(7).normal(0, 1, (256,))
                         .astype(np.float32))
    err = torch.zeros_like(g)
    total = torch.zeros_like(g)
    for _ in range(50):
        q, scale, err = TG.quantize_leaf(g, err)
        total = total + TG.dequantize_leaf(q, scale)
    assert (total / 50 - g).abs().max() < 0.01


def test_buffers():
    params = {"a": torch.zeros(5, 7), "b": {"c": torch.zeros(3)}}
    e = TG.init_error_buffers(params)
    assert e["a"].shape == (5, 7) and e["b"]["c"].dtype == torch.float32
    s = TG.init_scattered_error_buffers(params, 2)
    assert s["a"].shape == (18,) and s["b"]["c"].shape == (2,)
    j = JG.init_scattered_error_buffers(
        {"a": jnp.zeros((5, 7)), "b": {"c": jnp.zeros(3)}}, 2)
    assert j["a"].shape == s["a"].shape


def test_payload_dtype_at_16_and_17_pods():
    assert TG.payload_dtype(16) == torch.float16
    assert TG.payload_dtype(17) == torch.int32
    # the largest sums: exact in float16 at 16 pods, not at 17
    for n, exact in ((16, True), (17, False)):
        total = torch.zeros((), dtype=torch.float16)
        for _ in range(n):
            total = total + torch.tensor(127, dtype=torch.float16)
        assert (int(total) == 127 * n) is exact, n
    total = torch.zeros((), dtype=TG.payload_dtype(17))
    for _ in range(17):
        total = total + 127
    assert int(total) == 127 * 17


def test_pod_allreduce_int_sum_exact(runs):
    ref = runs["ref"]
    for rank in runs["flat"]:
        for k in SHAPES:
            np.testing.assert_array_equal(rank["q_sum"][k],
                                          ref[f"qsum_{k}"].astype(np.float32))


@pytest.mark.parametrize("name", ["flat", "hier"])
def test_compressed_sync_equals_the_reference(runs, name):
    ref = runs["ref"]
    for r, rank in enumerate(runs[name]):
        for it in range(2):
            for k in SHAPES:
                _close(rank[f"grads{it}"][k],
                       ref[f"{name}_grads{it}_{k}"][r], k)
                # the reference's jitted body fuses ``gf - q * scale``
                # into one multiply-add: one rounding of gf apart
                np.testing.assert_allclose(
                    rank[f"errs{it}"][k], ref[f"{name}_errs{it}_{k}"][r],
                    rtol=0, atol=ERR_ATOL)
    # every rank ends with the same gradients
    for rank in runs[name][1:]:
        for k in SHAPES:
            np.testing.assert_array_equal(rank["grads1"][k],
                                          runs[name][0]["grads1"][k])


def test_make_pod_grad_compress_is_the_pod_body():
    assert callable(TG.make_pod_grad_compress(object(), None))
