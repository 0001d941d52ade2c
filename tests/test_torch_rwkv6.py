"""Port of the RWKV6 recurrence: the plain PyTorch versions against the
JAX package's per-token oracle, its chunked jnp form and its Pallas kernel
(interpret mode); the wrapper's input checks; and — on a machine with a
CUDA card only — the CUDA kernel against its plain version.

Inputs are made with ``numpy.random.default_rng(seed)`` and handed to both
packages as numpy arrays. Tolerances: float32 inputs agree to 1e-4
(absolute and relative; the two packages sum in different orders and the
chunked forms differ from the per-token scan by float32 rounding, about
1e-5 here); bfloat16 inputs to 5e-2, as the reference's own
``test_rwkv6_bf16_inputs`` (one bfloat16 step of outputs of magnitude
up to ~6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv6.ref import rwkv6_chunked as j_chunked
from repro.kernels.rwkv6.ref import rwkv6_scan_ref as j_scan
from repro.kernels.rwkv6.rwkv6 import rwkv6_pallas
from repro_torch.kernels import launch_counts, reset_launch_counts
from repro_torch.kernels.rwkv6 import (rwkv6, rwkv6_chunked, rwkv6_kernel,
                                       rwkv6_scan_ref)
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _inputs(b, h, t, n, seed, state=False):
    rng = np.random.default_rng(seed)
    r = rng.normal(0, 1, (b, h, t, n)).astype(np.float32)
    k = rng.normal(0, 0.3, (b, h, t, n)).astype(np.float32)
    v = rng.normal(0, 1, (b, h, t, n)).astype(np.float32)
    w = rng.uniform(0.6, 0.999, (b, h, t, n)).astype(np.float32)
    u = rng.normal(0, 0.3, (h, n)).astype(np.float32)
    s0 = rng.normal(0, 1, (b, h, n, n)).astype(np.float32) if state else None
    return r, k, v, w, u, s0


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("b,h,t,n,state", [
    (1, 2, 64, 16, False), (2, 3, 100, 32, False), (1, 2, 70, 64, True),
    (2, 1, 1, 64, False)])
def test_plain_versions_match_the_reference_scan(b, h, t, n, state):
    r, k, v, w, u, s0 = _inputs(b, h, t, n, seed=t + n, state=state)
    jy, js = j_scan(*map(_j, (r, k, v, w, u)), state=_j(s0))
    for fn in (rwkv6_chunked, rwkv6_scan_ref):
        y, s = fn(*map(_t, (r, k, v, w, u)), state=_t(s0))
        assert y.dtype == torch.float32 and s.dtype == torch.float32
        _close(y, jy, F32_TOL)
        _close(s, js, F32_TOL)


def test_chunked_matches_the_reference_chunked_form():
    # T = 40: not a chunk multiple (the reference pads as the port does)
    r, k, v, w, u, s0 = _inputs(2, 2, 40, 32, seed=3, state=True)
    jy, js = jax.jit(j_chunked, static_argnames="chunk")(
        *map(_j, (r, k, v, w, u)), state=_j(s0), chunk=32)
    y, s = rwkv6_chunked(*map(_t, (r, k, v, w, u)), state=_t(s0), chunk=32)
    _close(y, jy, F32_TOL)
    _close(s, js, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_chunked_matches_the_pallas_kernel(dtype):
    r, k, v, w, u, _ = _inputs(1, 2, 64, 64, seed=6)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jy, js = rwkv6_pallas(*(_j(a, jdt) for a in (r, k, v, w)), _j(u),
                          chunk=32, interpret=True)
    y, s = rwkv6_chunked(*(_t(a, tdt) for a in (r, k, v, w)), _t(u))
    assert y.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(y, jy, tol)
    _close(s, js, tol)


def test_padding_leaves_outputs_and_state_unchanged():
    # T = 70 runs as 96 padded positions; the first 70 outputs and the
    # final state equal the per-token scan over 70 tokens
    r, k, v, w, u, _ = _inputs(1, 2, 70, 32, seed=9)
    y, s = rwkv6_chunked(*map(_t, (r, k, v, w, u)))
    ys, ss = rwkv6_scan_ref(*map(_t, (r, k, v, w, u)))
    assert y.shape == (1, 2, 70, 32)
    torch.testing.assert_close(y, ys, **F32_TOL)
    torch.testing.assert_close(s, ss, **F32_TOL)


def test_decay_at_zero_stays_finite():
    # w = 0 (log w clamped to log 1e-30) at a few positions of each chunk;
    # long runs of it put |cum| in the thousands, where float32 resolves
    # the exponent only to ~1e-4 (in the reference's log-space form too)
    r, k, v, w, u, _ = _inputs(1, 1, 64, 16, seed=4)
    w[:, :, [5, 6, 7, 20, 40, 41, 63]] = 0.0
    y, s = rwkv6_chunked(*map(_t, (r, k, v, w, u)))
    jy, js = j_scan(*map(_j, (r, k, v, w, u)))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    _close(y, jy, F32_TOL)
    _close(s, js, F32_TOL)


def test_long_run_of_zero_decay_is_as_precise_as_the_reference():
    # 35 positions of w = 0 put cum near -2400: float32 then holds the
    # log-space exponents to ~2e-4, and the reference's own chunked forms
    # and its scan differ by 4e-4 on these inputs; the port agrees with
    # the scan and the Pallas kernel to 1e-3
    r, k, v, w, u, _ = _inputs(1, 1, 64, 16, seed=4)
    w[:, :, 5:40] = 0.0
    y, s = rwkv6_chunked(*map(_t, (r, k, v, w, u)))
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    ins = tuple(map(_j, (r, k, v, w, u)))
    for jy, js in (j_scan(*ins), rwkv6_pallas(*ins, interpret=True)):
        _close(y, jy, dict(atol=1e-3, rtol=1e-3))
        _close(s, js, dict(atol=1e-3, rtol=1e-3))


def test_dispatch_takes_the_plain_version_on_the_cpu():
    r, k, v, w, u, _ = _inputs(1, 2, 40, 64, seed=2)
    reset_launch_counts()
    y, s = rwkv6(*map(_t, (r, k, v, w, u)))
    y2, s2 = rwkv6_chunked(*map(_t, (r, k, v, w, u)))
    assert torch.equal(y, y2) and torch.equal(s, s2)
    assert launch_counts()["rwkv6"] == 0
    with pytest.raises(ValueError, match="CUDA tensors only"):
        rwkv6(*map(_t, (r, k, v, w, u)), use_kernel=True)


def test_kernel_wrapper_refuses_grad_and_cpu_tensors():
    r, k, v, w, u, _ = _inputs(1, 1, 32, 64, seed=1)
    args = list(map(_t, (r, k, v, w, u)))
    with pytest.raises(ValueError, match="CUDA tensors"):
        rwkv6_kernel(*args)
    args[0].requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        rwkv6_kernel(*args)
    with pytest.raises(ValueError, match="head size 64"):
        rwkv6_kernel(*map(_t, _inputs(1, 1, 32, 16, seed=1)[:5]))


# ---------------------------------------------------------------------------
# on the card: the CUDA kernel against its plain version
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_kernel_matches_plain_version(cuda_device):
    from repro_torch.kernels import selfcheck
    cases = [c for c in selfcheck.recurrence_cases(
        cuda_device, rwkv6_shape=(2, 8, 256), ssd_shape=(1, 2, 64))
        if c.kernel == "rwkv6"]
    bad = {c.label: selfcheck.float_mismatches(c) for c in cases}
    assert not any(n for n, _ in bad.values()), bad
