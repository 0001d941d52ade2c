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
import torch.nn.functional as F

from repro.kernels.rwkv6.ref import rwkv6_chunked as j_chunked
from repro.kernels.rwkv6.ref import rwkv6_scan_ref as j_scan
from repro.kernels.rwkv6.rwkv6 import rwkv6_pallas
from repro_torch.kernels import launch_counts, reset_launch_counts, selfcheck
from repro_torch.kernels.rwkv6 import (rwkv6, rwkv6_chunked, rwkv6_kernel,
                                       rwkv6_scan_ref)
from repro_torch.kernels.rwkv6.kernel import CHUNK, SEGMENT_CHUNKS
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
# the CUDA kernel's bf16 route, emulated on the CPU: the same segments and
# transitions, the same operand rounding, held against the plain version
# and the reference's Pallas kernel at selfcheck.TOLERANCE
# ---------------------------------------------------------------------------

def _split(x):
    """x ~ hi + lo, both bf16 values: the kernel's split operand."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mm2(a, b):
    """float32 a times bf16 b on the tensor cores: two passes, a split."""
    ah, al = _split(a)
    return ah @ b + al @ b


def _mm3(a, b):
    """float32 a times float32 b: three passes, hi.hi + hi.lo + lo.hi."""
    ah, al = _split(a)
    bh, bl = _split(b)
    return ah @ bh + ah @ bl + al @ bh


#: the kernel's float32 log2(e)
LOG2E = 1.4426950408889634


def _exp(x):
    """exp as the kernel takes it: 2^(x log2(e)) on the special-function
    unit."""
    return torch.exp2(x * LOG2E)


def _emulate_bf16_route(r, k, v, w, u, state=None):
    """``csrc/rwkv6.cu``'s bf16 route: the decays' exponents in the plain
    version's bits (natural log, a sequential sum per column, cum - lw);
    segments of SEGMENT_CHUNKS chunks; every segment but the last run from
    a zero state to its transition (D, M); each segment run from the state
    the earlier transitions carry it, scores (bonus on the diagonal) times
    v and q S on split operands."""
    L, G = CHUNK, SEGMENT_CHUNKS
    b, h, t, n = r.shape
    pad = (-t) % L
    rf, kf, vf = (F.pad(x.float(), (0, 0, 0, pad)) for x in (r, k, v))
    lw = torch.log(torch.clamp_min(F.pad(w.float(), (0, 0, 0, pad),
                                         value=1.0), 1e-30))
    chunks = (t + pad) // L
    n_seg = max(1, -(-chunks // G))
    lower = torch.tril(torch.ones((L, L), dtype=torch.bool), diagonal=-1)

    def chunk(ci):
        sl = slice(ci * L, (ci + 1) * L)
        cum = torch.cumsum(lw[:, :, sl], dim=2)
        cl = cum[:, :, -1]
        kw = kf[:, :, sl] * _exp(cl[:, :, None] - cum)
        return sl, cum, cl, kw

    def update(s, sl, cl, kw):
        return (_exp(cl)[..., None] * s
                + _mm2(kw.transpose(-1, -2), vf[:, :, sl]))

    trans = []
    for sg in range(n_seg - 1):
        s, d = torch.zeros((b, h, n, n)), torch.ones((b, h, n))
        for ci in range(sg * G, (sg + 1) * G):
            sl, cum, cl, kw = chunk(ci)
            s, d = update(s, sl, cl, kw), d * _exp(cl)
        trans.append((d, s))
    ys = []
    for sg in range(n_seg):
        s = torch.zeros((b, h, n, n)) if state is None else state.float()
        for d, m in trans[:sg]:
            s = d[..., None] * s + m
        for ci in range(sg * G, min((sg + 1) * G, chunks)):
            sl, cum, cl, kw = chunk(ci)
            rc, kc = rf[:, :, sl], kf[:, :, sl]
            cex = cum - lw[:, :, sl]
            diff = cex[:, :, :, None, :] - cum[:, :, None, :, :]
            e = _exp(torch.where(lower[:, :, None], diff, -torch.inf))
            scores = (e * rc[:, :, :, None, :] * kc[:, :, None, :, :]).sum(-1)
            bonus = (rc * u.float()[None, :, None, :] * kc).sum(-1)
            scores = scores + torch.diag_embed(bonus)
            q = rc * _exp(cex)
            ys.append(_mm3(q, s) + _mm2(scores, vf[:, :, sl]))
            s = update(s, sl, cl, kw)
    y = torch.cat(ys, dim=2) if ys else rf
    return y[:, :, :t].to(r.dtype), s


SEG = CHUNK * SEGMENT_CHUNKS


@pytest.mark.parametrize("t,state,zero_run", [
    (1, True, None), (CHUNK, False, None), (2 * SEG + 88, False, None),
    (SEG + 40, True, None), (SEG + 88, False, (SEG - 16, 35))])
def test_bf16_route_emulation_matches_plain_version(t, state, zero_run):
    # T = 1, one chunk, three segments with a ragged tail, an initial
    # state, and 35 zero decays across a segment boundary
    x = selfcheck.rwkv6_inputs(torch.device("cpu"), 1, 2, t, state=state,
                               zero_run=zero_run, seed=t)
    got = _emulate_bf16_route(*x)
    assert got[0].dtype == torch.bfloat16
    bad, err = selfcheck.out_of_tolerance(got, rwkv6_chunked(*x))
    assert bad == 0, err


def test_bf16_route_emulation_matches_the_pallas_kernel():
    # three segments, the last of one chunk; zero state and a chunk
    # multiple, as the Pallas kernel takes them
    r, k, v, w, u, _ = selfcheck.rwkv6_inputs(
        torch.device("cpu"), 1, 2, (2 * SEGMENT_CHUNKS + 1) * CHUNK, seed=5)
    got = _emulate_bf16_route(r, k, v, w, u)
    jy, js = rwkv6_pallas(*(jnp.asarray(x.float().numpy(), jnp.bfloat16)
                            for x in (r, k, v, w)), _j(u.numpy()),
                          chunk=CHUNK, interpret=True)
    want = (torch.from_numpy(np.asarray(jy, np.float32)).to(torch.bfloat16),
            torch.from_numpy(np.array(js)))
    bad, err = selfcheck.out_of_tolerance(got, want)
    assert bad == 0, err


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


def test_cuda_kernel_takes_unaligned_views(cuda_device):
    # contiguous views that start one element past a 16-byte boundary
    # (2 bytes for bf16, 4 for float32): the wrapper copies them, so the
    # kernel's 16-byte copies stay aligned
    from repro_torch.kernels import selfcheck
    x = selfcheck.rwkv6_inputs(cuda_device, 1, 2, 100, state=True)
    views = [selfcheck.offset_view(t) for t in x]
    assert all(t.data_ptr() % 16 for t in views)
    got = rwkv6_kernel(*views)
    assert all(torch.equal(g, w) for g, w in zip(got, rwkv6_kernel(*x)))
    bad, err = selfcheck.out_of_tolerance(got, rwkv6_chunked(*x))
    assert bad == 0, err
