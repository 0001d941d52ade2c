"""Port of the Mamba2 SSD recurrence: the plain PyTorch versions against
the JAX package's per-token oracle, its chunked jnp form and its Pallas
kernel (interpret mode); the dispatcher's rounding of ``x*dt``; the
wrapper's input checks; and — on a machine with a CUDA card only — the
CUDA kernel against its plain version.

Inputs are made with ``numpy.random.default_rng(seed)`` and handed to both
packages as numpy arrays. Tolerances: float32 inputs agree to 1e-4
(absolute and relative; float32 summation order); bfloat16 inputs to
5e-2, one bfloat16 step of outputs of magnitude up to ~6, as for rwkv6.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels.mamba2.mamba2 import mamba2_ssd_pallas
from repro.kernels.mamba2.ops import mamba2_ssd as j_dispatch
from repro.kernels.mamba2.ref import ssd_chunked as j_chunked
from repro.kernels.mamba2.ref import ssd_scan_ref as j_scan
from repro_torch.kernels import launch_counts, reset_launch_counts, selfcheck
from repro_torch.kernels.mamba2 import (mamba2_ssd, mamba2_ssd_kernel,
                                        mamba2_ssd_ref, ssd_chunked,
                                        ssd_scan_ref)
from repro_torch.kernels.mamba2.kernel import CHUNK, SEGMENT_CHUNKS
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

F32_TOL = dict(atol=1e-4, rtol=1e-4)
BF16_TOL = dict(atol=5e-2, rtol=5e-2)


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _inputs(b, h, t, p, n, seed, state=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (b, h, t, p)).astype(np.float32)
    dt = rng.uniform(0.001, 0.1, (b, h, t)).astype(np.float32)
    a = -rng.uniform(0.5, 2.0, (h,)).astype(np.float32)
    bm = rng.normal(0, 1, (b, t, n)).astype(np.float32)
    cm = rng.normal(0, 1, (b, t, n)).astype(np.float32)
    s0 = rng.normal(0, 1, (b, h, n, p)).astype(np.float32) if state else None
    return x, dt, a, bm, cm, s0


def _t(a, dtype=torch.float32):
    return None if a is None else torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return None if a is None else jnp.asarray(a, dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("b,h,t,p,n,state", [
    (1, 1, 64, 16, 16, False), (2, 2, 100, 32, 16, False),
    (1, 3, 130, 64, 64, True), (2, 1, 1, 64, 64, False)])
def test_plain_versions_match_the_reference_scan(b, h, t, p, n, state):
    x, dt, a, bm, cm, s0 = _inputs(b, h, t, p, n, seed=t + p, state=state)
    jy, js = j_scan(*map(_j, (x, dt, a, bm, cm)), state=_j(s0))
    for fn in (ssd_chunked, ssd_scan_ref):
        y, s = fn(*map(_t, (x, dt, a, bm, cm)), state=_t(s0))
        assert y.dtype == torch.float32 and s.dtype == torch.float32
        _close(y, jy, F32_TOL)
        _close(s, js, F32_TOL)


def test_chunked_matches_the_reference_chunked_form():
    # T = 100: not a chunk multiple (the reference pads as the port does)
    x, dt, a, bm, cm, s0 = _inputs(2, 2, 100, 32, 16, seed=5, state=True)
    jy, js = jax.jit(j_chunked, static_argnames="chunk")(
        *map(_j, (x, dt, a, bm, cm)), state=_j(s0), chunk=64)
    y, s = ssd_chunked(*map(_t, (x, dt, a, bm, cm)), state=_t(s0), chunk=64)
    _close(y, jy, F32_TOL)
    _close(s, js, F32_TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_the_pallas_kernel(dtype):
    x, dt, a, bm, cm, _ = _inputs(2, 2, 128, 64, 64, seed=10)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    xdt = (x * dt[..., None]).astype(np.float32)
    la = (dt * a[None, :, None]).astype(np.float32)
    jy, js = mamba2_ssd_pallas(_j(xdt, jdt), _j(la), _j(bm, jdt),
                               _j(cm, jdt), chunk=64, interpret=True)
    y, s = mamba2_ssd_ref(_t(xdt, tdt), _t(la), _t(bm, tdt), _t(cm, tdt))
    assert y.dtype == tdt
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    _close(y, jy, tol)
    _close(s, js, tol)


def test_dispatcher_follows_the_pallas_route_in_bf16():
    # the reference's dispatcher rounds x*dt to bf16 on its Pallas route
    # (T a chunk multiple, use_pallas=True); the port does so on both
    # devices and for any T, so the outputs agree to float32 rounding
    # before the final cast (1e-2: two bfloat16 steps at magnitude ~1)
    x, dt, a, bm, cm, _ = _inputs(1, 2, 128, 64, 64, seed=12)
    bf = dict(dtype=torch.bfloat16)
    jy, js = j_dispatch(_j(x, jnp.bfloat16), _j(dt), _j(a),
                        _j(bm, jnp.bfloat16), _j(cm, jnp.bfloat16),
                        use_pallas=True)
    reset_launch_counts()
    y, s = mamba2_ssd(_t(x, **bf), _t(dt), _t(a), _t(bm, **bf),
                      _t(cm, **bf))
    assert launch_counts()["mamba2_ssd"] == 0
    _close(y, jy, dict(atol=1e-2, rtol=1e-2))
    _close(s, js, F32_TOL)
    # the chunked route keeps x*dt in float32: a looser agreement
    jy2, js2 = jax.jit(j_dispatch, static_argnames="use_pallas")(
        _j(x, jnp.bfloat16), _j(dt), _j(a), _j(bm, jnp.bfloat16),
        _j(cm, jnp.bfloat16), use_pallas=False)
    _close(y, jy2, BF16_TOL)
    _close(s, js2, dict(atol=1e-2, rtol=1e-2))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        mamba2_ssd(_t(x), _t(dt), _t(a), _t(bm), _t(cm), use_kernel=True)


def test_padding_leaves_outputs_and_state_unchanged():
    x, dt, a, bm, cm, _ = _inputs(1, 2, 70, 64, 64, seed=13)
    y, s = ssd_chunked(*map(_t, (x, dt, a, bm, cm)))
    ys, ss = ssd_scan_ref(*map(_t, (x, dt, a, bm, cm)))
    assert y.shape == (1, 2, 70, 64)
    torch.testing.assert_close(y, ys, **F32_TOL)
    torch.testing.assert_close(s, ss, **F32_TOL)


def test_kernel_wrapper_refuses_grad_and_cpu_tensors():
    x, dt, a, bm, cm, _ = _inputs(1, 2, 64, 64, 64, seed=1)
    xdt, la = _t(x * dt[..., None]), _t(dt * a[None, :, None])
    with pytest.raises(ValueError, match="CUDA tensors"):
        mamba2_ssd_kernel(xdt, la, _t(bm), _t(cm))
    with pytest.raises(RuntimeError, match="no backward"):
        mamba2_ssd_kernel(xdt.requires_grad_(True), la, _t(bm), _t(cm))
    with pytest.raises(ValueError, match="state 64"):
        mamba2_ssd_kernel(_t(x), la, _t(bm[..., :16]), _t(cm[..., :16]))


def test_selfcheck_recurrence_cases_cover_both_kernels_and_run_plain():
    # the cases chip_smoke.py checks on the card, at small path shapes:
    # every input set is well formed and its plain version finite here
    from repro_torch.kernels import selfcheck
    cases = selfcheck.recurrence_cases(torch.device("cpu"), (1, 2, 64),
                                       (1, 2, 64))
    assert {c.kernel for c in cases} == {"rwkv6", "mamba2_ssd"}
    assert len({(c.kernel, c.label) for c in cases}) == len(cases)
    for c in cases:
        y, s = c.plain_fn()
        assert torch.isfinite(y.float()).all() and torch.isfinite(s).all(), \
            c.label


# ---------------------------------------------------------------------------
# the CUDA kernel's bf16 route, emulated on the CPU: the same segments and
# transitions, the same operand rounding, held against the plain version
# and the reference's Pallas kernel at selfcheck.TOLERANCE
# ---------------------------------------------------------------------------

#: the kernel's float32 log2(e)
LOG2E = 1.4426950408889634


def _split(x):
    """x ~ hi + lo, both bf16 values: the kernel's split operand."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _mm2(a, b):
    """float32 a times bf16 b on the tensor cores: two passes, a split."""
    ah, al = _split(a)
    return ah @ b + al @ b


def _emulate_bf16_route(xdt, la, bm, cm, state=None):
    """``csrc/mamba2_ssd.cu``'s bf16 route: log2-scaled decays; c b^T once
    per (batch row, chunk) in one pass (bf16 x bf16); segments of
    SEGMENT_CHUNKS chunks, every one but the last run from a zero state to
    its transition (D, M); each segment run from the state the earlier
    transitions carry it: y = exp(cum) (c S) with S split, plus scores
    xdt with scores split; bw^T xdt with bw split."""
    L, G = CHUNK, SEGMENT_CHUNKS
    bb, h, t, p = xdt.shape
    n = bm.shape[-1]
    pad = (-t) % L
    xf = F.pad(xdt.float(), (0, 0, 0, pad))
    lf = F.pad(la.float(), (0, pad)) * LOG2E
    bf, cf = (F.pad(m.float(), (0, 0, 0, pad)) for m in (bm, cm))
    chunks = (t + pad) // L
    n_seg = max(1, -(-chunks // G))
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool))

    def chunk(ci):
        sl = slice(ci * L, (ci + 1) * L)
        cum = torch.cumsum(lf[:, :, sl], dim=-1)
        cl = cum[..., -1]
        bw = bf[:, None, sl] * torch.exp2(cl[..., None] - cum)[..., None]
        return sl, cum, cl, bw

    def update(s, sl, cl, bw):
        return (torch.exp2(cl)[..., None, None] * s
                + _mm2(bw.transpose(-1, -2), xf[:, :, sl]))

    trans = []
    for sg in range(n_seg - 1):
        s, d = torch.zeros((bb, h, n, p)), torch.ones((bb, h))
        for ci in range(sg * G, (sg + 1) * G):
            sl, cum, cl, bw = chunk(ci)
            s, d = update(s, sl, cl, bw), d * torch.exp2(cl)
        trans.append((d, s))
    ys = []
    for sg in range(n_seg):
        s = (torch.zeros((bb, h, n, p)) if state is None
             else state.float())
        for d, m in trans[:sg]:
            s = d[..., None, None] * s + m
        for ci in range(sg * G, min((sg + 1) * G, chunks)):
            sl, cum, cl, bw = chunk(ci)
            cb = cf[:, sl] @ bf[:, sl].transpose(-1, -2)        # [B,L,L]
            diff = torch.where(mask, cum[..., :, None] - cum[..., None, :],
                               0.0)
            scores = torch.where(mask, cb[:, None] * torch.exp2(diff), 0.0)
            sh, sl_ = _split(s)
            cs = cf[:, None, sl] @ sh + cf[:, None, sl] @ sl_
            ys.append(torch.exp2(cum)[..., None] * cs
                      + _mm2(scores, xf[:, :, sl]))
            s = update(s, sl, cl, bw)
    y = torch.cat(ys, dim=2) if ys else xf
    return y[:, :, :t].to(xdt.dtype), s


@pytest.mark.parametrize("t,state,la", [
    (1, True, None), (CHUNK, False, None), (600, False, None),
    (300, True, None), (300, True, -80.0)])
def test_bf16_route_emulation_matches_plain_version(t, state, la):
    # T = 1, one chunk, three segments with a ragged tail, an initial
    # state, and a decay to 0 from a state
    x = selfcheck.ssd_inputs(torch.device("cpu"), 1, 2, t, state=state,
                             la=la, seed=t)
    got = _emulate_bf16_route(*x)
    assert got[0].dtype == torch.bfloat16
    bad, err = selfcheck.out_of_tolerance(got, mamba2_ssd_ref(*x))
    assert bad == 0, err


def test_bf16_route_emulation_matches_the_pallas_kernel():
    # T = 9 chunks: three segments, the last of one chunk; zero state and
    # a chunk multiple, as the Pallas kernel takes them
    xdt, la, bm, cm, _ = selfcheck.ssd_inputs(torch.device("cpu"), 1, 2,
                                              9 * CHUNK, seed=7)
    got = _emulate_bf16_route(xdt, la, bm, cm)
    jy, js = mamba2_ssd_pallas(_j(xdt.float().numpy(), jnp.bfloat16),
                               _j(la.numpy()),
                               _j(bm.float().numpy(), jnp.bfloat16),
                               _j(cm.float().numpy(), jnp.bfloat16),
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
        cuda_device, rwkv6_shape=(1, 2, 32), ssd_shape=(2, 8, 256))
        if c.kernel == "mamba2_ssd"]
    bad = {c.label: selfcheck.float_mismatches(c) for c in cases}
    assert not any(n for n, _ in bad.values()), bad


def test_cuda_kernel_takes_unaligned_views(cuda_device):
    # contiguous views that start one element past a 16-byte boundary
    # (2 bytes for bf16, 4 for float32): the wrapper copies them, so the
    # kernel's 16-byte copies stay aligned
    from repro_torch.kernels import selfcheck
    x = selfcheck.ssd_inputs(cuda_device, 1, 2, 150, state=True)
    views = [selfcheck.offset_view(t) for t in x]
    assert all(t.data_ptr() % 16 for t in views)
    got = mamba2_ssd_kernel(*views)
    assert all(torch.equal(g, w) for g, w in zip(got, mamba2_ssd_kernel(*x)))
    bad, err = selfcheck.out_of_tolerance(got, mamba2_ssd_ref(*x))
    assert bad == 0, err
