"""Port of flash attention: the plain PyTorch version and the dispatcher
against the JAX package's Pallas kernel (interpret mode) and its oracle
``attention_ref``; the routing of ``models.layers.attention``; the
wrapper's input checks; the CUDA kernel's bf16 arithmetic emulated on the
CPU; the kernel checks ``chip_smoke.py`` runs, built here with their plain
versions; and — on a machine with a CUDA card only — the CUDA kernel
against its plain version.

Inputs are made with ``numpy.random.default_rng(seed)`` and handed to both
packages as numpy arrays. Tolerances are the reference kernel tests'
(``tests/test_kernels.py``): float32 to 2e-5 (absolute and relative; the
full score matrix against the online softmax differ by float32 rounding,
about 1e-6 here) and bfloat16 to 2e-2 (one bfloat16 step of outputs of
magnitude up to ~2).

A row that no key reaches (kv_len < Sq, causal) gives 0 in the
reference's kernel and in the port; the reference's oracle spreads its
softmax over the masked scores there, so those cases are compared with
the kernel only.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.flash_attention import \
    flash_attention_pallas
from repro.kernels.flash_attention.ref import attention_ref as j_ref
from repro.models.layers import attention as j_attention
from repro_torch.kernels import launch_counts, reset_launch_counts, selfcheck
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention,
                                                 flash_attention_kernel)
from repro_torch.kernels.flash_attention.kernel import tiles
from repro_torch.models import layers as tlayers
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

F32_TOL = dict(atol=2e-5, rtol=2e-5)
BF16_TOL = dict(atol=2e-2, rtol=2e-2)


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _inputs(b, h, kh, s_q, s_k, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h, s_q, d)).astype(np.float32),
            rng.normal(0, 1, (b, kh, s_k, d)).astype(np.float32),
            rng.normal(0, 1, (b, kh, s_k, d)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# (label, (b, h, kh, s_q, s_k, d), kwargs, the oracle agrees)
CASES = [
    ("MHA", (1, 4, 4, 256, 256, 64), {}, True),
    ("GQA 2:1", (2, 4, 2, 128, 128, 64), {}, True),
    ("MQA", (1, 8, 1, 256, 256, 32), {}, True),
    ("window 32", (1, 2, 2, 256, 256, 64), {"window": 32}, True),
    ("window 128", (1, 2, 2, 256, 256, 64), {"window": 128}, True),
    ("kv_len mask, Sq=1", (1, 2, 2, 1, 384, 64),
     {"causal": False, "kv_len": 200}, True),
    ("S=200, not a block multiple", (1, 2, 2, 200, 200, 64), {}, True),
    ("non-causal", (1, 2, 2, 200, 200, 64), {"causal": False}, True),
    ("D=80", (1, 2, 2, 150, 150, 80), {}, True),
    ("Sq < Sk with an offset", (1, 4, 2, 100, 300, 64), {"kv_len": 250},
     True),
    ("rows no key reaches", (1, 2, 2, 100, 64, 64), {"kv_len": 40}, False),
]


@pytest.mark.parametrize("label,shape,kw,oracle", CASES,
                         ids=[c[0] for c in CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_the_reference(label, shape, kw, oracle,
                                             dtype):
    q, k, v = _inputs(*shape, seed=len(label))
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = getattr(torch, dtype)
    jq, jk, jv = (jnp.asarray(a, jdt) for a in (q, k, v))
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    reset_launch_counts()
    got = attention_ref(tq, tk, tv, **kw)
    assert got.dtype == tdt and got.shape == tq.shape
    assert torch.equal(flash_attention(tq, tk, tv, **kw), got)
    assert launch_counts()["flash_attention"] == 0
    _close(got, flash_attention_pallas(jq, jk, jv, interpret=True, **kw), tol)
    if oracle:
        _close(got, j_ref(jq, jk, jv, **kw), tol)


def test_rows_no_key_reaches_give_zero():
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 2, 100, 64, 64, seed=3))
    out = attention_ref(q, k, v, causal=True, kv_len=40)
    # q row i sits at position i - 60: rows 0..59 see no key
    assert torch.equal(out[:, :, :60], torch.zeros_like(out[:, :, :60]))
    assert out[:, :, 60:].abs().sum(-1).min() > 0
    out = attention_ref(q[:, :, :10], k, v, causal=False, kv_len=0)
    assert torch.equal(out, torch.zeros_like(out))


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("s_q,s_k,causal", [
    (48, 48, True), (48, 48, False), (3, 40, True)])
def test_layers_attention_routes_as_the_reference(use_pallas, s_q, s_k,
                                                  causal):
    # use_pallas with a static window takes the flash function, except for
    # decode shapes (Sq <= 8, causal, Sk > Sq), which take the dense path
    q, k, v = _inputs(2, 4, 2, s_q, s_k, 16, seed=s_q + s_k)
    want = j_attention(*map(jnp.asarray, (q, k, v)), causal=causal,
                       use_pallas=use_pallas, block_k=16)
    reset_launch_counts()
    got = tlayers.attention(*map(torch.from_numpy, (q, k, v)), causal=causal,
                            use_pallas=use_pallas, block_k=16)
    _close(got, want, F32_TOL)
    assert launch_counts()["flash_attention"] == 0


def test_decode_attention_takes_a_device_kv_len():
    # the serving path's kv_len is a 0-d tensor; the masks are built from
    # it without reading it back
    q, k, v = _inputs(1, 4, 4, 1, 24, 16, seed=7)
    want = j_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                       kv_len=jnp.asarray(17, jnp.int32))
    got = tlayers.attention(*map(torch.from_numpy, (q, k, v)), causal=True,
                            kv_len=torch.tensor(17, dtype=torch.int32))
    _close(got, want, F32_TOL)
    want = j_attention(*map(jnp.asarray, (q[:, :, :1], k[:, :, :9],
                                          v[:, :, :9])), causal=True,
                       kv_len=jnp.asarray(9, jnp.int32))
    got = tlayers.blockwise_attention(
        *map(torch.from_numpy, (q, k[:, :, :9], v[:, :, :9])), causal=True,
        kv_len=torch.tensor(9, dtype=torch.int32), block_k=4)
    _close(got, want, F32_TOL)


def test_dispatcher_checks_its_arguments():
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 2, 8, 8, 16, seed=1))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_attention(q, k, v, use_kernel=True)
    with pytest.raises(TypeError, match="kv_len must be an int"):
        flash_attention(q, k, v, kv_len=torch.tensor(4))


def test_kernel_wrapper_refuses_grad_and_cpu_tensors():
    q, k, v = map(torch.from_numpy, _inputs(1, 2, 2, 8, 8, 16, seed=1))
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_kernel(q, k, v)
    # the arguments are checked before the device, so on any device
    with pytest.raises(ValueError, match="kv_len 9 outside"):
        flash_attention_kernel(q, k, v, kv_len=9)
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention_kernel(q, k, v)


# ---------------------------------------------------------------------------
# the CUDA kernel's bf16 route, emulated on the CPU: the same k tiles, the
# same exponent arithmetic and operand rounding, held against the plain
# version and the reference's Pallas kernel at selfcheck.TOLERANCE
# ---------------------------------------------------------------------------

#: the kernel's float32 log2(e)
LOG2E = 1.4426950408889634


def _emulate_bf16_route(q, k, v, *, causal=True, window=None, scale=None,
                        kv_len=None, split=True):
    """``csrc/flash_attention.cu``'s bf16 route: k tiles of
    ``tiles(D)[1]`` rows in order; s = q k^T in float32 (bf16 products are
    exact); masked scores -inf; per tile, in log2 units with
    c = |scale| log2(e) (a negative scale flips q), the row max
    m_new = max(m, c max s), base = m_new (0 while a row has seen no key),
    alpha = 2^(m - base), p = 2^(c s - base), l = alpha l + sum p and
    acc = alpha acc + hi v + lo v with hi = bf16(p), lo = bf16(p - hi)
    (``split=False``: p rounded to bf16 once); o = acc (1 / l) in bf16,
    l = 0 read as 1."""
    b, h, s_q, d = q.shape
    kh, s_k = k.shape[1], k.shape[2]
    bk = tiles(d)[1]
    kv = s_k if kv_len is None else kv_len
    scale = d ** -0.5 if scale is None else scale
    c = abs(scale) * LOG2E if scale else 1.0
    qf = q.float() * (-1.0 if scale < 0 else 1.0 if scale else 0.0)
    kf = torch.repeat_interleave(k.float(), h // kh, dim=1)
    vf = torch.repeat_interleave(v.float(), h // kh, dim=1)
    qp = torch.arange(s_q)[:, None] + kv - s_q
    m = torch.full((b, h, s_q, 1), -torch.inf)
    l = torch.zeros((b, h, s_q, 1))
    acc = torch.zeros((b, h, s_q, d))
    for k0 in range(0, s_k, bk):
        kp = torch.arange(k0, min(k0 + bk, s_k))[None, :]
        keep = kp < kv
        if causal:
            keep = keep & (kp <= qp)
        if window:
            keep = keep & (qp - kp < window)
        sc = torch.where(keep, qf @ kf[:, :, k0:k0 + bk].transpose(-1, -2),
                         -torch.inf)
        mx = torch.maximum(m, sc.amax(-1, keepdim=True) * c)
        base = torch.where(mx == -torch.inf, 0.0, mx)
        alpha = torch.exp2(m - base)
        p = torch.exp2(sc * c - base)
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float() if split else 0 * hi
        vt = vf[:, :, k0:k0 + bk]
        l = alpha * l + p.sum(-1, keepdim=True)
        acc = alpha * acc + hi @ vt + lo @ vt
        m = mx
    return (acc * (1.0 / torch.where(l == 0, 1.0, l))).to(q.dtype)


def _bf16_inputs(shape, seed):
    return selfcheck.attention_inputs(torch.device("cpu"), *shape,
                                      seed=seed)


def _out_of_tolerance(got, want):
    return selfcheck.out_of_tolerance((got,), (want,))[0]


# (label, (b, h, kh, s_q, s_k, d), kwargs): each of the route's edges
EMULATION_CASES = [
    ("causal S=150", (1, 2, 2, 150, 150, 64), {}),
    ("window 32", (1, 2, 2, 160, 160, 64), {"window": 32}),
    ("kv_len=40 < Sq=100", (1, 2, 2, 100, 64, 64), {"kv_len": 40}),
    ("GQA 4:1 Sq < Sk kv_len < Sk", (1, 4, 1, 70, 150, 64),
     {"kv_len": 130}),
    ("Sk = one k tile + 1", (1, 2, 2, 40, 65, 64), {"causal": False}),
    ("D=80 causal", (1, 2, 2, 130, 130, 80), {}),
    ("D=256 Sk = one k tile + 1", (1, 2, 2, 50, 33, 256),
     {"causal": False}),
]


@pytest.mark.parametrize("label,shape,kw", EMULATION_CASES,
                         ids=[c[0] for c in EMULATION_CASES])
def test_bf16_route_emulation_matches_plain_and_reference(label, shape, kw):
    q, k, v = _bf16_inputs(shape, seed=len(label))
    got = _emulate_bf16_route(q, k, v, **kw)
    assert _out_of_tolerance(got, attention_ref(q, k, v, **kw)) == 0
    jq, jk, jv = (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                  for x in (q, k, v))
    ref = flash_attention_pallas(jq, jk, jv, interpret=True, **kw)
    want = torch.from_numpy(np.asarray(ref, np.float32)).to(torch.bfloat16)
    assert _out_of_tolerance(got, want) == 0


def test_bf16_route_emulation_needs_the_split_of_p():
    # p rounded to bf16 once (8 bits) against p = hi + lo (about 16): the
    # outputs that cancel near 0 leave the tolerance
    q, k, v = _bf16_inputs((1, 4, 4, 256, 256, 64), seed=0)
    want = attention_ref(q, k, v, causal=False)
    assert _out_of_tolerance(_emulate_bf16_route(q, k, v, causal=False),
                             want) == 0
    assert _out_of_tolerance(_emulate_bf16_route(q, k, v, causal=False,
                                                 split=False), want) > 0


#: small stand-ins for the paths' shapes on the CPU
CPU_PATH_SHAPES = (("small encoder", 1, 2, 2, 150, 150, 64, False),
                   ("small shared block", 1, 2, 2, 130, 130, 80, True))


def test_selfcheck_attention_cases_run_plain():
    # the checks chip_smoke.py runs on the card, at small path shapes:
    # every input set is well formed and its plain version finite here
    cases = selfcheck.attention_cases(torch.device("cpu"), CPU_PATH_SHAPES)
    assert {c.kernel for c in cases} == {"flash_attention"}
    assert len({c.label for c in cases}) == len(cases)
    for c in cases:
        o = c.plain_fn()
        assert torch.isfinite(o.float()).all(), c.label


BF16_SPECS = [sp for sp in selfcheck.attention_specs(CPU_PATH_SHAPES)
              if sp[2] == torch.bfloat16]


@pytest.mark.parametrize("label,shape,dtype,kw,seed", BF16_SPECS,
                         ids=[sp[0] for sp in BF16_SPECS])
def test_bf16_route_emulation_passes_every_selfcheck_case(label, shape,
                                                          dtype, kw, seed):
    q, k, v = selfcheck.attention_inputs(torch.device("cpu"), *shape,
                                         dtype=dtype, seed=seed)
    assert _out_of_tolerance(_emulate_bf16_route(q, k, v, **kw),
                             attention_ref(q, k, v, **kw)) == 0


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
    cases = selfcheck.attention_cases(cuda_device, path_shapes=(
        ("small encoder", 2, 4, 4, 300, 300, 64, False),
        ("small shared block", 1, 4, 4, 256, 256, 80, True)))
    bad = {c.label: selfcheck.float_mismatches(c) for c in cases}
    assert not any(n for n, _ in bad.values()), bad


def test_cuda_kernel_takes_unaligned_views(cuda_device):
    # contiguous bf16 views that start 2 bytes past a 16-byte boundary:
    # the wrapper copies them, the kernel's 16-byte copies stay aligned
    q, k, v = selfcheck.attention_inputs(cuda_device, 1, 2, 2, 70, 70, 64)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        y = buf[1:].view(x.shape)
        y.copy_(x)
        return y

    views = [shifted(x) for x in (q, k, v)]
    assert all(x.data_ptr() % 16 for x in views)
    got = flash_attention_kernel(*views)
    assert torch.equal(got, flash_attention_kernel(q, k, v))
    assert _out_of_tolerance(got, attention_ref(q, k, v)) == 0


def test_cuda_kernel_rejects_unsupported_head_size(cuda_device):
    q = torch.zeros((1, 2, 8, 24), device=cuda_device)
    with pytest.raises(ValueError, match="head sizes"):
        flash_attention_kernel(q, q, q)
