"""Port kernels: the plain PyTorch versions against the JAX oracles and the
Pallas kernels (interpret mode), the dispatch policy, and — on a machine
with a CUDA card only — the CUDA kernels against their plain versions.

Every comparison here is on integer data and is bit for bit (tolerance 0).
Inputs are made with ``numpy.random.default_rng(seed)`` and handed to both
packages as numpy arrays.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.radix_partition import (radix_partition_pallas,
                                           radix_partition_ref as j_radix_ref)
from repro.kernels.rowhash.ref import (hash_neighbor_flags_ref as j_flags_ref,
                                       rowhash_ref as j_rowhash_ref)
from repro.kernels.rowhash.rowhash import (hash_neighbor_flags_pallas,
                                           rowhash_pallas)
from repro.relalg.encoding import PAD_ID as J_PAD_ID
from repro_torch.kernels import (launch_counts, reset_launch_counts,
                                 resolve_use_kernel)
from repro_torch.kernels.radix_partition import (bucket_shift,
                                                 kernel_feasible,
                                                 radix_partition,
                                                 radix_partition_kernel,
                                                 radix_partition_ref)
from repro_torch.kernels.radix_partition import ref as radix_ref_mod
from repro_torch.kernels.rowhash import (hash_neighbor_flags,
                                         hash_neighbor_flags_kernel,
                                         hash_neighbor_flags_ref, rowhash,
                                         rowhash_kernel, rowhash_ref)
from repro_torch.relalg import PAD_ID
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _rows(n, k, seed=0, lo=0, hi=1 << 20):
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi, size=(n, k)).astype(np.int32)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _np(x):
    return np.asarray(x).astype(np.int64)


# ---------------------------------------------------------------------------
# rowhash
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,k", [(16, 1), (256, 3), (1000, 5), (4096, 8)])
def test_rowhash_plain_matches_ref_and_pallas(n, k):
    rng = np.random.default_rng(12)
    x = rng.integers(-2**31, 2**31 - 1, (n, k)).astype(np.int32)
    got = rowhash_ref(_t(x)).numpy()
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, _np(j_rowhash_ref(jnp.asarray(x))))
    np.testing.assert_array_equal(
        got, _np(rowhash_pallas(jnp.asarray(x), block_n=256,
                                interpret=True)))


def test_rowhash_extreme_values_pinned():
    # the int64 emulation of uint32 arithmetic at the edges of int32
    x = np.array([[-2**31, 2**31 - 1], [0, -1], [PAD_ID, PAD_ID],
                  [1, 2]], dtype=np.int32)
    np.testing.assert_array_equal(rowhash_ref(_t(x)).numpy(),
                                  _np(j_rowhash_ref(jnp.asarray(x))))


def _hash_sorted_rows(n, k):
    rows = _rows(n, k, seed=21, hi=6)            # many duplicate runs
    h = np.asarray(j_rowhash_ref(jnp.asarray(rows)))
    return rows[np.argsort(h, kind="stable")]    # hash-sorted


@pytest.mark.parametrize("n,k", [(64, 2), (300, 4), (1024, 5), (257, 3)])
def test_hash_neighbor_flags_plain_matches_ref(n, k):
    rows = _hash_sorted_rows(n, k)
    got = hash_neighbor_flags_ref(_t(rows))
    for g, want in zip(got, j_flags_ref(jnp.asarray(rows))):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), _np(want))


@pytest.mark.parametrize("n,k,block_n", [(64, 2, 16), (257, 3, 128)])
def test_hash_neighbor_flags_plain_matches_pallas(n, k, block_n):
    rows = _hash_sorted_rows(n, k)
    got = hash_neighbor_flags_ref(_t(rows))
    pallas = hash_neighbor_flags_pallas(jnp.asarray(rows), block_n=block_n,
                                        interpret=True)
    for g, p in zip(got, pallas):
        np.testing.assert_array_equal(g.numpy().astype(np.int64), _np(p))


def test_hash_neighbor_flags_semantics_and_collisions():
    rows = np.array([[1, 2], [1, 2], [1, 2], [5, 6]], np.int32)
    _, keep, coll = hash_neighbor_flags_ref(_t(rows))
    assert keep.tolist() == [1, 0, 0, 1] and coll.tolist() == [0, 0, 0, 0]
    # a real 32-bit collision pair (brute-forced against the production
    # hash): equal hashes, different rows
    a, b = [573955, 771106], [1046201, 851388]
    h, keep, coll = hash_neighbor_flags_ref(_t(np.array([a, b], np.int32)))
    assert h[0] == h[1]
    assert keep.tolist() == [1, 1] and coll.tolist() == [0, 1]


# ---------------------------------------------------------------------------
# radix partition
# ---------------------------------------------------------------------------

CASES = [
    # (n, k, n_buckets, cap_bucket, count, key_cols)
    (64, 3, 4, 64, 64, None),
    (200, 5, 8, 128, 137, None),
    (256, 2, 2, 256, 0, None),          # empty shard
    (300, 4, 16, 64, 300, (1, 3)),      # join-key subset
    (128, 1, 4, 64, 100, (0,)),
    (512, 6, 8, 32, 512, None),         # tight caps → overflow
]


def _radix_plain(n, k, nb, cb, count, key_cols, order_preserving):
    data = _rows(n, k, seed=n + k)
    out = radix_partition_ref(_t(data), count, n_buckets=nb, cap_bucket=cb,
                              key_cols=key_cols,
                              order_preserving=order_preserving)
    return data, out


def _assert_same_partition(got, want):
    pb, pc, po = got
    wb, wc, wo = want
    assert bool(po) == bool(wo)
    np.testing.assert_array_equal(pc.numpy(), np.asarray(wc))
    np.testing.assert_array_equal(pb.numpy(), np.asarray(wb))


@pytest.mark.parametrize(
    "n,k,nb,cb,count,key_cols,order_preserving",
    [c + (False,) for c in CASES] + [CASES[1] + (True,), CASES[3] + (True,)])
def test_radix_plain_matches_ref(n, k, nb, cb, count, key_cols,
                                 order_preserving):
    data, got = _radix_plain(n, k, nb, cb, count, key_cols,
                             order_preserving)
    _assert_same_partition(got, j_radix_ref(
        jnp.asarray(data), jnp.int32(count), n_buckets=nb, cap_bucket=cb,
        key_cols=key_cols, order_preserving=order_preserving))


@pytest.mark.parametrize("n,k,nb,cb,count,key_cols,order_preserving", [
    (256, 2, 2, 256, 0, None, False),          # empty shard
    (300, 4, 16, 64, 300, (1, 3), False),      # join-key subset
    (512, 6, 8, 32, 512, None, True),          # overflow, top-bit targets
])
def test_radix_plain_matches_pallas(n, k, nb, cb, count, key_cols,
                                    order_preserving):
    data, got = _radix_plain(n, k, nb, cb, count, key_cols,
                             order_preserving)
    _assert_same_partition(got, radix_partition_pallas(
        jnp.asarray(data), jnp.int32(count), n_buckets=nb, cap_bucket=cb,
        key_cols=key_cols, order_preserving=order_preserving, block_n=128,
        interpret=True))


def test_radix_all_rows_one_bucket_overflows_without_corruption():
    row = np.array([[7, 11, 13]], dtype=np.int32)
    data = np.repeat(row, 96, axis=0)
    buckets, counts, overflow = radix_partition(_t(data), 96, n_buckets=4,
                                                cap_bucket=32)
    assert bool(overflow)
    counts = counts.numpy()
    assert counts.sum() == 32 and counts.max() == 32
    hot = int(counts.argmax())
    np.testing.assert_array_equal(buckets[hot].numpy(),
                                  np.repeat(row, 32, axis=0))
    for b in range(4):
        if b != hot:
            assert (buckets[b].numpy() == PAD_ID).all()


def test_radix_pad_sentinel_and_shift():
    assert radix_ref_mod.PAD_ID == PAD_ID == int(J_PAD_ID)
    assert bucket_shift(2) == 31 and bucket_shift(64) == 26
    for bad in (0, 3, 12):
        with pytest.raises(ValueError):
            bucket_shift(bad)


def test_radix_kernel_feasibility_gate():
    assert kernel_feasible(1 << 20, 5, 8, 140_000)
    assert kernel_feasible(1024, 5, 64, 256, key_cols=(4, 0))
    assert not kernel_feasible(0, 5, 8, 256)          # empty
    # exchange mode takes any bucket count (one per shard); the
    # order-preserving mode keeps its power-of-two rule
    assert kernel_feasible(1024, 5, 3, 256)
    assert kernel_feasible(1024, 5, 1, 256)
    assert not kernel_feasible(1024, 5, 3, 256, order_preserving=True)
    assert not kernel_feasible(1024, 5, 1, 256, order_preserving=True)
    assert not kernel_feasible(1024, 5, 0, 256)       # no bucket
    assert not kernel_feasible(1024, 5, 2048, 256)    # too many buckets
    assert not kernel_feasible(1024, 5, 8, 256, key_cols=(5,))  # bad col
    assert not kernel_feasible(1024, 40, 8, 256)      # > 16 key columns


# ---------------------------------------------------------------------------
# dispatch policy: CPU tensors take the plain version, CUDA the kernel
# ---------------------------------------------------------------------------

def test_dispatch_on_cpu_takes_plain_version_and_launches_nothing():
    x = _t(_rows(300, 3, seed=5, hi=9))
    reset_launch_counts()
    np.testing.assert_array_equal(rowhash(x).numpy(), rowhash_ref(x).numpy())
    for got, want in zip(hash_neighbor_flags(x), hash_neighbor_flags_ref(x)):
        np.testing.assert_array_equal(got.numpy(), want.numpy())
    got = radix_partition(x, 300, n_buckets=4, cap_bucket=128)
    want = radix_partition_ref(x, 300, n_buckets=4, cap_bucket=128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy())
    assert launch_counts() == {"rowhash": 0, "hash_neighbor_flags": 0,
                               "radix_partition": 0, "rwkv6": 0,
                               "mamba2_ssd": 0, "flash_attention": 0}


def test_kernel_wrappers_raise_on_cpu_tensors():
    x = _t(_rows(64, 3))
    with pytest.raises(ValueError, match="CUDA"):
        rowhash(x, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        hash_neighbor_flags(x, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        radix_partition(x, 64, n_buckets=4, cap_bucket=32, use_kernel=True)
    for fn in (rowhash_kernel, hash_neighbor_flags_kernel):
        with pytest.raises(ValueError, match="CUDA"):
            fn(x)
    with pytest.raises(ValueError, match="CUDA"):
        radix_partition_kernel(x, 64, n_buckets=4, cap_bucket=32)
    assert resolve_use_kernel(x, None) is False
    assert resolve_use_kernel(x, False) is False


def test_selfcheck_cases_cover_every_width_and_run_plain():
    # the card's kernel-versus-plain cases, built on the CPU: every width
    # and main-path shape appears, and each plain version runs (a case
    # asking for a column the rows lack would raise here)
    from repro_torch.kernels import selfcheck
    path = [(4096, 1), (6144, 2), (8192, 5)]
    cases = selfcheck.cases(torch.device("cpu"), n_main=3000,
                            ks=(1, 2, 5, 10), path_shapes=path)
    labels = {c.kernel + " " + c.label for c in cases}
    for name in ("rowhash", "hash_neighbor_flags"):
        for k in (1, 2, 5, 10):
            assert any(lb.startswith(f"{name} N=3000 K={k}")
                       for lb in labels), (name, k)
    for n, k in path:
        assert f"radix_partition path N={n} K={k} count={n - n // 3} nb=8" \
            in labels
    for c in cases:
        c.plain_fn()


# ---------------------------------------------------------------------------
# on the card: the CUDA kernels against their plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_kernels_match_plain_versions(cuda_device):
    from repro_torch.kernels import selfcheck
    cases = selfcheck.cases(cuda_device, n_main=5000, ks=(1, 2, 5, 10),
                            path_shapes=[(4096, 1), (6144, 2), (8192, 5)])
    bad = {c.kernel + " " + c.label: selfcheck.mismatches(c)
           for c in cases}
    assert not any(bad.values()), bad
    assert {c.kernel for c in cases} == {"rowhash", "hash_neighbor_flags",
                                         "radix_partition"}


def test_cuda_kernel_rejects_infeasible_shape(cuda_device):
    x = torch.zeros((64, 3), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError, match="does not take"):
        radix_partition(x, 64, n_buckets=3, cap_bucket=32)
    with pytest.raises(ValueError, match="always takes the kernel"):
        rowhash(x, use_kernel=False)
