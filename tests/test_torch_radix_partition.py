"""The one-pass radix partition kernel's algorithm, emulated on the CPU.

``csrc/radix_partition.cu`` cannot run here, so this file replays what it
computes with numpy, step by step: tiles of R rows read from the
wrapper's ``kernel.tiles``; in each tile the rounds of 256 rows, each
row's rank among the same-bucket rows of lower lanes in its warp, of lower
warps in its round and of earlier rounds; the tile's stable grouping by
bucket; the prefix of every bucket over the lower tiles (what the
look-back sums, in tile order); the runs written at their slots below the
bucket capacity; then the finishing blocks' PAD tails, clamped counts
and overflow flag from the last tile's inclusive prefix. The emulation is
held bit for bit against the port's plain version, the JAX oracle and the
JAX Pallas kernel in interpret mode on every radix family of
``selfcheck.radix_specs``, and every output slot must be written exactly
once. Two mutations (prefixes taken in completion order instead of tile
order, and an unstable grouping inside a warp) must break bit identity.

The CUDA-only test at the end counts the CUDA launches of one call on a
card: the scratch memset and the kernel.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.radix_partition import (radix_partition_pallas,
                                           radix_partition_ref as j_ref)
from repro_torch.kernels import aligned16, selfcheck
from repro_torch.kernels.radix_partition import radix_partition_ref
from repro_torch.kernels.radix_partition.kernel import (STAGE_BYTES,
                                                        TILE_ROWS, tiles)
from repro_torch.kernels.radix_partition.ref import PAD_ID, bucket_shift
from repro_torch.kernels.rowhash.ref import rowhash_ref
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

WARP, THREADS = 32, 256


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _targets(data, nb, key_cols, order_preserving):
    cols = list(range(data.shape[1])) if key_cols is None else list(key_cols)
    h = rowhash_ref(torch.from_numpy(np.ascontiguousarray(data[:, cols])))
    h = h.numpy().astype(np.int64)
    return h >> bucket_shift(nb) if order_preserving else h % nb


def _tile_ranks(tg, nb, unstable):
    """Each row's rank among the tile's same-bucket rows, as the kernel's
    rounds build it: lanes below in the warp (above, when ``unstable``),
    the lower warps of the round, and the earlier rounds' running count."""
    rank = np.empty(len(tg), np.int64)
    run = np.zeros(nb, np.int64)
    for r0 in range(0, len(tg), THREADS):
        rnd = tg[r0:r0 + THREADS]
        warp_cnt = np.zeros((THREADS // WARP, nb), np.int64)
        for w0 in range(0, len(rnd), WARP):
            lanes = rnd[w0:w0 + WARP]
            same = lanes[:, None] == lanes[None, :]
            side = (np.triu(np.ones_like(same), 1) if unstable
                    else np.tril(np.ones_like(same), -1))
            rank[r0 + w0:r0 + w0 + len(lanes)] = (
                run[lanes] + warp_cnt[:w0 // WARP, lanes].sum(0)
                + (same & side).sum(1))
            warp_cnt[w0 // WARP] = np.bincount(lanes, minlength=nb)
        run += np.bincount(rnd, minlength=nb)
    return rank, run


def emulate(data, count, *, n_buckets, cap_bucket, key_cols=None,
            order_preserving=False, completion=None, unstable=False):
    """(buckets, counts, overflow, writes per output word) of the one-pass
    kernel. ``completion`` (an order of the tiles) takes each tile's
    prefix over the tiles completed before it instead of the lower tiles:
    a mutation, as is ``unstable``."""
    n, k = data.shape
    nb, cb = n_buckets, cap_bucket
    rows, _staged = tiles(k)
    n_tiles = -(-n // rows)
    valid = min(n, max(int(count), 0))
    target = _targets(data, nb, key_cols, order_preserving)
    tile_rows = [max(0, min(rows, valid - t * rows)) for t in range(n_tiles)]
    ranks, hist = [], np.zeros((n_tiles, nb), np.int64)
    for t, m in enumerate(tile_rows):
        rank, hist[t] = _tile_ranks(target[t * rows:t * rows + m], nb,
                                    unstable)
        ranks.append(rank)
    # the look-back: each tile's exclusive prefix per bucket
    excl = np.zeros((n_tiles, nb), np.int64)
    acc = np.zeros(nb, np.int64)
    for t in (range(n_tiles) if completion is None else completion):
        excl[t] = acc
        acc += hist[t]
    out = np.zeros((nb * cb, k), np.int32)
    writes = np.zeros((nb * cb, k), np.int64)
    for t, m in enumerate(tile_rows):
        tg = target[t * rows:t * rows + m]
        start = np.cumsum(hist[t]) - hist[t]
        gp = np.empty(m, np.int64)                # grouped order
        gp[start[tg] + ranks[t]] = np.arange(m)
        gb = tg[gp]
        pos = np.arange(m)
        lim = start + np.clip(cb - excl[t], 0, hist[t])
        keep = pos < lim[gb]
        slot = gb * cb + excl[t][gb] + pos - start[gb]
        out[slot[keep]] = data[t * rows + gp[keep]]
        writes[slot[keep]] += 1
    # the finishing blocks, from the last tile's inclusive prefix
    raw = excl[n_tiles - 1] + hist[n_tiles - 1]
    for b in range(nb):
        lo = b * cb + min(raw[b], cb)
        out[lo:(b + 1) * cb] = PAD_ID
        writes[lo:(b + 1) * cb] += 1
    return (out.reshape(nb, cb, k), np.minimum(raw, cb).astype(np.int32),
            bool((raw > cb).any()), writes)


def _same(got, want):
    gb, gc, go = got[:3]
    wb, wc, wo = (np.asarray(x) for x in want)
    return (np.array_equal(gb, wb) and np.array_equal(gc, wc)
            and bool(go) == bool(wo))


SPECS = {s.label: s for s in selfcheck.radix_specs(
    1500, ks=(1, 2, 5, 10), path_shapes=[(2048, 5), (3000, 1)])}
#: the n_main families at K = 2, 5 (the main path's width) and 10 for the
#: Pallas kernel (interpret mode costs seconds per call; K = 1 meets the
#: plain version and the JAX oracle only); 1024 buckets are held against
#: the JAX oracle, as the Pallas kernel's interpret-mode compile takes
#: minutes there, and so are the bucket counts the Pallas kernel does not
#: take (its modulo is a mask: a power of two of at least 2), which the
#: exchanges of a 1-, 3- or 6-rank mesh use


def _pallas_takes(nb):
    return 2 <= nb <= 64 and not nb & (nb - 1)


PALLAS_SPECS = {s.label: s for s in selfcheck.radix_specs(
    1500, ks=(2, 5, 10), path_shapes=[(2048, 5)])
    if _pallas_takes(s.n_buckets)}
ORACLE_SPECS = [lb for lb, s in SPECS.items()
                if not _pallas_takes(s.n_buckets)]


@pytest.mark.parametrize("label", list(SPECS))
def test_emulation_matches_plain_version(label):
    s = SPECS[label]
    got = emulate(s.data, s.count, **s.kwargs())
    assert (got[3] == 1).all(), "an output word not written exactly once"
    want = radix_partition_ref(torch.from_numpy(s.data), s.count,
                               **s.kwargs())
    assert _same(got, [w.numpy() for w in want])


@pytest.mark.parametrize("label", list(PALLAS_SPECS))
def test_emulation_matches_pallas_interpret(label):
    s = PALLAS_SPECS[label]
    got = emulate(s.data, s.count, **s.kwargs())
    want = radix_partition_pallas(jnp.asarray(s.data), jnp.int32(s.count),
                                  **s.kwargs(), interpret=True)
    assert _same(got, want)


@pytest.mark.parametrize("label", ORACLE_SPECS)
def test_emulation_matches_jax_oracle(label):
    s = SPECS[label]
    got = emulate(s.data, s.count, **s.kwargs())
    assert _same(got, j_ref(jnp.asarray(s.data), jnp.int32(s.count),
                            **s.kwargs()))


@pytest.mark.parametrize("mutation", ["completion order", "unstable"])
@pytest.mark.parametrize("label", [
    "count=2048 on a tile boundary N=3172",
    "path N=3000 K=1 count=2000 nb=8"])
def test_mutations_break_bit_identity(label, mutation):
    s = SPECS[label]
    n_tiles = -(-s.data.shape[0] // tiles(s.data.shape[1])[0])
    assert n_tiles > 2
    kw = s.kwargs()
    if mutation == "completion order":
        # tiles completing in another order than their index: 1 before 0
        kw["completion"] = [1, 0] + list(range(2, n_tiles))
    else:
        kw["unstable"] = True
    got = emulate(s.data, s.count, **kw)
    want = radix_partition_ref(torch.from_numpy(s.data), s.count,
                               **s.kwargs())
    assert not _same(got, [w.numpy() for w in want])


def test_specs_cover_the_tile_edges():
    labels = set(SPECS)
    r5 = tiles(5)[0]
    big = selfcheck.largest_staged_k()
    for want in (f"N={r5 + 1} (one tile + 1) K=5",
                 f"count={2 * r5} on a tile boundary N={3 * r5 + 100}",
                 "N=1500 nb=1024 exchange"):
        assert want in labels, want
    assert any(lb.startswith(f"K={big} (the largest staged K")
               for lb in labels)
    assert any(lb.startswith(f"K={big + 1} (the first unstaged K")
               for lb in labels)
    assert any(s.offset for s in SPECS.values())
    assert any(s.count % r5 == 0 and s.count < s.data.shape[0]
               for s in SPECS.values() if s.data.shape[1] == 5)


def test_tiles_fit_the_stage_and_shrink_with_k():
    big = selfcheck.largest_staged_k()
    last = TILE_ROWS[0]
    for k in range(1, big + 40):
        rows, staged = tiles(k)
        assert rows in TILE_ROWS and rows <= last
        assert staged == (k <= big)
        if staged:
            assert rows * k * 4 <= STAGE_BYTES
            assert rows == TILE_ROWS[0] or 2 * rows * k * 4 > STAGE_BYTES
        else:
            assert rows == TILE_ROWS[-1]
        last = rows
    assert tiles(5) == (1024, True) and tiles(10) == (1024, True)


def test_aligned16_copies_offset_views_only():
    x = torch.arange(40, dtype=torch.int32).reshape(8, 5)
    assert aligned16(x) is x
    view = selfcheck.offset_view(x)
    assert view.data_ptr() % 16 and view.is_contiguous()
    got = aligned16(view)
    assert got.data_ptr() % 16 == 0 and got.data_ptr() != view.data_ptr()
    assert torch.equal(got, x)
    bf = selfcheck.offset_view(torch.ones(4, 7, dtype=torch.bfloat16))
    assert bf.data_ptr() % 16 and aligned16(bf).data_ptr() % 16 == 0
    strided = x.t()
    assert torch.equal(aligned16(strided), strided)
    assert aligned16(strided).is_contiguous()


# ---------------------------------------------------------------------------
# on the card: one call's CUDA launches
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU mode")
    return torch.device("cuda")


def test_cuda_call_makes_two_launches(cuda_device):
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.radix_partition import radix_partition_kernel
    s = SPECS["N=1500 K=5 nb=8"]
    x = torch.from_numpy(s.data).to(cuda_device)
    c = torch.tensor(s.count, dtype=torch.int32, device=cuda_device)
    radix_partition_kernel(x, c, **s.kwargs())        # build, warm up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        got = radix_partition_kernel(x, c, **s.kwargs())
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert len(names) == 2, names
    want = radix_partition_ref(x, c, **s.kwargs())
    assert all(torch.equal(g, w) for g, w in zip(got, want))
