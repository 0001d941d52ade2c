"""Port relational operators against ``repro.relalg`` on the CPU.

Every operator of ``repro_torch.relalg.ops`` gets the same numpy inputs as
its reference counterpart; data, counts and flags must agree bit for bit
(tolerance 0: the path is int32 throughout). Covered: forced hash
collisions (``hash_fn``) and real 32-bit collisions, rows whose content is
all PAD, ≥4096-row inputs (the radix layout), bucket overflow, and
``equi_join`` overflow.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.relalg as J
from repro.relalg import ops as jops
import repro_torch.relalg as T
from repro_torch.kernels.radix_partition import radix_partition
from repro_torch.relalg import ops as tops
from repro_torch.relalg.guard import count_transfers
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

# one XLA program per reference call (eager dispatch of the reference's
# lax.cond paths costs several times more per first call)
_j_distinct_rows = jax.jit(jops.distinct_rows)
_j_distinct_rows_hashed = jax.jit(jops.distinct_rows_hashed,
                                  static_argnames=("radix",))

# distinct K=2 rows with IDENTICAL 32-bit rowhash values (brute-forced
# against the production hash; the same pairs the reference tests use)
COLLIDING_PAIRS = [
    ([573955, 771106], [1046201, 851388]),
    ([371750, 616302], [385810, 783927]),
    ([111516, 1026830], [628226, 432961]),
    ([225467, 153997], [397535, 951855]),
]


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _rows(n, k, seed=0, hi=1 << 20):
    return np.random.default_rng(seed).integers(0, hi, (n, k)).astype(
        np.int32)


def _tables(rows, attrs, capacity=None):
    rows = np.asarray(rows, dtype=np.int32).reshape(-1, len(attrs))
    return (J.Table.from_codes(rows, attrs, capacity),
            T.Table.from_codes(rows, attrs, capacity, device="cpu"))


def _same_table(jt, tt):
    assert tuple(jt.attrs) == tuple(tt.attrs)
    assert int(jt.count) == int(tt.count)
    np.testing.assert_array_equal(np.asarray(jt.data), tt.data.numpy())


def _same_pair(jout, tout):
    jd, jc = jout
    td, tc = tout
    assert int(jc) == int(tc)
    np.testing.assert_array_equal(np.asarray(jd), td.numpy())


# ---------------------------------------------------------------------------
# unary operators
# ---------------------------------------------------------------------------

def test_compact_and_sort_lex():
    rows = _rows(100, 3, seed=1, hi=5)
    keep = np.random.default_rng(2).random(100) < 0.4
    _same_pair(jops.compact(jnp.asarray(rows), jnp.asarray(keep)),
               tops.compact(torch.from_numpy(rows), torch.from_numpy(keep)))
    jt, tt = _tables(rows, ["a", "b", "c"], capacity=128)
    np.testing.assert_array_equal(np.asarray(jops.sort_lex(jt)),
                                  tops.sort_lex(tt).numpy())


def test_project_rename_select():
    jt, tt = _tables(_rows(60, 4, seed=3, hi=6), ["a", "b", "c", "d"], 64)
    _same_table(J.project(jt, ["c", "a"]), T.project(tt, ["c", "a"]))
    spec = [("a", "x"), ("a", "y"), ("d", "z")]
    _same_table(J.project_as(jt, spec), T.project_as(tt, spec))
    _same_table(J.rename(jt, {"b": "q"}), T.rename(tt, {"b": "q"}))
    _same_table(J.select_eq(jt, "b", 2), T.select_eq(tt, "b", 2))
    _same_table(J.select_neq(jt, "c", 0), T.select_neq(tt, "c", 0))
    mask = np.random.default_rng(4).random(64) < 0.5
    _same_table(J.select_mask(jt, jnp.asarray(mask)),
                T.select_mask(tt, torch.from_numpy(mask)))
    with pytest.raises(ValueError):
        T.project_as(tt, [("a", "x"), ("b", "x")])
    with pytest.raises(ValueError):
        T.rename(tt, {"a": "b"})


@pytest.mark.parametrize("n,k,hi,cap", [
    (0, 2, 5, 8),            # empty
    (1, 1, 2, 4),            # single row
    (64, 1, 4, 64),          # K=1
    (200, 3, 9, 256),        # heavy duplication
    (1000, 5, 40, 1024),     # triple-shaped
    (513, 8, 1 << 20, 520),  # wide rows, nearly all distinct, odd sizes
    (5000, 4, 50, 5000),     # radix layout
    (4100, 2, 1 << 20, 4100),  # radix layout, nearly all distinct
])
def test_dedup_strategies_match_reference(n, k, hi, cap):
    rows = _rows(n, k, seed=n + k, hi=hi)
    jt, tt = _tables(rows, [f"c{i}" for i in range(k)], capacity=cap)
    want_lex = _j_distinct_rows(jt.data, jt.count)
    want_hash = {radix: _j_distinct_rows_hashed(jt.data, jt.count,
                                                radix=radix)
                 for radix in (False, True) if cap >= 16 or not radix}
    _same_pair(want_lex, tops.distinct_rows(tt.data, tt.count))
    for radix, want in want_hash.items():
        _same_pair(want, tops.distinct_rows_hashed(tt.data, tt.count,
                                                   radix=radix))
    # the strategy entry points pick the same layouts as the reference
    auto = want_hash[cap >= tops.RADIX_DEDUP_MIN_ROWS]
    for dedup, want in (("lex", want_lex), ("hash", auto)):
        _same_pair(want, tops.dedup_rows(tt.data, tt.count, dedup))
        out = T.distinct(tt, dedup=dedup)
        _same_pair(want, (out.data, out.count))
        assert out.attrs == jt.attrs


def test_hash_dedup_under_real_collisions_takes_lex_fallback():
    rows = []
    for a, b in COLLIDING_PAIRS:
        rows += [a, b, a, b, a]
    rows += [[7, 7], [8, 9], [7, 7]]
    jt, tt = _tables(rows, ["x", "y"], capacity=64)
    with count_transfers() as ledger:
        out = T.distinct(tt, dedup="hash")
    assert ledger.device_to_host == 1      # the one counted fallback read
    _same_table(J.distinct(jt, dedup="hash"), out)
    _same_table(J.distinct(jt, dedup="lex"), T.distinct(tt, dedup="lex"))
    assert out.row_set() == {tuple(r) for r in rows}


@pytest.mark.parametrize("name", ["constant", "mod4"])
def test_forced_collision_hash_fn(name):
    jfn = {"constant": lambda x: jnp.zeros((x.shape[0],), jnp.uint32),
           "mod4": lambda x: x[:, 0].astype(jnp.uint32) % jnp.uint32(4)}
    tfn = {"constant": lambda x: torch.zeros(x.shape[0], dtype=torch.int64),
           "mod4": lambda x: (x[:, 0].to(torch.int64) & 0xFFFFFFFF) % 4}
    rows = _rows(100, 3, seed=11, hi=7)
    jt, tt = _tables(rows, ["a", "b", "c"], capacity=128)
    _same_pair(jops.distinct_rows_hashed(jt.data, jt.count,
                                         hash_fn=jfn[name]),
               tops.distinct_rows_hashed(tt.data, tt.count,
                                         hash_fn=tfn[name]))


def test_radix_dedup_all_pad_content_rows():
    data = np.full((4096, 3), T.PAD_ID, dtype=np.int32)
    data[:2048] = _rows(2048, 3, seed=6, hi=7)
    jt, tt = _tables(data, ["a", "b", "c"])
    out = T.distinct(tt, dedup="hash")
    _same_pair(_j_distinct_rows_hashed(jt.data, jt.count, radix=True),
               (out.data, out.count))
    got = out.row_set()
    assert got == {tuple(map(int, r)) for r in data}


def test_radix_dedup_bucket_overflow_falls_back():
    # 4096 copies of one row fill one radix bucket far past its capacity
    data = np.concatenate([np.repeat(_rows(1, 3, seed=8), 4096, axis=0),
                           _rows(904, 3, seed=9, hi=50)])
    jt, tt = _tables(data, ["a", "b", "c"])
    cb = tops._radix_dedup_cap(tt.capacity, tops.RADIX_DEDUP_BUCKETS)
    _b, _c, overflow = radix_partition(
        tt.data, tt.count, n_buckets=tops.RADIX_DEDUP_BUCKETS,
        cap_bucket=cb, order_preserving=True)
    assert bool(overflow)
    with count_transfers() as ledger:
        out = T.distinct(tt, dedup="hash")
    assert ledger.device_to_host == 2      # radix flag, then sorted flag
    _same_pair(_j_distinct_rows_hashed(jt.data, jt.count, radix=True),
               (out.data, out.count))


def _fallback_case(name):
    """(rows, attrs, capacity) that send the hash δ down one path."""
    if name == "sorted_collision":
        rows = [r for a, b in COLLIDING_PAIRS for r in (a, b, a)]
        return rows, ["x", "y"], 64
    if name == "radix_overflow":
        return (np.repeat(_rows(1, 3, seed=8), 4096, axis=0), ["a", "b", "c"],
                None)
    if name == "radix_pad_merge":
        # one valid all-PAD row, alone and so first in its radix bucket
        # (bucket 0 is exempt: its first row has no predecessor)
        pad = np.full((1, 3), T.PAD_ID, dtype=np.int32)
        rows = _rows(40, 3, seed=4)
        top = lambda x: tops.rowhash(torch.from_numpy(x)).numpy() >> 29
        assert top(pad)[0] != 0
        return (np.concatenate([rows[top(rows) != top(pad)[0]], pad]),
                ["a", "b", "c"], 4096)
    return _rows(5000, 5, seed=3, hi=100), list("abcde"), None


@pytest.mark.parametrize("name, calls, fallbacks", [
    ("sorted_collision", {("sorted", 64, 2): 1}, {"sorted_collision": 1}),
    ("radix_overflow", {("radix", 4096, 3): 1, ("sorted", 4096, 3): 1},
     {"radix_overflow": 1}),
    ("radix_pad_merge", {("radix", 4096, 3): 1, ("sorted", 4096, 3): 1},
     {"radix_pad_merge": 1}),
    ("none", {("radix", 5000, 5): 1}, {}),
])
def test_hash_dedup_counts_record_layouts_and_fallbacks(name, calls,
                                                        fallbacks):
    rows, attrs, cap = _fallback_case(name)
    jt, tt = _tables(rows, attrs, capacity=cap)
    tops.reset_hash_dedup_counts()
    with count_transfers() as ledger:
        out = T.distinct(tt, dedup="hash")
    got = tops.hash_dedup_counts()
    assert got == {"calls": calls, "fallbacks": fallbacks}
    # one counted host read per hash δ call, whatever the trigger
    assert ledger.device_to_host == sum(calls.values())
    _same_table(J.distinct(jt, dedup="hash"), out)
    tops.reset_hash_dedup_counts()
    assert tops.hash_dedup_counts() == {"calls": {}, "fallbacks": {}}


# ---------------------------------------------------------------------------
# binary operators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dedup", [False, True, "lex", "hash"])
def test_union(dedup):
    (a1, b1), (a2, b2) = COLLIDING_PAIRS[0], COLLIDING_PAIRS[1]
    ja, ta = _tables([a1, b1, a2, a1], ["x", "y"], capacity=8)
    jb, tb = _tables([[r[1], r[0]] for r in (b1, a2, b2, b2)], ["y", "x"],
                     capacity=8)
    _same_table(J.union(ja, jb, dedup=dedup), T.union(ta, tb, dedup=dedup))
    with pytest.raises(ValueError):
        T.union(ta, T.project(ta, ["x"]))


@pytest.mark.parametrize("n0,n1,cap", [(5, 3, 16), (14, 9, 16), (0, 4, 8)])
def test_append_rows(n0, n1, cap):
    jbase, tbase = _tables(_rows(n0, 2, seed=1, hi=9), ["a", "b"], cap)
    jd, td = _tables(_rows(n1, 2, seed=2, hi=9)[:, ::-1], ["b", "a"], 16)
    with count_transfers() as ledger:
        out = T.append_rows(tbase, td)
    assert ledger.device_to_host == 2      # the two row counts
    _same_table(J.append_rows(jbase, jd), out)


@pytest.mark.parametrize("out_cap", [8, 64, 256])
def test_equi_join_matches_reference_including_overflow(out_cap):
    rng = np.random.default_rng(7)
    left = rng.integers(0, 12, (40, 2)).astype(np.int32)
    right = rng.integers(0, 12, (30, 3)).astype(np.int32)
    jl, tl = _tables(left, ["k", "v"], capacity=48)
    jr, tr = _tables(right, ["k", "w", "v"], capacity=32)
    jout, jtotal = J.equi_join(jl, jr, "k", "k", out_capacity=out_cap)
    tout, ttotal = T.equi_join(tl, tr, "k", "k", out_capacity=out_cap)
    assert int(jtotal) == int(ttotal)
    _same_table(jout, tout)
    assert tout.attrs == ("k", "v", "r_k", "w", "r_v")
    if out_cap == 8:
        assert int(ttotal) > out_cap       # the caller's overflow signal


def test_table_helpers():
    assert [T.bucket_cap(n) for n in (0, 8, 9, 100, 129)] == \
        [J.bucket_cap(n) for n in (0, 8, 9, 100, 129)]
    assert T.round_cap(13) == J.round_cap(13)
    jt, tt = _tables(_rows(13, 2, seed=3), ["a", "b"], capacity=64)
    _same_table(J.shrink_to_fit(jt), T.shrink_to_fit(tt))
    vocab_j, vocab_t = J.Vocab(), T.Vocab()
    recs = [{"a": "x", "b": 1}, {"a": "y", "b": None}, {"a": "x", "b": 2}]
    _same_table(J.Table.from_records(recs, ["a", "b"], vocab_j, 4),
                T.Table.from_records(recs, ["a", "b"], vocab_t, 4,
                                     device="cpu"))
    assert vocab_j._to_value == vocab_t._to_value
