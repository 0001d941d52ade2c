"""The port's mesh planning (``repro_torch.plan.annotate``'s local half,
``repro_torch.core.distributed``, ``explain(n_shards=...)``) against the
reference's, in this process, on the CPU.

The pure functions must agree exactly: ``poisson_shard_bound``,
``sink_bucket_cap``, ``parent_fanouts``, the u16 packing, and
``join_exchange_cost``'s bytes over the grid of ``test_join_exchange.py``
(its seconds and strategy too, under one injected calibration passed to
both packages: the static constants differ by design, the reference's
describing a TPU's links and the port's NVLink). ``annotate_local``'s
counts, caps and exchanges and ``explain(plan, n_shards=...)``'s text must
equal the reference's on the paper's DISes and on the ⋈ DISes of
``test_join_exchange.py`` at 1, 2, 3, 4 and 8 shards. The partition of a
rank's rows into per-rank buckets (plain route) must equal the
reference's, buckets, counts and overflow flag, at 1 to 8 shards, whole
rows and a key subset, and overflowing. Inputs come from fixed seeds (no
Hypothesis); the multi-rank runs are in ``test_torch_mesh_ranks.py``.
"""
import dataclasses
import importlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import repro.core as JC
import repro.core.distributed as JD
import repro.launch.mesh as JM
import repro.plan as JP
import repro.relalg.table as JT
import repro_torch.core as TC
import repro_torch.core.distributed as TD
import repro_torch.launch.mesh as TM
import repro_torch.relalg.table as TT
from repro_torch.plan.ir import EquiJoin, node_order
from test_join_exchange import (_join_spec, _random_records,
                                _shared_parent_spec)
from torch_parity import dises, isolated_plan_caches

torch.set_num_threads(1)

# the packages' ``plan`` re-exports functions named like these modules
JPA = importlib.import_module("repro.plan.annotate")
JX = importlib.import_module("repro.plan.explain")
TPA = importlib.import_module("repro_torch.plan.annotate")
TX = importlib.import_module("repro_torch.plan.explain")

SHARDS = (1, 2, 3, 4, 8)
#: one calibration both packages price with, so seconds and strategy can
#: be held equal (numbers of no machine in particular)
CAL = dict(all_gather_bw=120e9, all_to_all_bw=80e9, launch_s=1.5e-5,
           source="measured")


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _cals():
    return JM.Calibration(**CAL), TM.Calibration(**CAL)


def _join_dises(kind):
    if kind == "join":
        spec = _join_spec(*_random_records(40, 24, 5, seed=7))
    elif kind == "one_key":
        spec = _join_spec(*_random_records(30, 12, 1, seed=2))
    elif kind == "empty_parent":
        spec = _join_spec(*_random_records(10, 0, 3, seed=1))
    else:
        spec = _shared_parent_spec(3, 12, 20)
    return JC.parse_dis(spec), TC.parse_dis(spec, device="cpu")


def _dis_pair(kind):
    if kind in ("fig4", "group_a", "group_b"):
        return dises(kind)
    return _join_dises(kind)


KINDS = ("fig4", "group_a", "group_b", "join", "one_key", "empty_parent",
         "shared_parent")


# ---------------------------------------------------------------------------
# the pure functions
# ---------------------------------------------------------------------------

def test_poisson_shard_bound_and_sink_bucket_cap_match():
    for total in (0, 1, 7, 8, 100, 999, 80_000, 1 << 20):
        for n in (1, 2, 3, 4, 6, 8, 64):
            assert TPA.poisson_shard_bound(total, n) == \
                JPA.poisson_shard_bound(total, n)
            for slack in (1.0, 1.5, 4.0):
                assert TD.sink_bucket_cap(total, n, slack) == \
                    JD.sink_bucket_cap(total, n, slack)


@pytest.mark.parametrize("kind", ["fig4", "group_b", "join",
                                  "shared_parent"])
def test_parent_fanouts_match(kind):
    jd, td = _dis_pair(kind)
    jplan, tplan = JC.plan_mapsdi(jd), TC.plan_mapsdi(td)
    jj = [n for n in JP.ir.node_order(jplan.emits())
          if isinstance(n, JP.ir.EquiJoin)]
    tj = [n for n in node_order(tplan.emits()) if isinstance(n, EquiJoin)]
    assert list(TPA.parent_fanouts(tj).values()) == \
        list(JPA.parent_fanouts(jj).values())


@pytest.mark.parametrize("k", [1, 2, 5, 6])
def test_u16_packing_matches_bit_for_bit(k):
    rng = np.random.default_rng(k)
    codes = rng.integers(0, 1 << 16, (37, k)).astype(np.int32)
    codes[-3:] = 2**31 - 1                      # PAD rows ride along
    jp = np.asarray(JD.pack_u16_pairs(jnp.asarray(codes)))
    tp = TD.pack_u16_pairs(torch.from_numpy(codes)).numpy()
    np.testing.assert_array_equal(tp, jp)
    np.testing.assert_array_equal(
        TD.unpack_u16_pairs(torch.from_numpy(tp), k).numpy(),
        np.asarray(JD.unpack_u16_pairs(jnp.asarray(jp), k)))
    np.testing.assert_array_equal(
        TD.unpack_u16_pairs(torch.from_numpy(tp), k).numpy()[:-3],
        codes[:-3])


#: test_join_exchange.py's grid: (child, parent, shards), each priced under
#: every strategy and with a shared-parent fan-out
GRID = [(64, 1 << 16, 8), (256, 1 << 20, 4), (8, 8, 8), (1 << 16, 64, 8),
        (1 << 14, 1 << 14, 1), (64, 1024, 8), (8, 8, 8), (512, 4096, 8)]


@pytest.mark.parametrize("child,parent,n", sorted(set(GRID)))
def test_join_exchange_cost_matches(child, parent, n):
    jcal, tcal = _cals()
    for strategy in ("gather", "repartition", "auto"):
        for fanout in (1, 6):
            for cols in ((2, 2), (3, 2)):
                args = (child, cols[0], parent, cols[1], n)
                kw = dict(strategy=strategy, parent_fanout=fanout)
                j = JPA.join_exchange_cost(*args, **kw)
                t = TPA.join_exchange_cost(*args, **kw)
                assert t.gather_bytes == j.gather_bytes
                assert t.repartition_bytes == j.repartition_bytes
                assert t.parent_fanout == j.parent_fanout
                assert t.cost_source == j.cost_source == "static"
                jc = JPA.join_exchange_cost(*args, calibration=jcal, **kw)
                tc = TPA.join_exchange_cost(*args, calibration=tcal, **kw)
                assert (tc.strategy, tc.gather_seconds,
                        tc.repartition_seconds, tc.cost_source) == \
                    (jc.strategy, jc.gather_seconds,
                     jc.repartition_seconds, jc.cost_source)
    with pytest.raises(ValueError, match="join exchange"):
        TPA.join_exchange_cost(8, 2, 8, 2, n, strategy="nope")


def test_static_calibration_is_the_ports_own():
    """The port prices with NVLink's data-sheet rate and a launch time
    measured on the card, not the reference's TPU constants."""
    cal = TM.static_calibration()
    assert cal.signature() == JM.static_calibration().signature()
    assert cal.all_gather_bw == cal.all_to_all_bw == TM.NVLINK_BW != \
        JM.ICI_BW
    assert cal.launch_s == TPA.COLLECTIVE_LAUNCH_S != \
        JPA.COLLECTIVE_LAUNCH_S
    measured = TM.Calibration(**CAL)
    assert measured.signature() == JM.Calibration(**CAL).signature()
    bw, launch = TM._fit_line([1e3, 2e3, 4e3], [2e-6, 3e-6, 5e-6])
    jbw, jlaunch = JM._fit_line([1e3, 2e3, 4e3], [2e-6, 3e-6, 5e-6])
    assert (bw, launch) == pytest.approx((jbw, jlaunch))


# ---------------------------------------------------------------------------
# annotate_local and explain(n_shards=...)
# ---------------------------------------------------------------------------

def _cap_locals(plan, n, pkg_cap):
    scans = {name for name in plan.dis.sources}
    return {name: pkg_cap(-(-plan.dis.sources[name].capacity // n))
            for name in sorted(scans)}


@pytest.mark.parametrize("kind", KINDS)
def test_annotate_local_matches(kind):
    jd, td = _dis_pair(kind)
    jplan, tplan = JC.plan_mapsdi(jd), TC.plan_mapsdi(td)
    jcal, tcal = _cals()
    for n in SHARDS:
        jl = _cap_locals(jplan, n, JT.bucket_cap)
        tl = _cap_locals(tplan, n, TT.bucket_cap)
        assert tl == jl
        for strategy in ("gather", "repartition", "auto"):
            for mode, safe in (("exact", False), ("bound", False),
                               ("exact", True)):
                kw = dict(mode=mode, slack=1.0, join_exchange=strategy,
                          safe_exchange=safe)
                jc, jcaps, jx = JPA.annotate_local(
                    jplan, n, jl, cap_fn=JT.bucket_cap,
                    calibration=jcal, **kw)
                tc, tcaps, tx = TPA.annotate_local(
                    tplan, n, tl, cap_fn=TT.bucket_cap,
                    calibration=tcal, **kw)
                assert [type(x).__name__ for x in tc] == \
                    [type(x).__name__ for x in jc]
                assert list(tc.values()) == list(jc.values())
                assert list(tcaps.values()) == list(jcaps.values())
                assert [(x.strategy, x.gather_bytes, x.repartition_bytes,
                         x.gather_seconds, x.repartition_seconds,
                         x.cost_source, x.parent_fanout)
                        for x in tx.values()] == \
                    [(x.strategy, x.gather_bytes, x.repartition_bytes,
                      x.gather_seconds, x.repartition_seconds,
                      x.cost_source, x.parent_fanout) for x in jx.values()]


@pytest.mark.parametrize("kind", KINDS)
def test_explain_n_shards_matches_letter_for_letter(kind):
    jd, td = _dis_pair(kind)
    jplan, tplan = JC.plan_mapsdi(jd), TC.plan_mapsdi(td)
    jcal, tcal = _cals()
    for n in SHARDS:
        for engine in ("rmlmapper", "sdm"):
            for strategy in ("gather", "repartition"):
                assert TX.explain(tplan, engine, n_shards=n,
                                  join_exchange=strategy) == \
                    JX.explain(jplan, engine, n_shards=n,
                               join_exchange=strategy)
            assert TX.explain(tplan, engine, n_shards=n,
                              calibration=tcal) == \
                JX.explain(jplan, engine, n_shards=n, calibration=jcal)


# ---------------------------------------------------------------------------
# the per-rank partition
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_partition_local_matches_reference(n):
    rng = np.random.default_rng(n)
    data = rng.integers(0, 40, (300, 4)).astype(np.int32)
    for key_cols in (None, (2, 0)):
        for count, cap in ((300, 300), (211, JD.sink_bucket_cap(211, n)),
                           (300, max(1, 300 // (2 * n)))):  # overflows
            j = JD._partition_local(jnp.asarray(data), jnp.int32(count), n,
                                    cap, False, key_cols)
            t = TD._partition_local(torch.from_numpy(data),
                                    torch.tensor(count, dtype=torch.int32),
                                    n, cap, None, key_cols)
            s = TD._partition_local_sorted(
                torch.from_numpy(data),
                torch.tensor(count, dtype=torch.int32), n, cap, None,
                key_cols)
            for got in (t, s):
                np.testing.assert_array_equal(got[0].numpy(),
                                              np.asarray(j[0]))
                np.testing.assert_array_equal(got[1].numpy(),
                                              np.asarray(j[1]))
                assert bool(got[2]) == bool(j[2])
            if cap < 300 // n:
                assert bool(t[2])


@pytest.mark.parametrize("n", [1, 2, 3])
def test_shard_table_blocks_match_the_reference_layout(n):
    """Each rank's block is the reference's round-robin block of the valid
    rows (``shard_table``: ``per = ceil(rows / n)`` rows a shard), shaped
    as ``mesh_abstract_inputs`` says, and the blocks gathered back are the
    table."""
    from types import SimpleNamespace

    from repro_torch.plan.mesh import mesh_abstract_inputs
    _jd, td = dises("group_b")
    plan = TC.plan_mapsdi(td)
    cap_locals = {name: TT.bucket_cap(-(-t.capacity // n))
                  for name, t in td.sources.items()}
    shapes, counts = mesh_abstract_inputs(plan, cap_locals, n)
    for name, table in td.sources.items():
        rows = table.to_codes()
        per = -(-max(1, len(rows)) // n)
        blocks, sizes = [], []
        for rank in range(n):
            mesh = SimpleNamespace(shape={"data": n}, rank=rank,
                                   device=torch.device("cpu"))
            data, count, cap = TD.shard_table(table, mesh, "data",
                                              cap_locals[name])
            assert cap == cap_locals[name]
            assert tuple(data.shape) == shapes[name] and counts[name] == ()
            want = rows[rank * per:(rank + 1) * per]
            np.testing.assert_array_equal(data[:int(count)].numpy(), want)
            assert (data[int(count):] == 2**31 - 1).all()
            blocks.append(data)
            sizes.append(int(count))
        gathered = TD.unshard_rows(torch.cat(blocks), sizes, cap_locals[name])
        np.testing.assert_array_equal(gathered.numpy(), rows)


# ---------------------------------------------------------------------------
# annotate_query_local
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["join_2hop", "join_filter_project",
                                  "term_neq", "chain_3", "repeated_var"])
def test_annotate_query_local_matches(name):
    """Counts, caps and exchanges of the shard-local query annotation equal
    the reference's for the same query, KG and calibration, at 1 to 4
    shards, exact and bound, with and without ``safe_exchange``."""
    import repro.api as JA
    import repro.query as JQ
    import repro_torch.api as TA
    import repro_torch.query as TQ
    from test_torch_query import named_queries, session
    _je, _te, jkg, tkg = session("group_b")
    codes = np.asarray(jkg.to_codes())
    jq, tq = named_queries(JA, codes)[name], named_queries(TA, codes)[name]
    jplan, tplan = JQ.lower_query(jq), TQ.lower_query(tq)
    jsrc = {JQ.KG_SOURCE: JT.Table.from_codes(codes, jkg.attrs)}
    tsrc = {TQ.KG_SOURCE: TT.Table.from_codes(codes, tkg.attrs,
                                              device="cpu")}
    jcal, tcal = _cals()
    for n in (1, 2, 3, 4):
        cap_local = TT.bucket_cap(-(-len(codes) // n))
        assert cap_local == JT.bucket_cap(-(-len(codes) // n))
        for strategy in ("gather", "repartition", "auto"):
            for mode, safe in (("exact", False), ("bound", False),
                               ("exact", True), ("bound", True)):
                kw = dict(mode=mode, slack=1.0, join_exchange=strategy,
                          safe_exchange=safe)
                jc, jcaps, jx = JQ.annotate_query_local(
                    jplan, n, {JQ.KG_SOURCE: cap_local},
                    cap_fn=JT.bucket_cap, sources=jsrc, calibration=jcal,
                    **kw)
                tc, tcaps, tx = TQ.annotate_query_local(
                    tplan, n, {TQ.KG_SOURCE: cap_local},
                    cap_fn=TT.bucket_cap, sources=tsrc, calibration=tcal,
                    **kw)
                assert [type(x).__name__ for x in tc] == \
                    [type(x).__name__ for x in jc]
                assert list(tc.values()) == list(jc.values())
                assert list(tcaps.values()) == list(jcaps.values())
                assert [dataclasses.astuple(x) for x in tx.values()] == \
                    [dataclasses.astuple(x) for x in jx.values()]


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_query_mesh_abstract_inputs_match_shard_table(n):
    """One rank's KG block, as ``KGEngine`` shards it for a mesh query,
    has the shapes ``query_mesh_abstract_inputs`` gives."""
    from types import SimpleNamespace

    import repro_torch.query as TQ
    from repro_torch.core.schema import TRIPLE_ATTRS
    codes = np.random.default_rng(n).integers(0, 50, (37, 5)).astype(
        np.int32)
    kg = TT.Table.from_codes(codes, TRIPLE_ATTRS, device="cpu")
    cap_local = TT.bucket_cap(-(-kg.capacity // n))
    shape, count_shape = TQ.query_mesh_abstract_inputs(cap_local, n)
    for rank in range(n):
        mesh = SimpleNamespace(shape={"data": n}, rank=rank,
                               device=torch.device("cpu"))
        data, count, _ = TD.shard_table(kg, mesh, "data", cap_local)
        assert tuple(data.shape) == shape
        assert tuple(count.shape) == count_shape
    with pytest.raises(ValueError, match="n_shards"):
        TQ.query_mesh_abstract_inputs(cap_local, 0)
