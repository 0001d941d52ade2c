"""The port's mesh sessions in real ranks: gloo on the CPU, against the
reference.

One group of ``n`` ranks per ``n`` in 1..4 is spawned once, the four
together (``launch_ranks``, a 60 s limit, so a hang fails instead of
stalling the suite), and runs every case of
``torch_mesh_cases.rank_cases``; the tests check what the ranks
returned:

* ``KGEngine(dis, mesh=make_mesh((n,), ("data",), device="cpu"))``'s KG
  codes and ``raw``, under the three ⋈ exchanges × both engines × both
  δ strategies, equal the reference's single-device ``KGEngine`` bit for
  bit on every rank (the reference's own harness holds its mesh KG to that
  KG), and each such session's ``verify="full"`` audit is clean: its
  collectives equal ``expected_collectives`` and its counted host reads
  ``expected_host_reads`` on every rank;
* an ingest inside the buckets reuses the closure, one that crosses them
  costs one recompile and truncates nothing;
* the all-rows-one-key and empty-parent DISes of ``test_join_exchange.py``
  (and group B) at 4 ranks give the single-device KG and ``raw`` with at
  most one recompile; the skewed DIS and group B give the reference's
  recompiles, ``raw``, ``stats()`` counters and ``explain()`` text at 4
  virtual devices (one subprocess, started with the first rank group so
  the two overlap, runs the reference), under one injected calibration;
* ``distributed_distinct_table`` equals the reference's ``distinct``;
* mesh and single-device sessions never share a plan-cache entry;
* a rank that raises fails the group at once;
* ``KGEngine.query`` on every group-B session above answers the named
  queries of ``test_torch_query.py`` (the reference's two-pattern chain
  among them) bit for bit as the reference's single-device session does,
  its first query's ``verify="full"`` audit counts exactly
  ``expected_query_collectives`` (non-zero at n > 1: the closure reads
  only its rank's block) and a repeat is a cache hit; numpy-seeded random
  BGPs equal ``test_query.bgp_oracle``; at 4 ranks a query that overflows
  recompiles once, and the answers, ``explain_query()`` text, query
  counters, exchanges and store metadata (``pack_entry_meta`` of the KG
  and the query entry) equal the reference's at 4 virtual devices;
* the plan store on a mesh: a reader hits on every rank with the
  writer's KG and answers, the store key is the same on every rank, one
  rank's damaged entry makes every rank build, and mesh and one-device
  entries never adopt each other;
* a mesh ``FrontDoor`` (leader on rank 0) at 2 and 4 ranks gives every
  tenant the reference's one-device front-door KG bit for bit on every
  rank, with its ``compile_dedup()``; worker mode and ``stop(drain=True)``
  resolve every ticket; a follower that fails to encode fails the
  leader's ticket and the group goes on.

Inputs come from fixed seeds (no Hypothesis).
"""
import functools
import json
import os
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import repro.api as JA
import repro.core as JC
import repro.data.synthetic as JS
import repro.relalg as JR
import repro.serve as JSV
import repro_torch.api as TA
import repro_torch.data.synthetic as TS
import repro_torch.relalg as TR
from repro_torch.core.schema import TRIPLE_ATTRS
from repro_torch.launch.mesh import RankError, launch_ranks, make_mesh
from test_join_exchange import _join_spec, _random_records
from test_query import bgp_oracle
from test_torch_query import _seeded_bgp, named_queries
from torch_mesh_cases import (DEDUPS, ENGINES, STRATEGIES, failing_rank,
                              np_rows, rank_cases)
from torch_parity import extension_records, isolated_plan_caches

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROUP_TIMEOUT = 60
RANKS = (1, 2, 3, 4)
KINDS = ("group_b", "join")
SPECS = {
    "join": _join_spec(*_random_records(40, 24, 5, seed=7)),
    "one_key": _join_spec([{"ID": i, "k": "K", "v": f"v{i}"}
                           for i in range(48)],
                          [{"ID": i, "k": "K", "p": f"p{i % 5}"}
                           for i in range(12)]),
    "empty_parent": _join_spec([{"ID": i, "k": f"K{i}", "v": f"v{i}"}
                                for i in range(10)], []),
}
#: an ingest inside every capacity bucket, then one that crosses them
RECORDS = [extension_records("group_b", 1, seed=5, limit=2),
           extension_records("group_b", 1, seed=6)]
CAL = dict(all_gather_bw=120e9, all_to_all_bw=80e9, launch_s=1.5e-5,
           source="measured")
#: the named queries of ``test_torch_query.py`` asked on every group-B
#: mesh session (the first, the reference's two-pattern chain, is audited)
QUERY_NAMES = ("join_2hop", "join_filter_project", "repeated_var",
               "chain_3")
RANDOM_SEEDS = range(8)
#: the four-rank queries held to the reference at 4 virtual devices, as
#: variable patterns: on the one-key KG the repartitioned ⋈ lands on one
#: rank and overflows (one recompile); on group B the two-pattern chain
REF_QUERIES = {"one_key": [["?c", "?r", "?p"], ["?d", "?r", "?p"]],
               "group_b": [["?s", "?p", "?o"], ["?o", "?p2", "?o2"]]}
#: the front door's requests: rounds of per-tenant records
#: (``test_torch_frontdoor.py``'s stream)
STREAMS = [[JS.make_group_b_extension_records(2, seed=100 + rnd * 4 + t)
            for t in range(4)] for rnd in range(2)]


def _tables():
    rng = np.random.default_rng(4)
    few = rng.integers(0, 5, (200, 3)).astype(np.int32)   # duplicates
    many = rng.integers(0, 1 << 17, (300, 3)).astype(np.int32)  # no packing
    return {"few": few, "many": many}


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _group_b_codes(rows, seed):
    """The port's one-device sdm/hash KG codes of group B (equal to the
    reference's: ``test_torch_engine.py``)."""
    with isolated_plan_caches():
        kg, _ = TA.KGEngine(TS.make_group_b_dis(rows, 0.6, seed=seed,
                                                device="cpu"),
                            config=TA.EngineConfig(engine="sdm",
                                                   dedup="hash"),
                            device="cpu").create_kg()
    return np.asarray(kg.to_codes())


@functools.lru_cache(maxsize=None)
def _queries():
    codes = _group_b_codes(48, 2)
    named = named_queries(TA, codes)
    random_kg = _group_b_codes(64, 11)
    return {"named": {name: named[name] for name in QUERY_NAMES},
            "random": [_seeded_bgp(TA, random_kg, seed)
                       for seed in RANDOM_SEEDS],
            "ref": {kind: TA.Query(patterns=[TA.TriplePattern(*p)
                                             for p in pats])
                    for kind, pats in REF_QUERIES.items()}}


_ROOTS = {}


@functools.lru_cache(maxsize=None)
def _groups():
    """Every group, spawned together (and the reference's mesh run
    beside them)."""
    _start_reference_mesh()
    queries = _queries()
    tmp = tempfile.mkdtemp(prefix="mesh_store_")
    _ROOTS.update({n: os.path.join(tmp, f"ranks{n}") for n in RANKS})
    try:
        with ThreadPoolExecutor(len(RANKS)) as pool:
            futures = {n: pool.submit(
                launch_ranks, rank_cases, n, device="cpu",
                timeout=GROUP_TIMEOUT,
                args=(n, SPECS, KINDS, RECORDS, CAL, _tables(), queries,
                      _ROOTS, STREAMS))
                for n in RANKS}
            # the reference's one-device results, while the ranks run
            for kind in KINDS:
                for engine in ENGINES:
                    for dedup in DEDUPS:
                        reference_kg(kind, engine, dedup)
            for dedup in DEDUPS:
                reference_answers(dedup)
            reference_door()
            return {n: f.result() for n, f in futures.items()}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def group(n):
    """What every rank of an ``n``-rank group returned (rank order)."""
    return _groups()[n]


def _ref_dis(kind):
    if kind == "group_b":
        return JS.make_group_b_dis(48, 0.6, seed=2)
    return JC.parse_dis(SPECS[kind])


@functools.lru_cache(maxsize=None)
def reference_kg(kind, engine, dedup):
    with isolated_plan_caches():
        kg, st = JA.KGEngine(_ref_dis(kind), config=JA.EngineConfig(
            engine=engine, dedup=dedup, verify="off")).create_kg()
    return kg.to_codes(), st["raw_triples"]


# ---------------------------------------------------------------------------
# KG parity and the audit
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("dedup", DEDUPS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", RANKS)
def test_mesh_kg_equals_single_device_reference(n, kind, engine, dedup,
                                                strategy):
    ranks = group(n)
    assert [r["rank"] for r in ranks] == list(range(n))
    assert {r["backend"] for r in ranks} == {"gloo"}
    want_codes, want_raw = reference_kg(kind, engine, dedup)
    for r in ranks:
        got = r["main"][(kind, engine, dedup, strategy)]
        np.testing.assert_array_equal(got["codes"], want_codes)
        assert got["raw"] == want_raw
        audit = got["audit"]
        assert audit["ok"], audit["text"]
        assert audit["collectives"] == got["want_collectives"]
        assert audit["expected"] == got["want_collectives"]
        assert audit["host_reads"] == audit["expected_host_reads"]


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n", (3, 4))
def test_ingests_reuse_the_closure_and_cross_with_one_recompile(n, engine):
    ranks = group(n)
    with isolated_plan_caches():
        je = JA.KGEngine(_ref_dis("group_b"), config=JA.EngineConfig(
            engine=engine, dedup="hash", verify="off"))
        want = [je.create_kg()]
        for recs in RECORDS:
            want.append(je.ingest({
                name: JR.Table.from_records(r, je.sources[name].attrs,
                                            je.vocab)
                for name, r in recs.items()}))
    for r in ranks:
        steps = r["ingest"][engine]
        for got, (kg, st) in zip(steps, want):
            np.testing.assert_array_equal(got["codes"], kg.to_codes())
            assert got["raw"] == st["raw_triples"]
        assert [s["recompiles"] for s in steps] == [0, 0, 1]
        assert steps[1]["hit"] and not steps[2]["hit"]


# ---------------------------------------------------------------------------
# the adversarial corners, against the reference at 4 virtual devices
# ---------------------------------------------------------------------------

_REF_MESH = """
import json, sys
import numpy as np
from repro.api import (EngineConfig, KGEngine, Query, TriplePattern,
                       clear_plan_cache)
from repro.api.store import pack_entry_meta
from repro.core import parse_dis
from repro.data.synthetic import make_group_b_dis
from repro.launch.mesh import Calibration, make_mesh
specs, cal, queries = json.loads(sys.argv[1])
mesh = make_mesh((4,), ("data",))
out = {}
for kind, strategy in (("one_key", "repartition"), ("group_b", "auto")):
    for engine in ("rmlmapper", "sdm"):
            clear_plan_cache()
            dis = (make_group_b_dis(48, 0.6, seed=2) if kind == "group_b"
                   else parse_dis(specs[kind]))
            eng = KGEngine(dis, config=EngineConfig(
                engine=engine, dedup="hash", mesh=mesh,
                join_exchange=strategy, calibrate=Calibration(**cal)))
            kg, st = eng.create_kg()
            stats = eng.stats()
            rec = out["|".join((kind, engine, strategy))] = {
                "codes": kg.to_codes().tolist(), "raw": st["raw_triples"],
                "recompiles": st["recompiles"], "explain": eng.explain(),
                "stats": {k: stats[k] for k in (
                    "executions", "ingests", "builds", "recompiles",
                    "plan_cache_hits", "plan_cache_misses", "cost_model")}}
            if engine != "sdm":
                continue
            q = Query(patterns=[TriplePattern(*p) for p in queries[kind]])
            res = eng.query(q)
            qst = eng.stats()["query"]
            entry = eng._q_last["entry"]
            metas = []
            for e in (eng._last["entry"], entry):
                meta = pack_entry_meta(e, e.plan)
                meta.pop("build_seconds")
                metas.append(meta)
            rec["query"] = {
                "codes": res.to_codes().tolist(),
                "explain": eng.explain_query(q),
                "stats": {k: qst[k] for k in (
                    "executions", "cache_hits", "cache_misses", "recompiles",
                    "store_hits", "store_misses", "store_rejects")},
                "exchanges": [x.strategy for x in entry.exchanges.values()],
                "kg_meta": metas[0], "query_meta": metas[1]}
print(json.dumps(out))
"""


_REF_PROC = []


def _start_reference_mesh():
    if _REF_PROC:
        return
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    proc = subprocess.Popen(
        [sys.executable, "-c", _REF_MESH,
         json.dumps([SPECS, CAL, REF_QUERIES])],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    _REF_PROC.append(proc)


@functools.lru_cache(maxsize=None)
def reference_mesh():
    _start_reference_mesh()
    proc = _REF_PROC[0]
    try:
        out, err = proc.communicate(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    assert proc.returncode == 0, err[-4000:]
    return json.loads(out.strip().splitlines()[-1])


@pytest.mark.parametrize("strategy", ("repartition", "auto"))
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind", ("one_key", "empty_parent", "group_b"))
def test_skewed_and_empty_parent_kgs_equal_single_device_reference(
        kind, engine, strategy):
    want_codes, want_raw = reference_kg(kind, engine, "hash")
    for r in group(4):
        got = r["skew"][(kind, engine, strategy)]
        np.testing.assert_array_equal(got["codes"], want_codes)
        assert got["raw"] == want_raw
        assert got["recompiles"] <= 1


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kind,strategy", [("one_key", "repartition"),
                                           ("group_b", "auto")])
def test_four_ranks_match_reference_at_four_virtual_devices(kind, strategy,
                                                            engine):
    want = reference_mesh()["|".join((kind, engine, strategy))]
    for r in group(4):
        got = r["skew"][(kind, engine, strategy)]
        np.testing.assert_array_equal(
            got["codes"], np.asarray(want["codes"], np.int32).reshape(-1, 5))
        assert got["raw"] == want["raw"]
        assert got["recompiles"] == want["recompiles"] <= 1
        assert got["stats"] == want["stats"]
        assert got["explain"] == want["explain"]
    if kind == "one_key" and strategy == "repartition":
        # every row on one key: the exchange lands the ⋈ on one rank,
        # which must recompile (once) rather than truncate
        assert want["recompiles"] == 1


# ---------------------------------------------------------------------------
# the distributed δ, the cache and a failing rank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dedup", DEDUPS)
@pytest.mark.parametrize("key", ("few", "many"))
@pytest.mark.parametrize("n", RANKS)
def test_distributed_distinct_table_matches_reference(n, key, dedup):
    codes = _tables()[key]
    want = JR.distinct(JR.Table.from_codes(codes, ("a", "b", "c")),
                       dedup=dedup).to_codes()
    for r in group(n):
        got, over = r["distinct"][(key, dedup)]
        assert not over
        np.testing.assert_array_equal(np_rows(got), np_rows(want))


def test_mesh_and_single_device_sessions_share_no_cache_entry():
    for r in group(2):
        for case in r["cache"]:
            assert case["hits"] == [False, False]
            assert case["entries"] == 2


def test_a_failing_rank_fails_the_group():
    with pytest.raises(RankError, match="rank 1 fails on purpose"):
        launch_ranks(failing_rank, 3, device="cpu", timeout=GROUP_TIMEOUT,
                     args=(3,))


def test_mesh_of_several_ranks_needs_launched_ranks():
    with pytest.raises(ValueError, match="launch_ranks"):
        make_mesh((2,), ("data",), device="cpu")


# ---------------------------------------------------------------------------
# queries on a mesh
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_answers(dedup):
    """The reference's one-device answers to the named queries (over the
    sdm KG: both engines' KGs are equal code for code, which the test
    checks, so their answers are too)."""
    codes = _group_b_codes(48, 2)
    queries = named_queries(JA, codes)
    with isolated_plan_caches():
        je = JA.KGEngine(_ref_dis("group_b"), config=JA.EngineConfig(
            engine="sdm", dedup=dedup))
        je.create_kg()
        return {name: (np.asarray(je.query(queries[name]).to_codes()),
                       tuple(queries[name].answer_attrs()))
                for name in QUERY_NAMES}


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("dedup", DEDUPS)
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("n", RANKS)
def test_mesh_queries_equal_single_device_reference(n, engine, dedup,
                                                    strategy):
    np.testing.assert_array_equal(reference_kg("group_b", engine, dedup)[0],
                                  reference_kg("group_b", "sdm", dedup)[0])
    want = reference_answers(dedup)
    for r in group(n):
        got = r["main"][("group_b", engine, dedup, strategy)]["queries"]
        for name in QUERY_NAMES:
            codes, attrs = got["answers"][name]
            np.testing.assert_array_equal(codes, want[name][0])
            assert attrs == want[name][1]
        audit = got["audit"]
        assert audit["ok"], audit["text"]
        assert audit["collectives"] == audit["expected"] == \
            got["want_collectives"]
        assert audit["host_reads"] == audit["expected_host_reads"]
        if n > 1:     # the closure exchanges: it reads only its block
            assert sum(got["want_collectives"].values()) > 0
        assert got["repeat_hit"]
        assert got["query_stats"]["cache_hits"] == 1
        assert got["query_stats"]["recompiles"] == 0
        assert got["mesh"]["query_calls"] == len(QUERY_NAMES) + 1


@pytest.mark.parametrize("n", RANKS)
def test_mesh_random_bgps_match_oracle(n):
    queries = _queries()["random"]
    for r in group(n):
        got = r["random"]
        kg = TR.Table.from_codes(got["kg"], TRIPLE_ATTRS, device="cpu")
        np.testing.assert_array_equal(got["kg"], _group_b_codes(64, 11))
        for q, codes in zip(queries, got["answers"]):
            rows = (np.unique(codes, axis=0) if len(codes)
                    else np.zeros((0, len(q.answer_attrs())), np.int32))
            assert len(rows) == len(codes)
            np.testing.assert_array_equal(rows, bgp_oracle(kg, q))


def _json(x):
    return json.loads(json.dumps(x))


@pytest.mark.parametrize("what", ("codes", "explain", "stats", "exchanges",
                                  "kg_meta", "query_meta"))
@pytest.mark.parametrize("kind,strategy", [("one_key", "repartition"),
                                           ("group_b", "auto")])
def test_four_rank_queries_match_reference_at_four_virtual_devices(
        kind, strategy, what):
    engine = "sdm"
    want = reference_mesh()["|".join((kind, engine, strategy))]["query"]
    for r in group(4):
        got = r["skew"][(kind, engine, strategy)]["query"]
        if what == "codes":
            np.testing.assert_array_equal(got["codes"], np.asarray(
                want["codes"], np.int32).reshape(got["codes"].shape))
        else:
            assert _json(got[what]) == want[what]
    if kind == "one_key" and what == "stats":
        # the repartitioned ⋈ lands on one rank: one recompile, on every
        # rank alike, then the one-device answer
        assert want["stats"]["recompiles"] == 1


# ---------------------------------------------------------------------------
# the plan store on a mesh
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", RANKS)
def test_mesh_store_reader_hits_on_every_rank(n):
    ranks = group(n)
    for r in ranks:
        w, rd = r["store"]["writer"], r["store"]["reader"]
        assert w["kg_store"] == w["query_store"] == {
            "store_hits": 0, "store_misses": 1, "store_rejects": 0}
        assert rd["kg_store"] == rd["query_store"] == {
            "store_hits": 1, "store_misses": 0, "store_rejects": 0}
        assert rd["builds"] == 0 and rd["origins"] == ("store", "store")
        assert rd["store_checks"] == 2
        np.testing.assert_array_equal(rd["codes"], w["codes"])
        np.testing.assert_array_equal(rd["answer"], w["answer"])
        assert r["store"]["entries"] == 2
    want, _ = reference_kg("group_b", "sdm", "hash")
    np.testing.assert_array_equal(ranks[0]["store"]["writer"]["codes"], want)


@pytest.mark.parametrize("n", RANKS)
def test_mesh_store_key_is_the_same_on_every_rank(n):
    keys = {tuple(r["store"]["keys"]) for r in group(n)}
    assert len(keys) == 1 and len(set(next(iter(keys)))) == 2


@pytest.mark.parametrize("n", RANKS)
def test_one_ranks_damaged_entry_makes_every_rank_build(n):
    for r in group(n):
        got, w = r["store"]["damaged"], r["store"]["writer"]
        assert got["kg_store"]["store_hits"] == 0
        assert got["kg_store"]["store_rejects"] == 1
        assert got["query_store"]["store_rejects"] == 1
        assert got["builds"] == 2 and got["origins"] == ("build", "build")
        np.testing.assert_array_equal(got["codes"], w["codes"])
        np.testing.assert_array_equal(got["answer"], w["answer"])


@pytest.mark.parametrize("n", RANKS)
def test_mesh_and_one_device_entries_never_adopt_each_other(n):
    for r in group(n):
        assert r["store"]["one_device"] == {"store_misses": 1}
        assert r["store"]["mesh_after_one_device"] == {
            "store_hits": 0, "store_misses": 1, "store_rejects": 0}


# ---------------------------------------------------------------------------
# the front door over a mesh
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def reference_door():
    """The reference's one-device front door fed the same stream at the
    same flush granularity."""
    with isolated_plan_caches():
        door = JSV.FrontDoor(JA.EngineConfig(engine="sdm", dedup="hash"),
                             flush_window=0.0, max_queue=64)
        for t in range(4):
            door.register(f"t{t}", JS.make_group_b_dis(24, 0.5,
                                                        seed=40 + t % 2))
        for rnd in STREAMS:
            tickets = [door.submit(f"t{t}", recs)
                       for t, recs in enumerate(rnd)]
            door.pump(force=True)
            for tk in tickets:
                tk.result(timeout=600)
        return ({f"t{t}": np.asarray(door.kg(f"t{t}").to_codes())
                 for t in range(4)}, door.registry.compile_dedup())


@pytest.mark.parametrize("n", (2, 4))
def test_mesh_front_door_equals_reference(n):
    want, dedup = reference_door()
    for r in group(n):
        got = r["door"]["sync"]
        for tid, codes in want.items():
            np.testing.assert_array_equal(got["codes"][tid], codes)
        assert got["dedup"] == dedup
        assert got["flushes"] == 4 * len(STREAMS)
        assert got["mesh"] == {"rank": r["rank"], "broken": None,
                               "role": "leader" if r["rank"] == 0
                               else "follower"}
    assert group(n)[0]["door"]["sync"]["resolved"]


@pytest.mark.parametrize("n", (2, 4))
def test_mesh_front_door_worker_and_drain_resolve_every_ticket(n):
    want, _ = reference_door()
    ranks = group(n)
    leader = ranks[0]["door"]["worker"]
    assert leader["resolved"] and leader["tickets"] == 4 * len(STREAMS)
    for r in ranks:
        # the worker coalesces requests as they arrive, which changes the
        # vocab's interning order (so the codes) but not the triples: the
        # ranks agree bit for bit, and the KGs hold the reference's count
        got = r["door"]["worker"]
        assert got["flushes"] == leader["flushes"]
        for tid, codes in want.items():
            np.testing.assert_array_equal(got["codes"][tid],
                                          leader["codes"][tid])
            assert len(got["codes"][tid]) == len(codes)


@pytest.mark.parametrize("n", (2, 4))
def test_mesh_front_door_follower_failure_fails_the_ticket(n):
    ranks = group(n)
    errors = ranks[0]["door"]["fault"]["errors"]
    assert len(errors) == 2
    assert errors[0].startswith("FlushSkipped") and "[1]" in errors[0]
    assert errors[1] > 0
    for r in ranks:
        fault = r["door"]["fault"]
        np.testing.assert_array_equal(fault["kg"],
                                      ranks[0]["door"]["fault"]["kg"])
        assert fault["tenant_errors"] == 1
