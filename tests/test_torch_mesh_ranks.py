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
* a rank that raises fails the group at once.

Inputs come from fixed seeds (no Hypothesis).
"""
import functools
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import repro.api as JA
import repro.core as JC
import repro.data.synthetic as JS
import repro.relalg as JR
from repro_torch.launch.mesh import RankError, launch_ranks, make_mesh
from test_join_exchange import _join_spec, _random_records
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


def _tables():
    rng = np.random.default_rng(4)
    few = rng.integers(0, 5, (200, 3)).astype(np.int32)   # duplicates
    many = rng.integers(0, 1 << 17, (300, 3)).astype(np.int32)  # no packing
    return {"few": few, "many": many}


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


@functools.lru_cache(maxsize=None)
def _groups():
    """Every group, spawned together (and the reference's mesh run
    beside them)."""
    _start_reference_mesh()
    with ThreadPoolExecutor(len(RANKS)) as pool:
        futures = {n: pool.submit(
            launch_ranks, rank_cases, n, device="cpu",
            timeout=GROUP_TIMEOUT,
            args=(n, SPECS, KINDS, RECORDS, CAL, _tables()))
            for n in RANKS}
        return {n: f.result() for n, f in futures.items()}


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
from repro.api import EngineConfig, KGEngine, clear_plan_cache
from repro.core import parse_dis
from repro.data.synthetic import make_group_b_dis
from repro.launch.mesh import Calibration, make_mesh
specs, cal = json.loads(sys.argv[1])
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
            out["|".join((kind, engine, strategy))] = {
                "codes": kg.to_codes().tolist(), "raw": st["raw_triples"],
                "recompiles": st["recompiles"], "explain": eng.explain(),
                "stats": {k: stats[k] for k in (
                    "executions", "ingests", "builds", "recompiles",
                    "plan_cache_hits", "plan_cache_misses", "cost_model")}}
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
        [sys.executable, "-c", _REF_MESH, json.dumps([SPECS, CAL])],
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
