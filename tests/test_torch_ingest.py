"""Port ``KGEngine.ingest`` sweeps, rebuild ladder, annotate modes and
session configuration against ``repro.api.KGEngine``.

Both sessions run on the CPU over the same DIS (built from the same spec or
seed) and the same extension rows. KG codes, raw triple counts, KG sizes,
Table-1 reduced source sizes, recompile counts and plan-cache hits must
agree exactly (tolerance 0: the path is int32 throughout). The reference
runs with ``verify="off"``, which changes neither its KG nor its counters.

Both packages keep a process-wide plan cache keyed by plan structure, not
data, so every test starts and ends with both caches cleared: entries left
behind would change later recompile counts, here and in the reference's
own tests.
"""
import pytest
import torch

import repro.api as JA
import repro.core as JC
import repro.data.synthetic as JS
import repro_torch.api as TA
import repro_torch.core as TC
import repro_torch.data.synthetic as TS
from torch_parity import deltas, dises, isolated_plan_caches, same_step, \
    sessions

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


@pytest.mark.parametrize("factor,seed,engine,dedup,both", [
    (1, 0, "sdm", "hash", True),
    (4, 2, "sdm", "lex", False),
    (7, 1, "rmlmapper", "lex", False),    # recorded by the reference's
    (15, 1, "rmlmapper", "hash", True),   # ingest property sweep
    (16, 3, "sdm", "hash", True),
])
def test_ingest_sweep_matches_reference(factor, seed, engine, dedup, both):
    jdis = JS.make_group_b_dis(24, 0.6, seed=seed)
    tdis = TS.make_group_b_dis(24, 0.6, seed=seed, device="cpu")
    je, te = sessions(jdis, tdis, engine, dedup)
    same_step(je.create_kg(), te.create_kg())
    ext = JS.make_group_b_dis(24 * factor, 0.6, seed=seed + 31)
    names = ("gene", "chrom") if both else ("gene",)
    jd, td = deltas(je, te, {n: ext.sources[n].to_records(ext.vocab)
                              for n in names})
    jout, tout = je.ingest(jd), te.ingest(td)
    same_step(jout, tout)
    assert tout[1]["recompiles"] <= 1
    # a re-run without new data does not recompile again
    jout2, tout2 = je.create_kg(), te.create_kg()
    same_step(jout2, tout2)
    assert tout2[1]["recompiles"] == tout[1]["recompiles"]
    # and the session KG equals a fresh port run over the accumulated rows
    fresh = TC.RDFizer(te._dis, engine, dedup=dedup)(te.sources)[0]
    assert fresh.row_set() == tout[0].row_set()


def test_interior_overflow_rebuilds_once_like_reference():
    values = [f"v{i % 4}" for i in range(40)]
    spec = {"sources": {"s": {"attrs": ["a", "b"], "records": [
        {"a": v, "b": v} for v in values]}},
        "maps": [{"name": "m", "source": "s",
                  "subject": {"template": "http://ex/T/{a}",
                              "class": "ex:C"},
                  "poms": [{"predicate": "ex:p",
                            "object": {"reference": "b"}}]}]}
    je, te = sessions(JC.parse_dis(spec), TC.parse_dis(spec, device="cpu"),
                       "sdm", None)
    same_step(je.create_kg(), te.create_kg())
    fresh = [{"a": f"w{i}", "b": f"w{i}"} for i in range(10)]
    jd, td = deltas(je, te, {"s": fresh})
    jout, tout = je.ingest(jd), te.ingest(td)
    same_step(jout, tout)
    assert tout[1]["recompiles"] == 1 and tout[1]["kg_triples"] == 28


def test_bound_mode_and_unoptimized_sessions_match_reference():
    for cfg in (dict(mode="bound", slack=2.0), dict(optimize=False)):
        JA.clear_plan_cache()
        TA.clear_plan_cache()
        jdis, tdis = dises("group_b")
        je = JA.KGEngine(jdis, config=JA.EngineConfig(**cfg,
                                                      verify="off"))
        te = TA.KGEngine(tdis, config=TA.EngineConfig(**cfg), device="cpu")
        same_step(je.create_kg(), te.create_kg())


def test_engine_config_validation():
    with pytest.raises(ValueError, match="engine"):
        TA.EngineConfig(engine="x")
    with pytest.raises(ValueError, match="dedup"):
        TA.EngineConfig(dedup="sort")
    with pytest.raises(ValueError, match="slack"):
        TA.EngineConfig(slack=0.5)
    with pytest.raises(ValueError, match="verify"):
        TA.EngineConfig(verify="some")
    # the reference's levels and default; the level is not keyed
    for level in ("off", "plan", "full"):
        assert TA.EngineConfig(verify=level).verify == level
        assert TA.EngineConfig(verify=level).cache_sig() == \
            TA.EngineConfig().cache_sig()
    assert TA.EngineConfig().verify == JA.EngineConfig().verify == "plan"
