"""Port ``KGEngine.create_kg``/``.ingest`` against ``repro.api.KGEngine``.

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
import repro_torch.api as TA
from torch_parity import deltas, dises, extension_records, \
    isolated_plan_caches, same_step, sessions

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


@pytest.mark.parametrize("dedup", ["lex", "hash"])
@pytest.mark.parametrize("engine", ["rmlmapper", "sdm"])
@pytest.mark.parametrize("kind", ["fig4", "group_a", "group_b"])
def test_create_kg_and_ingest_match_reference(kind, engine, dedup):
    je, te = sessions(*dises(kind), engine, dedup)
    same_step(je.create_kg(), te.create_kg())
    same_step(je.create_kg(), te.create_kg())          # warm: cache hit
    # an ingest inside the capacity buckets, then one that crosses them
    for factor, seed, limit in ((1, 77, 5), (6, 78, None)):
        jd, td = deltas(je, te, extension_records(kind, factor, seed,
                                                    limit))
        same_step(je.ingest(jd), te.ingest(td))
    assert te.stats()["recompiles"] == je.stats()["recompiles"] >= 1
    assert te.stats()["builds"] == je.stats()["builds"]
