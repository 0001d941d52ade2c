"""Port planner, mapping model and synthetic data against the reference.

Host-side parity, all exact: the port's synthetic generators reproduce the
reference's codes and vocabulary from the same seed; ``DIS.from_numpy``
rebuilds a reference DIS from its plain pieces; the optimized plan's
``fingerprint`` equals the reference's sha1; the rewrite counters, the
annotated counts and capacities (``exact`` and ``bound`` modes) and the
materialization names agree.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro.core as JC
import repro.data.synthetic as JS
import repro.plan as JP
from repro.core.rml import triple_map_to_json
from repro.relalg import bucket_cap as j_bucket_cap, \
    round_cap as j_round_cap
import repro_torch.core as TC
import repro_torch.data.synthetic as TS
import repro_torch.plan as TP
from repro_torch.relalg import bucket_cap as t_bucket_cap, \
    round_cap as t_round_cap
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

SIGMA_SPEC = {
    "sources": {
        "g": {"attrs": ["k", "v", "sp"], "records": [
            {"k": "k1", "v": "o1", "sp": "HUMAN"},
            {"k": "k2", "v": None, "sp": "MOUSE"},
            {"k": "k3", "v": "o3", "sp": "HUMAN"}]},
        "h": {"attrs": ["k", "w"], "records": [
            {"k": "k1", "w": "b1"}, {"k": None, "w": "b2"},
            {"k": "k3", "w": "b3"}]},
        "u": {"attrs": ["x", "y"], "records": [
            {"x": "http://ex/Shared/1", "y": "a"},
            {"x": "http://ex/Shared/2", "y": "b"}]},
        "u2": {"attrs": ["p", "q"], "records": [
            {"p": "http://ex/Shared/1", "q": "a"},
            {"p": "http://ex/Shared/3", "q": None}]},
    },
    "maps": [
        {"name": "parent", "source": "g",
         "subject": {"template": "http://ex/P/{k}", "class": "ex:P"},
         "poms": [{"predicate": "ex:v", "object": {"reference": "v"}},
                  {"predicate": "ex:c", "object": {"constant": "ex:K"}}],
         "selections": [{"attr": "sp", "eq": "HUMAN"}]},
        {"name": "child", "source": "h",
         "subject": {"template": "http://ex/C/{w}"},
         "poms": [{"predicate": "ex:j",
                   "object": {"parentTriplesMap": "parent",
                              "joinCondition": {"child": "k",
                                                "parent": "k"}}}]},
        {"name": "s1", "source": "u",
         "subject": {"template": "http://ex/S/{x}"},
         "poms": [{"predicate": "ex:y", "object": {"reference": "y"}}]},
        {"name": "s2", "source": "u2",
         "subject": {"template": "http://ex/S/{p}"},
         "poms": [{"predicate": "ex:y", "object": {"reference": "q"}}]},
    ],
}


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _gene_spec():
    records, attrs = JS.fig4_gene_source()
    return {"sources": {"genes": {"attrs": attrs, "records": records}},
            "maps": [JS.FIG3_MAP]}


def _pairs():
    """(name, reference DIS, port DIS) built from the same spec/seed."""
    return [
        ("fig4", JC.parse_dis(_gene_spec()),
         TC.parse_dis(_gene_spec(), device="cpu")),
        ("fig5", JS.fig5_join_dis(), TS.fig5_join_dis(device="cpu")),
        ("sigma", JC.parse_dis(SIGMA_SPEC),
         TC.parse_dis(SIGMA_SPEC, device="cpu")),
        ("group_a", JS.make_group_a_dis(60, 0.5, seed=3),
         TS.make_group_a_dis(60, 0.5, seed=3, device="cpu")),
        ("group_b", JS.make_group_b_dis(80, 0.6, seed=2),
         TS.make_group_b_dis(80, 0.6, seed=2, device="cpu")),
    ]


def _same_dis(jd, td):
    assert jd.vocab._to_value == td.vocab._to_value
    assert jd.null_code == td.null_code
    assert jd.templates == td.templates
    assert [repr(m) for m in jd.maps] == [repr(m) for m in td.maps]
    assert list(jd.sources) == list(td.sources)
    for name, jt in jd.sources.items():
        tt = td.sources[name]
        assert tuple(jt.attrs) == tt.attrs and jt.capacity == tt.capacity
        np.testing.assert_array_equal(np.asarray(jt.data), tt.data.numpy())
        assert int(jt.count) == int(tt.count)


@pytest.mark.parametrize("idx", range(5))
def test_dis_and_synthetic_data_match_reference(idx):
    _name, jd, td = _pairs()[idx]
    _same_dis(jd, td)


def test_group_b_extension_records_match_reference():
    assert (JS.make_group_b_extension_records(40, seed=5)
            == TS.make_group_b_extension_records(40, seed=5))


def test_dis_from_numpy_rebuilds_reference_dis():
    jd = JC.parse_dis(SIGMA_SPEC)
    td = TC.DIS.from_numpy(
        {name: (t.to_codes(), t.attrs, t.capacity)
         for name, t in jd.sources.items()},
        list(jd.vocab._to_value),
        [triple_map_to_json(m) for m in jd.maps], device="cpu")
    _same_dis(jd, td)
    assert td.null_code is not None


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("idx", range(5))
def test_plan_fingerprint_stats_and_annotation_match(idx, optimize):
    _name, jd, td = _pairs()[idx]
    if optimize:
        jstats, tstats = JC.TransformStats(), TC.TransformStats()
        jplan = JC.plan_mapsdi(jd, stats=jstats)
        tplan = TC.plan_mapsdi(td, stats=tstats)
        assert dataclasses.asdict(jstats) == dataclasses.asdict(tstats)
    else:
        jplan, tplan = JP.lower(jd), TP.lower(td)
    assert TP.fingerprint(tplan.emits()) == JP.fingerprint(jplan.emits())
    assert [repr(m) for m in tplan.maps] == [repr(m) for m in jplan.maps]
    assert TP.input_names(tplan) == JP.input_names(jplan)
    for mode in ("exact", "bound"):
        for cap_fn in ((j_round_cap, t_round_cap),
                       (j_bucket_cap, t_bucket_cap)):
            jc, jcaps = JP.annotate(jplan, mode=mode, slack=1.5,
                                    cap_fn=cap_fn[0])
            tc, tcaps = TP.annotate(tplan, mode=mode, slack=1.5,
                                    cap_fn=cap_fn[1])
            assert [type(n).__name__ for n in tc] == \
                [type(n).__name__ for n in jc]
            assert list(tc.values()) == list(jc.values())
            assert list(tcaps.values()) == list(jcaps.values())


def test_selection_preds_and_sink_match():
    jd, td = JC.parse_dis(SIGMA_SPEC), TC.parse_dis(SIGMA_SPEC, device="cpu")
    for jm, tm in zip(jd.maps, td.maps):
        assert [repr(p) for p in TP.selection_preds(td, tm)] == \
            [repr(p) for p in JP.selection_preds(jd, jm)]
    for engine in ("rmlmapper", "sdm"):
        jroot = JC.plan_mapsdi(jd).sink(engine)
        troot = TC.plan_mapsdi(td).sink(engine)
        assert TP.fingerprint([troot]) == JP.fingerprint([jroot])
