"""The paper's experiment in the port against the reference, on the CPU.

Rules 1–3 (``apply_projection``, ``apply_merge``, both fixpoint loops),
the materialization, the T-framework, the one-shot pipeline and its
deprecated shims, the N-Triples sink and ``explain``: the same DIS spec
goes to ``repro`` and ``repro_torch`` and everything they return must be
equal, bit for bit (tolerance 0: the path is int32 throughout) — source
names and order, attrs, capacities, codes, provenance flags, maps, every
``TransformStats`` field, KG codes, raw counts, stats, text.

Inputs are literal specs and numpy-seeded ones (no Hypothesis, so a run
writes no example database). Every test starts and ends with both
packages' plan caches empty (``isolated_plan_caches``).

The reference compiles every closure and op with XLA, which takes most
of the file's time, so each case runs under one δ strategy
(TRANSFORM_CASES) and the KG-level entry points run on three cases, each
under its own (engine, dedup) pair (KG_CASES).
"""
import dataclasses
import importlib
import json
import warnings

import numpy as np
import pytest
import torch

import repro.api as JA
import repro.core as JC
import repro.core.pipeline as JPIPE
import repro.core.transform as JT
import repro.data.synthetic as JS
import repro.plan as JP
import repro.relalg as JR
from repro.configs.mapsdi_paper import CONFIG as J_PAPER
import repro_torch.api as TA
import repro_torch.core as TC
import repro_torch.core.pipeline as TPIPE
import repro_torch.core.transform as TT
import repro_torch.data.synthetic as TS
import repro_torch.plan as TP
import repro_torch.relalg as TR
from repro_torch.configs.mapsdi_paper import CONFIG as T_PAPER, PaperConfig
from repro_torch.relalg import count_transfers, forbid_transfers
from repro_torch.relalg.ops import hash_dedup_counts, \
    reset_hash_dedup_counts
from torch_parity import gene_spec, isolated_plan_caches

torch.set_num_threads(1)

ENGINES = ("rmlmapper", "sdm")
DEDUPS = ("lex", "hash")

# σ selections over a join parent, a Rule-3 pair sharing a template, nulls
SIGMA_SPEC = {
    "sources": {
        "g": {"attrs": ["k", "v", "sp"], "records": [
            {"k": "k1", "v": "o1", "sp": "HUMAN"},
            {"k": "k2", "v": None, "sp": "MOUSE"},
            {"k": "k3", "v": "o3", "sp": "HUMAN"},
            {"k": "k1", "v": "o1", "sp": "HUMAN"}]},
        "h": {"attrs": ["k", "w"], "records": [
            {"k": "k1", "w": "b1"}, {"k": None, "w": "b2"},
            {"k": "k3", "w": "b3"}, {"k": "k3", "w": "b3"}]},
        "u": {"attrs": ["x", "y"], "records": [
            {"x": "1", "y": "a"}, {"x": "2", "y": "b"}, {"x": "1", "y": "a"}]},
        "u2": {"attrs": ["p", "q"], "records": [
            {"p": "1", "q": "a"}, {"p": "3", "q": None}]},
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
                                                "parent": "k"}}}],
         "selections": [{"attr": "k", "notnull": True}]},
        {"name": "s1", "source": "u",
         "subject": {"template": "http://ex/S/{x}"},
         "poms": [{"predicate": "ex:y", "object": {"reference": "y"}}]},
        {"name": "s2", "source": "u2",
         "subject": {"template": "http://ex/S/{p}"},
         "poms": [{"predicate": "ex:y", "object": {"reference": "q"}}]},
    ],
}

# The failing example of the reference's
# test_planner_properties.py::test_planner_fixpoint_matches_eager_fixpoint
# (ROADMAP.md Queue 3): null-valued sources, m0 and m2 sharing the template
# http://ex/Shared/{…}, a Rule-3 merge of m0 and m2.
PLANNER_FIXPOINT_SPEC = {
    "sources": {
        "s0": {"attrs": ["x0_0"], "records": [{"x0_0": None}] * 5},
        "s1": {"attrs": ["x1_0"], "records": [
            {"x1_0": None}, {"x1_0": None}, {"x1_0": None},
            {"x1_0": "a"}]}},
    "maps": [
        {"name": "m0", "source": "s0",
         "subject": {"template": "http://ex/Shared/{x0_0}"},
         "poms": [{"predicate": "ex:p1", "object": {"reference": "x0_0"}}]},
        {"name": "m1", "source": "s0",
         "subject": {"template": "http://ex/T/{x0_0}"},
         "poms": [{"predicate": "ex:p2", "object": {"constant": "ex:k2"}},
                  {"predicate": "ex:p1", "object": {"reference": "x0_0"}},
                  {"predicate": "ex:p2", "object": {"reference": "x0_0"}}]},
        {"name": "m2", "source": "s1",
         "subject": {"template": "http://ex/Shared/{x1_0}"},
         "poms": [{"predicate": "ex:p1", "object": {"reference": "x1_0"}}]},
    ],
}

N_RANDOM = 10
SMALL_CAPACITY = 16
SYNTHETIC_CAPACITY = 256


def random_spec(seed: int) -> dict:
    """A DIS spec shaped like ``tests/test_lossless.py``'s strategy (1–3
    sources of 1–4 attrs and 0–12 rows, 1–3 maps over references,
    constants, templates and classes, a shared subject template as Rule-3
    bait, maybe a join from the last map to the first), plus null values
    and σ selections."""
    rng = np.random.default_rng(seed)
    pick = lambda seq: seq[int(rng.integers(len(seq)))]  # noqa: E731
    values = ["a", "b", "c", "d", "e", None]
    sources, src_attrs = {}, {}
    for si in range(int(rng.integers(1, 4))):
        attrs = [f"x{si}_{k}" for k in range(int(rng.integers(1, 5)))]
        records = [{a: pick(values) for a in attrs}
                   for _ in range(int(rng.integers(0, 13)))]
        sources[f"s{si}"] = {"attrs": attrs, "records": records}
        src_attrs[f"s{si}"] = attrs
    maps = []
    for mi in range(int(rng.integers(1, 4))):
        src = pick(sorted(sources))
        attrs = src_attrs[src]
        subj_attr = pick(attrs)
        subj = {"template": pick(["http://ex/T/{%s}" % subj_attr,
                                  "http://ex/Shared/{%s}" % subj_attr])}
        if rng.random() < 0.5:
            subj["class"] = pick(["ex:C1", "ex:C2"])
        poms = []
        for _ in range(int(rng.integers(0, 4))):
            kind = pick(["reference", "constant", "template"])
            pred = pick(["ex:p1", "ex:p2", "ex:p3"])
            if kind == "reference":
                obj = {"reference": pick(attrs)}
            elif kind == "constant":
                obj = {"constant": pick(["ex:k1", "ex:k2"])}
            else:
                obj = {"template": "http://ex/O/{%s}" % pick(attrs)}
            poms.append({"predicate": pred, "object": obj})
        tm = {"name": f"m{mi}", "source": src, "subject": subj,
              "poms": poms}
        if rng.random() < 0.4:
            op = pick(["eq", "neq", "notnull"])
            sel = {"attr": pick(attrs)}
            sel.update({"notnull": True} if op == "notnull"
                       else {op: pick(values[:-1])})
            tm["selections"] = [sel]
        maps.append(tm)
    if len(maps) >= 2 and rng.random() < 0.6:
        child, parent = maps[-1], maps[0]
        child["poms"] = child["poms"] + [{
            "predicate": "ex:join",
            "object": {"parentTriplesMap": parent["name"],
                       "joinCondition": {
                           "child": pick(src_attrs[child["source"]]),
                           "parent": pick(src_attrs[parent["source"]])}}}]
    return {"sources": sources, "maps": maps}


SPECS = {"fig4": gene_spec(), "sigma": SIGMA_SPEC,
         **{f"random{s}": random_spec(s) for s in range(N_RANDOM)}}
SCENARIOS = dict(zip("abc", J_PAPER.group_b_scenarios))
#: the transformations' δ strategy per case (the random specs alternate)
TRANSFORM_CASES = (
    [("fig4", "lex"), ("sigma", "hash")] +
    [(f"random{s}", DEDUPS[s % 2]) for s in range(N_RANDOM)] +
    [("fig5", "hash"), ("group_a", "lex"), ("group_b_a", "hash"),
     ("group_b_b", "lex"), ("group_b_c", "hash"), ("motivating", "lex")])
#: the KG-level entry points' cases: three (engine, dedup) pairs on the
#: paper's figures and group A; the planner-fixpoint test runs rdfize under
#: the fourth (rmlmapper with the default δ, hash)
KG_CASES = [("fig4", "rmlmapper", "lex"), ("fig5", "sdm", "lex"),
            ("group_a", "sdm", "hash")]


def _rebuffered(dis, pkg, capacity, **kw):
    """``dis`` with every source re-buffered at ``capacity`` rows."""
    dis.sources = {name: pkg.Table.from_codes(t.to_codes(), t.attrs,
                                              capacity, **kw)
                   for name, t in dis.sources.items()}
    return dis


def _synthetic(case: str, pkg, **kw):
    if case == "fig5":
        return pkg.fig5_join_dis(**kw)
    if case == "group_a":
        return pkg.make_group_a_dis(128, 0.75, seed=5, n_noise_attrs=2,
                                    **kw)
    if case.startswith("group_b_"):
        left, right = SCENARIOS[case[-1]]
        return pkg.make_group_b_dis(128, 0.75, seed=6, dedup_left=left,
                                    dedup_right=right, **kw)
    assert case == "motivating"
    return pkg.make_motivating_dis(200, **kw)


def make_dises(case: str):
    """The case's DIS built by each package, on the CPU, every source
    re-buffered with padding at SMALL_CAPACITY rows (the literal and random
    specs, Fig. 5) or SYNTHETIC_CAPACITY (group A/B, Fig. 1): the
    reference compiles each op once per shape, so shared shapes keep the
    file fast."""
    if case in SPECS:
        jdis = JC.parse_dis(SPECS[case])
        tdis = TC.parse_dis(SPECS[case], device="cpu")
        cap = SMALL_CAPACITY
    else:
        jdis, tdis = _synthetic(case, JS), _synthetic(case, TS, device="cpu")
        cap = SMALL_CAPACITY if case == "fig5" else SYNTHETIC_CAPACITY
    return (_rebuffered(jdis, JR, cap),
            _rebuffered(tdis, TR, cap, device="cpu"))


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


@pytest.fixture
def quiet_deprecations():
    """The deprecated entry points warn once per process; keep their
    warnings out of the test output, and both packages' warn-once sets as
    they were."""
    saved = set(JPIPE._WARNED), set(TPIPE._WARNED)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        yield
    JPIPE._WARNED.clear()
    JPIPE._WARNED.update(saved[0])
    TPIPE._WARNED.clear()
    TPIPE._WARNED.update(saved[1])


def same_dis(jdis, tdis) -> None:
    assert list(jdis.sources) == list(tdis.sources)
    for name, jt in jdis.sources.items():
        tt = tdis.sources[name]
        assert tt.attrs == jt.attrs, name
        assert tt.capacity == jt.capacity, name
        np.testing.assert_array_equal(tt.to_codes(), jt.to_codes(),
                                      err_msg=name)
    assert tdis.preprocessed == jdis.preprocessed
    assert tdis.sigma_baked == jdis.sigma_baked
    assert ([TC.rml.triple_map_to_json(m) for m in tdis.maps] ==
            [JC.rml.triple_map_to_json(m) for m in jdis.maps])
    assert TC.dump_maps(tdis.maps) == JC.dump_maps(jdis.maps)
    assert tdis.templates == jdis.templates
    assert tdis.null_code == jdis.null_code
    assert tdis.vocab._to_value == jdis.vocab._to_value


def same_stats(js, ts) -> None:
    assert dataclasses.asdict(ts) == dataclasses.asdict(js)


def same_kg(jout, tout) -> None:
    (jkg, jraw), (tkg, traw) = jout, tout
    np.testing.assert_array_equal(tkg.to_codes(), jkg.to_codes())
    assert int(traw) == int(jraw)


# ---------------------------------------------------------------------------
# Rules 1–3 and the two fixpoint loops (engine-independent)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,dedup", TRANSFORM_CASES)
def test_transformations_match_reference(case, dedup):
    jdis, tdis = make_dises(case)
    same_dis(jdis, tdis)
    assert TT._join_parents(tdis) == JT._join_parents(jdis)
    for fixpoint in ("apply_mapsdi_eager", "apply_mapsdi"):
        jout, js = getattr(JC, fixpoint)(jdis, dedup=dedup)
        tout, ts = getattr(TC, fixpoint)(tdis, dedup=dedup)
        same_dis(jout, tout)
        same_stats(js, ts)
        assert TT._dis_signature(tout) == JT._dis_signature(jout)
    # the eager fixpoint's first round, rule by rule (the reference has
    # compiled its ops already)
    js, ts = JC.TransformStats(), TC.TransformStats()
    for rule in ("apply_merge", "apply_projection"):
        jdis_r = getattr(JC, rule)(jdis, js, dedup=dedup)
        tdis_r = getattr(TC, rule)(tdis, ts, dedup=dedup)
        same_dis(jdis_r, tdis_r)
        same_stats(js, ts)
        jdis, tdis = jdis_r, tdis_r


# ---------------------------------------------------------------------------
# KG-level entry points, one (engine, dedup) pair per case
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case,engine,dedup", KG_CASES)
def test_kg_entry_points_match_reference(case, engine, dedup,
                                         quiet_deprecations):
    jdis, tdis = make_dises(case)
    jplan, tplan = JC.plan_mapsdi(jdis), TC.plan_mapsdi(tdis)
    for annotated in (False, True):
        assert (TP.explain(tplan, engine, with_annotations=annotated) ==
                JP.explain(jplan, engine, with_annotations=annotated))

    jraw = JC.rdfize(jdis, engine, dedup)
    traw = TC.rdfize(tdis, engine, dedup)
    same_kg(jraw, traw)
    assert (TC.triples_to_ntriples(traw[0], tdis) ==
            JC.triples_to_ntriples(jraw[0], jdis))

    jkg, jst = JC.t_framework_create_kg(jdis, engine, dedup)
    t_kg, tst = TC.t_framework_create_kg(tdis, engine, dedup)
    np.testing.assert_array_equal(t_kg.to_codes(), jkg.to_codes())
    assert tst == jst
    # the reference's make_t_framework_fn runs the very RDFizer call its
    # t_framework_create_kg runs (one XLA compile saved)
    tkg_fn, traw_fn = TC.make_t_framework_fn(tdis, engine, dedup)()
    np.testing.assert_array_equal(tkg_fn.to_codes(), jkg.to_codes())
    assert int(traw_fn) == jst["raw_triples"]

    jkg, jst = JC.mapsdi_create_kg(jdis, engine, dedup)
    tkg, tst = TC.mapsdi_create_kg(tdis, engine, dedup)
    np.testing.assert_array_equal(tkg.to_codes(), jkg.to_codes())
    for key in ("raw_triples", "kg_triples", "source_rows_before",
                "source_rows_after", "rule1", "rule2", "rule3", "sigma",
                "cse_shared", "recompiles", "plan_cache_hit"):
        assert tst[key] == jst[key], key
    # the paper's Q1: the T-framework's KG is MapSDI's, as a row set
    assert t_kg.row_set() == tkg.row_set()

    (jfn, jp), (tfn, tp) = (JPIPE.make_planned_fn(jdis, engine, dedup),
                            TPIPE.make_planned_fn(tdis, engine, dedup))
    assert TP.fingerprint(tp.emits()) == JP.fingerprint(jp.emits())
    same_kg(jfn(jdis.sources), tfn(tdis.sources))
    (jfn, jdis2), (tfn, tdis2) = (JPIPE.make_mapsdi_fn(jdis, engine, dedup),
                                  TPIPE.make_mapsdi_fn(tdis, engine, dedup))
    same_dis(jdis2, tdis2)
    same_kg(jfn(), tfn())

    je = JA.KGEngine(jdis, config=JA.EngineConfig(engine=engine,
                                                  dedup=dedup))
    te = TA.KGEngine(tdis, config=TA.EngineConfig(engine=engine,
                                                  dedup=dedup),
                     device="cpu")
    assert te.explain() == je.explain()
    assert TP.fingerprint(te.plan.emits()) == JP.fingerprint(je.plan.emits())
    assert te.plan_signature[:2] == je.plan_signature[:2]
    assert te.plan_signature[2:] == te.config.cache_sig()
    je.create_kg()
    te.create_kg()
    assert (te.builds, te.recompiles) == (je.builds, je.recompiles)
    assert te.explain() == je.explain()


# ---------------------------------------------------------------------------
# the pinned reference caveat
# ---------------------------------------------------------------------------

def test_planner_fixpoint_case_pinned(quiet_deprecations):
    """Both fixpoints equal the reference's on the planner-fixpoint case,
    and, like the reference's, both KGs differ in their codes from the raw
    ``rdfize`` KG while the decoded triples are equal: each DIS is parsed
    anew, and the RDFizer interns predicates in map order, which the
    Rule-3 merge changes (the merged map goes last), so ``ex:p1`` and
    ``ex:p2`` swap codes. ROADMAP.md Queue 3 records it. The δ strategy is
    the default, as in the reference's test."""
    out = {}
    for pkg, kw in ((JC, {}), (TC, {"device": "cpu"})):
        raw_dis = pkg.parse_dis(PLANNER_FIXPOINT_SPEC, **kw)
        dis_e, st_e = pkg.apply_mapsdi_eager(
            pkg.parse_dis(PLANNER_FIXPOINT_SPEC, **kw))
        dis_p, st_p = pkg.apply_mapsdi(pkg.parse_dis(PLANNER_FIXPOINT_SPEC,
                                                     **kw))
        kgs = [pkg.rdfize(d) for d in (raw_dis, dis_e, dis_p)]
        out[pkg] = dict(
            dises=(dis_e, dis_p), stats=(st_e, st_p),
            codes=[kg.to_codes() for kg, _ in kgs],
            raw=[raw for _, raw in kgs],
            lines=[sorted(pkg.triples_to_ntriples(kg, d))
                   for (kg, _), d in zip(kgs, (raw_dis, dis_e, dis_p))])
    j, t = out[JC], out[TC]
    for jd, td in zip(j["dises"], t["dises"]):
        same_dis(jd, td)
    for js, ts in zip(j["stats"], t["stats"]):
        same_stats(js, ts)
    for jc, tc in zip(j["codes"], t["codes"]):
        np.testing.assert_array_equal(tc, jc)
    assert t["raw"] == j["raw"]
    assert t["lines"] == j["lines"]
    # which of the two KGs differs from the raw KG, in codes: both
    differs = tuple(not np.array_equal(c, t["codes"][0])
                    for c in t["codes"][1:])
    assert differs == (True, True)
    assert t["lines"][0] == t["lines"][1] == t["lines"][2] == [
        '<http://ex/Shared/a> <ex:p1> "a" .']


# ---------------------------------------------------------------------------
# host reads, warn-once, configuration, unported arguments
# ---------------------------------------------------------------------------

def test_plan_mapsdi_makes_no_host_read():
    tdis = TS.make_group_b_dis(200, 0.6, seed=7, device="cpu")
    with forbid_transfers() as ledger:
        plan = TC.plan_mapsdi(tdis)
    assert ledger.device_to_host == 0
    assert len(plan.maps) == 2


@pytest.mark.parametrize("dedup", DEDUPS)
@pytest.mark.parametrize("case", ["sigma", "group_a", "group_b_a",
                                  "motivating"])
def test_materialize_plan_host_reads(case, dedup):
    """One counted read per source of DIS' (the row count that sizes a
    new source's shrink) plus one per hash δ call, none else. (Its output
    is held against the reference's through ``apply_mapsdi`` above.)"""
    _, tdis = make_dises(case)
    plan = TC.plan_mapsdi(tdis)
    reset_hash_dedup_counts()
    with count_transfers() as ledger:
        out, rows_after = TP.materialize_plan(plan, dedup=dedup)
    hash_calls = sum(hash_dedup_counts()["calls"].values())
    assert (hash_calls > 0) == (dedup == "hash")
    assert ledger.device_to_host == len(out.sources) + hash_calls
    assert rows_after == {name: int(t.count)
                          for name, t in out.sources.items()}


def test_deprecated_entry_points_warn_once(quiet_deprecations):
    mk = lambda: TS.make_group_b_dis(16, 0.5, seed=22,  # noqa: E731
                                     device="cpu")
    TPIPE._WARNED.clear()
    with warnings.catch_warnings():
        warnings.simplefilter("default", DeprecationWarning)
        for name, call in (("make_planned_fn",
                            lambda: TPIPE.make_planned_fn(mk())),
                           ("make_mapsdi_fn",
                            lambda: TPIPE.make_mapsdi_fn(mk())),
                           ("rdfize", lambda: TC.rdfize(mk()))):
            with pytest.warns(DeprecationWarning, match=name):
                call()
        # second calls: silent
        warnings.simplefilter("error", DeprecationWarning)
        TPIPE.make_planned_fn(mk())
        TPIPE.make_mapsdi_fn(mk())
        TC.rdfize(mk())


def test_paper_config_and_load_dis(tmp_path):
    assert dataclasses.asdict(T_PAPER) == dataclasses.asdict(J_PAPER)
    assert T_PAPER == PaperConfig()
    assert ([T_PAPER.rows_for_volume(v) for v in T_PAPER.volumes] ==
            [J_PAPER.rows_for_volume(v) for v in J_PAPER.volumes])
    path = tmp_path / "dis.json"
    path.write_text(json.dumps(SIGMA_SPEC))
    same_dis(JC.load_dis(str(path)), TC.load_dis(str(path), device="cpu"))


def test_explain_helpers_match_reference():
    JX = importlib.import_module("repro.plan.explain")
    TX = importlib.import_module("repro_torch.plan.explain")
    for n in (0, 1, 1023, 1024, 1536, 5 << 20, 3 << 30, 7 << 40):
        assert TX._fmt_bytes(n) == JX._fmt_bytes(n)
    jdis, tdis = make_dises("sigma")
    jroot = JC.plan_mapsdi(jdis).sink("sdm")
    troot = TC.plan_mapsdi(tdis).sink("sdm")
    assert sorted(TX._multi_referenced(troot).values()) == \
        sorted(JX._multi_referenced(jroot).values())
    assert TX.dump_root(troot) == JX.dump_root(jroot)


def test_unported_explain_arguments_raise():
    """The mesh arguments are ported now: ``explain(n_shards=2)`` and
    ``dump_plan(exchanges=...)`` print the reference's text."""
    jdis = JS.make_group_b_dis(16, 0.5, seed=3)
    tdis = TS.make_group_b_dis(16, 0.5, seed=3, device="cpu")
    jplan, plan = JC.plan_mapsdi(jdis), TC.plan_mapsdi(tdis)
    JX = importlib.import_module("repro.plan.explain")
    for strategy in ("gather", "repartition"):
        assert TP.explain(plan, n_shards=2, join_exchange=strategy) == \
            JX.explain(jplan, n_shards=2, join_exchange=strategy)
    assert TP.dump_plan(plan, exchanges={}) == \
        JP.dump_plan(jplan, exchanges={})
    # the static verifier's schemas and verdict are ported: the dump
    # carries them as the reference's does
    from repro_torch.analysis import verify_plan
    report = verify_plan(plan, "sdm")
    text = TP.dump_plan(plan, "sdm", schemas=report.schemas,
                        verdict=report.describe())
    assert text.startswith(report.describe() + "\n")
    assert "cols=" in text


def test_dis_device_is_the_sources_device():
    tdis = TS.make_group_b_dis(16, 0.5, seed=3, device="cpu")
    assert tdis.device == torch.device("cpu")
    tdis.sources = {}
    assert tdis.device is None
