"""Port ``repro_torch.analysis`` (static plan verification) against
``repro.analysis``.

Every deterministic case of ``test_analysis.py`` runs on both packages in
the same test, on the CPU, over plans lowered from the same DIS (the Fig. 5
join DIS and ``make_group_b_dis(48, 0.6, seed=0)``): the same corruption
applied to each package's plan must give the same diagnostic codes,
``nodes_checked`` and ``describe()`` text, each broken rewrite the same
``RewriteSoundnessError`` naming it, and the gated optimizer the
reference's fingerprints. ``expected_collectives`` and
``expected_query_collectives`` are pure functions of the plan and must
equal the reference's for 1 and 8 shards under gather and repartition.

The torch auditor has no counterpart to hold it to (the reference traces a
jaxpr), so it is held to the plan: the intact closure audits clean with its
counted host reads equal to ``expected_host_reads`` under every δ strategy
``test_torch_engine.py`` runs, and each deliberate fault fails with its
named diagnostic. Inputs come from fixed seeds (no Hypothesis). Every test
starts and ends with both packages' plan caches empty.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.analysis as JAN
import repro.api as JA
import repro.core as JC
import repro.data.synthetic as JS
import repro.plan as JP
import repro.query as JQ
import repro.relalg as JR
import repro_torch.analysis as TAN
import repro_torch.api as TA
import repro_torch.core as TC
import repro_torch.data.synthetic as TS
import repro_torch.plan as TP
import repro_torch.query as TQ
import repro_torch.relalg as TR
from repro_torch.relalg import count_transfers
from torch_parity import dises, extension_records, isolated_plan_caches

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: (name, analysis, plan, core, synthetic, extra DIS kwargs) per package
PKGS = {
    "ref": SimpleNamespace(an=JAN, P=JP, C=JC, S=JS, kw={}),
    "port": SimpleNamespace(an=TAN, P=TP, C=TC, S=TS, kw={"device": "cpu"}),
}
KINDS = ("fig5", "group_b")


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def make_dis(pk, kind):
    if kind == "fig5":
        return pk.S.fig5_join_dis(**pk.kw)
    return pk.S.make_group_b_dis(48, 0.6, seed=0, **pk.kw)


def optimized(kind):
    """{package: (pk, dis, optimized plan)}."""
    out = {}
    for name, pk in PKGS.items():
        dis = make_dis(pk, kind)
        plan = pk.P.lower(dis)
        pk.P.optimize(plan)
        out[name] = (pk, dis, plan)
    return out


def same_report(j, t):
    assert t.codes() == j.codes()
    assert t.nodes_checked == j.nodes_checked
    assert t.ok == j.ok
    assert t.describe() == j.describe()


def first_distinct_input(pk, plan):
    for tm in plan.maps:
        node = plan.inputs[tm.name]
        if isinstance(node, pk.P.Distinct) and \
                isinstance(node.child, pk.P.Project):
            return tm.name, node
    raise AssertionError("no canonical δ(π(..)) input in the plan")


def corrupt_both(kind, corrupt, **verify_kw):
    """Apply ``corrupt(pk, dis, plan)`` to each package's optimized plan
    and verify both; returns (reference report, port report)."""
    reports = []
    for pk, dis, plan in optimized(kind).values():
        kw = corrupt(pk, dis, plan) or {}
        reports.append(pk.an.verify_plan(plan, **dict(verify_kw, **kw)))
    same_report(*reports)
    return reports


# ---------------------------------------------------------------------------
# the intact plan passes; every corruption is rejected by name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_intact_plan_verifies(kind):
    both = optimized(kind)
    for engine in ("rmlmapper", "sdm"):
        reports = []
        for pk, dis, plan in both.values():
            counts, caps = pk.P.annotate(plan, mode="exact",
                                         sources=dis.sources)
            report = pk.an.verify_plan(plan, engine, counts=counts,
                                       caps=caps)
            assert report.ok, report.describe()
            assert plan.inputs[plan.maps[0].name] in report.schemas
            reports.append(report)
        same_report(*reports)
        j, t = reports
        assert sorted(s.describe() for s in t.schemas.values()) == \
            sorted(s.describe() for s in j.schemas.values())
    pk, dis, plan = both["port"]
    counts, caps = pk.P.annotate(plan, mode="exact", sources=dis.sources)
    bad = dict(caps)
    bad[next(iter(bad))] = -1
    with pytest.raises(TAN.PlanVerificationError):
        TAN.verify_plan(plan, counts=counts, caps=bad).raise_for_status()


@pytest.mark.parametrize("kind", KINDS)
def test_dropped_column_rejected(kind):
    def corrupt(pk, dis, plan):
        name, node = first_distinct_input(pk, plan)
        proj = node.child
        _, dst = proj.spec[0]
        plan.inputs[name] = pk.P.Distinct(pk.P.Project(
            proj.child, (("no_such_col", dst),) + proj.spec[1:]))
    j, _ = corrupt_both(kind, corrupt, check_cse=False)
    assert "unknown-column" in j.codes()


@pytest.mark.parametrize("stand_in", ["numpy", "torch"])
def test_swapped_join_key_dtype_rejected(stand_in):
    """A source re-typed to int64 makes the ⋈ keys disagree; the port
    reads the dtype off a numpy stand-in (the reference's fixture) or a
    torch one (its own Tables) and names it in numpy's spelling."""
    def sources(pk, dis, wide):
        out = {}
        for name, t in dis.sources.items():
            dtype = np.int64 if name == "gene" and wide else np.int32
            data = np.zeros((1, len(t.attrs)), dtype=dtype)
            if pk is PKGS["port"] and stand_in == "torch":
                data = torch.from_numpy(data)
            out[name] = SimpleNamespace(attrs=tuple(t.attrs), data=data)
        return out

    j, _ = corrupt_both("fig5", lambda pk, dis, plan: {
        "sources": sources(pk, dis, True)})
    assert "join-key-dtype" in j.codes()
    j, _ = corrupt_both("fig5", lambda pk, dis, plan: {
        "sources": sources(pk, dis, False)})
    assert j.ok


@pytest.mark.parametrize("kind", KINDS)
def test_inflated_capacity_and_impossible_count_rejected(kind):
    for what in ("caps", "counts"):
        def corrupt(pk, dis, plan):
            counts, caps = pk.P.annotate(plan, mode="exact",
                                         sources=dis.sources)
            _, node = first_distinct_input(pk, plan)
            counts, caps = dict(counts), dict(caps)
            if what == "caps":   # a δ cap above its child's
                caps[node] = caps[node.child] * 4 + 64
            else:                # a count π/σ/δ could never produce
                counts[node] = counts[node.child] + 1
            return {"counts": counts, "caps": caps}
        j, _ = corrupt_both(kind, corrupt)
        assert "capacity" in j.codes()


@pytest.mark.parametrize("kind", KINDS)
def test_reduplicated_cse_node_rejected(kind):
    def corrupt(pk, dis, plan):
        name, node = first_distinct_input(pk, plan)
        proj = node.child
        clone = pk.P.Project(proj.child, proj.spec)
        assert clone == proj and clone is not proj
        plan.inputs[name] = pk.P.Distinct(pk.P.Union((proj, clone)))
    j, _ = corrupt_both(kind, corrupt)
    assert "cse-alias" in j.codes()
    j, _ = corrupt_both(kind, corrupt, check_cse=False)
    assert j.ok


@pytest.mark.parametrize("kind", KINDS)
def test_non_canonical_select_rejected(kind):
    def corrupt(pk, dis, plan):
        name, node = first_distinct_input(pk, plan)
        scan = node.child.child
        while not isinstance(scan, pk.P.Scan):
            scan = scan.child
        attr = scan.scan_attrs[0]
        nested = pk.P.Select(pk.P.Select(scan, (pk.P.Pred(attr, "notnull",
                                                          0),)),
                             (pk.P.Pred(attr, "eq", 1),))
        plan.inputs[name] = pk.P.Distinct(pk.P.Project(
            nested, tuple((a, a) for a in scan.scan_attrs)))
    j, _ = corrupt_both(kind, corrupt, check_cse=False)
    assert "non-canonical" in j.codes()


@pytest.mark.parametrize("kind", KINDS)
def test_union_arity_mismatch_rejected(kind):
    def corrupt(pk, dis, plan):
        name, node = first_distinct_input(pk, plan)
        proj = node.child
        narrower = pk.P.Project(proj.child, proj.spec[:1])
        plan.inputs[name] = pk.P.Distinct(pk.P.Union((proj, narrower)))
    j, _ = corrupt_both(kind, corrupt, check_cse=False)
    assert "union-arity" in j.codes()


@pytest.mark.parametrize("kind", KINDS)
def test_cycle_rejected(kind):
    def corrupt(pk, dis, plan):
        _, node = first_distinct_input(pk, plan)
        object.__setattr__(node.child, "child", node)   # δ → π → δ
    j, _ = corrupt_both(kind, corrupt, check_cse=False)
    assert j.codes() == ("cycle",)
    assert j.nodes_checked == 0


@pytest.mark.parametrize("kind", KINDS)
def test_empty_emit_flagged(kind):
    reports = []
    for pk in PKGS.values():
        dis = make_dis(pk, kind)
        tm = dis.maps[1]
        dis.maps[1] = dataclasses.replace(tm, subject_class=None, poms=())
        plan = pk.P.lower(dis)
        reports.append(pk.an.verify_plan(plan, check_cse=False,
                                         check_canonical=False))
    same_report(*reports)
    assert "emit-empty" in reports[0].codes() and reports[0].ok


@pytest.mark.parametrize("kind", KINDS)
def test_unknown_source_rejected(kind):
    def corrupt(pk, dis, plan):
        drop = sorted(dis.sources)[0]
        return {"sources": {n: t for n, t in dis.sources.items()
                            if n != drop}}
    j, _ = corrupt_both(kind, corrupt)
    assert "unknown-source" in j.codes()


# ---------------------------------------------------------------------------
# rewrite-soundness gates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS + ("group_a",))
def test_checked_optimize_and_gated_plan_mapsdi_are_transparent(kind):
    fps, stats = [], []
    for pk in PKGS.values():
        if kind == "group_a":
            dis = pk.S.make_group_a_dis(40, 0.5, seed=3, **pk.kw)
        else:
            dis = make_dis(pk, kind)
        gated, plain = pk.P.lower(dis), pk.P.lower(dis)
        gstats = pk.an.checked_optimize(gated)
        pstats = pk.P.optimize(plain)
        assert dataclasses.asdict(gstats) == dataclasses.asdict(pstats)
        assert pk.P.fingerprint(gated.emits()) == \
            pk.P.fingerprint(plain.emits())
        mapsdi = pk.C.plan_mapsdi(dis, gate=pk.an.soundness_gate)
        fps.append((pk.P.fingerprint(gated.emits()),
                    pk.P.fingerprint(mapsdi.emits()),
                    pk.P.fingerprint(pk.C.plan_mapsdi(dis).emits())))
        stats.append(dataclasses.asdict(gstats))
    assert fps[0] == fps[1] and len(set(fps[1])) == 1
    assert stats[0] == stats[1]


BROKEN_PASSES = ("push_projections", "push_selections", "cse", "merge_maps",
                 "no_such_pass")


@pytest.mark.parametrize("rewrite", BROKEN_PASSES)
def test_broken_pass_named(rewrite):
    messages = []
    for pk, dis, plan in optimized("fig5").values():
        before = (list(plan.maps), dict(plan.inputs))
        name, node = first_distinct_input(pk, plan)
        proj = node.child
        if rewrite == "push_projections":     # drops a referenced column
            plan.inputs[name] = pk.P.Distinct(pk.P.Project(proj.child,
                                                           proj.spec[:1]))
        elif rewrite == "push_selections":    # renames: not a filter
            plan.inputs[name] = pk.P.Distinct(pk.P.Project(
                proj.child, tuple((s, d + "_x") for s, d in proj.spec)))
        elif rewrite == "cse":                # changes the structure
            plan.inputs[name] = pk.P.Distinct(pk.P.Distinct(proj))
        elif rewrite == "merge_maps":         # fresh maps off the role schema
            before = ([], dict(plan.inputs))
        with pytest.raises(pk.an.RewriteSoundnessError) as exc:
            pk.an.soundness_gate(rewrite, before, plan)
        assert exc.value.rewrite == rewrite
        assert rewrite in str(exc.value)
        messages.append(str(exc.value))
    assert messages[0] == messages[1]
    assert TAN.CONTRACTS == JAN.CONTRACTS


# ---------------------------------------------------------------------------
# the plan's collectives (pure functions of the plan: no mesh needed)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_expected_collectives_match_reference(kind):
    both = optimized(kind)
    for engine in ("rmlmapper", "sdm"):
        for n in (1, 8):
            for strategy in ("gather", "repartition"):
                got = []
                for pk, _, plan in both.values():
                    joins = [j for e in plan.emits() for _, j in e.joins]
                    exch = ({j: "repartition" for j in joins}
                            if strategy == "repartition" else None)
                    got.append(pk.an.expected_collectives(
                        plan, engine, n_shards=n, exchanges=exch))
                    assert pk.an.expected_collectives(
                        plan, engine, n_shards=n, exchanges=exch,
                        single_device=True) == {"all_gather": 0,
                                                "all_to_all": 0}
                assert got[0] == got[1], (engine, n, strategy)
    assert TAN.audit.EQNS_PER_GATHER == JAN.audit.EQNS_PER_GATHER
    assert TAN.audit.EQNS_PER_REPARTITION == JAN.audit.EQNS_PER_REPARTITION


def smoke_queries(pkg, codes):
    """The query shapes of ``chip_smoke.py``'s phase 2c, from the KG's own
    codes, in either package's spec types."""
    Q, P, F = pkg.Query, pkg.TriplePattern, pkg.QueryFilter
    row = codes[len(codes) // 2]
    s0, p0 = (int(row[0]), int(row[1])), int(row[2])
    o0 = (int(row[3]), int(row[4]))
    spo = P("?s", "?p", "?o")
    return {
        "scan_1pat": Q(patterns=[spo]),
        "join_2hop": Q(patterns=[spo, P("?o", "?p2", "?o2")]),
        "pred_eq_project": Q(patterns=[spo], filters=[F("?p", "eq", p0)],
                             project=("?s",)),
        "term_neq": Q(patterns=[spo], filters=[F("?o", "neq", o0)]),
        "repeated_var": Q(patterns=[P("?x", "?p", "?x")]),
        "exists_hit": Q(patterns=[P(s0, p0, o0)]),
        "exists_miss": Q(patterns=[P(s0, 2**30, o0)]),
    }


_KGS = {}


def kg_pair():
    """The group-B KG of both packages (codes equal; one build per file)."""
    if not _KGS:
        jdis, tdis = (JS.make_group_b_dis(48, 0.6, seed=0),
                      TS.make_group_b_dis(48, 0.6, seed=0, device="cpu"))
        je = JA.KGEngine(jdis, config=JA.EngineConfig(verify="off"))
        te = TA.KGEngine(tdis, config=TA.EngineConfig(), device="cpu")
        _KGS["pair"] = (je._kg_table(None), te._kg_table(None))
        np.testing.assert_array_equal(_KGS["pair"][0].to_codes(),
                                      _KGS["pair"][1].to_codes())
    return _KGS["pair"]


QUERY_NAMES = ("scan_1pat", "join_2hop", "pred_eq_project", "term_neq",
               "repeated_var", "exists_hit", "exists_miss")


@pytest.mark.parametrize("name", QUERY_NAMES)
def test_query_plan_verification_and_collectives_match_reference(name):
    jkg, tkg = kg_pair()
    codes = tkg.to_codes()
    jq = smoke_queries(JA, codes)[name]
    tq = smoke_queries(TA, codes)[name]
    jplan, tplan = JQ.lower_query(jq), TQ.lower_query(tq)
    jc, jcaps = JQ.annotate_query(jplan, {JQ.KG_SOURCE: jkg},
                                  cap_fn=JR.bucket_cap)
    tc, tcaps = TQ.annotate_query(tplan, {TQ.KG_SOURCE: tkg},
                                  cap_fn=TR.bucket_cap)
    j = JAN.verify_query_plan(jplan, counts=jc, caps=jcaps,
                              sources={JQ.KG_SOURCE: jkg})
    t = TAN.verify_query_plan(tplan, counts=tc, caps=tcaps,
                              sources={TQ.KG_SOURCE: tkg})
    assert t.ok, t.describe()
    same_report(j, t)
    if name == "repeated_var":
        assert any(isinstance(n, TP.ColEq) for n in t.schemas)
    for n in (1, 8):
        for strategy in ("gather", "repartition"):
            got = []
            for pk_an, pk_p, plan in ((JAN, JP, jplan), (TAN, TP, tplan)):
                joins = [x for x in pk_p.iter_nodes(plan.root)
                         if isinstance(x, pk_p.EquiJoin)]
                exch = ({x: "repartition" for x in joins}
                        if strategy == "repartition" else None)
                got.append(pk_an.expected_query_collectives(
                    plan, n_shards=n, exchanges=exch))
            assert got[0] == got[1], (n, strategy)
    # a root that is not the answer δ leaks bag duplicates
    reports = []
    for pk_an, plan in ((JAN, jplan), (TAN, tplan)):
        bare = dataclasses.replace(plan, root=plan.root.child)
        reports.append(pk_an.verify_query_plan(bare))
    same_report(*reports)
    assert "query-root" in reports[1].codes()


# ---------------------------------------------------------------------------
# the torch auditor
# ---------------------------------------------------------------------------

def fig5_step(dedup="hash", engine="rmlmapper"):
    """The port's Fig. 5 closure plus the read of its overflow flag (what
    ``KGEngine`` audits), its sources and its plan."""
    dis = TS.fig5_join_dis(device="cpu")
    plan = TP.lower(dis)
    TP.optimize(plan)
    _, caps = TP.annotate(plan, mode="exact", sources=dis.sources)
    view = dis.copy()
    view.maps = list(plan.maps)
    emitter = TC.RDFizer(view, engine, join_caps={}, dedup=dedup)
    fn = TP.compile_plan(plan, emitter, engine=engine, dedup=dedup,
                         caps=caps, report_overflow=True)

    def step(sources):
        kg, raw, over = fn(sources)
        return kg, raw, TR.host_int(over)
    return step, dis.sources, plan


def audit(step, sources, plan, engine="rmlmapper", dedup="hash", **kw):
    kw.setdefault("expected_host_reads", functools.partial(
        TAN.expected_host_reads, plan, engine, dedup))
    return TAN.audit_closure(step, (sources,), plan=plan, engine=engine,
                             single_device=True, **kw)


def test_single_device_closure_audits_clean():
    step, sources, plan = fig5_step()
    plain = step(sources)
    report = audit(step, sources, plan)
    assert report.ok, report.describe()
    assert report.describe().startswith("audit: ok")
    assert report.collectives == {"all_gather": 0, "all_to_all": 0}
    assert not report.host_callbacks and not report.transfers
    assert not report.promotions
    assert report.host_reads == report.expected_host_reads == 4
    assert report.sync_warnings is None         # no card: no sync debug
    kg, raw, over = report.result               # the run itself, unchanged
    np.testing.assert_array_equal(kg.to_codes(), plain[0].to_codes())
    assert (TR.host_int(raw), over) == (TR.host_int(plain[1]), plain[2])


def _bare_item(step):
    def bad(sources):
        out = step(sources)
        out[1].item()                    # a read the ledger never sees
        return out
    return bad


def _int64_column(step):
    def bad(sources):
        kg, raw, over = step(sources)
        return TR.Table(data=kg.data.to(torch.int64), count=kg.count,
                        attrs=kg.attrs), raw, over
    return bad


def _double(step):
    def bad(sources):
        kg, raw, over = step(sources)
        return kg, raw.double(), over
    return bad


def _bool_mask(step):
    def bad(sources):
        kg, raw, over = step(sources)
        kg.data[kg.data[:, 0] >= 0]      # a hidden nonzero
        return kg, raw, over
    return bad


MUTATIONS = {
    "bare_item": (_bare_item, {}, "host-transfer"),
    "bool_mask_index": (_bool_mask, {}, "host-transfer"),
    "int64_column": (_int64_column, {}, "dtype-promotion"),
    "double": (_double, {}, "dtype-promotion"),
    "host_reads_off_by_one": (None, {"expected_host_reads": 5},
                              "host-read-mismatch"),
    "mislabelled_collectives": (None, {"expected_counts": {
        "all_gather": 2, "all_to_all": 0}}, "collective-mismatch"),
}


@pytest.mark.parametrize("mutation", sorted(MUTATIONS))
def test_auditor_mutation_fails_with_its_code(mutation):
    wrap, kw, code = MUTATIONS[mutation]
    step, sources, plan = fig5_step()
    if wrap is not None:
        step = wrap(step)
    report = audit(step, sources, plan, **kw)
    assert not report.ok
    assert {d.code for d in report.diagnostics} == {code}, \
        report.describe()
    assert report.describe().startswith("audit: FAILED")
    with pytest.raises(TAN.ClosureAuditError):
        report.raise_for_status()


@pytest.mark.parametrize("dedup", ["lex", "hash"])
@pytest.mark.parametrize("engine", ["rmlmapper", "sdm"])
@pytest.mark.parametrize("kind", ["fig4", "group_a", "group_b"])
def test_full_session_audits_every_build_like_off(kind, engine, dedup):
    """``test_torch_engine.py``'s steps under ``verify="full"`` against
    ``"off"``: equal KGs, counters and counted host reads per step; one
    plan check and one clean audit per build, each audit's ledger equal to
    ``expected_host_reads``."""
    steps = {}
    for level in ("off", "full"):
        TA.clear_plan_cache()
        _, tdis = dises(kind)
        eng = TA.KGEngine(tdis, config=TA.EngineConfig(
            engine=engine, dedup=dedup, verify=level), device="cpu")
        out, audits = [], []
        runs = [eng.create_kg, eng.create_kg]
        for factor, seed, limit in ((1, 77, 5), (6, 78, None)):
            td = {name: TR.Table.from_records(recs, eng.sources[name].attrs,
                                              eng.vocab, device="cpu")
                  for name, recs in extension_records(
                      kind, factor, seed, limit).items()}
            runs.append(functools.partial(eng.ingest, td))
        for run in runs:
            eng.last_audit = None
            with count_transfers() as ledger:
                kg, stats = run()
            if eng.last_audit is not None:
                rep = eng.last_audit
                assert rep.ok and rep.host_reads == rep.expected_host_reads
                audits.append(rep.host_reads)
            out.append((kg.to_codes().tolist(), stats["raw_triples"],
                        stats["recompiles"], stats["plan_cache_hit"],
                        ledger.device_to_host))
        v = eng.stats()["verify"]
        assert v == {"mode": level, "plan_checks": 0 if level == "off"
                     else eng.builds, "audits": 0 if level == "off"
                     else eng.builds, "store_checks": 0}
        assert len(audits) == (eng.builds if level == "full" else 0)
        steps[level] = out
    assert steps["full"] == steps["off"]


# ---------------------------------------------------------------------------
# engine integration
# ---------------------------------------------------------------------------

def test_engine_verify_counters_and_explain():
    te = TA.KGEngine(TS.fig5_join_dis(device="cpu"), config=TA.EngineConfig(
        engine="rmlmapper", verify="full"), device="cpu")
    je = JA.KGEngine(JS.fig5_join_dis(), config=JA.EngineConfig(
        engine="rmlmapper", verify="full"))
    te.create_kg()
    je.create_kg()
    assert te.stats()["verify"] == je.stats()["verify"] == {
        "mode": "full", "plan_checks": 1, "audits": 1, "store_checks": 0}
    text = te.explain()
    assert "verify: ok" in text and "cols=" in text
    assert text == je.explain()
    # a query build is checked and audited too
    codes = te._kg_table(None).to_codes()
    tq, jq = (smoke_queries(TA, codes)["join_2hop"],
              smoke_queries(JA, codes)["join_2hop"])
    te.query(tq)
    je.query(jq)
    assert te.stats()["verify"] == je.stats()["verify"] == {
        "mode": "full", "plan_checks": 2, "audits": 2, "store_checks": 0}
    assert te.last_audit.ok and te.last_audit.host_reads == 2
    assert te.explain_query(tq) == je.explain_query(jq)
    assert "verify: ok" in te.explain_query(tq)
    off = TA.KGEngine(TS.fig5_join_dis(device="cpu"),
                      config=TA.EngineConfig(verify="off"), device="cpu")
    assert off.stats()["verify"]["mode"] == "off"
    assert "verify:" not in off.explain()
    with pytest.raises(ValueError):
        TA.EngineConfig(verify="sometimes")


def test_unoptimized_plan_verifies_without_cse_checks():
    te = TA.KGEngine(TS.fig5_join_dis(device="cpu"), config=TA.EngineConfig(
        optimize=False, verify="plan"), device="cpu")
    je = JA.KGEngine(JS.fig5_join_dis(), config=JA.EngineConfig(
        optimize=False, verify="plan"))
    te.create_kg()    # duplicate equal Scans are legitimate
    je.create_kg()
    assert te.stats()["verify"] == je.stats()["verify"]
    assert te.stats()["verify"]["plan_checks"] == 1


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def _cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_demo_and_store(tmp_path):
    out = _cli("demo", "--join", "--audit", "-v", "--device", "cpu")
    assert out.returncode == 0, out.stderr
    assert "verify: ok" in out.stdout and "audit: ok" in out.stdout
    assert "cols=" in out.stdout
    # a clean (here: empty) store passes, as in the reference
    out = _cli("store", "--root", str(tmp_path / "empty"))
    assert out.returncode == 0, out.stderr
    assert "0 entries, 0 invalid" in out.stdout
