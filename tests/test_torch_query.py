"""BGP queries in the port against the reference, on the CPU.

The same DIS goes to ``repro.api.KGEngine`` and
``repro_torch.api.KGEngine(..., device="cpu")``; the same queries then go
to both sessions, and everything the query tier returns must be equal, bit
for bit (tolerance 0: the path is int32 throughout): ``Query.fingerprint()``,
``query_session_key``, the lowered DAG's IR fingerprint, ``annotate_query``'s
counts and caps by ``node_order`` index in both modes, each answer's codes
(row order included) and attrs, ``explain_query``'s text, the
``stats()["query"]`` counters and the recompiles a cross-session cache hit
costs. Every answer is also held against the host-side pattern-match
oracle of ``test_query.py`` (``bgp_oracle``), and so are the port's answers
to 25 numpy-seeded random connected BGPs shaped like
``test_query_properties.py::bgps``. The file
also holds the port's ``KGEngine`` keyword surface to the reference's.

Inputs come from numpy seeds (no Hypothesis, so a run writes no example
database). Both packages run at the default ``verify="plan"`` (so the
explain texts carry the same verdict), the reference with ``jit=True``: on
this CPU backend its eager mode compiles every op on first use and takes
about 3.5 times as long for the same queries. Every test starts and ends
with both packages' plan caches empty (``isolated_plan_caches``).
"""
import warnings
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import repro.api as JA
import repro.data.synthetic as JS
import repro.plan as JP
import repro.plan.ir as JIR
import repro.query as JQ
import repro.relalg as JR
import repro_torch.api as TA
import repro_torch.api.engine as TENG
import repro_torch.data.synthetic as TS
import repro_torch.plan as TP
import repro_torch.plan.ir as TIR
import repro_torch.query as TQ
import repro_torch.relalg as TR
from repro_torch.relalg import count_transfers
from repro_torch.relalg.ops import hash_dedup_counts, \
    reset_hash_dedup_counts
from test_query import bgp_oracle
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

CFG = dict(engine="sdm", dedup="hash")
QUERY_COUNTERS = ("executions", "cache_hits", "cache_misses", "recompiles",
                  "last_cache_hit")


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def make_dis(kind, n, seed):
    if kind == "group_a":
        return (JS.make_group_a_dis(n, 0.5, seed=seed),
                TS.make_group_a_dis(n, 0.5, seed=seed, device="cpu"))
    return (JS.make_group_b_dis(n, 0.6, seed=seed),
            TS.make_group_b_dis(n, 0.6, seed=seed, device="cpu"))


def make_sessions(kind, n, seed, **cfg):
    jdis, tdis = make_dis(kind, n, seed)
    je = JA.KGEngine(jdis, config=JA.EngineConfig(**CFG, **cfg))
    te = TA.KGEngine(tdis, config=TA.EngineConfig(**CFG, **cfg),
                     device="cpu")
    jkg, _ = je.create_kg()
    tkg, _ = te.create_kg()
    np.testing.assert_array_equal(jkg.to_codes(), tkg.to_codes())
    return je, te, jkg, tkg


_SESSIONS = {}


def session(kind):
    """One session pair per DIS kind for the whole file: group B at 48
    rows (``test_query.py``'s DIS), group A at 64."""
    if kind not in _SESSIONS:
        n = 48 if kind == "group_b" else 64
        _SESSIONS[kind] = make_sessions(kind, n, 1)
    return _SESSIONS[kind]


def named_queries(pkg, codes):
    """The named cases, built from the KG's own codes with either
    package's spec types (``pkg`` is ``JA`` or ``TA``)."""
    Q, P, F = pkg.Query, pkg.TriplePattern, pkg.QueryFilter
    row = codes[0]
    mid = codes[len(codes) // 2]
    s0, p0 = (int(row[0]), int(row[1])), int(row[2])
    o0 = (int(row[3]), int(row[4]))
    spo = P("?s", "?p", "?o")
    hop = P("?o", "?p2", "?o2")
    return {
        "scan_1pat": Q(patterns=[spo]),
        "join_2hop": Q(patterns=[spo, hop]),
        "pred_eq_project": Q(patterns=[spo], filters=[F("?p", "eq", p0)],
                             project=("?s",)),
        "term_neq": Q(patterns=[spo], filters=[F("?o", "neq", o0)]),
        "pred_neq": Q(patterns=[spo], filters=[F("?p", "neq", p0)]),
        "join_filter_project": Q(patterns=[spo, hop],
                                 filters=[F("?p", "eq", p0)],
                                 project=("?s", "?o2")),
        "repeated_var": Q(patterns=[P("?x", "?p", "?x")]),
        "subject_const": Q(patterns=[P((int(mid[0]), int(mid[1])), "?p",
                                       "?o")]),
        "shared_pred": Q(patterns=[spo, P("?o", "?p", "?o2")]),
        "chain_3": Q(patterns=[P("?a", "?p", "?b"), P("?b", "?q", "?c"),
                               P("?c", "?r", "?d")]),
        "exists_hit": Q(patterns=[P(s0, p0, o0)]),
        "exists_miss": Q(patterns=[P(s0, 987654, o0)]),
    }


QUERY_NAMES = tuple(named_queries(TA, np.zeros((1, 5), np.int32)))


def pair(kind, name):
    je, te, jkg, tkg = session(kind)
    codes = np.asarray(jkg.to_codes())
    return (named_queries(JA, codes)[name], named_queries(TA, codes)[name])


def answer_rows(res):
    codes = np.asarray(res.to_codes())
    return (np.unique(codes, axis=0) if len(codes)
            else np.zeros((0, len(res.attrs)), np.int32))


def same_answer(jres, tres, kg, tq):
    np.testing.assert_array_equal(jres.to_codes(), tres.to_codes())
    assert tuple(jres.attrs) == tuple(tres.attrs) == tq.answer_attrs()
    np.testing.assert_array_equal(answer_rows(tres), bgp_oracle(kg, tq))
    # δ root: the answer is duplicate-free
    assert len(answer_rows(tres)) == int(tres.count)


def same_query_stats(je, te):
    js, ts = je.stats()["query"], te.stats()["query"]
    for key in QUERY_COUNTERS:
        assert js.get(key) == ts.get(key), key
    assert js["store_hits"] == js["store_misses"] == 0


# ---------------------------------------------------------------------------
# spec and lowering: the same named errors
# ---------------------------------------------------------------------------

SPEC_ERRORS = {
    "bad_var": lambda m: m.TriplePattern("?1bad", "?p", "?o"),
    "rename_suffix": lambda m: m.TriplePattern("?r_x", "?p", "?o"),
    "bad_term": lambda m: m.TriplePattern((1,), "?p", "?o"),
    "bad_pred_tuple": lambda m: m.TriplePattern("?s", (1, 2), "?o"),
    "bad_pred_bool": lambda m: m.TriplePattern("?s", True, "?o"),
    "empty_query": lambda m: m.Query(patterns=[]),
    "mixed_kinds": lambda m: m.Query(
        patterns=[m.TriplePattern("?x", "?x", "?o")]),
    "unknown_filter_var": lambda m: m.Query(
        patterns=[m.TriplePattern("?s", "?p", "?o")],
        filters=[m.QueryFilter("?zzz", "eq", (1, 2))]),
    "pred_filter_term": lambda m: m.Query(
        patterns=[m.TriplePattern("?s", "?p", "?o")],
        filters=[m.QueryFilter("?p", "eq", (1, 2))]),
    "term_filter_code": lambda m: m.Query(
        patterns=[m.TriplePattern("?s", "?p", "?o")],
        filters=[m.QueryFilter("?s", "eq", 3)]),
    "bad_filter_op": lambda m: m.QueryFilter("?s", "lt", (1, 2)),
    "empty_projection": lambda m: m.Query(
        patterns=[m.TriplePattern("?s", "?p", "?o")], project=()),
    "unbound_projection": lambda m: m.Query(
        patterns=[m.TriplePattern("?s", "?p", "?o")], project=("?q",)),
    "duplicate_projection": lambda m: m.Query(
        patterns=[m.TriplePattern("?s", "?p", "?o")],
        project=("?s", "?s")),
    "disconnected_vars": lambda m: m.lower_query(m.Query(
        patterns=[m.TriplePattern("?a", "?p", "?b"),
                  m.TriplePattern("?x", "?q", "?y")])),
    "disconnected_constants": lambda m: m.lower_query(m.Query(
        patterns=[m.TriplePattern((0, 1), 2, (0, 3)),
                  m.TriplePattern((0, 1), 2, (0, 4))])),
    "disconnected_mixed": lambda m: m.lower_query(m.Query(
        patterns=[m.TriplePattern("?a", "?p", "?b"),
                  m.TriplePattern((0, 1), 2, (0, 3))])),
}


@pytest.mark.parametrize("case", sorted(SPEC_ERRORS))
def test_spec_and_lowering_errors_match_reference(case):
    errors = []
    for mod in (JQ, TQ):
        with pytest.raises(ValueError) as info:
            SPEC_ERRORS[case](mod)
        errors.append(str(info.value))
    assert errors[0] == errors[1]


def test_lowering_shape():
    q = TQ.Query(patterns=[TQ.TriplePattern("?s", "?p", "?o"),
                           TQ.TriplePattern("?o", "?p2", "?o2")])
    plan = TQ.lower_query(q)
    assert isinstance(plan.root, TIR.Distinct)    # always SELECT DISTINCT
    scans = [n for n in TIR.iter_nodes(plan.root)
             if isinstance(n, TIR.Scan)]
    assert len(set(map(id, scans))) == 1          # hash-consed: one Scan
    assert scans[0].source == TQ.KG_SOURCE == JQ.KG_SOURCE
    assert TQ.query_scan(plan) is scans[0]
    assert plan.out_attrs == q.answer_attrs()
    assert plan.emits() == [plan.root]


# ---------------------------------------------------------------------------
# fingerprints, keys, annotation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", QUERY_NAMES)
def test_fingerprints_and_keys_match_reference(name):
    jq, tq = pair("group_b", name)
    assert tq.fingerprint() == jq.fingerprint()
    assert tq.answer_attrs() == jq.answer_attrs()
    for jit in (True, False):
        kw = dict(dedup="hash", mode="exact", slack=1.5, jit=jit,
                  kg_bucket_cap=64)
        assert TQ.query_session_key(tq, **kw) == \
            JQ.query_session_key(jq, **kw)
    jplan, tplan = JQ.lower_query(jq), TQ.lower_query(tq)
    assert TIR.fingerprint([tplan.root]) == JIR.fingerprint([jplan.root])
    assert tplan.out_attrs == jplan.out_attrs
    assert [type(n).__name__ for n in TIR.node_order(tplan.emits())] == \
        [type(n).__name__ for n in JIR.node_order(jplan.emits())]


@pytest.mark.parametrize("mode", ["exact", "bound"])
@pytest.mark.parametrize("name", QUERY_NAMES)
def test_annotate_query_matches_reference(name, mode):
    je, te, _, _ = session("group_b")
    jq, tq = pair("group_b", name)
    jplan, tplan = JQ.lower_query(jq), TQ.lower_query(tq)
    jkg, tkg = je._kg_table(None), te._kg_table(None)
    assert jkg.capacity == tkg.capacity
    jc, jcaps = JQ.annotate_query(jplan, {JQ.KG_SOURCE: jkg}, mode=mode,
                                  slack=1.5, cap_fn=JR.bucket_cap)
    tc, tcaps = TQ.annotate_query(tplan, {TQ.KG_SOURCE: tkg}, mode=mode,
                                  slack=1.5, cap_fn=TR.bucket_cap)
    jorder = JIR.node_order([jplan.root])
    torder = TIR.node_order([tplan.root])
    assert [jc[n] for n in jorder] == [tc[n] for n in torder]
    assert [jcaps[n] for n in jorder] == [tcaps[n] for n in torder]


def test_creation_annotation_still_counts_joins_by_total():
    """With ``_eval_rows`` now materializing ⋈ rows for query DAGs, the
    creation path's counts stay the reference's: a join node still counts
    its match total, and every other node its rows."""
    je, te, _, _ = session("group_b")
    jc, jcaps = JP.annotate(je.plan)
    tc, tcaps = TP.annotate(te.plan)
    jorder = JIR.node_order(je.plan.emits())
    torder = TIR.node_order(te.plan.emits())
    assert any(isinstance(n, TIR.EquiJoin) for n in tc)
    assert [jc.get(n) for n in jorder] == [tc.get(n) for n in torder]
    assert [jcaps.get(n) for n in jorder] == [tcaps.get(n) for n in torder]


# ---------------------------------------------------------------------------
# the engine: answers, explain, counters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", QUERY_NAMES)
@pytest.mark.parametrize("kind", ["group_b", "group_a"])
def test_query_answers_and_explain_match_reference(kind, name):
    je, te, jkg, tkg = session(kind)
    jq, tq = pair(kind, name)
    same_answer(je.query(jq), te.query(tq), tkg, tq)
    same_answer(je.query(jq), te.query(tq), tkg, tq)    # warm: cache hit
    assert te.stats()["query"]["last_cache_hit"]
    same_query_stats(je, te)
    assert te.explain_query(tq) == je.explain_query(jq)


def _seeded_bgp(pkg, codes, seed):
    """A connected chain BGP drawn from a numpy seed, shaped like
    ``test_query_properties.py::bgps``: pattern i = (?v{i}, p_i,
    ?v{i+1}); the free ends and every predicate may become constants
    drawn from the KG (or off-KG codes for empty branches), then up to
    two eq/neq filters and a projection."""
    rng = np.random.default_rng(seed)
    Q, P, F = pkg.Query, pkg.TriplePattern, pkg.QueryFilter

    def term(pos, bogus):
        if bogus:
            return (999_983, 999_979)
        row = codes[rng.integers(len(codes))]
        cols = (0, 1) if pos == "s" else (3, 4)
        return (int(row[cols[0]]), int(row[cols[1]]))

    def pred(bogus):
        return 999_989 if bogus else int(codes[rng.integers(len(codes))][2])

    n = int(rng.integers(1, 4))
    tv = [f"?v{i}" for i in range(n + 1)]
    pats = []
    for i in range(n):
        s, o = tv[i], tv[i + 1]
        if i == 0 and rng.random() < 0.5:
            s = term("s", rng.integers(10) == 0)
        if i == n - 1 and n > 1 and rng.random() < 0.5:
            o = term("o", rng.integers(10) == 0)
        kind = ("var", "shared_var", "const")[rng.integers(3)]
        p = {"var": f"?p{i}", "shared_var": "?p0"}.get(kind) \
            or pred(rng.integers(10) == 0)
        pats.append(P(s, p, o))
    kinds = Q(patterns=pats).var_kinds()
    names = sorted(kinds)
    filters = []
    for _ in range(int(rng.integers(3)) if names else 0):
        name = names[rng.integers(len(names))]
        op = ("eq", "neq")[rng.integers(2)]
        bogus = rng.integers(10) == 0
        filters.append(F(f"?{name}", op, pred(bogus)
                         if kinds[name] == "pred" else term("o", bogus)))
    project = None
    if names and rng.random() < 0.5:
        k = int(rng.integers(1, len(names) + 1))
        project = tuple(f"?{v}" for v in rng.permutation(names)[:k])
    return Q(patterns=pats, filters=tuple(filters), project=project)


@pytest.mark.parametrize("seed", range(25))
def test_random_bgp_matches_oracle(seed):
    """The port's answer to a random BGP equals the oracle's row set (the
    reference's own property test holds it the same way; the named cases
    above hold the row order to the reference's)."""
    if "bgp" not in _SESSIONS:
        _SESSIONS["bgp"] = make_sessions("group_b", 64, 11)
    _, te, _, tkg = _SESSIONS["bgp"]
    codes = np.asarray(tkg.to_codes())
    tq = _seeded_bgp(TA, codes, seed)
    assert tq.fingerprint() == _seeded_bgp(JA, codes, seed).fingerprint()
    res = te.query(tq)
    assert res.attrs == tq.answer_attrs()
    np.testing.assert_array_equal(answer_rows(res), bgp_oracle(tkg, tq))
    assert len(answer_rows(res)) == int(res.count)


@pytest.mark.parametrize("crossing", [False, True])
def test_query_after_ingest_matches_reference(crossing):
    """Re-querying after ``ingest`` answers over the new KG: an ingest
    inside the capacity buckets, or one that crosses them."""
    je, te, jkg, tkg = make_sessions("group_b", 24, 3)
    q = {m: m.Query(patterns=[m.TriplePattern("?s", "?p", "?o"),
                              m.TriplePattern("?o", "?p2", "?o2")])
         for m in (JA, TA)}
    same_answer(je.query(q[JA]), te.query(q[TA]), tkg, q[TA])
    if crossing:
        ext = JS.make_group_b_dis(96, 0.6, seed=9)
        recs = ext.sources["gene"].to_records(ext.vocab)
    else:   # repeats of seed rows: no new entity, no new bucket
        recs = je.sources["gene"].to_records(je.vocab)[:2]
    attrs = je.sources["gene"].attrs
    jkg2, _ = je.ingest({"gene": JR.Table.from_records(recs, attrs,
                                                       je.vocab)})
    tkg2, _ = te.ingest({"gene": TR.Table.from_records(recs, attrs,
                                                       te.vocab,
                                                       device="cpu")})
    np.testing.assert_array_equal(jkg2.to_codes(), tkg2.to_codes())
    assert te.stats()["recompiles"] == je.stats()["recompiles"] == \
        int(crossing)
    same_answer(je.query(q[JA]), te.query(q[TA]), tkg2, q[TA])
    same_query_stats(je, te)


def test_explicit_kg_argument_matches_reference():
    je, te, jkg, tkg = session("group_b")
    jq, tq = pair("group_b", "join_2hop")
    # the KG of another DIS, in the session's vocab only by chance: the
    # point is the override path, answered over the table given
    _, _, jkg2, tkg2 = make_sessions("group_b", 24, 3)
    same_answer(je.query(jq, kg=jkg2), te.query(tq, kg=tkg2), tkg2, tq)
    assert te.explain_query(tq, kg=tkg2) == je.explain_query(jq, kg=jkg2)
    with pytest.raises(ValueError, match="coded KG table"):
        te.query(tq, kg=te.sources["gene"])


# ---------------------------------------------------------------------------
# the query plan-cache tier
# ---------------------------------------------------------------------------

def test_repeat_query_is_a_cache_hit_with_the_same_closure():
    je, te, jkg, tkg = make_sessions("group_b", 48, 1)
    q = {m: m.Query(patterns=[m.TriplePattern("?s", "?p", "?o"),
                              m.TriplePattern("?o", "?p2", "?o2")])
         for m in (JA, TA)}
    same_answer(je.query(q[JA]), te.query(q[TA]), tkg, q[TA])
    fn1 = te._q_last["entry"].fn
    builds = te.builds
    # a structurally identical (but distinct) Query object: same key
    q2 = TA.Query(patterns=[TA.TriplePattern("?s", "?p", "?o"),
                            TA.TriplePattern("?o", "?p2", "?o2")])
    same_answer(je.query(q[JA]), te.query(q2), tkg, q2)
    st = te.stats()["query"]
    assert st["cache_hits"] == 1 and st["cache_misses"] == 1
    assert st["recompiles"] == 0 and st["last_cache_hit"]
    assert te._q_last["entry"].fn is fn1 and te.builds == builds
    same_query_stats(je, te)


@pytest.mark.parametrize("seeds,recompiles", [((5, 5), 0),
                                              ((1, 7), 1)])
def test_cross_session_cache_hit_matches_reference(seeds, recompiles):
    """A second session whose KG lands in the same capacity bucket hits
    the first session's entry. The key holds no data, so when the second
    KG needs more rows at some node than the entry's caps, the hit costs
    one exact recompile (ROADMAP.md Queue 3): the count the reference
    gives is pinned here."""
    q = {m: m.Query(patterns=[m.TriplePattern("?s", "?p", "?o"),
                              m.TriplePattern("?o", "?p2", "?o2")])
         for m in (JA, TA)}
    sizes = (48, 48) if seeds == (5, 5) else (32, 40)
    je1, te1, _, tkg1 = make_sessions("group_b", sizes[0], seeds[0])
    same_answer(je1.query(q[JA]), te1.query(q[TA]), tkg1, q[TA])
    je2, te2, _, tkg2 = make_sessions("group_b", sizes[1], seeds[1])
    same_answer(je2.query(q[JA]), te2.query(q[TA]), tkg2, q[TA])
    same_query_stats(je2, te2)
    st = te2.stats()["query"]
    assert st["cache_hits"] == 1 and st["recompiles"] == recompiles
    assert st["last_cache_hit"] == (recompiles == 0)


@pytest.mark.parametrize("name", ["scan_1pat", "join_2hop", "term_neq"])
def test_cached_query_host_reads(name):
    """A cached query reads the host exactly once for its overflow flag
    plus once per hash δ call (ROADMAP.md Queue 3)."""
    _, te, _, _ = session("group_b")
    _, tq = pair("group_b", name)
    cold = te.query(tq)
    reset_hash_dedup_counts()
    with count_transfers() as ledger:
        warm = te.query(tq)
    calls = sum(hash_dedup_counts()["calls"].values())
    assert calls >= 1
    assert ledger.device_to_host == 1 + calls
    assert te.stats()["query"]["last_cache_hit"]
    np.testing.assert_array_equal(cold.to_codes(), warm.to_codes())


# ---------------------------------------------------------------------------
# the reference's KGEngine keyword surface
# ---------------------------------------------------------------------------

def _deprecations(caught):
    return [w for w in caught if issubclass(w.category, DeprecationWarning)]


def test_legacy_kwargs_warn_once_and_exclude_config():
    _, tdis = make_dis("group_b", 16, 0)
    TENG._WARNED_LEGACY.clear()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        TA.KGEngine(tdis, engine="sdm", dedup="hash", device="cpu")
    assert _deprecations(w)
    with warnings.catch_warnings(record=True) as w:   # once per combination
        warnings.simplefilter("always")
        TA.KGEngine(tdis, engine="sdm", dedup="hash", device="cpu")
    assert not _deprecations(w)
    with warnings.catch_warnings(record=True) as w:   # a new combination
        warnings.simplefilter("always")
        TA.KGEngine(tdis, "sdm", "hash", jit=False, device="cpu")
    assert _deprecations(w)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        TA.KGEngine(tdis, device="cpu")
        TA.KGEngine(tdis, config=TA.EngineConfig(engine="rmlmapper"),
                    device="cpu")
    assert not _deprecations(w)
    with pytest.raises(ValueError, match="not both"):
        TA.KGEngine(tdis, engine="sdm", config=TA.EngineConfig(),
                    device="cpu")
    with pytest.raises(TypeError, match="EngineConfig"):
        TA.KGEngine(tdis, config={"engine": "sdm"}, device="cpu")


def test_legacy_kwargs_validate_before_planning():
    _, tdis = make_dis("group_b", 16, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="unknown dedup strategy"):
            TA.KGEngine(tdis, dedup="bloom", device="cpu")
        with pytest.raises(ValueError, match="bad slack"):
            TA.KGEngine(tdis, slack=-1, device="cpu")


def test_config_is_the_cache_key_input_with_jit():
    _, tdis = make_dis("group_b", 16, 0)

    def key(**cfg):
        eng = TA.KGEngine(tdis, config=TA.EngineConfig(**cfg), device="cpu")
        return eng._key(eng.sources)

    assert key(**CFG) == key(**CFG)
    assert key(engine="sdm", dedup="lex") != key(**CFG)
    assert key(**CFG, jit=False) != key(**CFG)
    for jit in (True, False):
        cfg = dict(CFG, mode="bound", slack=2, jit=jit)
        assert TA.EngineConfig(**cfg).cache_sig() == \
            JA.EngineConfig(**cfg).cache_sig()
        assert TA.EngineConfig(**cfg).cache_sig()[-1] is jit


def test_positional_engine_and_dedup_match_reference():
    """``KGEngine(dis, "sdm", "hash", optimize=False).run()``, as
    ``test_core_mapsdi.py`` calls it, and ``engine(...)`` = ``.run(...)``."""
    jdis, tdis = make_dis("group_b", 64, 21)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jkg, jraw = JA.KGEngine(jdis, "sdm", "hash", optimize=False).run()
        te = TA.KGEngine(tdis, "sdm", "hash", optimize=False, device="cpu")
    tkg, traw = te.run()
    np.testing.assert_array_equal(jkg.to_codes(), tkg.to_codes())
    assert int(jraw) == int(traw)
    ckg, craw = te()
    np.testing.assert_array_equal(ckg.to_codes(), tkg.to_codes())
    assert int(craw) == int(traw)
    assert TA.KGEngine.__call__ is TA.KGEngine.run


@pytest.mark.parametrize("name,value,item", [
    ("mesh", object(), 4), ("mesh_axis", "model", 4),
    ("join_exchange", "repartition", 4), ("calibrate", True, 4),
    ("plan_store", "default", 5)])
def test_not_ported_keywords_raise(name, value, item, tmp_path,
                                   monkeypatch):
    """The keywords the port took over from later slices behave as the
    reference's. The mesh keywords (Queue 1 item 4): a mesh whose axes
    lack ``mesh_axis`` raises ``ValueError`` in both packages, and
    ``join_exchange`` / ``calibrate`` without a mesh are accepted and
    ignored. ``plan_store`` (item 5, ported): ``"default"`` is accepted
    by both, each package's default store root (pointed at a temporary
    directory here) gets its first miss and its entry, and the KGs
    agree."""
    monkeypatch.setenv("REPRO_PLAN_STORE", str(tmp_path / "reference"))
    monkeypatch.setenv("REPRO_TORCH_PLAN_STORE", str(tmp_path / "port"))
    jdis, tdis = make_dis("group_b", 16, 0)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if name in ("mesh", "mesh_axis"):
            kw = ({name: value} if name == "mesh" else
                  {"mesh": SimpleNamespace(shape={"data": 1}),
                   "mesh_axis": value})
            for pkg, dis, extra in ((JA, jdis, {}),
                                    (TA, tdis, {"device": "cpu"})):
                with pytest.raises(ValueError, match="mesh_axis"):
                    pkg.KGEngine(dis, **kw, **extra)
            return
        jeng = JA.KGEngine(jdis, verify="off", **{name: value})
        eng = TA.KGEngine(tdis, device="cpu", **{name: value})
    assert eng.config == TA.EngineConfig(**{name: value})
    jkg, jst = jeng.create_kg()
    tkg, tst = eng.create_kg()
    np.testing.assert_array_equal(tkg.to_codes(), jkg.to_codes())
    assert tst["raw_triples"] == jst["raw_triples"]
    for key in ("cost_model", "calibration", "join_exchange", "store_hits",
                "store_misses", "store_rejects"):
        assert eng.stats()[key] == jeng.stats()[key]
    if name == "plan_store":
        assert tst["store_misses"] == jst["store_misses"] == 1
        assert eng.stats()["plan_store"]["root"] == str(tmp_path / "port")
        assert eng.stats()["plan_store"]["writes"] == 1
    assert eng.calibration is None and eng.stats()["mesh"] is None
