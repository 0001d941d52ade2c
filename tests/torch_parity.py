"""Shared helpers of the port's tests.

:func:`isolated_plan_caches` keeps every ``test_torch_*.py`` test out of
the reference's process-wide plan cache. The rest serves the engine parity
tests (``test_torch_engine.py``, ``test_torch_ingest.py``): the same DIS,
the same extension rows and the same session configuration handed to
``repro.api.KGEngine`` and ``repro_torch.api.KGEngine`` on the CPU, and an
exact comparison of what one step returns. The language-model tests
share the logit tolerances below and the greedy-decoding comparison."""
import contextlib
from collections import OrderedDict

import numpy as np

import repro.api as JA
import repro.core as JC
import repro.data.synthetic as JS
import repro.relalg as JR
import repro_torch.api as TA
import repro_torch.core as TC
import repro_torch.data.synthetic as TS
import repro_torch.relalg as TR

# Logit tolerances of the language-model parity tests, with reasons:
# * float32 weights (no bf16 rounding anywhere): logits to 5e-4 absolute
#   (magnitude ~2; float32 summation order and exp/tanh/log in each of 4
#   layers; 1e-4 measured);
# * bf16 weights, the models' own dtype: the port rounds every op to bf16
#   as the reference's semantics say, while the reference's CPU backend
#   keeps fused elementwise chains in float32. Logits agree to 3% of their
#   RMS in RMS and to 8% of their largest magnitude at worst; the loss to
#   2e-3.
F32_LOGIT_ATOL = 5e-4
BF16_RMS_FRAC, BF16_MAX_FRAC, LOSS_ATOL = 0.03, 0.08, 2e-3


@contextlib.contextmanager
def isolated_plan_caches():
    """Both plan caches empty for the duration; afterwards the reference's
    cache is put back as it was (entries, their order, hit and miss
    counts). The xdist workers run the reference's tests in the same
    process, after these, and some of them count cache misses and
    recompiles: they must find the cache as if the port's test had not
    run, neither holding its entries nor emptied by it."""
    cache = JA.PLAN_CACHE
    saved = (OrderedDict(cache._entries), cache.hits, cache.misses)
    JA.clear_plan_cache()
    TA.clear_plan_cache()
    try:
        yield
    finally:
        JA.clear_plan_cache()
        TA.clear_plan_cache()
        cache._entries.update(saved[0])
        cache.hits, cache.misses = saved[1], saved[2]


def gene_spec(records=None):
    recs, attrs = JS.fig4_gene_source()
    return {"sources": {"genes": {"attrs": attrs,
                                  "records": recs if records is None
                                  else records}},
            "maps": [JS.FIG3_MAP]}


def dises(kind):
    if kind == "fig4":
        return JC.parse_dis(gene_spec()), TC.parse_dis(gene_spec(),
                                                        device="cpu")
    if kind == "group_a":
        return (JS.make_group_a_dis(40, 0.5, seed=3),
                TS.make_group_a_dis(40, 0.5, seed=3, device="cpu"))
    return (JS.make_group_b_dis(48, 0.6, seed=2),
            TS.make_group_b_dis(48, 0.6, seed=2, device="cpu"))


def extension_records(kind, factor, seed, limit=None):
    """{source: records} of new rows, drawn like the seed data (at most
    ``limit`` rows per source)."""
    if kind == "fig4":
        recs, _ = JS.fig4_gene_source()
        if limit is not None:   # repeats of seed rows: no new entities
            return {"genes": recs[:limit]}
        out = []
        for r in range(factor):
            for rec in recs:
                rec = dict(rec)
                rec["ID"] = 100 * (r + 1) + rec["ID"]
                rec["ENSG"] = rec["ENSG"][:-1] + str((r + seed) % 10)
                out.append(rec)
        return {"genes": out}
    ext = (JS.make_group_a_dis(40 * factor, 0.5, seed=seed)
           if kind == "group_a" else
           JS.make_group_b_dis(48 * factor, 0.6, seed=seed))
    return {name: t.to_records(ext.vocab)[:limit]
            for name, t in ext.sources.items()}


def sessions(jdis, tdis, engine, dedup):
    cfg = dict(engine=engine, dedup=dedup)
    je = JA.KGEngine(jdis, config=JA.EngineConfig(**cfg, verify="off"))
    te = TA.KGEngine(tdis, config=TA.EngineConfig(**cfg), device="cpu")
    return je, te


def deltas(je, te, records):
    jd, td = {}, {}
    for name, recs in records.items():
        attrs = je.sources[name].attrs
        jd[name] = JR.Table.from_records(recs, attrs, je.vocab)
        td[name] = TR.Table.from_records(recs, attrs, te.vocab,
                                         device="cpu")
    assert je.vocab._to_value == te.vocab._to_value
    return jd, td


def same_step(jout, tout):
    (jkg, js), (tkg, ts) = jout, tout
    np.testing.assert_array_equal(jkg.to_codes(), tkg.to_codes())
    for key in ("raw_triples", "kg_triples", "recompiles", "plan_cache_hit",
                "plan_cache_hits", "plan_cache_misses", "source_rows_before",
                "source_rows_after", "rule1", "rule2", "rule3", "sigma",
                "cse_shared"):
        assert js[key] == ts[key], key


def rms(a) -> float:
    return float(np.sqrt(np.mean(np.square(a))))


def assert_bf16_logits_close(got, want, what=""):
    """bf16 logits within the RMS and largest-magnitude fractions."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    assert rms(got - want) <= BF16_RMS_FRAC * rms(want), what
    assert np.abs(got - want).max() <= BF16_MAX_FRAC * np.abs(want).max(), \
        what


def agreeing_prefix(ref_logits, atol):
    """Greedy steps whose tokens must agree: every step up to the first
    one where the reference's top-2 logit margin, in some batch row, is
    under ``atol`` (there a port within tolerance may pick the other
    token, and the continuations part). ``ref_logits`` [steps, B, V]."""
    top2 = np.sort(np.asarray(ref_logits, np.float32), axis=-1)[..., -2:]
    margin = (top2[..., 1] - top2[..., 0]).min(axis=-1)
    near = np.flatnonzero(margin < atol)
    return int(near[0]) if near.size else len(margin)
