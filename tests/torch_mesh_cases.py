"""Rank bodies of ``test_torch_mesh_ranks.py``.

Each function runs in every rank of a group that
``repro_torch.launch.mesh.launch_ranks`` spawned (gloo on the CPU) and
returns plain data (codes, counts, texts) for the parent to check against
the reference. This module imports the port only, so a spawned rank does
not load JAX. Specs and extension records come from the parent, built
with the reference tests' own spec helpers.
"""
import numpy as np
import torch

import repro_torch.api as TA
import repro_torch.core as TC
import repro_torch.data.synthetic as TS
from repro_torch.analysis import expected_collectives
from repro_torch.launch.mesh import Calibration, make_mesh
from repro_torch.relalg import Table

STRATEGIES = ("gather", "repartition", "auto")
ENGINES = ("rmlmapper", "sdm")
DEDUPS = ("lex", "hash")


def build_dis(kind, specs):
    if kind == "group_b":
        return TS.make_group_b_dis(48, 0.6, seed=2, device="cpu")
    return TC.parse_dis(specs[kind], device="cpu")


def _session(dis, mesh, **cfg):
    return TA.KGEngine(dis, config=TA.EngineConfig(mesh=mesh, **cfg))


def _audit(eng):
    rep = eng.last_audit
    return {"ok": rep.ok, "collectives": rep.collectives,
            "expected": rep.expected, "host_reads": rep.host_reads,
            "expected_host_reads": rep.expected_host_reads,
            "text": rep.describe()}


def main_cases(mesh, specs, kinds):
    """create_kg for every kind × engine × dedup × strategy, audited."""
    out = {}
    for kind in kinds:
        for engine in ENGINES:
            for dedup in DEDUPS:
                for strategy in STRATEGIES:
                    TA.clear_plan_cache()
                    eng = _session(build_dis(kind, specs), mesh,
                                   engine=engine, dedup=dedup,
                                   join_exchange=strategy, verify="full")
                    kg, st = eng.create_kg()
                    entry = eng._last["entry"]
                    out[(kind, engine, dedup, strategy)] = {
                        "codes": kg.to_codes(), "raw": st["raw_triples"],
                        "recompiles": st["recompiles"],
                        "audit": _audit(eng),
                        "want_collectives": expected_collectives(
                            entry.plan, engine, mesh.size,
                            entry.exchanges)}
    return out


def ingest_cases(mesh, specs, records):
    """create_kg, an ingest inside the buckets, one that crosses them."""
    out = {}
    for engine in ENGINES:
        TA.clear_plan_cache()
        eng = _session(build_dis("group_b", specs), mesh, engine=engine,
                       dedup="hash")
        steps = [eng.create_kg()]
        for recs in records:
            deltas = {name: Table.from_records(r, eng.sources[name].attrs,
                                               eng.vocab, device="cpu")
                      for name, r in recs.items()}
            steps.append(eng.ingest(deltas))
        out[engine] = [{"codes": kg.to_codes(), "raw": st["raw_triples"],
                        "recompiles": st["recompiles"],
                        "hit": st["plan_cache_hit"]} for kg, st in steps]
    return out


def skew_cases(mesh, specs, calibration):
    """The all-rows-one-key and empty-parent DISes under every strategy,
    with the stats and explain() text the reference is held to."""
    cal = Calibration(**calibration)
    out = {}
    for kind in ("one_key", "empty_parent", "group_b"):
        for engine in ENGINES:
            for strategy in ("repartition", "auto"):
                TA.clear_plan_cache()
                eng = _session(build_dis(kind, specs), mesh, engine=engine,
                               dedup="hash", join_exchange=strategy,
                               calibrate=cal)
                kg, st = eng.create_kg()
                stats = eng.stats()
                out[(kind, engine, strategy)] = {
                    "codes": kg.to_codes(), "raw": st["raw_triples"],
                    "recompiles": st["recompiles"],
                    "explain": eng.explain(),
                    "stats": {k: stats[k] for k in (
                        "executions", "ingests", "builds", "recompiles",
                        "plan_cache_hits", "plan_cache_misses",
                        "cost_model")}}
    return out


def distinct_cases(mesh, tables):
    """distributed_distinct_table over coded tables, both δ strategies."""
    from repro_torch.core.distributed import distributed_distinct_table
    out = {}
    for key, codes in tables.items():
        for dedup in DEDUPS:
            table = Table.from_codes(codes, ("a", "b", "c"), device="cpu")
            got, over = distributed_distinct_table(table, mesh, "data",
                                                   dedup=dedup)
            out[(key, dedup)] = (got.to_codes(), over)
    return out


def cache_cases(mesh, specs):
    """A mesh session and a single-device one over the same DIS never
    share a plan-cache entry, whichever runs first."""
    out = []
    for mesh_first in (True, False):
        TA.clear_plan_cache()
        order = [mesh, None] if mesh_first else [None, mesh]
        hits = []
        for m in order:
            eng = (_session(build_dis("group_b", specs), m)
                   if m is not None else TA.KGEngine(
                       build_dis("group_b", specs), device="cpu"))
            _, st = eng.create_kg()
            hits.append(st["plan_cache_hit"])
        out.append({"hits": hits, "entries": len(TA.PLAN_CACHE)})
    return out


def rank_cases(n, specs, kinds, records, calibration, tables):
    """Everything one group of ``n`` ranks runs (the parent spawns one
    group per ``n``)."""
    mesh = make_mesh((n,), ("data",), device="cpu")
    res = {"rank": mesh.rank, "backend": mesh.backend,
           "main": main_cases(mesh, specs, kinds),
           "distinct": distinct_cases(mesh, tables)}
    if n >= 3:
        res["ingest"] = ingest_cases(mesh, specs, records)
    if n == 4:
        res["skew"] = skew_cases(mesh, specs, calibration)
    if n == 2:
        res["cache"] = cache_cases(mesh, specs)
    return res


def failing_rank(n):
    """Rank 1 raises; the others wait in a collective it never joins."""
    import torch.distributed as dist
    mesh = make_mesh((n,), ("data",), device="cpu")
    if mesh.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    x = torch.zeros(4, dtype=torch.int32)
    dist.all_reduce(x)
    return int(x.sum())


def np_rows(codes):
    return np.asarray(codes)[np.lexsort(np.asarray(codes).T[::-1])]
