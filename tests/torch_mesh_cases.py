"""Rank bodies of ``test_torch_mesh_ranks.py``.

Each function runs in every rank of a group that
``repro_torch.launch.mesh.launch_ranks`` spawned (gloo on the CPU) and
returns plain data (codes, counts, texts) for the parent to check against
the reference. This module imports the port only, so a spawned rank does
not load JAX. Specs, extension records, queries and request streams come
from the parent, built with the reference tests' own helpers; the plan
store's temporary root too.
"""
import os
import shutil

import numpy as np
import torch

import repro_torch.api as TA
import repro_torch.core as TC
import repro_torch.data.synthetic as TS
import repro_torch.serve as TSV
from repro_torch.analysis import (expected_collectives,
                                  expected_query_collectives)
from repro_torch.api.store import (pack_entry_meta, read_container,
                                   store_envelope, store_key,
                                   write_container)
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


def main_cases(mesh, specs, kinds, queries):
    """create_kg for every kind × engine × dedup × strategy, audited; on
    group B's KG also every query (the first one audited, then repeated:
    a plan-cache hit)."""
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
                    case = out[(kind, engine, dedup, strategy)] = {
                        "codes": kg.to_codes(), "raw": st["raw_triples"],
                        "recompiles": st["recompiles"],
                        "audit": _audit(eng),
                        "want_collectives": expected_collectives(
                            entry.plan, engine, mesh.size,
                            entry.exchanges)}
                    if kind == "group_b":
                        case["queries"] = query_run(eng, queries)
    return out


def query_run(eng, queries):
    """Every query once (the session's first query build is audited
    under ``verify="full"``), then the first again."""
    out = {"answers": {}}
    for i, (name, q) in enumerate(queries.items()):
        res = eng.query(q)
        out["answers"][name] = (res.to_codes(), tuple(res.attrs))
        if i == 0:
            entry = eng._q_last["entry"]
            out["audit"] = _audit(eng)
            out["want_collectives"] = expected_query_collectives(
                entry.plan, eng.n_shards, exchanges=entry.exchanges)
    first = next(iter(queries.values()))
    eng.query(first)
    st = eng.stats()
    out["repeat_hit"] = st["query"]["last_cache_hit"]
    out["query_stats"] = st["query"]
    out["mesh"] = st["mesh"]
    return out


def random_query_cases(mesh, queries):
    """The numpy-seeded random BGPs over group B's KG (sdm, hash, auto)."""
    TA.clear_plan_cache()
    eng = _session(TS.make_group_b_dis(64, 0.6, seed=11, device="cpu"),
                   mesh, engine="sdm", dedup="hash")
    kg, _ = eng.create_kg()
    return {"kg": kg.to_codes(),
            "answers": [eng.query(q).to_codes() for q in queries]}


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


def skew_cases(mesh, specs, calibration, ref_queries):
    """The all-rows-one-key and empty-parent DISes under every strategy,
    with the stats and explain() text the reference is held to; the
    queries ``ref_queries[kind]`` over the one-key and group-B KGs, with
    their answers, ``explain_query()`` text, query counters, exchanges
    and the entries' store metadata."""
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
                case = out[(kind, engine, strategy)] = {
                    "codes": kg.to_codes(), "raw": st["raw_triples"],
                    "recompiles": st["recompiles"],
                    "explain": eng.explain(),
                    "stats": {k: stats[k] for k in (
                        "executions", "ingests", "builds", "recompiles",
                        "plan_cache_hits", "plan_cache_misses",
                        "cost_model")}}
                if kind in ref_queries and engine == "sdm":
                    case["query"] = query_record(eng, ref_queries[kind])
    return out


def query_record(eng, q):
    """One query's answer, ``explain_query()`` text (after the run, as
    the reference's harness reads it), counters, exchanges, and the store
    metadata of the KG entry and of the query entry."""
    res = eng.query(q)
    st = eng.stats()["query"]
    entry = eng._q_last["entry"]
    return {"codes": res.to_codes(), "explain": eng.explain_query(q),
            "stats": {k: st[k] for k in (
                "executions", "cache_hits", "cache_misses", "recompiles",
                "store_hits", "store_misses", "store_rejects")},
            "exchanges": [x.strategy for x in entry.exchanges.values()],
            "kg_meta": _meta(eng._last["entry"]),
            "query_meta": _meta(entry)}


def _meta(entry):
    """``pack_entry_meta`` without the build time."""
    meta = pack_entry_meta(entry, entry.plan)
    meta.pop("build_seconds")
    return meta


def store_cases(mesh, root, query):
    """The plan store on a mesh: a writer fills ``root``, a reader hits
    on every rank; the last rank then reads a copy of the root whose
    entries' caps are damaged, and every rank builds; a one-device
    session and a mesh session never adopt each other's entries."""
    rank, n = mesh.rank, mesh.size
    out = {}

    def session(store, **cfg):
        return _session(TS.make_group_b_dis(48, 0.6, seed=2, device="cpu"),
                        mesh, engine="sdm", dedup="hash", plan_store=store,
                        **cfg)

    def step(eng):
        kg, st = eng.create_kg()
        ans = eng.query(query)
        est = eng.stats()
        return {"codes": kg.to_codes(), "answer": ans.to_codes(),
                "kg_store": {k: st[k] for k in (
                    "store_hits", "store_misses", "store_rejects")},
                "query_store": {k: est["query"][k] for k in (
                    "store_hits", "store_misses", "store_rejects")},
                "builds": eng.builds, "store_checks":
                    est["verify"]["store_checks"],
                "origins": (eng._last["entry"].origin,
                            eng._q_last["entry"].origin)}

    TA.clear_plan_cache()
    writer = session(root)
    out["writer"] = step(writer)
    env = store_envelope("cpu")
    out["keys"] = [store_key(writer._store_session_key(e.key), env)
                   for e in (writer._last["entry"], writer._q_last["entry"])]
    out["entries"] = len(TA.PlanStore(root))
    TA.clear_plan_cache()
    out["reader"] = step(session(root))
    view = root
    if rank == n - 1:       # this rank's view of the store is damaged
        view = f"{root}_damaged"
        shutil.copytree(root, view)
        for name in os.listdir(view):
            if name.endswith(".plan"):
                path = os.path.join(view, name)
                header, payloads = read_container(path)
                header["meta"]["caps"] = [[i, -1] for i, _ in
                                          header["meta"]["caps"]]
                header.pop("payloads")
                write_container(path, header, payloads)
    TA.clear_plan_cache()
    out["damaged"] = step(session(view))
    # one-device and mesh entries under one root (this rank's own)
    alone = f"{root}_one_device_{rank}"
    TA.clear_plan_cache()
    one = TA.KGEngine(TS.make_group_b_dis(48, 0.6, seed=2, device="cpu"),
                      config=TA.EngineConfig(engine="sdm", dedup="hash",
                                             plan_store=alone),
                      device="cpu")
    _, st = one.create_kg()
    out["one_device"] = {"store_misses": st["store_misses"]}
    TA.clear_plan_cache()
    _, st = session(alone).create_kg()
    out["mesh_after_one_device"] = {k: st[k] for k in (
        "store_hits", "store_misses", "store_rejects")}
    return out


def front_door_cases(mesh, streams):
    """A mesh front door, leader on rank 0: 4 tenants over 2 shapes fed
    ``streams`` (rounds of per-tenant records) in synchronous mode, then
    in worker mode; then a follower whose encoding fails once."""
    out = {}

    def door(**kw):
        d = TSV.FrontDoor(TA.EngineConfig(engine="sdm", dedup="hash",
                                          mesh=mesh), max_queue=64, **kw)
        for t in range(4):
            d.register(f"t{t}", TS.make_group_b_dis(24, 0.5, seed=40 + t % 2,
                                                    device="cpu"))
        return d

    def finish(d, tickets):
        if d.leader:
            d.stop(drain=True)
            res = [tk.result(timeout=0) for tk in tickets]
            assert all(r.latency_s >= r.ingest_s >= 0 for r in res)
            resolved = all(tk.done() for tk in tickets)
        else:
            d.follow()
            resolved = None
        st = d.serve_stats()
        return {"codes": {f"t{t}": d.kg(f"t{t}").to_codes()
                          for t in range(4)},
                "dedup": d.registry.compile_dedup(),
                "flushes": st["flushes"], "mesh": {
                    k: st["mesh"][k] for k in ("rank", "role", "broken")},
                "resolved": resolved, "tickets": len(tickets)}

    TA.clear_plan_cache()
    d = door(flush_window=0.0)
    tickets = []
    if d.leader:
        for rnd in streams:
            tickets += [d.submit(f"t{t}", recs) for t, recs in
                        enumerate(rnd)]
            d.pump(force=True)
    out["sync"] = finish(d, tickets)
    TA.clear_plan_cache()
    d = door(flush_window=0.01)
    tickets = []
    if d.leader:
        d.start()
        for rnd in streams:
            tickets += [d.submit(f"t{t}", recs) for t, recs in
                        enumerate(rnd)]
    out["worker"] = finish(d, tickets)
    # a follower fails to encode the first flush: every rank skips it, the
    # leader fails its ticket, and the group goes on
    TA.clear_plan_cache()
    d = door(flush_window=0.0)
    if mesh.rank == 1:
        encode, calls = d._encode, []

        def failing(session, merged):
            calls.append(1)
            if len(calls) == 1:
                raise ValueError("rank 1 fails to encode on purpose")
            return encode(session, merged)
        d._encode = failing
    errors = []
    if d.leader:
        first = d.submit("t0", streams[0][0])
        d.pump(force=True)
        second = d.submit("t0", streams[1][0])
        d.pump(force=True)
        try:
            first.result(timeout=0)
        except Exception as e:   # noqa: BLE001 - reported to the parent
            errors.append(f"{type(e).__name__}: {e}")
        errors.append(second.result(timeout=0).kg_triples)
        d.stop(drain=True)
    else:
        d.follow()
    out["fault"] = {"errors": errors, "kg": d.kg("t0").to_codes(),
                    "tenant_errors": d.serve_stats()["per_tenant"]["t0"]
                    ["errors"]}
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


def rank_cases(n, specs, kinds, records, calibration, tables, queries,
               roots, streams):
    """Everything one group of ``n`` ranks runs (the parent spawns one
    group per ``n``). ``queries`` holds the named queries over group B's
    KG (``"named"``), the random ones (``"random"``) and the reference
    queries of the four-rank cases (``"ref"``); ``roots[n]`` is the
    group's plan-store root; ``streams`` the front door's requests."""
    mesh = make_mesh((n,), ("data",), device="cpu")
    res = {"rank": mesh.rank, "backend": mesh.backend,
           "main": main_cases(mesh, specs, kinds, queries["named"]),
           "random": random_query_cases(mesh, queries["random"]),
           "store": store_cases(mesh, roots[n],
                                next(iter(queries["named"].values()))),
           "distinct": distinct_cases(mesh, tables)}
    if n >= 3:
        res["ingest"] = ingest_cases(mesh, specs, records)
    if n == 4:
        res["skew"] = skew_cases(mesh, specs, calibration, queries["ref"])
    if n in (2, 4):
        res["door"] = front_door_cases(mesh, streams)
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
