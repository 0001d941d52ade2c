"""KG serving in the port against the reference, on the CPU.

The multi-tenant front door (``repro_torch.serve``: ``percentile``,
``LatencyWindow``, ``AdmissionController``, ``MicroBatcher``,
``SessionRegistry``, ``FrontDoor``) and the ``kg_serve`` driver, held to
``repro.serve`` and ``repro.launch.kg_serve``:

* the framework-free pieces on numpy-seeded values and one scripted call
  sequence under a fake clock in both packages: outputs, ``Overloaded``
  fields and ``stats()`` exactly equal;
* one ``FrontDoor`` case, 4 tenants over 2 shapes at ``test_serve.py``'s
  sizes, in both packages: every tenant's KG codes bit for bit (tolerance
  0: the path is int32 throughout), ``compile_dedup()``, the
  deterministic fields of ``serve_stats()`` and the partition of tenants
  into shapes (the reference compiles XLA here, so it gets one case);
* the remaining ``tests/test_serve.py`` behaviours on the port alone;
* a one-rank CPU mesh door beside a one-device door (the multi-rank
  mesh doors are in ``test_torch_mesh_ranks.py``);
* ``python -m repro_torch.launch.kg_serve --device cpu`` beside
  ``python -m repro.launch.kg_serve`` with the same flags, on one device
  and with ``--mesh-shards 2`` (2 gloo ranks beside 2 host devices).

Every test starts and ends with both packages' plan caches empty
(``isolated_plan_caches``).
"""
import dataclasses
import os
import re
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import repro.api as JA
import repro.data.synthetic as JS
import repro.serve as JSV
import repro_torch.api as TA
import repro_torch.data.synthetic as TS
import repro_torch.relalg as TR
import repro_torch.serve as TSV
from repro_torch.launch.mesh import make_mesh
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(engine="sdm", dedup="hash")


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _tdis(shape=0, rows=24):
    return TS.make_group_b_dis(rows, 0.5, seed=40 + shape, device="cpu")


def _recs(n=2, seed=0):
    return TS.make_group_b_extension_records(n, seed=seed)


def _door(**kw):
    return TSV.FrontDoor(TA.EngineConfig(**CFG), device="cpu", **kw)


# ---------------------------------------------------------------------------
# framework-free pieces: exactly the reference's
# ---------------------------------------------------------------------------

def test_percentile_and_window_equal_reference():
    rng = np.random.default_rng(0)
    for n in (1, 2, 3, 10, 100, 101, 997):
        vals = rng.exponential(size=n).tolist()
        for q in (0, 25, 50, 75, 90, 99, 99.9, 100):
            assert TSV.percentile(vals, q) == JSV.percentile(vals, q)
    for bad in (([], 50), ([1.0], 101), ([1.0], -1)):
        with pytest.raises(ValueError) as te:
            TSV.percentile(*bad)
        with pytest.raises(ValueError) as je:
            JSV.percentile(*bad)
        assert str(te.value) == str(je.value)
    tw, jw = TSV.LatencyWindow(maxlen=16), JSV.LatencyWindow(maxlen=16)
    assert tw.snapshot() == jw.snapshot()
    for chunk in np.array_split(rng.exponential(size=40), 5):
        tw.extend(chunk.tolist())
        jw.extend(chunk.tolist())
        assert tw.snapshot() == jw.snapshot() and len(tw) == len(jw)


def _script(mod):
    """One call sequence through ``MicroBatcher`` and
    ``AdmissionController`` under a fake clock; every observable output."""
    clock = [0.0]
    tick = lambda: clock[0]  # noqa: E731
    out = []
    b = mod.MicroBatcher(flush_window=1.0, max_batch_rows=3, clock=tick)
    adm = mod.AdmissionController(max_queue=4, storm_queue=1,
                                  stall_window_s=10.0, clock=tick)
    for i, (tenant, rows) in enumerate([("a", 1), ("a", 2), ("b", 5),
                                        ("a", 1), ("b", 1), ("c", 1)]):
        clock[0] = 0.25 * i
        shed = adm.admit(tenant, b.depth())
        out.append(("admit", tenant,
                    None if shed is None else dataclasses.astuple(shed),
                    type(shed).__name__))
        if shed is None:
            recs = {"gene": [{"x": i * 10 + r} for r in range(rows)]}
            out.append(("add", b.add(tenant, recs,
                                     mod.Ticket(tenant, clock[0]))))
        out.append(("depth", b.depth(), b.depth("a"), b.depth("b")))
    out.append(("due", b.due(), b.next_deadline()))
    clock[0] = 1.1
    out.append(("due", b.due(), b.next_deadline()))
    for tid in b.due():
        taken, merged = b.pop_batch(tid)
        out.append(("pop", tid, [r.rows for r in taken], merged))
    adm.note_recompile(2)
    out.append(("storm", adm.in_storm(), adm.stats()))
    for depth in (0, 1, 4):
        shed = adm.admit("c", depth)
        out.append(("admit", depth,
                    None if shed is None else dataclasses.astuple(shed)))
    clock[0] = 20.0
    out.append(("storm", adm.in_storm(), adm.admit("c", 1)))
    out.append(("force", b.due(force=True)))
    out.append(("drain", len(b.drain_tickets()), b.depth()))
    out.append(("stats", adm.stats()))
    for ctor in (lambda: mod.MicroBatcher(flush_window=-1),
                 lambda: mod.MicroBatcher(max_batch_rows=0),
                 lambda: mod.AdmissionController(max_queue=0),
                 lambda: mod.AdmissionController(max_queue=4,
                                                 storm_queue=5)):
        with pytest.raises(ValueError) as err:
            ctor()
        out.append(("error", str(err.value)))
    return out


def test_batcher_and_admission_script_equal_reference():
    got, want = _script(TSV), _script(JSV)
    assert got == want
    assert any(step[0] == "admit" and step[-1] == "Overloaded"
               for step in got)


# ---------------------------------------------------------------------------
# the front door: one case against the reference
# ---------------------------------------------------------------------------

def _serve(pkg, make_dis, tenants=4, shapes=2, rounds=2, **extra):
    door = pkg.FrontDoor(pkg.EngineConfig(**CFG), flush_window=0.0,
                         max_queue=64, **extra)
    for t in range(tenants):
        door.register(f"t{t}", make_dis(t % shapes))
    for rnd in range(rounds):
        tickets = [door.submit(f"t{t}", _recs(2, seed=100 + rnd * tenants
                                              + t))
                   for t in range(tenants)]
        door.pump(force=True)
        results = [tk.result(timeout=600) for tk in tickets]
        assert all(r.latency_s >= r.ingest_s >= 0 for r in results)
    codes = {f"t{t}": door.kg(f"t{t}").to_codes() for t in range(tenants)}
    return door, codes


def _deterministic(st):
    """``serve_stats()`` without the clock's fields and the shape ids."""
    out = {k: v for k, v in st.items()
           if k not in ("latency", "admission", "per_tenant")}
    out["admission"] = {k: v for k, v in st["admission"].items()
                        if k != "in_storm"}
    out["latency"] = {k: st["latency"][k] for k in ("count", "total")}
    out["per_tenant"] = {
        tid: dict({k: v for k, v in per.items()
                   if k not in ("latency", "shape_id")},
                  latency={k: per["latency"][k] for k in ("count", "total")})
        for tid, per in st["per_tenant"].items()}
    return out


def _partition(door):
    groups = {}
    for s in door.registry.sessions():
        groups.setdefault(s.shape_key, set()).add(s.tenant_id)
    return sorted(sorted(g) for g in groups.values())


def test_front_door_equals_reference():
    jdoor, jcodes = _serve(
        JA, lambda shape: JS.make_group_b_dis(24, 0.5, seed=40 + shape))
    tdoor, tcodes = _serve(TA, _tdis, device="cpu")
    for tid, codes in jcodes.items():
        np.testing.assert_array_equal(tcodes[tid], codes)
    assert tdoor.registry.compile_dedup() == jdoor.registry.compile_dedup()
    assert tdoor.registry.compile_dedup()["shapes"] == 2
    assert _deterministic(tdoor.serve_stats()) == \
        _deterministic(jdoor.serve_stats())
    assert _partition(tdoor) == _partition(jdoor) == [["t0", "t2"],
                                                      ["t1", "t3"]]
    assert all(len(s.shape_id) == 12 for s in tdoor.registry.sessions())


# ---------------------------------------------------------------------------
# the rest of test_serve.py's behaviours, on the port
# ---------------------------------------------------------------------------

def test_k_compiles_and_dedicated_session_bit_identity():
    door = _door(flush_window=0.0, max_queue=64)
    tenants, shapes = 4, 2
    for t in range(tenants):
        door.register(f"t{t}", _tdis(shape=t % shapes))
    history = [[] for _ in range(tenants)]
    for rnd in range(2):
        for t in range(tenants):
            recs = _recs(2, seed=300 + rnd * tenants + t)
            history[t].append(recs)
            assert isinstance(door.submit(f"t{t}", recs), TSV.Ticket)
        door.pump(force=True)
    assert door.registry.compile_dedup() == {
        "tenants": tenants, "shapes": shapes, "compiles": shapes,
        "ratio": tenants / shapes}
    for t in range(tenants):
        eng = TA.KGEngine(_tdis(shape=t % shapes),
                          config=TA.EngineConfig(**CFG), device="cpu")
        kg, _ = eng.create_kg()
        for recs in history[t]:
            kg, _ = eng.ingest({
                n: TR.Table.from_records(r, eng.sources[n].attrs, eng.vocab,
                                         device="cpu")
                for n, r in recs.items() if r})
        served = door.kg(f"t{t}")
        assert served.device == torch.device("cpu")
        np.testing.assert_array_equal(served.to_codes(), kg.to_codes())


def test_coalesces_and_reports_stats():
    door = _door(flush_window=0.0, max_queue=64)
    door.register("a", _tdis())
    t1 = door.submit("a", _recs(1, seed=1))
    t2 = door.submit("a", _recs(1, seed=2))
    assert door.pump(force=True) == 1          # ONE flush for both
    r1, r2 = t1.result(timeout=600), t2.result(timeout=600)
    assert r1.batched_requests == r2.batched_requests == 2
    assert r1.flush_id == r2.flush_id
    st = door.serve_stats()
    assert (st["tenants"], st["accepted"], st["completed"], st["rejected"],
            st["flushes"], st["queue_depth"], st["compiles"]) == \
        (1, 2, 2, 0, 1, 0, 1)
    assert st["compile_dedup_ratio"] == 1.0 and st["latency"]["count"] == 2
    per = st["per_tenant"]["a"]
    assert (per["requests"], per["ingests"], per["rows"]) == (2, 1, 4)
    assert per["kg_triples"] > 0 and len(per["shape_id"]) == 12
    assert st["plan_store"] is None
    assert st["plan_store_hits"] == st["plan_store_misses"] == 0


def test_backpressure_no_silent_drops():
    door = _door(flush_window=0.0, max_queue=2, storm_queue=1,
                 stall_window_s=600.0)
    door.register("a", _tdis())
    responses = [door.submit("a", _recs(1, seed=i)) for i in range(4)]
    tickets = [r for r in responses if isinstance(r, TSV.Ticket)]
    sheds = [r for r in responses if isinstance(r, TSV.Overloaded)]
    assert len(tickets) == 2 and len(sheds) == 2
    assert all(s.reason == "queue_full" and not s for s in sheds)
    door.pump(force=True)
    assert all(tk.result(timeout=600).kg_triples > 0 for tk in tickets)
    # bucket-crossing delta -> recompile -> storm window opens
    tk = door.submit("a", _recs(64, seed=9))   # 24-row seed: crosses bucket
    door.pump(force=True)
    assert tk.result(timeout=600).recompiles >= 1
    st = door.serve_stats()
    assert st["recompile_stalls"] >= 1 and st["admission"]["in_storm"]
    ok = door.submit("a", _recs(1, seed=10))     # depth 0 < storm_queue
    storm = door.submit("a", _recs(1, seed=11))  # depth 1 >= storm_queue
    assert isinstance(ok, TSV.Ticket) and isinstance(storm, TSV.Overloaded)
    assert storm.reason == "recompile_storm"
    door.pump(force=True)
    st = door.serve_stats()
    assert st["accepted"] + st["rejected"] == 7   # every submit accounted
    assert st["completed"] == st["accepted"] and st["errors"] == 0


def test_error_path_fails_tickets_loudly():
    door = _door(flush_window=0.0, max_queue=8)
    door.register("a", _tdis())
    tk = door.submit("a", {"no_such_source": [{"x": 1}]})
    door.pump(force=True)
    with pytest.raises(KeyError):
        tk.result(timeout=600)
    st = door.serve_stats()
    assert st["errors"] == 1 and st["per_tenant"]["a"]["errors"] == 1
    tk2 = door.submit("a", _recs(1, seed=1))
    door.stop(drain=False)
    with pytest.raises(RuntimeError, match="stopped before flush"):
        tk2.result(timeout=1)


def test_worker_thread_mode():
    door = _door(flush_window=0.005, max_queue=64).start()
    try:
        with pytest.raises(RuntimeError, match="already started"):
            door.start()
        with pytest.raises(RuntimeError, match="worker thread"):
            door.pump()
        door.register("a", _tdis())
        tickets = [door.submit("a", _recs(1, seed=i)) for i in range(3)]
        results = [tk.result(timeout=600) for tk in tickets]
        assert all(r.kg_triples > 0 for r in results)
        door.drain(timeout=60)
    finally:
        door.stop()
    assert door.serve_stats()["completed"] == 3
    assert door._thread is None


def test_worker_threads_many_clients_every_ticket_resolves():
    """4 client threads submit to a running worker: every ticket resolves
    and each tenant's KG equals a dedicated session's, bit for bit, when
    that session ingests the same requests in the same flushes (each
    ticket's ``flush_id``). How the worker splits the stream into flushes
    depends on timing, and the vocab numbers new terms in the order the
    ingests meet them, so the codes of one merged ingest equal the door's
    only when the door happened to flush each tenant once."""
    door = _door(flush_window=0.01, max_queue=256)
    for t in range(2):
        door.register(f"t{t}", _tdis(shape=t))
    sent = {f"t{t}": [] for t in range(2)}
    tickets, lock = [], threading.Lock()

    def client(c):
        for i in range(3):
            tid, recs = f"t{(c + i) % 2}", _recs(1, seed=500 + 10 * c + i)
            with lock:       # arrival order = the order recorded here
                resp = door.submit(tid, recs)
                sent[tid].append((recs, resp))
                tickets.append(resp)

    door.start()
    try:
        clients = [threading.Thread(target=client, args=(c,))
                   for c in range(4)]
        for th in clients:
            th.start()
        for th in clients:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in clients)
    finally:
        door.stop(drain=True)
    assert all(isinstance(tk, TSV.Ticket) for tk in tickets)
    assert all(tk.result(timeout=60).kg_triples > 0 for tk in tickets)
    for tid, stream in sent.items():
        eng = TA.KGEngine(_tdis(shape=int(tid[1])),
                          config=TA.EngineConfig(**CFG), device="cpu")
        eng.create_kg()
        flushes = {}          # flush id -> the tenant's requests in order
        for recs, tk in stream:
            flushes.setdefault(tk.result().flush_id, []).append(recs)
        for fid in sorted(flushes):
            merged = {}
            for recs in flushes[fid]:
                for name, rows in recs.items():
                    merged.setdefault(name, []).extend(rows)
            kg, _ = eng.ingest({
                n: TR.Table.from_records(r, eng.sources[n].attrs, eng.vocab,
                                         device="cpu")
                for n, r in merged.items()})
        assert door.kg(tid).row_set() == kg.row_set()


def test_drain_flushes_requests_beyond_max_batch_rows():
    """ROADMAP.md Queue 3: a flush takes at most ``max_batch_rows`` of
    requests (at least one), so the port's ``stop(drain=True)`` and
    ``drain()`` flush until the queue is empty; the reference's single
    forced pump flushes one request here and leaves the rest queued,
    their tickets unresolved."""
    done = {}
    for pkg, make, extra in (
            (TA, _tdis, {"device": "cpu"}),
            (JA, lambda shape: JS.make_group_b_dis(24, 0.5, seed=40), {})):
        door = pkg.FrontDoor(pkg.EngineConfig(**CFG), flush_window=0.0,
                             max_batch_rows=2, **extra)
        door.register("a", make(0))
        tickets = [door.submit("a", _recs(2, seed=i)) for i in range(3)]
        door.stop(drain=True)                   # 4 rows a request > 2
        done[pkg.__name__] = [tk.done() for tk in tickets]
    assert done == {"repro_torch.api": [True, True, True],
                    "repro.api": [True, False, False]}
    door = _door(flush_window=0.0, max_batch_rows=2)
    door.register("a", _tdis())
    tickets = [door.submit("a", _recs(2, seed=i)) for i in range(3)]
    door.drain()
    assert [tk.result(timeout=0).batched_requests for tk in tickets] == \
        [1, 1, 1]
    assert door.serve_stats()["flushes"] == 3


def test_unknown_tenant_duplicates_and_mesh_raise():
    door = _door()
    with pytest.raises(KeyError, match="register"):
        door.submit("ghost", _recs(1))
    door.register("a", _tdis())
    with pytest.raises(ValueError, match="already registered"):
        door.register("a", _tdis())
    assert "a" in door.registry and len(door.registry) == 1
    # a one-rank CPU mesh door serves (it leads itself), and its tenant's
    # KG equals the one-device door's; a tenant may not bring a mesh the
    # door does not have
    mesh_cfg = TA.EngineConfig(**CFG, mesh=make_mesh((1,), ("data",),
                                                     device="cpu"))
    mdoor = TSV.FrontDoor(mesh_cfg, device="cpu", flush_window=0.0)
    mdoor.register("m", _tdis())
    tickets = [d.submit(t, _recs(2, seed=7))
               for d, t in ((mdoor, "m"), (door, "a"))]
    assert mdoor.pump(force=True) == door.pump(force=True) == 1
    assert all(tk.result(timeout=60).kg_triples > 0 for tk in tickets)
    np.testing.assert_array_equal(mdoor.kg("m").to_codes(),
                                  door.kg("a").to_codes())
    st = mdoor.serve_stats()
    assert st["mesh"]["role"] == "leader" and st["mesh"]["commands"] == 1
    assert st["mesh"]["sessions"]["m"]["calls"] == 1   # the ingest
    mdoor.stop(drain=True)
    with pytest.raises(RuntimeError, match="before start"):
        mdoor.register("n", _tdis())
    with pytest.raises(ValueError, match="mesh"):
        door.register("b", _tdis(), config=mesh_cfg)


def test_api_reexports_serve_surface():
    assert TA.FrontDoor is TSV.FrontDoor
    assert TA.Overloaded is TSV.Overloaded
    assert TA.percentile is TSV.percentile
    assert set(JA.__all__) == set(TA.__all__)
    assert "FrontDoor" in dir(TA)
    with pytest.raises(AttributeError):
        TA.not_a_real_name
    for name in ("greedy_generate", "make_prefill", "make_serve_step"):
        assert getattr(TSV, name) is getattr(
            __import__("repro_torch.serve.decode", fromlist=[name]), name)
    assert set(TSV.__all__) == set(JSV.__all__)


# ---------------------------------------------------------------------------
# the driver
# ---------------------------------------------------------------------------

KG_SERVE_FLAGS = ["--rows", "100", "--tenants", "4", "--shapes", "2",
                  "--batches", "4", "--batch-rows", "8", "--max-queue", "3"]


def _summary(stdout):
    """The driver's counters: rows, flushes, requests, sheds, compiles,
    tenants, dedup ratio, recompile stalls and the sheds by reason."""
    ingested = re.search(r"ingested (\d+) rows over (\d+) flushes "
                         r"\((\d+) requests, (\d+) shed\)", stdout)
    counters = re.search(r"compiles=(\d+) for (\d+) tenants \(dedup ratio "
                         r"([\d.]+)x\) recompile_stalls=(\d+) .*sheds=(.*)$",
                         stdout, re.M)
    assert ingested and counters, stdout
    return ingested.groups() + counters.groups()


def test_kg_serve_driver_equals_reference():
    """One device, then over a mesh of 2 (the port's 2 gloo ranks beside
    the reference's 2 host devices), the same flags; the four drivers
    run together."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               JAX_PLATFORMS="cpu")
    mesh_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count"
                    "=2")
    runs = [("repro_torch.launch.kg_serve", ["--device", "cpu"], env),
            ("repro.launch.kg_serve", [], env),
            ("repro_torch.launch.kg_serve", ["--device", "cpu",
                                             "--mesh-shards", "2",
                                             "--timeout", "240"], mesh_env),
            ("repro.launch.kg_serve", ["--mesh-shards", "2"], mesh_env)]
    procs = [subprocess.Popen([sys.executable, "-m", mod, *KG_SERVE_FLAGS,
                               *extra], env=e, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for mod, extra, e in runs]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
    port, ref, mport, mref = (_summary(out) for out, _ in outs)
    assert port == ref
    # sheds and recompile stalls are exercised, not zero
    assert port[3] == "4" and port[7] == "2"
    assert mport == mref
    assert "x2 ranks (gloo)" in outs[2][0]
