"""The port's persistent plan store against the reference, on the CPU.

``repro_torch.api.store`` keeps the reference's key derivation and
container, with an entry of its own (the plan's node-indexed counts and
caps plus the canonical session key; no executable) and an envelope of
the session's device. These tests hold it:

* to ``repro.api.store`` where the two must agree exactly: ``canonical``,
  ``store_key`` for one envelope dict (the two packages' session keys
  canonicalize to the same string), the container bytes both ways, and
  ``pack_entry_meta``'s node-indexed counts and caps for the same DIS and
  configuration;
* across processes: a writer and a reader subprocess of the port, each
  engine × dedup; the reader hits every entry and builds nothing, and its
  KG codes equal the writer's and the reference's in-process KG; keys
  stable under two ``PYTHONHASHSEED``s;
* to every failure case of ``tests/test_plan_store.py`` that has meaning
  for the port (truncation, bit flips, bad magic, envelope and key
  mismatches, an unwritable root, a held lock, a write race, pruning,
  vanishing entries, ``resolve_store``'s forms, overflow write-back), the
  stored-caps deviation pinned beside the reference's behaviour, the query
  tier, and the stats keys.

Every test starts and ends with both packages' plan caches empty
(``isolated_plan_caches``).
"""
import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import repro.api as JA
import repro.api.store as JST
import repro.data.synthetic as JS
import repro_torch.api as TA
import repro_torch.api.store as TST
import repro_torch.core as TC
import repro_torch.data.synthetic as TS
import repro_torch.relalg as TR
from repro_torch.api import PlanStore, resolve_store, store_envelope
from repro_torch.api.store import (FORMAT_VERSION, SESSION_KEY,
                                   read_container, write_container)
from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: engine × dedup of the cross-process round trip (the reference's
#: single-device CONFIGS)
CONFIGS = [("sdm", "hash"), ("sdm", None), ("rmlmapper", "hash"),
           ("rmlmapper", None)]


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


def _env():
    return store_envelope("cpu")


def _jsession(dis, root=None, **cfg):
    """The reference's session of the same configuration (``jit=True``)."""
    cfg.setdefault("engine", "sdm")
    cfg.setdefault("dedup", "hash")
    return JA.KGEngine(dis, config=JA.EngineConfig(plan_store=root, **cfg))


def _session(dis, root=None, **cfg):
    cfg.setdefault("engine", "sdm")
    cfg.setdefault("dedup", "hash")
    return TA.KGEngine(dis, config=TA.EngineConfig(plan_store=root, **cfg),
                       device="cpu")


# ---------------------------------------------------------------------------
# the reference's functions, exactly
# ---------------------------------------------------------------------------

CANONICAL_OK = [None, True, 0, -7, 2**40, 1.5, float("inf"), "a'b",
                (), (1, ("x", None, 2.25)), (False, (("k", 3),))]
CANONICAL_BAD = [[1], {"a": 1}, {1}, np.int64(3), torch.device("cpu"),
                 torch.int32, torch.tensor(1), (1, [2])]


def test_canonical_and_store_key_equal_reference():
    for obj in CANONICAL_OK:
        assert TST.canonical(obj) == JST.canonical(obj)
    for obj in CANONICAL_BAD:
        with pytest.raises(TypeError) as te:
            TST.canonical(obj)
        with pytest.raises(TypeError) as je:
            JST.canonical(obj)
        assert str(te.value) == str(je.value)
    env = {"format": 1, "framework": "torch", "device_count": 1,
           "calibration": "static", "x": None}
    jdis = JS.make_group_b_dis(48, 0.6, seed=3)
    tdis = TS.make_group_b_dis(48, 0.6, seed=3, device="cpu")
    je = _jsession(jdis)
    te = _session(tdis)
    jkey, tkey = je._key(je.sources), te._key(te.sources)
    assert TST.canonical(tkey) == JST.canonical(jkey)
    assert TST.store_key(tkey, env) == JST.store_key(jkey, env)
    assert TST.store_key(tkey, env) != TST.store_key(tkey, _env())


def test_container_bytes_equal_reference(tmp_path):
    header = {"version": 1, "key": "ab" * 32, "envelope": _env(),
              "meta": {"counts": [[0, 3]], "mode": "exact"}}
    payloads = {SESSION_KEY: b"('k',1)", "zz": bytes(range(256))}
    tp, jp = str(tmp_path / "t.plan"), str(tmp_path / "j.plan")
    TST.write_container(tp, header, payloads)
    JST.write_container(jp, header, payloads)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    assert TST.read_container(jp) == JST.read_container(tp)
    assert TST.read_container(tp)[1] == payloads
    assert TST.MAGIC == JST.MAGIC


@pytest.mark.parametrize("kind", ["group_b", "group_a"])
def test_pack_entry_meta_equal_reference(kind):
    if kind == "group_b":
        jdis = JS.make_group_b_dis(48, 0.6, seed=2)
        tdis = TS.make_group_b_dis(48, 0.6, seed=2, device="cpu")
    else:
        jdis = JS.make_group_a_dis(40, 0.5, seed=3)
        tdis = TS.make_group_a_dis(40, 0.5, seed=3, device="cpu")
    je = _jsession(jdis, engine="rmlmapper")
    te = _session(tdis, engine="rmlmapper")
    je.create_kg()
    te.create_kg()
    jentry, tentry = je._last["entry"], te._last["entry"]
    jm = JST.pack_entry_meta(jentry, jentry.plan)
    tm = TST.pack_entry_meta(tentry, tentry.plan)
    assert set(tm) == set(jm)
    for key in ("node_count", "engine", "dedup", "mode", "counts", "caps"):
        assert tm[key] == jm[key], key
    back = TST.unpack_entry_meta(tm, te.plan)
    assert back["caps"] == tentry.caps and back["counts"] == tentry.counts
    with pytest.raises(ValueError, match="does not match"):
        TST.unpack_entry_meta(dict(tm, node_count=tm["node_count"] + 1),
                              te.plan)


# ---------------------------------------------------------------------------
# across processes
# ---------------------------------------------------------------------------

_CHILD = r"""
import json, sys
import torch
from repro_torch.api import EngineConfig, KGEngine
from repro_torch.data.synthetic import make_group_b_dis
torch.set_num_threads(1)
root, configs = sys.argv[1], json.loads(sys.argv[2])
out = {}
for engine, dedup in configs:
    s = KGEngine(make_group_b_dis(48, 0.6, seed=3, device="cpu"),
                 config=EngineConfig(engine=engine, dedup=dedup,
                                     plan_store=root), device="cpu")
    kg, st = s.create_kg()
    out[f"{engine}/{dedup}"] = {
        "codes": kg.to_codes().tolist(), "raw": st["raw_triples"],
        "builds": s.builds, "checks": s.stats()["verify"]["store_checks"],
        **{k: st[k] for k in ("store_hits", "store_misses",
                              "store_rejects")}}
print(json.dumps(out))
"""


def _child(args):
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", _CHILD, *args], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, f"stderr:\n{out.stderr}"
    return out.stdout


def test_cross_process_round_trip_bit_identical(tmp_path):
    root = str(tmp_path / "store")
    cfg = json.dumps(CONFIGS)
    writer = json.loads(_child([root, cfg]))
    reader = json.loads(_child([root, cfg]))
    assert set(writer) == set(reader) == {f"{e}/{d}" for e, d in CONFIGS}
    for engine, dedup in CONFIGS:
        name = f"{engine}/{dedup}"
        w, r = writer[name], reader[name]
        assert (w["store_hits"], w["store_misses"], w["builds"]) == (0, 1, 1)
        assert (r["store_hits"], r["store_rejects"], r["builds"],
                r["checks"]) == (1, 0, 0, 1), name
        assert r["codes"] == w["codes"] and r["raw"] == w["raw"], name
        jkg, jst = JA.KGEngine(JS.make_group_b_dis(48, 0.6, seed=3),
                               config=JA.EngineConfig(
                                   engine=engine, dedup=dedup,
                                   verify="off")).create_kg()
        assert r["codes"] == jkg.to_codes().tolist(), name
        assert r["raw"] == jst["raw_triples"], name


def test_store_keys_stable_under_hash_randomization():
    code = r"""
from repro_torch.api import KGEngine
from repro_torch.api.store import store_envelope, store_key
from repro_torch.data.synthetic import make_group_b_dis
s = KGEngine(make_group_b_dis(32, 0.6, seed=5, device="cpu"), dedup="hash",
             device="cpu")
print(store_key(s._key(s.sources), store_envelope("cpu")))
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [subprocess.Popen([sys.executable, "-W", "ignore", "-c", code],
                              env=dict(env, PYTHONHASHSEED=seed),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for seed in ("0", "4242")]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    keys = {out.strip() for out, _ in outs}
    assert len(keys) == 1, f"hash-seed-dependent store keys: {keys}"


def test_store_cli_populate_ls_and_analysis_store(tmp_path):
    root = str(tmp_path / "store")
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))

    def cli(*args):
        return subprocess.run([sys.executable, "-m", *args], env=env,
                              capture_output=True, text=True, timeout=300)

    out = cli("repro_torch.api.store", "populate", "--root", root,
              "--device", "cpu")
    assert out.returncode == 0, out.stderr
    # every engine × dedup on one device, and the one-rank mesh session
    assert json.loads(out.stdout)["writes"] == 5
    out = cli("repro_torch.api.store", "ls", "--root", root)
    assert out.returncode == 0 and out.stdout.count("payloads=") == 5
    out = cli("repro_torch.analysis", "store", "--root", root)
    assert out.returncode == 0, out.stdout
    assert "5 entries, 0 invalid" in out.stdout
    assert out.stdout.count(", mesh)") == 1
    # a fresh session finds the populated entry
    s = _session(TS.make_group_b_dis(48, 0.6, seed=0, device="cpu"), root,
                 engine="rmlmapper", dedup="lex")
    _, st = s.create_kg()
    assert st["store_hits"] == 1 and s.builds == 0
    # a damaged entry makes the check fail, and the session rejects it
    path = sorted(PlanStore(root)._entry_files())[0]
    header, payloads = read_container(path)
    header["meta"]["caps"] = [[i, -5] for i, _ in header["meta"]["caps"]]
    write_container(path, header, payloads)
    out = cli("repro_torch.analysis", "store", "--root", root)
    assert out.returncode != 0 and "1 invalid" in out.stdout


# ---------------------------------------------------------------------------
# adversarial: corruption / mismatch / contention degrade, never break
# ---------------------------------------------------------------------------

def _tiny_dis():
    """One source, one map, no join — the cheapest real build."""
    return TC.parse_dis({
        "sources": {"s": {"attrs": ["a", "b"], "records": [
            {"a": f"e{i}", "b": f"x{i}"} for i in range(6)]}},
        "maps": [{"name": "m", "source": "s",
                  "subject": {"template": "http://ex/S/{a}",
                              "class": "ex:C"},
                  "poms": [{"predicate": "ex:p",
                            "object": {"reference": "b"}}]}]},
        device="cpu")


def _populate_tiny(root):
    """Build the tiny DIS into ``root``; returns (entry path, KG codes)."""
    TA.clear_plan_cache()
    store = PlanStore(str(root))
    kg, _ = _session(_tiny_dis(), store).create_kg()
    files = store._entry_files()
    assert len(files) == 1 and store.writes == 1
    return files[0], kg.to_codes()


def _load_fresh(root, **cfg):
    """A fresh session over an LRU-cleared cache: forced store lookup."""
    TA.clear_plan_cache()
    store = PlanStore(str(root))
    session = _session(_tiny_dis(), store, **cfg)
    kg, stats = session.create_kg()
    return kg, stats, store, session


def test_clean_store_round_trip_in_process(tmp_path):
    path, codes = _populate_tiny(tmp_path)
    kg, stats, store, session = _load_fresh(tmp_path)
    assert stats["store_hits"] == 1 and stats["store_rejects"] == 0
    assert store.hits == 1 and session.builds == 0
    assert session._last["entry"].origin == "store"
    np.testing.assert_array_equal(kg.to_codes(), codes)
    header, payloads = read_container(path)
    assert header["envelope"]["framework"] == "torch"
    assert header["envelope"]["device_type"] == "cpu"
    assert payloads[SESSION_KEY] == TST.canonical(
        session._key(session.sources)).encode()


@pytest.mark.parametrize("damage", ["truncate_header", "truncate_payload",
                                    "bitflip_payload", "bitflip_magic",
                                    "empty"])
def test_corrupt_entry_degrades_to_fresh_build(tmp_path, damage):
    path, codes = _populate_tiny(tmp_path)
    blob = open(path, "rb").read()
    if damage == "truncate_header":
        blob = blob[:20]
    elif damage == "truncate_payload":
        blob = blob[:len(blob) - 4]
    elif damage == "bitflip_payload":
        i = len(blob) - 8
        blob = blob[:i] + bytes([blob[i] ^ 0xFF]) + blob[i + 1:]
    elif damage == "bitflip_magic":
        blob = b"X" + blob[1:]
    elif damage == "empty":
        blob = b""
    with open(path, "wb") as f:
        f.write(blob)
    kg, stats, store, session = _load_fresh(tmp_path)
    assert stats["store_hits"] == 0
    assert stats["store_rejects"] == 1 and store.rejects == 1
    assert session.builds == 1
    np.testing.assert_array_equal(kg.to_codes(), codes)
    # the fresh build wrote a VALID entry back over the corpse
    header, payloads = read_container(path)
    assert header["version"] == FORMAT_VERSION and SESSION_KEY in payloads


@pytest.mark.parametrize("field,value", [
    ("format", FORMAT_VERSION + 1), ("framework", "jax"),
    ("torch", "0.0.0-other"), ("cuda", "99.9"), ("device_type", "cuda"),
    ("device_name", "alien"), ("device_count", 4096),
    ("calibration", "(1.0,2.0)")])
def test_envelope_mismatch_rejected(tmp_path, field, value):
    path, codes = _populate_tiny(tmp_path)
    header, payloads = read_container(path)
    assert field in header["envelope"]
    header["envelope"][field] = value
    write_container(path, header, payloads)
    kg, stats, store, _ = _load_fresh(tmp_path)
    assert stats["store_hits"] == 0 and stats["store_rejects"] == 1
    assert any("envelope mismatch" in r for r in store.reject_reasons)
    np.testing.assert_array_equal(kg.to_codes(), codes)


def test_header_key_mismatch_rejected(tmp_path):
    path, codes = _populate_tiny(tmp_path)
    header, payloads = read_container(path)
    header["key"] = "0" * 64
    write_container(path, header, payloads)
    kg, stats, store, _ = _load_fresh(tmp_path)
    assert stats["store_rejects"] == 1
    assert any("key mismatch" in r for r in store.reject_reasons)
    np.testing.assert_array_equal(kg.to_codes(), codes)


def test_session_key_payload_mismatch_rejected(tmp_path):
    """A payload that passes its checksum but is not this session's key
    (the port's counterpart of an unloadable executable) rejects."""
    path, codes = _populate_tiny(tmp_path)
    header, _payloads = read_container(path)
    write_container(path, header, {SESSION_KEY: b"('not','this')"})
    kg, stats, store, _ = _load_fresh(tmp_path)
    assert stats["store_hits"] == 0 and stats["store_rejects"] == 1
    assert any("rehydrate" in r for r in store.reject_reasons)
    np.testing.assert_array_equal(kg.to_codes(), codes)


def _damage_caps(path, cap):
    header, payloads = read_container(path)
    header["meta"]["caps"] = [[i, cap] for i, _ in header["meta"]["caps"]]
    header.pop("payloads")
    write_container(path, header, payloads)


def test_damaged_meta_rejected_under_plan_and_off(tmp_path):
    """Negative stored caps: ``"plan"`` rejects at verification, and so
    does ``"off"`` (no closure can be built from them); either way the
    session builds fresh and the KG is the writer's."""
    path, codes = _populate_tiny(tmp_path)
    _damage_caps(path, -5)
    for level in ("plan", "off"):
        kg, stats, store, session = _load_fresh(tmp_path, verify=level)
        assert stats["store_rejects"] == 1 and stats["store_hits"] == 0
        assert session.stats()["verify"]["store_checks"] == 0
        assert session.builds == 1
        np.testing.assert_array_equal(kg.to_codes(), codes)
        _damage_caps(path, -5)     # the fresh build wrote a good entry


def test_stored_caps_deviation_pinned(tmp_path):
    """ROADMAP Queue 3: the port builds its closure from the stored caps.
    Under ``verify="off"`` the reference adopts its intact executable
    whatever the stored caps say (negative or too small: no reject, no
    recompile); the port rejects negative caps and rebuilds, and runs
    caps too small for the data into the normal exact rebuild — one
    recompile and no reject. Every KG equals the writer's."""
    jroot, troot = tmp_path / "j", tmp_path / "t"
    jdis = lambda: JS.make_group_b_dis(48, 0.6, seed=0)  # noqa: E731
    tdis = lambda: TS.make_group_b_dis(48, 0.6, seed=0,  # noqa: E731
                                       device="cpu")
    jkg0, _ = _jsession(jdis(), str(jroot)).create_kg()
    tkg0, _ = _session(tdis(), str(troot)).create_kg()
    np.testing.assert_array_equal(tkg0.to_codes(), jkg0.to_codes())
    (jpath,), (tpath,) = (PlanStore(str(r))._entry_files()
                          for r in (jroot, troot))
    got = {}
    for cap in (-5, 1):
        JST.write_container(jpath, *(lambda h, p: (
            dict(h, meta=dict(h["meta"], caps=[[i, cap] for i, _ in
                                               h["meta"]["caps"]])), p))(
            *JST.read_container(jpath)))
        _damage_caps(tpath, cap)
        JA.clear_plan_cache()
        TA.clear_plan_cache()
        je = _jsession(jdis(), str(jroot), verify="off")
        te = _session(tdis(), str(troot), verify="off")
        (jkg, jst), (tkg, tst) = je.create_kg(), te.create_kg()
        np.testing.assert_array_equal(jkg.to_codes(), jkg0.to_codes())
        np.testing.assert_array_equal(tkg.to_codes(), jkg0.to_codes())
        got[cap] = ((jst["store_hits"], jst["store_rejects"],
                     jst["recompiles"]),
                    (tst["store_hits"], tst["store_rejects"],
                     tst["recompiles"]))
    assert got == {-5: ((1, 0, 0), (0, 1, 0)),
                   1: ((1, 0, 0), (1, 0, 1))}


def test_packages_never_adopt_each_others_entries(tmp_path):
    root = str(tmp_path)
    _jsession(JS.make_group_b_dis(48, 0.6, seed=0), root).create_kg()
    _, st = _session(TS.make_group_b_dis(48, 0.6, seed=0, device="cpu"),
                     root).create_kg()
    assert (st["store_hits"], st["store_misses"]) == (0, 1)
    JA.clear_plan_cache()
    _, jst = _jsession(JS.make_group_b_dis(48, 0.6, seed=0),
                       root).create_kg()
    assert jst["store_hits"] == 1      # its own entry, not the port's
    assert len(PlanStore(root)) == 2


def test_unwritable_store_root_counts_write_errors(tmp_path):
    blocker = tmp_path / "blocker"
    blocker.write_text("not a directory")
    session = _session(_tiny_dis(), PlanStore(str(blocker / "store")))
    kg, _ = session.create_kg()
    ps = session.stats()["plan_store"]
    assert ps["writes"] == 0 and ps["write_errors"] >= 1
    assert ps["entries"] == 0
    ref, _ = TC.RDFizer(_tiny_dis())()
    np.testing.assert_array_equal(kg.to_codes(), ref.to_codes())


def test_concurrent_writer_lock_skips_then_succeeds(tmp_path):
    import fcntl
    store = PlanStore(str(tmp_path))
    env = _env()
    key = "ab" * 32
    os.makedirs(store.root, exist_ok=True)
    lock_fd = os.open(store.entry_path(key) + ".lock",
                      os.O_CREAT | os.O_RDWR, 0o644)
    fcntl.flock(lock_fd, fcntl.LOCK_EX)
    try:
        assert store.save(key, env, {"m": 1}, {SESSION_KEY: b"x"}) is False
        assert store.write_skipped == 1 and store.writes == 0
    finally:
        os.close(lock_fd)
    assert store.save(key, env, {"m": 1}, {SESSION_KEY: b"x"}) is True
    res = store.load(key, env)
    assert res.status == "hit" and res.payloads[SESSION_KEY] == b"x"


def test_concurrent_writer_race_never_tears(tmp_path):
    store = PlanStore(str(tmp_path))
    env = _env()
    key = "cd" * 32
    payloads = [f"payload-{i}".encode() * 100 for i in range(8)]

    def writer(i):
        PlanStore(str(tmp_path)).save(key, env, {"i": i},
                                      {SESSION_KEY: payloads[i]})

    threads = [threading.Thread(target=writer, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    header, got = read_container(store.entry_path(key))
    assert got[SESSION_KEY] in payloads and header["key"] == key
    assert store.load(key, env).status == "hit"
    assert [f for f in os.listdir(store.root) if ".tmp." in f] == []


def test_max_entries_prunes_oldest(tmp_path):
    store = PlanStore(str(tmp_path), max_entries=2)
    env = _env()
    for i in range(4):
        key = f"{i:02d}" * 32
        assert store.save(key, env, {"i": i}, {SESSION_KEY: b"z"})
        os.utime(store.entry_path(key), (i, i))
    assert len(store) == 2
    assert f"{3:02d}" * 32 + ".plan" in os.listdir(store.root)


def test_prune_and_stats_tolerate_vanishing_entries(tmp_path, monkeypatch):
    store = PlanStore(str(tmp_path), max_entries=100)
    env = _env()
    for i in range(4):
        key = f"{i:02d}" * 32
        assert store.save(key, env, {"i": i}, {SESSION_KEY: b"z"})
        os.utime(store.entry_path(key), (i, i))
    real_getmtime, vanished = os.path.getmtime, []

    def racing_getmtime(path):
        if not vanished:
            vanished.append(path)
            os.unlink(path)                     # the concurrent pruner
        return real_getmtime(path)              # raises for the victim

    monkeypatch.setattr(os.path, "getmtime", racing_getmtime)
    store.max_entries = 1
    errors = store.write_errors
    store._prune()                              # must not raise
    monkeypatch.undo()
    assert store.write_errors == errors + 1 and len(store) == 1
    real_unlink = os.unlink

    def racing_unlink(path, *a, **kw):
        real_unlink(path, *a, **kw)
        raise FileNotFoundError(path)           # loser's view of the race

    assert store.save("aa" * 32, env, {}, {SESSION_KEY: b"z"})
    monkeypatch.setattr(os, "unlink", racing_unlink)
    errors = store.write_errors
    store._prune()
    monkeypatch.undo()
    assert store.write_errors == errors
    real_getsize = os.path.getsize
    monkeypatch.setattr(os.path, "getsize", lambda p: (_ for _ in ()).throw(
        FileNotFoundError(p)) if p.endswith(".plan") else real_getsize(p))
    st = store.stats()                          # must not raise
    assert st["entries"] == 1 and st["bytes"] == 0


def test_resolve_store_argument_forms(tmp_path, monkeypatch):
    assert resolve_store(None) is None and resolve_store(False) is None
    s = PlanStore(str(tmp_path))
    assert resolve_store(s) is s
    assert resolve_store(str(tmp_path)).root == str(tmp_path)
    assert resolve_store(tmp_path).root == str(tmp_path)
    monkeypatch.setenv("REPRO_TORCH_PLAN_STORE", str(tmp_path / "env"))
    assert resolve_store(True).root == str(tmp_path / "env")
    assert resolve_store("default").root == str(tmp_path / "env")
    with pytest.raises(TypeError):
        resolve_store(123)


def test_store_disabled_by_default_and_without_jit(tmp_path):
    session = _session(_tiny_dis())
    session.create_kg()
    st = session.stats()
    assert st["plan_store"] is None
    assert st["store_hits"] == st["store_misses"] == 0
    session = _session(_tiny_dis(), str(tmp_path), jit=False)
    session.create_kg()
    st = session.stats()
    assert st["store_misses"] == 0 and st["plan_store"]["writes"] == 0


def test_overflow_rebuild_writes_back_bigger_entry(tmp_path):
    def mk():
        return TS.make_group_b_dis(24, 0.6, seed=11, device="cpu")

    store = PlanStore(str(tmp_path))
    session = _session(mk(), store)
    session.create_kg()
    ext = TS.make_group_b_dis(24 * 16, 0.6, seed=42, device="cpu")
    recs = ext.sources["gene"].to_records(ext.vocab)
    kg, stats = session.ingest({"gene": TR.Table.from_records(
        recs, mk().sources["gene"].attrs, session.vocab, device="cpu")})
    assert stats["recompiles"] == 1 and store.writes >= 2
    TA.clear_plan_cache()
    session2 = _session(mk(), PlanStore(str(tmp_path)))
    session2.sources.update(session.sources)
    kg2, stats2 = session2.create_kg()
    assert stats2["store_hits"] == 1 and stats2["recompiles"] == 0
    np.testing.assert_array_equal(kg2.to_codes(), kg.to_codes())


def test_mesh_session_with_store_raises(tmp_path):
    """A one-rank mesh session takes a store (the name stays from when it
    raised): it writes its KG and query entries, and a fresh session
    rehydrates both, with the writer's KG and answer."""
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1,), ("data",), device="cpu")
    q = TA.Query(patterns=[TA.TriplePattern("?s", "?p", "?o"),
                           TA.TriplePattern("?o", "?p2", "?o2")])
    runs = []
    for _ in range(2):
        TA.clear_plan_cache()
        session = _session(_tiny_dis(), str(tmp_path), mesh=mesh)
        kg, st = session.create_kg()
        ans = session.query(q)
        runs.append((kg.to_codes(), ans.to_codes(), st, session))
    (wkg, wans, wst, writer), (rkg, rans, rst, reader) = runs
    assert wst["store_misses"] == 1 and writer.builds == 2
    assert rst["store_hits"] == 1 and reader.builds == 0
    assert reader.stats()["query"]["store_hits"] == 1
    assert reader._last["entry"].origin == "store"
    assert reader._last["entry"].cap_locals is not None
    np.testing.assert_array_equal(rkg, wkg)
    np.testing.assert_array_equal(rans, wans)
    assert len(PlanStore(str(tmp_path))) == 2


# ---------------------------------------------------------------------------
# the query tier and the stats keys
# ---------------------------------------------------------------------------

def test_query_tier_from_store_with_reference_answers(tmp_path):
    root = str(tmp_path)
    jdis = JS.make_group_b_dis(48, 0.6, seed=0)
    je = _jsession(jdis)
    jkg, _ = je.create_kg()
    codes = np.asarray(jkg.to_codes())
    pred = int(codes[0, 2])

    def q(pkg):
        return pkg.Query(patterns=[pkg.TriplePattern("?s", pred, "?o"),
                                   pkg.TriplePattern("?o", "?p", "?x")])

    jans = je.query(q(JA))
    te = _session(TS.make_group_b_dis(48, 0.6, seed=0, device="cpu"), root)
    te.create_kg()
    first = te.query(q(TA))
    assert te.stats()["query"]["store_misses"] == 1
    TA.clear_plan_cache()
    fresh = _session(TS.make_group_b_dis(48, 0.6, seed=0, device="cpu"),
                     root)
    fresh.create_kg()
    ans = fresh.query(q(TA))
    qst = fresh.stats()["query"]
    assert (qst["store_hits"], qst["store_misses"], qst["store_rejects"]) \
        == (1, 0, 0)
    assert fresh._q_last["entry"].origin == "store" and fresh.builds == 0
    assert fresh.stats()["verify"]["store_checks"] == 2
    for got in (first, ans):
        np.testing.assert_array_equal(got.to_codes(), jans.to_codes())
        assert tuple(got.attrs) == tuple(jans.attrs)
    again = fresh.query(q(TA))                  # now an LRU hit
    np.testing.assert_array_equal(again.to_codes(), jans.to_codes())
    assert fresh.stats()["query"]["cache_hits"] == 1


def test_stats_keys_equal_reference(tmp_path):
    je = _jsession(JS.make_group_b_dis(48, 0.6, seed=0),
                   str(tmp_path / "j"))
    te = _session(TS.make_group_b_dis(48, 0.6, seed=0, device="cpu"),
                  str(tmp_path / "t"))
    (_, jst), (_, tst) = je.create_kg(), te.create_kg()
    assert set(tst) == set(jst)
    js, ts = je.stats(), te.stats()
    assert set(ts) - set(js) == {"mesh", "device"}
    assert set(js) <= set(ts)
    for key in ("query", "verify", "plan_store"):
        assert set(ts[key]) == set(js[key]), key
    for key in ("store_hits", "store_misses", "store_rejects"):
        assert ts[key] == js[key] and tst[key] == jst[key], key
    assert ts["verify"] == js["verify"]
    for key in ("entries", "hits", "misses", "rejects", "writes",
                "write_errors", "write_skipped"):
        assert ts["plan_store"][key] == js["plan_store"][key], key
