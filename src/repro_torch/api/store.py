"""The persistent plan store: a second tier of the plan cache, on disk.

:data:`repro_torch.api.cache.PLAN_CACHE` amortizes planning *within* one
process; a restarting fleet pays the cold cost per worker × per DIS shape
(host-side exact annotation, seconds at 1M rows on the card). The store
makes the amortization survive the process: on an LRU miss the
:class:`~repro_torch.api.KGEngine` consults an on-disk store, and after
every build (overflow rebuilds included, so a bigger entry replaces the
smaller one) it writes back — so a fresh process with a populated store
skips the annotation of a plan it has seen.

Three design points differ from the reference's ``repro.api.store``:

* **The entry is the plan, not an executable.** PyTorch has no
  counterpart of ``serialize_executable`` or ``jax.export``, and the
  port's closures are eager: :func:`repro_torch.plan.compile.compile_plan`
  rebuilds one from the stored node-indexed counts and caps. A store hit
  therefore skips the exact annotation (its host reads included) and the
  build-time checks, but not the closure build, which is cheap. The
  port's entries carry a format version of their own
  (:data:`FORMAT_VERSION`) and a ``"framework": "torch"`` envelope field,
  so the two packages never adopt each other's entries.
* **The envelope belongs to the session's device**, not to the process
  (:func:`store_envelope`): a CPU session and a card session in one
  process never share an entry.
* **A mesh entry is one per mesh, not per rank.** The port's mesh is one
  process per rank, so the session key of a mesh session names the
  mesh's axes and backend (:meth:`repro_torch.launch.mesh.Mesh.signature`),
  not the rank or the card's index; every rank loads and checks the
  entry, the ranks adopt it only together, and rank 0 alone writes
  (:class:`~repro_torch.api.KGEngine`).
* **Stored caps are what the closure runs with.** The reference adopts
  an intact executable whatever its stored metadata says (under
  ``verify="off"``); the port builds the closure from the stored caps.
  Any failure to build or run a rehydrated entry is one more
  ``store_rejects``, followed by a fresh build, and caps too small for the
  data overflow into the normal exact rebuild: the KG is never wrong.

**Key.** ``store_key(session_key, envelope)`` = sha256 over the engine's
in-process plan-cache key (structural IR fingerprint × emitter codes ×
static config × capacity-bucket signature), canonicalized by
:func:`canonical` — which *rejects* anything but ``None``/``bool``/
``int``/``float``/``str``/``tuple``, so an ``id()``, a ``torch.device``, a
dtype or an unsorted dict can never silently leak into the key — and the
**compatibility envelope** (:func:`store_envelope`).

**Entry format** (the reference's container, one file per key)::

    MAGIC(8) | header_len u32 LE | sha256(header)(32) | header JSON | payloads

The header carries the envelope (validated for *equality* on load), the
node-indexed plan metadata (counts and caps keyed by
:func:`repro_torch.plan.ir.node_order` indices, so they rehydrate against
a freshly lowered plan) and per-payload sizes + sha256 checksums. The one
payload, :data:`SESSION_KEY`, is the canonical session key itself: the
engine adopts an entry only if it equals its own, which turns a
mis-copied or colliding entry into a clean rejection.

**Failure discipline.** Every load failure — missing file, bad magic,
truncated bytes, checksum mismatch, envelope mismatch, a session key that
differs — degrades to a fresh build and bumps a reject counter
(``stats()['rejects']``; mirrored as ``store_rejects`` on the engine).
Writes go to a temp file in the same directory and ``os.replace`` into
place under a per-entry advisory ``flock``, so a concurrent reader never
observes a torn entry and concurrent writers never interleave; a busy
lock or an unwritable directory skips the write (counted), never raises.

CLI::

    PYTHONPATH=src python -m repro_torch.api.store populate --root DIR [--device cpu]
    PYTHONPATH=src python -m repro_torch.api.store ls --root DIR
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import struct
import tempfile
from typing import Dict, List, Mapping, Optional, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device

#: the reference's container magic: the envelope, not the container,
#: keeps the two packages' entries apart
MAGIC = b"RPLNSTR1"
#: the port's own entry format (plan metadata + the canonical session
#: key; no executable payload)
FORMAT_VERSION = 1
FRAMEWORK = "torch"

#: the one payload of a port entry: ``canonical(session_key)``, UTF-8
SESSION_KEY = "session_key"


def default_store_root() -> str:
    """``$REPRO_TORCH_PLAN_STORE`` if set, else
    ``~/.cache/repro-torch-plans``."""
    env = os.environ.get("REPRO_TORCH_PLAN_STORE")
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache",
                        "repro-torch-plans")


# ---------------------------------------------------------------------------
# key canonicalization + envelope
# ---------------------------------------------------------------------------

def canonical(obj) -> str:
    """Deterministic, process-stable encoding of a plan-cache key.

    Only ``None``/``bool``/``int``/``float``/``str``/``tuple`` are
    admitted — these repr identically in every process. Anything else
    (an object whose repr embeds ``id()``, a dict whose iteration order
    depends on insertion, a tensor, a ``torch.device``) raises
    ``TypeError`` instead of silently producing a key that only this
    process can reproduce.
    """
    if obj is None or isinstance(obj, (bool, int, str)):
        return repr(obj)
    if isinstance(obj, float):
        return repr(obj)  # shortest-repr is deterministic in CPython 3
    if isinstance(obj, tuple):
        return "(" + ",".join(canonical(x) for x in obj) + ")"
    raise TypeError(
        f"plan-store keys must be built from None/bool/int/float/str/tuple; "
        f"got {type(obj).__name__} — a process-unstable component would "
        f"make the key irreproducible across workers")


def store_envelope(device: DeviceLike = None,
                   calibration=None) -> Dict[str, object]:
    """The runtime facts an entry is only valid under, for a session on
    ``device`` (the CUDA card by default): the port's format, the
    framework, torch's version and its CUDA version, the device's type,
    name (``torch.cuda.get_device_name`` for the card, ``"cpu"``
    otherwise) and count, and the cost model's calibration tag (as in the
    reference: ``"static"``, or the canonical signature of a measured
    :class:`repro_torch.launch.mesh.Calibration`)."""
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    env = {
        "format": FORMAT_VERSION,
        "framework": FRAMEWORK,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "device_type": dev.type,
        "device_name": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "device_count": torch.cuda.device_count() if cuda else 1,
        "calibration": "static",
    }
    if calibration is not None and calibration.source != "static":
        env["calibration"] = canonical(calibration.signature())
    return env


def _envelope_json(envelope: Mapping[str, object]) -> str:
    return json.dumps(dict(envelope), sort_keys=True, separators=(",", ":"))


def store_key(session_key: Tuple, envelope: Mapping[str, object]) -> str:
    """sha256 hex of the canonicalized in-process key × the envelope."""
    blob = canonical(session_key) + "\n" + _envelope_json(envelope)
    return hashlib.sha256(blob.encode()).hexdigest()


# ---------------------------------------------------------------------------
# container read/write (module-level so tests can tamper surgically)
# ---------------------------------------------------------------------------

def write_container(path: str, header: Dict[str, object],
                    payloads: Mapping[str, bytes]) -> None:
    """Serialize one entry (non-atomic — callers go through
    :meth:`PlanStore.save` for the temp+rename+lock discipline)."""
    names = sorted(payloads)
    header = dict(header)
    header["payloads"] = [{"name": n, "size": len(payloads[n]),
                           "sha256": hashlib.sha256(payloads[n]).hexdigest()}
                          for n in names]
    hjson = json.dumps(header, sort_keys=True).encode()
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(hjson)))
        f.write(hashlib.sha256(hjson).digest())
        f.write(hjson)
        for n in names:
            f.write(payloads[n])
        f.flush()
        os.fsync(f.fileno())


def read_container(path: str) -> Tuple[Dict[str, object], Dict[str, bytes]]:
    """Parse + integrity-check one entry; raises ``ValueError``/``OSError``
    on any corruption (bad magic, truncation, checksum mismatch)."""
    with open(path, "rb") as f:
        blob = f.read()
    if blob[:len(MAGIC)] != MAGIC:
        raise ValueError("bad magic")
    off = len(MAGIC)
    if len(blob) < off + 36:
        raise ValueError("truncated header")
    (hlen,) = struct.unpack("<I", blob[off:off + 4])
    off += 4
    hdigest, off = blob[off:off + 32], off + 32
    hjson = blob[off:off + hlen]
    if len(hjson) != hlen or hashlib.sha256(hjson).digest() != hdigest:
        raise ValueError("header checksum mismatch")
    header = json.loads(hjson.decode())
    off += hlen
    payloads: Dict[str, bytes] = {}
    for spec in header.get("payloads", []):
        data = blob[off:off + int(spec["size"])]
        if len(data) != int(spec["size"]):
            raise ValueError(f"truncated payload {spec['name']!r}")
        if hashlib.sha256(data).hexdigest() != spec["sha256"]:
            raise ValueError(f"payload checksum mismatch {spec['name']!r}")
        payloads[spec["name"]] = data
        off += int(spec["size"])
    return header, payloads


# ---------------------------------------------------------------------------
# node-indexed entry metadata (caps/counts survive the process)
# ---------------------------------------------------------------------------

def pack_entry_meta(entry, plan) -> Dict[str, object]:
    """Serialize a :class:`~repro_torch.api.cache.CachedPlan`'s node-keyed
    metadata as :func:`repro_torch.plan.ir.node_order` index lists (the
    order is fingerprint-stable, so a same-key process maps indices back
    onto its own freshly lowered nodes). A mesh entry adds its shard
    layout: the shard-local source capacities, the rows of one rank's
    output block, the sink slack, ``safe_exchange`` and every ⋈'s
    exchange decision, as the reference writes them."""
    from repro_torch.plan.ir import node_order
    index = {n: i for i, n in enumerate(node_order(plan.emits()))}
    meta: Dict[str, object] = {
        "node_count": len(index),
        "engine": entry.engine,
        "dedup": entry.dedup,
        "mode": entry.mode,
        "build_seconds": entry.build_seconds,
        "counts": sorted([index[n], int(v)]
                         for n, v in entry.counts.items()),
        "caps": sorted([index[n], int(v)] for n, v in entry.caps.items()),
    }
    if entry.cap_locals is not None:      # mesh entry: shard layout
        meta["cap_locals"] = {k: int(v)
                              for k, v in sorted(entry.cap_locals.items())}
        meta["out_cap_local"] = int(entry.out_cap_local)
        meta["sink_slack"] = float(entry.sink_slack)
        meta["safe_exchange"] = bool(entry.safe_exchange)
        meta["exchanges"] = sorted(
            [index[n], x.strategy, int(x.gather_bytes),
             int(x.repartition_bytes), float(x.gather_seconds),
             float(x.repartition_seconds),
             getattr(x, "cost_source", "static"),
             int(getattr(x, "parent_fanout", 1))]
            for n, x in (entry.exchanges or {}).items())
    return meta


def unpack_entry_meta(meta: Mapping[str, object], plan) -> Dict[str, object]:
    """Rebuild node-keyed dicts against *this* process's plan nodes;
    raises ``ValueError`` when the stored indices do not fit the local
    plan (a corrupted or key-colliding entry must reject, not mis-map).
    A mesh entry's result also holds ``cap_locals``, ``out_cap_local``,
    ``sink_slack``, ``safe_exchange`` and ``exchanges`` (node ->
    :class:`repro_torch.plan.annotate.JoinExchange`)."""
    from repro_torch.plan.annotate import JoinExchange
    from repro_torch.plan.ir import node_order
    order = node_order(plan.emits())
    if int(meta["node_count"]) != len(order):
        raise ValueError("stored node metadata does not match the plan "
                         f"({meta['node_count']} nodes vs {len(order)})")
    out: Dict[str, object] = {
        "counts": {order[i]: int(v) for i, v in meta["counts"]},
        "caps": {order[i]: int(v) for i, v in meta["caps"]},
        "mode": meta["mode"],
        "build_seconds": float(meta["build_seconds"]),
    }
    if "cap_locals" in meta:
        out["cap_locals"] = {str(k): int(v)
                             for k, v in sorted(meta["cap_locals"].items())}
        out["out_cap_local"] = int(meta["out_cap_local"])
        out["sink_slack"] = float(meta["sink_slack"])
        out["safe_exchange"] = bool(meta["safe_exchange"])
        out["exchanges"] = {
            order[i]: JoinExchange(strategy=s, gather_bytes=int(gb),
                                   repartition_bytes=int(rb),
                                   gather_seconds=float(gs),
                                   repartition_seconds=float(rs),
                                   cost_source=str(src),
                                   parent_fanout=int(rest[0]) if rest else 1)
            for i, s, gb, rb, gs, rs, src, *rest
            in meta.get("exchanges", [])}
    return out


# ---------------------------------------------------------------------------
# the store
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LoadResult:
    """Outcome of one :meth:`PlanStore.load`: ``status`` is ``"hit"``
    (header+payloads returned), ``"miss"`` (no entry) or ``"reject"``
    (an entry exists but failed validation — ``reason`` says why)."""

    status: str
    header: Optional[Dict[str, object]] = None
    payloads: Optional[Dict[str, bytes]] = None
    reason: Optional[str] = None


class PlanStore:
    """Disk-backed tier of the plan cache: one entry file per store key.

    ``max_entries`` prunes the oldest entries (by mtime) after each save.
    """

    def __init__(self, root: Optional[str] = None, *,
                 max_entries: Optional[int] = None):
        self.root = os.path.abspath(root or default_store_root())
        self.max_entries = max_entries
        self.hits = 0
        self.misses = 0
        self.rejects = 0
        self.writes = 0
        self.write_errors = 0
        self.write_skipped = 0
        self.reject_reasons: List[str] = []   # bounded diagnostic ring

    # -- paths ---------------------------------------------------------------
    def entry_path(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.plan")

    def _reject(self, reason: str) -> LoadResult:
        self.rejects += 1
        self.reject_reasons.append(reason)
        del self.reject_reasons[:-16]
        return LoadResult(status="reject", reason=reason)

    # -- read ----------------------------------------------------------------
    def load(self, key: str,
             envelope: Mapping[str, object]) -> LoadResult:
        """Validated read of one entry. NEVER raises: every failure mode
        (missing file, corrupt container, envelope mismatch) returns a
        ``miss``/``reject`` result and the caller builds fresh."""
        path = self.entry_path(key)
        try:
            if not os.path.exists(path):
                self.misses += 1
                return LoadResult(status="miss")
            header, payloads = read_container(path)
            if header.get("envelope") != dict(envelope):
                return self._reject("envelope mismatch")
            if header.get("key") != key:
                return self._reject("key mismatch")
            self.hits += 1
            return LoadResult(status="hit", header=header, payloads=payloads)
        except Exception as e:   # corrupt bytes must degrade, not crash
            return self._reject(f"{type(e).__name__}: {e}")

    # -- write ---------------------------------------------------------------
    def save(self, key: str, envelope: Mapping[str, object],
             meta: Mapping[str, object],
             payloads: Mapping[str, bytes]) -> bool:
        """Atomic write-back: temp file + ``os.replace`` under a per-entry
        advisory ``flock``. A busy lock (another writer is mid-flight on
        the same entry) skips; any OS error (read-only store, full disk)
        is swallowed and counted. Returns True iff the entry landed."""
        path = self.entry_path(key)
        lock_path = path + ".lock"
        tmp_path = None
        lock_fd = None
        try:
            os.makedirs(self.root, exist_ok=True)
            lock_fd = os.open(lock_path, os.O_CREAT | os.O_RDWR, 0o644)
            try:
                import fcntl
                fcntl.flock(lock_fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            except (ImportError, BlockingIOError, PermissionError):
                self.write_skipped += 1
                return False
            fd, tmp_path = tempfile.mkstemp(dir=self.root,
                                            prefix=f".{key[:16]}.tmp.")
            os.close(fd)
            header = {"version": FORMAT_VERSION, "key": key,
                      "envelope": dict(envelope), "meta": dict(meta)}
            write_container(tmp_path, header, payloads)
            os.replace(tmp_path, path)   # readers see old or new, never torn
            tmp_path = None
            self.writes += 1
            if self.max_entries is not None:
                self._prune()
            return True
        except OSError:
            self.write_errors += 1
            return False
        finally:
            if tmp_path is not None:
                try:
                    os.unlink(tmp_path)
                except OSError:
                    pass
            if lock_fd is not None:
                os.close(lock_fd)   # closing drops the flock

    def _prune(self) -> None:
        """Drop the oldest entries beyond ``max_entries`` — tolerant of
        concurrent stores: an entry vanishing or being replaced between
        the listing and the mtime read is skipped and counted under
        ``write_errors`` (the store's NEVER-raises contract covers pruning
        too), and the unlink itself is missing-ok."""
        stamped = []
        for path in self._entry_files():
            try:
                stamped.append((os.path.getmtime(path), path))
            except OSError:      # pruned/replaced behind our back
                self.write_errors += 1
        stamped.sort()
        for _, path in stamped[:max(0, len(stamped) - self.max_entries)]:
            try:
                os.unlink(path)
            except FileNotFoundError:   # a concurrent pruner won the race
                pass
            except OSError:
                self.write_errors += 1

    # -- introspection -------------------------------------------------------
    def _entry_files(self) -> List[str]:
        try:
            return [os.path.join(self.root, f) for f in os.listdir(self.root)
                    if f.endswith(".plan")]
        except OSError:
            return []

    def __len__(self) -> int:
        return len(self._entry_files())

    def stats(self) -> Dict[str, object]:
        files = self._entry_files()
        size = 0
        for p in files:     # same listing/stat race discipline as _prune
            try:
                size += os.path.getsize(p)
            except OSError:
                pass
        return {"root": self.root, "entries": len(files),
                "bytes": size,
                "hits": self.hits, "misses": self.misses,
                "rejects": self.rejects, "writes": self.writes,
                "write_errors": self.write_errors,
                "write_skipped": self.write_skipped}

    def clear(self) -> None:
        for path in self._entry_files():
            try:
                os.unlink(path)
            except OSError:
                pass


def resolve_store(plan_store) -> Optional[PlanStore]:
    """Normalize the ``KGEngine(plan_store=...)`` argument:

    * ``None``/``False`` — store disabled (the in-process LRU only);
    * ``True`` or ``"default"`` — :func:`default_store_root`
      (``$REPRO_TORCH_PLAN_STORE`` or ``~/.cache/repro-torch-plans``);
    * a path — a :class:`PlanStore` rooted there;
    * a :class:`PlanStore` — used as-is (sessions may share one).
    """
    if plan_store is None or plan_store is False:
        return None
    if isinstance(plan_store, PlanStore):
        return plan_store
    if plan_store is True or plan_store == "default":
        return PlanStore(default_store_root())
    if isinstance(plan_store, (str, os.PathLike)):
        return PlanStore(os.fspath(plan_store))
    raise TypeError(f"plan_store must be None, True, 'default', a path or "
                    f"a PlanStore; got {type(plan_store).__name__}")


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _populate(root: str, n_rows: int, device: DeviceLike) -> int:
    """Build the standard smoke configurations into ``root`` (every
    engine × dedup on one device, plus a mesh session: the reference's
    spans every device of its process, the port's is a one-rank mesh in
    this process) — a separate process then finds them as store hits."""
    from repro_torch.api.config import EngineConfig
    from repro_torch.api.engine import KGEngine
    from repro_torch.api.store import PlanStore as _PlanStore   # NOT the
    # ``__main__`` alias of this class: under ``python -m
    # repro_torch.api.store`` the module exists twice, and the engine
    # isinstance-checks against the canonically imported one
    from repro_torch.data.synthetic import make_group_b_dis
    store = _PlanStore(root)
    for engine in ("rmlmapper", "sdm"):
        for dedup in ("lex", "hash"):
            session = KGEngine(make_group_b_dis(n_rows, 0.6, seed=0,
                                                device=device),
                               config=EngineConfig(engine=engine,
                                                   dedup=dedup,
                                                   plan_store=store),
                               device=device)
            session.create_kg()
    from repro_torch.launch.mesh import make_mesh
    mesh = make_mesh((1,), ("data",), device=device)
    session = KGEngine(make_group_b_dis(n_rows, 0.6, seed=0, device=device),
                       config=EngineConfig(engine="sdm", dedup="hash",
                                           mesh=mesh, plan_store=store))
    session.create_kg()
    print(json.dumps(store.stats(), indent=1))
    return 0 if store.writes > 0 and store.write_errors == 0 else 1


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(prog="python -m repro_torch.api.store")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("populate", help="build smoke configs into a store")
    p.add_argument("--root", default=None)
    p.add_argument("--rows", type=int, default=48)
    p.add_argument("--device", default=None,
                   help="the sessions' device (default: the CUDA card)")
    p = sub.add_parser("ls", help="list store entries")
    p.add_argument("--root", default=None)
    p = sub.add_parser("clear", help="delete every entry")
    p.add_argument("--root", default=None)
    args = ap.parse_args(argv)
    root = args.root or default_store_root()
    if args.cmd == "populate":
        return _populate(root, args.rows, resolve_device(args.device))
    store = PlanStore(root)
    if args.cmd == "clear":
        store.clear()
    for path in sorted(store._entry_files()):
        try:
            header, payloads = read_container(path)
            env = header["envelope"]
            print(f"{os.path.basename(path)}  "
                  f"{os.path.getsize(path)}B  "
                  f"payloads={sorted(payloads)}  "
                  f"torch={env['torch']}  "
                  f"device={env['device_name']}  "
                  f"nodes={header['meta']['node_count']}")
        except Exception as e:
            print(f"{os.path.basename(path)}  INVALID ({e})")
    print(json.dumps(store.stats(), indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
