"""The multi-tenant streaming front door.

One :class:`FrontDoor` multiplexes many tenant
:class:`~repro_torch.api.KGEngine` sessions onto one device (the CUDA card
unless ``device="cpu"`` is passed):

* **registration** — each tenant brings its own DIS; structurally
  identical DISes share compiled closures through the process-wide plan
  cache (K compiles for T tenants — :mod:`repro_torch.serve.registry`);
* **submission** — ``submit(tenant_id, records)`` is the only hot-path
  entry. It runs admission control and either enqueues the raw records
  behind a :class:`~repro_torch.serve.admission.Ticket` or sheds them with a
  typed :class:`~repro_torch.serve.admission.Overloaded`. It never encodes,
  never touches a vocab, never blocks on the device;
* **flushing** — a single worker thread owns ALL engine work (KGEngine
  sessions are not thread-safe). It coalesces each tenant's pending
  requests into one ``engine.ingest`` per flush window
  (:mod:`repro_torch.serve.batcher`), encodes records with the tenant's vocab
  at that point, and resolves tickets with per-request
  :class:`~repro_torch.serve.admission.IngestResult`\\ s;
* **backpressure** — the worker reports engine recompiles to the
  admission controller, which tightens the queue watermark for a stall
  window (:mod:`repro_torch.serve.admission`). Nothing is ever dropped
  silently: every submit gets a Ticket or an Overloaded, and ``stop``
  either drains the queue or *fails* the remaining tickets loudly.

Synchronous mode: tests and benchmarks may skip ``start()`` and call
``pump(force=True)`` from their own thread — same code path, no timer
jitter. Mixing both is rejected (``pump`` raises while a worker runs).

Device discipline (the port's additions): records are encoded straight
onto the session's device (``Table.from_records(..., device=
engine.device)``), and the worker runs each flush under that device's
CUDA context, since the current device is per thread. A ticket's
``latency_s`` ends after the device work without a sync of the door's
own: ``engine.ingest`` ends in counted host reads of the KG's count.

**Over a mesh** (a configuration holding a
:class:`repro_torch.launch.mesh.Mesh`; the port's mesh is SPMD, one
process per rank, where the reference's is one process over every
device): every rank builds a ``FrontDoor`` with the same configuration
and registers the same tenants in the same order. Rank 0 is the
*leader*: it alone runs admission, the batcher, the flush timer and the
worker, and it alone holds tickets. Each flush is a command the leader
broadcasts on the mesh's group (one ``broadcast_object_list``: the
sequence number, the tenant and its coalesced records in order); the
other ranks run :meth:`FrontDoor.follow`, which executes the commands in
order and returns when the leader broadcasts stop. Every rank encodes the
same records in the same order, so the tenants' vocabularies stay in
step; the ranks agree that every rank encoded its records before the
ingest, and agree on the tenant's vocab size after it (outside the
audited call). A follower that fails to encode fails the flush's tickets
on the leader, naming the rank, and the group goes on; a failure inside
the ingest's collectives breaks the group, and the leader then fails
every ticket it holds. All group traffic of a rank comes from one thread:
on the leader, the worker while one runs, else the caller (``register``
after ``start()`` raises on a mesh door).
"""
from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict, List, Mapping, Optional, Sequence, Union

import torch

from repro_torch.api.cache import PLAN_CACHE
from repro_torch.api.config import EngineConfig
from repro_torch.core.schema import DIS
from repro_torch.device import DeviceLike
from repro_torch.relalg.table import Table

from .admission import AdmissionController, IngestResult, Overloaded, Ticket
from .batcher import MicroBatcher, PendingRequest
from .registry import SessionRegistry, TenantSession
from .stats import LatencyWindow

Records = Mapping[str, Sequence[Mapping[str, object]]]

#: the ranks' status codes in the flush agreements
_OK, _FAILED = 0, 1


class FlushSkipped(RuntimeError):
    """A rank of a mesh front door failed before the flush's collectives,
    so every rank skipped the flush (the leader fails its tickets with
    this error); the group goes on."""


def _device_scope(device: torch.device):
    """The CUDA context of ``device`` for the calling thread (nothing to
    enter for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class FrontDoor:
    """Multi-tenant streaming ingest service over one device, or over a
    mesh as leader (rank 0) and followers (see the module docstring)."""

    def __init__(self, config: Optional[EngineConfig] = None, *,
                 device: DeviceLike = None,
                 flush_window: float = 0.01,
                 max_batch_rows: int = 4096,
                 max_queue: int = 256,
                 storm_queue: Optional[int] = None,
                 stall_window_s: float = 0.25,
                 latency_window: int = 4096,
                 clock=time.monotonic):
        self.registry = SessionRegistry(default_config=config,
                                        latency_window=latency_window,
                                        device=device)
        self.batcher = MicroBatcher(flush_window=flush_window,
                                    max_batch_rows=max_batch_rows,
                                    clock=clock)
        self.admission = AdmissionController(max_queue=max_queue,
                                             storm_queue=storm_queue,
                                             stall_window_s=stall_window_s,
                                             clock=clock)
        self.latencies = LatencyWindow(latency_window)
        self._clock = clock
        self._lock = threading.Lock()          # counters only
        self.accepted = 0
        self.rejected = 0
        self.completed = 0
        self.errors = 0
        self.flushes = 0
        self._flush_id = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()
        # the mesh: rank 0 leads; the commands a rank has run; the error
        # that broke the group (no more commands are sent after it)
        self.mesh = self.registry.mesh
        self.leader = self.mesh is None or self.mesh.rank == 0
        self.commands = 0
        self._broken: Optional[BaseException] = None
        self._stopped = False

    # -- tenant lifecycle ----------------------------------------------------
    def register(self, tenant_id: str, dis: DIS,
                 config: Optional[EngineConfig] = None) -> TenantSession:
        """Register a tenant's DIS. On a mesh door every rank registers
        the same tenants in the same order (a session's start is a
        collective), before ``start()`` and ``follow()``."""
        if self.mesh is not None and (self._thread is not None
                                      or self._stopped):
            raise RuntimeError(
                "register every tenant of a mesh front door before start() "
                "or follow(): registration runs collectives, and a rank's "
                "group traffic comes from one thread")
        return self.registry.register(tenant_id, dis, config=config)

    def kg(self, tenant_id: str) -> Optional[Table]:
        """The tenant's KG Table from its latest flush (``None`` before
        the first one)."""
        return self.registry.get(tenant_id).last_kg

    # -- door (any thread) ---------------------------------------------------
    def submit(self, tenant_id: str,
               records: Records) -> Union[Ticket, Overloaded]:
        """Admit-or-shed, then enqueue. Raw records only — encoding into
        the tenant vocab happens on the worker thread at flush time. On a
        mesh, only the leader (rank 0) takes requests."""
        session = self.registry.get(tenant_id)   # KeyError if unknown
        if not self.leader:
            raise RuntimeError("submit to the leader of a mesh front door "
                               "(rank 0); the other ranks run follow()")
        depth = self.batcher.depth()
        shed = self.admission.admit(tenant_id, depth)
        if shed is not None:
            session.rejected += 1
            with self._lock:
                self.rejected += 1
            return shed
        ticket = Ticket(tenant_id, self._clock())
        self.batcher.add(tenant_id, records, ticket)
        session.requests += 1
        with self._lock:
            self.accepted += 1
        self._wake.set()
        return ticket

    # -- worker --------------------------------------------------------------
    def pump(self, force: bool = False) -> int:
        """Flush every due tenant once; returns the number of flushes.
        This is the worker loop body — callable directly only while no
        worker thread runs (synchronous mode)."""
        if (self._thread is not None and self._thread.is_alive()
                and threading.current_thread() is not self._thread):
            raise RuntimeError("pump() while the worker thread is running "
                               "— engines are single-threaded; use the "
                               "worker or synchronous mode, not both")
        self._leader_only("pump")
        return self._pump(force=force)

    def _leader_only(self, what: str) -> None:
        if not self.leader:
            raise RuntimeError(f"{what}() runs on the leader of a mesh "
                               "front door (rank 0); the other ranks run "
                               "follow()")

    def _pump(self, force: bool = False) -> int:
        n = 0
        for tenant_id in self.batcher.due(force=force):
            n += self._flush(tenant_id)
        return n

    def _pump_until_empty(self) -> int:
        """Force-flush until nothing is queued. One forced pump flushes
        each tenant once, and a flush takes at most ``max_batch_rows`` of
        requests (at least one), so a drain repeats it — the reference
        drains with one pump and leaves the rest queued (ROADMAP.md
        Queue 3)."""
        n = 0
        while True:
            k = self._pump(force=True)
            if not k:
                return n
            n += k

    def _flush(self, tenant_id: str) -> int:
        session = self.registry.get(tenant_id)
        taken, merged = self.batcher.pop_batch(tenant_id)
        if not taken:
            return 0
        engine = session.engine
        try:
            if self._broken is not None:
                raise RuntimeError("the mesh front door's group broke "
                                   "earlier") from self._broken
            if self.mesh is not None:
                self._broadcast(("flush", self.commands, tenant_id, merged))
            recompiles_before = engine.recompiles
            ingest_s = self._apply(session, merged)
            stalls = engine.recompiles - recompiles_before
            if stalls:
                self.admission.note_recompile(stalls)
        except Exception as err:
            if self.mesh is not None and not isinstance(err, FlushSkipped):
                self._broken = self._broken or err
            self._fail(session, taken, err)
            return 1
        now = self._clock()
        with self._lock:
            self._flush_id += 1
            flush_id = self._flush_id
            self.completed += len(taken)
        session.rows += sum(r.rows for r in taken)
        for req in taken:
            latency = now - req.enqueued_at
            session.latencies.record(latency)
            self.latencies.record(latency)
            req.ticket.resolve(IngestResult(
                tenant_id=tenant_id,
                kg_triples=session.kg_triples,
                latency_s=latency,
                ingest_s=ingest_s,
                batched_requests=len(taken),
                recompiles=engine.recompiles,
                flush_id=flush_id))
        return 1

    def _encode(self, session: TenantSession, merged) -> Dict[str, Table]:
        """The flush's records as tables in the tenant's vocab, on its
        session's device."""
        engine = session.engine
        return {name: Table.from_records(recs, engine.sources[name].attrs,
                                         engine.vocab, device=engine.device)
                for name, recs in merged.items() if recs}

    def _apply(self, session: TenantSession, merged) -> float:
        """One flush's device work on this rank: encode, ingest, and on a
        mesh the two agreements around the ingest. Returns the ingest's
        seconds; counts the flush on the tenant and the door. On a mesh,
        any failure but a skipped flush (:class:`FlushSkipped`) breaks
        the group: its peers may sit in a collective this rank left."""
        engine = session.engine
        interned = len(engine.vocab)
        with _device_scope(engine.device):
            try:
                deltas = self._encode(session, merged)
                status = _OK
            except Exception:
                if self.mesh is None:
                    raise
                deltas, status = {}, _FAILED
            try:
                if self.mesh is not None:
                    try:
                        self._agree_encoded(status)
                    except FlushSkipped:
                        # the values this rank interned for the dropped
                        # rows go too, so the vocabs stay in step
                        engine.vocab.truncate(interned)
                        raise
                t0 = self._clock()
                if deltas:
                    kg, stats = engine.ingest(deltas)
                    session.last_kg = kg
                    session.kg_triples = int(stats["kg_triples"])
                ingest_s = self._clock() - t0
                if self.mesh is not None:
                    from repro_torch.launch.mesh import agree
                    agree(self.mesh, engine.mesh_axis, (len(engine.vocab),),
                          what=f"tenant {session.tenant_id!r}'s vocab size "
                          "after a flush")
            except FlushSkipped:
                raise
            except Exception as err:
                if self.mesh is not None:
                    self._broken = self._broken or err
                raise
        session.ingests += 1
        with self._lock:
            self.flushes += 1
        return ingest_s

    def _agree_encoded(self, status: int) -> None:
        """Every rank encoded the flush's records (one agreement before
        the ingest's collectives); raise :class:`FlushSkipped`, naming
        the ranks, if one did not — every rank then skips the flush
        together and the group goes on."""
        from repro_torch.launch.mesh import gather_values
        rows = gather_values(self.mesh, self.registry.default_config
                             .mesh_axis, (status,))
        bad = [r for r, row in enumerate(rows) if int(row[0]) != _OK]
        if bad:
            raise FlushSkipped(f"rank(s) {bad} of the mesh front door "
                               "failed to encode the flush's records; "
                               "every rank skipped the flush")

    def _broadcast(self, command) -> object:
        """One command from the leader to every rank (the leader passes
        it, the others get it back)."""
        import torch.distributed as dist
        box = [command]
        dist.broadcast_object_list(
            box, src=0, group=self.mesh.group_for(
                self.registry.default_config.mesh_axis))
        self.commands += 1
        return box[0]

    def follow(self) -> int:
        """A follower's loop (every rank but 0 of a mesh door): run the
        leader's commands in order until it broadcasts stop. Returns the
        flushes run. A command that fails on this rank raises out of the
        loop, unless it failed before the ingest's collectives (then the
        leader fails the flush's tickets and the loop goes on)."""
        if self.mesh is None or self.leader:
            raise RuntimeError("follow() runs on the ranks other than 0 of "
                               "a mesh front door")
        self._stopped = True
        while True:
            command = self._broadcast(None)
            kind = command[0]
            if kind == "stop":
                return self.flushes
            _, seq, tenant_id, merged = command
            if seq != self.commands - 1:
                raise RuntimeError(f"command {seq} arrived as this rank's "
                                   f"{self.commands - 1}")
            session = self.registry.get(tenant_id)
            try:
                self._apply(session, merged)
            except FlushSkipped:
                session.errors += 1

    def _release_followers(self) -> None:
        """Broadcast stop (the leader, once), so every follow() returns."""
        if self.mesh is None or not self.leader or self._stopped:
            return
        self._stopped = True
        if self._broken is None:
            self._broadcast(("stop",))

    def _fail(self, session: TenantSession,
              taken: List[PendingRequest], err: BaseException) -> None:
        session.errors += 1
        with self._lock:
            self.errors += len(taken)
        for req in taken:
            req.ticket.fail(err)

    def _worker(self) -> None:
        while not self._stop.is_set():
            self._pump()
            deadline = self.batcher.next_deadline()
            # park until new work arrives or the oldest request is due
            self._wake.wait(timeout=deadline
                            if deadline is not None else 0.05)
            self._wake.clear()
        self._pump_until_empty()   # drain everything still queued
        self._release_followers()  # the worker's group traffic ends here

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FrontDoor":
        self._leader_only("start")
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("front door already started")
        self._stop.clear()
        self._thread = threading.Thread(target=self._worker,
                                        name="frontdoor-worker", daemon=True)
        self._thread.start()
        return self

    def stop(self, drain: bool = True, timeout: float = 30.0) -> None:
        """Stop the worker. With ``drain`` the queue is flushed first;
        without it the remaining tickets are *failed* with a
        ``RuntimeError`` — never left dangling, never dropped silently. On
        a mesh door (the leader) the followers are released last."""
        self._leader_only("stop")
        thread = self._thread
        if thread is not None and thread.is_alive():
            if not drain:
                # pull the queue out from under the worker, then fail it
                pending = self.batcher.drain_tickets()
                err = RuntimeError("front door stopped before flush")
                for req in pending:
                    req.ticket.fail(err)
                with self._lock:
                    self.errors += len(pending)
            self._stop.set()
            self._wake.set()
            thread.join(timeout=timeout)
            if thread.is_alive():
                raise RuntimeError("front door worker did not stop in "
                                   f"{timeout}s")
        elif drain:
            self._pump_until_empty()
        else:
            pending = self.batcher.drain_tickets()
            err = RuntimeError("front door stopped before flush")
            for req in pending:
                req.ticket.fail(err)
            with self._lock:
                self.errors += len(pending)
        self._release_followers()
        self._thread = None

    def drain(self, timeout: float = 30.0) -> None:
        """Block until the queue is empty (worker mode) or flush it in
        place (synchronous mode)."""
        self._leader_only("drain")
        if self._thread is not None and self._thread.is_alive():
            deadline = self._clock() + timeout
            while self.batcher.depth():
                if self._clock() > deadline:
                    raise TimeoutError(f"queue not drained in {timeout}s")
                self._wake.set()
                time.sleep(0.001)
        else:
            self._pump_until_empty()

    # -- observability -------------------------------------------------------
    def serve_stats(self) -> Dict[str, object]:
        """One self-describing snapshot: global counters, compile-dedup
        ratio, admission/backpressure state, latency quantiles, plan
        cache/store tiers, and a per-tenant breakdown; on a mesh door also
        ``mesh``: this rank's role, the commands it ran and its sessions'
        mesh counters (on a follower the counters are the flushes it
        ran)."""
        sessions = self.registry.sessions()
        dedup = self.registry.compile_dedup()
        store_hits = store_misses = 0
        plan_store = None
        for s in sessions:
            est = s.engine.stats()
            store_hits += int(est["store_hits"])
            store_misses += int(est["store_misses"])
            if plan_store is None and est["plan_store"] is not None:
                plan_store = est["plan_store"]
        with self._lock:
            counters = {"accepted": self.accepted,
                        "rejected": self.rejected,
                        "completed": self.completed,
                        "errors": self.errors,
                        "flushes": self.flushes}
        out = {
            "tenants": dedup["tenants"],
            "shapes": dedup["shapes"],
            "compiles": dedup["compiles"],
            "compile_dedup_ratio": dedup["ratio"],
            "queue_depth": self.batcher.depth(),
            **counters,
            "recompile_stalls": self.admission.recompile_stalls,
            "admission": self.admission.stats(),
            "latency": self.latencies.snapshot(),
            "plan_cache": PLAN_CACHE.stats(),
            "plan_store_hits": store_hits,
            "plan_store_misses": store_misses,
            "plan_store": plan_store,
            "per_tenant": {
                s.tenant_id: {
                    "shape_id": s.shape_id,
                    "requests": s.requests,
                    "rejected": s.rejected,
                    "ingests": s.ingests,
                    "rows": s.rows,
                    "errors": s.errors,
                    "kg_triples": s.kg_triples,
                    "queue_depth": self.batcher.depth(s.tenant_id),
                    "recompiles": s.engine.recompiles,
                    "latency": s.latencies.snapshot(),
                } for s in sessions},
        }
        if self.mesh is not None:
            out["mesh"] = {
                "rank": self.mesh.rank,
                "role": "leader" if self.leader else "follower",
                "commands": self.commands,
                "broken": None if self._broken is None
                else f"{type(self._broken).__name__}: {self._broken}",
                "sessions": {s.tenant_id: s.engine.stats()["mesh"]
                             for s in sessions}}
        return out
