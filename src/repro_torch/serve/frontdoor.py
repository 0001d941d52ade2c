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
A configuration holding a mesh raises ``NotImplementedError`` (ROADMAP.md
Queue 1 item 7, the mesh remainder).
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


def _device_scope(device: torch.device):
    """The CUDA context of ``device`` for the calling thread (nothing to
    enter for the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


class FrontDoor:
    """Multi-tenant streaming ingest service over one device."""

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

    # -- tenant lifecycle ----------------------------------------------------
    def register(self, tenant_id: str, dis: DIS,
                 config: Optional[EngineConfig] = None) -> TenantSession:
        return self.registry.register(tenant_id, dis, config=config)

    def kg(self, tenant_id: str) -> Optional[Table]:
        """The tenant's KG Table from its latest flush (``None`` before
        the first one)."""
        return self.registry.get(tenant_id).last_kg

    # -- door (any thread) ---------------------------------------------------
    def submit(self, tenant_id: str,
               records: Records) -> Union[Ticket, Overloaded]:
        """Admit-or-shed, then enqueue. Raw records only — encoding into
        the tenant vocab happens on the worker thread at flush time."""
        session = self.registry.get(tenant_id)   # KeyError if unknown
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
        return self._pump(force=force)

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
            with _device_scope(engine.device):
                deltas = {
                    name: Table.from_records(recs,
                                             engine.sources[name].attrs,
                                             engine.vocab,
                                             device=engine.device)
                    for name, recs in merged.items() if recs}
                recompiles_before = engine.recompiles
                t0 = self._clock()
                if deltas:
                    kg, stats = engine.ingest(deltas)
                    session.last_kg = kg
                    session.kg_triples = int(stats["kg_triples"])
                ingest_s = self._clock() - t0
            stalls = engine.recompiles - recompiles_before
            if stalls:
                self.admission.note_recompile(stalls)
        except Exception as err:
            self._fail(session, taken, err)
            return 1
        now = self._clock()
        with self._lock:
            self._flush_id += 1
            flush_id = self._flush_id
            self.flushes += 1
            self.completed += len(taken)
        session.ingests += 1
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

    # -- lifecycle -----------------------------------------------------------
    def start(self) -> "FrontDoor":
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
        ``RuntimeError`` — never left dangling, never dropped silently."""
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
        self._thread = None

    def drain(self, timeout: float = 30.0) -> None:
        """Block until the queue is empty (worker mode) or flush it in
        place (synchronous mode)."""
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
        cache/store tiers, and a per-tenant breakdown."""
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
        return {
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
