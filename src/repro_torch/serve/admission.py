"""Admission control: bounded queues, recompile-storm backpressure, typed
rejections.

The front door NEVER drops a request silently. Every ``submit`` returns
exactly one of two typed outcomes, decided synchronously at the door:

* a :class:`Ticket` — the request is queued; its :class:`IngestResult`
  (or error) arrives via ``ticket.result()`` once the micro-batcher
  flushes it;
* an :class:`Overloaded` — the request is shed *now*, with the reason
  (``"queue_full"`` | ``"recompile_storm"``), the queue depth observed,
  and a ``retry_after_s`` hint. Nothing was enqueued; the caller owns the
  retry.

Two watermarks implement "shed or delay, never lose":

* ``max_queue`` — the hard high-water: at this many queued requests the
  door sheds regardless of engine state (bounded memory, bounded tail
  latency).
* ``storm_queue`` — the low-water that applies only while a *recompile
  storm* is active: the worker just hit an engine recompile (a capacity
  bucket crossing or an overflow rebuild — seconds of host annotation
  and closure building during which the queue can only grow), reported
  via :meth:`note_recompile`.
  For ``stall_window_s`` after the last recompile the door admits only up
  to ``storm_queue`` queued requests, shedding the overflow with
  ``"recompile_storm"`` — load the queue merely *delays* under normal
  operation is shed early when the service is provably stalled.

Framework-free: a copy of the reference's ``repro.serve.admission`` (the
port imports nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from typing import Dict, Mapping, Optional


@dataclasses.dataclass(frozen=True)
class IngestResult:
    """Outcome of one accepted request after its flush completed."""

    tenant_id: str
    kg_triples: int          # tenant KG size after the flush
    latency_s: float         # submit → result (queueing + batching + run)
    ingest_s: float          # the engine.ingest wall time of the flush
    batched_requests: int    # requests coalesced into the same flush
    recompiles: int          # tenant-engine cumulative recompile count
    flush_id: int            # monotone per-front-door flush sequence no.


@dataclasses.dataclass(frozen=True)
class Overloaded:
    """Typed shed response — the request was NOT enqueued."""

    tenant_id: str
    reason: str              # "queue_full" | "recompile_storm"
    queue_depth: int         # depth observed at the door
    retry_after_s: float     # backoff hint (the flush window or the
    #                          remaining stall window, whichever applies)

    def __bool__(self) -> bool:
        # `if not response:` reads as "was the request shed?" at call
        # sites that only branch on acceptance
        return False


class Ticket:
    """Handle for one accepted request; resolved by the worker."""

    __slots__ = ("tenant_id", "enqueued_at", "_event", "_result", "_error")

    def __init__(self, tenant_id: str, enqueued_at: float):
        self.tenant_id = tenant_id
        self.enqueued_at = enqueued_at
        self._event = threading.Event()
        self._result: Optional[IngestResult] = None
        self._error: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> IngestResult:
        """Block until the flush lands; raises the flush's exception if
        it failed, ``TimeoutError`` if ``timeout`` elapses first."""
        if not self._event.wait(timeout):
            raise TimeoutError(
                f"request for tenant {self.tenant_id!r} not flushed within "
                f"{timeout}s")
        if self._error is not None:
            raise self._error
        assert self._result is not None
        return self._result

    # -- worker side ---------------------------------------------------------
    def resolve(self, result: IngestResult) -> None:
        self._result = result
        self._event.set()

    def fail(self, error: BaseException) -> None:
        self._error = error
        self._event.set()


class AdmissionController:
    """The door's admit/shed decision + storm bookkeeping (thread-safe).

    ``clock`` is injectable for deterministic tests (defaults to
    ``time.monotonic``).
    """

    def __init__(self, max_queue: int = 256,
                 storm_queue: Optional[int] = None,
                 stall_window_s: float = 0.25,
                 retry_after_s: float = 0.05,
                 clock=time.monotonic):
        if max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = int(max_queue)
        # default low-water: a quarter of the hard limit (min 1 so a calm
        # storm window still admits work and drains itself)
        self.storm_queue = (max(1, self.max_queue // 4)
                            if storm_queue is None else int(storm_queue))
        if not 0 <= self.storm_queue <= self.max_queue:
            raise ValueError(
                f"storm_queue must be in [0, max_queue], got "
                f"{self.storm_queue} vs max_queue={self.max_queue}")
        self.stall_window_s = float(stall_window_s)
        self.retry_after_s = float(retry_after_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._storm_until = float("-inf")
        self.recompile_stalls = 0      # recompiles reported by the worker
        self.sheds: Dict[str, int] = {"queue_full": 0, "recompile_storm": 0}

    # -- worker side ---------------------------------------------------------
    def note_recompile(self, count: int = 1,
                       now: Optional[float] = None) -> None:
        """The worker observed ``count`` engine recompiles during a flush:
        open (or extend) the storm window."""
        if count <= 0:
            return
        now = self._clock() if now is None else now
        with self._lock:
            self.recompile_stalls += count
            self._storm_until = max(self._storm_until,
                                    now + self.stall_window_s)

    def in_storm(self, now: Optional[float] = None) -> bool:
        now = self._clock() if now is None else now
        with self._lock:
            return now < self._storm_until

    # -- door side -----------------------------------------------------------
    def admit(self, tenant_id: str, queue_depth: int,
              now: Optional[float] = None) -> Optional[Overloaded]:
        """``None`` to admit; an :class:`Overloaded` (already counted) to
        shed. ``queue_depth`` is the depth *before* this request."""
        now = self._clock() if now is None else now
        with self._lock:
            storming = now < self._storm_until
            if queue_depth >= self.max_queue:
                reason = "queue_full"
            elif storming and queue_depth >= self.storm_queue:
                reason = "recompile_storm"
            else:
                return None
            self.sheds[reason] += 1
            retry = (max(self._storm_until - now, self.retry_after_s)
                     if reason == "recompile_storm" else self.retry_after_s)
        return Overloaded(tenant_id=tenant_id, reason=reason,
                          queue_depth=queue_depth, retry_after_s=retry)

    def stats(self) -> Mapping[str, object]:
        with self._lock:
            return {"max_queue": self.max_queue,
                    "storm_queue": self.storm_queue,
                    "stall_window_s": self.stall_window_s,
                    "in_storm": self._clock() < self._storm_until,
                    "recompile_stalls": self.recompile_stalls,
                    "sheds": dict(self.sheds)}
