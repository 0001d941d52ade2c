"""Per-tenant micro-batching of ingest deltas.

Each accepted request carries raw *records* (``source name → list of
attribute dicts``) — NOT encoded tables. Encoding interns strings into
the tenant's vocab, and vocabs are engine-session state owned by the
worker thread, so the door must not touch them; it only appends the rows
to the tenant's pending deque. At flush time the worker coalesces every
pending request for a tenant into ONE ``engine.ingest`` call: per-source
record lists are concatenated in arrival order (vocab interning order —
and hence the final KG's dictionary codes — depends only on that order,
which is what makes multi-tenant serving bit-identical to a dedicated
session fed the same stream).

A tenant becomes *due* when its oldest pending request has waited
``flush_window`` seconds, or its pending rows reach ``max_batch_rows``
(whichever first). The window trades latency for coalescing: a larger
window folds more requests into one device execution.

Framework-free: a copy of the reference's ``repro.serve.batcher`` (the
port imports nothing of the JAX package).
"""
from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Mapping, Optional, Sequence, Tuple

from .admission import Ticket


@dataclasses.dataclass
class PendingRequest:
    """One accepted request waiting in a tenant's queue."""

    ticket: Ticket
    records: Mapping[str, Sequence[Mapping[str, object]]]
    rows: int
    enqueued_at: float


class MicroBatcher:
    """Bounded-ish per-tenant queues + the due/pop flush policy.

    Thread-safety: the door thread calls :meth:`add` / :meth:`depth`;
    the worker thread calls :meth:`due` / :meth:`pop_batch`. One lock
    guards the deques; all engine work happens outside it.
    """

    def __init__(self, flush_window: float = 0.01,
                 max_batch_rows: int = 4096,
                 clock=time.monotonic):
        if flush_window < 0:
            raise ValueError(f"flush_window must be >= 0, got {flush_window}")
        if max_batch_rows < 1:
            raise ValueError(
                f"max_batch_rows must be >= 1, got {max_batch_rows}")
        self.flush_window = float(flush_window)
        self.max_batch_rows = int(max_batch_rows)
        self._clock = clock
        self._lock = threading.Lock()
        self._queues: Dict[str, Deque[PendingRequest]] = {}
        self._depth = 0           # total queued requests across tenants

    # -- door side -----------------------------------------------------------
    def add(self, tenant_id: str,
            records: Mapping[str, Sequence[Mapping[str, object]]],
            ticket: Ticket) -> int:
        """Enqueue an accepted request; returns the new global depth."""
        rows = sum(len(v) for v in records.values())
        req = PendingRequest(ticket=ticket, records=records, rows=rows,
                             enqueued_at=ticket.enqueued_at)
        with self._lock:
            self._queues.setdefault(tenant_id, deque()).append(req)
            self._depth += 1
            return self._depth

    def depth(self, tenant_id: Optional[str] = None) -> int:
        with self._lock:
            if tenant_id is None:
                return self._depth
            q = self._queues.get(tenant_id)
            return len(q) if q else 0

    # -- worker side ---------------------------------------------------------
    def due(self, now: Optional[float] = None,
            force: bool = False) -> List[str]:
        """Tenant ids whose queues should flush now: oldest request older
        than the flush window, pending rows at/over ``max_batch_rows``, or
        everything non-empty when ``force`` (drain/stop)."""
        now = self._clock() if now is None else now
        out: List[str] = []
        with self._lock:
            for tid, q in self._queues.items():
                if not q:
                    continue
                if force or (now - q[0].enqueued_at) >= self.flush_window:
                    out.append(tid)
                    continue
                if sum(r.rows for r in q) >= self.max_batch_rows:
                    out.append(tid)
        return out

    def next_deadline(self, now: Optional[float] = None) -> Optional[float]:
        """Seconds until the earliest pending request becomes due — the
        worker's idle sleep bound. ``None`` when nothing is queued."""
        now = self._clock() if now is None else now
        with self._lock:
            oldest = min((q[0].enqueued_at for q in self._queues.values()
                          if q), default=None)
        if oldest is None:
            return None
        return max(0.0, self.flush_window - (now - oldest))

    def pop_batch(self, tenant_id: str
                  ) -> Tuple[List[PendingRequest],
                             Dict[str, List[Mapping[str, object]]]]:
        """Dequeue the tenant's pending requests (respecting
        ``max_batch_rows``, but always at least one request) and coalesce
        their records per source, arrival order preserved."""
        taken: List[PendingRequest] = []
        with self._lock:
            q = self._queues.get(tenant_id)
            rows = 0
            while q:
                nxt = q[0]
                if taken and rows + nxt.rows > self.max_batch_rows:
                    break
                taken.append(q.popleft())
                rows += nxt.rows
            self._depth -= len(taken)
        merged: Dict[str, List[Mapping[str, object]]] = {}
        for req in taken:
            for name, recs in req.records.items():
                merged.setdefault(name, []).extend(recs)
        return taken, merged

    def drain_tickets(self) -> List[PendingRequest]:
        """Remove and return EVERY queued request (stop paths fail them
        explicitly rather than leaving callers blocked — no silent drop)."""
        with self._lock:
            out = [req for q in self._queues.values() for req in q]
            for q in self._queues.values():
                q.clear()
            self._depth = 0
        return out
