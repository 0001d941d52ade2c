"""Serving-side observability primitives: percentiles + latency windows.

:func:`percentile` is the port's one latency-quantile implementation —
the linear-interpolation estimator (numpy's default ``"linear"``
method), shared by :meth:`repro_torch.serve.FrontDoor.serve_stats`'s
windows and ``repro_torch.launch.kg_serve``. Index arithmetic such as
``int(len(lat) * 0.99)`` returns the MAX for any sample count ≤ 100 and
a biased median for even N; this helper interpolates instead. It is the
reference's (``repro.serve.stats``) in a copy of its own: the port
imports nothing of the JAX package.

:class:`LatencyWindow` is a bounded ring of recent latency samples with
cheap quantile snapshots — one per tenant plus one global window inside
the front door.
"""
from __future__ import annotations

import math
from collections import deque
from typing import Deque, Dict, Iterable, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """The ``q``-th percentile (``0 ≤ q ≤ 100``) of ``values`` by linear
    interpolation between closest ranks — numpy's default method, so
    ``percentile(v, q) == numpy.percentile(v, q)`` up to float rounding.

    ``values`` need not be pre-sorted (a sorted copy is taken; callers
    holding an already-sorted list pay one ``O(n)`` verification-free
    ``sorted`` pass). Raises ``ValueError`` on an empty sample or an
    out-of-range ``q`` — serving stats must never silently fabricate a
    latency.
    """
    if not 0.0 <= q <= 100.0:
        raise ValueError(f"percentile q must be in [0, 100], got {q!r}")
    vals = sorted(float(v) for v in values)
    if not vals:
        raise ValueError("percentile of an empty sample")
    rank = (len(vals) - 1) * (q / 100.0)
    lo = math.floor(rank)
    hi = min(lo + 1, len(vals) - 1)
    frac = rank - lo
    return vals[lo] * (1.0 - frac) + vals[hi] * frac


class LatencyWindow:
    """Bounded ring of the most recent latency samples (seconds).

    ``maxlen`` bounds memory for long-running front doors; quantiles are
    computed over whatever the window currently holds (the *recent*
    latency distribution — what an operator dashboards, not the lifetime
    one). ``total`` keeps the lifetime sample count."""

    def __init__(self, maxlen: int = 4096):
        self._ring: Deque[float] = deque(maxlen=int(maxlen))
        self.total = 0

    def record(self, seconds: float) -> None:
        self._ring.append(float(seconds))
        self.total += 1

    def extend(self, seconds: Iterable[float]) -> None:
        for s in seconds:
            self.record(s)

    def __len__(self) -> int:
        return len(self._ring)

    def snapshot(self) -> Dict[str, float]:
        """``{count, total, p50_s, p99_s, max_s}`` over the window —
        all-zero quantiles when no sample has landed yet (an empty
        window is a real serving state, not an error)."""
        if not self._ring:
            return {"count": 0, "total": self.total,
                    "p50_s": 0.0, "p99_s": 0.0, "max_s": 0.0}
        vals = list(self._ring)
        return {"count": len(vals), "total": self.total,
                "p50_s": percentile(vals, 50.0),
                "p99_s": percentile(vals, 99.0),
                "max_s": max(vals)}
