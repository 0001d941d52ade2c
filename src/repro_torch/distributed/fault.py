"""Fault tolerance: failure injection, restart policy, straggler watch.

On a real pod, failures arrive as lost hosts / ICI timeouts and the
runtime restarts the job from the last checkpoint, possibly on fewer
nodes (elastic). This module implements the *control plane* of that story
so it can be exercised end-to-end in tests and examples (numpy only:
the JAX package's module, kept as its own copy by the port):

* :class:`FailureInjector` — deterministic (seeded) step-level failure
  schedule; raises :class:`SimulatedFailure` mid-loop.
* :class:`RestartPolicy` + :func:`run_with_restarts` — the supervisor:
  catches failures, restores from the latest checkpoint (optionally onto
  a *different* mesh via the ``remesh`` hook = elastic scaling), replays.
* :class:`StragglerMonitor` — per-host step-time EMA; hosts slower than
  ``threshold`` x median are flagged; :meth:`shard_weights` feeds the data
  pipeline so slow hosts receive proportionally fewer examples (straggler
  mitigation by load shedding rather than sync barriers).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np


class SimulatedFailure(RuntimeError):
    """Injected node failure (host lost, ICI timeout, preemption...)."""


# ---------------------------------------------------------------------------
# failure injection
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FailureInjector:
    """Raises at deterministic steps: either an explicit schedule or a
    seeded Bernoulli per step (probability ``p``). Each failure fires once
    — after a restart the same step passes (crash-consistency is the
    checkpoint's job, not the injector's)."""

    schedule: Sequence[int] = ()
    p: float = 0.0
    seed: int = 0
    max_failures: int = 10

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)
        self._fired: set = set()
        self._count = 0

    def maybe_fail(self, step: int) -> None:
        if self._count >= self.max_failures:
            return
        want = step in self.schedule
        if not want and self.p > 0.0 and step not in self._fired:
            # hash-seeded draw: deterministic per (seed, step)
            r = np.random.default_rng((self.seed, step)).random()
            want = r < self.p
        if want and step not in self._fired:
            self._fired.add(step)
            self._count += 1
            raise SimulatedFailure(f"injected failure at step {step}")


# ---------------------------------------------------------------------------
# restart supervisor
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RestartPolicy:
    max_restarts: int = 5
    backoff_seconds: float = 0.0      # real pods back off; tests use 0
    restore_on_start: bool = True


@dataclasses.dataclass
class RestartReport:
    restarts: int = 0
    failures: List[Tuple[int, str]] = dataclasses.field(default_factory=list)
    resumed_from: List[Optional[int]] = dataclasses.field(
        default_factory=list)


def run_with_restarts(loop: Callable[[Optional[int]], Any],
                      policy: RestartPolicy = RestartPolicy(),
                      on_restart: Optional[Callable[[int], None]] = None
                      ) -> Tuple[Any, RestartReport]:
    """Supervise ``loop(resume_step)``: run until it returns; on
    :class:`SimulatedFailure` invoke ``on_restart`` (e.g. remesh for
    elastic scaling) and call the loop again — it is responsible for
    restoring from its checkpoint manager. Raises after
    ``policy.max_restarts`` failures (the paged-in-human case)."""
    report = RestartReport()
    attempt = 0
    while True:
        try:
            result = loop(None if attempt == 0 else attempt)
            return result, report
        except SimulatedFailure as e:
            attempt += 1
            report.restarts += 1
            report.failures.append((attempt, str(e)))
            if attempt > policy.max_restarts:
                raise
            if policy.backoff_seconds:
                time.sleep(policy.backoff_seconds)
            if on_restart is not None:
                on_restart(attempt)


# ---------------------------------------------------------------------------
# straggler monitor
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StragglerMonitor:
    """EMA of per-host step durations; flags and down-weights stragglers.

    ``observe`` is called with per-host wall times for one step (on a real
    pod these come from the per-host heartbeat); ``stragglers()`` returns
    hosts whose EMA exceeds ``threshold`` x the median EMA; and
    ``shard_weights()`` converts inverse EMAs into data-shard weights the
    pipeline uses to rebalance (slow host -> fewer rows)."""

    n_hosts: int
    alpha: float = 0.2
    threshold: float = 1.5

    def __post_init__(self):
        self._ema = np.zeros(self.n_hosts, dtype=np.float64)
        self._seen = np.zeros(self.n_hosts, dtype=bool)

    def observe(self, times: Sequence[float]) -> None:
        t = np.asarray(times, dtype=np.float64)
        if t.shape != (self.n_hosts,):
            raise ValueError(f"expected {self.n_hosts} host times")
        fresh = ~self._seen
        self._ema[fresh] = t[fresh]
        self._ema[~fresh] = (self.alpha * t[~fresh]
                             + (1 - self.alpha) * self._ema[~fresh])
        self._seen[:] = True

    @property
    def ema(self) -> np.ndarray:
        return self._ema.copy()

    def stragglers(self) -> List[int]:
        if not self._seen.any():
            return []
        med = float(np.median(self._ema[self._seen]))
        if med <= 0:
            return []
        return [i for i in range(self.n_hosts)
                if self._seen[i] and self._ema[i] > self.threshold * med]

    def shard_weights(self) -> np.ndarray:
        """Data-pipeline weights proportional to host speed (1/ema),
        normalized to sum to n_hosts (weight 1.0 = fair share)."""
        if not self._seen.all() or (self._ema <= 0).any():
            return np.ones(self.n_hosts)
        inv = 1.0 / self._ema
        return inv * (self.n_hosts / inv.sum())
