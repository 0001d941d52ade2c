"""MapSDI Transformation Rules 1–3 as a symbolic fixpoint.

Rewrites ``DIS_G = <O, S, M>`` into ``DIS'_G = <O, S', M'>`` with
``RDFize(DIS) == RDFize(DIS')`` (set semantics) and less work for the
semantification engine:

* Rule 1 (projection of attributes) — join-free maps read a projected +
  deduplicated copy of their source restricted to the referenced attrs.
* Rule 2 (pushing projections into joins) — the same projection applied to
  the child and parent sources of join conditions.
* Rule 3 (merging sources with equivalent attributes) — join-free maps
  with equal heads over different sources merge into one map over the
  deduplicated union of their projected sources.

:func:`plan_mapsdi` runs the rules (plus σ pushdown and CSE) as pure
rewrites of the logical IR (:mod:`repro_torch.plan`): no device work and
no host syncs until the plan is executed.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from .schema import DIS

__all__ = ["TransformStats", "plan_mapsdi"]


@dataclasses.dataclass
class TransformStats:
    rule1_applications: int = 0
    rule2_applications: int = 0
    rule3_merges: int = 0
    sigma_pushdowns: int = 0
    cse_shared_subplans: int = 0
    source_rows_before: Dict[str, int] = dataclasses.field(default_factory=dict)
    source_rows_after: Dict[str, int] = dataclasses.field(default_factory=dict)


def plan_mapsdi(dis: DIS, max_iters: int = 8,
                stats: Optional[TransformStats] = None):
    """Symbolic fixpoint: lower the DIS and run the optimizer (Rules 1–3 +
    σ pushdown + CSE) to convergence. Pure host-side rewriting — no device
    work, no host syncs. Returns the optimized
    :class:`~repro_torch.plan.lower.LogicalPlan`."""
    from repro_torch.plan.lower import lower
    from repro_torch.plan.optimize import optimize
    plan = lower(dis)
    pstats = optimize(plan, max_iters=max_iters)
    if stats is not None:
        stats.rule1_applications += pstats.rule1_applications
        stats.rule2_applications += pstats.rule2_applications
        stats.rule3_merges += pstats.rule3_merges
        stats.sigma_pushdowns += pstats.sigma_pushdowns
        stats.cse_shared_subplans += pstats.cse_shared_subplans
    return plan
