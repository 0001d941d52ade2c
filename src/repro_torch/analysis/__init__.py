"""Static plan verification: the compile-time complement of the
differential test harness. Three passes, as in the reference
(``repro.analysis``):

1. :func:`verify_plan` — schema-typed IR checking over the plan DAG;
2. :func:`soundness_gate` / :func:`checked_optimize` — per-rewrite
   lossless-precondition gates over the optimizer fixpoint;
3. :func:`audit_closure` — one recorded run of a compiled closure: host
   syncs against the counted reads the plan implies, collectives against
   the exchange plan, and dtype stability.

``python -m repro_torch.analysis`` exposes the passes as a CLI over a DIS
JSON spec or the built-in demo DIS.
"""
from .audit import (AuditReport, ClosureAuditError, audit_closure,
                    expected_collectives, expected_host_reads,
                    expected_query_collectives)
from .soundness import (CONTRACTS, RewriteSoundnessError, checked_optimize,
                        soundness_gate)
from .verify import (Diagnostic, NodeSchema, PlanVerificationError,
                     VerifyReport, verify_plan, verify_query_plan)

__all__ = [
    "AuditReport", "ClosureAuditError", "audit_closure",
    "expected_collectives", "expected_query_collectives", "CONTRACTS",
    "RewriteSoundnessError", "checked_optimize", "soundness_gate",
    "Diagnostic", "NodeSchema", "PlanVerificationError", "VerifyReport",
    "verify_plan", "verify_query_plan", "expected_host_reads",
]
