"""Public session API for MapSDI knowledge-graph creation and querying::

    from repro_torch.api import EngineConfig, KGEngine, PlanStore, Query

    engine = KGEngine(dis, config=EngineConfig(engine="sdm", dedup="hash"))
    kg, stats = engine.create_kg()
    kg, stats = engine.ingest(delta_sources)
    answers = engine.query(Query(patterns=[...]))

:class:`Query` (with :class:`TriplePattern` / :class:`QueryFilter`)
re-exports from :mod:`repro_torch.query`; :class:`Calibration` (the
measured-bandwidth cost model fed to ``EngineConfig(calibrate=...)``) from
:mod:`repro_torch.launch.mesh`; the persistent plan store from
:mod:`repro_torch.api.store`.

The multi-tenant streaming surface (:class:`~repro_torch.serve.FrontDoor`,
:class:`~repro_torch.serve.Overloaded`, …) lives in
:mod:`repro_torch.serve` and is re-exported here lazily, as in the
reference: ``repro_torch.serve.frontdoor`` imports this package, so the
names resolve on first attribute access (PEP 562) instead of at import
time.
"""
from repro_torch.launch.mesh import Calibration
from repro_torch.query import Query, QueryFilter, TriplePattern

from .cache import (PLAN_CACHE, CachedPlan, PlanCache, clear_plan_cache,
                    plan_cache_stats)
from .config import EngineConfig
from .engine import KGEngine
from .store import (PlanStore, default_store_root, resolve_store,
                    store_envelope, store_key)

# serve-tier names resolved lazily (repro_torch.serve.frontdoor imports
# this package, so an eager import here would be circular)
_SERVE_EXPORTS = (
    "FrontDoor", "IngestResult", "Overloaded", "SessionRegistry",
    "TenantSession", "Ticket", "percentile",
)

__all__ = [
    "CachedPlan", "Calibration", "EngineConfig", "KGEngine", "PLAN_CACHE",
    "PlanCache", "PlanStore", "Query", "QueryFilter", "TriplePattern",
    "clear_plan_cache", "default_store_root", "plan_cache_stats",
    "resolve_store", "store_envelope", "store_key", *_SERVE_EXPORTS,
]


def __getattr__(name: str):
    if name in _SERVE_EXPORTS:
        import repro_torch.serve as _serve
        return getattr(_serve, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_SERVE_EXPORTS))
