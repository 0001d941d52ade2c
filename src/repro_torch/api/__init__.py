"""Public session API for MapSDI knowledge-graph creation and querying::

    from repro_torch.api import EngineConfig, KGEngine, Query

    engine = KGEngine(dis, config=EngineConfig(engine="sdm", dedup="hash"))
    kg, stats = engine.create_kg()
    kg, stats = engine.ingest(delta_sources)
    answers = engine.query(Query(patterns=[...]))

:class:`Query` (with :class:`TriplePattern` / :class:`QueryFilter`)
re-exports from :mod:`repro_torch.query`.
"""
from repro_torch.query import Query, QueryFilter, TriplePattern

from .cache import PLAN_CACHE, CachedPlan, PlanCache, clear_plan_cache
from .config import EngineConfig
from .engine import KGEngine

__all__ = [
    "CachedPlan", "EngineConfig", "KGEngine", "PLAN_CACHE", "PlanCache",
    "Query", "QueryFilter", "TriplePattern", "clear_plan_cache",
]
