"""Public session API for MapSDI knowledge-graph creation::

    from repro_torch.api import EngineConfig, KGEngine

    engine = KGEngine(dis, config=EngineConfig(engine="sdm", dedup="hash"))
    kg, stats = engine.create_kg()
    kg, stats = engine.ingest(delta_sources)
"""
from .cache import PLAN_CACHE, CachedPlan, PlanCache, clear_plan_cache
from .config import EngineConfig
from .engine import KGEngine

__all__ = [
    "CachedPlan", "EngineConfig", "KGEngine", "PLAN_CACHE", "PlanCache",
    "clear_plan_cache",
]
