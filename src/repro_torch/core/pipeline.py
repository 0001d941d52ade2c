"""End-to-end MapSDI pipeline entry points — thin wrappers over the
session API.

The one front door is :class:`repro_torch.api.KGEngine` (cached plans,
incremental ingestion, overflow-safe re-execution). ``mapsdi_create_kg``
remains the one-shot convenience (Fig. 2 in one call);
``make_planned_fn`` / ``make_mapsdi_fn`` are **deprecated** shims kept for
source compatibility — they delegate to a ``KGEngine`` session and warn
once per process. Unlike the historical closures, the shims inherit the
engine's overflow safety: re-running on grown extensions recompiles
instead of silently truncating. Each session runs on the device of the
DIS's sources.
"""
from __future__ import annotations

import warnings
from typing import Dict, Optional, Tuple

from repro_torch.relalg import Table

from .rdfizer import Engine
from .schema import DIS
from .transform import apply_mapsdi

_WARNED: set = set()


def _warn_once(name: str, replacement: str) -> None:
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(
        f"{name} is deprecated; use repro_torch.api.KGEngine — "
        f"{replacement}", DeprecationWarning, stacklevel=3)


def mapsdi_create_kg(dis: DIS, engine: Engine = "sdm",
                     dedup: Optional[str] = None,
                     ) -> Tuple[Table, Dict[str, object]]:
    """Plan + execute once; returns (KG, stats incl. Table-1-style sizes).

    Delegates to a fresh :class:`repro_torch.api.KGEngine` session, so
    repeated calls over structurally-identical DISes hit the shared plan
    cache: on a hit the capacity annotation (the host pass over the
    sources) and the closure build are skipped and no longer counted in
    ``preprocess_seconds`` — only the cheap symbolic re-plan that derives
    the cache key remains — and the stats carry the session's
    ``recompiles`` / ``plan_cache_hit`` counters. ``dedup`` selects the δ
    strategy (``"lex"`` | ``"hash"``) for both the planned Rule 1–3
    pre-processing and the engine sinks; None = engine default.
    """
    from repro_torch.api import EngineConfig, KGEngine
    config = EngineConfig(engine=engine, dedup=dedup)
    return KGEngine(dis, config=config, device=dis.device).create_kg()


def make_planned_fn(dis: DIS, engine: Engine = "sdm",
                    dedup: Optional[str] = None):
    """DEPRECATED: use ``KGEngine(dis).run`` (or ``.ingest``).

    .. deprecated:: removal target — this shim goes away together with the
       other ``repro_torch.core.pipeline``/``rdfize`` compatibility
       wrappers; no in-repo caller uses it outside its own tests.

    Returns ``(fn, plan)`` where ``fn(raw_sources) -> (kg, raw)`` executes
    the session's cached closure — steady-state re-execution over
    *untransformed* source extensions. Via the engine, the closure is
    overflow-safe: extensions that outgrow the plan-time capacities
    trigger one transparent rebuild instead of silent truncation."""
    _warn_once("make_planned_fn",
               "engine = KGEngine(dis); engine.run(sources)")
    from repro_torch.api import EngineConfig, KGEngine
    eng = KGEngine(dis, config=EngineConfig(engine=engine, dedup=dedup),
                   device=dis.device)
    return eng.run, eng.plan


def make_mapsdi_fn(dis: DIS, engine: Engine = "sdm",
                   dedup: Optional[str] = None):
    """DEPRECATED: use ``apply_mapsdi`` + ``KGEngine`` (or just
    ``KGEngine(dis)``).

    .. deprecated:: removal target — scheduled for deletion with
       ``make_planned_fn`` and ``rdfize`` (see the note there); migrate to
       ``apply_mapsdi`` + ``KGEngine(dis2, config=EngineConfig(...))``.

    Pre-transform once (planning + one materialization), return a semantify
    closure over the *transformed* sources — the historical steady-state
    shape, where pre-processed extensions exist as concrete tables."""
    _warn_once("make_mapsdi_fn",
               "dis2, _ = apply_mapsdi(dis); engine = KGEngine(dis2)")
    from repro_torch.api import EngineConfig, KGEngine
    dis2, _ = apply_mapsdi(dis, dedup=dedup)
    eng = KGEngine(dis2, config=EngineConfig(engine=engine, dedup=dedup),
                   device=dis2.device)

    def fn(sources: Optional[Dict[str, Table]] = None):
        return eng.run(dis2.sources if sources is None else sources)

    return fn, dis2
