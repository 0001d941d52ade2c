"""The paper's baseline: the traditional ("T-") framework.

Schema-level integration first (blind evaluation of all mapping rules), then
data-level integration (global duplicate elimination + cleaning) — the two
separated steps of the motivating example (Fig. 1). No pre-processing of the
sources happens; whatever duplicates the sources contain are materialized as
RDF triples and only removed at the sink. It runs on the device of the
DIS's sources.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

from repro_torch.relalg import Table
from repro_torch.relalg.guard import host_int

from .rdfizer import Engine, RDFizer
from .schema import DIS


def t_framework_create_kg(dis: DIS, engine: Engine = "rmlmapper",
                          dedup: Optional[str] = None
                          ) -> Tuple[Table, Dict[str, int]]:
    """RDFize the untransformed DIS; returns (KG, stats)."""
    rdfizer = RDFizer(dis, engine, dedup=dedup)
    kg, raw = rdfizer()
    return kg, {
        "raw_triples": host_int(raw),
        "kg_triples": host_int(kg.count),
        "source_rows": {k: host_int(v.count) for k, v in dis.sources.items()},
    }


def make_t_framework_fn(dis: DIS, engine: Engine = "rmlmapper",
                        dedup: Optional[str] = None):
    """Closure (sources -> (kg, raw)) for benchmarking."""
    rdfizer = RDFizer(dis, engine, dedup=dedup)

    def fn(sources: Optional[Dict[str, Table]] = None):
        return rdfizer(sources if sources is not None else dis.sources)

    return fn
