"""KGQuery: BGP queries over the device-resident KG.

The read-side counterpart of the creation pipeline, built from the same
relational IR, annotation and plan-cache machinery. The public spec types
re-export from :mod:`repro_torch.api`; the compilation entry points live
here:

* :class:`Query` / :class:`TriplePattern` / :class:`QueryFilter` — the BGP
  spec (:mod:`repro_torch.query.spec`, also the query cache-key module).
* :func:`lower_query` — spec → IR DAG (:mod:`repro_torch.query.lower`).
* :func:`annotate_query` — capacity annotation
  (:mod:`repro_torch.query.annotate`).
* :func:`compile_query` — the single-device closure.

Served by :meth:`repro_torch.api.KGEngine.query`. The mesh forms
(``annotate_query_local``, ``compile_query_mesh`` and
``query_mesh_abstract_inputs``) wait for the mesh queries (ROADMAP.md
Queue 1 item 7, the mesh remainder).
"""
from .annotate import annotate_query
from .compile import compile_query
from .lower import QueryPlan, lower_query, query_scan
from .spec import (KG_SOURCE, Query, QueryFilter, TriplePattern,
                   query_session_key)

__all__ = [
    "KG_SOURCE",
    "Query",
    "QueryFilter",
    "QueryPlan",
    "TriplePattern",
    "annotate_query",
    "compile_query",
    "lower_query",
    "query_scan",
    "query_session_key",
]
