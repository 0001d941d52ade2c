"""KGQuery: BGP queries over the device-resident KG.

The read-side counterpart of the creation pipeline, built from the same
relational IR, annotation and plan-cache machinery. The public spec types
re-export from :mod:`repro_torch.api`; the compilation entry points live
here:

* :class:`Query` / :class:`TriplePattern` / :class:`QueryFilter` — the BGP
  spec (:mod:`repro_torch.query.spec`, also the query cache-key module).
* :func:`lower_query` — spec → IR DAG (:mod:`repro_torch.query.lower`).
* :func:`annotate_query` / :func:`annotate_query_local` — capacity
  annotation (:mod:`repro_torch.query.annotate`).
* :func:`compile_query` / :func:`compile_query_mesh` — the single-device
  closure and the per-rank mesh closure.

Served by :meth:`repro_torch.api.KGEngine.query`.
"""
from .annotate import annotate_query, annotate_query_local
from .compile import compile_query
from .lower import QueryPlan, lower_query, query_scan
from .mesh import compile_query_mesh, query_mesh_abstract_inputs
from .spec import (KG_SOURCE, Query, QueryFilter, TriplePattern,
                   query_session_key)

__all__ = [
    "KG_SOURCE",
    "Query",
    "QueryFilter",
    "QueryPlan",
    "TriplePattern",
    "annotate_query",
    "annotate_query_local",
    "compile_query",
    "compile_query_mesh",
    "lower_query",
    "query_mesh_abstract_inputs",
    "query_scan",
    "query_session_key",
]
