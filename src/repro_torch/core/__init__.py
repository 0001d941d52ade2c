"""MapSDI — mapping-rule-driven semantic data integration: the DIS model,
the RML subset, the static rule analysis, the symbolic Rules 1–3 and the
RDFizer engine."""
from .schema import (DIS, PredicateObjectMap, RDF_TYPE, RefObjectMap,
                     Selection, TMPL_BASE, TMPL_CONSTANT, TMPL_LITERAL,
                     TermMap, TRIPLE_ATTRS, TripleMap)
from .rml import parse_dis, parse_triple_map
from .analyze import merge_groups, referenced_attrs
from .transform import TransformStats, plan_mapsdi
from .rdfizer import RDFizer, plan_join_caps

__all__ = [
    "DIS", "PredicateObjectMap", "RDF_TYPE", "RefObjectMap", "Selection",
    "TMPL_BASE", "TMPL_CONSTANT", "TMPL_LITERAL", "TermMap", "TRIPLE_ATTRS",
    "TripleMap", "parse_dis", "parse_triple_map",
    "merge_groups", "referenced_attrs", "TransformStats", "plan_mapsdi",
    "RDFizer", "plan_join_caps",
]
