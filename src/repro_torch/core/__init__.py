"""MapSDI — mapping-rule-driven semantic data integration: the DIS model,
the RML subset, the static rule analysis, relational pre-processing (Rules
1–3), the RDFizer engine and the T-framework baseline."""
from .schema import (DIS, PredicateObjectMap, RDF_TYPE, RefObjectMap,
                     Selection, TMPL_BASE, TMPL_CONSTANT, TMPL_LITERAL,
                     TermMap, TRIPLE_ATTRS, TripleMap)
from .rml import dump_maps, load_dis, parse_dis, parse_triple_map
from .analyze import merge_groups, referenced_attrs
from .transform import TransformStats, apply_mapsdi, apply_mapsdi_eager, \
    apply_merge, apply_projection, plan_mapsdi, shrink_to_fit
from .rdfizer import RDFizer, plan_join_caps, rdfize, triples_to_ntriples
from .tframework import make_t_framework_fn, t_framework_create_kg
from .pipeline import make_mapsdi_fn, make_planned_fn, mapsdi_create_kg

__all__ = [
    "DIS", "PredicateObjectMap", "RDF_TYPE", "RefObjectMap", "Selection",
    "TMPL_BASE", "TMPL_CONSTANT", "TMPL_LITERAL", "TermMap", "TRIPLE_ATTRS",
    "TripleMap", "dump_maps", "load_dis", "parse_dis", "parse_triple_map",
    "merge_groups", "referenced_attrs", "TransformStats", "apply_mapsdi",
    "apply_mapsdi_eager", "apply_merge", "apply_projection", "plan_mapsdi",
    "shrink_to_fit", "RDFizer", "plan_join_caps", "rdfize",
    "triples_to_ntriples", "make_t_framework_fn", "t_framework_create_kg",
    "make_mapsdi_fn", "make_planned_fn", "mapsdi_create_kg",
]
