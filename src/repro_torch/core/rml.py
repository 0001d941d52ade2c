"""Parser/serializer for the RML subset MapSDI consumes.

The JSON form mirrors RML structure (rml:logicalSource, rr:subjectMap with
rr:template + rr:class, rr:predicateObjectMap with rml:reference /
rr:template / rr:constant objects, and rr:joinCondition +
rr:parentTriplesMap), e.g.::

    {
      "name": "TripleMap1",
      "source": "genes",
      "subject": {"template": "http://project-iasis.eu/Gene/{ENSG}",
                  "class": "iasis:Gene"},
      "poms": [
        {"predicate": "iasis:geneName", "object": {"reference": "SYMBOL"}},
        {"predicate": "iasis:locatedIn",
         "object": {"parentTriplesMap": "TripleMap2",
                    "joinCondition": {"child": "Genename",
                                      "parent": "Genename"}}}
      ]
    }

``parse_dis`` builds a full :class:`DIS` from ``{"sources": ..., "maps":
...}`` where each source is ``{"attrs": [...], "records": [...]}``.
"""
from __future__ import annotations

import json
import re
from typing import Dict, List, Mapping, Optional, Sequence

from repro_torch.device import DeviceLike
from repro_torch.relalg import Table, Vocab

from .schema import (DIS, PredicateObjectMap, RefObjectMap, Selection,
                     TermMap, TripleMap)

_TEMPLATE_VAR = re.compile(r"\{([^{}]+)\}")


def parse_term_map(obj: Mapping) -> TermMap:
    if "reference" in obj:
        return TermMap(kind="reference", attr=obj["reference"])
    if "template" in obj:
        tmpl = obj["template"]
        vars_ = _TEMPLATE_VAR.findall(tmpl)
        if len(vars_) != 1:
            raise ValueError(
                f"only single-placeholder templates supported, got {tmpl!r}")
        canonical = _TEMPLATE_VAR.sub("{}", tmpl)
        return TermMap(kind="template", attr=vars_[0], template=canonical)
    if "constant" in obj:
        return TermMap(kind="constant", constant=obj["constant"])
    raise ValueError(f"cannot parse term map {obj!r}")


def parse_selection(obj: Mapping) -> Selection:
    if "eq" in obj:
        return Selection(attr=obj["attr"], op="eq", value=obj["eq"])
    if "neq" in obj:
        return Selection(attr=obj["attr"], op="neq", value=obj["neq"])
    if obj.get("notnull"):
        return Selection(attr=obj["attr"], op="notnull")
    raise ValueError(f"cannot parse selection {obj!r}")


def parse_triple_map(obj: Mapping) -> TripleMap:
    subj_obj = dict(obj["subject"])
    subject_class = subj_obj.pop("class", None)
    subject = parse_term_map(subj_obj)
    poms = []
    for pom in obj.get("poms", ()):
        if "parentTriplesMap" in pom.get("object", {}):
            jc = pom["object"]["joinCondition"]
            o = RefObjectMap(parent_map=pom["object"]["parentTriplesMap"],
                             child_attr=jc["child"], parent_attr=jc["parent"])
        else:
            o = parse_term_map(pom["object"])
        poms.append(PredicateObjectMap(predicate=pom["predicate"], object=o))
    selections = tuple(parse_selection(s) for s in obj.get("selections", ()))
    return TripleMap(name=obj["name"], source=obj["source"], subject=subject,
                     subject_class=subject_class, poms=tuple(poms),
                     selections=selections)


def parse_dis(obj: Mapping, vocab: Optional[Vocab] = None,
              capacity_slack: float = 1.0, *,
              device: DeviceLike = None) -> DIS:
    """Build a DIS from the JSON form (sources with inline records)."""
    vocab = vocab or Vocab()
    sources: Dict[str, Table] = {}
    for name, src in obj["sources"].items():
        attrs = list(src["attrs"])
        records = src.get("records", [])
        cap = max(1, int(len(records) * capacity_slack))
        sources[name] = Table.from_records(records, attrs, vocab, cap,
                                           device=device)
    maps = [parse_triple_map(m) for m in obj["maps"]]
    null_code = vocab.intern(None) if any(
        rec.get(a) is None for src in obj["sources"].values()
        for rec in src.get("records", []) for a in src["attrs"]) else None
    dis = DIS(sources=sources, maps=maps, vocab=vocab, null_code=null_code)
    register_constants(dis)
    return dis


def load_dis(path: str, **kw) -> DIS:
    with open(path) as f:
        return parse_dis(json.load(f), **kw)


def register_constants(dis: DIS) -> None:
    """Pre-register templates and σ comparison codes deterministically,
    in map order."""
    vocab = dis.vocab
    for m in dis.maps:
        if m.subject.kind == "template":
            dis.template_id(m.subject.template)
        for p in m.poms:
            if isinstance(p.object, TermMap) and p.object.kind == "template":
                dis.template_id(p.object.template)
        for sel in m.selections:
            if sel.op in ("eq", "neq"):
                vocab.intern(sel.value)


# -- serialization (triple maps only; sources are data) ----------------------

def term_map_to_json(t: TermMap) -> Dict:
    if t.kind == "reference":
        return {"reference": t.attr}
    if t.kind == "template":
        return {"template": t.template.replace("{}", "{" + t.attr + "}")}
    return {"constant": t.constant}


def triple_map_to_json(m: TripleMap) -> Dict:
    subj = term_map_to_json(m.subject)
    if m.subject_class:
        subj["class"] = m.subject_class
    poms: List[Dict] = []
    for p in m.poms:
        if isinstance(p.object, RefObjectMap):
            obj = {"parentTriplesMap": p.object.parent_map,
                   "joinCondition": {"child": p.object.child_attr,
                                     "parent": p.object.parent_attr}}
        else:
            obj = term_map_to_json(p.object)
        poms.append({"predicate": p.predicate, "object": obj})
    out = {"name": m.name, "source": m.source, "subject": subj, "poms": poms}
    if m.selections:
        out["selections"] = [
            {"attr": s.attr, "notnull": True} if s.op == "notnull"
            else {"attr": s.attr, s.op: s.value} for s in m.selections]
    return out


def dump_maps(maps: Sequence[TripleMap]) -> str:
    return json.dumps([triple_map_to_json(m) for m in maps], indent=2)
