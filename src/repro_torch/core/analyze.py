"""Static analysis of mapping rules — the knowledge MapSDI extracts.

The paper's framework "extracts from the mapping rules information related to
the attributes that are used from each file" and detects rules that can be
merged. This module computes:

* :func:`referenced_attrs` — for every triple map, the attributes its
  evaluation touches in its own source (subject attr, object reference/
  template attrs, child join attrs) **plus** the attributes other maps pull
  from it via join conditions (its subject attr and the parent join attrs) —
  the set ``Z̄`` of the Rule-2 formalization.
* :func:`merge_groups` — maximal groups of join-free maps with equal heads
  (same subject template/class and same (predicate, object-signature) multi-
  set) over possibly different sources — the Rule-3 precondition.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Set, Tuple

from .schema import DIS, RefObjectMap, TermMap, TripleMap


def own_referenced_attrs(tm: TripleMap) -> Set[str]:
    """Attributes of ``tm.source`` used by ``tm`` itself."""
    attrs: Set[str] = set()
    if tm.subject.referenced_attr:
        attrs.add(tm.subject.referenced_attr)
    for pom in tm.poms:
        if isinstance(pom.object, RefObjectMap):
            attrs.add(pom.object.child_attr)
        elif pom.object.referenced_attr:
            attrs.add(pom.object.referenced_attr)
    for sel in tm.selections:
        attrs.add(sel.attr)
    return attrs


def incoming_join_attrs(dis: DIS, tm: TripleMap) -> Set[str]:
    """Attributes of ``tm.source`` that OTHER maps need from ``tm`` as a
    join parent: its subject attr + every parent join attr."""
    attrs: Set[str] = set()
    for other in dis.maps:
        for pom in other.poms:
            if isinstance(pom.object, RefObjectMap) and \
                    pom.object.parent_map == tm.name:
                attrs.add(pom.object.parent_attr)
                if tm.subject.referenced_attr:
                    attrs.add(tm.subject.referenced_attr)
    return attrs


def referenced_attrs(dis: DIS) -> Dict[str, Set[str]]:
    """map name -> full attribute set needed from its source (own + incoming)."""
    return {tm.name: own_referenced_attrs(tm) | incoming_join_attrs(dis, tm)
            for tm in dis.maps}


def head_signature(tm: TripleMap) -> Tuple:
    """Rule-3 equivalence key: subject template/class + sorted
    (predicate, object signature) tuple. Maps with joins or σ selections
    never merge (σ predicates reference source-specific attrs)."""
    if tm.has_join or tm.selections:
        return ("__nomerge__", tm.name)
    pom_sigs = tuple(sorted(
        (p.predicate,) + p.object.signature() for p in tm.poms))
    return (tm.subject.signature(), tm.subject_class, pom_sigs)


def merge_groups(dis: DIS) -> List[List[TripleMap]]:
    """Groups of >=2 maps sharing a head — candidates for Rule 3."""
    groups: Dict[Tuple, List[TripleMap]] = defaultdict(list)
    for tm in dis.maps:
        groups[head_signature(tm)].append(tm)
    return [g for key, g in groups.items()
            if len(g) >= 2 and key[0] != "__nomerge__"]


def sorted_reference_poms(tm: TripleMap) -> List[Tuple[int, TermMap]]:
    """Reference-kind POMs in canonical (predicate, signature) order, with
    their original indices — used to align attrs across merged maps."""
    entries = [(i, p) for i, p in enumerate(tm.poms)
               if isinstance(p.object, TermMap)]
    entries.sort(key=lambda e: (e[1].predicate,) + e[1].object.signature())
    return [(i, p.object) for i, p in entries]
