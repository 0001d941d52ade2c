"""Synthetic genomics-like testbeds with volume/redundancy dials.

Reproduces the *shape* of the paper's datasets (COSMIC mutations, CRG
protein-RNA interactions, GENCODE annotations): wide sources where a handful
of attributes carry a small number of distinct entities replicated across
many rows (transcripts per gene, samples per mutation, ...).

Dials match the experimental design of §4: ``volume`` scales row count
(25/50/75/100%), ``redundancy`` sets the fraction of duplicated rows
w.r.t. the projected attributes (25/50/75%).
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core import DIS, parse_dis
from repro_torch.device import DeviceLike


def _stable_hash(s: str) -> int:
    """Process-independent hash (builtin ``hash`` is salted per process,
    which would make generated KGs irreproducible across runs)."""
    return zlib.crc32(s.encode())


# ---------------------------------------------------------------------------
# paper figures (exact reconstructions, used in unit tests)
# ---------------------------------------------------------------------------

def fig4_gene_source() -> Tuple[List[Dict], List[str]]:
    """The 9-row gene file of Fig. 4a (8 attrs, 4 used by the map)."""
    rows = [
        # ENSG, ENSGV, SYMBOL, SYMBOLV, ENST, SPECIES, ACC
        ("ENSG00000187583", ".10", "PLEKHN1", "PLEKHN1-203", "ENST00000379410", "HUMAN", "Q494U1"),
        ("ENSG00000187583", ".10", "PLEKHN1", "PLEKHN1-202", "ENST00000379409", "HUMAN", "Q494U1"),
        ("ENSG00000187583", ".10", "PLEKHN1", "PLEKHN1-201", "ENST00000379407", "HUMAN", "Q494U1"),
        ("ENSG00000187642", ".9", "PERM1", "PERM1-202", "ENST00000341290", "HUMAN", "Q5SV97"),
        ("ENSG00000187642", ".9", "PERM1", "PERM1-203", "ENST00000433179", "HUMAN", "Q5SV97"),
        ("ENSG00000131591", ".17", "C1orf159", "C1orf159-204",
         "ENST00000379339", "HUMAN", "Q96HA4"),
        ("ENSG00000131591", ".17", "C1orf159", "C1orf159-203",
         "ENST00000379339", "HUMAN", "Q96HA4"),
        ("ENSG00000131591", ".17", "C1orf159", "C1orf159-205",
         "ENST00000379325", "HUMAN", "Q96HA4"),
        ("ENSG00000131591", ".17", "C1orf159", "C1orf159-201",
         "ENST00000421241", "HUMAN", "Q96HA4"),
    ]
    attrs = ["ID", "ENSG", "ENSGV", "SYMBOL", "SYMBOLV", "ENST", "SPECIES", "ACC"]
    records = [
        {"ID": i + 1, "ENSG": g, "ENSGV": g + v, "SYMBOL": s, "SYMBOLV": sv,
         "ENST": t, "SPECIES": sp, "ACC": a}
        for i, (g, v, s, sv, t, sp, a) in enumerate(rows)]
    return records, attrs


FIG3_MAP = {
    "name": "GeneMap", "source": "genes",
    "subject": {"template": "http://project-iasis.eu/Gene/{ENSG}",
                "class": "iasis:Gene"},
    "poms": [
        {"predicate": "iasis:geneName", "object": {"reference": "SYMBOL"}},
        {"predicate": "iasis:specieType", "object": {"reference": "SPECIES"}},
        {"predicate": "iasis:uniprotID", "object": {"reference": "ACC"}},
    ],
}


def fig5_join_dis(device: DeviceLike = None) -> DIS:
    """Fig. 5/6: two triple maps joined on Genename; 22 duplicate matches."""
    outer = [  # Genename, Biotype (+ unused attrs elided to HGNC only)
        ("STAT5B", 11367), ("STAT5B", 11367), ("STAT5B", 11367),
        ("STAT5B", 11367), ("STAT5B", 11367),
        ("KRAS", 6407), ("KRAS", 6407), ("KRAS", 6407),
        ("GAS7", 4169),
    ]
    inner = [  # Genename, Chromosome, Sample
        ("STAT5B", "chr17", "16857"), ("STAT5B", "chr17", "S52482"),
        ("STAT5B", "chr17", "1148969"),
        ("KRAS", "chr12", "CH-LA2"), ("KRAS", "chr12", "1559296"),
        ("EGFR", "chr7", "1479947"), ("EGFR", "chr7", "1544875"),
        ("GAS7", "chr17", "112146"),
    ]
    return parse_dis({
        "sources": {
            "gene": {"attrs": ["ID", "Genename", "HGNC", "Biotype"],
                     "records": [
                         {"ID": i + 1, "Genename": g, "HGNC": h,
                          "Biotype": "protein_coding"}
                         for i, (g, h) in enumerate(outer)]},
            "chrom": {"attrs": ["ID", "Genename", "Chromosome", "Sample"],
                      "records": [
                          {"ID": i + 1, "Genename": g, "Chromosome": c,
                           "Sample": s}
                          for i, (g, c, s) in enumerate(inner)]},
        },
        "maps": [
            {"name": "TripleMap1", "source": "gene",
             "subject": {"template": "http://project-iasis.eu/BioType/{Biotype}"},
             "poms": [{"predicate": "iasis:isRelatedTo",
                       "object": {"parentTriplesMap": "TripleMap2",
                                  "joinCondition": {"child": "Genename",
                                                    "parent": "Genename"}}}]},
            {"name": "TripleMap2", "source": "chrom",
             "subject": {"template": "http://project-iasis.eu/Chromosome/{Chromosome}",
                         "class": "iasis:Chromosome"},
             "poms": []},
        ],
    }, device=device)


# ---------------------------------------------------------------------------
# scalable generators (experiment groups A and B)
# ---------------------------------------------------------------------------

def _entity_pool(rng: np.random.Generator, n: int, prefix: str) -> np.ndarray:
    return np.array([f"{prefix}{i:08d}" for i in range(n)])


def make_group_a_dis(n_rows: int, redundancy: float, seed: int = 0,
                     n_noise_attrs: int = 8, *,
                     device: DeviceLike = None) -> DIS:
    """Three sources, each with the *same* concept (a transcript id) under a
    different attribute name plus noise attributes; one triple map per
    source with an identical head — the group-A setup (one concept, one
    attribute per source, Rule 3 applies).

    ``redundancy`` r => only (1-r)·n distinct transcript values per source.
    """
    rng = np.random.default_rng(seed)
    n_distinct = max(1, int(round(n_rows * (1.0 - redundancy))))
    pool = _entity_pool(rng, n_distinct, "ENST")
    names = ["enst", "downstream_gene", "transcript_id"]
    sources = {}
    for si, attr in enumerate(names):
        vals = pool[rng.integers(0, n_distinct, size=n_rows)]
        recs = []
        for i in range(n_rows):
            rec = {"ID": int(i), attr: str(vals[i])}
            for k in range(n_noise_attrs):
                rec[f"noise{k}"] = int(rng.integers(0, 50))
            recs.append(rec)
        sources[f"src{si}"] = {
            "attrs": ["ID", attr] + [f"noise{k}" for k in range(n_noise_attrs)],
            "records": recs}
    maps = [
        {"name": f"TM{si}", "source": f"src{si}",
         "subject": {"template": "http://project-iasis.eu/Transcript/{%s}" % attr,
                     "class": "iasis:Transcript"},
         "poms": []}
        for si, attr in enumerate(names)]
    return parse_dis({"sources": sources, "maps": maps}, device=device)


def make_group_b_dis(n_rows: int, redundancy: float = 0.75, seed: int = 0,
                     dedup_left: bool = False, dedup_right: bool = False, *,
                     device: DeviceLike = None) -> DIS:
    """Two sources joined by two triple maps (the group-B setup). The
    ``dedup_*`` flags pre-clean a source (the paper's scenarios a/b/c)."""
    rng = np.random.default_rng(seed)
    n_genes = max(1, int(round(n_rows * (1.0 - redundancy))))
    genes = _entity_pool(rng, n_genes, "GENE")
    bios = np.array(["protein_coding", "lncRNA", "miRNA", "snoRNA"])
    chroms = np.array([f"chr{i}" for i in range(1, 23)])

    gene_of_row = genes[rng.integers(0, n_genes, size=n_rows)]
    left = [{"ID": int(i), "Genename": str(g),
             "HGNC": int(rng.integers(1, 20000)),
             "enst": f"ENST{rng.integers(0, 10**8):08d}",
             "Biotype": str(bios[_stable_hash(g) % len(bios)])}
            for i, g in enumerate(gene_of_row)]
    gene_of_row_r = genes[rng.integers(0, n_genes, size=n_rows)]
    right = [{"ID": int(i), "Genename": str(g),
              "Chromosome": str(chroms[_stable_hash(g) % len(chroms)]),
              "Sample": f"S{rng.integers(0, 10**6):06d}"}
             for i, g in enumerate(gene_of_row_r)]

    def _dedup(recs, keys):
        seen, out = set(), []
        for r in recs:
            k = tuple(r[x] for x in keys)
            if k not in seen:
                seen.add(k)
                out.append(r)
        return out

    if dedup_left:
        left = _dedup(left, ["Genename", "Biotype"])
    if dedup_right:
        right = _dedup(right, ["Genename", "Chromosome"])

    return parse_dis({
        "sources": {
            "gene": {"attrs": ["ID", "Genename", "HGNC", "enst", "Biotype"],
                     "records": left},
            "chrom": {"attrs": ["ID", "Genename", "Chromosome", "Sample"],
                      "records": right},
        },
        "maps": [
            {"name": "TripleMap1", "source": "gene",
             "subject": {"template": "http://project-iasis.eu/BioType/{Biotype}",
                         "class": "iasis:BioType"},
             "poms": [{"predicate": "iasis:isRelatedTo",
                       "object": {"parentTriplesMap": "TripleMap2",
                                  "joinCondition": {"child": "Genename",
                                                    "parent": "Genename"}}}]},
            {"name": "TripleMap2", "source": "chrom",
             "subject": {"template": "http://project-iasis.eu/Chromosome/{Chromosome}",
                         "class": "iasis:Chromosome"},
             "poms": []},
        ],
    }, device=device)


def make_group_b_extension_records(n_rows: int, seed: int = 0,
                                   sources: Tuple[str, ...] = ("gene",
                                                               "chrom")
                                   ) -> Dict[str, List[Dict]]:
    """Extension rows shaped like :func:`make_group_b_dis`'s sources — new
    samples over shared gene-entity pools so join conditions keep matching.
    Encode them with the session's vocab via ``Table.from_records(recs,
    attrs, engine.vocab, device=...)``."""
    rng = np.random.default_rng(seed)
    bios = ["protein_coding", "lncRNA", "miRNA", "snoRNA"]
    chroms = [f"chr{i}" for i in range(1, 23)]
    pool = _entity_pool(rng, max(1, n_rows // 2), "GENE")
    out: Dict[str, List[Dict]] = {}
    if "gene" in sources:
        genes = pool[rng.integers(0, len(pool), size=n_rows)]
        out["gene"] = [
            {"ID": int(i), "Genename": str(g),
             "HGNC": int(rng.integers(1, 20000)),
             "enst": f"ENST{rng.integers(0, 10**8):08d}",
             "Biotype": bios[_stable_hash(str(g)) % len(bios)]}
            for i, g in enumerate(genes)]
    if "chrom" in sources:
        genes_r = pool[rng.integers(0, len(pool), size=n_rows)]
        out["chrom"] = [
            {"ID": int(i), "Genename": str(g),
             "Chromosome": chroms[_stable_hash(str(g)) % len(chroms)],
             "Sample": f"S{rng.integers(0, 10**6):06d}"}
            for i, g in enumerate(genes_r)]
    return out


def make_motivating_dis(n_rows: int = 2000, overlap: float = 0.9,
                        seed: int = 0, *, device: DeviceLike = None) -> DIS:
    """Fig. 1: three sources (mutations / downstream genes / drug
    resistances) that overlap heavily in the transcript they mention; blind
    semantification explodes into duplicates."""
    rng = np.random.default_rng(seed)
    n_shared = max(1, int(round(n_rows * 0.02)))
    pool = _entity_pool(rng, n_shared, "ENST")
    sources, maps = {}, []
    for si, attr in enumerate(["enst", "downstream_gene", "transcript_id"]):
        vals = pool[rng.integers(0, n_shared, size=n_rows)]
        recs = [{"ID": int(i), attr: str(vals[i]),
                 "extra": int(rng.integers(0, 10))} for i in range(n_rows)]
        sources[f"s{si}"] = {"attrs": ["ID", attr, "extra"], "records": recs}
        maps.append({
            "name": f"TM{si}", "source": f"s{si}",
            "subject": {"template": "http://project-iasis.eu/Transcript/{%s}" % attr,
                        "class": "iasis:Transcript"},
            "poms": []})
    return parse_dis({"sources": sources, "maps": maps}, device=device)
