"""Markdown tables from the port's dry-run and roofline records.

The port's counterpart of the reference's ``launch/report.py``: it reads
``experiments/dryrun_torch/`` and ``experiments/roofline_torch/``
(``launch/dryrun.py``, ``launch/roofline.py``) and the reference's
benchmark records under ``experiments/bench/``, and renders the
reference's tables; :func:`inject` replaces the marked blocks of a
markdown file.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.report            # print
    PYTHONPATH=src python -m repro_torch.launch.report --inject FILE.md
"""
from __future__ import annotations

import glob
import json
import os
import sys
from typing import Dict, List, Optional

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "..",
                    "..", "experiments")
DRYRUN_DIR, ROOFLINE_DIR = "dryrun_torch", "roofline_torch"


def load_dir(dirname: str, root: str = ROOT) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(root, dirname, "*.json"))):
        with open(path) as f:
            out.append(json.load(f))
    return out


def dryrun_table(records: List[Dict]) -> str:
    head = ("| arch | shape | mesh | status | args+temp GiB/dev | "
            "collective MiB/step | trace s |\n"
            "|---|---|---|---|---|---|---|\n")
    rows = []
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"],
                                            r["mesh"])):
        if r.get("status") == "ok":
            mem = r["memory"]
            per = (mem.get("argument_size_in_bytes", 0)
                   + mem.get("temp_size_in_bytes", 0)) / 2**30
            coll = r["collectives"]["total_bytes"] / 2**20
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | ok | "
                        f"{per:.2f} | {coll:.1f} | "
                        f"{r.get('trace_seconds', 0):.0f} |")
        elif r.get("status") == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"skip ({r.get('reason', '')}) | — | — | — |")
        else:
            rows.append(f"| {r['arch']} | {r['shape']} | {r['mesh']} | "
                        f"ERROR | — | — | — |")
    return head + "\n".join(rows) + "\n"


def roofline_table(records: List[Dict]) -> str:
    head = ("| arch | shape | compute s | memory s | collective s | "
            "dominant | useful/HLO | roofline frac | lever |\n"
            "|---|---|---|---|---|---|---|---|---|\n")
    rows = []
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"])):
        if r.get("status") == "skip":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | skip |"
                        " — | — | — |")
            continue
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | ERROR | | | | | |"
                        " |")
            continue
        t = r["terms_seconds"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.2e} | "
            f"{t['memory_s']:.2e} | {t['collective_s']:.2e} | "
            f"{r['dominant'].replace('_s', '')} | "
            f"{r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2%} | {r['suggestion'][:60]}… |")
    return head + "\n".join(rows) + "\n"


def bench_summary(root: str = ROOT) -> str:
    out = []
    for name in ("group_a", "group_b", "table1", "motivating"):
        path = os.path.join(root, "bench", f"{name}.json")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            rows = json.load(f)
        if not rows:
            continue
        keys = list(rows[0])
        out.append(f"**{name}**\n")
        out.append("| " + " | ".join(keys) + " |")
        out.append("|" + "---|" * len(keys))
        for r in rows:
            out.append("| " + " | ".join(str(r.get(k, "")) for k in keys)
                       + " |")
        out.append("")
    return "\n".join(out) + "\n"


def inject(md_path: str, root: str = ROOT) -> None:
    """Replace the blocks between ``<!-- DRYRUN:BEGIN -->`` and ``<!--
    DRYRUN:END -->`` (and ROOFLINE, BENCH) in ``md_path`` with the tables
    of the records under ``root``."""
    with open(md_path) as f:
        text = f.read()

    def repl(tag: str, body: str, t: str) -> str:
        b, e = f"<!-- {tag}:BEGIN -->", f"<!-- {tag}:END -->"
        i, j = t.index(b) + len(b), t.index(e)
        return t[:i] + "\n" + body + t[j:]

    text = repl("DRYRUN", dryrun_table(load_dir(DRYRUN_DIR, root)), text)
    text = repl("ROOFLINE", roofline_table(load_dir(ROOFLINE_DIR, root)),
                text)
    text = repl("BENCH", bench_summary(root), text)
    with open(md_path, "w") as f:
        f.write(text)
    print(f"injected tables into {md_path}")


def main(argv: Optional[List[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--inject"] and len(argv) == 2:
        inject(os.path.abspath(argv[1]))
        return
    print(dryrun_table(load_dir(DRYRUN_DIR)))
    print(roofline_table(load_dir(ROOFLINE_DIR)))


if __name__ == "__main__":
    main()
