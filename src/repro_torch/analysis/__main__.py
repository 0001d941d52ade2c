"""``python -m repro_torch.analysis`` — run the static passes from the shell.

Subcommands::

    python -m repro_torch.analysis dis spec.json [--engine E] [--audit] [-v]
                                                 [--device D]
    python -m repro_torch.analysis demo [--join] [--engine E] [--audit] [-v]
                                        [--device D]
    python -m repro_torch.analysis store [--root PATH]

``dis`` loads a DIS JSON spec (:func:`repro_torch.core.rml.load_dis`),
plans it through the soundness-gated optimizer, verifies the optimized
plan against its exact annotations and prints the annotated dump with the
verdict; ``--audit`` additionally compiles the single-device closure
(:func:`repro_torch.plan.compile.compile_plan`) and runs it once on the
DIS's sources under :func:`~repro_torch.analysis.audit_closure`. ``demo``
does the same on a built-in synthetic DIS (``--join`` picks the two-map
join spec). ``--device`` places the sources: the CUDA card by default, as
every port entry point, or ``cpu``. ``store`` integrity- and shape-checks
every entry of a persistent plan store (:mod:`repro_torch.api.store`;
``--root`` defaults to :func:`~repro_torch.api.store.default_store_root`)
without adopting any: container checksums, the port's envelope, the
node-indexed metadata (a mesh entry's shard layout and exchanges too) and
the session-key payload. Exit status is
non-zero iff any check failed.
"""
from __future__ import annotations

import argparse
import functools
import sys


def _check_dis(dis, engine: str, audit: bool, verbose: bool) -> int:
    from repro_torch.core.rdfizer import RDFizer
    from repro_torch.plan.annotate import annotate
    from repro_torch.plan.compile import compile_plan
    from repro_torch.plan.explain import dump_plan
    from repro_torch.plan.lower import lower
    from repro_torch.relalg import host_int

    from .audit import audit_closure, expected_host_reads
    from .soundness import RewriteSoundnessError, checked_optimize
    from .verify import verify_plan

    plan = lower(dis)
    try:
        checked_optimize(plan)
    except RewriteSoundnessError as e:
        print(e)
        return 1
    counts, caps = annotate(plan, mode="exact", sources=dis.sources)
    report = verify_plan(plan, engine, counts=counts, caps=caps)
    if verbose:
        print(dump_plan(plan, engine, counts=counts, caps=caps,
                        schemas=report.schemas, verdict=report.describe()))
    else:
        print(report.describe())
    status = 0 if report.ok else 1
    if audit and report.ok:
        # the emitter reads the rewritten maps (Rule 3 renames merged ones)
        view = dis.copy()
        view.maps = list(plan.maps)
        dedup = "hash" if engine == "sdm" else None
        emitter = RDFizer(view, engine, join_caps={}, dedup=dedup)
        fn = compile_plan(plan, emitter, engine=engine, dedup=dedup,
                          caps=caps, report_overflow=True)

        def step(sources):
            kg, raw, over = fn(sources)
            return kg, raw, host_int(over)

        audit_report = audit_closure(
            step, (dis.sources,), plan=plan, engine=engine,
            single_device=True,
            expected_host_reads=functools.partial(expected_host_reads, plan,
                                                  engine, dedup))
        print(audit_report.describe())
        status = status or (0 if audit_report.ok else 1)
    return status


def _check_mesh_meta(meta) -> None:
    """A mesh entry's shard layout: every field present, the capacities
    positive, the sink slack at least 1, and one well-formed exchange per
    ⋈ index."""
    missing = [k for k in ("out_cap_local", "sink_slack", "safe_exchange",
                           "exchanges") if k not in meta]
    if missing:
        raise ValueError(f"mesh meta missing keys {missing}")
    caps = list(meta["cap_locals"].values()) + [meta["out_cap_local"]]
    if any(int(c) <= 0 for c in caps):
        raise ValueError("non-positive shard-local capacity")
    if float(meta["sink_slack"]) < 1.0:
        raise ValueError(f"sink slack {meta['sink_slack']} below 1")
    idxs = []
    for x in meta["exchanges"]:
        if len(x) not in (7, 8) or x[1] not in ("gather", "repartition"):
            raise ValueError(f"malformed exchange {x!r}")
        idxs.append(int(x[0]))
    if any(i < 0 or i >= int(meta["node_count"]) for i in idxs) or \
            len(set(idxs)) != len(idxs):
        raise ValueError("exchange node index out of range or repeated")


def _check_store(root) -> int:
    import os

    from repro_torch.api.store import (FRAMEWORK, SESSION_KEY, PlanStore,
                                       default_store_root, read_container)
    store = PlanStore(root or default_store_root())
    required = ("node_count", "engine", "mode", "counts", "caps",
                "build_seconds")
    bad = 0
    entries = sorted(store._entry_files())
    for path in entries:
        name = os.path.basename(path)
        try:
            header, payloads = read_container(path)
            framework = header.get("envelope", {}).get("framework")
            if framework != FRAMEWORK:
                raise ValueError(f"envelope framework {framework!r}, not "
                                 f"{FRAMEWORK!r}")
            meta = header.get("meta", {})
            missing = [k for k in required if k not in meta]
            if missing:
                raise ValueError(f"meta missing keys {missing}")
            for field in ("counts", "caps"):
                pairs = meta[field]
                idxs = [i for i, _ in pairs]
                if any(i >= int(meta["node_count"]) or i < 0 for i in idxs):
                    raise ValueError(
                        f"{field} node index out of range "
                        f"(node_count={meta['node_count']})")
                if len(set(idxs)) != len(idxs):
                    raise ValueError(f"duplicate node index in {field}")
                if any(int(v) < 0 for _, v in pairs):
                    raise ValueError(f"negative value in {field}")
            if "cap_locals" in meta:
                _check_mesh_meta(meta)
            if not payloads.get(SESSION_KEY):
                raise ValueError("entry has no session-key payload")
            print(f"{name}  ok  ({len(payloads)} payload(s), "
                  f"{int(meta['node_count'])} nodes"
                  f"{', mesh' if 'cap_locals' in meta else ''})")
        except Exception as e:
            bad += 1
            print(f"{name}  INVALID ({e})")
    print(f"{len(entries)} entr{'y' if len(entries) == 1 else 'ies'}, "
          f"{bad} invalid")
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.analysis")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("dis", help="verify a DIS JSON spec end to end")
    p.add_argument("spec", help="path to the DIS JSON file")
    p.add_argument("--engine", choices=("rmlmapper", "sdm"),
                   default="rmlmapper")
    p.add_argument("--audit", action="store_true",
                   help="also run the compiled closure under the auditor")
    p.add_argument("-v", "--verbose", action="store_true",
                   help="print the fully annotated plan dump")
    p.add_argument("--device", default=None,
                   help="device of the sources (default: the CUDA card)")

    p = sub.add_parser("demo", help="verify a built-in synthetic DIS")
    p.add_argument("--join", action="store_true",
                   help="use the two-map join spec instead of group B")
    p.add_argument("--engine", choices=("rmlmapper", "sdm"),
                   default="rmlmapper")
    p.add_argument("--audit", action="store_true")
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default=None)

    p = sub.add_parser("store", help="integrity-check a plan store")
    p.add_argument("--root", default=None)

    args = ap.parse_args(argv)
    if args.cmd == "store":
        return _check_store(args.root)
    from repro_torch.device import resolve_device
    device = resolve_device(args.device)
    if args.cmd == "dis":
        from repro_torch.core.rml import load_dis
        dis = load_dis(args.spec, device=device)
    else:
        from repro_torch.data.synthetic import fig5_join_dis, make_group_b_dis
        dis = (fig5_join_dis(device=device) if args.join else
               make_group_b_dis(48, 0.6, seed=0, device=device))
    return _check_dis(dis, args.engine, args.audit, args.verbose)


if __name__ == "__main__":
    sys.exit(main())
