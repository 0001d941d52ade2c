"""Multi-pod dry-run on a fake mesh of H100 ranks: trace the full matrix.

The port's counterpart of the reference's ``launch/dryrun.py``, which
lowers and compiles each cell for 512 placeholder TPU devices. Here each
(architecture x supported input shape x mesh) cell is traced once, in
this process, as rank 0 of a fake world of 512 ranks
(``launch/mesh.py::make_production_mesh``: ``torch.distributed``'s
``"fake"`` backend, collectives that move nothing): the step's inputs
are fake tensors (``FakeTensorMode``) placed as DTensors by
``auto_rules``, on ``cuda`` (no card needed), so the float kernels run as
their custom ops' fake implementations, as on the card they launch. It
records per rank 0:

* ``memory`` — argument and output bytes (the sum of rank 0's local
  shards) and temp bytes (the traced peak of live storages less the
  arguments);
* ``cost`` — ``flops`` (the local ops' FLOPs) and ``bytes accessed``
  (operand plus result bytes of every op that is not a view: the port
  runs eagerly, so that is its HBM traffic);
* ``collectives`` — operand bytes by op (``launch/collective_analysis.py``);
* ``trace_seconds`` (the reference's ``compile_seconds``).

A process holds one default process group, so the dry-run runs in a
fresh process (never beside ``launch_ranks`` or the one-rank in-process
group). Records land in ``experiments/dryrun_torch/<arch>__<shape>__
<mesh>.json``.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun             # all
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh both
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import time
import traceback
from typing import Dict, List, Optional

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.launch import mesh as mesh_lib

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "dryrun_torch")

MESHES = ("single", "multi")


def _mesh_for(name: str, device=None):
    return mesh_lib.make_production_mesh(multi_pod=(name == "multi"),
                                         device=device)


def fake_device(device=None) -> str:
    """The fake tensors' device for the program of ``device`` (the card's
    unless ``"cpu"``): CUDA where PyTorch is built with CUDA; else the
    CPU, whose fake tensors then take the card's route inside
    ``kernels.card_trace`` (a CPU-only build cannot index a fake CUDA
    tensor)."""
    import torch
    if str(device) == "cpu" or not torch.backends.cuda.is_built():
        return "cpu"
    return "cuda"


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             rule_overrides=(), device=None,
             cfg_overrides: Optional[Dict[str, object]] = None
             ) -> Dict[str, object]:
    """One dry-run cell (``mesh_name`` ``"single"``, ``"multi"``, or
    ``"none"`` for one device with no mesh)."""
    from repro_torch.launch.specs import (build_cell, lower_cell,
                                          model_param_counts)
    from repro_torch.models import auto_rules
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    rec: Dict[str, object] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "kind": shape.kind, "status": "skip",
    }
    if not cfg.shape_supported(shape):
        rec["reason"] = ("no sub-quadratic path"
                         if shape_name == "long_500k" else "no decode path")
        return rec
    program = "cpu" if str(device) == "cpu" else "cuda"
    fake = fake_device(program)
    mesh = rules = None
    if mesh_name != "none":
        mesh = _mesh_for(mesh_name, fake)
        rules = auto_rules(cfg, mesh, shape)
        if rule_overrides:
            rules = rules.with_overrides(*rule_overrides)
    t0 = time.perf_counter()
    cell = build_cell(cfg, shape, mesh, rules, fake)
    t1 = time.perf_counter()
    trace = lower_cell(cell, pod_boundary=(
        mesh.size // mesh.shape["pod"]
        if mesh is not None and "pod" in mesh.shape else None),
        card=(program == "cuda"))
    rec.update({
        "status": "ok",
        "device": program, "fake_device": fake,
        "n_devices": 1 if mesh is None else mesh.size,
        "n_microbatches": cell.n_microbatches,
        "build_seconds": round(t1 - t0, 3),
        "trace_seconds": round(trace.trace_seconds, 3),
        "memory": {"argument_size_in_bytes": trace.argument_bytes,
                   "output_size_in_bytes": trace.output_bytes,
                   "temp_size_in_bytes": trace.temp_bytes,
                   "peak_size_in_bytes": trace.peak_bytes},
        "cost": {"flops": float(trace.flops),
                 "bytes accessed": float(trace.bytes)},
        "collectives": trace.collectives,
        "kernel_calls": trace.op_calls,
        "params": model_param_counts(cfg),
    })
    return rec


def save_record(rec: Dict[str, object], out_dir: str = OUT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(
        out_dir, f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


def summary(rec: Dict[str, object]) -> str:
    """One line for an ``ok`` record: per-device GiB against the card's
    HBM, FLOPs, collective MiB."""
    mem = rec["memory"]
    per_dev = (mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"])
    return (f"args+temp/dev = {per_dev / 2**30:.2f} GiB of "
            f"{mesh_lib.HBM_BYTES / 2**30:.0f}, flops/dev = "
            f"{rec['cost']['flops']:.3e}, coll = "
            f"{rec['collectives']['total_bytes'] / 2**20:.1f} MiB "
            f"({rec['trace_seconds']:.1f}s trace)")


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=("single", "multi",
                                                       "both"))
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device (no card is needed)")
    ap.add_argument("--grad-compress-pods", action="store_true",
                    help="the pod-decoupled int8 error-feedback train step "
                         "on the multi-pod mesh")
    ap.add_argument("--stop-on-error", action="store_true")
    args = ap.parse_args(argv)
    # DTensor warns at every redistribute it cannot fuse
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)

    archs = ARCH_IDS if args.arch == "all" else (args.arch,)
    shapes = tuple(SHAPES) if args.shape == "all" else (args.shape,)
    meshes = MESHES if args.mesh == "both" else (args.mesh,)
    over = {"grad_compress_pods": True} if args.grad_compress_pods else None

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mesh_name in meshes:
                tag = f"{arch} x {shape} x {mesh_name}"
                try:
                    rec = run_cell(arch, shape, mesh_name,
                                   device=args.device, cfg_overrides=over)
                except Exception as e:   # record and continue
                    failures += 1
                    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
                           "status": "error", "error": str(e),
                           "traceback": traceback.format_exc()}
                    print(f"[FAIL] {tag}: {e}")
                    if args.stop_on_error:
                        save_record(rec, args.out)
                        raise
                save_record(rec, args.out)
                if rec["status"] == "ok":
                    print(f"[ok]   {tag}: {summary(rec)}")
                elif rec["status"] == "skip":
                    print(f"[skip] {tag}: {rec['reason']}")
    print(f"dry-run complete; {failures} failures")
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
