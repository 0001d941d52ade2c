#!/usr/bin/env python3
"""Time one small collective of ``torch.distributed`` on this machine.

Run from the root of a checkout:

    python3 tools/collective_launch.py [--calls 200]

For each placement it spawns the ranks (``repro_torch.launch.mesh
.launch_ranks``) and times ``all_to_all_single`` and ``all_gather`` of a
4 KiB int32 block per rank, each call ended by a device sync, after a
warm-up; it prints the median seconds of a call on rank 0 (the
per-collective launch cost the exchange cost model adds to wire time,
``COLLECTIVE_LAUNCH_S`` in ``src/repro_torch/plan/annotate.py``), the
placement, the backend and, on a card, ``nvidia-smi``'s name and power
limit. With a card it also fits ``measure_collective_bandwidth`` on 4
ranks sharing it, ``--fits`` times at the module's payloads and at each
``--payload-kib`` list given, to show how far the fit moves between runs:

    python3 tools/collective_launch.py --fits 8 --payload-kib 64 256 1024 \
        --repeats 3

Placements: one rank on NCCL (a card), 4 ranks sharing one card on gloo,
and 4 ranks on the CPU on gloo. It needs no network.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

WORDS = 1024          # 4 KiB of int32 per rank


def _time_calls(calls: int, device: str, n_fits: int, fit_settings):
    import torch
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_mesh
    n = dist.get_world_size()
    mesh = make_mesh((n,), ("data",), device=device)
    dev = mesh.device
    x = torch.arange(WORDS, dtype=torch.int32, device=dev)
    y = torch.empty_like(x)
    outs = [torch.empty_like(x) for _ in range(n)]

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    res = {}
    for name, op in (("all_to_all", lambda: dist.all_to_all_single(y, x)),
                     ("all_gather", lambda: dist.all_gather(outs, x))):
        for _ in range(20):
            op()
        sync()
        secs = []
        for _ in range(calls):
            dist.barrier()
            sync()
            t0 = time.perf_counter()
            op()
            sync()
            secs.append(time.perf_counter() - t0)
        res[name] = statistics.median(secs)
    fits = []
    if n > 1 and dev.type == "cuda":
        from repro_torch.launch.mesh import measure_collective_bandwidth
        for payload_kib, repeats in fit_settings:
            for _ in range(n_fits):
                t0 = time.perf_counter()
                cal = measure_collective_bandwidth(
                    mesh, "data", payload_kib=payload_kib, repeats=repeats)
                fits.append({"payload_kib": list(payload_kib),
                             "repeats": repeats,
                             "all_gather_bw": cal.all_gather_bw,
                             "all_to_all_bw": cal.all_to_all_bw,
                             "launch_s": cal.launch_s, "source": cal.source,
                             "seconds": time.perf_counter() - t0})
    return {"ranks": n, "device": str(dev), "backend": mesh.backend,
            "median_s": res, "fits": fits}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--calls", type=int, default=200)
    ap.add_argument("--fits", type=int, default=1,
                    help="fits of measure_collective_bandwidth per setting")
    ap.add_argument("--payload-kib", type=int, nargs="+", action="append",
                    help="payloads of one more fit setting (repeated: "
                         "several settings); default: the module's")
    ap.add_argument("--repeats", type=int, default=None,
                    help="trials per payload of the --payload-kib settings")
    args = ap.parse_args()
    import torch
    from repro_torch.launch.mesh import (CALIBRATION_PAYLOAD_KIB,
                                         CALIBRATION_REPEATS, launch_ranks)
    settings = [(tuple(CALIBRATION_PAYLOAD_KIB), CALIBRATION_REPEATS)]
    settings += [(tuple(p), args.repeats or CALIBRATION_REPEATS)
                 for p in args.payload_kib or ()]
    card = None
    placements = [("cpu", 4, "gloo")]
    if torch.cuda.is_available():
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
        placements = [("cuda", 1, "nccl"), ("cuda", 4, "gloo")] + placements
    for device, n, backend in placements:
        out = launch_ranks(_time_calls, n, device=device, timeout=300,
                           args=(args.calls, device, args.fits, settings),
                           backend=backend)[0]
        out["card"] = card
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
