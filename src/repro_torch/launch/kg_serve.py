"""Multi-tenant streaming KG ingestion driver over the serve front door.

Simulates the semantification service: T tenant DISes spread over K
structural shapes register with one :class:`~repro_torch.serve.FrontDoor`
on one device (the CUDA card unless ``--device cpu``), then extension
micro-batches (new gene/sample rows) stream in round-robin and are folded
into each tenant's KG via the shared-plan ingest path — tenants of one
shape share built closures through the process-wide plan cache (K
compiles for T tenants), and the admission controller sheds load with
typed ``Overloaded`` responses when the queue passes its watermarks.
Reports per-request latency quantiles (linear-interpolation percentiles,
:func:`repro_torch.serve.percentile`), compile dedup, recompile stalls and
shed counts from ``serve_stats()``. The flags are the reference's
(``repro.launch.kg_serve``), plus ``--device`` and ``--timeout``.

With ``--mesh-shards N`` every tenant is a mesh session over N ranks
(:func:`repro_torch.launch.mesh.launch_ranks`: gloo on the CPU and when
the ranks share a card, NCCL with a card each): rank 0 leads the front
door and drives the traffic, the other ranks follow its flushes
(:meth:`~repro_torch.serve.FrontDoor.follow`), and this process prints
rank 0's lines. ``--timeout`` bounds the ranks (seconds).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.kg_serve --rows 2000 \\
        --tenants 8 --shapes 2 --batches 12 --batch-rows 128
    PYTHONPATH=src python -m repro_torch.launch.kg_serve --device cpu \\
        --mesh-shards 2 --rows 100 --batches 4 --batch-rows 8
"""
from __future__ import annotations

import argparse
import time
from typing import Callable, Dict, List, Optional

from repro_torch.api import EngineConfig
from repro_torch.data.synthetic import (make_group_b_dis,
                                        make_group_b_extension_records)
from repro_torch.serve import FrontDoor, Overloaded, percentile


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.kg_serve")
    ap.add_argument("--rows", type=int, default=4000,
                    help="seed rows per source")
    ap.add_argument("--tenants", type=int, default=4,
                    help="registered tenant sessions")
    ap.add_argument("--shapes", type=int, default=2,
                    help="distinct structural DIS shapes among tenants")
    ap.add_argument("--batches", type=int, default=16,
                    help="ingest micro-batches per tenant")
    ap.add_argument("--batch-rows", type=int, default=256)
    ap.add_argument("--flush-window", type=float, default=0.0,
                    help="micro-batch coalescing window in seconds")
    ap.add_argument("--max-queue", type=int, default=1024,
                    help="admission hard high-water (queued requests)")
    ap.add_argument("--engine", default="sdm")
    ap.add_argument("--dedup", default="hash")
    ap.add_argument("--mode", default="exact", choices=["exact", "bound"])
    ap.add_argument("--slack", type=float, default=1.0)
    ap.add_argument("--mesh-shards", type=int, default=0,
                    help="run every tenant over N ranks (0 = one device)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="the tenants' device (default: the CUDA card)")
    ap.add_argument("--timeout", type=float, default=3600.0,
                    help="the ranks' limit in seconds (--mesh-shards)")
    return ap


def _door(args: argparse.Namespace, mesh=None) -> FrontDoor:
    """The front door with every tenant registered (tenants of one shape
    share seed rows: identical structure and dictionary codes, so one
    plan signature and one compile; their live deltas still differ)."""
    door = FrontDoor(EngineConfig(engine=args.engine, dedup=args.dedup,
                                  mode=args.mode, slack=args.slack,
                                  mesh=mesh),
                     device=None if mesh is not None else args.device,
                     flush_window=args.flush_window,
                     max_queue=args.max_queue)
    for t in range(args.tenants):
        dis = make_group_b_dis(args.rows, 0.6, seed=args.seed + t %
                               args.shapes, device=door.registry.device)
        door.register(f"tenant{t}", dis)
    return door


def _drive(door: FrontDoor, args: argparse.Namespace, where: str,
           seconds: float, emit: Callable[[str], None]) -> None:
    """The traffic and the summary lines (the reference's)."""
    dedup = door.registry.compile_dedup()
    emit(f"registered {dedup['tenants']} tenants over {dedup['shapes']} "
         f"shapes on {where} in {seconds:.2f}s")
    shed = 0
    tickets = []
    for b in range(args.batches):
        for t in range(args.tenants):
            recs = make_group_b_extension_records(
                args.batch_rows, seed=1000 + b * args.tenants + t)
            resp = door.submit(f"tenant{t}", recs)
            if isinstance(resp, Overloaded):
                shed += 1
                continue
            tickets.append(resp)
        flushed = door.pump(force=args.flush_window == 0.0)
        if flushed:
            last = tickets[-1].result(timeout=600)
            emit(f"batch {b:3d}: tenant kg={last.kg_triples} triples "
                 f"{last.ingest_s * 1e3:7.1f}ms "
                 f"coalesced={last.batched_requests} "
                 f"recompiles={last.recompiles}")
    door.drain()

    st = door.serve_stats()
    lat = [tk.result(timeout=600).latency_s for tk in tickets]
    emit(f"\ningested {sum(s['rows'] for s in st['per_tenant'].values())} "
         f"rows over {st['flushes']} flushes "
         f"({st['completed']} requests, {shed} shed): "
         f"p50={percentile(lat, 50) * 1e3:.1f}ms "
         f"p99={percentile(lat, 99) * 1e3:.1f}ms")
    emit(f"compiles={st['compiles']} for {st['tenants']} tenants "
         f"(dedup ratio {st['compile_dedup_ratio']:.1f}x) "
         f"recompile_stalls={st['recompile_stalls']} "
         f"plan_cache_hits={st['plan_cache']['hits']} "
         f"sheds={st['admission']['sheds']}")


def serve_rank(options: Dict[str, object]) -> Optional[List[str]]:
    """One rank of ``--mesh-shards N`` (spawned by
    :func:`~repro_torch.launch.mesh.launch_ranks`): rank 0 leads and
    returns its lines; the others follow and return ``None``."""
    from repro_torch.launch.mesh import make_mesh
    args = argparse.Namespace(**options)
    mesh = make_mesh((args.mesh_shards,), ("data",), device=args.device)
    t0 = time.perf_counter()
    door = _door(args, mesh)
    if not door.leader:
        door.follow()
        return None
    lines: List[str] = []
    try:
        _drive(door, args, f"{mesh.device} x{args.mesh_shards} ranks "
               f"({mesh.backend})", time.perf_counter() - t0, lines.append)
    finally:
        door.stop(drain=True)   # releases the followers
    return lines


def main(argv=None) -> int:
    ap = _parser()
    args = ap.parse_args(argv)
    if not 1 <= args.shapes <= args.tenants:
        ap.error("--shapes must be in [1, --tenants]")
    if args.mesh_shards < 0:
        ap.error("--mesh-shards must be >= 0")
    if args.mesh_shards:
        from repro_torch.launch.mesh import launch_ranks
        lines = launch_ranks(serve_rank, args.mesh_shards,
                             device=args.device, timeout=args.timeout,
                             args=(vars(args),))[0]
        for line in lines:
            print(line)
        return 0
    t0 = time.perf_counter()
    door = _door(args)
    _drive(door, args, str(door.registry.device), time.perf_counter() - t0,
           print)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
