"""End-to-end training driver: MapSDI data integration -> LM training.

The full production story in one process (shrunk to CPU scale with
``--reduced``):

1. Build a synthetic genomics DIS (volume/redundancy dials) on the
   device, run MapSDI (Rules 1-3 + RDFize) to create the deduplicated
   knowledge graph: on the card its δs launch the rowhash,
   hash-neighbour-flag and radix-partition kernels.
2. Linearize the KG into a token stream (:mod:`repro_torch.data.pipeline`).
3. Train the selected architecture, with atomic checkpoints, injected
   failures + supervised restarts, and a straggler monitor rebalancing
   the data pipeline.

The flags are the JAX package's (``repro.launch.train``), plus
``--device``: everything runs on the CUDA card unless ``--device cpu``.
Weights are random, from a seeded ``torch.Generator`` on the device.
It trains token-only families (it refuses vlm and encdec, as the
reference does).

Alone it trains on one device. Run as SPMD ranks (``launch_ranks``, or
any initialized process group) it trains sharded, as the reference's
pjit does: a ``(data, model)`` mesh of the ranks with ``model =
--model-parallel`` (a rank count that it does not divide fails, as the
reference's mesh construction fails; here with ``SystemExit``, as the
driver's other refusals), ``auto_rules`` placing the
parameters, each data rank taking its shard of the global batch. Every
rank builds the same KG (no collective on the data path); rank 0 writes
the checkpoints and prints.

Usage (CPU smoke)::

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
        --reduced --steps 20 --batch 8 --seq 128 --ckpt /tmp/ckpt \\
        --fail-at 7 --fail-at 13 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs.base import get_config, reduced_config
from repro_torch.core.pipeline import mapsdi_create_kg
from repro_torch.data.pipeline import KGTokenPipeline, linearize_kg
from repro_torch.data.synthetic import make_group_a_dis
from repro_torch.device import resolve_device
from repro_torch.distributed.checkpoint import CheckpointManager
from repro_torch.distributed.fault import (FailureInjector, RestartPolicy,
                                           RestartReport, StragglerMonitor,
                                           run_with_restarts)
from repro_torch.distributed.sharding import init_params
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import auto_rules, get_model
from repro_torch.models.layers import ShardCtx
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import local_batch, make_train_step


def build_dataset(cfg, *, rows: int, redundancy: float, seed: int,
                  device=None, log=print) -> np.ndarray:
    """The MapSDI KG of a group-A DIS on ``device``, linearized."""
    dis = make_group_a_dis(rows, redundancy, seed=seed, device=device)
    kg, stats = mapsdi_create_kg(dis)
    log(f"[mapsdi] raw={stats['raw_triples']} kg={stats['kg_triples']} "
        f"rows {stats['source_rows_before']}->{stats['source_rows_after']}"
        f" (rule1={stats['rule1']} rule3={stats['rule3']})")
    return linearize_kg(kg, cfg.vocab_size, seed=seed)


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--reduced", action="store_true",
                    help="CPU-sized config of the same family")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--rows", type=int, default=2000)
    ap.add_argument("--redundancy", type=float, default=0.75)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--ckpt-every", type=int, default=5)
    ap.add_argument("--fail-at", type=int, action="append", default=[],
                    help="inject a simulated failure at this step")
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainRun:
    """What :func:`train` leaves: the losses of the attempt that finished,
    the restart report, the final state, the checkpoint manager's
    ``stats`` (None without ``--ckpt``) and the mesh (None on one
    device)."""

    losses: List[float]
    report: RestartReport
    params: dict
    opt_state: dict
    ckpt_stats: Optional[dict]
    mesh: Optional[object] = None


def _quiet(*_args, **_kwargs) -> None:
    pass


def train(cfg, args) -> TrainRun:
    """The driver's data build and supervised training loop for ``cfg``
    under the parsed ``args``."""
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit("train driver covers token-only families; "
                         "see tests/test_archs.py for vlm/encdec steps")
    dev = resolve_device(args.device)
    model = get_model(cfg.family)
    mesh = ctx = None
    if args.model_parallel != 1 or (dist.is_initialized()
                                    and dist.get_world_size() > 1):
        try:
            mesh = make_local_mesh(model=args.model_parallel, device=dev)
        except ValueError as e:        # the ranks do not make the mesh
            raise SystemExit(f"--model-parallel {args.model_parallel}: "
                             f"{e}") from e
        ctx = ShardCtx(mesh, auto_rules(cfg, mesh))
    log = print if mesh is None or mesh.rank == 0 else _quiet

    # --- data: MapSDI KG -> token stream ------------------------------------
    stream = build_dataset(cfg, rows=args.rows, redundancy=args.redundancy,
                           seed=args.seed, device=dev, log=log)
    pipe = KGTokenPipeline(stream, args.seq, args.batch)
    n_hosts = 1 if mesh is None else mesh.shape["data"]
    monitor = StragglerMonitor(n_hosts)

    # --- model / optimizer ---------------------------------------------------
    opt = make_optimizer(cfg.optimizer, lr=args.lr)
    specs = model.param_specs(cfg)
    train_step = make_train_step(cfg, optimizer=opt, ctx=ctx)

    manager = (CheckpointManager(args.ckpt, keep_n=3,
                                 group=None if mesh is None else mesh.group)
               if args.ckpt else None)
    injector = FailureInjector(schedule=tuple(args.fail_at))
    state = {}

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = (init_params(specs, gen, dev) if ctx is None else
                  init_params(specs, gen, dev, mesh=mesh, rules=ctx.rules))
        return params, opt.init(params)

    def loop(resume_attempt: Optional[int]):
        params, opt_state = init_state()
        start = 0
        if manager is not None and manager.latest_step() is not None:
            (params, opt_state), extra = manager.restore(
                (params, opt_state), device=dev)
            start = int(extra.get("step", manager.latest_step())) + 1
            log(f"[restore] resumed from step {start - 1}")
        losses = []
        for step in range(start, args.steps):
            injector.maybe_fail(step)
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch(step).items()}
            if ctx is not None:        # this data rank's rows
                batch = local_batch(ctx, batch)
            params, opt_state, metrics = train_step(params, opt_state, batch,
                                                    step)
            loss = float(metrics["loss"])         # reads back: a sync
            dt = time.perf_counter() - t0
            monitor.observe([dt] * n_hosts)   # one host: uniform
            losses.append(loss)
            if manager is not None and (step + 1) % args.ckpt_every == 0:
                manager.save(step, (params, opt_state),
                             extra={"step": step})
            if step % max(1, args.steps // 10) == 0:
                log(f"[step {step:4d}] loss={loss:.4f} "
                    f"gnorm={float(metrics['grad_norm']):.3f} "
                    f"{dt*1e3:.0f}ms")
        if manager is not None:
            manager.save(args.steps - 1, (params, opt_state),
                         extra={"step": args.steps - 1})
            manager.wait()
        state.update(params=params, opt_state=opt_state)
        return losses

    policy = RestartPolicy(max_restarts=max(3, len(args.fail_at) + 1))
    losses, report = run_with_restarts(loop, policy)
    if report.restarts:
        log(f"[fault] survived {report.restarts} injected failures: "
            f"{[f[1] for f in report.failures]}")
    if monitor.stragglers():
        pipe.rebalance(monitor.shard_weights())
        log(f"[straggler] rebalanced: {monitor.shard_weights()}")
    if manager is not None:
        manager.close()
    return TrainRun(losses, report, state["params"], state["opt_state"],
                    manager and manager.stats, mesh)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    run = train(cfg, args)
    losses = run.losses
    log = print if run.mesh is None or run.mesh.rank == 0 else _quiet
    log(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    ok = losses[-1] < losses[0]
    log("loss decreased" if ok else "WARNING: loss did not decrease")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
