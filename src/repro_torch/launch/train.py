"""End-to-end training driver: MapSDI data integration -> LM training.

The full production story in one process (shrunk to CPU scale with
``--reduced``):

1. Build a synthetic genomics DIS (volume/redundancy dials) on the
   device, run MapSDI (Rules 1-3 + RDFize) to create the deduplicated
   knowledge graph: on the card its δs launch the rowhash,
   hash-neighbour-flag and radix-partition kernels.
2. Linearize the KG into a token stream (:mod:`repro_torch.data.pipeline`).
3. Train the selected architecture on one device, with atomic
   checkpoints, injected failures + supervised restarts, and a straggler
   monitor rebalancing the data pipeline.

The flags are the JAX package's (``repro.launch.train``), plus
``--device``: everything runs on the CUDA card unless ``--device cpu``.
Weights are random, from a seeded ``torch.Generator`` on the device.
Sharded training (``--model-parallel`` other than 1) is not ported yet
and refused. It trains token-only families (it refuses vlm and encdec,
as the reference does).

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
from repro_torch.models import get_model
from repro_torch.train.optimizer import make_optimizer
from repro_torch.train.train_step import make_train_step


def build_dataset(cfg, *, rows: int, redundancy: float, seed: int,
                  device=None) -> np.ndarray:
    """The MapSDI KG of a group-A DIS on ``device``, linearized."""
    dis = make_group_a_dis(rows, redundancy, seed=seed, device=device)
    kg, stats = mapsdi_create_kg(dis)
    print(f"[mapsdi] raw={stats['raw_triples']} kg={stats['kg_triples']} "
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
    the restart report, the final state and the checkpoint manager's
    ``stats`` (None without ``--ckpt``)."""

    losses: List[float]
    report: RestartReport
    params: dict
    opt_state: dict
    ckpt_stats: Optional[dict]


def train(cfg, args) -> TrainRun:
    """The driver's data build and supervised training loop for ``cfg``
    under the parsed ``args``."""
    if cfg.family in ("vlm", "encdec"):
        raise SystemExit("train driver covers token-only families; "
                         "see tests/test_archs.py for vlm/encdec steps")
    if args.model_parallel != 1:
        raise SystemExit("--model-parallel: sharded training is not "
                         "ported yet; the port trains on one device")
    dev = resolve_device(args.device)
    model = get_model(cfg.family)

    # --- data: MapSDI KG -> token stream ------------------------------------
    stream = build_dataset(cfg, rows=args.rows, redundancy=args.redundancy,
                           seed=args.seed, device=dev)
    pipe = KGTokenPipeline(stream, args.seq, args.batch)
    n_hosts = 1
    monitor = StragglerMonitor(n_hosts)

    # --- model / optimizer ---------------------------------------------------
    opt = make_optimizer(cfg.optimizer, lr=args.lr)
    specs = model.param_specs(cfg)
    train_step = make_train_step(cfg, optimizer=opt)

    manager = (CheckpointManager(args.ckpt, keep_n=3) if args.ckpt else None)
    injector = FailureInjector(schedule=tuple(args.fail_at))
    state = {}

    def init_state():
        gen = torch.Generator(device=dev).manual_seed(args.seed)
        params = init_params(specs, gen, dev)
        return params, opt.init(params)

    def loop(resume_attempt: Optional[int]):
        params, opt_state = init_state()
        start = 0
        if manager is not None and manager.latest_step() is not None:
            (params, opt_state), extra = manager.restore(
                (params, opt_state), device=dev)
            start = int(extra.get("step", manager.latest_step())) + 1
            print(f"[restore] resumed from step {start - 1}")
        losses = []
        for step in range(start, args.steps):
            injector.maybe_fail(step)
            t0 = time.perf_counter()
            batch = {k: torch.from_numpy(v).to(dev)
                     for k, v in pipe.batch(step).items()}
            params, opt_state, metrics = train_step(params, opt_state, batch,
                                                    step)
            loss = float(metrics["loss"])         # reads back: a sync
            dt = time.perf_counter() - t0
            monitor.observe([dt] * n_hosts)   # single-host: uniform
            losses.append(loss)
            if manager is not None and (step + 1) % args.ckpt_every == 0:
                manager.save(step, (params, opt_state),
                             extra={"step": step})
            if step % max(1, args.steps // 10) == 0:
                print(f"[step {step:4d}] loss={loss:.4f} "
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
        print(f"[fault] survived {report.restarts} injected failures: "
              f"{[f[1] for f in report.failures]}")
    if monitor.stragglers():
        pipe.rebalance(monitor.shard_weights())
        print(f"[straggler] rebalanced: {monitor.shard_weights()}")
    if manager is not None:
        manager.close()
    return TrainRun(losses, report, state["params"], state["opt_state"],
                    manager and manager.stats)


def main(argv=None) -> int:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced_config(cfg)
    losses = train(cfg, args).losses
    print(f"final loss {losses[-1]:.4f} (first {losses[0]:.4f})")
    ok = losses[-1] < losses[0]
    print("loss decreased" if ok else "WARNING: loss did not decrease")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
