#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MapSDI on one CUDA card and check it.

Run from the root of a checkout, on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (each raises on failure; the script then exits non-zero and prints
no result):

1. Require a CUDA card; print ``nvidia-smi``'s name and power limit; build
   the hand-written kernels (``src/repro_torch/kernels/csrc/*.cu``, nvcc
   for sm_90a, at first use) and print the build time.
2. The main path at a real size: ``KGEngine(...).create_kg()`` cold and
   warm, one ``ingest`` inside the capacity buckets (0 recompiles) and one
   that crosses a bucket (exactly 1), for the paper's group-B DIS at
   1,000,000 rows per source (redundancy 0.75) and its group-A DIS at
   200,000 rows per source, each under both engines with ``dedup="hash"``
   on the card. After the run, the same steps on the CPU give the
   references: the KG must equal the CPU ``dedup="lex"`` path's (which
   launches no kernel) as a set, and the CPU ``dedup="hash"`` path's (the
   kernels' plain versions) bit for bit, row order included, with equal
   raw counts and recompiles. The hash δ calls per (layout, capacity, K)
   and the exact fallbacks they took (collision, radix overflow, PAD
   merge) must equal the CPU hash path's, so a wrong kernel flag cannot
   hide behind a fallback whose output is identical. Every kernel's
   launch count must have risen during the card's run.
3. Every kernel against its plain PyTorch version on the card, bit for bit
   (tolerance 0: integer code), at N = 2**20 rows for K = 1, 2, 5 and 10,
   at every (capacity, K) the main path handed the hash δ, and at the
   edge cases. Then the device time of each kernel and its plain version
   (CUDA events around back-to-back calls queued behind a sleep kernel,
   over input copies that together exceed the L2 cache), beside the bound
   the card's memory and integer rates set.
4. The language-model forward of the ``rwkv`` and ``hybrid`` families,
   with its own counts: ``make_loss_fn`` of ``rwkv6-7b`` (32 layers) and
   then ``zamba2-2.7b`` (54 layers) at full width and depth on random
   weights from a seeded ``torch.Generator`` on the card, B = 2, T = 2048,
   cold and then warm. Each forward must launch its recurrence kernel
   exactly once per layer and no other kernel; the loss must be finite
   and within 1.0 of ln(vocab) (random weights). Prints seconds, tokens/s
   and peak memory.
5. The same widths at reduced depth (rwkv6 2 layers, zamba2 6 = one
   group), T = 40 (not a chunk multiple): the card's logits and loss
   against the port's CPU plain path on the same weights.
6. Both recurrence kernels against their plain versions on the card at
   the forward's shapes and at edge cases (``selfcheck.recurrence_cases``,
   tolerances stated there), then their device times beside the bound
   (``recurrence_work``).
7. A ``{"kernels": [...]}`` JSON line for all five kernels, then as the
   last line ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, "src"))

#: NVIDIA H100 SXM data-sheet peaks: HBM3 bandwidth, and the int32 rate
#: (the 67 TFLOP/s fp32 figure counts an FMA as two operations: 33.5 T
#: fp32 instructions/s; Hopper issues int32 at half the fp32 lane rate)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 16.7e12
#: the H100's L2 cache; timed inputs are spread over copies that together
#: hold at least twice this, so every call reads its input from HBM
L2_BYTES = 50 * 2**20
#: the sleep kernel's cycles per second (the H100 SXM's top SM clock; a
#: lower clock only lengthens the sleep)
SLEEP_CYCLES_PER_S = 1.98e9
#: float32 outside the tensor cores (an FMA counts as two operations), and
#: the special-function units' exponentials: 16 per SM per clock, 132 SMs,
#: 1.98 GHz
FP32_FLOPS_PER_S = 66.9e12
SFU_OPS_PER_S = 132 * 16 * 1.98e9

N_MAIN = 1 << 20
CHECK_KS = (1, 2, 5, 10)
#: timing: trials (the median is kept) of back-to-back calls each
TIMING_TRIALS = 5
TIMING_CALLS = {"kernel": 20, "plain": 10}
#: main-path DIS sizes (rows per source) and the two ingests as fractions
#: of them: the first stays inside every capacity bucket, the second
#: crosses one
GROUP_B_ROWS = 1_000_000
GROUP_A_ROWS = 200_000
INGEST_IN_BUCKET = 0.02
INGEST_CROSSING = {"group_b": 0.06, "group_a": 0.35}

#: language-model forward: the path's batch and sequence; the reduced
#: depth of the CPU comparison and its sequence; the comparison's
#: tolerances (bf16 on both sides, rounded per op; accumulation order
#: differs between cuBLAS and the CPU's kernels): logits within 3% of
#: their RMS in RMS and 8% of their largest magnitude, loss within 2e-3
LM_ARCHS = ("rwkv6-7b", "zamba2-2.7b")
LM_BATCH, LM_SEQ = 2, 2048
LM_REDUCED_LAYERS = {"rwkv6-7b": 2, "zamba2-2.7b": 6}
LM_REDUCED_SEQ = 40
LM_RMS_FRAC, LM_MAX_FRAC, LM_LOSS_ATOL = 0.03, 0.08, 2e-3
LM_LOSS_BAND = 1.0
LM_KERNEL = {"rwkv": "rwkv6", "hybrid": "mamba2_ssd"}

KERNELS = {
    "rowhash": ("src/repro_torch/kernels/csrc/rowhash.cu",
                "src/repro/kernels/rowhash/rowhash.py:52"),
    "hash_neighbor_flags": (
        "src/repro_torch/kernels/csrc/hash_neighbor_flags.cu",
        "src/repro/kernels/rowhash/rowhash.py:97"),
    "radix_partition": (
        "src/repro_torch/kernels/csrc/radix_partition.cu",
        "src/repro/kernels/radix_partition/radix_partition.py:147"),
    "rwkv6": ("src/repro_torch/kernels/csrc/rwkv6.cu",
              "src/repro/kernels/rwkv6/rwkv6.py:60"),
    "mamba2_ssd": ("src/repro_torch/kernels/csrc/mamba2_ssd.cu",
                   "src/repro/kernels/mamba2/mamba2.py:61"),
}
INT_KERNELS = ("rowhash", "hash_neighbor_flags", "radix_partition")


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def log(*args) -> None:
    print(*args, flush=True)


# ---------------------------------------------------------------------------
# phase 1
# ---------------------------------------------------------------------------

def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr}")
    return res.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------

def group_a_records(n_rows: int, n_distinct: int, seed: int, attr: str,
                    n_noise: int = 8):
    """Extension rows shaped like ``make_group_a_dis``'s sources, drawn
    from the same transcript pool."""
    import numpy as np
    rng = np.random.default_rng(seed)
    vals = rng.integers(0, n_distinct, size=n_rows)
    noise = rng.integers(0, 50, size=(n_rows, n_noise))
    return [dict({"ID": int(1_000_000 + i), attr: f"ENST{int(v):08d}"},
                 **{f"noise{j}": int(noise[i, j]) for j in range(n_noise)})
            for i, v in enumerate(vals)]


def build_workloads():
    from repro_torch.data.synthetic import (make_group_a_dis,
                                            make_group_b_dis,
                                            make_group_b_extension_records)
    out = []
    t0 = time.perf_counter()
    n = GROUP_B_ROWS
    dis = make_group_b_dis(n, 0.75, seed=0, device="cpu")
    small = make_group_b_extension_records(int(n * INGEST_IN_BUCKET), seed=1)
    big = make_group_b_extension_records(
        int(n * INGEST_CROSSING["group_b"]), seed=2, sources=("gene",))
    out.append((f"group_b_{n}", dis, small, big))
    log(f"workload group_b {n} rows/source built in "
        f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    n = GROUP_A_ROWS
    dis = make_group_a_dis(n, 0.75, seed=0, device="cpu")
    n_distinct = int(round(n * 0.25))
    small = {"src0": group_a_records(int(n * INGEST_IN_BUCKET * 5),
                                     n_distinct, 3, "enst")}
    big = {"src1": group_a_records(int(n * INGEST_CROSSING["group_a"]),
                                   n_distinct, 4, "downstream_gene")}
    out.append((f"group_a_{n}", dis, small, big))
    log(f"workload group_a {n} rows/source built in "
        f"{time.perf_counter() - t0:.1f} s")
    return out


def encode(deltas, dis, vocab):
    from repro_torch.relalg import Table
    return {name: Table.from_records(recs, dis.sources[name].attrs, vocab,
                                     device="cpu")
            for name, recs in deltas.items()}


STEPS = ("create_kg cold", "create_kg warm", "ingest in bucket",
         "ingest crossing")


def run_session(torch, dis, engine, dedup, device, deltas):
    """The four main-path steps; per step the KG codes, counts,
    recompiles, wall seconds, counted host syncs, and the hash δ calls
    and fallbacks."""
    from repro_torch.api import EngineConfig, KGEngine, clear_plan_cache
    from repro_torch.relalg import count_transfers
    from repro_torch.relalg.ops import (hash_dedup_counts,
                                        reset_hash_dedup_counts)
    clear_plan_cache()
    eng = KGEngine(dis, config=EngineConfig(engine=engine, dedup=dedup),
                   device=device)
    out = []
    for step, delta in zip(STEPS, (None, None) + tuple(deltas)):
        reset_hash_dedup_counts()
        with count_transfers() as ledger:
            t0 = time.perf_counter()
            kg, stats = (eng.create_kg() if delta is None
                         else eng.ingest(delta))
            if eng.device.type == "cuda":
                torch.cuda.synchronize()
            secs = time.perf_counter() - t0
        out.append({"step": step, "codes": kg.to_codes(),
                    "raw": stats["raw_triples"], "kg": stats["kg_triples"],
                    "recompiles": stats["recompiles"],
                    "cache_hit": stats["plan_cache_hit"], "seconds": secs,
                    "host_syncs": ledger.device_to_host,
                    "dedup": hash_dedup_counts()})
    return out


def main_path_phase(torch, dev):
    """Returns the launch counts of the card's run and the (capacity, K)
    shapes it handed the hash δ."""
    import numpy as np
    from repro_torch.kernels import launch_counts, reset_launch_counts
    workloads = build_workloads()
    runs = []
    for name, dis, small, big in workloads:
        deltas = (encode(small, dis, dis.vocab), encode(big, dis, dis.vocab))
        for engine in ("rmlmapper", "sdm"):
            runs.append((name, dis, engine, deltas))

    # the card's run of the main path, between a reset and a read of the
    # launch counts
    torch.cuda.synchronize()
    reset_launch_counts()
    gpu = {}
    for name, dis, engine, deltas in runs:
        gpu[(name, engine)] = run_session(torch, dis, engine, "hash", dev,
                                          deltas)
    torch.cuda.synchronize()
    launches = launch_counts()
    log(f"main path launches: {json.dumps(launches)}")
    check(all(launches[k] > 0 for k in INT_KERNELS),
          f"a kernel was not launched on the main path: {launches}")

    # the references, on the CPU (no kernel launches there)
    shapes = set()
    for name, dis, engine, deltas in runs:
        lex = run_session(torch, dis, engine, "lex", "cpu", deltas)
        plain = run_session(torch, dis, engine, "hash", "cpu", deltas)
        vocab = len(dis.vocab)
        for g, lx, pl in zip(gpu[(name, engine)], lex, plain):
            where = f"{name} {engine} {g['step']}"
            codes = g["codes"]
            check(codes.ndim == 2 and codes.shape == (g["kg"], 5) and
                  g["kg"] > 0, f"{where}: bad KG shape")
            check(int(codes[:, [1, 2, 4]].min()) >= 0 and
                  int(codes[:, [1, 2, 4]].max()) < vocab,
                  f"{where}: codes outside the vocab")
            check(np.array_equal(codes, pl["codes"]),
                  f"{where}: KG differs from the CPU hash path (plain "
                  "versions)")
            order = np.lexsort(codes.T[::-1])
            lorder = np.lexsort(lx["codes"].T[::-1])
            check(np.array_equal(codes[order], lx["codes"][lorder]),
                  f"{where}: KG differs from the CPU lex path")
            for key in ("raw", "kg", "recompiles"):
                check(g[key] == lx[key] == pl[key],
                      f"{where}: {key} {g[key]} vs lex {lx[key]} vs plain "
                      f"{pl[key]}")
            check(g["dedup"] == pl["dedup"],
                  f"{where}: hash δ calls or fallbacks on the card "
                  f"{g['dedup']} differ from the CPU hash path's "
                  f"{pl['dedup']}")
            shapes.update((cap, k) for _layout, cap, k in g["dedup"]["calls"])
        steps = gpu[(name, engine)]
        check(steps[1]["cache_hit"] and steps[1]["recompiles"] == 0,
              f"{name} {engine}: warm create_kg rebuilt")
        check(steps[2]["recompiles"] == 0,
              f"{name} {engine}: in-bucket ingest recompiled")
        check(steps[3]["recompiles"] == 1,
              f"{name} {engine}: bucket crossing cost "
              f"{steps[3]['recompiles']} recompiles, expected 1")
        for s in steps:
            calls = sum(s["dedup"]["calls"].values())
            log(f"main {name:12s} {engine:9s} {s['step']:17s} "
                f"{s['seconds']:8.3f} s  {s['kg'] / s['seconds']:12.0f} "
                f"KG triples/s  kg {s['kg']}  raw {s['raw']}  "
                f"recompiles {s['recompiles']}  host syncs "
                f"{s['host_syncs']}  hash δ calls {calls} fallbacks "
                f"{json.dumps(s['dedup']['fallbacks'])}  == cpu lex, "
                "== cpu plain")
    shapes = sorted(shapes, key=lambda s: (s[1], s[0]))
    log(f"hash δ shapes (capacity, K) on the main path: {shapes}")
    return launches, shapes


# ---------------------------------------------------------------------------
# phase 3
# ---------------------------------------------------------------------------

def device_ms(torch, calls, n_calls: int):
    """Device milliseconds per call, and whether the host kept up.

    ``calls`` are thunks over distinct input copies, taken in turn. Each
    trial queues ``n_calls`` back-to-back calls behind a sleep kernel that
    outlasts the host's enqueueing, so the events around them time the
    device alone; the median trial is kept. ``host_bound`` is True when
    the host took longer to enqueue than the sleep lasted (the device may
    then have idled between calls, and the time is an upper bound).
    """
    for fn in calls:                      # warm-up
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_calls):
        calls[i % len(calls)]()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    cycles = int(max(1e-3, 3 * enqueue_s) * SLEEP_CYCLES_PER_S)
    trials, host_bound = [], False
    for _ in range(TIMING_TRIALS):
        slept = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for i in range(n_calls):
            calls[i % len(calls)]()
        host_ms = (time.perf_counter() - t0) * 1e3
        stop.record()
        stop.synchronize()
        host_bound |= host_ms > slept.elapsed_time(start)
        trials.append(start.elapsed_time(stop) / n_calls)
    return statistics.median(trials), host_bound


def max_abs_err(torch, case) -> float:
    got, want = case.kernel_fn(), case.plain_fn()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = 0.0
    for g, w in zip(got, want):
        diff = (g.to(torch.int64) - w.to(torch.int64)).abs()
        err = max(err, float(diff.max().item()) if diff.numel() else 0.0)
    return err


def timing_work(torch, dev, n: int, k: int):
    """Per kernel: thunks over input copies for the kernel and its plain
    version, and the bytes and operations the function needs (the
    reference's 4-byte hash output, though the port writes it as int64)."""
    import numpy as np
    from repro_torch.kernels.radix_partition import (radix_partition_kernel,
                                                     radix_partition_ref)
    from repro_torch.kernels.rowhash import (hash_neighbor_flags_kernel,
                                             hash_neighbor_flags_ref,
                                             rowhash_kernel, rowhash_ref)
    from repro_torch.relalg.ops import RADIX_DEDUP_BUCKETS, _radix_dedup_cap
    rng = np.random.default_rng(1)
    rows = rng.integers(0, max(2, n // 4), (n, k)).astype(np.int32)
    hs = rowhash_ref(torch.from_numpy(rows)).numpy()
    word = 4
    copies = min(64, max(2, -(-2 * L2_BYTES // (n * k * word))))
    x = [torch.from_numpy(rows).to(dev) for _ in range(copies)]
    xs = [torch.from_numpy(rows[np.argsort(hs, kind="stable")]).to(dev)
          for _ in range(copies)]
    nb = RADIX_DEDUP_BUCKETS
    cb = _radix_dedup_cap(n, nb)
    cnt = torch.tensor(n, dtype=torch.int32, device=dev)
    kw = dict(n_buckets=nb, cap_bucket=cb, order_preserving=True)
    ops_hash = n * (11 * k + 8)
    return {
        "rowhash": ([lambda t=t: rowhash_kernel(t) for t in x],
                    [lambda t=t: rowhash_ref(t) for t in x],
                    n * k * word + n * word, ops_hash),
        "hash_neighbor_flags": (
            [lambda t=t: hash_neighbor_flags_kernel(t) for t in xs],
            [lambda t=t: hash_neighbor_flags_ref(t) for t in xs],
            n * k * word + n * 3 * word, ops_hash + n * (2 * k + 4)),
        "radix_partition": (
            [lambda t=t: radix_partition_kernel(t, cnt, **kw) for t in x],
            [lambda t=t: radix_partition_ref(t, cnt, **kw) for t in x],
            n * k * word + word + nb * cb * k * word + nb * word + 1,
            ops_hash + n * 8),
    }


def kernel_phase(torch, dev, path_shapes):
    from repro_torch.kernels import selfcheck

    errs = {name: 0.0 for name in INT_KERNELS}
    bad = {name: 0 for name in INT_KERNELS}
    cases = selfcheck.cases(dev, N_MAIN, ks=CHECK_KS,
                            path_shapes=path_shapes)
    for case in cases:
        n_bad = selfcheck.mismatches(case)
        bad[case.kernel] += n_bad
        errs[case.kernel] = max(errs[case.kernel], max_abs_err(torch, case))
        log(f"check {case.kernel:20s} {case.label:50s} mismatches {n_bad}")
    check(not any(bad.values()), f"kernel/plain mismatches: {bad}")
    check({c.kernel for c in cases} == set(INT_KERNELS),
          "a kernel has no case")

    # time N = 2**20 at K = 5 and 10, and the largest δ input of each width
    # the main path had
    largest = {}
    for n, k in path_shapes:
        largest[k] = max(largest.get(k, 0), n)
    shapes = sorted({(N_MAIN, 5), (N_MAIN, 10)} |
                    {(n, k) for k, n in largest.items()})
    results = {}
    for n, k in shapes:
        for name, (kern, plain, nbytes, nops) in timing_work(
                torch, dev, n, k).items():
            ms, k_host = device_ms(torch, kern, TIMING_CALLS["kernel"])
            plain_ms, p_host = device_ms(torch, plain, TIMING_CALLS["plain"])
            bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
            ops_ms = nops / INT32_OPS_PER_S * 1e3
            bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
            results[(name, n, k)] = {
                "ms": ms, "plain_ms": plain_ms,
                "bound_ms": max(bytes_ms, ops_ms), "bound_by": bound_by,
                "host_bound": k_host, "plain_host_bound": p_host}
            log(f"time {name:20s} N={n:8d} K={k:2d} kernel {ms:.4f} ms  "
                f"plain {plain_ms:.4f} ms  bound {max(bytes_ms, ops_ms):.4f}"
                f" ms ({bound_by})  host-bound kernel {k_host} plain "
                f"{p_host}")
    # the kernels line reports the sink δ's width (5-column triples) at
    # its largest main-path input
    report = (largest[5], 5) if 5 in largest else (N_MAIN, 5)
    return errs, bad, results, report


# ---------------------------------------------------------------------------
# phases 4-6: the language-model forward
# ---------------------------------------------------------------------------

def lm_batch(torch, cfg, batch: int, seq: int, gen, dev):
    seq_ids = torch.randint(0, cfg.vocab_size, (batch, seq + 1),
                            generator=gen, device=dev)
    return {"tokens": seq_ids[:, :-1], "labels": seq_ids[:, 1:]}


def lm_forward_phase(torch, dev):
    """Full width and depth, cold then warm; each forward between a reset
    and a read of the launch counts. Returns the cold forward's counts."""
    import math
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import init_params
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.models import get_model
    from repro_torch.train.train_step import make_loss_fn
    launches = {}
    for arch in LM_ARCHS:
        cfg = get_config(arch)
        model = get_model(cfg.family)
        kernel = LM_KERNEL[cfg.family]
        gen = torch.Generator(device=dev).manual_seed(0)
        t0 = time.perf_counter()
        params = init_params(model.param_specs(cfg), gen, dev)
        batch = lm_batch(torch, cfg, LM_BATCH, LM_SEQ, gen, dev)
        torch.cuda.synchronize()
        n_params = sum(x.numel() for x in _tensors(params))
        log(f"lm {arch}: {n_params / 1e9:.3f} B parameters initialised on "
            f"the card in {time.perf_counter() - t0:.1f} s")
        loss_fn = make_loss_fn(cfg)
        torch.cuda.reset_peak_memory_stats(dev)
        for run in ("cold", "warm"):
            torch.cuda.synchronize()
            reset_launch_counts()
            t0 = time.perf_counter()
            loss = float(loss_fn(params, batch))      # reads back: a sync
            secs = time.perf_counter() - t0
            counts = launch_counts()
            if run == "cold":
                launches[kernel] = counts[kernel]
            log(f"lm {arch} forward {run}: {secs:.3f} s, "
                f"{LM_BATCH * LM_SEQ / secs:.0f} tokens/s, loss {loss:.4f} "
                f"(ln vocab {math.log(cfg.vocab_size):.4f}), launches "
                f"{json.dumps(counts)}")
            check(counts[kernel] == cfg.n_layers,
                  f"{arch} {run}: {counts[kernel]} {kernel} launches for "
                  f"{cfg.n_layers} layers")
            check(all(v == 0 for k, v in counts.items() if k != kernel),
                  f"{arch} {run}: another kernel launched: {counts}")
            check(math.isfinite(loss) and
                  abs(loss - math.log(cfg.vocab_size)) < LM_LOSS_BAND,
                  f"{arch} {run}: loss {loss} not finite or not within "
                  f"{LM_LOSS_BAND} of ln(vocab)")
        peak = torch.cuda.max_memory_allocated(dev)
        weights = sum(x.numel() * x.element_size() for x in _tensors(params))
        log(f"lm {arch}: peak device memory {peak / 2**30:.2f} GiB "
            f"(parameters {weights / 2**30:.2f} GiB)")
        del params, batch
        torch.cuda.empty_cache()
    return launches


def _tensors(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    else:
        yield tree


def lm_cpu_phase(torch, dev):
    """Full width at reduced depth: the card's logits and loss against the
    port's CPU plain path on the same weights and tokens."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import init_params
    from repro_torch.models import get_model
    from repro_torch.models.layers import softmax_xent

    def to_cpu(tree):
        if isinstance(tree, dict):
            return {k: to_cpu(v) for k, v in tree.items()}
        return tree.cpu()

    for arch in LM_ARCHS:
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=LM_REDUCED_LAYERS[arch])
        model = get_model(cfg.family)
        gen = torch.Generator(device=dev).manual_seed(1)
        params = init_params(model.param_specs(cfg), gen, dev)
        batch = lm_batch(torch, cfg, LM_BATCH, LM_REDUCED_SEQ, gen, dev)
        out = {}
        for where, p, b in (("card", params, batch),
                            ("cpu", to_cpu(params),
                             {k: v.cpu() for k, v in batch.items()})):
            t0 = time.perf_counter()
            with torch.inference_mode():
                logits = model.apply(cfg, p, b["tokens"])
                loss = softmax_xent(logits, b["labels"], None,
                                    cfg.vocab_size)
            out[where] = (logits.float().cpu(), float(loss))
            log(f"lm {arch} {cfg.n_layers} layers T={LM_REDUCED_SEQ} on the "
                f"{where}: {time.perf_counter() - t0:.2f} s")
        (gl, gloss), (cl, closs) = out["card"], out["cpu"]
        diff = gl - cl
        rms = float(diff.square().mean().sqrt())
        ref_rms = float(cl.square().mean().sqrt())
        worst, ref_max = float(diff.abs().max()), float(cl.abs().max())
        log(f"lm {arch} card vs cpu: logits rms diff {rms:.5f} (ref rms "
            f"{ref_rms:.5f}), max diff {worst:.5f} (ref max {ref_max:.5f}), "
            f"loss {gloss:.6f} vs {closs:.6f}")
        check(bool(torch.isfinite(gl).all()), f"{arch}: non-finite logits")
        check(rms <= LM_RMS_FRAC * ref_rms and worst <= LM_MAX_FRAC * ref_max
              and abs(gloss - closs) <= LM_LOSS_ATOL,
              f"{arch}: the card's forward differs from the CPU plain path")
        del params
        torch.cuda.empty_cache()


def recurrence_work(torch, dev, kernel: str):
    """Thunks over input copies for the kernel and its plain version at
    the forward's shape (bf16), and the bytes, float32 operations and
    exponentials the function needs. Operations: an FMA counts two; a
    score's exp(a - b) * r * k counts four plus one exponential; products
    over a causal triangle count only its lower part (the rest is zero);
    mamba2's c b^T is shared by the heads of a batch row and counted once
    per row."""
    from repro_torch.kernels import selfcheck
    from repro_torch.kernels.mamba2 import mamba2_ssd_kernel, mamba2_ssd_ref
    from repro_torch.kernels.rwkv6 import rwkv6_chunked, rwkv6_kernel
    if kernel == "rwkv6":
        b, h, t = LM_BATCH, 64, LM_SEQ
        n, ln = 64, 32
        chunks = b * h * (-(-t // ln))
        nbytes = (5 * b * h * t * n * 2 + h * n * 4 + b * h * n * n * 4)
        tri = ln * (ln - 1) // 2
        flops = chunks * (4 * tri * n + 2 * tri * n + 4 * ln * n * n
                          + 8 * ln * n + 2 * n * n)
        exps = chunks * (tri * n + 2 * ln * n + n)
        make, kern, plain = (selfcheck.rwkv6_inputs, rwkv6_kernel,
                             rwkv6_chunked)
    else:
        b, h, t = LM_BATCH, 80, LM_SEQ
        n = p = ln = 64
        chunks = b * h * (-(-t // ln))
        nbytes = (2 * b * h * t * p * 2 + b * h * t * 4 + 2 * b * t * n * 2
                  + b * h * n * p * 4)
        tri = ln * (ln + 1) // 2
        flops = (chunks * (2 * tri + 2 * tri * p + 4 * ln * n * p
                           + 3 * ln * n + 2 * n * p)
                 + b * (-(-t // ln)) * 2 * tri * n)
        exps = chunks * (tri + 2 * ln + 1)
        make, kern, plain = (selfcheck.ssd_inputs, mamba2_ssd_kernel,
                             mamba2_ssd_ref)
    copies = max(2, -(-2 * L2_BYTES // nbytes))
    ins = [make(dev, b, h, t, seed=i) for i in range(copies)]
    return ([lambda x=x: kern(*x) for x in ins],
            [lambda x=x: plain(*x) for x in ins], nbytes, flops, exps,
            f"B={b} H={h} T={t}")


def lm_kernel_phase(torch, dev):
    from repro_torch.kernels import selfcheck
    errs = {k: 0.0 for k in LM_KERNEL.values()}
    bad = {k: 0 for k in LM_KERNEL.values()}
    for case in selfcheck.recurrence_cases(dev, (LM_BATCH, 64, LM_SEQ),
                                           (LM_BATCH, 80, LM_SEQ)):
        n_bad, err = selfcheck.float_mismatches(case)
        bad[case.kernel] += n_bad
        errs[case.kernel] = max(errs[case.kernel], err)
        log(f"check {case.kernel:12s} {case.label:32s} out of tolerance "
            f"{n_bad}  max |kernel - plain| {err:.3g}")
    check(not any(bad.values()), f"kernel/plain disagreements: {bad}")
    times = {}
    for kernel in LM_KERNEL.values():
        kern, plain, nbytes, flops, exps, shape = recurrence_work(
            torch, dev, kernel)
        ms, k_host = device_ms(torch, kern, TIMING_CALLS["kernel"])
        plain_ms, p_host = device_ms(torch, plain, TIMING_CALLS["plain"])
        parts = {"bytes": nbytes / HBM_BYTES_PER_S * 1e3,
                 "fp32": flops / FP32_FLOPS_PER_S * 1e3,
                 "exp": exps / SFU_OPS_PER_S * 1e3}
        bound = max(parts.values())
        times[kernel] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound,
            "bound_by": ("bytes" if parts["bytes"] >= bound
                         else "operations"),
            "host_bound": k_host, "shape": shape}
        log(f"time {kernel:12s} {shape} kernel {ms:.4f} ms  plain "
            f"{plain_ms:.4f} ms  bound {bound:.4f} ms (bytes "
            f"{parts['bytes']:.4f}, fp32 {parts['fp32']:.4f}, exp "
            f"{parts['exp']:.4f}: {nbytes} B, {flops} flop, {exps} exp)  "
            f"host-bound kernel {k_host} plain {p_host}")
    return errs, bad, times


# ---------------------------------------------------------------------------

def main() -> int:
    t_start = time.perf_counter()
    try:
        import torch
    except ImportError:
        print("chip_smoke: PyTorch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import _lib
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from "
              "the root of a checkout", file=sys.stderr)
        return 2
    try:
        card = card_line()
        log(card)
        dev = torch.device("cuda", 0)
        t0 = time.perf_counter()
        _lib.lib()
        log(f"kernels built and loaded in {time.perf_counter() - t0:.2f} s "
            f"(nvcc {_lib.last_build_seconds:.2f} s)")
        launches, path_shapes = main_path_phase(torch, dev)
        errs, bad, times, (n_rep, k_rep) = kernel_phase(torch, dev,
                                                        path_shapes)
        # float32 products in full float32 (the plain versions' matmuls)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        launches.update(lm_forward_phase(torch, dev))
        lm_cpu_phase(torch, dev)
        lm_errs, lm_bad, lm_times = lm_kernel_phase(torch, dev)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    errs.update(lm_errs)
    bad.update(lm_bad)
    for name in INT_KERNELS:
        times[name] = dict(times[(name, n_rep, k_rep)],
                           shape=f"N={n_rep} K={k_rep}")
    times.update(lm_times)
    kernels = []
    for name, (source, replaces) in KERNELS.items():
        t = times[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "mismatches": bad[name], "max_abs_err": errs[name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None, "host_bound": t["host_bound"],
            "shape": t["shape"]})
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(card)
    log(json.dumps({"kernels": kernels}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
