"""Roofline analysis per (arch x shape) on the one-pod H100 mesh.

The port's counterpart of the reference's ``launch/roofline.py``. Three
terms, all **per device** (rank 0 of the dry-run's fake mesh,
``launch/dryrun.py``):

    compute    = FLOPs / peak bf16 FLOP/s          (989e12)
    memory     = bytes accessed / HBM bandwidth     (3.35e12 B/s)
    collective = collective operand bytes / NVLINK_BW (450e9 B/s)

The peaks are the H100 SXM 80GB data sheet's at 700 W
(``launch/mesh.py``), not measured; the collective term assumes every
collective stays inside one NVLink domain, which a 16-wide ``model``
axis does not (a DGX H100 holds 8 cards), so it is optimistic.

**Depth extrapolation**, the reference's method: the step is traced at
two small depths (L0, L1) and every count is extrapolated to the real
depth as an affine function of it,

    f(L) = f(L0) + (f(L1) - f(L0)) / (L1 - L0) * (L - L0)

with the depth unit one structural period (gemma3's 6-layer local/global
cycle, zamba2's group of 6 mamba layers and a shared block). The port's
layers are a Python loop, so the trace at each depth counts every layer
and the counts are exactly affine in depth (``tests/test_torch_launch_
roofline.py`` holds the extrapolation to a direct trace).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
from typing import Dict, List, Optional, Tuple

from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16

OUT_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "experiments", "roofline_torch")


# ---------------------------------------------------------------------------
# depth schedule
# ---------------------------------------------------------------------------

def depth_points(cfg) -> Tuple[int, int, int]:
    """(L0, L1, L_full) in layers, respecting the structural period."""
    if cfg.local_global:                      # gemma3: 6-layer cycle
        p = cfg.local_global + 1
        return p, 2 * p, cfg.n_layers
    if cfg.shared_attn_every:                 # zamba2: 6-mamba groups
        p = cfg.shared_attn_every
        return p, 2 * p, cfg.n_layers
    return 4, 8, cfg.n_layers


def _extract(rec: Dict) -> Dict[str, float]:
    c = rec["cost"]
    return {
        "flops": float(c.get("flops", 0.0)),
        "bytes": float(c.get("bytes accessed", 0.0)),
        "transcendentals": float(c.get("transcendentals", 0.0)),
        "coll_bytes": float(rec["collectives"]["total_bytes"]),
        "temp_bytes": float(rec["memory"].get("temp_size_in_bytes", 0)),
        "arg_bytes": float(rec["memory"].get("argument_size_in_bytes", 0)),
    }


def extrapolate(f0: Dict[str, float], f1: Dict[str, float],
                l0: int, l1: int, l: int) -> Dict[str, float]:
    out = {}
    for k in f0:
        slope = (f1[k] - f0[k]) / (l1 - l0)
        out[k] = f0[k] + slope * (l - l0)
    return out


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

def model_flops(cfg, shape, n_devices: int, params: Dict[str, float]
                ) -> float:
    """Useful FLOPs per device per step: 6·N·D train, 2·N·D inference
    (N = active non-embedding params, D = tokens this step)."""
    n = params["body_active"]
    if shape.kind == "train":
        d = shape.global_batch * shape.seq_len
        mult = 6.0
    elif shape.kind == "prefill":
        d = shape.global_batch * shape.seq_len
        mult = 2.0
    else:                                    # decode: one token per row
        d = shape.global_batch
        mult = 2.0
    return mult * n * d / n_devices


def analyze_cell(arch: str, shape_name: str, *, mesh: str = "single",
                 rule_overrides=(), cfg_overrides: Optional[Dict] = None,
                 device=None) -> Dict[str, object]:
    """Two reduced-depth traces -> extrapolated roofline terms."""
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.specs import model_param_counts

    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    shape = SHAPES[shape_name]
    if not cfg.shape_supported(shape):
        return {"arch": arch, "shape": shape_name, "mesh": mesh,
                "status": "skip"}
    l0, l1, lf = depth_points(cfg)
    # one microbatch: the cost is microbatch-count invariant (the same
    # tokens a step), as the reference's cost build takes it
    base_over = dict(cfg_overrides or {})
    base_over.setdefault("microbatch_seq_tokens", 1 << 62)
    rec0 = run_cell(arch, shape_name, mesh, device=device,
                    cfg_overrides={**base_over, "n_layers": l0},
                    rule_overrides=rule_overrides)
    rec1 = run_cell(arch, shape_name, mesh, device=device,
                    cfg_overrides={**base_over, "n_layers": l1},
                    rule_overrides=rule_overrides)
    f = extrapolate(_extract(rec0), _extract(rec1), l0, l1, lf)

    n_dev = rec0["n_devices"]
    params = model_param_counts(cfg)        # at full depth
    terms = {
        "compute_s": f["flops"] / PEAK_FLOPS_BF16,
        "memory_s": f["bytes"] / HBM_BW,
        "collective_s": f["coll_bytes"] / NVLINK_BW,
    }
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape, n_dev, params)
    bound_s = max(terms.values())
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh, "status": "ok",
        "kind": shape.kind, "n_devices": n_dev,
        "depths": [l0, l1, lf],
        "hlo_flops": f["flops"], "hlo_bytes": f["bytes"],
        "collective_bytes": f["coll_bytes"],
        "terms_seconds": terms,
        "dominant": dominant,
        "model_flops": mf,
        "useful_flops_ratio": (mf / f["flops"]) if f["flops"] else 0.0,
        "roofline_fraction": (
            (mf / PEAK_FLOPS_BF16) / bound_s if bound_s else 0.0),
        "params": params,
        "trace_seconds": rec0["trace_seconds"] + rec1["trace_seconds"],
        "suggestion": _suggest(dominant, terms, shape),
    }


def _suggest(dominant: str, terms: Dict[str, float], shape) -> str:
    if dominant == "compute_s":
        return ("compute-bound: cut remat recompute / cast accumulations "
                "to bf16; beyond that this cell is at the FLOP roofline")
    if dominant == "memory_s":
        if shape.kind == "decode":
            return ("HBM-bound (weight+cache streaming): shrink the KV/state"
                    " working set (wider batch amortizes weights; quantize "
                    "cache; window/local layers skip far blocks)")
        return ("HBM-bound: fuse attention (the flash kernel on the "
                "training route), fuse the eager elementwise chains, avoid "
                "f32 round-trips on the residual")
    return ("collective-bound: reshard (move TP off the hot axis), overlap "
            "collectives with compute, int8-compress cross-pod grads")


def save_record(rec: Dict[str, object], out_dir: str = OUT_DIR) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir,
                        f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json")
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
    return path


# ---------------------------------------------------------------------------
# table generation
# ---------------------------------------------------------------------------

def markdown_table(records: List[Dict]) -> str:
    head = ("| arch | shape | compute s | memory s | collective s | "
            "dominant | useful/HLO | roofline frac |\n"
            "|---|---|---|---|---|---|---|---|\n")
    rows = []
    for r in sorted(records, key=lambda r: (r["arch"], r["shape"])):
        if r.get("status") != "ok":
            rows.append(f"| {r['arch']} | {r['shape']} | — | — | — | "
                        f"skip | — | — |")
            continue
        t = r["terms_seconds"]
        rows.append(
            f"| {r['arch']} | {r['shape']} | {t['compute_s']:.3e} | "
            f"{t['memory_s']:.3e} | {t['collective_s']:.3e} | "
            f"{r['dominant'].replace('_s', '')} | "
            f"{r['useful_flops_ratio']:.2f} | "
            f"{r['roofline_fraction']:.2%} |")
    return head + "\n".join(rows) + "\n"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="the fake tensors' device (no card is needed)")
    args = ap.parse_args(argv)
    archs = ARCH_IDS if args.arch == "all" else (args.arch,)
    shapes = tuple(SHAPES) if args.shape == "all" else (args.shape,)
    recs = []
    for arch in archs:
        for shape in shapes:
            try:
                rec = analyze_cell(arch, shape, device=args.device)
            except Exception as e:   # record and continue
                import traceback
                rec = {"arch": arch, "shape": shape, "mesh": "single",
                       "status": "error", "error": str(e),
                       "traceback": traceback.format_exc()}
                print(f"[FAIL] {arch} x {shape}: {e}")
            save_record(rec, args.out)
            recs.append(rec)
            if rec["status"] == "ok":
                t = rec["terms_seconds"]
                print(f"[ok] {arch} x {shape}: "
                      f"C={t['compute_s']:.2e}s M={t['memory_s']:.2e}s "
                      f"K={t['collective_s']:.2e}s -> {rec['dominant']} "
                      f"(useful {rec['useful_flops_ratio']:.2f}, "
                      f"roofline {rec['roofline_fraction']:.1%})")
    print()
    print(markdown_table(recs))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
