"""The port's dry-run, roofline and report on the CPU.

``repro_torch.launch.{collective_analysis,specs,dryrun,roofline,report}``
and the float kernels as custom ops:

* collective counting: a hand-built program of known collectives on the
  fake one-pod mesh gives each op's per-device operand bytes exactly (the
  reference's ``test_collective_bytes_by_op``); an async collective and
  its ``wait_tensor`` count once (``test_async_pairs_not_double_counted``);
  the pod-decoupled error-feedback cell on the two-pod mesh has
  cross-pod bytes (``test_ef_pod_decoupled_cell_lowers``);
* depth extrapolation: ``analyze_cell`` traced at 4 and 8 layers and
  extrapolated to 12 equals a direct trace at 12 layers — FLOPs, bytes
  and collective bytes within a relative 1e-6 (the eager trace meets
  every layer, so each count is affine in depth; the measured error is
  0);
* kernels in the trace: reduced-depth prefill and decode cells of
  ``rwkv6-7b``, ``zamba2-2.7b`` and ``whisper-large-v3`` on the card's
  route call each float kernel's op as often as
  ``chip_smoke.py::expected_launches`` says, and launch nothing; each
  op's fake implementation gives the plain version's shapes and dtypes;
* ``report.py``'s tables render the reference's columns.

The traces run in one fresh process (``tests/torch_launch_cases.py
trace``: the fake world needs a process without a process group).
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

import repro.launch.report as JR
from repro_torch.kernels import card_trace, selfcheck
from repro_torch.kernels.flash_attention import (attention_ref,
                                                 flash_attention_kernel)
from repro_torch.kernels.mamba2 import mamba2_ssd_kernel, mamba2_ssd_ref
from repro_torch.kernels.rwkv6 import rwkv6_chunked, rwkv6_kernel
from repro_torch.launch import report as TR

from torch_parity import isolated_plan_caches

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = os.path.join(REPO, "tests", "torch_launch_cases.py")
REL = 1e-6


@pytest.fixture(autouse=True)
def _isolate_plan_caches():
    with isolated_plan_caches():
        yield


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    out = tmp_path_factory.mktemp("launch_trace") / "trace.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    proc = subprocess.run([sys.executable, CASES, "trace", str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(out) as f:
        return json.load(f)


def _chip_smoke():
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    return chip_smoke


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

def test_collective_bytes_by_op(traced):
    st = traced["hand"]
    assert st["bytes_by_op"] == {"all-gather": 512, "all-reduce": 1024,
                                 "reduce-scatter": 512, "all-to-all": 512,
                                 "collective-permute": 0}
    assert st["count_by_op"] == {"all-gather": 1, "all-reduce": 2,
                                 "reduce-scatter": 1, "all-to-all": 1,
                                 "collective-permute": 0}
    assert st["total_bytes"] == 2560
    assert "cross_pod_bytes" not in st


def test_async_pairs_not_double_counted(traced):
    st = traced["pair"]
    assert st["count_by_op"]["all-gather"] == 1
    assert st["total_bytes"] == st["bytes_by_op"]["all-gather"] == 512


def test_ef_pod_decoupled_cell_traces(traced):
    rec = traced["ef"]
    assert rec["status"] == "ok" and rec["n_devices"] == 512
    coll = rec["collectives"]
    assert coll["cross_pod_bytes"] > 0
    assert coll["bytes_by_op"]["reduce-scatter"] > 0   # the data axis
    assert rec["memory"]["argument_size_in_bytes"] > 0


# ---------------------------------------------------------------------------
# depth extrapolation
# ---------------------------------------------------------------------------

def test_depth_extrapolation_matches_direct_trace(traced):
    ext, direct = traced["extrapolated"], traced["direct"]
    assert ext["depths"] == [4, 8, 12]
    for got, want in ((ext["hlo_flops"], direct["cost"]["flops"]),
                      (ext["hlo_bytes"], direct["cost"]["bytes accessed"]),
                      (ext["collective_bytes"],
                       direct["collectives"]["total_bytes"])):
        assert want > 0
        assert abs(got - want) <= REL * want, (got, want)
    assert ext["dominant"] in ("compute_s", "memory_s", "collective_s")


# ---------------------------------------------------------------------------
# the float kernels in the trace
# ---------------------------------------------------------------------------

def test_kernel_ops_called_as_expected_launches(traced):
    from torch_launch_cases import KERNEL_CELLS, KERNEL_MESH_CELLS
    import dataclasses
    from repro_torch.configs.base import get_config
    cs = _chip_smoke()
    seen = 0
    for key, got in traced["kernels"].items():
        arch, shape, mesh = key.split("|")
        cfg = dataclasses.replace(get_config(arch),
                                  n_layers=got["n_layers"])
        what = "prefill" if shape.startswith("prefill") else "step"
        want = {f"repro_torch::{k}": v
                for k, v in cs.expected_launches(cfg, what).items()}
        assert got["calls"] == want, key
        seen += 1
    assert seen == len(KERNEL_CELLS) + len(KERNEL_MESH_CELLS)
    assert not any(traced["launches"].values())


def _fake_cases():
    rng = np.random.default_rng(0)

    def t(*shape, dtype=torch.bfloat16):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).to(dtype)
    r, k, v, w = (t(2, 3, 40, 64) for _ in range(4))
    w = torch.sigmoid(w.float()).to(torch.bfloat16)
    u = t(3, 64, dtype=torch.float32)
    s0 = t(2, 3, 64, 64, dtype=torch.float32)
    xdt, bm, cm = t(2, 3, 70, 64), t(2, 70, 64), t(2, 70, 64)
    la = -torch.rand(2, 3, 70, generator=torch.Generator().manual_seed(0))
    q, kk, vv = t(2, 4, 33, 64), t(2, 2, 33, 64), t(2, 2, 33, 64)
    return (("rwkv6", rwkv6_kernel, rwkv6_chunked, (r, k, v, w, u, None)),
            ("rwkv6 from a state", rwkv6_kernel, rwkv6_chunked,
             (r, k, v, w, u, s0)),
            ("mamba2_ssd", mamba2_ssd_kernel, mamba2_ssd_ref,
             (xdt, la, bm, cm, None)),
            ("flash_attention", flash_attention_kernel, attention_ref,
             (q, kk, vv)))


@pytest.mark.parametrize("case", _fake_cases(), ids=lambda c: c[0])
def test_fake_implementation_shapes_equal_plain(case):
    _, kernel, plain, args = case
    want = plain(*args)
    with FakeTensorMode(allow_non_fake_inputs=True) as mode, card_trace():
        fake = kernel(*(None if a is None else mode.from_tensor(a)
                        for a in args))
    want = want if isinstance(want, tuple) else (want,)
    fake = fake if isinstance(fake, tuple) else (fake,)
    assert [(tuple(x.shape), x.dtype) for x in fake] == \
        [(tuple(x.shape), x.dtype) for x in want]


def test_card_route_needs_fake_tensors():
    """``card_trace`` reroutes fake tensors only: a real CPU tensor still
    takes the plain version, and the wrapper refuses it."""
    x = selfcheck.attention_inputs("cpu", 1, 2, 2, 8, 8, 16, seed=0)
    with card_trace(), pytest.raises(ValueError, match="CUDA tensors"):
        flash_attention_kernel(*x)


# ---------------------------------------------------------------------------
# report tables
# ---------------------------------------------------------------------------

def _records():
    dry = [{"arch": "qwen3-1.7b", "shape": "train_4k", "mesh": "single",
            "status": "ok", "trace_seconds": 12.0, "compile_seconds": 12.0,
            "memory": {"argument_size_in_bytes": 3 * 2**30,
                       "temp_size_in_bytes": 2**29},
            "collectives": {"total_bytes": 5 * 2**20}},
           {"arch": "qwen3-1.7b", "shape": "long_500k", "mesh": "multi",
            "status": "skip", "reason": "no sub-quadratic path"},
           {"arch": "kimi-k2-1t-a32b", "shape": "train_4k",
            "mesh": "multi", "status": "error"}]
    roof = [{"arch": "qwen3-1.7b", "shape": "train_4k", "status": "ok",
             "terms_seconds": {"compute_s": 0.5, "memory_s": 0.25,
                               "collective_s": 0.125},
             "dominant": "compute_s", "useful_flops_ratio": 0.5,
             "roofline_fraction": 0.4, "suggestion": "x" * 70},
            {"arch": "rwkv6-7b", "shape": "long_500k", "status": "skip"},
            {"arch": "gemma3-4b", "shape": "train_4k", "status": "error"}]
    return dry, roof


def test_report_tables_render_reference_columns():
    """The port's tables equal the reference's on the same records, but
    for the dry-run's last column: the port times a trace, not a
    compile."""
    dry, roof = _records()
    got = TR.dryrun_table(dry).replace("| trace s |", "| compile s |")
    assert got == JR.dryrun_table(dry)
    assert TR.roofline_table(roof) == JR.roofline_table(roof)


def test_report_inject_replaces_marked_blocks(tmp_path):
    dry, roof = _records()
    root = tmp_path / "experiments"
    for d, recs in ((TR.DRYRUN_DIR, dry), (TR.ROOFLINE_DIR, roof)):
        (root / d).mkdir(parents=True)
        for i, r in enumerate(recs):
            (root / d / f"{i}.json").write_text(json.dumps(r))
    md = tmp_path / "out.md"
    md.write_text("head\n<!-- DRYRUN:BEGIN -->old<!-- DRYRUN:END -->\n"
                  "<!-- ROOFLINE:BEGIN -->old<!-- ROOFLINE:END -->\n"
                  "<!-- BENCH:BEGIN -->old<!-- BENCH:END -->\ntail\n")
    TR.inject(str(md), root=str(root))
    text = md.read_text()
    assert "old" not in text and text.startswith("head\n")
    assert TR.dryrun_table(TR.load_dir(TR.DRYRUN_DIR, str(root))) in text
    assert TR.roofline_table(TR.load_dir(TR.ROOFLINE_DIR, str(root))) in text
