"""Both sides of the launch-tooling parity tests, each run as a script in
a fresh process (``python tests/torch_launch_cases.py ref|port OUT``):

* ``ref`` — the JAX package with 512 forced host devices (its dry-run's
  device count): ``SHAPES``, ``shape_supported``, ``microbatches``,
  ``opt_state_specs``, ``model_param_counts``, ``depth_points``,
  ``extrapolate``, ``model_flops`` and, for every arch x supported shape
  x mesh, each ``build_cell`` argument leaf's per-device shape
  (``sharding.shard_shape``) and dtype; nothing is compiled;
* ``port`` — the same argument leaves from the port's ``build_cell`` on
  the fake 512-rank world (rank 0's local shards), which needs a process
  without a process group;
* ``trace`` — the port's dry-run traces on that world: a hand-built
  program of known collectives, an async collective and its wait, the
  error-feedback cell and a depth extrapolation at reduced width, and the
  float kernels' op calls in reduced prefill and decode cells.

Each writes one JSON file. The port side imports no JAX.
"""
import json
import os
import sys
import time

#: data-shard counts the microbatch rule is compared at
DATA_SHARDS = (1, 2, 4, 8, 16, 32, 64, 128, 256)
MESHES = ("single", "multi")
#: the arch of the error-feedback cell (``grad_compress_pods``)
EF_ARCH = "qwen3-1.7b"


def _dtype_name(dt) -> str:
    return str(dt).replace("torch.", "")


def ref_cases() -> dict:
    import dataclasses
    import jax
    from repro.configs.base import ARCH_IDS, SHAPES, get_config
    from repro.distributed.sharding import ParamSpec
    from repro.launch import mesh as mesh_lib
    from repro.launch.roofline import depth_points, extrapolate, model_flops
    from repro.launch.specs import (build_cell, model_param_counts,
                                    opt_state_specs)
    from repro.models import auto_rules, get_model

    def leaves(tree):
        out = {}
        for path, x in jax.tree_util.tree_flatten_with_path(tree)[0]:
            shape = (x.sharding.shard_shape(x.shape)
                     if getattr(x, "sharding", None) is not None
                     else x.shape)
            out[jax.tree_util.keystr(path)] = [list(shape),
                                               _dtype_name(x.dtype)]
        return out

    def spec_leaves(tree):
        out = {}
        flat = jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=lambda x: isinstance(x, ParamSpec))[0]
        for path, s in flat:
            out[jax.tree_util.keystr(path)] = [
                list(s.shape), jax.numpy.dtype(s.dtype).name,
                list(s.logical_axes)]
        return out

    res = {"shapes": {k: [v.seq_len, v.global_batch, v.kind]
                      for k, v in SHAPES.items()},
           "archs": list(ARCH_IDS), "per_arch": {}, "cells": {}}
    meshes = {m: mesh_lib.make_production_mesh(multi_pod=(m == "multi"))
              for m in MESHES}
    f0 = {"flops": 10.0, "bytes": 4.0, "coll_bytes": 3.0}
    f1 = {"flops": 18.0, "bytes": 5.0, "coll_bytes": 7.5}
    res["extrapolate"] = extrapolate(f0, f1, 4, 8, 28)
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        specs = get_model(cfg.family).param_specs(cfg)
        params = model_param_counts(cfg)
        res["per_arch"][cfg.name] = {
            "supported": {s: cfg.shape_supported(v)
                          for s, v in SHAPES.items()},
            "microbatches": {s: {n: cfg.microbatches(v, n)
                                 for n in DATA_SHARDS}
                             for s, v in SHAPES.items()},
            "opt_specs": {o: spec_leaves(opt_state_specs(o, specs))
                          for o in ("adamw", "adafactor")},
            "param_counts": params,
            "depth_points": list(depth_points(cfg)),
            "model_flops": {s: {n: model_flops(cfg, v, n, params)
                                for n in (1, 256, 512)}
                            for s, v in SHAPES.items()},
        }
        for s, shape in SHAPES.items():
            if not cfg.shape_supported(shape):
                continue
            for m, mesh in meshes.items():
                cell = build_cell(cfg, shape, mesh,
                                  auto_rules(cfg, mesh, shape))
                res["cells"][f"{cfg.name}|{s}|{m}"] = leaves(cell.args)
    cfg = dataclasses.replace(get_config(EF_ARCH), grad_compress_pods=True)
    shape = SHAPES["train_4k"]
    cell = build_cell(cfg, shape, meshes["multi"],
                      auto_rules(cfg, meshes["multi"], shape))
    res["ef_cell"] = leaves(cell.args)
    return res


def port_cases() -> dict:
    import dataclasses
    from repro_torch.configs.base import ARCH_IDS, SHAPES, get_config
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.specs import build_cell, is_dtensor
    from repro_torch.models import auto_rules

    def leaves(tree, path=""):
        if isinstance(tree, dict):
            out = {}
            for k in sorted(tree):
                out.update(leaves(tree[k], f"{path}[{k!r}]"))
            return out
        if isinstance(tree, (tuple, list)):
            out = {}
            for i, v in enumerate(tree):
                out.update(leaves(v, f"{path}[{i}]"))
            return out
        local = tree.to_local() if is_dtensor(tree) else tree
        return {path: [list(local.shape), _dtype_name(local.dtype)]}

    res = {"cells": {}}
    meshes = {m: mesh_lib.make_production_mesh(multi_pod=(m == "multi"),
                                               device="cpu")
              for m in MESHES}
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for s, shape in SHAPES.items():
            if not cfg.shape_supported(shape):
                continue
            for m, mesh in meshes.items():
                cell = build_cell(cfg, shape, mesh,
                                  auto_rules(cfg, mesh, shape), "cpu")
                res["cells"][f"{cfg.name}|{s}|{m}"] = leaves(cell.args)
    cfg = dataclasses.replace(get_config(EF_ARCH), grad_compress_pods=True)
    shape = SHAPES["train_4k"]
    cell = build_cell(cfg, shape, meshes["multi"],
                      auto_rules(cfg, meshes["multi"], shape), "cpu")
    res["ef_cell"] = leaves(cell.args)
    return res


#: the reduced-width config fields the trace cases override
def reduced_overrides(arch: str) -> dict:
    import dataclasses
    from repro_torch.configs.base import get_config, reduced_config
    cfg = get_config(arch)
    red = reduced_config(cfg)
    return {f.name: getattr(red, f.name) for f in dataclasses.fields(cfg)
            if f.name != "name" and getattr(red, f.name) != getattr(cfg,
                                                                    f.name)}


#: (arch, shape) of the kernel-call cases, each on one device, and those
#: also traced on the one-pod mesh (the dry-run phase's serving cells)
KERNEL_CELLS = (("rwkv6-7b", "prefill_32k"), ("rwkv6-7b", "decode_32k"),
                ("zamba2-2.7b", "prefill_32k"),
                ("zamba2-2.7b", "decode_32k"),
                ("whisper-large-v3", "prefill_32k"),
                ("whisper-large-v3", "decode_32k"))
KERNEL_MESH_CELLS = (("rwkv6-7b", "decode_32k"),
                     ("zamba2-2.7b", "prefill_32k"))
#: their depth (zamba2: one group of its shared block and 6 mamba layers)
KERNEL_DEPTH = {"rwkv6-7b": 2, "zamba2-2.7b": 6, "whisper-large-v3": 2}
#: the depth extrapolation case: a reduced-width train cell
EXTRAPOLATE = ("qwen3-1.7b", "decode_32k", 12)


def _hand_built(mesh) -> dict:
    """Known collectives on the one-pod mesh (data=16, model=16), float32
    [16, 8] local shards (512 bytes): DTensor's all-gather over data, its
    all-reduce of a partial over model, its reduce-scatter of a partial
    onto a model shard, and the port's own all_reduce / all_to_all
    helpers over data."""
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.specs import CostMode
    dm = mesh.device_mesh
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = torch.empty(16, 8)
        mode = CostMode()
        with mode:
            a = DTensor.from_local(x, dm, [Shard(0), Replicate()],
                                   run_check=False)
            a.redistribute(dm, [Replicate(), Replicate()])     # AG 512
            p = DTensor.from_local(x, dm, [Replicate(), Partial()],
                                   run_check=False)
            p.redistribute(dm, [Replicate(), Replicate()])     # AR 512
            p.redistribute(dm, [Replicate(), Shard(0)])        # RS 512
            y = x.clone()
            mesh_lib.all_reduce(y, mesh.group_for("data"))     # AR 512
            mesh_lib.all_to_all(torch.empty(16, 8), torch.empty(16, 8),
                                mesh.group_for("data"))        # A2A 512
        hand = mode.collectives.stats().to_dict()
        mode = CostMode()
        with mode:
            out = torch.ops._c10d_functional.all_gather_into_tensor(
                x, 16, dm.get_group("data").group_name)
            torch.ops._c10d_functional.wait_tensor(out)
        pair = mode.collectives.stats().to_dict()
    return {"hand": hand, "pair": pair}


def trace_cases() -> dict:
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch import mesh as mesh_lib
    from repro_torch.launch.dryrun import run_cell
    from repro_torch.launch.roofline import analyze_cell

    t0 = time.perf_counter()
    res = _hand_built(mesh_lib.make_production_mesh(device="cpu"))
    res["seconds"] = {"hand": time.perf_counter() - t0}
    red = reduced_overrides(EF_ARCH)
    t0 = time.perf_counter()
    res["ef"] = run_cell(EF_ARCH, "train_4k", "multi", device="cuda",
                         cfg_overrides={**red, "n_layers": 1,
                                        "grad_compress_pods": True})
    res["seconds"]["ef"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    arch, shape, depth = EXTRAPOLATE
    red = reduced_overrides(arch)
    res["extrapolated"] = analyze_cell(arch, shape, device="cuda",
                                       cfg_overrides={**red,
                                                      "n_layers": depth})
    res["direct"] = run_cell(arch, shape, "single", device="cuda",
                             cfg_overrides={**red, "n_layers": depth,
                                            "microbatch_seq_tokens": 1 << 62})
    res["seconds"]["extrapolate"] = time.perf_counter() - t0
    res["kernels"] = {}
    reset_launch_counts()
    for arch, shape in KERNEL_CELLS:
        # full width (the kernels' head sizes), a reduced depth
        over = {"n_layers": KERNEL_DEPTH[arch]}
        for mesh in ("none", "single") if (arch, shape) in \
                KERNEL_MESH_CELLS else ("none",):
            t0 = time.perf_counter()
            rec = run_cell(arch, shape, mesh, device="cuda",
                           cfg_overrides=over)
            res["kernels"][f"{arch}|{shape}|{mesh}"] = {
                "calls": rec["kernel_calls"], "n_layers": over["n_layers"],
                "seconds": time.perf_counter() - t0}
    res["launches"] = launch_counts()
    return res


if __name__ == "__main__":
    side, out = sys.argv[1], sys.argv[2]
    if side == "ref":
        assert "jax" not in sys.modules
        os.environ["XLA_FLAGS"] = \
            "--xla_force_host_platform_device_count=512"
    result = {"ref": ref_cases, "port": port_cases,
              "trace": trace_cases}[side]()
    with open(out, "w") as f:
        json.dump(result, f)
