"""Meshes of ranks on ``torch.distributed``, and the measured-bandwidth
collective calibration.

The reference builds one ``jax.sharding.Mesh`` over the devices of one
process and runs each plan as one ``shard_map``. The port runs SPMD: one
process per shard, the same program in every rank, and the collectives
of ``torch.distributed`` between them. A :class:`Mesh` is one rank's view
of that: the axis sizes, this rank, its device, the backend and the
process group.

The backend follows the placement: NCCL when each rank has a card of its
own, gloo when ranks share a card (NCCL refuses two ranks on one GPU;
gloo stages CUDA tensors through the host) and on the CPU.

``make_mesh`` inside a rank (see :func:`launch_ranks`) takes the ranks'
process group; a one-rank mesh outside any rank runs in the calling
process, on a one-rank gloo group created once per process and reused.
Nothing here touches ``torch.distributed`` at import time.

A mesh of several axes numbers its ranks row-major over the axes (as
``np.arange(n).reshape(shape)``) and has one process group per axis and
rank: every rank creates every subgroup, in the same order
(``new_group`` is collective). An axis that spans every rank uses the
mesh's own group. :attr:`Mesh.device_mesh` is the DTensor
``DeviceMesh`` built from those groups and the mesh's backend (not
``init_device_mesh``, which would pick NCCL for CUDA ranks that share a
card).

:func:`make_production_mesh` is the dry-run's mesh: rank 0 of a fake
world of 512 ranks (``torch.distributed``'s ``"fake"`` backend, whose
collectives move nothing), so a step traces on fake tensors as one rank
of the production deployment would run it, with no card.

gloo segfaults on collectives of CUDA tensors on the H100 (PyTorch
2.11): on every ``reduce_scatter``, and on DTensor's all-gather over an
axis subgroup. A CUDA mesh on gloo therefore stages its collectives
through pinned host memory, where gloo runs them on the CPU: the port's
own calls go through :func:`all_reduce`, :func:`all_gather_into`,
:func:`reduce_scatter` and :func:`all_to_all`, and the functional
collectives that DTensor calls get CUDA kernels that do the same
(:func:`_stage_collectives`).
"""
from __future__ import annotations

import dataclasses
import math
import os
import pickle
import sys
import tempfile
import threading
import time
import traceback
import warnings
from datetime import timedelta
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.kernels import register_mesh_rules


@dataclasses.dataclass(eq=False)
class Mesh:
    """One rank's view of a mesh of ranks.

    ``shape`` maps each axis name to its size, so ``mesh.shape[axis]``
    and ``tuple(mesh.shape)`` read as on the reference's mesh.
    ``axis_groups`` holds this rank's process group along each axis
    (:meth:`group_for`)."""

    shape: Dict[str, int]
    axis_names: Tuple[str, ...]
    rank: int
    device: torch.device
    backend: str
    group: object
    axis_groups: Dict[str, object] = dataclasses.field(default_factory=dict)

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis (row-major rank order)."""
        idx = np.unravel_index(self.rank, tuple(self.shape.values()))
        return {a: int(i) for a, i in zip(self.axis_names, idx)}

    def group_for(self, axis: str):
        """The process group of ``axis`` that holds this rank: the mesh's
        group when the axis spans every rank."""
        if self.shape[axis] == self.size:
            return self.group
        return self.axis_groups[axis]

    @property
    def device_mesh(self):
        """The DTensor ``DeviceMesh`` over this mesh's groups (built once
        per mesh)."""
        dm = getattr(self, "_device_mesh", None)
        if dm is None:
            from torch.distributed.device_mesh import DeviceMesh
            register_mesh_rules()
            groups = [self.group_for(a) for a in self.axis_names]
            grid = torch.arange(self.size).reshape(
                tuple(self.shape.values()))
            dm = DeviceMesh.from_group(
                groups if len(groups) > 1 else groups[0], self.device.type,
                mesh=grid, mesh_dim_names=self.axis_names)
            self._device_mesh = dm
        return dm

    def key(self) -> Tuple:
        """Identity of this mesh in cache keys: axes, this rank, the
        device and the backend (a group's ranks are 0..size-1)."""
        # the axes in the mesh's own order: it is part of its identity
        axes = tuple(self.shape.items())  # lint: allow-id
        return (axes, self.rank, str(self.device), self.backend)

    def signature(self) -> Tuple:
        """Identity of this mesh in plan-store keys: the axes (so the
        rank count) and the backend, with no rank and no device index, so
        every rank of a mesh — and a rank on ``cuda:1`` as on ``cuda:0``
        — computes one key for one plan. The store's envelope adds the
        card's name. The axes keep the mesh's own order, which is part of
        its identity (a mesh of axes (a, b) is not one of (b, a))."""
        axes = tuple(self.shape.items())  # lint: allow-id
        return (axes, self.backend)

    def axis_mesh(self, axis: str) -> "Mesh":
        """This rank's one-axis mesh along ``axis`` (its group of that
        axis; the DeviceMesh's slice)."""
        mesh = Mesh(shape={axis: self.shape[axis]}, axis_names=(axis,),
                    rank=self.coords[axis], device=self.device,
                    backend=self.backend, group=self.group_for(axis))
        mesh._device_mesh = self.device_mesh[axis]
        return mesh

    def describe(self) -> Dict[str, object]:
        return {"shape": dict(self.shape), "rank": self.rank,
                "device": str(self.device), "backend": self.backend}


def backend_for(device_type: str, n_ranks: int) -> str:
    """``"nccl"`` when every rank can have a CUDA card of its own, else
    ``"gloo"`` (shared cards, the CPU)."""
    if device_type == "cuda" and dist.is_nccl_available() and \
            torch.cuda.device_count() >= n_ranks:
        return "nccl"
    return "gloo"


#: whether this process's group is the in-process one-rank group
_IN_PROCESS: List[bool] = [False]


def _one_rank_group() -> None:
    """The in-process one-rank group: ``init_process_group`` runs once per
    process, so it is created on first use and reused."""
    if not dist.is_initialized():
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                                world_size=1)
        _IN_PROCESS[0] = True


def make_mesh(shape: Sequence[int], axes: Sequence[str],
              device: DeviceLike = None) -> Mesh:
    """A mesh of ``prod(shape)`` ranks with the named ``axes``.

    Inside a rank of :func:`launch_ranks` (or any initialized process
    group of that size) it takes the group; a one-rank mesh elsewhere
    runs in this process. ``device`` defaults to CUDA (the rank's card),
    as every entry point of the port does; ``"cpu"`` for the tests."""
    shape = tuple(int(s) for s in shape)
    axes = tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"shape {shape} and axes {axes} differ in length")
    n = math.prod(shape)
    dev = resolve_device(device)
    if not dist.is_initialized() or _IN_PROCESS[0]:
        if n != 1:
            raise ValueError(f"a {n}-rank mesh needs {n} processes: start "
                             "them with launch_ranks")
        _one_rank_group()
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"need {n} ranks, the process group has {world}")
    group = dist.group.WORLD
    rank = dist.get_rank()
    backend = str(dist.get_backend(group))
    grid = np.arange(n).reshape(shape)
    axis_groups: Dict[str, object] = {}
    for i, axis in enumerate(axes):
        if shape[i] == n:
            continue                  # the mesh's own group
        # every rank creates every group of the axis, in one order
        lines = np.moveaxis(grid, i, -1).reshape(-1, shape[i])
        for line in lines:
            g = dist.new_group([int(r) for r in line], backend=backend)
            if rank in line:
                axis_groups[axis] = g
    if dev.type == "cuda" and backend == "gloo":
        _stage_collectives()
    return Mesh(shape=dict(zip(axes, shape)), axis_names=axes, rank=rank,
                device=dev, backend=backend, group=group,
                axis_groups=axis_groups)


#: the production meshes of the reference's dry-run: one pod of 256 ranks
#: as (data=16, model=16), two as (pod=2, data=16, model=16)
PRODUCTION_MESHES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}
#: ranks of the fake world the production meshes live in: the reference
#: forces 512 placeholder devices and the one-pod mesh takes the first 256
FAKE_WORLD = 512


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> Mesh:
    """The production mesh of the dry-run: ``(data=16, model=16)``, or
    ``(pod=2, data=16, model=16)`` with ``multi_pod``, as rank 0 of a
    fake world of :data:`FAKE_WORLD` ranks (``torch.distributed``'s
    ``"fake"`` backend, whose collectives move nothing). No card is
    needed: the dry-run traces its step on fake tensors of ``device``
    (CUDA unless ``"cpu"``; only its type is kept).

    The fake world is created on first use, only where this process has
    no process group; a process with a real group (``launch_ranks``, the
    one-rank in-process group) is refused, never replaced."""
    shape, axes = PRODUCTION_MESHES[bool(multi_pod)]
    dev_type = "cpu" if str(device) == "cpu" else "cuda"
    if not dist.is_initialized():
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=FAKE_WORLD)
    elif dist.get_backend() != "fake" or _IN_PROCESS[0]:
        raise RuntimeError(
            "make_production_mesh needs a process without a process group "
            f"(this one has a {dist.get_backend()!r} group of "
            f"{dist.get_world_size()} ranks): run the dry-run in a fresh "
            "process")
    n = math.prod(shape)
    from torch.distributed.device_mesh import DeviceMesh
    register_mesh_rules()
    dm = DeviceMesh(dev_type, torch.arange(n).reshape(shape),
                    mesh_dim_names=axes)
    mesh = Mesh(shape=dict(zip(axes, shape)), axis_names=axes, rank=0,
                device=torch.device(dev_type, 0) if dev_type == "cuda"
                else torch.device("cpu"), backend="fake",
                group=dist.new_group(list(range(n))),
                axis_groups={a: dm.get_group(a) for a in axes})
    mesh._device_mesh = dm
    return mesh


def make_local_mesh(model: int = 1, data: Optional[int] = None,
                    device: DeviceLike = None) -> Mesh:
    """A ``(data, model)`` mesh over the ranks that exist (one, outside
    :func:`launch_ranks`). A rank count that ``model`` does not divide
    fails, as the reference's mesh construction fails."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    data = data if data is not None else max(1, n // model)
    return make_mesh((data, model), ("data", "model"), device=device)


# ---------------------------------------------------------------------------
# collectives of CUDA tensors on gloo, staged through the host
# ---------------------------------------------------------------------------

def _staged(x: torch.Tensor, group) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def _pinned(x: torch.Tensor) -> torch.Tensor:
    h = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    return h.copy_(x)


def _host_op(op):
    """gloo has no AVG: (the op it runs, whether to divide after)."""
    if op == dist.ReduceOp.AVG:
        return dist.ReduceOp.SUM, True
    return op, False


def all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM) -> None:
    """``dist.all_reduce(x)`` in place; a CUDA tensor on a gloo group goes
    through pinned host memory (see the module docstring)."""
    if not _staged(x, group):
        dist.all_reduce(x, op=op, group=group)
        return
    h = _pinned(x)
    host_op, mean = _host_op(op)
    dist.all_reduce(h, op=host_op, group=group)
    if mean:
        h /= dist.get_world_size(group)
    x.copy_(h)


def all_gather_into(out: torch.Tensor, x: torch.Tensor, group) -> None:
    """``dist.all_gather_into_tensor(out, x)``, staged as
    :func:`all_reduce`."""
    if not _staged(x, group):
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
        return
    h = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    dist.all_gather_into_tensor(h, _pinned(x), group=group)
    out.copy_(h)


def reduce_scatter(out: torch.Tensor, inp: torch.Tensor, group,
                   op=dist.ReduceOp.SUM) -> None:
    """``dist.reduce_scatter_tensor(out, inp)``, staged as
    :func:`all_reduce`."""
    if not _staged(inp, group):
        dist.reduce_scatter_tensor(out, inp.contiguous(), op=op, group=group)
        return
    h = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    host_op, mean = _host_op(op)
    dist.reduce_scatter_tensor(h, _pinned(inp), op=host_op, group=group)
    if mean:
        h /= dist.get_world_size(group)
    out.copy_(h)


def all_to_all(out: torch.Tensor, inp: torch.Tensor, group,
               out_splits=None, in_splits=None) -> None:
    """``dist.all_to_all_single(out, inp)``, staged as :func:`all_reduce`."""
    if not _staged(inp, group):
        dist.all_to_all_single(out, inp.contiguous(), out_splits, in_splits,
                               group=group)
        return
    h = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
    dist.all_to_all_single(h, _pinned(inp), out_splits, in_splits,
                           group=group)
    out.copy_(h)


#: the library that holds the staged CUDA kernels, once registered
_STAGED: List[object] = []


def _stage_collectives() -> None:
    """Register (once per process) CUDA kernels of the functional
    collectives DTensor calls (``_c10d_functional``'s all_reduce,
    all_gather_into_tensor, reduce_scatter_tensor, all_to_all_single),
    each run by the helpers above: through the host on a gloo group, by
    the group's own collective otherwise. They complete before they
    return, so DTensor's later wait has nothing to wait for."""
    if _STAGED:
        return
    from torch.distributed.distributed_c10d import _resolve_process_group
    ops = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.AVG,
           "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}

    def k_all_reduce(inp, reduce_op, group_name):
        out = inp.clone()
        all_reduce(out, _resolve_process_group(group_name),
                   ops[reduce_op.lower()])
        return out

    def k_all_gather(inp, group_size, group_name):
        out = inp.new_empty((inp.shape[0] * group_size,)
                            + tuple(inp.shape[1:]))
        all_gather_into(out, inp, _resolve_process_group(group_name))
        return out

    def k_reduce_scatter(inp, reduce_op, group_size, group_name):
        out = inp.new_empty((inp.shape[0] // group_size,)
                            + tuple(inp.shape[1:]))
        reduce_scatter(out, inp, _resolve_process_group(group_name),
                       ops[reduce_op.lower()])
        return out

    def k_all_to_all(inp, output_split_sizes, input_split_sizes,
                     group_name):
        out = inp.new_empty((sum(output_split_sizes),)
                            + tuple(inp.shape[1:]))
        all_to_all(out, inp, _resolve_process_group(group_name),
                   list(output_split_sizes), list(input_split_sizes))
        return out

    lib = torch.library.Library("_c10d_functional", "IMPL")
    with warnings.catch_warnings():    # they override the stock kernels
        warnings.simplefilter("ignore")
        lib.impl("all_reduce", k_all_reduce, "CUDA")
        lib.impl("all_gather_into_tensor", k_all_gather, "CUDA")
        lib.impl("reduce_scatter_tensor", k_reduce_scatter, "CUDA")
        lib.impl("all_to_all_single", k_all_to_all, "CUDA")
    _STAGED.append(lib)


# ---------------------------------------------------------------------------
# agreement: every rank takes the same decision before its next collective
# ---------------------------------------------------------------------------

def gather_values(mesh: Mesh, axis: str, values) -> np.ndarray:
    """Every rank's ``values`` (a sequence of ints, or a 1-d integer
    tensor on the mesh's device), as an ``[n_ranks, k]`` int64 array on
    every rank: one ``all_gather`` of a small tensor and one counted host
    read (:func:`repro_torch.relalg.host_get`). Every rank of ``axis``
    must call it together, with the same ``k``."""
    from repro_torch.relalg import host_get
    if isinstance(values, torch.Tensor):
        mine = values.reshape(-1).to(device=mesh.device, dtype=torch.int64)
    else:
        mine = torch.tensor([int(v) for v in values], dtype=torch.int64,
                            device=mesh.device)
    n = int(mesh.shape[axis])
    got = [torch.empty_like(mine) for _ in range(n)]
    dist.all_gather(got, mine, group=mesh.group_for(axis))
    return host_get(torch.stack(got))


def agree(mesh: Mesh, axis: str, values, what: str = "values"
          ) -> Tuple[int, ...]:
    """Check that every rank holds the same ``values`` (see
    :func:`gather_values`) and return them; raise ``RuntimeError`` naming
    each rank's values otherwise. Wherever a rank's next collective
    depends on a decision — a plan, a store hit, a flush — the ranks
    agree on it first, outside any audited call: a rank that decided
    differently would hang in the next exchange, or exchange buffers of
    another size."""
    rows = gather_values(mesh, axis, values)
    first = tuple(int(v) for v in rows[0])
    if any(tuple(int(v) for v in row) != first for row in rows):
        per_rank = ", ".join(f"rank {r}: {tuple(int(v) for v in row)}"
                             for r, row in enumerate(rows))
        raise RuntimeError(f"the ranks of the mesh disagree on {what} "
                           f"({per_rank})")
    return first


# ---------------------------------------------------------------------------
# spawning ranks
# ---------------------------------------------------------------------------

#: starting ranks sets ``PYTHONHASHSEED`` in this process's environment for
#: the spawned interpreters; groups started from several threads take turns
_SPAWN_LOCK = threading.Lock()


class RankError(RuntimeError):
    """A rank raised (the message carries its traceback), or the group
    outlived its timeout (``rank`` is then ``None``)."""

    def __init__(self, rank: Optional[int], text: str):
        super().__init__(text if rank is None
                         else f"rank {rank} failed:\n{text}")
        self.rank = rank


def _rank_main(fn, args, rank: int, n: int, store_path: str,
               device_type: str, backend: str, timeout: float,
               out_path: str) -> None:
    try:
        if device_type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        else:   # CPU ranks are test-sized; n ranks must not oversubscribe
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, n), rank=rank,
            world_size=n, timeout=timedelta(seconds=timeout))
        result = fn(*args)
        # no rank drops its links while a peer is still in the last
        # collective
        dist.barrier()
        payload = pickle.dumps(("ok", result))
    except BaseException as e:   # noqa: BLE001 - reported to the parent
        text = traceback.format_exc()
        try:
            payload = pickle.dumps(("error", text, e))
        except Exception:        # an exception that does not pickle
            payload = pickle.dumps(("error", text, None))
        with open(out_path, "wb") as f:
            f.write(payload)
        os._exit(1)              # never wait on peers that may be hung
    with open(out_path, "wb") as f:
        f.write(payload)
    sys.stdout.flush()
    sys.stderr.flush()
    # skip the interpreter's teardown: the group's threads and the card's
    # context need no orderly exit, and a teardown fault after the result
    # is written must not read as the rank's failure
    os._exit(0)


def launch_ranks(fn: Callable, n: int, *, device: DeviceLike = None,
                 timeout: float = 60.0, args: Tuple = (),
                 backend: Optional[str] = None) -> List[object]:
    """Run ``fn(*args)`` in ``n`` spawned ranks and return their results
    (rank order).

    Each rank joins one process group through a ``FileStore`` in a
    temporary directory, with ``timeout`` seconds for each collective; on
    CUDA rank ``r`` takes card ``r % device_count``. ``backend`` defaults
    to :func:`backend_for`. ``timeout`` also bounds the whole group: if a
    rank raises, or the group outlives it, every rank is terminated and
    the caller gets a :class:`RankError` (chained to the rank's own
    exception when it pickles), so a failed rank never leaves the others
    hanging. ``fn`` must be importable by the spawned interpreters (a
    module-level function). The ranks share the parent's hash seed
    (``PYTHONHASHSEED``, 0 unless the caller set one), so any iteration
    over a set of strings is the same in every rank."""
    import torch.multiprocessing as mp
    dev_type = resolve_device(device).type
    backend = backend or backend_for(dev_type, n)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="mapsdi_ranks_") as tmp:
        outs = [os.path.join(tmp, f"rank{r}.pkl") for r in range(n)]
        procs = [ctx.Process(target=_rank_main, daemon=True, args=(
            fn, args, r, n, os.path.join(tmp, "store"), dev_type, backend,
            timeout, outs[r])) for r in range(n)]
        with _SPAWN_LOCK:
            seed = os.environ.get("PYTHONHASHSEED")
            os.environ["PYTHONHASHSEED"] = seed or "0"
            try:
                for p in procs:
                    p.start()
            finally:
                if seed is None:
                    del os.environ["PYTHONHASHSEED"]
                else:
                    os.environ["PYTHONHASHSEED"] = seed
        deadline = time.monotonic() + timeout
        failed: Optional[int] = None
        try:
            while True:
                codes = [p.exitcode for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    failed = bad[0]
                    break
                if all(c == 0 for c in codes):
                    break
                if time.monotonic() > deadline:
                    raise RankError(
                        None, f"the {n} ranks outlived their {timeout} s "
                        "timeout (a hang?); every rank was terminated")
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(5)
                if p.is_alive():
                    p.kill()
                    p.join()
        if failed is not None:
            # a rank's failure makes its peers' collectives fail too: the
            # first report written is the cause
            reported = [r for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)
                        and os.path.exists(outs[r])]
            if reported:
                failed = min(reported,
                             key=lambda r: os.stat(outs[r]).st_mtime_ns)
            try:
                with open(outs[failed], "rb") as f:
                    _, text, exc = pickle.load(f)
            except (OSError, pickle.UnpicklingError, EOFError):
                text, exc = (f"exit code {procs[failed].exitcode} and no "
                             "report (killed?)"), None
            raise RankError(failed, text) from exc
        results = []
        for path in outs:
            with open(path, "rb") as f:
                results.append(pickle.load(f)[1])
        return results


# ---------------------------------------------------------------------------
# the cost model's constants and the measured calibration
# ---------------------------------------------------------------------------

#: NVLink 4 of the H100 SXM: 900 GB/s per GPU in both directions together
#: (NVIDIA's data sheet), so 450 GB/s leaving one card — the cost model
#: counts the bytes that leave one shard. A data-sheet number; no NVLink
#: peer exists on a one-card machine to measure it.
NVLINK_BW = 450e9

#: NVIDIA H100 SXM 80GB at its 700 W limit, per card, as NVIDIA's data
#: sheet gives them (not measured; a card set below 700 W runs slower):
#: dense bf16 tensor-core rate, HBM3 bandwidth and size. The dry-run's
#: roofline divides by these; its collective term divides by NVLINK_BW,
#: which holds inside one 8-GPU NVLink domain (a DGX H100): a 16-wide
#: ``model`` axis spans two such hosts, whose link is slower, so the term
#: is optimistic there.
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12
HBM_BYTES = 80 * 2**30
#: the same data sheet's rates outside the tensor cores, for the kernels'
#: bounds: float32 on the CUDA cores (67 TFLOP/s, an FMA counting two),
#: int32 at half the float32 lane rate, the special-function units'
#: exponentials (16 per SM per clock, 132 SMs), the top SM clock and the
#: L2 cache
PEAK_FLOPS_FP32 = 66.9e12
PEAK_OPS_INT32 = 16.7e12
SM_CLOCK_HZ = 1.98e9
SFU_OPS = 132 * 16 * SM_CLOCK_HZ
L2_BYTES = 50 * 2**20


@dataclasses.dataclass(frozen=True)
class Calibration:
    """Per-collective bandwidth model ``t = launch_s + wire_bytes / bw``.

    ``source`` records provenance: ``"static"`` is the data-sheet link
    rate and the measured launch constant (the cost model's default),
    ``"measured"`` a fit to microbenchmarks of the live mesh's
    collectives (:func:`measure_collective_bandwidth`). The cost model
    (:func:`repro_torch.plan.annotate.join_exchange_cost`) treats the two
    alike; only the numbers and the plan-cache signature differ."""
    all_gather_bw: float        # bytes/s of per-shard wire bytes
    all_to_all_bw: float        # bytes/s of per-shard wire bytes
    launch_s: float             # fixed per-collective launch cost
    source: str = "static"

    def signature(self) -> Tuple:
        """Hashable tag for plan-cache keys: static calibrations share one
        tag; measured ones carry their numbers, so plans costed under
        different link speeds never collide."""
        if self.source == "static":
            return ("static",)
        return (self.source, round(self.all_gather_bw),
                round(self.all_to_all_bw), round(self.launch_s, 9))


def static_calibration() -> Calibration:
    """The cost model's default constants as a :class:`Calibration`."""
    from repro_torch.plan.annotate import COLLECTIVE_LAUNCH_S
    return Calibration(all_gather_bw=NVLINK_BW, all_to_all_bw=NVLINK_BW,
                       launch_s=COLLECTIVE_LAUNCH_S, source="static")


def _fit_line(wire_bytes: Sequence[float], seconds: Sequence[float]
              ) -> Tuple[float, float]:
    """Least-squares ``t = launch + bytes/bw`` -> (bw, launch)."""
    slope, intercept = np.polyfit(np.asarray(wire_bytes, dtype=np.float64),
                                  np.asarray(seconds, dtype=np.float64), 1)
    if not np.isfinite(slope) or slope <= 0.0:
        return float("nan"), float("nan")
    return 1.0 / float(slope), max(float(intercept), 0.0)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _best_seconds(mesh: Mesh, call, repeats: int) -> float:
    """This rank's best time of ``call()`` over ``repeats`` trials, each
    started together on every rank (a barrier) and ended by a device
    sync."""
    call()                                   # warm
    _sync(mesh.device)
    best = float("inf")
    for _ in range(repeats):
        dist.barrier(group=mesh.group)
        _sync(mesh.device)
        t0 = time.perf_counter()
        call()
        _sync(mesh.device)
        best = min(best, time.perf_counter() - t0)
    return best


#: per-shard payloads of the calibration fit, in KiB. They span 512x so
#: that wire time, not the launch, sets the slope: gloo ranks sharing a
#: card stage every call through the host and take milliseconds to launch,
#: which three payloads of at most 1 MiB could not tell from timer noise
#: (the slope came out non-positive and the fit fell back to static).
CALIBRATION_PAYLOAD_KIB = (64, 2048, 32768)
CALIBRATION_REPEATS = 5


def measure_collective_bandwidth(mesh: Mesh, axis: str, *,
                                 payload_kib: Sequence[int] =
                                 CALIBRATION_PAYLOAD_KIB,
                                 repeats: int = CALIBRATION_REPEATS
                                 ) -> Calibration:
    """Time ``all_gather`` / ``all_to_all`` over ``axis`` and fit the
    two-parameter model ``t = launch + wire_bytes / bw``.

    Wire bytes follow the cost model's convention — bytes leaving one
    shard: ``(n-1) · shard_bytes`` for all_gather, ``(n-1)/n ·
    shard_bytes`` for all_to_all. Every rank times the same calls and the
    ranks keep the slowest rank's time of each (one ``all_reduce``), so
    every rank fits the same numbers and prices its plans alike.
    Degenerate fits (one rank, timer noise, non-monotone times) fall back
    to :func:`static_calibration`."""
    n = int(mesh.shape[axis])
    if n < 2:
        return static_calibration()
    group = mesh.group_for(axis)
    cols = 128
    secs = []
    g_bytes, a_bytes = [], []
    for kib in payload_kib:
        shard_rows = max(1, (kib * 1024) // (cols * 4))
        x = torch.zeros((shard_rows, cols), dtype=torch.int32,
                        device=mesh.device)
        outs = [torch.empty_like(x) for _ in range(n)]
        g_bytes.append((n - 1) * shard_rows * cols * 4)
        secs.append(_best_seconds(
            mesh, lambda: dist.all_gather(outs, x, group=group), repeats))
        bucket_rows = max(1, shard_rows // n)
        xb = torch.zeros((n * bucket_rows, cols), dtype=torch.int32,
                         device=mesh.device)
        yb = torch.empty_like(xb)
        a_bytes.append((n - 1) * bucket_rows * cols * 4)
        secs.append(_best_seconds(
            mesh, lambda: dist.all_to_all_single(yb, xb, group=group),
            repeats))
    t = torch.tensor(secs, dtype=torch.float64, device=mesh.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    t = t.cpu().numpy()
    g_bw, g_launch = _fit_line(g_bytes, t[0::2])
    a_bw, a_launch = _fit_line(a_bytes, t[1::2])
    if not (np.isfinite(g_bw) and np.isfinite(a_bw)):
        return static_calibration()
    return Calibration(all_gather_bw=g_bw, all_to_all_bw=a_bw,
                       launch_s=max(g_launch, a_launch), source="measured")


#: process-wide memo: one microbenchmark pass per (mesh, axis, payloads)
_CALIBRATION_CACHE: Dict[Tuple, Calibration] = {}


def calibrate_mesh(mesh: Mesh, axis: str, *,
                   payload_kib: Sequence[int] = CALIBRATION_PAYLOAD_KIB,
                   repeats: int = CALIBRATION_REPEATS,
                   force: bool = False) -> Calibration:
    """Session-start calibration (memoized per process and mesh): engines
    created with ``calibrate=True`` call this once per mesh, and later
    engines on the same mesh reuse the fit."""
    key = (axis, mesh.key(), tuple(payload_kib), repeats)
    if force or key not in _CALIBRATION_CACHE:
        _CALIBRATION_CACHE[key] = measure_collective_bandwidth(
            mesh, axis, payload_kib=payload_kib, repeats=repeats)
    return _CALIBRATION_CACHE[key]
