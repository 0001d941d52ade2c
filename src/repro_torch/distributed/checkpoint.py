"""Atomic, async checkpointing of training state, in the JAX package's
on-disk format.

Layout (one directory per step; the write is crash-safe because the
directory is materialized under a ``.tmp`` name and ``os.rename``'d —
readers never observe a partial checkpoint)::

    ckpt_root/
      step_00000100/
        manifest.json       per-leaf shape/dtype, the step, caller's extra
        arrays.npz          leaf data keyed by flattened tree path
      LATEST                text file: "step_00000100"

A tree is nested dicts, tuples and lists of tensors (a training state is
``(params, opt_state)``). Leaf keys are the tree paths as JAX flattens
them: tuple and list indices and dict keys in sorted order, joined by
``/`` (``"0/embed/embedding"``), so either package restores the other's
checkpoints. bfloat16 leaves are stored as 2-byte void records (numpy
has no bfloat16; the reference's ``ml_dtypes`` arrays land in the file
the same way) and viewed back on restore.

Async mode hands the host copy to a writer thread: the train loop goes
on while the previous step flushes. The copy is taken synchronously, so
the optimizer's in-place updates cannot race the writer.

On a mesh of ranks the leaves are DTensors. A save gathers each leaf
(``full_tensor()``, a collective every rank joins) and one rank writes
the file (the manager's ``group``: its rank 0), in the same format, so
a checkpoint does not record the layout it was saved from. ``restore``
with ``shardings`` (or onto a ``like`` whose leaves are DTensors) has
every rank read each leaf and keep its shard: elastic restore, onto any
layout, from a checkpoint saved on one device or on another mesh.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device
from repro_torch.distributed.sharding import is_dtensor, shard_to

Tree = Any

_SEP = "/"
#: numpy's dtype for a 2-byte record: how bfloat16 leaves are stored
_BF16_RECORD = np.dtype("V2")


# ---------------------------------------------------------------------------
# tree <-> flat list of (path, leaf)
# ---------------------------------------------------------------------------

def _flatten_with_paths(tree: Tree, path: str = "") -> List[Tuple[str, Any]]:
    def join(k):
        return f"{path}{_SEP}{k}" if path else str(k)

    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _flatten_with_paths(tree[k], join(k))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, v in enumerate(tree)
                for kv in _flatten_with_paths(v, join(i))]
    return [(path, tree)]


def _unflatten_like(like: Tree, leaves: Dict[str, Any], path: str = ""):
    def join(k):
        return f"{path}{_SEP}{k}" if path else str(k)

    if isinstance(like, dict):
        return {k: _unflatten_like(v, leaves, join(k))
                for k, v in like.items()}
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten_like(v, leaves, join(i))
                          for i, v in enumerate(like))
    return leaves[path]


def _dtype_name(dtype) -> str:
    """numpy's name of a tensor's or an array's dtype ("bfloat16",
    "float32", ...): what the manifest records, in either package."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).split(".")[-1]
    return np.dtype(dtype).name


def _to_numpy(leaf) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    if is_dtensor(leaf):               # every rank gathers it
        leaf = leaf.full_tensor()
    t = leaf.detach().to("cpu", copy=True)    # never the live storage
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_RECORD)
    return t.numpy()


def _host_copy(tree: Tree) -> Dict[str, np.ndarray]:
    """Synchronous device->host copy (the only blocking part of async)."""
    return {key: _to_numpy(leaf) for key, leaf in _flatten_with_paths(tree)}


def _manifest_for(tree: Tree, step: int,
                  extra: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    return {
        "step": step,
        "format": 1,
        "leaves": {k: {"shape": list(v.shape), "dtype": _dtype_name(v.dtype)}
                   for k, v in _flatten_with_paths(tree)},
        "extra": extra or {},
    }


def _from_numpy(arr: np.ndarray, like, device: torch.device) -> torch.Tensor:
    """A stored leaf as a tensor of ``like``'s dtype on ``device``."""
    want = like.dtype
    if not isinstance(want, torch.dtype):
        want = getattr(torch, _dtype_name(want))
    if arr.dtype.kind == "V":
        # a 2-byte record is a bfloat16 (either package writes it so)
        if not (arr.dtype.itemsize == 2 and want == torch.bfloat16):
            raise ValueError(f"a {arr.dtype} record restores as bfloat16 "
                             f"only, not {want}")
        return torch.from_numpy(arr.view(np.int16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device, want)


# ---------------------------------------------------------------------------
# save / restore primitives
# ---------------------------------------------------------------------------

def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:08d}")


def save_checkpoint(root: str, step: int, tree: Tree,
                    extra: Optional[Dict[str, Any]] = None) -> str:
    """Atomic synchronous save; returns the final directory path."""
    return _write_host_copy(root, step, _host_copy(tree),
                            _manifest_for(tree, step, extra))


def _write_host_copy(root: str, step: int, host: Dict[str, np.ndarray],
                     manifest: Dict[str, Any]) -> str:
    final = _step_dir(root, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **host)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)              # atomic publish
    latest_tmp = os.path.join(root, "LATEST.tmp")
    with open(latest_tmp, "w") as f:
        f.write(os.path.basename(final))
    os.replace(latest_tmp, os.path.join(root, "LATEST"))
    return final


def latest_step(root: str) -> Optional[int]:
    path = os.path.join(root, "LATEST")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(root, name)):
        return None
    return int(name.split("_")[-1])


def all_steps(root: str) -> List[int]:
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if name.startswith("step_") and not name.endswith(".tmp") \
                and os.path.isdir(os.path.join(root, name)):
            out.append(int(name.split("_")[-1]))
    return sorted(out)


def _place(t: torch.Tensor, like, sharding):
    """A restored whole leaf laid out as asked: ``sharding``'s layout (a
    ``sharding.Sharding``), else ``like``'s when it is a DTensor, else
    whole."""
    if sharding is not None:
        return sharding.shard(t)
    if is_dtensor(like):
        return shard_to(t, like.device_mesh, like.placements)
    return t


def restore_checkpoint(root: str, like: Tree, step: Optional[int] = None,
                       device: DeviceLike = None,
                       shardings: Optional[Tree] = None
                       ) -> Tuple[Tree, Dict[str, Any]]:
    """Restore into the structure of ``like`` (a tree of tensors, or of
    anything with ``shape`` and ``dtype``), every leaf in ``like``'s
    dtype on ``device`` (the card unless ``device="cpu"``). ``shardings``
    (``like``'s structure, ``sharding.Sharding`` leaves) reshards each
    leaf onto a mesh: every rank reads it whole and keeps its shard; a
    ``like`` of DTensors reshards onto its own layout. Returns (tree,
    manifest['extra'])."""
    dev = resolve_device(device)
    layouts = (None if shardings is None else
               dict(_flatten_with_paths(shardings)))
    step = latest_step(root) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {root}")
    d = _step_dir(root, step)
    with open(os.path.join(d, "manifest.json")) as f:
        manifest = json.load(f)
    leaves = {}
    with np.load(os.path.join(d, "arrays.npz")) as data:
        for key, ref in _flatten_with_paths(like):
            if key not in data:
                raise KeyError(f"checkpoint {d} missing leaf {key!r}")
            arr = data[key]
            if tuple(arr.shape) != tuple(ref.shape):
                raise ValueError(f"leaf {key}: checkpoint shape {arr.shape} "
                                 f"!= expected {tuple(ref.shape)}")
            leaves[key] = _place(_from_numpy(arr, ref, dev), ref,
                                 None if layouts is None else layouts[key])
    return _unflatten_like(like, leaves), manifest.get("extra", {})


# ---------------------------------------------------------------------------
# manager (async writer + retention)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class CheckpointManager:
    """Retention + async writes. ``save`` blocks only for the host copy.

    ``stats`` counts what the manager did: saves, bytes of arrays
    written, seconds blocked in ``save`` (the host copy), seconds the
    writes took (on the writer thread in async mode), restores and their
    seconds.

    With a ``group`` (a mesh's process group) every rank of it makes the
    same calls: each ``save`` gathers the leaves in every rank and the
    group's rank 0 writes; ``wait`` ends with a barrier, so no rank reads
    the directory before the writer has published."""

    root: str
    keep_n: int = 3
    async_write: bool = True
    group: Any = None

    def __post_init__(self):
        import torch.distributed as dist
        self._writes = (self.group is None
                        or dist.get_rank(self.group) == 0)
        os.makedirs(self.root, exist_ok=True)
        self._q: "queue.Queue" = queue.Queue()
        self._err: List[BaseException] = []
        self._thread: Optional[threading.Thread] = None
        self.stats = {"saves": 0, "bytes": 0, "save_s": 0.0, "write_s": 0.0,
                      "restores": 0, "restore_s": 0.0}
        if self.async_write:
            self._thread = threading.Thread(target=self._worker, daemon=True)
            self._thread.start()

    # -- writer thread ------------------------------------------------------
    def _worker(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            step, host, manifest = item
            try:
                self._write(step, host, manifest)
            except Exception as e:       # surfaced on next save/wait
                self._err.append(e)
            finally:
                self._q.task_done()

    def _write(self, step, host, manifest):
        t0 = time.perf_counter()
        _write_host_copy(self.root, step, host, manifest)
        self._gc()
        self.stats["write_s"] += time.perf_counter() - t0
        self.stats["bytes"] += sum(a.nbytes for a in host.values())

    def _raise_pending(self):
        if self._err:
            raise RuntimeError("async checkpoint write failed") \
                from self._err.pop(0)

    def _gc(self):
        steps = all_steps(self.root)
        for s in steps[:-self.keep_n] if self.keep_n else []:
            shutil.rmtree(_step_dir(self.root, s), ignore_errors=True)

    # -- public API ----------------------------------------------------------
    def save(self, step: int, tree: Tree,
             extra: Optional[Dict[str, Any]] = None) -> None:
        self._raise_pending()
        t0 = time.perf_counter()
        manifest = _manifest_for(tree, step, extra)
        host = _host_copy(tree)          # synchronous: in-place-update safe
        self.stats["saves"] += 1
        self.stats["save_s"] += time.perf_counter() - t0
        if not self._writes:
            return
        if self.async_write:
            self._q.put((step, host, manifest))
        else:
            self._write(step, host, manifest)

    def wait(self) -> None:
        if self.async_write:
            self._q.join()
        self._raise_pending()
        if self.group is not None:
            import torch.distributed as dist
            dist.barrier(group=self.group)

    def close(self) -> None:
        if self._thread is not None:
            self._q.join()
            self._q.put(None)
            self._thread.join()
            self._thread = None
        self._raise_pending()

    def latest_step(self) -> Optional[int]:
        """The newest published step, after the pending writes land (a
        restart asks which step to resume from while the writer thread
        may still hold the last save; the reference answers from the
        directory alone and then misses it)."""
        self.wait()
        return latest_step(self.root)

    def all_steps(self) -> List[int]:
        self.wait()
        return all_steps(self.root)

    def restore(self, like: Tree, step: Optional[int] = None,
                device: DeviceLike = None,
                shardings: Optional[Tree] = None):
        self.wait()
        t0 = time.perf_counter()
        out = restore_checkpoint(self.root, like, step, device, shardings)
        self.stats["restores"] += 1
        self.stats["restore_s"] += time.perf_counter() - t0
        return out
