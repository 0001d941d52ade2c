"""Carry the JAX package's parameters into the port.

``params_from_numpy`` takes the reference's parameter tree as numpy
arrays (``jax.tree_util.tree_map(np.asarray, params)``) and returns the
port's tree of tensors with the same dtypes and shapes; stacked layer
parameters keep their leading ``[L]`` / ``[G, E]`` axes. Nothing here
imports jax: bfloat16 arrays arrive with numpy dtype ``bfloat16`` (from
the ``ml_dtypes`` package), which ``torch.from_numpy`` does not take, so
they go through float32, which holds every bfloat16 value exactly.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device


def _tensor(a, device: torch.device) -> torch.Tensor:
    a = np.array(a)          # a writable copy: jax hands out read-only views
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device,
                                                         torch.bfloat16)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree, device: DeviceLike = None):
    """Nested dicts of numpy arrays -> the same dicts of tensors on
    ``device`` (the card unless ``device="cpu"``)."""
    dev = resolve_device(device)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return _tensor(node, dev)

    return walk(tree)
