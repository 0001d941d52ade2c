"""Parameter declarations and their initialisation.

The JAX package declares every parameter as a ``ParamSpec`` with logical
axis names that its ``AxisRules`` map onto a device mesh. The port runs
on one card: it keeps the declaration (shape, dtype, init kind) and the
materialisation, and has no mesh, no logical axes and no axis rules.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Tuple

import torch

from repro_torch.device import DeviceLike, resolve_device


#: the largest float32 draw ``ParamSpec.materialize`` makes at once
DRAW_LIMIT = 1 << 30


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter: shape + dtype + init."""

    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # 'normal' | 'zeros' | 'ones' | 'scaled'
    init_scale: float = 0.02

    def __post_init__(self):
        if self.init not in ("normal", "zeros", "ones", "scaled"):
            raise ValueError(f"unknown init {self.init!r}")

    def materialize(self, generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
        if self.init == "zeros":
            return torch.zeros(self.shape, dtype=self.dtype, device=device)
        if self.init == "ones":
            return torch.ones(self.shape, dtype=self.dtype, device=device)
        scale = self.init_scale
        if self.init == "scaled":  # 1/sqrt(fan_in) on the last axis
            fan_in = self.shape[-1] if len(self.shape) else 1
            scale = float(fan_in) ** -0.5
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        # stacked layer parameters are drawn one layer at a time, so the
        # float32 draw never holds a whole stack; a layer's part of more
        # than DRAW_LIMIT elements (kimi's 384 stacked experts, its
        # embedding) is drawn in chunks of its leading axis
        parts = out if len(self.shape) >= 3 else out[None]
        for part in parts:
            for piece in part.chunk(-(-part.numel() // DRAW_LIMIT)):
                piece.copy_(torch.randn(piece.shape, generator=generator,
                                        dtype=torch.float32, device=device)
                            .mul_(scale))
        return out


def spec_tree_map(fn: Callable[[ParamSpec], object], specs):
    """Map ``fn`` over the ParamSpec leaves of a tree of dicts."""
    if isinstance(specs, ParamSpec):
        return fn(specs)
    return {k: spec_tree_map(fn, v) for k, v in sorted(specs.items())}


def init_params(specs, generator: torch.Generator,
                device: DeviceLike = None):
    """Materialise a ParamSpec tree into tensors on ``device`` (the card
    unless ``device="cpu"``), drawing from ``generator`` (which must live
    on that device) in sorted-key order."""
    dev = resolve_device(device)
    return spec_tree_map(lambda s: s.materialize(generator, dev), specs)
