"""Device selection for the port's entry points.

Entry points (``KGEngine``, ``Table.from_codes``, ``parse_dis``, the
synthetic generators, ...) run on the CUDA card unless the caller passes
``device="cpu"``. Without a card they raise :class:`NoCUDADeviceError`;
they never fall back to the CPU on their own.
"""
from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]


class NoCUDADeviceError(RuntimeError):
    """A CUDA device was required (the default) but none is available."""


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise NoCUDADeviceError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
