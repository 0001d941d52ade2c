"""Device→host transfer accounting.

Every host read of a tensor in the port goes through :func:`host_get`
(array) or :func:`host_int` (scalar) instead of a bare ``.cpu()``,
``.tolist()`` or ``.item()``. The helpers behave like those calls but tick
any active :class:`TransferLedger`, so a region's host syncs can be
counted (:func:`count_transfers`) or forbidden (:func:`forbid_transfers`).

Any tensor read ticks, whatever its device, so the counts a CPU test sees
are the counts the same code path makes on the card.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Iterator, List

import numpy as np
import torch


@dataclasses.dataclass
class TransferLedger:
    """Counts device→host materializations observed while active."""

    device_to_host: int = 0

    def tick(self, n: int = 1) -> None:
        self.device_to_host += n


_ACTIVE: List[TransferLedger] = []


def _tick() -> None:
    for ledger in _ACTIVE:
        ledger.tick()


def host_get(x) -> np.ndarray:
    """``x.cpu().numpy()`` that ticks active ledgers (numpy input is free)."""
    if isinstance(x, torch.Tensor):
        _tick()
        return x.detach().cpu().numpy()
    return np.asarray(x)


def host_int(x) -> int:
    """``int(x.item())`` that ticks active ledgers for tensor scalars."""
    if isinstance(x, torch.Tensor):
        _tick()
        return int(x.item())
    return int(x)


@contextlib.contextmanager
def count_transfers() -> Iterator[TransferLedger]:
    """Count instrumented device→host syncs inside the ``with`` block."""
    ledger = TransferLedger()
    _ACTIVE.append(ledger)
    try:
        yield ledger
    finally:
        _ACTIVE.remove(ledger)


@contextlib.contextmanager
def forbid_transfers() -> Iterator[TransferLedger]:
    """Raise on any device→host sync inside the ``with`` block.

    Combines the instrumented ledger with, when CUDA is initialised,
    ``torch.cuda.set_sync_debug_mode("error")``, which makes PyTorch itself
    reject synchronising calls that might bypass the instrumentation.
    """
    cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
    with count_transfers() as ledger:
        prev = torch.cuda.get_sync_debug_mode() if cuda else None
        if cuda:
            torch.cuda.set_sync_debug_mode("error")
        try:
            yield ledger
        finally:
            if cuda:
                torch.cuda.set_sync_debug_mode(prev)
        if ledger.device_to_host:
            raise RuntimeError(
                f"{ledger.device_to_host} device→host transfer(s) inside a "
                "forbid_transfers() region")
