"""Fixed-capacity columnar tables on device.

A ``Table`` is an int32 matrix ``data[capacity, n_attrs]`` of dictionary
codes plus a 0-d int32 ``count`` of valid rows on the same device. Rows
``>= count`` are padding filled with ``PAD_ID`` (INT32_MAX) so that
lexicographic sorts push them to the end. ``attrs`` names the columns.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from repro_torch.device import DeviceLike, resolve_device

from .encoding import PAD_ID, Vocab
from .guard import host_get, host_int


def round_cap(n: int, mult: int = 8) -> int:
    """Round a row count up to a capacity multiple (minimum one multiple)."""
    return max(mult, ((int(n) + mult - 1) // mult) * mult)


def bucket_cap(n: int, mult: int = 8, growth: float = 2.0) -> int:
    """Round a row count up to a *geometric* capacity bucket (8, 16, 32, …).

    A plan built for one bucket stays valid for every extension that fits
    the bucket, so a steadily growing source crosses only O(log n) buckets,
    hence O(log n) plan rebuilds, over its lifetime.
    """
    cap = mult
    n = int(n)
    while cap < n:
        cap = round_cap(int(cap * growth), mult)
    return cap


def shrink_to_fit(table: "Table", mult: int = 8, *,
                  count: int | None = None) -> "Table":
    """Materialize a table at capacity == round_cap(count). One host sync,
    the count (none when the caller passes the ``count`` it has read); the
    rows are copied on the table's device."""
    n = host_int(table.count) if count is None else count
    cap = round_cap(n, mult)
    data = torch.full((cap, table.n_attrs), PAD_ID, dtype=torch.int32,
                      device=table.device)
    data[:n] = table.data[:n]
    return Table(data=data, count=torch.full((), n, dtype=torch.int32,
                                             device=table.device),
                 attrs=table.attrs)


def pad_rows(data: torch.Tensor, capacity: int) -> torch.Tensor:
    """``data`` grown to ``capacity`` rows with PAD rows appended."""
    extra = capacity - data.shape[0]
    if extra <= 0:
        return data
    pad = torch.full((extra, data.shape[1]), PAD_ID, dtype=torch.int32,
                     device=data.device)
    return torch.cat([data, pad], dim=0)


@dataclasses.dataclass(frozen=True)
class Table:
    """Columnar relation: ``data[capacity, len(attrs)]`` int32 + valid count."""

    data: torch.Tensor       # [capacity, n_attrs] int32
    count: torch.Tensor      # 0-d int32 on data's device
    attrs: Tuple[str, ...]   # column names, in column order

    # -- static properties ---------------------------------------------------
    @property
    def capacity(self) -> int:
        return self.data.shape[0]

    @property
    def n_attrs(self) -> int:
        return len(self.attrs)

    @property
    def device(self) -> torch.device:
        return self.data.device

    def col_index(self, attr: str) -> int:
        try:
            return self.attrs.index(attr)
        except ValueError:
            raise KeyError(f"attribute {attr!r} not in table {self.attrs}")

    def column(self, attr: str) -> torch.Tensor:
        return self.data[:, self.col_index(attr)]

    @property
    def valid_mask(self) -> torch.Tensor:
        return torch.arange(self.capacity, dtype=torch.int32,
                            device=self.device) < self.count

    def to(self, device: DeviceLike) -> "Table":
        """The same table on ``device`` (no copy if it is already there)."""
        dev = resolve_device(device)
        if self.data.device == dev:
            return self
        return Table(data=self.data.to(dev), count=self.count.to(dev),
                     attrs=self.attrs)

    # -- constructors --------------------------------------------------------
    @classmethod
    def empty(cls, attrs: Sequence[str], capacity: int,
              device: DeviceLike = None) -> "Table":
        dev = resolve_device(device)
        data = torch.full((capacity, len(attrs)), PAD_ID, dtype=torch.int32,
                          device=dev)
        return cls(data=data, count=torch.zeros((), dtype=torch.int32,
                                                device=dev),
                   attrs=tuple(attrs))

    @classmethod
    def from_codes(cls, codes: np.ndarray, attrs: Sequence[str],
                   capacity: int | None = None, *,
                   device: DeviceLike = None) -> "Table":
        """Build from an [n, k] int32 code matrix (host)."""
        codes = np.asarray(codes, dtype=np.int32)
        n, k = codes.shape
        if k != len(attrs):
            raise ValueError("codes width != len(attrs)")
        capacity = n if capacity is None else capacity
        if n > capacity:
            raise ValueError(f"{n} rows exceed capacity {capacity}")
        dev = resolve_device(device)
        data = np.full((capacity, k), PAD_ID, dtype=np.int32)
        data[:n] = codes
        return cls(data=torch.from_numpy(data).to(dev),
                   count=torch.tensor(n, dtype=torch.int32, device=dev),
                   attrs=tuple(attrs))

    @classmethod
    def from_records(cls, records: Iterable[Mapping[str, object]],
                     attrs: Sequence[str], vocab: Vocab,
                     capacity: int | None = None, *,
                     device: DeviceLike = None) -> "Table":
        """Intern host records (list of dicts) into a device table."""
        rows: List[List[int]] = []
        for rec in records:
            rows.append([vocab.intern(rec[a]) for a in attrs])
        codes = (np.asarray(rows, dtype=np.int32)
                 if rows else np.zeros((0, len(attrs)), np.int32))
        return cls.from_codes(codes, attrs, capacity, device=device)

    # -- host-side views (tests / sinks only) ---------------------------------
    def to_codes(self) -> np.ndarray:
        n = host_int(self.count)
        return host_get(self.data[:n])

    def to_records(self, vocab: Vocab) -> List[Dict[str, object]]:
        return [
            {a: vocab.decode(row[i]) for i, a in enumerate(self.attrs)}
            for row in self.to_codes()
        ]

    def row_set(self) -> set:
        """Set of valid rows as tuples — order-insensitive comparison."""
        return {tuple(int(x) for x in row) for row in self.to_codes()}

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return (f"Table(attrs={self.attrs}, capacity={self.capacity}, "
                f"device={self.device})")
