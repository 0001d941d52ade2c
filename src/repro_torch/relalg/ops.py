"""Masked fixed-shape relational operators on :class:`Table`.

Outputs have static capacities and a 0-d device ``count`` of valid rows.
Padding rows carry ``PAD_ID`` in every column so lexicographic sorts push
them to the end. These are the building blocks the MapSDI transformation
rules are defined over: projection (Rules 1/2), union+rename (Rule 3),
distinct (duplicate elimination) and the sort-merge equi-join behind
join conditions.

Duplicate elimination (δ) comes in two strategies with identical row sets
(the lex strategy returns them in lexicographic order, the hash strategy
in hash order):

* ``"lex"``  — a K-key lexicographic sort (a chain of stable sorts, last
  column first), then a neighbour compare. Always exact.
* ``"hash"`` — the default: the ``rowhash`` kernel turns each row into a
  32-bit key, one stable single-key sort carries the row permutation, and
  the fused hash+neighbour-flag kernel verifies full-row equality of
  sorted neighbours. At :data:`RADIX_DEDUP_MIN_ROWS` rows the global sort
  is replaced by the ``radix_partition`` kernel plus per-bucket sorts.

The reference selects its exact fallbacks (32-bit collision, bucket
overflow, PAD-content merge) on the device with ``lax.cond``. Here each
hash δ call reads one 0-d flag to the host (through :func:`host_int`, so
the read is counted) and runs only the branch it needs.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch.kernels.radix_partition import radix_partition
from repro_torch.kernels.rowhash import hash_neighbor_flags, rowhash

from .encoding import PAD_ID
from .guard import host_int
from .table import Table, bucket_cap, pad_rows

# Engine-wide default δ strategy.
DEFAULT_DEDUP = "hash"

# The hash δ swaps its single global sort for a radix partition + per-bucket
# sorts once the matrix has this many rows.
RADIX_DEDUP_MIN_ROWS = 4096
RADIX_DEDUP_BUCKETS = 8

_UINT32_MAX = 0xFFFFFFFF

# Hash-δ bookkeeping since the last reset: calls per (layout, capacity, K),
# and the exact fallbacks taken, per trigger. The same run on the card and
# on the CPU must agree on both (the kernels' flags equal the plain ones).
_HASH_DEDUP_CALLS: Counter = Counter()
_HASH_DEDUP_FALLBACKS: Counter = Counter()
_RADIX_TRIGGERS = ("radix_overflow", "radix_collision", "radix_pad_merge")


def hash_dedup_counts() -> Dict[str, dict]:
    """``{"calls": {(layout, capacity, K): n}, "fallbacks": {trigger:
    n}}`` since the last :func:`reset_hash_dedup_counts`."""
    return {"calls": dict(_HASH_DEDUP_CALLS),
            "fallbacks": dict(_HASH_DEDUP_FALLBACKS)}


def reset_hash_dedup_counts() -> None:
    _HASH_DEDUP_CALLS.clear()
    _HASH_DEDUP_FALLBACKS.clear()


def _resolve_dedup(dedup: Optional[str]) -> str:
    strategy = DEFAULT_DEDUP if dedup is None else dedup
    if strategy not in ("lex", "hash"):
        raise ValueError(f"unknown dedup strategy {strategy!r} "
                         "(expected 'lex' or 'hash')")
    return strategy


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _pad_like(data: torch.Tensor) -> torch.Tensor:
    # a fill on the device: ``torch.tensor(PAD_ID, device=...)`` would copy
    # from the host, which on a CUDA device blocks until the stream drains
    return torch.full((), PAD_ID, dtype=torch.int32, device=data.device)


def _columns(data: torch.Tensor, idx: Sequence[int]) -> torch.Tensor:
    """``data[:, idx]`` from column views: a Python list index is first
    copied to the device, a blocking host-to-device copy on CUDA."""
    if not idx:
        return data[:, :0]
    return torch.stack([data[:, i] for i in idx], dim=1)


def _masked(data: torch.Tensor, count) -> torch.Tensor:
    """``data`` with rows ``>= count`` forced to PAD_ID in every column."""
    valid = torch.arange(data.shape[0], dtype=torch.int32,
                         device=data.device) < count
    return torch.where(valid[:, None], data, _pad_like(data))


def _masked_data(table: Table) -> torch.Tensor:
    """Table data with padding rows forced to PAD_ID in every column."""
    return _masked(table.data, table.count)


def compact(data: torch.Tensor, keep: torch.Tensor
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scatter rows with ``keep`` set to the front; return (data, count).

    Dropped rows are written to one slack row past the capacity, which is
    sliced off (the reference's out-of-range ``mode="drop"`` write)."""
    capacity = data.shape[0]
    keep = keep.to(torch.int32)
    pos = torch.cumsum(keep, 0, dtype=torch.int32) - 1
    dest = torch.where(keep == 1, pos, capacity).long()
    out = torch.full((capacity + 1, data.shape[1]), PAD_ID,
                     dtype=torch.int32, device=data.device)
    out[dest] = data
    return out[:capacity], keep.sum(dtype=torch.int32)


def _lex_perm(masked: torch.Tensor) -> torch.Tensor:
    """Row permutation sorting ``masked`` lexicographically by all columns
    as signed int32 (PAD last): stable sorts from the last column to the
    first."""
    perm = torch.arange(masked.shape[0], device=masked.device)
    for c in reversed(range(masked.shape[1])):
        order = torch.sort(masked[perm, c], stable=True).indices
        perm = perm[order]
    return perm


def sort_lex(table: Table) -> torch.Tensor:
    """Rows sorted lexicographically by all columns; padding last."""
    masked = _masked_data(table)
    return masked[_lex_perm(masked)]


# ---------------------------------------------------------------------------
# unary operators
# ---------------------------------------------------------------------------

def project(table: Table, attrs: Sequence[str]) -> Table:
    """π_attrs — keep only ``attrs`` (bag semantics: rows unchanged)."""
    idx = [table.col_index(a) for a in attrs]
    return Table(data=_columns(table.data, idx), count=table.count,
                 attrs=tuple(attrs))


def project_as(table: Table, spec: Sequence[Tuple[str, str]]) -> Table:
    """π with renaming: ``spec`` is ``[(source_attr, new_name), ...]``.

    A source attribute may appear several times (needed when one attribute
    plays multiple roles after a Rule-3 merge).
    """
    names = [n for _, n in spec]
    if len(set(names)) != len(names):
        raise ValueError(f"project_as produces duplicate attrs: {names}")
    idx = [table.col_index(a) for a, _ in spec]
    return Table(data=_columns(table.data, idx), count=table.count,
                 attrs=tuple(names))


def rename(table: Table, mapping: Mapping[str, str]) -> Table:
    """ρ — rename attributes (data untouched)."""
    new_attrs = tuple(mapping.get(a, a) for a in table.attrs)
    if len(set(new_attrs)) != len(new_attrs):
        raise ValueError(f"rename produces duplicate attrs: {new_attrs}")
    return Table(data=table.data, count=table.count, attrs=new_attrs)


def select_mask(table: Table, mask: torch.Tensor) -> Table:
    """σ — keep rows where ``mask`` holds (and the row is valid)."""
    keep = mask & table.valid_mask
    data, count = compact(table.data, keep)
    return Table(data=data, count=count, attrs=table.attrs)


def select_eq(table: Table, attr: str, code: int) -> Table:
    return select_mask(table, table.column(attr) == int(code))


def select_neq(table: Table, attr: str, code: int) -> Table:
    return select_mask(table, table.column(attr) != int(code))


def distinct_rows(data: torch.Tensor, count
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matrix-level lex δ: ``data[N, K]`` with ``count`` valid rows ->
    deduplicated ``(data, count)``. Lexicographic full-row sort, then
    first-occurrence compaction. Always exact; also the collision fallback
    of :func:`distinct_rows_hashed`."""
    capacity = data.shape[0]
    masked = _masked(data, count)
    sorted_data = masked[_lex_perm(masked)]
    prev = torch.roll(sorted_data, 1, dims=0)
    first = torch.any(sorted_data != prev, dim=1)
    first[:1].fill_(True)   # a fill, not a copy of a host scalar
    valid = torch.arange(capacity, dtype=torch.int32,
                         device=data.device) < count
    return compact(sorted_data, first & valid)


def distinct_rows_hashed(data: torch.Tensor, count, *,
                         hash_fn: Optional[Callable[[torch.Tensor],
                                                    torch.Tensor]] = None,
                         radix: Optional[bool] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matrix-level hash-first δ — the same row set and count as
    :func:`distinct_rows`, in hash order.

    Two layouts share the hash-first idea; both end in the fused
    hash+neighbour-flag pass and a first-occurrence compaction:

    * **sorted** — one stable single-key sort on the 32-bit row hash
      carrying the row permutation;
    * **radix** — an order-preserving radix partition into
      :data:`RADIX_DEDUP_BUCKETS` buckets (bucket = the hash's top bits,
      so concatenated buckets stay in global hash order) followed by
      independent per-bucket stable sorts. Picked automatically at
      :data:`RADIX_DEDUP_MIN_ROWS` rows (``radix`` overrides); falls back
      to the sorted layout on bucket overflow.

    A collision (equal hash, unequal rows, adjacent after the sort) makes
    the neighbour keep-mask inexact and routes the call through the exact
    lex path.

    ``hash_fn`` overrides the row hash (tests force collisions with it);
    the plain flag path and the sorted layout are used then, since the
    kernels hard-code the production hash.
    """
    capacity = data.shape[0]
    if radix is None:
        radix = hash_fn is None and capacity >= RADIX_DEDUP_MIN_ROWS
    if radix and hash_fn is None:
        return _distinct_hashed_radix(data, count)
    return _distinct_hashed_sorted(data, count, hash_fn=hash_fn)


def _prev_valid(valid_s: torch.Tensor) -> torch.Tensor:
    prev = torch.roll(valid_s, 1)
    prev[:1].fill_(False)   # a fill, not a copy of a host scalar
    return prev


def _distinct_hashed_sorted(data: torch.Tensor, count, *,
                            hash_fn: Optional[Callable[[torch.Tensor],
                                                       torch.Tensor]] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-global-sort layout of the hash δ."""
    capacity = data.shape[0]
    _HASH_DEDUP_CALLS["sorted", capacity, data.shape[1]] += 1
    idx = torch.arange(capacity, dtype=torch.int32, device=data.device)
    valid_in = idx < count
    masked = torch.where(valid_in[:, None], data, _pad_like(data))

    h = (rowhash(masked) if hash_fn is None
         else hash_fn(masked).to(torch.int64))
    # padding sorts last: the stable sort keeps valid rows (smaller
    # original index) ahead of pads even when a valid row hashes to max
    h = torch.where(valid_in, h, _UINT32_MAX)
    perm = torch.sort(h, stable=True).indices
    rows = masked[perm]
    valid_s = perm < count

    if hash_fn is None:
        _, keep_raw, coll_raw = hash_neighbor_flags(rows)
        keep_raw = keep_raw.bool()
        coll_raw = coll_raw.bool()
    else:
        hs = h[perm]
        row_eq = torch.all(rows == torch.roll(rows, 1, dims=0), dim=1)
        hash_eq = hs == torch.roll(hs, 1)
        keep_raw = ~(hash_eq & row_eq)
        coll_raw = hash_eq & ~row_eq
        keep_raw[:1].fill_(True)
        coll_raw[:1].fill_(False)

    collision = torch.any(coll_raw & valid_s & _prev_valid(valid_s))
    if host_int(collision):
        _HASH_DEDUP_FALLBACKS["sorted_collision"] += 1
        return distinct_rows(data, count)
    return compact(rows, keep_raw & valid_s)


def _radix_dedup_cap(capacity: int, n_buckets: int) -> int:
    """Per-bucket capacity: Poisson mean + 6σ slack (overflow falls
    back)."""
    m = capacity / n_buckets
    return max(8, int(-(-(m + 6.0 * m ** 0.5 + 8.0) // 1)))


def _distinct_hashed_radix(data: torch.Tensor, count
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Radix-bucketed layout of the hash δ.

    The order-preserving partition buckets rows by the hash's top bits and
    keeps original order inside each bucket, so per-bucket stable sorts on
    the hash concatenate to exactly the global stable hash order.

    Two extra fallback triggers relative to the sorted layout: bucket
    overflow (skewed hashes would drop rows), and a valid row whose content
    is all PAD_ID sitting right after a bucket's padding tail, where the
    neighbour compare would merge it into the padding. Either re-runs the
    sorted layout (identical output, just slower).
    """
    capacity, k = data.shape
    _HASH_DEDUP_CALLS["radix", capacity, k] += 1
    nb = RADIX_DEDUP_BUCKETS
    cb = _radix_dedup_cap(capacity, nb)
    buckets, counts, overflow = radix_partition(
        data, count, n_buckets=nb, cap_bucket=cb, order_preserving=True)

    flat = buckets.reshape(nb * cb, k)
    h = rowhash(flat).reshape(nb, cb)
    pos = torch.arange(cb, dtype=torch.int32, device=data.device)[None, :]
    valid2d = pos < counts[:, None]
    h = torch.where(valid2d, h, _UINT32_MAX)        # pads sort last
    perm = torch.sort(h, dim=1, stable=True).indices
    rows = torch.gather(buckets, 1, perm[..., None].expand(nb, cb, k)
                        ).reshape(nb * cb, k)
    # valid rows occupy each bucket's head before AND after the stable
    # sort, so the validity mask needs no permuting
    valid_s = valid2d.reshape(nb * cb)

    _, keep_raw, coll_raw = hash_neighbor_flags(rows)
    keep_raw = keep_raw.bool()
    coll_raw = coll_raw.bool()
    prev_valid = _prev_valid(valid_s)
    collision = torch.any(coll_raw & valid_s & prev_valid)
    pad_merge = torch.any(~keep_raw & valid_s & ~prev_valid)
    # one host read for the three triggers, packed one bit each
    fell_back = host_int(overflow.to(torch.int32)
                         | collision.to(torch.int32) << 1
                         | pad_merge.to(torch.int32) << 2)
    if fell_back:
        for bit, trigger in enumerate(_RADIX_TRIGGERS):
            if fell_back >> bit & 1:
                _HASH_DEDUP_FALLBACKS[trigger] += 1
        return _distinct_hashed_sorted(data, count)
    out, n = compact(rows, keep_raw & valid_s)
    # the δ output fits the input capacity and compact fronts the kept
    # rows, so the slack tail is all-PAD
    return out[:capacity], n


def dedup_rows(data: torch.Tensor, count, dedup: Optional[str] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Matrix-level δ under the selected strategy (None = engine default)."""
    if _resolve_dedup(dedup) == "lex":
        return distinct_rows(data, count)
    return distinct_rows_hashed(data, count)


def distinct(table: Table, dedup: Optional[str] = None) -> Table:
    """δ — eliminate duplicate rows (set semantics) under ``dedup``
    (``"lex"`` | ``"hash"``; None = :data:`DEFAULT_DEDUP`)."""
    data, count = dedup_rows(table.data, table.count, dedup)
    return Table(data=data, count=count, attrs=table.attrs)


# ---------------------------------------------------------------------------
# binary operators
# ---------------------------------------------------------------------------

def union(a: Table, b: Table, dedup: bool | str = False) -> Table:
    """∪ — concatenate rows (b's columns aligned to a's attr order).

    ``dedup=False`` is bag-union; ``True`` set-union under the default δ
    strategy; a strategy string set-union under that strategy.
    """
    if set(a.attrs) != set(b.attrs):
        raise ValueError(f"union schema mismatch: {a.attrs} vs {b.attrs}")
    b_aligned = project(b, a.attrs)
    data = torch.cat([_masked_data(a), _masked_data(b_aligned)], dim=0)
    keep = torch.cat([a.valid_mask, b_aligned.valid_mask])
    data, count = compact(data, keep)
    out = Table(data=data, count=count, attrs=a.attrs)
    if dedup is False:
        return out
    return distinct(out, dedup=None if dedup is True else dedup)


def append_rows(base: Table, delta: Table,
                capacity: Optional[int] = None) -> Table:
    """Append ``delta``'s valid rows after ``base``'s (micro-batch
    ingestion), columns aligned by name.

    When the combined rows fit ``base.capacity`` the write lands in the
    padding region and the output keeps base's shape; otherwise the buffer
    grows to ``capacity`` (default: the next :func:`bucket_cap` bucket),
    which changes the shape — the caller's rebuild signal.

    Host cost: two scalar reads (the row counts); row data stays on device.
    """
    aligned = project(delta.to(base.device), base.attrs)
    n0, n1 = host_int(base.count), host_int(aligned.count)
    total = n0 + n1
    data = _masked_data(base)
    if total > base.capacity:
        cap = bucket_cap(total) if capacity is None else capacity
        if cap < total:
            raise ValueError(f"{total} rows exceed capacity {cap}")
        data = pad_rows(data, cap)
    cap = data.shape[0]
    idx = torch.arange(aligned.capacity, device=base.device)
    dest = torch.where(idx < n1, idx + n0, cap)     # invalid rows -> dropped
    out = pad_rows(data, cap + 1)
    out[dest] = _masked_data(aligned)
    return Table(data=out[:cap],
                 count=torch.full((), total, dtype=torch.int32,
                                  device=base.device),
                 attrs=base.attrs)


def equi_join(left: Table, right: Table, left_key: str, right_key: str,
              out_capacity: int, right_suffix: str = "r_",
              ) -> Tuple[Table, torch.Tensor]:
    """⋈ — sort-merge equi-join with a static output capacity.

    Returns ``(table, total_matches)``; ``total_matches`` may exceed the
    capacity (overflow detection is the caller's job).

    Output attrs: left attrs followed by right attrs; right-side names that
    collide with a left name get ``right_suffix`` prepended.
    """
    dev = left.device
    pad = _pad_like(left.data)
    lk = torch.where(left.valid_mask, left.column(left_key), pad)
    rk = torch.where(right.valid_mask, right.column(right_key), pad)

    cap_l, cap_r = left.capacity, right.capacity
    rk_sorted, perm = torch.sort(rk, stable=True)
    rk_sorted = rk_sorted.contiguous()
    lo = torch.searchsorted(rk_sorted, lk, out_int32=True)
    hi = torch.searchsorted(rk_sorted, lk, right=True, out_int32=True)
    counts = torch.where(left.valid_mask & (lk != PAD_ID), hi - lo, 0)

    offsets = torch.cumsum(counts, 0, dtype=torch.int32)   # inclusive
    starts = offsets - counts
    total = (offsets[cap_l - 1] if cap_l > 0
             else torch.zeros((), dtype=torch.int32, device=dev))

    j = torch.arange(out_capacity, dtype=torch.int32, device=dev)
    left_idx = torch.searchsorted(offsets, j, right=True, out_int32=True)
    left_idx_c = torch.clamp(left_idx, 0, cap_l - 1).long()
    within = j - starts[left_idx_c]
    right_pos = torch.clamp(lo[left_idx_c] + within, 0, cap_r - 1).long()
    right_idx = perm[right_pos]
    valid_out = j < torch.clamp(total, max=out_capacity)

    rows = torch.cat([left.data[left_idx_c], right.data[right_idx]], dim=1)
    rows = torch.where(valid_out[:, None], rows, pad)

    left_names = set(left.attrs)
    right_attrs = tuple(
        (right_suffix + a) if a in left_names else a for a in right.attrs)
    out = Table(data=rows, count=torch.clamp(total, max=out_capacity),
                attrs=left.attrs + right_attrs)
    return out, total
