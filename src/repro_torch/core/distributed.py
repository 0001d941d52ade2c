"""Scaled-up MapSDI: the paper's dedup lifted onto a mesh of ranks.

The core primitive is :func:`repartition_by_key` — hash-partition a
rank's rows on a column subset and exchange them with one
``all_to_all_single`` so equal keys co-locate. Two consumers:

* **global duplicate elimination** (``key_cols=None``: the hash covers the
  whole row) over row-sharded tables in one collective pass:

      local δ  →  rowhash → hash-repartition (all_to_all)  →  local δ

  Equal rows hash identically, so after the exchange every duplicate
  group lives on exactly one rank and the second local δ is globally
  correct. The first local δ runs before the collective, so the exchange
  moves already-minimized data (Rule 1 applied to the links).
* **repartition-by-join-key ⋈ exchange** (``key_cols=(key,)``): both join
  sides partitioned on the key so each rank joins only its key range —
  the ``join_exchange="repartition"`` strategy of
  :func:`repro_torch.plan.mesh.compile_mesh_plan`.

Every rank runs the same code (SPMD, one process per shard); the
exchanges are collectives of the mesh's process group. Everything is
fixed-shape: each rank holds ``cap_local`` rows, each outgoing bucket
``cap_bucket`` rows. The bucketing is the ``radix_partition`` kernel with
one bucket per rank (any rank count). Bucket overflow is detected and
returned as a flag that every rank agrees on: each sender's bit rides in
the counts payload the exchange sends to every rank anyway, so the
agreement costs no collective of its own.
"""
from __future__ import annotations

import functools
from collections import Counter, OrderedDict
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.kernels.radix_partition import radix_partition
from repro_torch.kernels.rowhash import rowhash
from repro_torch.relalg import PAD_ID, Table
from repro_torch.relalg.guard import host_get, host_int
from repro_torch.relalg.ops import _columns, _pad_like, compact, dedup_rows
from repro_torch.relalg.table import pad_rows, round_cap


# ---------------------------------------------------------------------------
# rank-local body
# ---------------------------------------------------------------------------

# the partition calls of this process since the last reset, per (rows,
# columns, n_shards, cap_bucket, key_cols): the shapes the exchanges hand
# the radix kernel (the kernel checks re-run them)
_EXCHANGE_SHAPES: Counter = Counter()


def exchange_shapes() -> Dict[Tuple, int]:
    """``{(rows, columns, n_shards, cap_bucket, key_cols): calls}`` of the
    exchange partitions since the last :func:`reset_exchange_shapes`."""
    return dict(_EXCHANGE_SHAPES)


def reset_exchange_shapes() -> None:
    _EXCHANGE_SHAPES.clear()


def _partition_local(data: torch.Tensor, count, n_shards: int,
                     cap_bucket: int, use_kernel: Optional[bool] = None,
                     key_cols: Optional[Tuple[int, ...]] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Group this rank's valid rows into per-target-rank buckets.

    The target is ``rowhash(row[key_cols]) % n_shards`` (``key_cols=None``
    hashes the whole row — the global-δ partition; a subset repartitions
    a relation by join key). Returns (buckets [n_shards, cap_bucket, K],
    bucket_counts [n_shards], overflowed). The radix partition kernel on
    a CUDA tensor, its plain version on the CPU; bit-identical to
    :func:`_partition_local_sorted`, the sort-based oracle."""
    _EXCHANGE_SHAPES[(data.shape[0], data.shape[1], n_shards, cap_bucket,
                      None if key_cols is None else tuple(key_cols))] += 1
    return radix_partition(
        data, count, n_buckets=n_shards, cap_bucket=cap_bucket,
        key_cols=None if key_cols is None else tuple(key_cols),
        use_kernel=use_kernel)


def _partition_local_sorted(data: torch.Tensor, count, n_shards: int,
                            cap_bucket: int,
                            use_kernel: Optional[bool] = None,
                            key_cols: Optional[Tuple[int, ...]] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """Sort-based bucketization (a stable sort on the target, bucket
    boundaries by ``searchsorted``, a scatter): the oracle the
    differential tests hold :func:`_partition_local` against."""
    cap_local, k = data.shape
    dev = data.device
    valid = torch.arange(cap_local, dtype=torch.int32, device=dev) < count
    data = torch.where(valid[:, None], data, _pad_like(data))
    keyed = data if key_cols is None else _columns(data, key_cols)
    h = rowhash(keyed, use_kernel=use_kernel)
    target = torch.where(valid, h % n_shards, n_shards)
    order_key, order = torch.sort(target, stable=True)
    rows_sorted = data[order]
    shard_ids = torch.arange(n_shards, dtype=order_key.dtype, device=dev)
    starts = torch.searchsorted(order_key, shard_ids)
    ends = torch.searchsorted(order_key, shard_ids, right=True)
    counts = ends - starts
    overflow = torch.any(counts > cap_bucket)
    pos_within = torch.arange(cap_local, device=dev) - \
        starts[torch.clamp(order_key, 0, n_shards - 1)]
    ok = (order_key < n_shards) & (pos_within < cap_bucket)
    dest = torch.where(ok, order_key * cap_bucket + pos_within,
                       n_shards * cap_bucket)
    buckets = torch.full((n_shards * cap_bucket + 1, k), PAD_ID,
                         dtype=torch.int32, device=dev)
    buckets[dest] = rows_sorted
    return (buckets[:-1].reshape(n_shards, cap_bucket, k),
            torch.clamp(counts, max=cap_bucket).to(torch.int32), overflow)


def pack_u16_pairs(data: torch.Tensor) -> torch.Tensor:
    """[N, K] int32 codes (all in [0, 65535]) -> [N, ceil(K/2)] int32.

    Halves an exchange's payload when every dictionary code fits 16 bits
    (checked on the host from the vocab). int32 shifts wrap, so the
    packed word's bits equal the reference's uint32 ones."""
    n, k = data.shape
    if k % 2:
        data = torch.cat([data, torch.zeros((n, 1), dtype=torch.int32,
                                            device=data.device)], dim=1)
    lo = data[:, 0::2] & 0xFFFF
    hi = data[:, 1::2] & 0xFFFF
    return (lo | (hi << 16)).contiguous()


def unpack_u16_pairs(packed: torch.Tensor, k: int) -> torch.Tensor:
    """Inverse of :func:`pack_u16_pairs` (original column count ``k``)."""
    lo = packed & 0xFFFF
    hi = (packed >> 16) & 0xFFFF
    out = torch.stack([lo, hi], dim=-1).reshape(packed.shape[0], -1)
    return out[:, :k].contiguous()


def repartition_by_key(data: torch.Tensor, count, *, group,
                       n_shards: int, cap_bucket: int,
                       key_cols: Optional[Tuple[int, ...]] = None,
                       use_kernel: Optional[bool] = None,
                       pack_u16: bool = False
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hash-repartition this rank's valid rows by ``key_cols``.

    The exchange primitive behind every mesh-plan collective, run by
    every rank of ``group`` together. Rows are hashed on ``key_cols``
    (``None`` = all columns), grouped into per-target buckets of
    ``cap_bucket`` rows, exchanged with one ``all_to_all_single``, and
    compacted; a second ``all_to_all_single`` carries the bucket counts
    with each sender's overflow bit. Takes this rank's ``data [cap_local,
    k]`` / 0-d ``count``; returns ``(data [n_shards * cap_bucket, k],
    count, overflow)`` — the rows whose key hashes to this rank, and a
    flag equal on every rank: True iff some rank's bucket exceeded
    ``cap_bucket`` and rows were dropped (``cap_bucket >= cap_local``
    never overflows)."""
    count = count.reshape(())
    k_cols = data.shape[1]
    # 1. bucket by key hash
    buckets, bcounts, overflow = _partition_local(
        data, count, n_shards, cap_bucket, use_kernel, key_cols)
    # 2. exchange buckets: rank j receives every rank's bucket j
    send = buckets.reshape(n_shards * cap_bucket, k_cols)
    if pack_u16:   # halve the wire bytes
        send = pack_u16_pairs(send)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if pack_u16:
        recv = unpack_u16_pairs(recv, k_cols)
    # the counts payload: (bucket count, the sender's overflow bit), so
    # every rank ends with every sender's bit (the reference's pmax)
    meta = torch.stack([bcounts, overflow.to(torch.int32).expand(n_shards)],
                       dim=1)
    recv_meta = torch.empty_like(meta)
    dist.all_to_all_single(recv_meta, meta, group=group)
    overflow = torch.any(recv_meta[:, 1] != 0)
    # 3. flatten + compact (validity from the counts, so u16 packing of
    # PAD rows round-trips harmlessly: they are re-masked here)
    total = n_shards * cap_bucket
    idx = torch.arange(total, dtype=torch.int32, device=data.device)
    valid = (idx % cap_bucket) < recv_meta[:, 0][idx // cap_bucket]
    flat, n = compact(torch.where(valid[:, None], recv, _pad_like(recv)),
                      valid)
    return flat, n, overflow


def repartition_distinct_local(data: torch.Tensor, count, *, group,
                               n_shards: int, cap_bucket: int,
                               use_kernel: Optional[bool] = None,
                               pack_u16: bool = False,
                               dedup: Optional[str] = None
                               ) -> Tuple[torch.Tensor, torch.Tensor,
                                          torch.Tensor]:
    """Per-rank body: local δ -> hash partition -> all_to_all -> local δ.

    The plan-level global-δ primitive, consumed by
    :func:`make_repartition_distinct` and by the fused mesh plan's
    rmlmapper sink. Returns ``(data [n_shards * cap_bucket, k], count
    [1], overflow [1])`` — the globally deduplicated rows that hash to
    this rank. Both local δ passes go through
    :func:`repro_torch.relalg.ops.dedup_rows`, so the single-device and
    mesh paths share one δ and one ``dedup`` strategy."""
    count = count.reshape(())
    data, count = dedup_rows(data, count, dedup)
    flat, n, overflow = repartition_by_key(
        data, count, group=group, n_shards=n_shards, cap_bucket=cap_bucket,
        key_cols=None, use_kernel=use_kernel, pack_u16=pack_u16)
    flat, n = dedup_rows(flat, n, dedup)
    return flat, n.reshape(1), overflow.reshape(1)


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------

# builds of a shard body in this process: a cached closure's reuse keeps
# this flat
_TRACE_COUNTS = {"repartition": 0}

# (mesh, axis, shapes, strategy) -> (run, out cap per rank): built
# repartition-distinct closures, so repeated distributed δ calls over
# same-bucket shapes never rebuild
_CLOSURE_CACHE: "OrderedDict[Tuple, Tuple]" = OrderedDict()
_CLOSURE_CACHE_MAX = 32


def repartition_trace_count() -> int:
    """Process-wide count of shard-body builds (the reuse guard). The
    reference counts traces of its ``shard_map`` body; the port's bodies
    run eagerly, so it counts the builds of :func:`make_repartition_distinct`
    closures and of :func:`repro_torch.plan.mesh.compile_mesh_plan`
    closures instead."""
    return _TRACE_COUNTS["repartition"]


def sink_bucket_cap(cap_local: int, n_shards: int, slack: float = 1.0) -> int:
    """Per-target-rank bucket capacity for the hash repartition.

    A Poisson tail bound: a mixing hash spreads rows ~uniformly, so bucket
    occupancy ≈ Poisson(m) with ``m = cap_local / n_shards``, and
    ``m + 6·sqrt(m) + 8`` bounds the max bucket far tighter than a blanket
    2× at large m. ``slack`` multiplies the bound; overflow is still
    detected and flagged for a re-run."""
    m = cap_local / n_shards
    return max(8, int(np.ceil((m + 6.0 * np.sqrt(m) + 8) * slack)))


def make_repartition_distinct(mesh, axis: str, cap_local: int, k: int,
                              slack: float = 1.0,
                              use_kernel: Optional[bool] = None,
                              pack_u16: bool = False,
                              dedup: Optional[str] = None,
                              cache: bool = True):
    """Build the global distinct over a row-sharded matrix.

    ``run(data, count)`` takes this rank's block ``data [cap_local, k]``
    and its 0-d ``count``, and returns ``(data [out_cap_local, k], count,
    overflow)`` with the flag agreed across ranks; every rank calls it
    together. Returns ``(run, out_cap_local)``. ``pack_u16``: the caller
    asserts every code fits 16 bits. ``cache=True`` memoizes the closure
    on (mesh, axis, shapes, strategy);
    :func:`repartition_trace_count` observes the reuse."""
    key = (mesh.key(), axis, cap_local, k, slack, use_kernel, pack_u16,
           dedup)
    if cache:
        hit = _CLOSURE_CACHE.get(key)
        if hit is not None:
            _CLOSURE_CACHE.move_to_end(key)
            return hit
    _TRACE_COUNTS["repartition"] += 1
    n_shards = int(mesh.shape[axis])
    cap_bucket = sink_bucket_cap(cap_local, n_shards, slack)
    body = functools.partial(repartition_distinct_local,
                             group=mesh.group_for(axis), n_shards=n_shards,
                             cap_bucket=cap_bucket, use_kernel=use_kernel,
                             pack_u16=pack_u16, dedup=dedup)

    def run(data: torch.Tensor, count):
        out, n, overflow = body(data, count)
        return out, n.reshape(()), overflow.reshape(())

    result = (run, cap_bucket * n_shards)
    if cache:
        _CLOSURE_CACHE[key] = result
        while len(_CLOSURE_CACHE) > _CLOSURE_CACHE_MAX:
            _CLOSURE_CACHE.popitem(last=False)
    return result


def shard_table(table: Table, mesh, axis: str,
                cap_local: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """This rank's round-robin block of a table's valid rows; returns
    ``(data [cap_local, k], count, cap_local)`` on the mesh's device.

    Rank ``r`` of ``n`` takes rows ``[r·per, (r+1)·per)`` with ``per =
    ceil(rows / n)`` (every rank holds the whole table and keeps its
    block: one host read, the row count). ``cap_local`` overrides the
    exact-fit block capacity — the engine passes a capacity bucket so the
    closure is shape-stable across ingests."""
    n_shards = int(mesh.shape[axis])
    total = host_int(table.count)
    per = -(-max(1, total) // n_shards)
    if cap_local is None:
        cap_local = max(8, round_cap(per))
    elif cap_local < per:
        raise ValueError(f"cap_local {cap_local} < {per} rows per shard")
    lo = min(mesh.rank * per, total)
    hi = min(lo + per, total)
    block = table.data[lo:hi].to(mesh.device)
    data = pad_rows(block, cap_local).contiguous()
    count = torch.full((), hi - lo, dtype=torch.int32, device=mesh.device)
    return data, count, cap_local


def gather_blocks(data: torch.Tensor, count, group, n_shards: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Every rank's fixed-shape block and count: ``(data [n_shards ·
    cap, k], counts [n_shards])`` on every rank (two ``all_gather``)."""
    blocks = [torch.empty_like(data) for _ in range(n_shards)]
    dist.all_gather(blocks, data.contiguous(), group=group)
    count = count.reshape(1).to(torch.int32)
    counts = [torch.empty_like(count) for _ in range(n_shards)]
    dist.all_gather(counts, count, group=group)
    return torch.cat(blocks, dim=0), torch.cat(counts)


def unshard_rows(data: torch.Tensor, counts, cap_local: int
                 ) -> torch.Tensor:
    """The valid rows of gathered blocks (``data [n · cap_local, k]``,
    ``counts`` per block, host ints), in rank order."""
    parts = [data[s * cap_local:s * cap_local + int(c)]
             for s, c in enumerate(counts)]
    return torch.cat(parts, dim=0) if parts else data[:0]


def distributed_distinct_table(table: Table, mesh, axis: str = "data",
                               slack: float = 1.0,
                               use_kernel: Optional[bool] = None,
                               pack_u16: Optional[bool] = None,
                               dedup: Optional[str] = None,
                               cap_local: Optional[int] = None
                               ) -> Tuple[Table, bool]:
    """Convenience end-to-end, every rank together: shard -> global
    distinct -> gather. Returns (the distinct rows in rank order, as a
    table on every rank; the agreed overflow flag).

    ``pack_u16=None`` packs when every valid code fits 16 bits. ``dedup``
    picks the rank-local δ strategy. ``cap_local`` pins the per-rank
    capacity (see :func:`shard_table`) so repeated calls reuse one cached
    closure."""
    if pack_u16 is None:
        rows_np = table.to_codes()
        pack_u16 = bool(rows_np.size == 0
                        or (rows_np.min() >= 0 and rows_np.max() < 65536))
    data, count, cap_local = shard_table(table, mesh, axis, cap_local)
    run, out_cap_local = make_repartition_distinct(
        mesh, axis, cap_local, table.n_attrs, slack, use_kernel,
        pack_u16=pack_u16, dedup=dedup)
    out, n, overflow = run(data, count)
    n_shards = int(mesh.shape[axis])
    gdata, gcounts = gather_blocks(out, n, mesh.group_for(axis), n_shards)
    rows = unshard_rows(gdata, host_get(gcounts), out_cap_local)
    total = rows.shape[0]
    out_table = Table(data=pad_rows(rows, round_cap(total)),
                      count=torch.full((), total, dtype=torch.int32,
                                       device=rows.device),
                      attrs=table.attrs)
    return out_table, bool(host_int(overflow))
