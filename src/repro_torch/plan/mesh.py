"""Fused distributed execution: the whole plan in one per-rank body.

``compile_mesh_plan`` is the mesh sibling of
:func:`repro_torch.plan.compile.compile_plan`: it lowers the optimized DAG
to ONE closure that every rank of a mesh runs on its own row blocks of the
sources (SPMD, one process per shard). Scan reads this rank's block, π/σ/∪
run on the block, every interior δ is a *global* hash-repartition δ,
every ⋈ moves its inputs with one of two cost-modelled exchange
strategies, ``EmitTriples`` semantifies the rank's rows, and the global
sink δ runs fused on the device. Intermediate triples never reach the
host: the only host reads in the body are the hash δ's fallback flags
(one per δ call, as on one device).

**Exact partition invariant.** Every relation node inside the body is an
exact *multiset* partition of its single-device value: Scans partition
rows, π/σ are row-wise, ∪ concatenates partitions, and an interior δ
repartitions by full-row hash
(:func:`repro_torch.core.distributed.repartition_by_key`) so every copy of
a row lands on one rank and the local δ after the exchange is globally
exact. Join exchanges keep the invariant on both sides, so the ranks' ⋈
outputs and emit counts sum to the single-device values — the mesh
``raw`` count (global per-map δ under ``sdm``, blind generation under
``rmlmapper``) equals :func:`compile_plan`'s exactly.

**⋈ exchange strategies** (picked per join at plan time by the cost model
in :mod:`repro_torch.plan.annotate`, passed as ``exchanges``):

* ``gather`` — the parent side is all-gathered (:func:`gather_table`) and
  each rank joins its child block against the full parent relation. One
  exchange (2 ``all_gather``: rows and counts), shared by every ⋈ on the
  same parent node.
* ``repartition`` — both sides are hashed on the join key and exchanged
  (2 ``all_to_all`` each: rows and counts), so each rank joins only its
  key range.

The collectives the body makes are exactly what
:func:`repro_torch.analysis.expected_collectives` counts for the plan:
nothing else runs inside it. Overflow flags of the exchanges are agreed
inside the exchanges themselves (each sender's bit rides in the counts
payload); the truncation flags of capped nodes are rank-local, and the
engine agrees them after the call (``KGEngine._run_mesh``).
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core.distributed import (_TRACE_COUNTS, gather_blocks,
                                          repartition_by_key,
                                          repartition_distinct_local,
                                          sink_bucket_cap)
from repro_torch.relalg import Table
from repro_torch.relalg.ops import _masked_data, _pad_like, compact, dedup_rows

from .compile import execute_node
from .ir import Node, Scan, iter_nodes
from .lower import LogicalPlan


def plan_scans(plan: LogicalPlan) -> Dict[str, Scan]:
    """The Scan node per source name reachable from the plan's emits —
    the sources the mesh closure receives as row blocks."""
    scans: Dict[str, Scan] = {}
    for emit in plan.emits():
        for node in iter_nodes(emit):
            if isinstance(node, Scan):
                scans[node.source] = node
    return scans


def gather_table(table: Table, group, n_shards: int) -> Table:
    """All-gather a rank-local table into the full relation on every rank.

    Concatenates every rank's valid rows and compacts. The blocks are
    exact multiset partitions of the global relation, so the gathered
    table IS the single-device relation, duplicates included: ⋈
    multiplicities (hence ``raw``) stay exact. Every rank of ``group``
    must call it together."""
    cap_local = table.capacity
    gdata, gcounts = gather_blocks(_masked_data(table), table.count, group,
                                   n_shards)
    idx = torch.arange(n_shards * cap_local, dtype=torch.int32,
                       device=gdata.device)
    valid = (idx % cap_local) < gcounts[idx // cap_local]
    data, count = compact(torch.where(valid[:, None], gdata,
                                      _pad_like(gdata)), valid)
    return Table(data=data, count=count, attrs=table.attrs)


def mesh_abstract_inputs(plan: LogicalPlan, cap_locals: Mapping[str, int],
                         n_shards: int) -> Tuple[Dict[str, Tuple[int, int]],
                                                 Dict[str, Tuple]]:
    """The shapes of one rank's closure inputs, as
    :func:`repro_torch.core.distributed.shard_table` lays them out:
    ``datas[name]`` ``(cap_locals[name], k)`` int32 and ``counts[name]``
    ``()`` int32 per scanned source. (The reference's abstract inputs
    describe the whole sharded array, ``n_shards`` blocks; a rank holds
    one.)"""
    scans = plan_scans(plan)
    datas = {name: (int(cap_locals[name]), len(scans[name].scan_attrs))
             for name in scans}
    counts = {name: () for name in scans}
    return datas, counts


def compile_mesh_plan(plan: LogicalPlan, emitter, mesh, axis: str,
                      engine: str = "rmlmapper", dedup: Optional[str] = None,
                      caps: Optional[Mapping[Node, int]] = None,
                      cap_locals: Optional[Mapping[str, int]] = None,
                      sink_slack: float = 1.0, pack_u16: bool = False,
                      exchanges: Optional[Mapping[Node, object]] = None,
                      safe_exchange: bool = False):
    """Lower the DAG to one per-rank closure ``run(datas, counts)``.

    ``datas[name] [cap_locals[name], k]`` / ``counts[name]`` (0-d) are
    this rank's block of each scanned source
    (:func:`repro_torch.core.distributed.shard_table`). Every rank calls
    ``run`` together; each gets ``(kg_data [out_cap_local, 5], kg_count,
    raw, overflowed, sink_overflowed)``: its shard of the globally
    deduplicated KG, its share of ``raw`` (the ranks' shares sum to the
    single-device plan's), whether any capped node truncated on this rank
    or any interior exchange overflowed on any rank (rebuild with
    ``safe_exchange=True``), and whether a sink exchange overflowed on
    any rank (rebuild with more ``sink_slack``).

    ``caps`` are SHARD-LOCAL node capacities (``annotate_local``);
    ``exchanges`` maps ⋈ nodes to their strategy (a
    :class:`repro_torch.plan.annotate.JoinExchange` or a plain string;
    unmapped joins gather); ``safe_exchange`` sizes every exchange bucket
    at ``cap_bucket = cap_local``, which cannot overflow; ``pack_u16``
    asserts every dictionary code fits 16 bits, so each all_to_all moves
    ceil(k/2) words per row."""
    n_shards = int(mesh.shape[axis])
    group = mesh.group_for(axis)
    emit_nodes = plan.emits()
    scans = plan_scans(plan)
    strategies = {node: getattr(x, "strategy", x)
                  for node, x in (exchanges or {}).items()}
    _TRACE_COUNTS["repartition"] += 1

    def _bucket_cap(cap_local: int, slack: float = 1.0) -> int:
        if n_shards == 1 or safe_exchange:
            return cap_local    # a rank sends at most its own rows to one
            # target, so cap_bucket = cap_local can never overflow
        return min(cap_local, sink_bucket_cap(cap_local, n_shards, slack))

    def run(datas: Mapping[str, torch.Tensor],
            counts: Mapping[str, torch.Tensor]):
        sources = {name: Table(data=datas[name],
                               count=counts[name].reshape(()),
                               attrs=scan.scan_attrs)
                   for name, scan in scans.items()}
        gathered: Dict[Node, Table] = {}
        exchanged: Dict[Tuple[Node, str], Table] = {}
        flags = []
        sink_flags = []

        def exchange_table(side_node: Node, table: Table,
                           key_attr: str) -> Table:
            """Key-partition one ⋈ side (memoized per (node, key))."""
            hit = exchanged.get((side_node, key_attr))
            if hit is None:
                data, cnt, over = repartition_by_key(
                    _masked_data(table), table.count, group=group,
                    n_shards=n_shards,
                    cap_bucket=_bucket_cap(table.capacity),
                    key_cols=(table.attrs.index(key_attr),),
                    pack_u16=pack_u16)
                flags.append(over)
                hit = exchanged[(side_node, key_attr)] = Table(
                    data=data, count=cnt, attrs=table.attrs)
            return hit

        def join_exchange(node: Node, left: Table, right: Table):
            if strategies.get(node) == "repartition":
                return (exchange_table(node.left, left, node.left_key),
                        exchange_table(node.right, right, node.right_key))
            hit = gathered.get(node.right)
            if hit is None:
                hit = gathered[node.right] = gather_table(right, group,
                                                          n_shards)
            return left, hit

        def global_distinct(table: Table, cap_bucket: int,
                            flag_list) -> Table:
            """Global δ: local δ -> rowhash repartition -> local δ. The
            first δ minimizes the exchanged rows; after the exchange every
            copy of a row is on one rank, so the second δ is globally
            exact. One rank needs no exchange."""
            data, cnt = dedup_rows(_masked_data(table), table.count, dedup)
            if n_shards > 1:
                data, cnt, over = repartition_by_key(
                    data, cnt, group=group, n_shards=n_shards,
                    cap_bucket=cap_bucket, key_cols=None,
                    pack_u16=pack_u16)
                flag_list.append(over)
                data, cnt = dedup_rows(data, cnt, dedup)
            return Table(data=data, count=cnt, attrs=table.attrs)

        def distinct_global(node: Node, child: Table) -> Table:
            return global_distinct(child, _bucket_cap(child.capacity),
                                   flags)

        memo: Dict[Node, Table] = {}
        per_map = [execute_node(e, sources, memo, emitter, dedup, caps,
                                flags, join_exchange=join_exchange,
                                distinct_global=distinct_global)
                   for e in emit_nodes]
        if engine == "sdm":
            # global per-map δ — the single-device raw semantics. Every
            # map's rows end up partitioned by the SAME full-row hash, so
            # the sink δ below is one local δ (no second exchange)
            per_map = [global_distinct(t, sink_bucket_cap(
                t.capacity, n_shards, sink_slack), sink_flags)
                for t in per_map]
        raw = torch.stack([t.count for t in per_map]).sum(dtype=torch.int32)

        data = torch.cat([_masked_data(t) for t in per_map], dim=0)
        mask = torch.cat([t.valid_mask for t in per_map])
        data, count = compact(data, mask)
        false = torch.zeros((), dtype=torch.bool, device=data.device)
        if engine == "sdm":
            # rows are rowhash-partitioned per map already: local δ = global
            kg_data, kg_count = dedup_rows(data, count, dedup)
            sink_over = torch.any(torch.stack(sink_flags)) if sink_flags \
                else false
        else:
            # the fused sink δ: this rank's triples repartitioned by
            # rowhash, so one local δ per rank is globally correct
            cap_bucket = sink_bucket_cap(data.shape[0], n_shards, sink_slack)
            kg_data, kg_count, sink_over = repartition_distinct_local(
                data, count, group=group, n_shards=n_shards,
                cap_bucket=cap_bucket, pack_u16=pack_u16, dedup=dedup)
        over = torch.any(torch.stack(flags)) if flags else false
        return (kg_data, kg_count.reshape(()), raw, over.reshape(()),
                sink_over.reshape(()))

    return run
