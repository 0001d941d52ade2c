"""Distributed query execution: the whole BGP in one per-rank closure.

The mesh sibling of :func:`repro_torch.query.compile.compile_query`,
built from the same collective machinery as
:func:`repro_torch.plan.mesh.compile_mesh_plan`: every rank of the mesh
(SPMD, one process per shard) runs the closure over its own row block of
the KG table; σ/π/``ColEq`` run on the block, every ⋈ moves its sides
with the cost-modelled exchange the annotator picked (``gather`` the
right side vs hash-``repartition`` both sides on the join key), and every
δ — the root's included — is a global hash-repartition δ (a local δ, the
exchange, a second local δ). Self-joins of the KG against itself work
unchanged: both ⋈ inputs derive from the same rank-local Scan block, and
the exchange re-co-locates rows by join key, so the ranks' outputs are
exact multiset partitions of the single-device relation.

The closure returns this rank's part of the root (``out_data
[out_cap_local, k]`` and its 0-d count) plus the rank-local overflow flag
(the exchanges' own overflow bits are already agreed inside them; the
truncation flags of capped nodes are not, so the engine agrees the flag
after the call). The engine gathers the rows once and runs one canonical
δ over them, as ``KGEngine._run_mesh`` does for the KG — which makes the
mesh answer bit-identical to the single-device one. The collectives the
closure makes are exactly what
:func:`repro_torch.analysis.expected_query_collectives` counts.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch

from repro_torch.core.distributed import repartition_by_key, sink_bucket_cap
from repro_torch.plan.compile import execute_node
from repro_torch.plan.ir import Node
from repro_torch.plan.mesh import gather_table
from repro_torch.relalg import Table
from repro_torch.relalg.ops import _masked_data, dedup_rows

from .lower import QueryPlan, query_scan


def query_mesh_abstract_inputs(cap_local: int, n_shards: int
                               ) -> Tuple[Tuple[int, int], Tuple]:
    """The shapes of one rank's closure inputs, as
    :func:`repro_torch.core.distributed.shard_table` lays them out:
    ``data`` ``(cap_local, 5)`` int32 and a 0-d ``count`` — the query
    analogue of :func:`repro_torch.plan.mesh.mesh_abstract_inputs`. (The
    reference's abstract inputs describe the whole sharded array,
    ``n_shards`` blocks; a rank holds one, so ``n_shards`` only checks
    the mesh size.)"""
    if int(n_shards) < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    return (int(cap_local), 5), ()


def compile_query_mesh(plan: QueryPlan, mesh, axis: str,
                       dedup: Optional[str] = None,
                       caps: Optional[Mapping[Node, int]] = None,
                       cap_local: int = 0, pack_u16: bool = False,
                       exchanges: Optional[Mapping[Node, object]] = None,
                       safe_exchange: bool = False):
    """Lower a query DAG to one per-rank closure; returns ``(run,
    out_cap_local)`` where ``run(data, count) -> (out_data, out_count,
    overflowed)`` keeps the result on this rank.

    ``data [cap_local, 5]`` / ``count`` (0-d) are this rank's block of
    the KG table; every rank calls ``run`` together. ``caps`` are the
    SHARD-LOCAL node capacities from
    :func:`repro_torch.query.annotate.annotate_query_local`;
    ``exchanges``/``safe_exchange``/``pack_u16`` follow
    :func:`repro_torch.plan.mesh.compile_mesh_plan` exactly (unmapped ⋈
    gather; ``safe_exchange`` sizes every exchange bucket at the hard-safe
    ``cap_bucket = cap_local``). ``out_cap_local`` is the root's
    shard-local capacity, the row count of every ``out_data``."""
    n_shards = int(mesh.shape[axis])
    group = mesh.group_for(axis)
    scan = query_scan(plan)
    strategies = {node: getattr(x, "strategy", x)
                  for node, x in (exchanges or {}).items()}

    def _bucket_cap(cap: int) -> int:
        if n_shards == 1 or safe_exchange:
            return cap
        return min(cap, sink_bucket_cap(cap, n_shards))

    def run(data: torch.Tensor, count: torch.Tensor):
        sources = {scan.source: Table(data=data, count=count.reshape(()),
                                      attrs=scan.scan_attrs)}
        gathered: Dict[Node, Table] = {}
        exchanged: Dict[Tuple[Node, str], Table] = {}
        flags = []

        def exchange_table(side_node: Node, table: Table,
                           key_attr: str) -> Table:
            """Key-partition one ⋈ side (memoized per (node, key))."""
            hit = exchanged.get((side_node, key_attr))
            if hit is None:
                d, cnt, over = repartition_by_key(
                    _masked_data(table), table.count, group=group,
                    n_shards=n_shards,
                    cap_bucket=_bucket_cap(table.capacity),
                    key_cols=(table.attrs.index(key_attr),),
                    pack_u16=pack_u16)
                flags.append(over)
                hit = exchanged[(side_node, key_attr)] = Table(
                    data=d, count=cnt, attrs=table.attrs)
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

        def distinct_global(node: Node, child: Table) -> Table:
            """Global δ: local δ -> rowhash repartition -> local δ (one
            rank needs no exchange)."""
            d, cnt = dedup_rows(_masked_data(child), child.count, dedup)
            if n_shards > 1:
                d, cnt, over = repartition_by_key(
                    d, cnt, group=group, n_shards=n_shards,
                    cap_bucket=_bucket_cap(child.capacity), key_cols=None,
                    pack_u16=pack_u16)
                flags.append(over)
                d, cnt = dedup_rows(d, cnt, dedup)
            return Table(data=d, count=cnt, attrs=child.attrs)

        memo: Dict[Node, Table] = {}
        out = execute_node(plan.root, sources, memo, None, dedup, caps,
                           flags, join_exchange=join_exchange,
                           distinct_global=distinct_global)
        over = (torch.any(torch.stack(flags)) if flags
                else torch.zeros((), dtype=torch.bool, device=out.device))
        return out.data, out.count.reshape(()), over.reshape(())

    out_cap_local = None if caps is None else int(caps[plan.root])
    return run, out_cap_local
