"""MapSDI logical-plan subsystem: IR, optimizing planner, compiler.

``lower`` turns a ``DIS`` into a logical plan DAG, ``optimize`` runs Rules
1–3 plus selection pushdown and common-subplan elimination as symbolic
rewrites (zero device work), ``annotate`` sizes every buffer at plan time,
and ``compile_plan`` lowers the optimized DAG to one ``sources -> (KG,
raw)`` closure; ``materialize_plan`` evaluates its relation inputs into
a concrete ``DIS'`` and ``explain`` prints the annotated DAG;
``annotate_local`` and ``compile_mesh_plan`` are the mesh forms (one
per-rank closure over row-sharded sources).
"""
from .ir import (ColEq, Distinct, EmitTriples, EquiJoin, Node, Pred,
                 Project, Scan, Select, Union, fingerprint, intern,
                 iter_nodes, make_coleq, make_select, node_order, tree_size)
from .lower import LogicalPlan, lower, selection_preds
from .optimize import (PlanStats, cse, merge_maps, optimize,
                       push_projections, push_selections)
from .annotate import (JoinExchange, annotate, annotate_local,
                       join_exchange_cost, join_match_total,
                       poisson_shard_bound)
from .compile import (compile_plan, execute_node, input_names,
                      materialize_plan)
from .mesh import compile_mesh_plan, plan_scans
from .explain import dump_plan, explain

__all__ = [
    "ColEq", "Distinct", "EmitTriples", "EquiJoin", "JoinExchange",
    "LogicalPlan", "Node", "PlanStats", "Pred", "Project", "Scan", "Select",
    "Union", "annotate", "annotate_local", "compile_mesh_plan",
    "compile_plan", "cse", "dump_plan", "execute_node", "explain",
    "fingerprint", "input_names", "intern", "iter_nodes",
    "join_exchange_cost", "join_match_total", "lower", "make_coleq",
    "make_select", "materialize_plan", "node_order", "plan_scans",
    "poisson_shard_bound",
    "merge_maps", "optimize", "push_projections", "push_selections",
    "selection_preds", "tree_size",
]
