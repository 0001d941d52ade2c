"""Abstract inputs per (arch x shape x mesh) cell, and their trace.

The port's counterpart of the reference's ``launch/specs.py``.
``build_cell`` returns a :class:`Cell` whose ``fn(*args)`` is the step
the cell runs (train, prefill or decode) and whose ``args`` are fake
tensors (``FakeTensorMode``: shapes, dtypes and devices, never storage)
— on a production mesh DTensors placed by the rule table, each holding
rank 0's shard. :func:`lower_cell` is the counterpart of ``jit(fn)
.lower(*args)``: one run of ``fn`` on those tensors under a
:class:`CostMode`, which counts what rank 0 does — the FLOPs and bytes
of its local ops, its collectives and its memory — with no card, no
allocation and no data.
"""
from __future__ import annotations

import dataclasses
import time
import weakref
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.base import ArchConfig, ShapeSpec
from repro_torch.distributed.sharding import (AxisRules, ParamSpec,
                                              abstract_params, is_dtensor,
                                              spec_tree_map)
from repro_torch.launch.collective_analysis import (CollectiveCounter,
                                                    collective_of)
from repro_torch.models import get_model
from repro_torch.models.layers import ShardCtx
from repro_torch.models.vlm import VIT_DIM
from repro_torch.serve.decode import make_prefill, make_serve_step
from repro_torch.train.optimizer import make_optimizer, tree_map
from repro_torch.train.train_step import make_train_step

PyTree = Any


# ---------------------------------------------------------------------------
# optimizer state specs (mirrors optimizer.init exactly)
# ---------------------------------------------------------------------------

def opt_state_specs(opt_name: str, param_specs: PyTree) -> PyTree:
    """ParamSpec tree for the optimizer state (same tree structure as
    ``make_optimizer(name).init(params)``), carrying logical axes so the
    state shards exactly like its parameter."""
    def f32(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, s.logical_axes, torch.float32, "zeros")

    if opt_name == "adamw":
        return {"mu": spec_tree_map(f32, param_specs),
                "nu": spec_tree_map(f32, param_specs),
                "master": spec_tree_map(f32, param_specs)}
    if opt_name == "adafactor":
        def per(s: ParamSpec):
            if len(s.shape) >= 2:
                return {"vr": ParamSpec(s.shape[:-1], s.logical_axes[:-1],
                                        torch.float32, "zeros"),
                        "vc": ParamSpec(s.shape[:-2] + s.shape[-1:],
                                        s.logical_axes[:-2]
                                        + s.logical_axes[-1:],
                                        torch.float32, "zeros")}
            return {"v": f32(s)}
        return {"v": spec_tree_map(per, param_specs)}
    raise KeyError(f"unknown optimizer {opt_name!r}")


# ---------------------------------------------------------------------------
# batch specs
# ---------------------------------------------------------------------------

def batch_specs(cfg: ArchConfig, shape: ShapeSpec, *,
                with_labels: bool) -> Dict[str, ParamSpec]:
    """Token (+frontend-stub) input specs for one global batch, with the
    reference's logical axes."""
    b, s = shape.global_batch, shape.seq_len
    out: Dict[str, ParamSpec] = {}
    text = s - cfg.n_prepend if cfg.family == "vlm" else s
    out["tokens"] = ParamSpec((b, text), ("batch", "seq"), torch.int32,
                              "zeros")
    if with_labels:
        out["labels"] = ParamSpec((b, text), ("batch", "seq"), torch.int32,
                                  "zeros")
    if cfg.family == "vlm":
        out["patches"] = ParamSpec((b, cfg.n_prepend, VIT_DIM),
                                   ("batch", "seq", None), torch.float32,
                                   "zeros")
    elif cfg.family == "encdec":
        out["frames"] = ParamSpec((b, cfg.n_enc_frames, cfg.d_model),
                                  ("batch", "seq", "embed"), torch.float32,
                                  "zeros")
    return out


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Cell:
    """One dry-run cell: callable + fake args (+ metadata)."""
    arch: str
    shape: str
    kind: str
    fn: Callable
    args: Tuple[PyTree, ...]
    n_microbatches: int = 1


def _local(tree):
    """Each DTensor leaf's local shard (the rank's own tensor)."""
    return tree_map(lambda x: x.to_local() if is_dtensor(x) else x, tree)


def _ef_step(cfg, mesh, model_mesh, rules: AxisRules, opt, n_mb: int):
    """The pod-decoupled int8 error-feedback step (reference ``:135-199``),
    as the reference's ``shard_map`` manual over (pod, data) with
    ``model`` left to GSPMD: each rank runs the step on its batch rows,
    its parameters DTensors on ``model_mesh`` (the one-axis ``model``
    mesh: tensor-parallel, the batch unsharded), and the hook
    (``train_step.with_error_feedback``) owns the whole gradient sync
    over ``data`` and ``pod``: each gradient is gathered over ``model``
    whole (the reference's flatten of a model-sharded gradient),
    reduce-scattered over ``data``, quantized with the rank's EF shard,
    summed over ``pod`` and all-gathered over ``data``."""
    from repro_torch.distributed.sharding import shard_to
    from repro_torch.train.train_step import with_error_feedback
    opt, hook = with_error_feedback(opt, mesh.shape["data"], mesh=mesh)

    def gathered_hook(grads, opt_state):
        whole = tree_map(lambda g: g.full_tensor() if is_dtensor(g) else g,
                         grads)
        new, opt_state = hook(whole, opt_state)
        return tree_map(
            lambda n, g: shard_to(n, g.device_mesh, g.placements)
            if is_dtensor(g) else n, new, grads), opt_state

    return make_train_step(cfg, n_microbatches=n_mb, optimizer=opt,
                           ctx=ShardCtx(model_mesh, rules.with_overrides(
                               ("batch", None))),
                           grad_compress=gathered_hook)


def build_cell(cfg: ArchConfig, shape: ShapeSpec, mesh, rules:
               Optional[AxisRules], device=None) -> Cell:
    """The cell's step and fake args on ``mesh`` (a production mesh, or
    None for one device) with ``rules``, on ``device`` (CUDA unless
    ``"cpu"``); the args share one ``FakeTensorMode``."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode(allow_non_fake_inputs=True):
        return _build_cell(cfg, shape, mesh, rules, device)


def _build_cell(cfg, shape, mesh, rules, device) -> Cell:
    if not cfg.shape_supported(shape):
        raise ValueError(f"{cfg.name} does not support {shape.name}")
    ctx = None if mesh is None else ShardCtx(mesh, rules)
    model = get_model(cfg.family)
    p_specs = model.param_specs(cfg)

    def fake(specs, rules=rules):
        return abstract_params(specs, mesh, rules, device)

    if shape.kind == "train":
        n_shards = 1 if mesh is None else (
            mesh.shape.get("pod", 1) * mesh.shape.get("data", 1))
        n_mb = cfg.microbatches(shape, n_shards)
        opt = make_optimizer(cfg.optimizer)
        opt_spec_tree = opt_state_specs(cfg.optimizer, p_specs)
        batch = fake(batch_specs(cfg, shape, with_labels=True))
        step_no = abstract_params(ParamSpec((), (), torch.int32, "zeros"),
                                  None, None, device)
        use_ef = (cfg.grad_compress_pods and mesh is not None
                  and mesh.shape.get("pod", 1) > 1 and not cfg.fsdp
                  and not cfg.fsdp_pods)
        if use_ef:
            n_inner, n_pods = mesh.shape["data"], mesh.shape["pod"]

            def ef_len(s: ParamSpec) -> int:
                n = 1
                for d in s.shape:
                    n *= d
                return (n + n_inner - 1) // n_inner
            ef_specs = spec_tree_map(
                lambda s: ParamSpec((n_pods * n_inner * ef_len(s),),
                                    ("ef_shard",), torch.float32, "zeros"),
                p_specs)
            rules = rules.with_overrides(("ef_shard", ("pod", "data")))
            model_mesh = mesh.axis_mesh("model")
            fn = _ef_step(cfg, mesh, model_mesh, rules, opt, n_mb)
            params = abstract_params(p_specs, model_mesh, rules, device)
            opt_abs = {"opt": abstract_params(opt_spec_tree, model_mesh,
                                              rules, device),
                       "ef": _local(fake(ef_specs, rules))}
            batch = _local(batch)
        else:
            step = make_train_step(cfg, n_microbatches=n_mb, optimizer=opt,
                                   ctx=ctx)

            def fn(params, opt_state, batch, step_no):
                return step(params, opt_state, _local(batch), step_no)
            params = fake(p_specs)
            opt_abs = fake(opt_spec_tree)
        return Cell(cfg.name, shape.name, "train", fn,
                    (params, opt_abs, batch, step_no), n_mb)

    params = fake(p_specs)
    if shape.kind == "prefill":
        batch = fake(batch_specs(cfg, shape, with_labels=False))
        return Cell(cfg.name, shape.name, "prefill", make_prefill(cfg, ctx),
                    (params, batch))

    # decode: one token against a seq_len-deep cache/state
    cache = fake(model.cache_specs(cfg, shape.global_batch, shape.seq_len))
    tokens = fake(ParamSpec((shape.global_batch, 1), ("batch", "seq"),
                            torch.int32, "zeros"))
    return Cell(cfg.name, shape.name, "decode", make_serve_step(cfg, ctx),
                (params, cache, tokens))


# ---------------------------------------------------------------------------
# the trace
# ---------------------------------------------------------------------------

def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def local_bytes(tree) -> int:
    """Bytes of rank 0's local tensors in a tree (a DTensor's shard)."""
    return sum((x.to_local() if is_dtensor(x) else x).nbytes
               for x in _tensors(tree))


#: ops that move no bytes of their own: allocations, and the wait of an
#: async collective (its bytes count at the collective)
_NO_TRAFFIC = {"aten::empty", "aten::empty_strided", "aten::empty_like",
               "aten::new_empty", "aten::new_empty_strided",
               "_c10d_functional::wait_tensor"}


class CostMode(TorchDispatchMode):
    """Counts rank 0's work over one run of a step on fake tensors.

    DTensor ops are handed back to DTensor (``NotImplemented``), which
    runs them as local ops on the shards and as collectives; this mode
    sees those. DTensor's sharding propagation also runs each op once on
    global-shape fake tensors to infer its output: those runs are not
    counted (:meth:`__enter__` marks them).

    * ``flops``: per-device FLOPs of the local ops, from
      ``torch.utils.flop_counter``'s formulas (matrix products,
      attention, convolutions, and the float kernels' ops, whose formulas
      come from ``kernels/work.py``); elementwise ops count none;
    * ``bytes``: operand plus result bytes of every op that is not a
      view, an allocation or a collective — the port runs eagerly, so
      that is its HBM traffic (a float kernel's op counts the bytes its
      function needs, ``kernels/work.py``);
    * ``collectives``: per-device operand bytes by XLA op name
      (:mod:`.collective_analysis`);
    * ``peak_bytes``: the most bytes live at once, from the arguments'
      and every op output's storage, freed when Python drops it;
    * ``op_calls``: calls of each custom op (the float kernels).
    """

    def __init__(self, pod_boundary: Optional[int] = None):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives = CollectiveCounter(pod_boundary)
        self.op_calls: Dict[str, int] = {}
        self.live = 0
        self.peak_bytes = 0
        self._storages = WeakIdKeyDictionary()   # storages counted live
        self._muted = 0
        self._saved = None

    # -- memory ------------------------------------------------------------
    def track(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (rank 0's shards) as
        live until they are dropped."""
        for x in _tensors(tree):
            self._track(x.to_local() if is_dtensor(x) else x)

    def _track(self, x: torch.Tensor) -> None:
        st = x.untyped_storage()
        if st in self._storages:
            return
        n = st.nbytes()
        self._storages[st] = True
        self.live += n
        self.peak_bytes = max(self.peak_bytes, self.live)
        weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    # -- dispatch ----------------------------------------------------------
    def __enter__(self):
        from torch.distributed.tensor._sharding_prop import \
            ShardingPropagator
        orig = ShardingPropagator._propagate_tensor_meta_non_cached
        mode = self

        def muted(prop, op_schema):
            mode._muted += 1
            try:
                return orig(prop, op_schema)
            finally:
                mode._muted -= 1
        self._saved = (ShardingPropagator, orig)
        ShardingPropagator._propagate_tensor_meta_non_cached = muted
        return super().__enter__()

    def __exit__(self, *exc):
        cls, orig = self._saved
        cls._propagate_tensor_meta_non_cached = orig
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        name = func._schema.name
        if self._muted:
            return func(*args, **kwargs)
        if name == "_c10d_functional::wait_tensor":
            return args[0]          # the collective's output, no new tensor
        out = func(*args, **kwargs)
        coll = collective_of(func, args, kwargs)
        if coll is not None:
            self.collectives.add(*coll)
        elif name.startswith("repro_torch::"):
            self.op_calls[name] = self.op_calls.get(name, 0) + 1
            self.bytes += _kernel_work(name, args)["bytes"]
        elif not func.is_view and name not in _NO_TRAFFIC:
            self.bytes += sum(x.nbytes for x in _tensors((args, kwargs, out)))
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += int(formula(*args, **kwargs, out_val=out))
        if not func.is_view:
            for x in _tensors(out):
                self._track(x)
        return out


def _kernel_work(name: str, args) -> Dict[str, object]:
    """``kernels/work.py``'s record of a float kernel's op call."""
    from repro_torch.kernels import work
    if name == "repro_torch::flash_attention":
        q, k = args[0], args[1]
        b, h, s_q, d = q.shape
        return work.attention_work(b, h, k.shape[1], s_q, k.shape[2], d,
                                   args[3], args[4] or None, args[6],
                                   q.element_size())
    x = args[0]
    b, h, t, _ = x.shape
    state = args[-1] is not None
    fn = work.rwkv6_work if name == "repro_torch::rwkv6" else \
        work.mamba2_work
    return fn(b, h, t, state, x.element_size())


@dataclasses.dataclass
class CellTrace:
    """What one traced run of a cell's step did on rank 0."""
    flops: int
    bytes: int
    collectives: Dict[str, object]
    argument_bytes: int
    output_bytes: int
    peak_bytes: int
    op_calls: Dict[str, int]
    trace_seconds: float

    @property
    def temp_bytes(self) -> int:
        """The traced peak less the arguments."""
        return max(0, self.peak_bytes - self.argument_bytes)


def lower_cell(cell: Cell, pod_boundary: Optional[int] = None,
               card: bool = True) -> CellTrace:
    """One run of ``cell.fn(*cell.args)`` under a :class:`CostMode` (the
    counterpart of the reference's ``jit(fn).lower(*args)``; nothing is
    compiled, allocated or launched). With ``card``, fake CPU args stand
    for the card's (``kernels.card_trace``): the float kernels' ops run,
    as on CUDA args."""
    import contextlib
    from repro_torch.kernels import card_trace
    from torch._guards import detect_fake_mode
    fake_mode = detect_fake_mode([x.to_local() if is_dtensor(x) else x
                                  for x in _tensors(cell.args)])
    mode = CostMode(pod_boundary)
    arg_bytes = local_bytes(cell.args)
    t0 = time.perf_counter()
    with fake_mode, card_trace() if card else contextlib.nullcontext():
        mode.track(cell.args)
        with mode:
            out = cell.fn(*cell.args)
        out_bytes = local_bytes(out)
    return CellTrace(flops=mode.flops, bytes=mode.bytes,
                     collectives=mode.collectives.stats().to_dict(),
                     argument_bytes=arg_bytes, output_bytes=out_bytes,
                     peak_bytes=mode.peak_bytes, op_calls=mode.op_calls,
                     trace_seconds=time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# analytic parameter counts (roofline MODEL_FLOPS)
# ---------------------------------------------------------------------------

def model_param_counts(cfg: ArchConfig) -> Dict[str, float]:
    """Total / active / non-embedding parameter counts from the spec tree.
    ``active`` scales expert leaves by top_k / n_experts (MoE); ``body``
    excludes vocab-axis leaves (the 6ND convention)."""
    leaves = []
    spec_tree_map(leaves.append, get_model(cfg.family).param_specs(cfg))
    total = active = body = body_active = 0.0
    for s in leaves:
        n = 1.0
        for d in s.shape:
            n *= d
        frac = 1.0
        if cfg.n_experts and "expert" in (s.logical_axes or ()):
            frac = cfg.top_k / cfg.n_experts
        total += n
        active += n * frac
        if "vocab" not in (s.logical_axes or ()):
            body += n
            body_active += n * frac
    return {"total": total, "active": active,
            "body": body, "body_active": body_active}
