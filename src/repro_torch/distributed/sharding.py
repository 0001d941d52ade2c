"""Logical-axis sharding: ParamSpec trees -> placements on a mesh of ranks.

Model definitions never name mesh axes. Every parameter is declared as a
:class:`ParamSpec` carrying *logical* axis names (``("layers", "embed",
"ffn")`` ...); an :class:`AxisRules` table maps logical names to mesh
axes, as the JAX package's does, so the same model runs data-parallel,
tensor-parallel, FSDP or any mix by swapping rule tables.

Conventions (the reference's):

* a logical axis mapped to ``None`` is replicated;
* a logical axis may map to a *tuple* of mesh axes (e.g. batch ->
  ``("pod", "data")``);
* rules are ordered: the first rule whose mesh axes are all still unused
  by the current tensor wins (one mesh axis never shards two dims).

``AxisRules.spec_for`` gives the per-dimension mesh axes of the
reference's ``PartitionSpec`` (a tuple here, trailing ``None``s trimmed).
:class:`Sharding` turns them into DTensor placements on the mesh's
``DeviceMesh`` (``torch.distributed.tensor``, PyTorch's counterpart of
GSPMD): a mesh axis that shards dim ``i`` is ``Shard(i)``, any other is
``Replicate()``; the mesh axes of one tuple entry shard their dim in the
mesh's axis order, as JAX's tuple entries do.

``init_params(..., mesh=, rules=)`` draws every full leaf in every rank,
in the one-device order, and keeps the rank's shard: a sharded run
starts from the one-device run's weights bit for bit, at a transient
cost of one full leaf per rank.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple, Union

import torch

from repro_torch.device import DeviceLike, resolve_device

MeshAxes = Union[None, str, Tuple[str, ...]]

#: the largest float32 draw ``ParamSpec.materialize`` makes at once
DRAW_LIMIT = 1 << 30


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declaration of one parameter: shape + logical axes + dtype + init."""

    shape: Tuple[int, ...]
    logical_axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"          # 'normal' | 'zeros' | 'ones' | 'scaled'
    init_scale: float = 0.02

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(
                f"shape {self.shape} vs logical_axes {self.logical_axes}")
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


# ---------------------------------------------------------------------------
# axis rules
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AxisRules:
    """Ordered (logical_axis -> mesh axes) table."""

    rules: Tuple[Tuple[str, MeshAxes], ...]

    def with_overrides(self, *overrides: Tuple[str, MeshAxes]) -> "AxisRules":
        """New table with ``overrides`` taking precedence (prepended)."""
        return AxisRules(tuple(overrides) + self.rules)

    def candidates(self, logical: str) -> Sequence[MeshAxes]:
        return [m for lg, m in self.rules if lg == logical]

    def spec_for(self, spec_or_axes) -> Tuple[MeshAxes, ...]:
        """Per-dimension mesh axes of a ParamSpec (or a raw logical-axes
        tuple): the entries of the reference's ``PartitionSpec``."""
        axes = (spec_or_axes.logical_axes
                if isinstance(spec_or_axes, ParamSpec) else spec_or_axes)
        used: set = set()
        out = []
        for logical in axes:
            assigned: MeshAxes = None
            if logical is not None:
                for mesh_axes in self.candidates(logical):
                    if mesh_axes is None:
                        assigned = None
                        break
                    tup = ((mesh_axes,) if isinstance(mesh_axes, str)
                           else tuple(mesh_axes))
                    if not (set(tup) & used):
                        assigned = tup if len(tup) > 1 else tup[0]
                        used.update(tup)
                        break
            out.append(assigned)
        # trim trailing Nones (canonical PartitionSpec form)
        while out and out[-1] is None:
            out.pop()
        return tuple(out)


# ---------------------------------------------------------------------------
# placements on a mesh
# ---------------------------------------------------------------------------

def is_dtensor(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor laid out on a mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def replica_scope():
    """The scope of a sharded computation: a plain tensor that meets a
    DTensor in an op (a mask, positions, a 0-d step count) counts as the
    same whole value in every rank."""
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _entry_axes(entry: MeshAxes) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A tensor's layout on a mesh: the mesh (``launch.mesh.Mesh``) and
    the per-dimension mesh axes (``AxisRules.spec_for``); the reference's
    ``NamedSharding``."""

    mesh: object
    spec: Tuple[MeshAxes, ...]

    @property
    def placements(self) -> tuple:
        from torch.distributed.tensor import Replicate, Shard
        out = []
        for axis in self.mesh.axis_names:
            dims = [i for i, e in enumerate(self.spec)
                    if axis in _entry_axes(e)]
            out.append(Shard(dims[0]) if dims else Replicate())
        return tuple(out)

    def shard(self, full: torch.Tensor):
        """This rank's shard of the whole tensor ``full`` as a DTensor
        (no communication: every rank holds ``full``)."""
        return shard_to(full, self.mesh.device_mesh, self.placements)


def shard_to(full: torch.Tensor, device_mesh, placements):
    """This rank's shard of ``full`` (the same whole tensor in every
    rank) as a DTensor with ``placements`` on ``device_mesh``; the mesh
    dims that shard one tensor dim split it in mesh-dim order."""
    from torch.distributed.tensor import DTensor
    coord = device_mesh.get_coordinate()
    local = full
    for i, place in enumerate(placements):
        if place.is_shard():
            n = device_mesh.size(i)
            if local.shape[place.dim] % n:
                raise ValueError(
                    f"dim {place.dim} of shape {tuple(full.shape)} does not "
                    f"divide over mesh dim {i} of size {n}")
            local = local.chunk(n, dim=place.dim)[coord[i]]
    return DTensor.from_local(local.contiguous(), device_mesh,
                              tuple(placements), run_check=False,
                              shape=full.shape, stride=full.stride())


def logical_sharding(mesh, rules: AxisRules,
                     *logical_axes: Optional[str]) -> Sharding:
    """The layout of an activation given its logical axes."""
    return Sharding(mesh, rules.spec_for(tuple(logical_axes)))


def param_shardings(specs, mesh, rules: AxisRules):
    """Tree of :class:`Sharding` matching a ParamSpec tree."""
    return spec_tree_map(lambda s: Sharding(mesh, rules.spec_for(s)), specs)


def batch_sharding(mesh, rules: AxisRules) -> Sharding:
    return logical_sharding(mesh, rules, "batch", "seq")


# ---------------------------------------------------------------------------
# standard rule tables
# ---------------------------------------------------------------------------
#
# Logical axes used by the model zoo:
#   batch       input batch                  -> (pod, data)
#   seq         sequence (activations)       -> None (or model under SP)
#   embed       d_model / residual stream    -> None (or data under FSDP)
#   heads       q heads                      -> model
#   kv_heads    k/v heads                    -> model
#   head_dim    per-head dim                 -> None
#   ffn         MLP hidden                   -> model
#   vocab       embedding/unembedding rows   -> model
#   expert      MoE expert dim               -> model
#   expert_ffn  per-expert hidden            -> None (or data under FSDP)
#   layers      stacked layer dim            -> None (never sharded)
#   conv/state  small recurrent dims         -> None

DEFAULT_RULES = AxisRules((
    ("batch", ("pod", "data")),
    ("batch", "data"),
    ("heads", "model"),
    ("kv_heads", "model"),
    ("ffn", "model"),
    ("vocab", "model"),
    ("expert", "model"),
    ("seq", None),
    ("embed", None),
    ("expert_ffn", None),
))

# FSDP: parameters additionally sharded over the within-pod data axis on a
# non-"model" dim; the forward gathers them where a layer needs them whole
FSDP_RULES = DEFAULT_RULES.with_overrides(
    ("embed", "data"),
    ("expert_ffn", "data"),
)


def make_rules(fsdp: bool = False,
               overrides: Sequence[Tuple[str, MeshAxes]] = ()) -> AxisRules:
    base = FSDP_RULES if fsdp else DEFAULT_RULES
    return base.with_overrides(*overrides) if overrides else base


def local_shape(shape: Tuple[int, ...], mesh, placements) -> Tuple[int, ...]:
    """This rank's shard shape of a tensor of ``shape`` with
    ``placements`` on ``mesh`` (DTensor's split: ``torch.chunk``'s, so
    rank 0 takes the first, ceiling-sized piece, XLA's padded per-device
    shape)."""
    return shard_extent(shape, mesh.device_mesh, placements)[0]


def shard_extent(shape: Tuple[int, ...], device_mesh, placements
                 ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """(this rank's shard shape, its offset in the whole tensor), by
    DTensor's own split, computed outside any active mode (it builds
    index tensors a fake or counting mode must not see)."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    from torch.utils._python_dispatch import _disable_current_modes
    with _disable_current_modes():
        size, offset = compute_local_shape_and_global_offset(
            torch.Size(shape), device_mesh, placements)
    return tuple(size), tuple(offset)


def contiguous_stride(shape: Tuple[int, ...]) -> Tuple[int, ...]:
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return tuple(stride)


def spec_zeros(spec: ParamSpec, device, mesh=None,
               rules: Optional[AxisRules] = None) -> torch.Tensor:
    """Zeros of ``spec``'s shape and dtype on ``device``; on a ``mesh``
    (with ``rules``) a DTensor placed by ``rules.spec_for`` whose rank
    allocates its shard only."""
    if mesh is None:
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    from torch.distributed.tensor import DTensor
    places = Sharding(mesh, rules.spec_for(spec)).placements
    local = torch.zeros(local_shape(spec.shape, mesh, places),
                        dtype=spec.dtype, device=device)
    return DTensor.from_local(local, mesh.device_mesh, places,
                              run_check=False, shape=torch.Size(spec.shape),
                              stride=contiguous_stride(spec.shape))


def abstract_params(specs, mesh=None, rules: Optional[AxisRules] = None,
                    device: DeviceLike = None):
    """The dry-run's input: a tree of fake tensors (``FakeTensorMode``:
    shapes, dtypes and devices, no storage) for a ParamSpec tree, on
    ``device`` (CUDA unless ``"cpu"``; no card needed): :func:`spec_zeros`
    under the mode, so on a ``mesh`` (with ``rules``) each leaf is a
    DTensor whose local tensor is rank 0's fake shard and no leaf is ever
    whole. Call it inside the ``FakeTensorMode`` the step will run under
    (one is entered here otherwise)."""
    from torch._guards import active_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    if mesh is not None and rules is None:
        raise ValueError("abstract_params on a mesh needs its axis rules")
    dev = torch.device("cpu") if str(device) == "cpu" else \
        torch.device("cuda", 0)
    with active_fake_mode() or FakeTensorMode(allow_non_fake_inputs=True):
        return spec_tree_map(lambda s: spec_zeros(s, dev, mesh, rules),
                             specs)


# ---------------------------------------------------------------------------
# initialisation
# ---------------------------------------------------------------------------

def init_params(specs, generator: torch.Generator,
                device: DeviceLike = None, mesh=None,
                rules: Optional[AxisRules] = None):
    """Materialise a ParamSpec tree into tensors on ``device`` (the card
    unless ``device="cpu"``), drawing from ``generator`` (which must live
    on that device) in sorted-key order.

    On a ``mesh`` (with ``rules``) every rank draws each full leaf in the
    same order and keeps its shard as a DTensor placed by
    ``rules.spec_for``: the weights equal the one-device draw's."""
    dev = resolve_device(device)
    if mesh is None:
        return spec_tree_map(lambda s: s.materialize(generator, dev), specs)
    if rules is None:
        raise ValueError("init_params on a mesh needs its axis rules")
    return spec_tree_map(
        lambda s: Sharding(mesh, rules.spec_for(s)).shard(
            s.materialize(generator, dev)), specs)
