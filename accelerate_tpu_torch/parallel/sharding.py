"""The sharding rules: where each parameter, moment and batch lies on the
mesh.

Port of ``accelerate_tpu/parallel/sharding.py`` (``DEFAULT_LOGICAL_RULES``
:43-60, ``get_logical_specs``, ``_fsdp_spec_for_leaf`` :143,
``_merge_fsdp_into_spec`` :161, ``infer_param_shardings`` :187 with the
"zero" seat, ``infer_opt_state_shardings`` :254, ``grad_buffer_shardings``
:280, ``replicated``, ``batch_sharding``, ``shard_params`` :355,
``shardings_of`` :366, ``mesh_axes_of_params`` :383).

A sharding here is a *spec*: one entry per tensor dim, each None (whole),
a mesh axis name, or a tuple of them (major first), as a JAX
``PartitionSpec`` reads. The rules are the reference's, computed by the
same functions on the reference's shapes. Two mechanisms, as there:

* logical axes: a port model declares, for each parameter, the reference's
  logical axis names over the reference's shape (``LeafAxes``: the
  reference stacks the layers into one leaf ``(layers, in, out)`` where the
  port keeps ``layers.<i>....weight`` as ``(out, in)``). The rules map the
  names to mesh axes on that shape, the fsdp heuristic merges onto it, and
  the result is read back through ``LeafAxes.dims`` into the port's dim
  order. So the fsdp axis lands on the same tensor dimension as in the
  reference, and ``min_weight_size`` counts the stacked leaf, as there;
* the fsdp heuristic for a leaf without logical axes: the largest dim that
  the fsdp degree divides, later dims first on ties, on the leaf's own
  shape.

A dim that an axis does not divide stays whole (no uneven shard), so a
checkpoint's chunks tile as the reference's. Every function of a spec is
pure: it reads shapes, logical axes, the plugin and the mesh's degrees (a
``DeviceMesh`` or a dict), never a process group.

A spec becomes DTensor placements with :func:`placements_for`: ``Shard(d)``
on each mesh dim that splits tensor dim ``d``. A dim split over two axes
whose order differs from the mesh's (the embedding's vocab dim, ``("tp",
"fsdp")``, where fsdp precedes tp in the mesh) takes ``_StridedShard`` on
the axis the mesh puts first, which gives the reference's chunk order (tp
major). ``local_bounds`` computes a rank's chunk of a spec by the same
order, which the step, the checkpoints and the loads read.

``live_mesh`` and ``constrain_activations`` (reference :98-140) pin no
layout here: the port's step is eager, so they decide what a rank holds.
The rows come from the loader (``data_loader.py``: the data axes dp x fsdp
x ep split the batch; sp, pp and tp peers read the same rows), and
``constrain_activations`` takes a rank's contiguous chunk of the sequence
over sp, which is where the reference's constraint puts it.

Waiting for later parts of queue A7: ``hierarchical_psum`` (part 5), and
``wants_collective_overlap`` and the ``collective_contract_*`` functions
(A10's ``hlo_audit``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Sequence

import torch

from ..utils.constants import (
    MESH_AXES,
    MESH_AXIS_DATA,
    MESH_AXIS_FSDP,
    MESH_AXIS_SEQUENCE,
    MESH_AXIS_TENSOR,
)
from ..utils.dataclasses import ParallelismPlugin, ShardingStrategy
from .mesh import data_axes, mesh_coordinate, mesh_shape_of

Spec = tuple  # per tensor dim: None, an axis name, or a tuple of names (major first)

# logical axis -> mesh axis, in priority order (the reference's, :43-60)
DEFAULT_LOGICAL_RULES: tuple[tuple[str, Optional[str]], ...] = (
    ("batch", MESH_AXIS_DATA),
    ("vocab", MESH_AXIS_TENSOR),
    # "zero": the ZeRO-3 weight-shard seat stacked onto another logical
    # axis's dim (the embedding's vocab dim carries ("vocab", "zero") ->
    # (tp, fsdp)), where the fsdp heuristic must not pick the feature dim
    ("zero", MESH_AXIS_FSDP),
    ("embed", None),
    ("heads", MESH_AXIS_TENSOR),
    ("kv", None),
    ("mlp", MESH_AXIS_TENSOR),
    ("expert", "ep"),
    ("length", MESH_AXIS_SEQUENCE),
    ("norm", None),
    ("layers", None),  # the reference's stacked-layer dim
)


@dataclass(frozen=True)
class LeafAxes:
    """The reference's view of one port parameter: its logical axis names
    (``logical``, one entry a dim: None, a name or a tuple of names) over
    its shape in the reference (``ref_shape``, the stacked layers dim
    included), and ``dims``: the reference dim that each port dim is. A
    reference dim no port dim maps to (the stacked ``layers``) must stay
    whole."""

    logical: tuple
    ref_shape: tuple
    dims: tuple

    def to_port(self, ref_spec: Spec, name: str = "") -> Spec:
        entries = list(ref_spec) + [None] * (len(self.ref_shape) - len(ref_spec))
        dropped = set(range(len(self.ref_shape))) - set(self.dims)
        for d in dropped:
            if entries[d] is not None:
                raise NotImplementedError(
                    f"the sharding rules put {entries[d]!r} on the reference's stacked dim {d} "
                    f"of {name or 'a leaf'} (shape {self.ref_shape}), which the port keeps "
                    "as one tensor a layer: set min_weight_size or the fsdp degree so "
                    "another dim takes it")
        return tuple(entries[d] for d in self.dims)


def _shape(leaf: Any) -> tuple:
    return tuple(leaf) if isinstance(leaf, (tuple, list, torch.Size)) else tuple(
        getattr(leaf, "shape", ()))


def _entry_axes(entry: Any) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def get_logical_specs(model: Any) -> Optional[dict[str, LeafAxes]]:
    """The logical axes a port model declares for its parameters
    (``CausalLM.logical_axes()``, ``SequenceClassifier.logical_axes()``),
    by parameter name; None for a module or tree that declares none, whose
    leaves then take the fsdp heuristic."""
    fn = getattr(model, "logical_axes", None)
    return fn() if callable(fn) else None


def live_mesh():
    """The AcceleratorState's mesh when one is initialised and spans more
    than one process, else None (reference :98)."""
    from ..state import AcceleratorState

    if not AcceleratorState._shared_state:
        return None
    mesh = getattr(AcceleratorState(), "mesh", None)
    if mesh is None or math.prod(mesh_shape_of(mesh).values()) == 1:
        return None
    return mesh


def sequence_chunk_bounds(length: int, sp_size: int, sp_rank: int) -> Optional[tuple[int, int]]:
    """``(start, stop)`` of sp rank ``sp_rank``'s contiguous chunk of a
    sequence of ``length``, or None when sp is 1 or does not divide it
    (the reference's constraint then leaves the sequence whole)."""
    if sp_size <= 1 or length % sp_size:
        return None
    step = length // sp_size
    return sp_rank * step, (sp_rank + 1) * step


def constrain_activations(x: torch.Tensor, seq_dim: Optional[int] = 1) -> torch.Tensor:
    """This rank's part of an activation that holds the whole sequence of
    its rows (reference :110): its contiguous chunk of ``seq_dim`` under the
    running sharded step's sp group when sp divides the length, else ``x``
    as it is (no step running, sp 1, or a length sp does not tile). The
    rows are this rank's already (the loader's)."""
    from .runtime import sp_state

    sp = sp_state()
    if sp is None or seq_dim is None or seq_dim >= x.dim():
        return x
    bounds = sequence_chunk_bounds(x.shape[seq_dim], sp.size, sp.rank)
    if bounds is None:
        return x
    return x.narrow(seq_dim, bounds[0], bounds[1] - bounds[0])


def _fsdp_spec_for_leaf(shape: tuple, fsdp_size: int, min_weight_size: int) -> Spec:
    """The largest dim that fsdp divides, later dims first on ties; whole
    below ``min_weight_size`` elements (reference :143)."""
    if not shape or math.prod(shape) < min_weight_size:
        return ()
    order = sorted(range(len(shape)), key=lambda i: (shape[i], i), reverse=True)
    for dim in order:
        if shape[dim] % fsdp_size == 0 and shape[dim] >= fsdp_size:
            spec: list[Any] = [None] * len(shape)
            spec[dim] = MESH_AXIS_FSDP
            return tuple(spec)
    return ()


def _merge_fsdp_into_spec(spec: Spec, shape: tuple, fsdp_size: int,
                          min_weight_size: int) -> Spec:
    """fsdp added on a free dim of a spec the logical rules made (reference
    :161); a spec that holds fsdp already (the "zero" seat) stays."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    if not shape or math.prod(shape) < min_weight_size:
        return tuple(spec)
    if any(MESH_AXIS_FSDP in _entry_axes(e) for e in entries):
        return tuple(entries)
    order = sorted(range(len(shape)), key=lambda i: (shape[i], i), reverse=True)
    for dim in order:
        if entries[dim] is None and shape[dim] % fsdp_size == 0 and shape[dim] >= fsdp_size:
            entries[dim] = MESH_AXIS_FSDP
            return tuple(entries)
    return tuple(spec)


def _rule_map(plugin: ParallelismPlugin, rules: Optional[Sequence]) -> dict:
    rule_map = dict(DEFAULT_LOGICAL_RULES)
    if plugin.sharding_rules:
        rule_map.update(dict(plugin.sharding_rules))
    if rules:
        rule_map.update(dict(rules))
    return rule_map


def _fsdp_on(plugin: ParallelismPlugin, shape: dict) -> bool:
    return (plugin.sharding_strategy in (ShardingStrategy.FULL_SHARD,
                                         ShardingStrategy.HYBRID_SHARD)
            and shape[MESH_AXIS_FSDP] > 1)


def _pad(spec: Spec, ndim: int) -> Spec:
    return tuple(spec) + (None,) * (ndim - len(spec))


def infer_param_shardings(params: dict, mesh: Any, plugin: Optional[ParallelismPlugin] = None,
                          logical_specs: Optional[dict[str, LeafAxes]] = None,
                          rules: Optional[Sequence[tuple[str, Optional[str]]]] = None
                          ) -> dict[str, Spec]:
    """The spec of every leaf of ``params`` (a name -> tensor, or shape,
    dict) in the port's dim order (reference :187). A leaf with logical
    axes in ``logical_specs`` maps them through the rules on its reference
    shape, merging fsdp under FULL_SHARD/HYBRID_SHARD; any other leaf takes
    the fsdp heuristic under those strategies and stays whole otherwise."""
    plugin = plugin or ParallelismPlugin()
    shape = mesh_shape_of(mesh)
    rule_map = _rule_map(plugin, rules)
    fsdp_on = _fsdp_on(plugin, shape)
    fsdp_size = shape[MESH_AXIS_FSDP]

    def usable(axis: Optional[str]) -> bool:
        # the fsdp axis ("zero" seat) shards weights only under ZeRO-3-style
        # strategies: under ZeRO-1/2 the params stay whole
        if axis == MESH_AXIS_FSDP and not fsdp_on:
            return False
        return bool(axis) and shape.get(axis, 1) > 1

    def map_logical(logical: tuple, ref_shape: tuple) -> Spec:
        entries = []
        for name in logical:
            if name is None:
                entries.append(None)
            elif isinstance(name, (list, tuple)):
                axes = tuple(a for a in (rule_map.get(n) for n in name) if usable(a))
                entries.append(axes if axes else None)
            else:
                axis = rule_map.get(name)
                entries.append(axis if usable(axis) else None)
        spec = tuple(entries)
        if fsdp_on:
            spec = _merge_fsdp_into_spec(spec, ref_shape, fsdp_size, plugin.min_weight_size)
        return spec

    out = {}
    for name, leaf in params.items():
        own = _shape(leaf)
        axes = (logical_specs or {}).get(name)
        if axes is not None:
            ref_spec = _pad(map_logical(axes.logical, axes.ref_shape), len(axes.ref_shape))
            out[name] = axes.to_port(ref_spec, name)
        elif fsdp_on:
            out[name] = _pad(_fsdp_spec_for_leaf(own, fsdp_size, plugin.min_weight_size),
                             len(own))
        else:
            out[name] = (None,) * len(own)
    return out


def infer_opt_state_shardings(params: dict, mesh: Any,
                              plugin: Optional[ParallelismPlugin] = None,
                              logical_specs: Optional[dict[str, LeafAxes]] = None
                              ) -> dict[str, Spec]:
    """The moments' specs under ZeRO-1/2 (reference :254): the fsdp
    heuristic on each moment's reference shape (a moment has its
    parameter's shape), while the params stay whole on fsdp."""
    plugin = plugin or ParallelismPlugin()
    fsdp_size = mesh_shape_of(mesh)[MESH_AXIS_FSDP]
    out = {}
    for name, leaf in params.items():
        axes = (logical_specs or {}).get(name)
        if axes is not None:
            ref = _pad(_fsdp_spec_for_leaf(axes.ref_shape, fsdp_size, plugin.min_weight_size),
                       len(axes.ref_shape))
            out[name] = axes.to_port(ref, name)
        else:
            own = _shape(leaf)
            out[name] = _pad(_fsdp_spec_for_leaf(own, fsdp_size, plugin.min_weight_size),
                             len(own))
    return out


def grad_buffer_shardings(params: dict, mesh: Any, plugin: Optional[ParallelismPlugin] = None,
                          logical_specs: Optional[dict[str, LeafAxes]] = None
                          ) -> dict[str, Spec]:
    """The accumulated-gradient buffer's specs under ZeRO-2 (reference
    :280): the moments'."""
    return infer_opt_state_shardings(params, mesh, plugin, logical_specs)


def zero12_shards(plugin: Optional[ParallelismPlugin], mesh: Any) -> bool:
    """Whether the moments shard on fsdp while the params stay whole:
    SHARD_OPT or SHARD_GRAD_OP with fsdp above 1 (the reference's
    ``AcceleratedOptimizer.init`` condition)."""
    return (plugin is not None and plugin.sharding_strategy in (
        ShardingStrategy.SHARD_OPT, ShardingStrategy.SHARD_GRAD_OP)
        and mesh_shape_of(mesh)[MESH_AXIS_FSDP] > 1)


def moment_shardings(params: dict, mesh: Any, plugin: Optional[ParallelismPlugin] = None,
                     logical_specs: Optional[dict[str, LeafAxes]] = None) -> dict[str, Spec]:
    """The moments' specs: ``infer_opt_state_shardings``' under ZeRO-1/2
    with fsdp above 1, else their parameters' (the reference's moments
    follow their parameters there)."""
    if zero12_shards(plugin, mesh):
        return infer_opt_state_shardings(params, mesh, plugin, logical_specs)
    return infer_param_shardings(params, mesh, plugin, logical_specs)


# ---------------------------------------------------------------------- #
# specs as DTensor placements and local chunks
# ---------------------------------------------------------------------- #
def live_axes(spec: Spec, mesh: Any) -> Spec:
    """``spec`` without the axes of degree 1 (they split nothing)."""
    shape = mesh_shape_of(mesh)
    out = []
    for entry in spec:
        axes = tuple(a for a in _entry_axes(entry) if shape.get(a, 1) > 1)
        out.append(None if not axes else axes[0] if len(axes) == 1 else axes)
    return tuple(out)


def sharded_axes(spec: Spec, mesh: Any) -> tuple[str, ...]:
    """The mesh axes (degree above 1) that split a leaf of ``spec``, in
    mesh order."""
    used = {a for e in live_axes(spec, mesh) for a in _entry_axes(e)}
    return tuple(a for a in MESH_AXES if a in used)


def placements_for(spec: Spec, mesh: Any) -> list:
    """DTensor placements, one a mesh dim in ``MESH_AXES`` order, for a
    spec: ``Shard(d)`` on each axis that splits dim ``d``; where a dim's
    axes run against the mesh's order (two at most), the axis the mesh puts
    first takes ``_StridedShard(d, split_factor=<the other's degree>)``."""
    from torch.distributed.tensor import Replicate, Shard

    shape = mesh_shape_of(mesh)
    out: dict[str, Any] = {a: Replicate() for a in MESH_AXES}
    for d, entry in enumerate(live_axes(spec, mesh)):
        axes = _entry_axes(entry)
        if len(axes) > 2:
            raise NotImplementedError(f"a dim split over {axes}: at most two axes a dim")
        if len(axes) == 2 and MESH_AXES.index(axes[0]) > MESH_AXES.index(axes[1]):
            from torch.distributed.tensor.placement_types import _StridedShard

            out[axes[1]] = _StridedShard(d, split_factor=shape[axes[0]])
            out[axes[0]] = Shard(d)
        else:
            for a in axes:
                out[a] = Shard(d)
    return [out[a] for a in MESH_AXES]


def spec_of_placements(placements: Sequence, ndim: int) -> Spec:
    """The spec a list of placements (``MESH_AXES`` order) encodes: the
    inverse of :func:`placements_for` for axes of degree above 1."""
    from torch.distributed.tensor import Shard

    per_dim: list[list[tuple[int, str]]] = [[] for _ in range(ndim)]
    for axis, pl in zip(MESH_AXES, placements):
        if isinstance(pl, Shard) or type(pl).__name__ == "_StridedShard":
            strided = type(pl).__name__ == "_StridedShard"
            # a strided axis is the minor one: it goes last
            per_dim[pl.dim].append((1 if strided else 0, axis))
    out = []
    for axes in per_dim:
        names = tuple(a for _, a in sorted(axes, key=lambda t: t[0]))
        out.append(None if not names else names[0] if len(names) == 1 else names)
    return tuple(out)


def local_bounds(spec: Spec, global_shape: Sequence[int], rank: int, mesh: Any
                 ) -> tuple[tuple[int, int], ...]:
    """``(start, stop)`` per dim of ``rank``'s chunk of a leaf of
    ``global_shape`` under ``spec``: the chunk index of a dim is the rank's
    coordinate over its axes, the first axis major. Raises when an axis
    does not divide its dim."""
    shape = mesh_shape_of(mesh)
    coord = mesh_coordinate(rank, shape)
    bounds = []
    for d, size in enumerate(global_shape):
        entry = spec[d] if d < len(spec) else None
        axes = tuple(a for a in _entry_axes(entry) if shape.get(a, 1) > 1)
        n, idx = 1, 0
        for a in axes:
            n *= shape[a]
            idx = idx * shape[a] + coord[a]
        if size % n != 0:
            raise ValueError(f"mesh axes {axes} (degree {n}) do not divide dim {d} of size "
                             f"{size}: the port shards only evenly")
        step = size // n
        bounds.append((idx * step, idx * step + step))
    return tuple(bounds)


def is_replica_zero(spec: Spec, rank: int, mesh: Any) -> bool:
    """Whether ``rank`` holds the first copy of its chunk: its coordinate
    is 0 on every axis that does not split the leaf (the one writer of the
    chunk in a checkpoint)."""
    shape = mesh_shape_of(mesh)
    coord = mesh_coordinate(rank, shape)
    used = set(sharded_axes(spec, mesh))
    return all(coord[a] == 0 for a in MESH_AXES if a not in used)


def local_chunk(full: torch.Tensor, spec: Spec, rank: int, mesh: Any) -> torch.Tensor:
    """``rank``'s chunk of a whole tensor under ``spec`` (a view)."""
    out = full
    for d, (lo, hi) in enumerate(local_bounds(spec, full.shape, rank, mesh)):
        if (lo, hi) != (0, full.shape[d]):
            out = out.narrow(d, lo, hi - lo)
    return out


def replicated(mesh: Any) -> list:
    """The placements of a leaf whole on every rank."""
    from torch.distributed.tensor import Replicate

    return [Replicate() for _ in MESH_AXES]


def batch_sharding(mesh: Any, *, seq_dim: Optional[int] = None) -> list:
    """A batch's placements: its leading dim over the data axes (dp x fsdp
    x ep, in mesh order, as the reference's ``P(data_axes)``), and
    ``seq_dim`` over sp when given (reference :85)."""
    spec: list = [data_axes(mesh)]
    if seq_dim is not None:
        spec += [None] * (seq_dim + 1 - len(spec))
        if mesh_shape_of(mesh)[MESH_AXIS_SEQUENCE] > 1:
            spec[seq_dim] = MESH_AXIS_SEQUENCE
    return placements_for(tuple(spec), mesh)


def shard_params(params: dict, specs: dict[str, Spec], mesh: Any, rank: Optional[int] = None,
                 device: Any = None) -> dict:
    """Each whole tensor of ``params`` as a DTensor on ``mesh`` holding
    this rank's chunk (a copy, on ``device`` when given) under its spec; no
    communication, so every rank must pass the same values (weights made
    from one seed, or read from one file)."""
    from torch.distributed.tensor import DTensor

    if rank is None:
        rank = mesh.get_rank()
    out = {}
    for name, full in params.items():
        spec = specs[name]
        local = local_chunk(full.detach(), spec, rank, mesh).contiguous()
        local = local.clone() if device is None else local.to(device, copy=True)
        out[name] = DTensor.from_local(local, mesh, placements_for(spec, mesh),
                                       run_check=False, shape=full.shape,
                                       stride=torch.empty(full.shape, device="meta").stride())
    return out


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def shardings_of(tree: dict) -> dict:
    """The spec of each DTensor leaf of a name -> tensor dict (None for a
    plain tensor)."""
    return {k: spec_of_placements(v.placements, v.ndim) if is_dtensor(v) else None
            for k, v in tree.items()}


def mesh_axes_of_params(params: dict) -> set:
    """The mesh axes (degree above 1) that any leaf of ``params`` is split
    over; empty when every leaf is whole."""
    axes: set = set()
    for leaf in params.values():
        if is_dtensor(leaf):
            spec = spec_of_placements(leaf.placements, leaf.ndim)
            axes.update(sharded_axes(spec, leaf.device_mesh))
    return axes
