"""The device mesh and its axis conventions.

Port of ``accelerate_tpu/parallel/mesh.py`` (all of it). Where the
reference builds one ``jax.sharding.Mesh`` over its devices, the port
builds a ``torch.distributed.device_mesh.DeviceMesh`` over the process
group that ``state.py`` brings up (NCCL on the card, gloo on the CPU), one
device a process, with the same axis names in the same order
(``utils/constants.MESH_AXES``: dp outermost, tp innermost). Rank ``r`` sits
at the mesh coordinate of ``r`` in row-major order over those axes
(:func:`mesh_coordinate`), as the reference's ``devices.reshape(dims)``
places device ``r``.

Every axis runs above 1: pipeline stages (``pp``, ``parallel/pipeline.py``),
sequence parallelism (``sp``, ring attention) and expert parallelism
(``ep``, ``ops/moe.moe_ragged_ep``) beside dp, fsdp and tp. A mesh across
several slices raises, naming part 5 of ROADMAP.md's queue A7. A pp mesh
is validated on its resolved degrees (``pipeline.validate_pipeline_plugin``,
reference :113-117), so ``pp_size=-1`` cannot skip the check. The shape
checks and the env-driven slice helpers need no process group.
"""

from __future__ import annotations

import math
import os
from typing import Any, Optional, Union

from ..utils.constants import (
    ENV_PREFIX,
    MESH_AXES,
    MESH_AXIS_DATA,
    MESH_AXIS_EXPERT,
    MESH_AXIS_FSDP,
    MESH_AXIS_PIPELINE,
)
from ..utils.dataclasses import ParallelismPlugin

NUM_SLICES_ENV = f"{ENV_PREFIX}NUM_SLICES"
FAULT_DOMAIN_ENV = f"{ENV_PREFIX}FAULT_DOMAIN"

# the axes whose degree above 1 waits for a later part of queue A7: none
# since pipelines (part 3) and sequence and expert parallelism (part 4)
UNPORTED_AXES: dict[str, str] = {}


def resolve_num_slices() -> int:
    """How many slices the fleet spans: ``ACCELERATE_TPU_NUM_SLICES`` (the
    elastic supervisor exports it), else 1. A GPU host has no slice
    attribute to read."""
    env = os.environ.get(NUM_SLICES_ENV)
    if env:
        n = int(env)
        if n < 1:
            raise ValueError(f"{NUM_SLICES_ENV}={env} must be >= 1")
        return n
    return 1


def mesh_num_slices(mesh: Any = None) -> int:
    """The number of slices a mesh spans (1: no cross-slice hop)."""
    return resolve_num_slices()


def fault_domain_of_rank(rank: int, world: int, num_slices: int) -> int:
    """The slice of a rank under the slice-major numbering: ranks
    ``[s*world/num_slices, (s+1)*world/num_slices)`` live on slice ``s``."""
    if num_slices <= 1:
        return 0
    if world % num_slices != 0:
        raise ValueError(f"world size {world} is not divisible by num_slices {num_slices}")
    return rank // (world // num_slices)


def resolve_mesh_shape(plugin: ParallelismPlugin, num_devices: int) -> dict[str, int]:
    """The plugin's degrees with the ``-1`` axis resolved against
    ``num_devices``; raises when they do not cover the devices."""
    shape = dict(plugin.mesh_shape)
    fixed = math.prod(v for v in shape.values() if v != -1)
    if num_devices % fixed != 0:
        raise ValueError(
            f"mesh degrees {shape} (product {fixed}) do not divide device count {num_devices}")
    auto_axes = [k for k, v in shape.items() if v == -1]
    if auto_axes:
        shape[auto_axes[0]] = num_devices // fixed
    elif fixed != num_devices:
        raise ValueError(
            f"mesh degrees {shape} use {fixed} devices but {num_devices} are present; "
            "set one axis to -1 to auto-absorb")
    return shape


def check_ported(shape: dict[str, int]) -> None:
    """Raise NotImplementedError for an axis above 1 that the port does not
    run yet, naming its part of queue A7."""
    for axis, why in UNPORTED_AXES.items():
        if shape.get(axis, 1) > 1:
            raise NotImplementedError(f"{why} (mesh {shape})")


def mesh_coordinate(rank: int, shape: dict[str, int]) -> dict[str, int]:
    """The coordinate of ``rank`` on a mesh of ``shape``: row-major over
    ``MESH_AXES``, tp fastest."""
    coord, rest = {}, rank
    for axis in reversed(MESH_AXES):
        size = shape.get(axis, 1)
        coord[axis] = rest % size
        rest //= size
    return {a: coord[a] for a in MESH_AXES}


def build_mesh(plugin: Optional[ParallelismPlugin] = None, device_type: Optional[str] = None):
    """The DeviceMesh of the running process group with the plugin's
    resolved degrees (``init_device_mesh(device_type, dims,
    mesh_dim_names=MESH_AXES)``). ``device_type`` defaults to the group's:
    ``"cuda"`` under NCCL, ``"cpu"`` under gloo. Needs a process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    plugin = plugin or ParallelismPlugin()
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("build_mesh needs a process group: AcceleratorState("
                           "parallelism_plugin=...) brings one up")
    check_ported(plugin.mesh_shape)
    shape = resolve_mesh_shape(plugin, dist.get_world_size())
    check_ported(shape)
    if shape[MESH_AXIS_PIPELINE] > 1:
        from .pipeline import validate_pipeline_plugin

        # on the RESOLVED degrees, so that pp_size=-1 cannot skip the check
        validate_pipeline_plugin(plugin, resolved_shape=shape)
    num_slices = resolve_num_slices()
    if num_slices > 1:
        outer = shape[MESH_AXIS_DATA] * shape[MESH_AXIS_PIPELINE]
        if outer % num_slices != 0:
            raise ValueError(
                f"hierarchical mesh needs the DCN-crossing axes (dp x pp = {outer}) to tile "
                f"the {num_slices} slices; got mesh degrees {shape}")
        raise NotImplementedError("a mesh across several slices is not ported yet: "
                                  "ROADMAP.md, queue A7 part 5")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, tuple(shape[a] for a in MESH_AXES),
                            mesh_dim_names=MESH_AXES)


def single_device_mesh(device_type: Optional[str] = None):
    """A mesh of one process (every axis 1), so the sharded paths run at a
    world size of one; needs a group of one."""
    return build_mesh(ParallelismPlugin(dp_size=1), device_type)


def rank_at(coord: dict[str, int], shape: dict[str, int]) -> int:
    """The rank at mesh coordinate ``coord`` (the inverse of
    :func:`mesh_coordinate`)."""
    rank = 0
    for axis in MESH_AXES:
        rank = rank * shape.get(axis, 1) + coord.get(axis, 0)
    return rank


def axis_peers(rank: int, shape: dict[str, int], axes) -> list[int]:
    """The ranks that share ``rank``'s coordinate on every axis but
    ``axes``, in row-major order over ``axes`` (a sub-group's ranks)."""
    axes = [a for a in MESH_AXES if a in set(axes)]
    coord = mesh_coordinate(rank, shape)
    peers = [rank_at(coord, shape)]
    for axis in axes:
        peers = [rank_at({**mesh_coordinate(r, shape), axis: i}, shape)
                 for r in peers for i in range(shape[axis])]
    return sorted(peers)


def mesh_shape_of(mesh: Union[Any, dict]) -> dict[str, int]:
    """``{axis: degree}`` of a DeviceMesh, or a dict of degrees as it is."""
    if isinstance(mesh, dict):
        return {a: int(mesh.get(a, 1)) for a in MESH_AXES}
    return {a: int(n) for a, n in zip(mesh.mesh_dim_names, mesh.mesh.shape)}


def mesh_axis_size(mesh: Any, *axes: str) -> int:
    shape = mesh_shape_of(mesh)
    return math.prod(shape[a] for a in axes)


def data_axes(mesh: Any) -> tuple[str, ...]:
    """The axes the global batch is split over: every axis that is not
    tensor- or sequence-parallel, of degree above 1 (dp, fsdp, ep); ``("dp",)``
    when none is."""
    shape = mesh_shape_of(mesh)
    return tuple(a for a in (MESH_AXIS_DATA, MESH_AXIS_FSDP, MESH_AXIS_EXPERT)
                 if shape[a] > 1) or (MESH_AXIS_DATA,)
