"""The sharded step's collectives: gathers at use, the tensor-parallel
pieces of the forward, and the gradient and optimizer epilogue over the
mesh.

The reference gives GSPMD a sharding for every leaf and lets XLA insert
the collectives. The port's step is eager, so this module issues them,
each on the sub-group of the mesh axis it runs over (``DeviceMesh.
get_group``), on plain local tensors: a kernel never sees a DTensor.

* **Gather at use** (FSDP / ZeRO-3). A leaf whose spec splits a dim over
  fsdp is cast to the compute dtype on its shard and all-gathered over
  fsdp just before it is used; the backward of the gather is the
  reduce-scatter (:class:`_GatherFsdp`). The parameters of a port model's
  layer ``i`` are gathered when that layer runs (``models.transformer.
  _layer_stack`` reads :func:`layer_gather`), and again in the recompute
  under remat, so a layer's whole weights live only while it runs; every
  other leaf is gathered before the loss runs.
* **Tensor parallelism** (Megatron's pair). Inside :func:`sharded_forward`
  the model reads :func:`tp_state`: q, gate and up are split by columns
  (the local heads), o_proj and down by rows; ``copy_to_tp`` (identity,
  all-reduce in the backward) goes in front of a column-split product and
  ``reduce_from_tp`` (all-reduce, identity in the backward) after a
  row-split one. The embedding and the lm_head are split over the vocab:
  a lookup masks the ids outside the local range and sums over tp, and the
  logits are gathered over tp before the loss. The reference keeps k_proj
  and v_proj whole on tp (``("embed", "kv")``, "kv" -> None); each tp rank
  uses the rows of its q heads' kv heads, so their gradients, and under
  the fused prologue the attention norm's, are partial sums that
  :meth:`ShardedLayout.reduce_grads_` adds over tp exactly once (the
  model names them, ``models.transformer.tp_partial_leaves``).
* **The epilogue.** A gradient is summed over the ranks that hold other
  tokens of the global batch and the same shard of the leaf: the token
  axes dp, fsdp, ep and sp, less the axes that split the leaf (an expert
  stack split over ep sums over dp x fsdp x sp; the fsdp part comes from the
  gather's reduce-scatter for a leaf split over fsdp), then divided by the
  number of token ranks (dp x fsdp x ep x sp), the count the loss's weights
  were made over. Pipeline stages (pp) and tp peers are not token ranks: a
  stage's layers are its own, and tp peers hold the same tokens. The clip's norm sums each
  leaf's squares once per distinct shard; under fp16 the non-finite flag
  is all-reduced, so an inf on one rank holds every rank's step. ZeRO-1
  (SHARD_OPT) updates each rank's fsdp slice of a whole parameter with its
  moment shard and all-gathers the slices; ZeRO-2 (SHARD_GRAD_OP)
  reduce-scatters each gradient into a sharded accumulation buffer first.

At a world size of one every sub-group is one rank: no divide runs, the
norm is ``optimizer.global_norm`` of the same tensors, and the step's
numbers are the unsharded step's bit for bit.
"""

from __future__ import annotations

import contextlib
import math
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from ..utils.constants import (
    MESH_AXES,
    MESH_AXIS_DATA,
    MESH_AXIS_EXPERT,
    MESH_AXIS_FSDP,
    MESH_AXIS_SEQUENCE,
    MESH_AXIS_TENSOR,
)
from ..utils.dataclasses import ParallelismPlugin, ShardingStrategy
from .mesh import axis_peers, mesh_coordinate, mesh_shape_of

# the axes over which ranks hold different rows of the global batch, and
# with sp the axes over which they hold different tokens
ROW_AXES = (MESH_AXIS_DATA, MESH_AXIS_FSDP, MESH_AXIS_EXPERT)
TOKEN_AXES = ROW_AXES + (MESH_AXIS_SEQUENCE,)
from .sharding import (
    Spec,
    _entry_axes,
    is_dtensor,
    live_axes,
    local_bounds,
    moment_shardings,
    grad_buffer_shardings,
    infer_param_shardings,
    placements_for,
    shard_params,
    sharded_axes,
    spec_of_placements,
    zero12_shards,
)


def _dist():
    import torch.distributed as dist

    return dist


# ---------------------------------------------------------------------- #
# collectives along one tensor dim
# ---------------------------------------------------------------------- #
def all_gather_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The group's chunks of ``x`` concatenated along ``dim`` in group-rank
    order."""
    if n == 1:
        return x
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((n * xm.shape[0],) + tuple(xm.shape[1:]), dtype=x.dtype, device=x.device)
    _dist().all_gather_into_tensor(out, xm, group=group)
    out = out.movedim(0, dim)
    return out if dim == 0 else out.contiguous()


def reduce_scatter_dim(x: torch.Tensor, dim: int, group, n: int) -> torch.Tensor:
    """The group's sum of ``x``, each rank keeping its chunk along
    ``dim``."""
    if n == 1:
        return x
    xm = x.movedim(dim, 0).contiguous()
    out = torch.empty((xm.shape[0] // n,) + tuple(xm.shape[1:]), dtype=x.dtype, device=x.device)
    dist = _dist()
    dist.reduce_scatter_tensor(out, xm, op=dist.ReduceOp.SUM, group=group)
    out = out.movedim(0, dim)
    return out if dim == 0 else out.contiguous()


class _GatherFsdp(torch.autograd.Function):
    """All-gather over fsdp along a dim; the backward reduce-scatters."""

    @staticmethod
    def forward(ctx, x, dim, group, n):
        ctx.dim, ctx.group, ctx.n = dim, group, n
        return all_gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group, ctx.n), None, None, None


class _CopyToTP(torch.autograd.Function):
    """Identity; the backward sums the gradient over tp."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _dist().all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromTP(torch.autograd.Function):
    """The sum over tp; the backward passes the gradient through."""

    @staticmethod
    def forward(ctx, x, group):
        out = x.contiguous().clone()
        _dist().all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromTP(torch.autograd.Function):
    """All-gather over tp along ``dim``; the backward keeps the local
    chunk."""

    @staticmethod
    def forward(ctx, x, dim, group, n, rank):
        ctx.dim, ctx.n, ctx.rank, ctx.size = dim, n, rank, x.shape[dim]
        return all_gather_dim(x, dim, group, n)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size).contiguous(), None, None, None, None


# ---------------------------------------------------------------------- #
# the forward's context: what the model reads while the step runs
# ---------------------------------------------------------------------- #
@dataclass
class TensorParallel:
    group: Any
    size: int
    rank: int

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        return _CopyToTP.apply(x, self.group)

    def reduce(self, x: torch.Tensor) -> torch.Tensor:
        return _ReduceFromTP.apply(x, self.group)

    def gather(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        return _GatherFromTP.apply(x, dim % x.dim(), self.group, self.size, self.rank)

    def vocab_embedding(self, ids: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
        """A lookup into this rank's rows of a vocab-split table, summed over
        tp: ids outside the local range read zeros."""
        rows = weight.shape[0]
        lo = self.rank * rows
        local = ids - lo
        inside = (local >= 0) & (local < rows)
        out = torch.nn.functional.embedding(local.clamp(0, rows - 1), weight)
        out = out * inside[..., None].to(out.dtype)
        return self.reduce(out)


@dataclass
class AxisGroup:
    """One mesh axis (or several) as the forward reads it: the sub-group,
    its size, this rank's index in it, and the group's global ranks in
    group order. The sequence-parallel chunk and the expert shard of a port
    model come from here."""
    group: Any
    size: int
    rank: int
    ranks: tuple = ()


@dataclass
class _ForwardContext:
    gather: Optional[Callable[[str, dict], dict]]
    tp: Optional[TensorParallel]
    sp: Optional[AxisGroup] = None
    ep: Optional[AxisGroup] = None
    tokens: Optional[AxisGroup] = None
    rows: Optional[AxisGroup] = None
    # set by a port model's forward: whether it split its sequence over sp
    seq_split: bool = False


# a module global, not a thread-local: autograd may run the backward (and
# the remat recompute inside it) on a thread of its own
_ACTIVE: Optional[_ForwardContext] = None


@contextlib.contextmanager
def sharded_forward(gather: Optional[Callable[[str, dict], dict]] = None,
                    tp: Optional[TensorParallel] = None, sp: Optional[AxisGroup] = None,
                    ep: Optional[AxisGroup] = None, tokens: Optional[AxisGroup] = None,
                    rows: Optional[AxisGroup] = None):
    """Inside: a port model gathers each layer's parameters through
    ``gather(prefix, {name: tensor}) -> {name: tensor}`` as the layer runs,
    splits its products over ``tp``, takes its sequence chunk over ``sp``
    (ring attention) and its expert shard over ``ep``; ``tokens`` is the
    group of the ranks that hold other tokens (the MoE's window), ``rows``
    of those that hold other rows."""
    global _ACTIVE
    prev = _ACTIVE

    def live(g):
        return g if g is not None and g.size > 1 else None

    _ACTIVE = _ForwardContext(gather, live(tp), live(sp), live(ep), tokens, rows)
    try:
        yield
    finally:
        _ACTIVE = prev


def layer_gather() -> Optional[Callable[[str, dict], dict]]:
    return None if _ACTIVE is None else _ACTIVE.gather


def tp_state() -> Optional[TensorParallel]:
    return None if _ACTIVE is None else _ACTIVE.tp


def sp_state() -> Optional[AxisGroup]:
    """The sequence-parallel group of the running sharded step (sp above
    1), else None."""
    return None if _ACTIVE is None else _ACTIVE.sp


def ep_state() -> Optional[AxisGroup]:
    """The expert-parallel group of the running sharded step (ep above
    1), else None."""
    return None if _ACTIVE is None else _ACTIVE.ep


def token_state() -> Optional[AxisGroup]:
    """The ranks that hold other tokens of the global batch than this one,
    in the global batch's order, under a running sharded step: dp x fsdp x
    ep x sp where the model split its sequence over sp, else the ranks
    that hold other rows (dp x fsdp x ep)."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.tokens if _ACTIVE.seq_split else _ACTIVE.rows


def set_sequence_split(split: bool) -> None:
    """A port model's forward says whether it split its sequence over sp
    (ring attention on a length sp tiles) or kept it whole."""
    if _ACTIVE is not None:
        _ACTIVE.seq_split = bool(split)


def sequence_split() -> bool:
    return _ACTIVE is not None and _ACTIVE.seq_split


# ---------------------------------------------------------------------- #
# the layout: every leaf's specs and the step's collectives
# ---------------------------------------------------------------------- #
def _axis_dim(spec: Spec, axis: str, mesh) -> Optional[int]:
    for d, entry in enumerate(live_axes(spec, mesh)):
        axes = _entry_axes(entry)
        if axis in axes:
            if axes[-1] != axis:
                raise NotImplementedError(f"fsdp must be the minor axis of a dim it shares, "
                                          f"got {axes}")
            return d
    return None


def to_local(t: Any) -> Any:
    """A DTensor's local tensor, sharing its storage; anything else as it
    is."""
    if is_dtensor(t):
        return t._local_tensor
    return t


class ShardedLayout:
    """The specs of one prepared parameter set on a mesh and the
    collectives of the step that trains it (the module docstring).

    ``param_specs``/``moment_specs``/``buffer_specs``: name -> spec of the
    parameters, the optimizer's moments and the unfused accumulation
    buffer. ``lazy_prefix``: leaves under it are gathered by the model's
    layer loop, not before the loss. ``tp_partial``: leaves whose gradient
    each tp rank holds a partial sum of."""

    def __init__(self, mesh, plugin: ParallelismPlugin, param_specs: dict[str, Spec],
                 moment_specs: dict[str, Spec], buffer_specs: dict[str, Spec],
                 lazy_prefix: Optional[str] = None, tp_partial: frozenset = frozenset()):
        dist = _dist()
        self.mesh, self.plugin = mesh, plugin
        self.shape = mesh_shape_of(mesh)
        self.world = math.prod(self.shape.values())
        self.rank = dist.get_rank()
        self.coord = mesh_coordinate(self.rank, self.shape)
        self.param_specs, self.moment_specs = param_specs, moment_specs
        self.buffer_specs = buffer_specs
        self.lazy_prefix = lazy_prefix
        self.tp_partial = tp_partial
        self.groups = {a: mesh.get_group(a) for a in MESH_AXES}
        self.fsdp = self.shape[MESH_AXIS_FSDP]
        self.tp = TensorParallel(self.groups[MESH_AXIS_TENSOR], self.shape[MESH_AXIS_TENSOR],
                                 self.coord[MESH_AXIS_TENSOR])
        self.sp = self.axis(MESH_AXIS_SEQUENCE)
        self.ep = self.axis(MESH_AXIS_EXPERT)
        # the loss's weights and the gradient means run over the token ranks
        self.data_size = math.prod(self.shape[a] for a in TOKEN_AXES)
        self.data_group = axes_group(mesh, TOKEN_AXES)
        self.rows_group = axes_group(mesh, ROW_AXES)
        self.tokens = self._axes(self.data_group, TOKEN_AXES)
        self.rows = self._axes(self.rows_group, ROW_AXES)
        self.zero12 = zero12_shards(plugin, mesh)
        self.zero2 = self.zero12 and plugin.sharding_strategy == ShardingStrategy.SHARD_GRAD_OP
        self.gather_dims = {k: _axis_dim(s, MESH_AXIS_FSDP, mesh) for k, s in param_specs.items()}
        self.moment_dims = {k: _axis_dim(s, MESH_AXIS_FSDP, mesh)
                            for k, s in moment_specs.items()}
        # each leaf's gradient is summed over the token axes that do not
        # split it; every rank makes the same groups in the same order
        self.reduce_groups = {k: self._replica_group(k) for k in sorted(param_specs)}
        if self.zero12 and self.tp.size > 1:
            raise NotImplementedError(
                "SHARD_OPT/SHARD_GRAD_OP with fsdp and tp both above 1: the reference's "
                "moments then shard the whole parameter over fsdp alone, which the port's "
                f"tp-split step does not hold (mesh {self.shape}); use FULL_SHARD")

    # ---------------------------------------------------------------- #
    def axis(self, axis: str) -> AxisGroup:
        return AxisGroup(self.groups[axis], self.shape[axis], self.coord[axis],
                         tuple(axis_peers(self.rank, self.shape, (axis,))))

    def _axes(self, group, axes) -> AxisGroup:
        return AxisGroup(group, math.prod(self.shape[a] for a in axes),
                         _axes_index(self.coord, self.shape, axes),
                         tuple(axis_peers(self.rank, self.shape, axes)))

    def _replica_group(self, name: str):
        """The group a gradient of leaf ``name`` is summed over: the token
        axes that split neither the leaf nor (ZeRO-2) its buffer, and not
        fsdp where the gather's reduce-scatter has summed over it."""
        used = set(sharded_axes(self.param_specs[name], self.mesh))
        if self.gather_dims.get(name) is not None or (
                self.zero2 and _axis_dim(self.buffer_specs[name], MESH_AXIS_FSDP,
                                         self.mesh) is not None):
            used.add(MESH_AXIS_FSDP)
        return axes_group(self.mesh, tuple(a for a in TOKEN_AXES if a not in used))

    @property
    def trivial(self) -> bool:
        return self.world == 1

    def local(self, tree: dict) -> dict:
        return {k: to_local(v) for k, v in tree.items()}

    def gather_leaf(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """Leaf ``name``'s local shard (in the compute dtype) gathered over
        fsdp, differentiably; as it is when fsdp does not split it."""
        d = self.gather_dims.get(name)
        if d is None:
            return t
        return _GatherFsdp.apply(t, d, self.groups[MESH_AXIS_FSDP], self.fsdp)

    def loss_params(self, compute: dict) -> dict:
        """The leaves the loss receives: gathered now, except those the
        model's layer loop gathers as each layer runs."""
        return {k: t if self._lazy(k) else self.gather_leaf(k, t) for k, t in compute.items()}

    def _lazy(self, name: str) -> bool:
        return self.lazy_prefix is not None and name.startswith(self.lazy_prefix)

    def _gather_prefix(self, prefix: str, tensors: dict) -> dict:
        return {n: self.gather_leaf(prefix + n, t) for n, t in tensors.items()}

    def forward_context(self, whole_batch: bool = False):
        """The step's forward context. ``whole_batch``: every rank holds the
        same whole batch (``apply_sharded``): no sequence chunk over sp, and
        the MoE's windows over this rank's tokens alone."""
        gather = self._gather_prefix if self.lazy_prefix else None
        if whole_batch:
            alone = AxisGroup(None, 1, 0, (self.rank,))
            return sharded_forward(gather, self.tp, None, self.ep, alone, alone)
        return sharded_forward(gather, self.tp, self.sp, self.ep, self.tokens, self.rows)

    # ---------------------------------------------------------------- #
    # gradients
    # ---------------------------------------------------------------- #
    def zero2_scatter(self, name: str, g: torch.Tensor) -> torch.Tensor:
        """ZeRO-2: a whole gradient summed over fsdp, each rank keeping the
        chunk of its buffer's spec."""
        d = _axis_dim(self.buffer_specs[name], MESH_AXIS_FSDP, self.mesh)
        if d is None:
            return g
        return reduce_scatter_dim(g, d, self.groups[MESH_AXIS_FSDP], self.fsdp)

    def reduce_grads_(self, grads: dict, scattered: bool = False) -> dict:
        """The gradients summed over the token ranks that share the leaf's
        shard (the module docstring) and divided by the number of token
        ranks, the tp-partial ones summed over tp first. A leaf the gather
        split over fsdp (or, ``scattered``, a ZeRO-2 buffer chunk) already
        holds its fsdp sum. Returns the dict (a ZeRO-2 scatter replaces
        entries)."""
        dist = _dist()
        out = {}
        for k, g in grads.items():
            if self.tp.size > 1 and k in self.tp_partial:
                dist.all_reduce(g, group=self.tp.group)
            if self.zero2 and not scattered:
                g = self.zero2_scatter(k, g)
            dist.all_reduce(g, group=self.reduce_groups[k])
            if self.data_size > 1:
                g.div_(self.data_size)
            out[k] = g
        return out

    def held_spec(self, name: str) -> Spec:
        """The spec of the gradient the epilogue holds for ``name``."""
        if self.zero2:
            return self.buffer_specs[name]
        return self.param_specs[name]

    def global_norm(self, grads: dict) -> torch.Tensor:
        """sqrt of every leaf's squares summed once per distinct shard
        (``optimizer.global_norm`` at a world size of one)."""
        from ..optimizer import global_norm

        if self.trivial:
            return global_norm(grads)
        total = None
        for k, g in grads.items():
            n = math.prod(self.shape[a] for a in sharded_axes(self.held_spec(k), self.mesh))
            term = torch.sum(g.float() ** 2) / (self.world // n)
            total = term if total is None else total + term
        _dist().all_reduce(total)
        return torch.sqrt(total)

    def all_finite(self, finite: bool, device) -> bool:
        """Every rank's non-finite check, all-reduced."""
        if self.trivial:
            return finite
        flag = torch.tensor(0.0 if finite else 1.0, device=device)
        _dist().all_reduce(flag)
        return bool(flag.item() == 0.0)

    # ---------------------------------------------------------------- #
    # the update
    # ---------------------------------------------------------------- #
    def work_set(self, grads: dict, params: dict, opt_state: dict):
        """``(grads, params, state, finish)``: plain tensors the optimizer
        updates in place, and ``finish()`` to run after it. Without ZeRO-1/2
        the local shards themselves. Under ZeRO-1/2 each leaf whose moment
        is split over fsdp takes this rank's slice of its whole parameter
        (and of its whole gradient under ZeRO-1); ``finish`` all-gathers
        the updated slices into the whole parameter and hands the count
        back."""
        lp = self.local(params)
        lstate = {k: (self.local(v) if isinstance(v, dict) else v) for k, v in opt_state.items()}
        if not self.zero12:
            def finish():
                opt_state["count"] = lstate.get("count", opt_state.get("count"))

            return grads, lp, lstate, finish
        wp, wg, gathers = {}, {}, []
        for k, p in lp.items():
            d = self.moment_dims.get(k)
            if d is None:
                wp[k], wg[k] = p, grads[k]
                continue
            (lo, hi) = local_bounds(self.moment_specs[k], p.shape, self.rank, self.mesh)[d]
            wp[k] = p.narrow(d, lo, hi - lo).contiguous()
            g = grads[k]
            wg[k] = g if self.zero2 else g.narrow(d, lo, hi - lo).contiguous()
            gathers.append((k, d))

        def finish():
            opt_state["count"] = lstate.get("count", opt_state.get("count"))
            with torch.no_grad():
                for k, d in gathers:
                    lp[k].copy_(all_gather_dim(wp[k], d, self.groups[MESH_AXIS_FSDP], self.fsdp))

        return wg, wp, lstate, finish

    # ---------------------------------------------------------------- #
    # placing trees
    # ---------------------------------------------------------------- #
    def place(self, tree: dict, specs: dict[str, Spec]) -> dict:
        """Whole tensors as DTensors under ``specs`` (this rank's chunks)."""
        return shard_params(tree, specs, self.mesh, self.rank)

    def place_opt_state(self, opt_state: Any) -> Any:
        """An optimizer state made for the DTensor params, with each
        per-parameter tensor dict (the moments) moved to the moments'
        specs."""
        if not isinstance(opt_state, dict):
            return opt_state
        out = {}
        for key, v in opt_state.items():
            if isinstance(v, dict) and v and set(v) <= set(self.moment_specs) and all(
                    isinstance(t, torch.Tensor) for t in v.values()):
                out[key] = {k: self.replace(t, self.moment_specs[k]) for k, t in v.items()}
            else:
                out[key] = v
        return out

    def replace(self, t: torch.Tensor, spec: Spec) -> torch.Tensor:
        """``t`` (a DTensor, or a whole tensor) as a DTensor under ``spec``."""
        if is_dtensor(t) and spec_of_placements(t.placements, t.ndim) == live_axes(spec, self.mesh):
            return t
        full = gather_full(t) if is_dtensor(t) else t
        return shard_params({"_": full}, {"_": spec}, self.mesh, self.rank)["_"]

    def zeros_buffer(self, params: dict) -> dict:
        """The unfused accumulation buffer: fp32 zeros under the buffer's
        specs."""
        from torch.distributed.tensor import DTensor

        out = {}
        for k, p in params.items():
            spec = self.buffer_specs[k]
            bounds = local_bounds(spec, p.shape, self.rank, self.mesh)
            local = torch.zeros(tuple(hi - lo for lo, hi in bounds), dtype=torch.float32,
                                device=to_local(p).device)
            out[k] = DTensor.from_local(local, self.mesh, placements_for(spec, self.mesh),
                                        run_check=False, shape=p.shape,
                                        stride=torch.empty(p.shape, device="meta").stride())
        return out


def _axes_index(coord: dict, shape: dict, axes) -> int:
    """A rank's index among the ranks that differ from it only on
    ``axes``: row-major over them in mesh order."""
    idx = 0
    for a in MESH_AXES:
        if a in axes:
            idx = idx * shape[a] + coord[a]
    return idx


def axes_group(mesh, axes):
    """The group of the ranks that differ from this one only on ``axes``:
    the whole world when those are every axis above 1, the axis's own
    sub-group (``DeviceMesh.get_group``) when one axis is, and otherwise a
    group made for each bucket of ranks, made once a mesh and in the same
    order on every rank, as ``new_group`` asks."""
    dist = _dist()
    shape = mesh_shape_of(mesh)
    live = tuple(a for a in MESH_AXES if a in axes and shape[a] > 1)
    others = tuple(a for a in MESH_AXES if a not in live and shape[a] > 1)
    if not others:
        return dist.group.WORLD
    if len(live) == 1:
        return mesh.get_group(live[0])
    if not live:  # a group of this rank alone: any axis of degree 1
        return mesh.get_group(next(a for a in MESH_AXES if shape[a] == 1))
    cache = mesh.__dict__.setdefault("_accelerate_axes_groups", {})
    if live not in cache:
        world = math.prod(shape.values())
        rank = dist.get_rank()
        buckets: dict[tuple, list[int]] = {}
        for r in range(world):
            c = mesh_coordinate(r, shape)
            buckets.setdefault(tuple(c[a] for a in others), []).append(r)
        for key in sorted(buckets):
            group = dist.new_group(buckets[key])
            if rank in buckets[key]:
                cache[live] = group
    return cache[live]


def data_parallel_group(mesh):
    """The group of the ranks that hold other tokens of the global batch
    than this one (dp x fsdp x ep x sp), sharing its tp and pp coordinate;
    the whole world when no other axis is above 1."""
    return axes_group(mesh, TOKEN_AXES)


def gather_full(t: Any) -> torch.Tensor:
    """A DTensor's whole value on every rank (each rank's chunk all-gathered
    over the world and placed at its bounds); a plain tensor as it is."""
    if not is_dtensor(t):
        return t
    mesh = t.device_mesh
    shape = mesh_shape_of(mesh)
    world = math.prod(shape.values())
    local = t._local_tensor.contiguous()
    if world == 1:
        return local
    spec = spec_of_placements(t.placements, t.ndim)
    dist = _dist()
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local)
    full = torch.empty(tuple(t.shape), dtype=local.dtype, device=local.device)
    for r, part in enumerate(parts):
        idx = tuple(slice(lo, hi) for lo, hi in local_bounds(spec, t.shape, r, shape))
        full[idx] = part
    return full


def build_layout(mesh, plugin: ParallelismPlugin, params: dict, logical_specs=None,
                 lazy_prefix: Optional[str] = None, tp_partial: frozenset = frozenset()
                 ) -> ShardedLayout:
    """The layout of ``params`` (whole tensors or shapes) under the plugin's
    rules."""
    param_specs = infer_param_shardings(params, mesh, plugin, logical_specs)
    moment_specs = moment_shardings(params, mesh, plugin, logical_specs)
    if zero12_shards(plugin, mesh) and plugin.sharding_strategy == ShardingStrategy.SHARD_GRAD_OP:
        buffer_specs = grad_buffer_shardings(params, mesh, plugin, logical_specs)
    else:
        buffer_specs = dict(param_specs)
    return ShardedLayout(mesh, plugin, param_specs, moment_specs, buffer_specs,
                         lazy_prefix=lazy_prefix, tp_partial=tp_partial)


def layout_of_placements(params: dict, plugin: Optional[ParallelismPlugin] = None,
                         lazy_prefix: Optional[str] = None) -> ShardedLayout:
    """The layout of parameters already placed: each DTensor's spec read
    from its placements (a plain tensor whole), moments and buffer alike."""
    sharded = [v for v in params.values() if is_dtensor(v)]
    specs = {k: spec_of_placements(v.placements, v.ndim) if is_dtensor(v)
             else (None,) * v.ndim for k, v in params.items()}
    return ShardedLayout(sharded[0].device_mesh, plugin or ParallelismPlugin.pure_dp(), specs,
                         specs, specs, lazy_prefix=lazy_prefix)


def apply_sharded(model, *args, **kwargs):
    """``model(*args, **kwargs)`` for a module whose parameters are
    DTensors (a module prepared under a plugin, or loaded onto a mesh by
    ``big_modeling.load_checkpoint_and_dispatch(mesh=...)``), without a
    gradient: the local shards go in, a leaf split over fsdp is gathered as
    it is used (a port model's layers one at a time), the products split
    over tp and the experts over ep, as in the train step. Every rank of the
    mesh calls it with the same whole batch, and gets the whole output."""
    from torch import nn

    params = dict(model.named_parameters())
    sharded = [v for v in params.values() if is_dtensor(v)]
    if not sharded:
        return model(*args, **kwargs)
    layout = getattr(model, "_apply_layout", None)
    if layout is None or set(layout.param_specs) != set(params):
        transformer = (callable(getattr(model, "logical_axes", None))
                       and isinstance(getattr(model, "layers", None), nn.ModuleList))
        layout = layout_of_placements(params, lazy_prefix="layers." if transformer else None)
        model._apply_layout = layout
    with torch.no_grad(), layout.forward_context(whole_batch=True):
        return torch.func.functional_call(model, layout.loss_params(layout.local(params)), args,
                                          kwargs)
