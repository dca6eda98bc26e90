"""Pipeline parallelism over the ``pp`` mesh axis: GPipe and 1F1B.

Port of ``accelerate_tpu/parallel/pipeline.py`` (all of it). The layer
stack is a stacked tensor per leaf (leading ``num_layers`` dim) whose layer
dim is split over pp (:func:`stacked_layer_shardings`): stage ``i`` holds
layers ``[i*L/S, (i+1)*L/S)``. Where the reference runs one ``shard_map``
program whose ``scan`` ticks the schedule and ``ppermute`` moves the
activations, each stage here is a process of the group running its own
stage body tick by tick, and P2P sends and receives
(``torch.distributed.batch_isend_irecv``) move the activations forward and
the cotangents back between the ranks that share every coordinate but pp.

* :func:`pipeline_apply` — GPipe: the forward ticks, every microbatch's
  graph kept (autograd saves the residuals of all M microbatches), the
  output broadcast from the last stage to every stage; its backward runs
  the reverse schedule, each stage's cotangents going back by the reverse
  send.
* :func:`pipeline_train_step` — 1F1B (PipeDream-Flush): one tick table
  (:func:`schedule_1f1b`) says which microbatch each stage runs forward
  and backward at each tick; each stage keeps only the inputs of its
  in-flight microbatches (at most ``2S - 1``, whatever M is), runs its
  forward without a graph, and in the backward sub-phase re-runs the stage
  from the saved input under autograd (recompute). No (M, ...) output
  buffer exists: the last stage takes each microbatch's loss and turns its
  cotangent around in the same tick. Stage 0 alone reads the inputs and
  the last stage alone the targets (the other stages may pass None): the
  port's form of the reference's feed sharding (:328-340). A stage with no
  microbatch at a tick does no work, where the reference computes masked
  ticks; the numbers are the same.

The per-stage body (:class:`StageBody`) is a function of its stage's
inputs; the collectives only carry tensors between the bodies, so a
one-process runner can run every stage's body through the same tick table
(``test_utils/pipeline_runner.py``).

Both return the global batch's numbers: the loss (the last stage's, summed
over pp, over M, then averaged over the ranks holding other tokens) on
every rank, and each stage's gradients averaged over those ranks (dp x
fsdp x ep x sp; a leaf split over one of them sums over the rest).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Optional

import torch

from ..utils.constants import MESH_AXIS_PIPELINE
from ..utils.dataclasses import ParallelismPlugin
from .mesh import mesh_coordinate, mesh_shape_of, rank_at
from .runtime import TOKEN_AXES, axes_group, to_local
from .sharding import is_dtensor, sharded_axes, spec_of_placements


def partial_manual_supported() -> bool:
    """True. The reference asks its jax for partial-manual ``shard_map``,
    which 1F1B and pp composed with tp, sp or ep need; the port's stages are
    processes with their own collectives, so every composition the
    validator admits runs. Kept for the reference's API."""
    return True


def validate_pipeline_plugin(plugin: ParallelismPlugin,
                             resolved_shape: Optional[dict] = None) -> None:
    """The reference's validator (:102-147) on the plugin, or on the mesh
    degrees ``resolved_shape`` (from ``resolve_mesh_shape``) so that
    ``pp_size=-1`` cannot skip it: fewer microbatches than stages raises.
    pp composes with tp, sp and ep."""
    pp = resolved_shape["pp"] if resolved_shape is not None else plugin.pp_size
    if pp in (1, -1):
        return
    if plugin.num_micro_batches < pp:
        raise ValueError(
            f"num_micro_batches ({plugin.num_micro_batches}) must be >= pp_size ({pp}) or "
            "the pipeline bubbles dominate")


def stacked_layer_shardings(stacked_params: dict, mesh: Any, layer_dim: int = 0) -> dict:
    """Each leaf's spec (``parallel.sharding``'s form): its ``layer_dim``
    over pp where pp divides it, else whole (reference :150). Place the
    leaves with ``parallel.sharding.shard_params``."""
    pp = mesh_shape_of(mesh)[MESH_AXIS_PIPELINE]
    out = {}
    for name, leaf in stacked_params.items():
        shape = tuple(leaf.shape)
        spec = [None] * len(shape)
        if len(shape) > layer_dim and shape[layer_dim] % pp == 0:
            spec[layer_dim] = MESH_AXIS_PIPELINE
        out[name] = tuple(spec)
    return out


def _microbatch(tree: Any, M: int, batch_dim: int = 0) -> Any:
    """(B, ...) leaves -> (M, B/M, ...), microbatch-major (reference
    :255)."""

    def one(x):
        B = x.shape[batch_dim]
        if B % M:
            raise ValueError(f"batch {B} not divisible into {M} microbatches")
        xm = x.movedim(batch_dim, 0)
        return xm.reshape((M, B // M) + tuple(xm.shape[1:]))

    if isinstance(tree, dict):
        return {k: _microbatch(v, M, batch_dim) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_microbatch(v, M, batch_dim) for v in tree)
    return one(tree)


def _index(tree: Any, j: int) -> Any:
    if isinstance(tree, dict):
        return {k: _index(v, j) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_index(v, j) for v in tree)
    return tree[j]


# ---------------------------------------------------------------------- #
# the tick tables
# ---------------------------------------------------------------------- #
def schedule_1f1b(num_stages: int, num_micro: int) -> list[list[tuple]]:
    """The 1F1B tick table (reference :369-414): ``table[t][i] = (f, b)``,
    the microbatch stage ``i`` runs forward (``f``) and backward (``b``)
    at tick ``t``, None where it has none. Microbatch ``j`` runs forward on
    stage ``i`` at tick ``i + j`` and backward at ``2S - 2 - i + j``; the
    last stage turns a microbatch around in the tick of its forward.
    ``M + 2S - 2`` ticks."""
    S, M = num_stages, num_micro
    table = []
    for t in range(M + 2 * S - 2):
        row = []
        for i in range(S):
            jf, jb = t - i, t - (2 * S - 2 - i)
            row.append((jf if 0 <= jf < M else None, jb if 0 <= jb < M else None))
        table.append(row)
    return table


def schedule_gpipe(num_stages: int, num_micro: int) -> list[list[Optional[int]]]:
    """The GPipe forward tick table (reference :204-226): ``table[t][i]``
    the microbatch stage ``i`` runs at tick ``t`` (``t - i``), None when it
    has none; ``M + S - 1`` ticks. The backward runs it in reverse, each
    stage taking its microbatches last first."""
    S, M = num_stages, num_micro
    return [[(t - i) if 0 <= t - i < M else None for i in range(S)]
            for t in range(M + S - 1)]


def gpipe_backward_order(num_stages: int, num_micro: int) -> list[list[Optional[int]]]:
    """The GPipe backward tick table: stage ``i`` runs the backward of
    microbatch ``M - 1 - (u - (S - 1 - i))`` at tick ``u``."""
    S, M = num_stages, num_micro
    out = []
    for u in range(M + S - 1):
        row = []
        for i in range(S):
            j = (M - 1) - (u - (S - 1 - i))
            row.append(j if 0 <= j < M else None)
        out.append(row)
    return out


# ---------------------------------------------------------------------- #
# the stage body
# ---------------------------------------------------------------------- #
def _leaves(params: dict) -> dict:
    """Plain tensors: a DTensor's local shard (this stage's layers)."""
    return {k: to_local(v) for k, v in params.items()}


class StageBody:
    """One stage's work in the 1F1B schedule, a function of the stage's
    inputs only: ``forward(j, x)`` runs microbatch ``j`` (no graph) and
    keeps ``x`` in the input ring; on the last stage it also takes the
    microbatch's loss against ``target`` and returns its cotangent;
    ``backward(j, ct)`` re-runs the stage on the saved input under autograd,
    adds the parameter gradients (in fp32), and returns the input's
    cotangent (None on stage 0). ``grads`` and ``loss_sum`` hold the sums;
    ``peak_inputs`` and ``ring_bytes`` the most inputs, and bytes, the ring
    held at once."""

    def __init__(self, block_fn: Callable, loss_fn: Optional[Callable], params: dict,
                 is_first: bool, is_last: bool, ring_depth: int):
        self.block_fn, self.loss_fn = block_fn, loss_fn
        self.params = params
        self.is_first, self.is_last = is_first, is_last
        self.R = ring_depth
        self.ring: dict[int, torch.Tensor] = {}
        self.grads: Optional[dict] = None
        self.loss_sum: Optional[torch.Tensor] = None
        self.peak_inputs = 0
        self.ring_bytes = 0

    def forward(self, j: int, x: torch.Tensor, target: Any = None):
        slot = j % self.R
        if slot in self.ring:
            raise RuntimeError(f"input ring slot {slot} is still in flight")
        self.ring[slot] = x
        self.peak_inputs = max(self.peak_inputs, len(self.ring))
        self.ring_bytes = max(self.ring_bytes,
                              sum(t.numel() * t.element_size() for t in self.ring.values()))
        with torch.no_grad():
            y = self.block_fn(self.params, x)
        if not self.is_last:
            return y, None
        with torch.enable_grad():
            yl = y.detach().requires_grad_(True)
            loss = self.loss_fn(yl, target)
            (dy,) = torch.autograd.grad(loss, [yl])
        loss = loss.detach().float()
        self.loss_sum = loss if self.loss_sum is None else self.loss_sum + loss
        return y, dy

    def backward(self, j: int, ct: torch.Tensor) -> Optional[torch.Tensor]:
        x_saved = self.ring.pop(j % self.R)
        names = list(self.params)
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in self.params.items()}
            xg = x_saved.detach().requires_grad_(not self.is_first)
            y = self.block_fn(leaves, xg)
            inputs = [leaves[k] for k in names] + ([xg] if not self.is_first else [])
            got = torch.autograd.grad(y, inputs, ct.to(y.dtype), allow_unused=True)
        if self.grads is None:  # the microbatches' sum, in fp32
            self.grads = {k: torch.zeros_like(v, dtype=torch.float32)
                          for k, v in self.params.items()}
        for k, g in zip(names, got):
            if g is not None:
                self.grads[k].add_(g.float())
        return None if self.is_first else got[-1]


# ---------------------------------------------------------------------- #
# the stage's place in the mesh
# ---------------------------------------------------------------------- #
class _Stage:
    """This rank's stage on ``mesh``: its index, the pp neighbours' global
    ranks, and the groups the step's sums run over."""

    def __init__(self, mesh):
        import torch.distributed as dist

        self.mesh = mesh
        self.shape = mesh_shape_of(mesh)
        self.S = self.shape[MESH_AXIS_PIPELINE]
        rank = dist.get_rank() if dist.is_initialized() else 0
        coord = mesh_coordinate(rank, self.shape)
        self.index = coord[MESH_AXIS_PIPELINE]
        self.is_first, self.is_last = self.index == 0, self.index == self.S - 1
        self.prev = None if self.is_first else rank_at(
            {**coord, MESH_AXIS_PIPELINE: self.index - 1}, self.shape)
        self.next = None if self.is_last else rank_at(
            {**coord, MESH_AXIS_PIPELINE: self.index + 1}, self.shape)
        self.first = rank_at({**coord, MESH_AXIS_PIPELINE: 0}, self.shape)
        self.last = rank_at({**coord, MESH_AXIS_PIPELINE: self.S - 1}, self.shape)
        self.pp_group = mesh.get_group(MESH_AXIS_PIPELINE) if self.S > 1 else None
        self.tokens = math.prod(self.shape[a] for a in TOKEN_AXES)

    def exchange(self, sends: list, recvs: list) -> list:
        """One tick's P2P: ``sends`` (tensor, peer) and ``recvs`` (shape,
        dtype, device, peer); returns the received tensors in order."""
        import torch.distributed as dist

        ops, outs = [], []
        for t, peer in sends:
            ops.append(dist.P2POp(dist.isend, t.contiguous(), peer))
        for shape, dtype, device, peer in recvs:
            out = torch.empty(shape, dtype=dtype, device=device)
            ops.append(dist.P2POp(dist.irecv, out, peer))
            outs.append(out)
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()
        return outs

    def broadcast_meta(self, x: Optional[torch.Tensor], device) -> tuple:
        """The microbatch's shape and dtype, from stage 0 to every stage
        (the other stages get no data)."""
        import torch.distributed as dist

        codes = [torch.float32, torch.bfloat16, torch.float16, torch.float64]
        meta = torch.zeros(10, dtype=torch.int64, device=device)
        if self.is_first:
            meta[0] = codes.index(x.dtype)
            meta[1] = x.dim()
            meta[2:2 + x.dim()] = torch.tensor(list(x.shape))
        dist.broadcast(meta, src=self.first, group=self.pp_group)
        meta = meta.tolist()
        return tuple(meta[2:2 + meta[1]]), codes[meta[0]]

    def reduce_tokens_(self, grads: dict, specs: dict) -> None:
        """Each gradient summed over the token ranks that share its shard
        and divided by their number (``runtime.ShardedLayout``'s rule)."""
        import torch.distributed as dist

        if self.tokens == 1:
            return
        for k in sorted(grads):
            used = set(sharded_axes(specs[k], self.mesh)) if specs.get(k) else set()
            group = axes_group(self.mesh, tuple(a for a in TOKEN_AXES if a not in used))
            dist.all_reduce(grads[k], group=group)
            grads[k].div_(self.tokens)

    def mean_loss(self, loss: torch.Tensor) -> torch.Tensor:
        import torch.distributed as dist

        if self.tokens == 1:
            return loss
        dist.all_reduce(loss, group=axes_group(self.mesh, TOKEN_AXES))
        return loss / self.tokens


def _specs_of(params: dict) -> dict:
    return {k: spec_of_placements(v.placements, v.ndim) if is_dtensor(v) else None
            for k, v in params.items()}


def _like_params(params: dict, local: dict) -> dict:
    """``local`` tensors as the leaves of ``params``: DTensors with the same
    placements where those are DTensors."""
    out = {}
    for k, v in params.items():
        if is_dtensor(v):
            from torch.distributed.tensor import DTensor

            out[k] = DTensor.from_local(local[k], v.device_mesh, v.placements, run_check=False,
                                        shape=v.shape, stride=v.stride())
        else:
            out[k] = local[k]
    return out


# ---------------------------------------------------------------------- #
# GPipe
# ---------------------------------------------------------------------- #
class _GPipe(torch.autograd.Function):
    """The GPipe schedule as one autograd node per stage: the forward runs
    every microbatch through this stage's layers with its graph kept and
    broadcasts the last stage's outputs; the backward runs the reverse
    schedule, the cotangents going back stage by stage."""

    @staticmethod
    def forward(ctx, stage, block_fn, M, x, names, *tensors):
        S = stage.S
        params = dict(zip(names, tensors))
        xm = x.reshape((M, x.shape[0] // M) + tuple(x.shape[1:]))
        mb_shape, dtype, dev = tuple(xm.shape[1:]), xm.dtype, xm.device
        graphs: dict[int, tuple] = {}
        outs: dict[int, torch.Tensor] = {}
        incoming = None
        table = schedule_gpipe(S, M)
        for t, row in enumerate(table):
            j = row[stage.index]
            sends = []
            if j is not None:
                x_in = xm[j] if stage.is_first else incoming
                with torch.enable_grad():
                    leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
                    xg = x_in.detach().requires_grad_(not stage.is_first or x.requires_grad)
                    y = block_fn(leaves, xg)
                graphs[j] = (leaves, xg, y)
                if stage.is_last:
                    outs[j] = y.detach()
                else:
                    sends.append((y.detach(), stage.next))
            nxt = table[t + 1][stage.index] if t + 1 < len(table) else None
            recvs = [(mb_shape, y.dtype if j is not None else dtype, dev, stage.prev)] \
                if (not stage.is_first and nxt is not None) else []
            got = stage.exchange(sends, recvs)
            incoming = got[0] if got else None
        if stage.is_last:
            out = torch.stack([outs[j] for j in range(M)])
        else:
            out = torch.empty((M,) + mb_shape, dtype=dtype, device=dev)
        import torch.distributed as dist

        dist.broadcast(out, src=stage.last, group=stage.pp_group)
        ctx.stage, ctx.M, ctx.names, ctx.graphs = stage, M, names, graphs
        ctx.x_grad = x.requires_grad
        ctx.mb_shape, ctx.dev = mb_shape, dev
        return out.reshape(x.shape[:1] + out.shape[2:])

    @staticmethod
    def backward(ctx, g):
        stage, M, names, graphs = ctx.stage, ctx.M, ctx.names, ctx.graphs
        S = stage.S
        gm = g.reshape((M, g.shape[0] // M) + tuple(g.shape[1:]))
        grads = None
        dxs: dict[int, torch.Tensor] = {}
        incoming = None
        table = gpipe_backward_order(S, M)
        for u, row in enumerate(table):
            j = row[stage.index]
            sends = []
            if j is not None:
                leaves, xg, y = graphs.pop(j)
                # the last stage's cotangent: every stage computed the same
                # loss from the same broadcast, so it is counted once
                ct = gm[j] if stage.is_last else incoming
                inputs = [leaves[k] for k in names] + ([xg] if xg.requires_grad else [])
                got = torch.autograd.grad(y, inputs, ct.to(y.dtype), allow_unused=True)
                del y, leaves
                if grads is None:
                    grads = [torch.zeros_like(v) if v is not None else None for v in got[:len(names)]]
                for i, gi in enumerate(got[:len(names)]):
                    if gi is not None:
                        grads[i] = gi if grads[i] is None else grads[i] + gi
                if xg.requires_grad:
                    dx = got[-1]
                    if stage.is_first:
                        dxs[j] = dx
                    else:
                        sends.append((dx, stage.prev))
            nxt = table[u + 1][stage.index] if u + 1 < len(table) else None
            recvs = [(ctx.mb_shape, g.dtype, ctx.dev, stage.next)] \
                if (not stage.is_last and nxt is not None) else []
            got_in = stage.exchange(sends, recvs)
            incoming = got_in[0] if got_in else None
        ctx.graphs = None
        dx = None
        if ctx.x_grad and stage.is_first:
            dx = torch.cat([dxs[j] for j in range(M)])
        return (None, None, None, dx, None, *grads)


def pipeline_apply(block_fn: Callable[[dict, torch.Tensor], torch.Tensor],
                   stacked_params: dict, x: torch.Tensor, *, mesh: Any,
                   num_micro_batches: int, batch_dim: int = 0) -> torch.Tensor:
    """Run a stacked layer sequence as a GPipe pipeline over the pp axis
    (reference :173). ``block_fn(local_layers, x_micro) -> y_micro`` applies
    a stage's layers (leaves with leading dim ``num_layers // pp``) to one
    microbatch and keeps its shape; ``stacked_params`` holds this stage's
    layers (DTensors split over pp by :func:`stacked_layer_shardings`, or
    their local tensors); ``x`` this rank's batch, on every stage. Returns
    the whole stack's output on every stage, differentiable: its backward
    is the reverse schedule, counting the last stage's cotangent once."""
    stage = _Stage(mesh)
    M = num_micro_batches
    params = _leaves(stacked_params)
    if stage.S == 1:
        return block_fn(params, x)
    xb = x.movedim(batch_dim, 0)
    if xb.shape[0] % M:
        raise ValueError(f"batch {xb.shape[0]} not divisible into {M} microbatches")
    names = list(params)
    y = _GPipe.apply(stage, block_fn, M, xb, names, *[params[k] for k in names])
    return y.movedim(0, batch_dim) if batch_dim != 0 else y


# ---------------------------------------------------------------------- #
# 1F1B
# ---------------------------------------------------------------------- #
def pipeline_train_step(block_fn: Callable[[dict, torch.Tensor], torch.Tensor],
                        loss_fn: Callable[[torch.Tensor, Any], torch.Tensor],
                        stacked_params: dict, x: Optional[torch.Tensor], targets: Any, *,
                        mesh: Any, num_micro_batches: int, batch_dim: int = 0,
                        _stats: Optional[dict] = None) -> tuple[torch.Tensor, dict]:
    """One 1F1B pipeline training step: ``(loss, grads)`` (reference
    :272). ``loss_fn(y_micro, target_micro)`` must decompose over
    microbatches: the loss is ``mean_j loss_fn(y_j, t_j)``. ``x`` is read
    on stage 0 and ``targets`` on the last stage only; the other stages may
    pass None. ``grads`` has ``stacked_params``' keys and leaf types (a
    DTensor split over pp for a DTensor leaf), each stage holding its
    layers'. tp, sp and ep run inside ``block_fn`` on their own groups.
    Where the reference's test switch ``_force_replicated_feed`` gives every
    stage the data, here the caller decides what each stage holds.
    ``_stats``: filled with the stage's ring peak (inputs and bytes)."""
    stage = _Stage(mesh)
    S, M = stage.S, num_micro_batches
    params = _leaves(stacked_params)
    specs = _specs_of(stacked_params)
    if S == 1:
        xm = _microbatch(x.movedim(batch_dim, 0) if batch_dim else x, M)
        tm = _microbatch(targets, M, batch_dim)
        with torch.enable_grad():
            leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
            losses = [loss_fn(block_fn(leaves, xm[j]), _index(tm, j)) for j in range(M)]
            loss = torch.stack([l_.float() for l_ in losses]).mean()
            got = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: (g if g is not None else torch.zeros_like(params[k]))
                 for k, g in zip(leaves, got)}
        stage.reduce_tokens_(grads, specs)
        return stage.mean_loss(loss.detach()), _like_params(stacked_params, grads)
    dev = next(iter(params.values())).device
    xm = _microbatch(x.movedim(batch_dim, 0) if batch_dim else x, M) if stage.is_first \
        else None
    tm = _microbatch(targets, M, batch_dim) if stage.is_last else None
    mb_shape, dtype = stage.broadcast_meta(xm[0] if stage.is_first else None, dev)
    body = StageBody(block_fn, loss_fn, params, stage.is_first, stage.is_last, 2 * S - 1)
    table = schedule_1f1b(S, M)
    fwd_in = bwd_in = None
    for t, row in enumerate(table):
        jf, jb = row[stage.index]
        sends, dy = [], None
        if jf is not None:
            x_in = xm[jf] if stage.is_first else fwd_in
            y, dy = body.forward(jf, x_in, _index(tm, jf) if stage.is_last else None)
            if not stage.is_last:
                sends.append((y, stage.next))
        if jb is not None:
            ct = dy if stage.is_last else bwd_in
            dx = body.backward(jb, ct)
            if dx is not None:
                sends.append((dx, stage.prev))
        recvs = []
        if t + 1 < len(table):
            nf, nb = table[t + 1][stage.index]
            if nf is not None and not stage.is_first:
                recvs.append((mb_shape, dtype, dev, stage.prev))
            if nb is not None and not stage.is_last:
                recvs.append((mb_shape, dtype, dev, stage.next))
        got = stage.exchange(sends, recvs)
        fwd_in = bwd_in = None
        if t + 1 < len(table):
            nf, nb = table[t + 1][stage.index]
            k = 0
            if nf is not None and not stage.is_first:
                fwd_in, k = got[0], 1
            if nb is not None and not stage.is_last:
                bwd_in = got[k]
    import torch.distributed as dist

    loss = body.loss_sum if stage.is_last else torch.zeros((), dtype=torch.float32, device=dev)
    loss = loss.clone()
    dist.all_reduce(loss, group=stage.pp_group)
    loss = loss / M
    grads = {k: g.div_(M) for k, g in body.grads.items()}
    stage.reduce_tokens_(grads, specs)
    if _stats is not None:
        _stats.update(peak_inputs=body.peak_inputs, ring_bytes=body.ring_bytes)
    return stage.mean_loss(loss), _like_params(stacked_params, grads)
