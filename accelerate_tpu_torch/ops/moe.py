"""Sparse MoE dispatch: the exact grouped-product path and the capacity path.

Port of ``accelerate_tpu/ops/moe.py`` (all of it): ``expert_capacity``
(:38), ``no_drop_capacity_factor`` (:51), ``moe_ragged`` (:57),
``ragged_ep_supported`` (:115), the expert-parallel shard-capacity schedule
``moe_ragged_ep`` (:128-261), ``moe_dispatch_combine`` (:264),
``_constrain_expert_buffer`` (:312) and ``load_balancing_loss`` (:347).

``moe_ragged_ep`` runs the reference's per-shard body (:188-234) on each
rank of the ep group: the tokens (and their choices and weights) are
all-gathered over the ranks that hold other tokens, sorted by expert the
same way on every rank, and each rank runs its experts over a static
window of ``C_s = max(8*ceil(T*K*cf/ep/8), 8)`` sorted rows starting at its
experts' region, rows past the region going to a zero dummy group; the
contributions are summed over ep and each rank keeps its own tokens' rows
(the reference's psum followed by the rank's slice). Its backward is
autograd: the gather's is a reduce-scatter, the sum's a sum.
:func:`shard_window` is that body alone, a function of one shard's inputs.

The reference computes the grouped product with ``jax.lax.ragged_dot``
(XLA, no Pallas), so the port's grouped product is PyTorch's own grouped
GEMM, ``torch.nn.functional.grouped_mm``, on a CUDA tensor, and its plain
version, a loop over the experts slicing by group offsets, on a CPU tensor.
There is no fallback: on a CUDA tensor the grouped GEMM runs or raises.

Dispatch and combine are gathers in a fixed order, not scatter-adds, so a
step repeats bit for bit on the card (an ``index_add_`` on CUDA adds with
atomics in no fixed order). Each token has exactly K routed rows; the
combine sums them in the order of their rows in the expert-sorted array,
which is the order the reference's scatter-add visits them, and the
gradient of the dispatch gather is that same sum.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.nn.functional as F


def expert_capacity(num_tokens: int, num_experts: int, num_selected: int,
                    capacity_factor: float) -> int:
    """Per-expert buffer length C: perfectly balanced load times
    ``capacity_factor`` headroom, a multiple of 8 and >= 8."""
    ideal = num_tokens * num_selected / num_experts
    cap = int(math.ceil(ideal * capacity_factor))
    return max(8 * int(math.ceil(cap / 8)), 8)


def no_drop_capacity_factor(num_experts: int, num_selected: int) -> float:
    """The factor at which dropping is impossible (every token could route
    to the same expert): C >= T*K/E * f with f = E/K gives C >= T."""
    return num_experts / num_selected


def grouped_mm_reference(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """The plain grouped product: rows ``offs[e-1]:offs[e]`` of ``x`` (N, k)
    times ``w[e]`` (k, n), for every expert e. Reads the offsets on the
    host."""
    bounds = [0] + [int(o) for o in offs]
    return torch.cat([x[a:b] @ w[e] for e, (a, b) in enumerate(zip(bounds, bounds[1:]))])


def grouped_mm(x: torch.Tensor, w: torch.Tensor, offs: torch.Tensor) -> torch.Tensor:
    """(N, k) rows grouped by ``offs`` (cumulative int32 ends, one per
    expert) times the (E, k, n) stack: PyTorch's grouped GEMM on a CUDA
    tensor, the per-expert loop on a CPU tensor."""
    if not x.is_cuda:
        return grouped_mm_reference(x, w, offs)
    op = getattr(F, "grouped_mm", None) or getattr(torch, "_grouped_mm", None)
    if op is None:
        raise RuntimeError(f"torch {torch.__version__} has no grouped GEMM "
                           "(torch.nn.functional.grouped_mm): the ragged MoE needs it on CUDA")
    return op(x, w, offs=offs)


def _token_rows(sel: torch.Tensor, num_experts: int):
    """The expert-sorted layout of the (T, K) choices: ``tok`` (T*K,) the
    source token of each sorted row, ``pos`` (T, K) each token's rows in
    ascending order (the reference's scatter-add order), ``order`` the
    stable sort of the flattened choices, and ``offs`` (E,) int32 the
    cumulative group ends."""
    T, K = sel.shape
    flat = sel.reshape(T * K)
    order = torch.argsort(flat, stable=True)  # ties keep token order, as jnp.argsort
    tok = torch.div(order, K, rounding_mode="floor")
    inv = torch.empty_like(order)
    inv[order] = torch.arange(T * K, device=sel.device)
    pos = inv.reshape(T, K).sort(dim=1).values
    offs = torch.cumsum(torch.bincount(flat, minlength=num_experts), 0).to(torch.int32)
    return tok, pos, order, offs


def _sum_rows(rows: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """out[t] = 0 + rows[pos[t, 0]] + rows[pos[t, 1]] + ..., in that order."""
    out = rows[pos[:, 0]]
    for k in range(1, pos.shape[1]):
        out = out + rows[pos[:, k]]
    return out


class _Dispatch(torch.autograd.Function):
    """x (T, h) -> x[tok] (T*K, h); the gradient sums each token's rows
    in a fixed order, with no atomics."""

    @staticmethod
    def forward(ctx, x, tok, pos):
        ctx.save_for_backward(pos)
        return x[tok]

    @staticmethod
    def backward(ctx, g):
        (pos,) = ctx.saved_tensors
        return _sum_rows(g, pos), None, None


class _Combine(torch.autograd.Function):
    """rows (T*K, h) -> (T, h), each token's K rows summed in the order of
    ``pos``; the gradient is a gather, g[tok]."""

    @staticmethod
    def forward(ctx, rows, tok, pos):
        ctx.save_for_backward(tok)
        return _sum_rows(rows, pos)

    @staticmethod
    def backward(ctx, g):
        (tok,) = ctx.saved_tensors
        return g[tok], None, None


def moe_ragged(x: torch.Tensor, sel: torch.Tensor, weights: torch.Tensor,
               w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor) -> torch.Tensor:
    """Exact sparse MoE by grouped products: the T*K (token, choice) rows
    sorted by expert, each expert's group through its SwiGLU, no capacity
    padding and no drops.

    ``x``: (T, h); ``sel``/``weights``: (T, K); ``w_gate``/``w_up``:
    (E, h, f); ``w_down``: (E, f, h). Returns (T, h) in the products' dtype.
    """
    T, K = sel.shape
    tok, pos, order, offs = _token_rows(sel, w_gate.shape[0])
    xs = _Dispatch.apply(x, tok, pos)  # (TK, h), rows grouped by expert
    hidden = F.silu(grouped_mm(xs, w_gate, offs)) * grouped_mm(xs, w_up, offs)
    out = grouped_mm(hidden, w_down, offs)  # (TK, h)
    w_flat = weights.reshape(T * K)[order].to(out.dtype)
    return _Combine.apply(out * w_flat[:, None], tok, pos)


def ragged_ep_supported() -> bool:
    """Whether :func:`moe_ragged_ep` can run: the reference asks its jax for
    partial-manual ``shard_map``; the port's schedule needs
    ``torch.distributed`` only (reference :115)."""
    import torch.distributed as dist

    return dist.is_available()


def shard_capacity(num_tokens: int, num_selected: int, ep: int, capacity_factor: float) -> int:
    """The window ``C_s`` of sorted rows each ep shard runs (reference
    :183): ``max(8 * ceil(T*K*cf/ep/8), 8)``."""
    return max(8 * math.ceil(num_tokens * num_selected * capacity_factor / ep / 8), 8)


def shard_window(x: torch.Tensor, sel: torch.Tensor, weights: torch.Tensor,
                 w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor, *,
                 shard: int, num_shards: int, num_experts: int,
                 capacity_factor: float) -> torch.Tensor:
    """One ep shard's contribution (reference :188-234): ``x`` (T, h),
    ``sel``/``weights`` (T, K) are every token of the group, ``w_*`` this
    shard's ``num_experts / num_shards`` experts. The (T*K) choices sorted by
    expert (stable), the shard's window of ``C_s`` rows from its region's
    start through its experts (a grouped product, no per-expert padding),
    rows past the region through a zero dummy group; returns (T, h), each
    token's weighted sum of its window rows. The sum over the shards is
    the MoE's output, with the rows no window reached dropped."""
    T, K = sel.shape
    TK = T * K
    E, El = num_experts, w_gate.shape[0]
    C_s = shard_capacity(T, K, num_shards, capacity_factor)
    dev = x.device
    flat = sel.reshape(TK)
    order = torch.argsort(flat, stable=True)  # ties keep token order, as jnp.argsort
    tok = torch.div(order, K, rounding_mode="floor")
    w_flat = weights.reshape(TK)[order]
    counts = torch.bincount(flat, minlength=E)
    offsets = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])  # (E+1,)
    first = shard * El
    off_s = offsets[first]
    # the window, padded so that it never reads past the end: a padded row
    # points at token 0 with weight 0 and lands in the dummy group
    win = off_s + torch.arange(C_s, device=dev)
    tok_win = torch.cat([tok, tok.new_zeros(C_s)])[win]
    w_win = torch.cat([w_flat, w_flat.new_zeros(C_s)])[win]
    xs = x[tok_win]  # (C_s, h)
    lo, hi = off_s, off_s + C_s
    starts = offsets[first:first + El].clamp(lo, hi)
    ends = offsets[first + 1:first + El + 1].clamp(lo, hi)
    gs = ends - starts
    # cumulative group ends, the dummy group's last: exactly C_s
    offs = torch.cat([torch.cumsum(gs, 0), torch.full((1,), C_s, device=dev,
                                                       dtype=gs.dtype)]).to(torch.int32)

    def with_dummy(w):
        return torch.cat([w, w.new_zeros((1,) + tuple(w.shape[1:]))])

    hidden = F.silu(grouped_mm(xs, with_dummy(w_gate), offs)) * grouped_mm(
        xs, with_dummy(w_up), offs)
    out = grouped_mm(hidden, with_dummy(w_down), offs)  # (C_s, h); dummy rows are zeros
    contrib = out.new_zeros((T, out.shape[-1]))
    return contrib.index_add(0, tok_win, out * w_win[:, None].to(out.dtype))


def shard_coverage(sel: torch.Tensor, num_experts: int, num_shards: int,
                   capacity_factor: float) -> list[int]:
    """How many of the (T*K) choices each ep shard's window reaches in its
    experts' region (:func:`shard_window`'s rows that are not the dummy
    group's); ``T*K`` minus their sum is the number dropped. Reads the
    counts on the host."""
    T, K = sel.shape
    C_s = shard_capacity(T, K, num_shards, capacity_factor)
    counts = torch.bincount(sel.reshape(-1), minlength=num_experts).tolist()
    El = num_experts // num_shards
    return [min(sum(counts[s * El:(s + 1) * El]), C_s) for s in range(num_shards)]


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0 over a group (group order); the backward sums
    every rank's gradient of this rank's rows (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, group, n):
        from ..parallel.runtime import all_gather_dim

        ctx.group, ctx.n = group, n
        return all_gather_dim(x, 0, group, n)

    @staticmethod
    def backward(ctx, g):
        from ..parallel.runtime import reduce_scatter_dim

        return reduce_scatter_dim(g, 0, ctx.group, ctx.n), None, None


class _SumOver(torch.autograd.Function):
    """The sum over a group, in its forward and its backward: every rank's
    output reads every rank's input."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        out = x.contiguous().clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _gather_plain(x: torch.Tensor, group, n: int) -> torch.Tensor:
    from ..parallel.runtime import all_gather_dim

    return all_gather_dim(x, 0, group, n)


def _axis_group(mesh, axis_name: str):
    from ..parallel import runtime

    if mesh is None:
        ep = runtime.ep_state()
        if ep is not None:
            return ep
        from ..state import AcceleratorState

        mesh = getattr(AcceleratorState(), "mesh", None) if AcceleratorState._shared_state \
            else None
        if mesh is None:
            return runtime.AxisGroup(None, 1, 0, ())
    import torch.distributed as dist

    from ..parallel.mesh import axis_peers, mesh_coordinate, mesh_shape_of

    shape = mesh_shape_of(mesh)
    rank = dist.get_rank()
    return runtime.AxisGroup(mesh.get_group(axis_name), shape[axis_name],
                             mesh_coordinate(rank, shape)[axis_name],
                             tuple(axis_peers(rank, shape, (axis_name,))))


def _token_order(n_groups: int, rows: int, sp: int, length: int, device) -> torch.Tensor:
    """The gathered tokens' positions in the global batch's order when each
    rank holds ``rows`` rows of a ``length`` chunk of a sequence split over
    ``sp`` ranks (sp the minor axis of the gather): rank-major (row group,
    sp, row, position) to (row group, row, sp, position)."""
    idx = torch.arange(n_groups * sp * rows * length, device=device)
    return idx.view(n_groups, sp, rows, length).transpose(1, 2).reshape(-1)


def moe_ragged_ep(x: torch.Tensor, sel: torch.Tensor, weights: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor, *,
                  mesh=None, capacity_factor: float = 1.25, axis_name: str = "ep",
                  experts_sharded: bool = False, tokens=None,
                  seq_split: Optional[tuple[int, int, int]] = None) -> torch.Tensor:
    """Expert-parallel grouped-product MoE, the shard-capacity schedule
    (reference :128; the module docstring). ``x`` (T, h), ``sel``/
    ``weights`` (T, K) are this rank's tokens; ``w_gate``/``w_up`` (E, h, f)
    and ``w_down`` (E, f, h) the whole stacks, of which each ep rank runs its
    ``E/ep`` experts, or with ``experts_sharded`` this rank's shard of them
    (a stack split over ep by the sharding rules). The ep group is
    ``mesh``'s, else the running sharded step's. ``tokens``: the group of
    the ranks whose tokens the windows span (``parallel.runtime.AxisGroup``;
    the ep group when None), every rank of it calling; ``seq_split``:
    ``(rows, sp, length)`` when those ranks hold sequence chunks (sp the
    group's minor axis), so that the gathered tokens take the global
    batch's order. ``capacity_factor >= ep`` drops nothing and equals the
    dense oracle. Returns (T, h)."""
    ep = _axis_group(mesh, axis_name)
    tokens = ep if tokens is None else tokens
    T, h = x.shape
    if experts_sharded:
        E = w_gate.shape[0] * ep.size
        wg, wu, wd = w_gate, w_up, w_down
    else:
        E = w_gate.shape[0]
        if E % ep.size:
            raise ValueError(f"ep_size {ep.size} does not divide the {E} experts")
        El = E // ep.size
        wg, wu, wd = (w.narrow(0, ep.rank * El, El) for w in (w_gate, w_up, w_down))
    n = tokens.size
    if n > 1:
        xs = _GatherRows.apply(x, tokens.group, n)
        sels = _gather_plain(sel, tokens.group, n)
        ws = _GatherRows.apply(weights, tokens.group, n)
    else:
        xs, sels, ws = x, sel, weights
    order = None
    if seq_split is not None and seq_split[1] > 1:
        rows, sp, length = seq_split
        order = _token_order(n // sp, rows, sp, length, x.device)
        xs, sels, ws = xs[order], sels[order], ws[order]
    contrib = shard_window(xs, sels, ws, wg, wu, wd, shard=ep.rank, num_shards=ep.size,
                           num_experts=E, capacity_factor=capacity_factor)
    if ep.size > 1:
        contrib = _SumOver.apply(contrib, ep.group)
    if order is not None:  # back to the gathered (rank-major) order
        inv = torch.empty_like(order)
        inv[order] = torch.arange(order.numel(), device=order.device)
        contrib = contrib[inv]
    return contrib.narrow(0, tokens.rank * T, T) if n > 1 else contrib


def gather_experts(w: torch.Tensor, mesh=None, axis_name: str = "ep") -> torch.Tensor:
    """A stack split over ep made whole on every ep rank, differentiably
    (the backward keeps each rank's shard of the summed gradient): the
    capacity and dense dispatches under ep run every expert."""
    ep = _axis_group(mesh, axis_name)
    if ep.size == 1:
        return w
    return _GatherRows.apply(w, ep.group, ep.size)


def capacity_slots(sel: torch.Tensor, num_experts: int, capacity: int):
    """Each (token, choice)'s slot in the flattened (E*C) buffer, token-major
    (earlier tokens win slots), and whether it was kept; a dropped claim
    points at slot E*C, the buffer's spare row."""
    flat = sel.reshape(-1)
    onehot = F.one_hot(flat, num_experts).to(torch.int32)  # (TK, E)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    keep = pos < capacity
    slot = torch.where(keep, flat * capacity + pos, torch.full_like(flat, num_experts * capacity))
    return slot, keep


def moe_dispatch_combine(x: torch.Tensor, sel: torch.Tensor, weights: torch.Tensor,
                         experts_fn: Callable[[torch.Tensor], torch.Tensor], num_experts: int,
                         capacity_factor: float = 2.0,
                         capacity: Optional[int] = None) -> torch.Tensor:
    """Route tokens through their selected experts under a capacity limit.

    ``x``: (T, h); ``sel``/``weights``: (T, K); ``experts_fn``: (E, C, h)
    -> (E, C, h). Claims past an expert's capacity are dropped: their
    writes land in the buffer's spare row E*C and they read zeros back
    (the reference's ``mode="drop"``/``mode="fill"``), so every shape is
    static and no index is out of range. Returns (T, h).
    """
    T, h = x.shape
    K = sel.shape[-1]
    E = num_experts
    C = capacity or expert_capacity(T, E, K, capacity_factor)
    slot, _ = capacity_slots(sel, E, C)
    rows = x[:, None, :].expand(T, K, h).reshape(T * K, h)
    buf = x.new_zeros(E * C + 1, h).index_put((slot,), rows)
    buf = _constrain_expert_buffer(buf[:E * C].reshape(E, C, h))
    expert_out = _constrain_expert_buffer(experts_fn(buf)).reshape(E * C, h)
    expert_out = torch.cat([expert_out, expert_out.new_zeros(1, h)])
    y = expert_out[slot].reshape(T, K, h) * weights.reshape(T, K, 1).to(expert_out.dtype)
    return y.sum(dim=1)


def _constrain_expert_buffer(buf: torch.Tensor) -> torch.Tensor:
    """The (E, C, h) buffer as it is. The reference pins its GSPMD layout
    (experts over ep, capacity over the data axes) so that dispatch lowers
    to one all-to-all (:312); the port's eager step has no layout to pin,
    and under ep its capacity dispatch runs with the stacks gathered."""
    return buf


def load_balancing_loss(logits: torch.Tensor, sel: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss E * sum_e density_e * router_prob_e,
    1.0 at uniform routing. ``logits``: (..., E), ``sel``: (..., K)."""
    probs = torch.softmax(logits.float(), dim=-1)
    routed = F.one_hot(sel, num_experts).float().amax(dim=-2)  # (..., E)
    axes = tuple(range(routed.dim() - 1))
    density = routed.mean(dim=axes)
    prob_mean = probs.mean(dim=axes)
    return num_experts * (density * prob_mean).sum()
