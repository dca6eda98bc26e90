"""Sparse MoE dispatch: the exact grouped-product path and the capacity path.

Port of ``accelerate_tpu/ops/moe.py`` for one device: ``expert_capacity``
(:38), ``no_drop_capacity_factor`` (:51), ``moe_ragged`` (:57),
``moe_dispatch_combine`` (:264) and ``load_balancing_loss`` (:347). The
expert-parallel schedule (``moe_ragged_ep``, ``ragged_ep_supported``,
``_constrain_expert_buffer``) needs an ``ep`` mesh and is refused here
(ROADMAP.md, queue A7).

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


def moe_ragged_ep(*args, **kwargs):
    """The expert-parallel ragged schedule needs an ``ep`` mesh."""
    raise NotImplementedError(
        "moe_ragged_ep (MoE experts sharded over an ep mesh axis, ep > 1) is not ported "
        "yet: ROADMAP.md, queue A7")


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
    expert_out = experts_fn(buf[:E * C].reshape(E, C, h)).reshape(E * C, h)
    expert_out = torch.cat([expert_out, expert_out.new_zeros(1, h)])
    y = expert_out[slot].reshape(T, K, h) * weights.reshape(T, K, 1).to(expert_out.dtype)
    return y.sum(dim=1)


def load_balancing_loss(logits: torch.Tensor, sel: torch.Tensor, num_experts: int) -> torch.Tensor:
    """Switch-style auxiliary loss E * sum_e density_e * router_prob_e,
    1.0 at uniform routing. ``logits``: (..., E), ``sel``: (..., K)."""
    probs = torch.softmax(logits.float(), dim=-1)
    routed = F.one_hot(sel, num_experts).float().amax(dim=-2)  # (..., E)
    axes = tuple(range(routed.dim() - 1))
    density = routed.mean(dim=axes)
    prob_mean = probs.mean(dim=axes)
    return num_experts * (density * prob_mean).sum()
