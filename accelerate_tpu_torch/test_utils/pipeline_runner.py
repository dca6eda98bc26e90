"""One-process runners of the pipeline, ring and expert-shard bodies.

Each mechanism of ``parallel/pipeline.py``, ``ops/ring_attention.py`` and
``ops/moe.py`` has a body per rank that is a function of that rank's
inputs; the collectives only carry tensors between the bodies. These
run every rank's body in one process and pass by hand what the
collective would pass, through the library's own tick table, ring order
and shard window, so that one card checks the arithmetic users run at full
width (``chip_smoke.py``'s pipelines phase). Test plumbing: not exported.
"""

from __future__ import annotations

from typing import Any, Callable, Sequence

import torch

from ..ops.moe import shard_window
from ..ops.ring_attention import _chunk_attend, combine, ring_order
from ..parallel.pipeline import StageBody, schedule_1f1b, schedule_gpipe


def run_1f1b(blocks: Sequence[Callable], params: Sequence[dict], loss_fn: Callable,
             xm: Sequence[torch.Tensor], tm: Sequence[Any]) -> tuple[torch.Tensor, list, list]:
    """Every stage's :class:`StageBody` through :func:`schedule_1f1b`, the
    activation a stage sends at tick t handed to the next stage at t + 1
    and the cotangent to the previous one. Returns the loss (the mean over
    the M microbatches), each stage's gradients (their mean) and bodies."""
    S, M = len(blocks), len(xm)
    bodies = [StageBody(blocks[i], loss_fn if i == S - 1 else None, params[i], i == 0,
                        i == S - 1, 2 * S - 1) for i in range(S)]
    fwd: dict[int, torch.Tensor] = {}
    bwd: dict[int, torch.Tensor] = {}
    for row in schedule_1f1b(S, M):
        sent_f, sent_b = {}, {}
        for i, (jf, jb) in enumerate(row):
            dy = None
            if jf is not None:
                x_in = xm[jf] if i == 0 else fwd.pop(i)
                y, dy = bodies[i].forward(jf, x_in, tm[jf] if i == S - 1 else None)
                if i < S - 1:
                    sent_f[i + 1] = y
            if jb is not None:
                ct = dy if i == S - 1 else bwd.pop(i)
                dx = bodies[i].backward(jb, ct)
                if i > 0:
                    sent_b[i - 1] = dx
        fwd.update(sent_f)
        bwd.update(sent_b)
    loss = bodies[-1].loss_sum / M
    grads = [{k: g / M for k, g in b.grads.items()} for b in bodies]
    return loss, grads, bodies


def run_gpipe(blocks: Sequence[Callable], params: Sequence[dict], loss_fn: Callable,
              xm: Sequence[torch.Tensor], tm: Sequence[Any]) -> tuple[torch.Tensor, list]:
    """GPipe with autograd: every stage's microbatches through
    :func:`schedule_gpipe` with their graphs kept (each stage's output is
    the next stage's input, as ``pipeline_apply``'s send gives it), then
    one backward of the mean of the microbatches' losses. Returns the loss
    and each stage's gradients."""
    S, M = len(blocks), len(xm)
    leaves = [{k: v.detach().requires_grad_(True) for k, v in p.items()} for p in params]
    held: dict[tuple, torch.Tensor] = {}
    for row in schedule_gpipe(S, M):
        for i, j in enumerate(row):
            if j is not None:
                x_in = xm[j] if i == 0 else held.pop((i - 1, j))
                held[(i, j)] = blocks[i](leaves[i], x_in)
    losses = [loss_fn(held[(S - 1, j)], tm[j]).float() for j in range(M)]
    loss = torch.stack(losses).mean()
    flat = [v for p in leaves for v in p.values()]
    got = torch.autograd.grad(loss, flat)
    grads, k = [], 0
    for p in leaves:
        grads.append({name: got[k + n] for n, name in enumerate(p)})
        k += len(p)
    return loss.detach(), grads


def ring_rank_bodies(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, sp: int,
                     causal: bool = True, scale: float = None) -> torch.Tensor:
    """Every sp rank's ring body on its chunk of the whole ``q``, ``k``,
    ``v`` (B, S, H, D), each step taking the kv chunk the ring order says
    it holds; the ranks' output chunks, concatenated (differentiable)."""
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    qs, ks, vs = (torch.chunk(t, sp, dim=1) for t in (q, k, v))
    outs = []
    for rank in range(sp):
        parts = [_chunk_attend(qs[rank], ks[i], vs[i], scale, mode)
                 for i, mode in ring_order(rank, sp, causal)]
        outs.append(combine([o for o, _ in parts], [lse for _, lse in parts], q.dtype))
    return torch.cat(outs, dim=1)


def expert_shards(x: torch.Tensor, sel: torch.Tensor, weights: torch.Tensor,
                  w_gate: torch.Tensor, w_up: torch.Tensor, w_down: torch.Tensor, ep: int,
                  capacity_factor: float) -> torch.Tensor:
    """Every ep shard's window (:func:`ops.moe.shard_window`) over the same
    tokens, with its experts' slices of the stacks, summed: what
    ``moe_ragged_ep`` gives when the ep group holds these tokens."""
    E = w_gate.shape[0]
    El = E // ep
    out = None
    for shard in range(ep):
        part = shard_window(x, sel, weights, *(w[shard * El:(shard + 1) * El]
                                               for w in (w_gate, w_up, w_down)),
                            shard=shard, num_shards=ep, num_experts=E,
                            capacity_factor=capacity_factor)
        out = part if out is None else out + part
    return out
