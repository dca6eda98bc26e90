"""Ring attention: sequence-parallel attention over the ``sp`` mesh axis.

Port of ``accelerate_tpu/ops/ring_attention.py`` (all of it). Each rank
holds one contiguous chunk of the sequence of q, k and v; the k/v chunks
travel around the ring of the sp group, one step at a time, so that after
step ``s`` rank ``r`` holds the chunk of sp rank ``(r - s) mod n``. Each
(q chunk, kv chunk) pair is attended on its own (:func:`_chunk_attend`,
normalised within the chunk, with its logsumexp) and the pairs combine
exactly by their lse weights, ``out = sum_s out_s * exp(lse_s - lse)``
with ``lse = logsumexp_s lse_s``: the flash combination across ring steps.
Under ``causal`` a kv chunk ahead of the q chunk is skipped, the diagonal
pair is masked triangularly, and chunks behind attend fully.

The reference computes the chunk attention with XLA einsums, not Pallas,
so the port's is plain PyTorch (``torch.einsum`` in fp32); a Hopper
kernel for it would be new work (ROADMAP.md, queue B). The reference
computes a skipped pair under a mask of all False; the port skips it,
which gives the same zero weight.

The backward is autograd: the ring shift (:class:`_RingShift`, a P2P
exchange with the two ring neighbours) has the reverse shift as its
backward, so ``dk``/``dv`` travel back to the rank that owns the chunk.
Every rank's graph holds every shift (a pair it skips still anchors the
chunk it received, :class:`_Anchor`), so every rank runs the same
exchanges in the same order in the backward.

Fallbacks, the reference's: at sp 1 the plain ``xla_attention`` runs
(reference :149-152); when the model's sequence does not tile the sp axis
the sequence stays whole on every rank and dense attention runs, with
the reference's warning at S >= 2048 (:160-190). Nothing else falls back:
a failed exchange raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..utils.constants import MESH_AXIS_SEQUENCE

NEG_INF = -1e30


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    if n_rep == 1:
        return x
    b, s, h, d = x.shape
    return x[:, :, :, None, :].expand(b, s, h, n_rep, d).reshape(b, s, h * n_rep, d)


def _chunk_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
                  mode: int) -> tuple[torch.Tensor, torch.Tensor]:
    """One (q chunk, kv chunk) pair: ``(out, lse)``, ``out`` (B, Sq, H, D)
    fp32 normalised within the chunk and ``lse`` (B, H, Sq) fp32 (reference
    :46). ``mode`` 0 attends fully, 1 is the causal diagonal (triangular
    mask), 2 skips the pair (zero output, lse ``NEG_INF``)."""
    b, sq, h, d = q.shape
    if mode == 2:
        return (torch.zeros((b, sq, h, d), dtype=torch.float32, device=q.device),
                torch.full((b, h, sq), NEG_INF, dtype=torch.float32, device=q.device))
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    sk = logits.shape[-1]
    if mode == 1:
        rows = torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        mask = cols <= rows + (sk - sq)
        logits = logits.masked_fill(~mask[None, None], NEG_INF)
    m = logits.amax(dim=-1)  # (B, H, Sq)
    m_safe = torch.where(m <= NEG_INF / 2, torch.zeros_like(m), m)
    p = torch.exp(logits - m_safe[..., None])
    if mode == 1:
        p = p.masked_fill(~mask[None, None], 0.0)
    l = p.sum(dim=-1)  # (B, H, Sq)
    # the products take v's dtype's inputs and accumulate in fp32, as the
    # reference's einsum with preferred_element_type=float32
    out = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), v.float())
    l_safe = l.clamp_min(1e-37)
    out = out / l_safe.transpose(1, 2)[..., None]
    lse = torch.where(l > 0.0, m_safe + torch.log(l_safe), torch.full_like(l, NEG_INF))
    return out, lse


def _exchange(tensors, send_to: int, recv_from: int) -> tuple:
    """Each tensor sent to global rank ``send_to`` and its counterpart
    received from ``recv_from``, in one batch of P2P operations."""
    import torch.distributed as dist

    outs, ops = [], []
    for t in tensors:
        t = t.contiguous()
        out = torch.empty_like(t)
        ops.append(dist.P2POp(dist.isend, t, send_to))
        ops.append(dist.P2POp(dist.irecv, out, recv_from))
        outs.append(out)
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return tuple(outs)


class _RingShift(torch.autograd.Function):
    """k and v one step along the ring (to the next sp rank, from the
    previous one); the backward sends the gradients the other way."""

    @staticmethod
    def forward(ctx, k, v, nxt, prv):
        ctx.nxt, ctx.prv = nxt, prv
        return _exchange((k, v), nxt, prv)

    @staticmethod
    def backward(ctx, gk, gv):
        gk, gv = _exchange((gk, gv), ctx.prv, ctx.nxt)
        return gk, gv, None, None


class _Anchor(torch.autograd.Function):
    """``out`` as it is, with ``tensors`` in its graph: their gradient is
    zero, so that the shift that delivered a chunk this rank skips still
    runs its backward exchange."""

    @staticmethod
    def forward(ctx, out, *tensors):
        ctx.like = [(t.shape, t.dtype, t.device) for t in tensors]
        return out.view_as(out)

    @staticmethod
    def backward(ctx, g):
        return (g, *(torch.zeros(s, dtype=dt, device=dev) for s, dt, dev in ctx.like))


def ring_order(rank: int, n: int, causal: bool) -> list[tuple[int, int]]:
    """The ring order (reference :99-110): ``(kv_index, mode)`` at each of
    the ``n`` steps of sp rank ``rank``, which holds kv chunk ``(rank - s)
    mod n`` after ``s`` shifts; ``mode`` as :func:`_chunk_attend` takes it
    (the chunks ahead of the q chunk skipped under ``causal``)."""
    out = []
    for s in range(n):
        kv_index = (rank - s) % n
        mode = 0 if not causal else (0 if kv_index < rank else 1 if kv_index == rank else 2)
        out.append((kv_index, mode))
    return out


def combine(outs: list, lses: list, dtype) -> torch.Tensor:
    """The ring steps' chunk results merged exactly by their lse weights:
    ``sum_s out_s * exp(lse_s - logsumexp_s lse_s)`` (reference :129-135)."""
    lses = torch.stack(lses)  # (n, B, H, Sq)
    lse = torch.logsumexp(lses, dim=0)
    weights = torch.exp(lses - lse[None])  # (n, B, H, Sq)
    return torch.einsum("nbqhd,nbhq->bqhd", torch.stack(outs), weights).to(dtype)


def _ring_local(q, k, v, *, ranks: tuple, rank: int, scale: float, causal: bool):
    """The per-rank body (reference :92): local q stays, k/v go round."""
    n = len(ranks)
    nxt, prv = ranks[(rank + 1) % n], ranks[(rank - 1) % n]
    outs, lses, unused = [], [], []
    kc, vc = k, v
    for s, (_, mode) in enumerate(ring_order(rank, n, causal)):
        out_s, lse_s = _chunk_attend(q, kc, vc, scale, mode)
        if mode == 2:
            unused += [kc, vc]
        outs.append(out_s)
        lses.append(lse_s)
        if s + 1 < n:
            kc, vc = _RingShift.apply(kc, vc, nxt, prv)
    out = combine(outs, lses, torch.float32)
    if unused:
        out = _Anchor.apply(out, *unused)
    return out.to(q.dtype)


def _sp_group(mesh, axis_name: str):
    """The sp group of ``mesh`` as the forward reads it (size, this rank's
    index, the group's global ranks); the running sharded step's when no
    mesh is given."""
    from ..parallel import runtime

    if mesh is None:
        sp = runtime.sp_state()
        if sp is not None:
            return sp
        from ..state import AcceleratorState

        mesh = getattr(AcceleratorState(), "mesh", None) if AcceleratorState._shared_state \
            else None
        if mesh is None:
            return None
    import torch.distributed as dist

    from ..parallel.mesh import axis_peers, mesh_coordinate, mesh_shape_of

    shape = mesh_shape_of(mesh)
    rank = dist.get_rank()
    return runtime.AxisGroup(mesh.get_group(axis_name), shape[axis_name],
                             mesh_coordinate(rank, shape)[axis_name],
                             tuple(axis_peers(rank, shape, (axis_name,))))


def dense_fallback(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None, causal: bool = True,
                   sp_size: int = 1) -> torch.Tensor:
    """Dense attention over a whole sequence that does not tile the sp
    axis, with the reference's warning at S >= 2048 (:160-190)."""
    from .attention import xla_attention

    if q.shape[1] >= 2048:
        from ..logging import get_logger

        get_logger(__name__).warning(
            f"ring_attention: shapes q{tuple(q.shape)}/kv{tuple(k.shape)} do not tile mesh "
            f"axes (seq%{sp_size}) — falling back to DENSE attention; fix batch/seq/head "
            "divisibility to keep the ring")
    return xla_attention(q, k, v, scale=scale, causal=causal)


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   scale: Optional[float] = None, causal: bool = True, mesh=None,
                   axis_name: str = MESH_AXIS_SEQUENCE) -> torch.Tensor:
    """Sequence-parallel attention: ``q`` (B, S/n, H, D) and ``k``/``v``
    (B, S/n, Hkv, D) are this rank's contiguous chunks of the sequence (sp
    rank ``i`` holding positions ``[i*S/n, (i+1)*S/n)``), and the result is
    this rank's chunk of the output. Every rank of the sp group calls it.
    The sp group is ``mesh``'s, else the running sharded step's, else the
    AcceleratorState's mesh's; at sp 1 (or with no mesh) it is the plain
    ``xla_attention`` of the whole sequence."""
    from .attention import xla_attention

    scale = scale if scale is not None else q.shape[-1] ** -0.5
    group = _sp_group(mesh, axis_name)
    if group is None or group.size == 1:
        return xla_attention(q, k, v, scale=scale, causal=causal)
    return _ring_local(q, k, v, ranks=group.ranks, rank=group.rank, scale=scale, causal=causal)
