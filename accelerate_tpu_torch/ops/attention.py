"""Attention entry point and its plain path.

Port of ``accelerate_tpu/ops/attention.py:208-399``: the causal and
length masks, the plain (``xla``) attention that works for every mask,
and ``dot_product_attention``, which picks the flash kernels by the
reference's own predicate. Shapes are (batch, seq, heads, head_dim), kv
(batch, seq_kv, kv_heads, head_dim). The paged decode path waits for the
serving slice (ROADMAP.md, queue A9).
"""

from __future__ import annotations

from typing import Optional

import torch


def make_causal_mask(
    q_len: int, kv_len: int, window: Optional[int] = None, device=None
) -> torch.Tensor:
    """Lower-triangular (q_len, kv_len) bool mask aligned at the end
    (decode: q_len < kv_len). ``window``: query row r additionally sees
    only cols > r + offset - window, self included (HF semantics)."""
    offset = kv_len - q_len
    rows = torch.arange(q_len, device=device)[:, None]
    cols = torch.arange(kv_len, device=device)[None, :]
    keep = cols <= rows + offset
    if window is not None:
        keep = keep & (cols > rows + offset - window)
    return keep


def _repeat_kv(x: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, n_kv, D) -> (B, S, n_kv*n_rep, D) for grouped-query attention."""
    if n_rep == 1:
        return x
    return x.repeat_interleave(n_rep, dim=2)


def lengths_to_mask(kv_lengths: torch.Tensor, kv_len: int) -> torch.Tensor:
    """(B,) valid-prefix lengths -> (B, 1, 1, kv_len) bool key mask."""
    cols = torch.arange(kv_len, device=kv_lengths.device)[None, :]
    return (cols < kv_lengths[:, None])[:, None, None, :]


def xla_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = False,
    kv_lengths: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """The plain path (named after the reference's): fp32 scores and
    softmax whatever the input dtype, masked entries set to the fp32
    minimum, probabilities cast back to the input dtype before p.v. A fully
    masked row averages v, as the reference's does."""
    if window is not None and not causal:
        raise ValueError("sliding window requires causal attention")
    orig_dtype = q.dtype
    n_rep = q.shape[2] // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if bias is not None:
        logits = logits + bias.float()
    fmin = torch.finfo(torch.float32).min
    if causal:
        cmask = make_causal_mask(q.shape[1], k.shape[1], window, device=q.device)
        logits = logits.masked_fill(~cmask[None, None], fmin)
    if kv_lengths is not None:
        lmask = lengths_to_mask(kv_lengths, k.shape[1])
        mask = lmask if mask is None else mask & lmask
    if mask is not None:
        logits = logits.masked_fill(~mask, fmin)
    probs = torch.softmax(logits, dim=-1).to(orig_dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v)


def flash_self_attention_eligible(seq_len: int, device: torch.device) -> bool:
    """Would auto-dispatch pick the flash kernels for self-attention at this
    sequence length: the reference's shape predicate (S >= 256, S a
    multiple of 128), with a CUDA device in place of the TPU backend."""
    return torch.device(device).type == "cuda" and seq_len >= 256 and seq_len % 128 == 0


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    causal: bool = False,
    kv_lengths: Optional[torch.Tensor] = None,
    implementation: Optional[str] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Attention entry point, shapes (batch, seq, heads, head_dim).

    ``implementation``: None (auto) | "xla" | "flash" | "ring". Auto picks
    flash for causal or bidirectional self-attention on a CUDA device with
    no dense mask or bias, else the plain path — decided before any
    launch. Score soft-capping and per-layer windows (Gemma-2) are not
    ported yet (ROADMAP.md, queue A8).
    """
    if implementation is None:
        flash_ok = (
            bias is None and mask is None
            and q.shape[1] == k.shape[1]
            and flash_self_attention_eligible(q.shape[1], q.device)
        )
        implementation = "flash" if flash_ok else "xla"
    if implementation == "xla":
        return xla_attention(
            q, k, v, mask=mask, bias=bias, scale=scale, causal=causal,
            kv_lengths=kv_lengths, window=window,
        )
    if implementation == "flash":
        from .flash_attention import flash_attention

        if mask is not None or bias is not None:
            raise ValueError(
                "flash attention supports no dense mask/bias tensor — pass "
                "right-padding via kv_lengths, or implementation='xla' for "
                "arbitrary masks"
            )
        return flash_attention(
            q, k, v, scale=scale, causal=causal, kv_lengths=kv_lengths, window=window
        )
    if implementation == "ring":
        raise NotImplementedError(
            "ring attention is not ported yet (ROADMAP.md, queue A7)"
        )
    raise ValueError(f"unknown attention implementation {implementation!r}")
