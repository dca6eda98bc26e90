"""Attention entry point, its plain path and the paged KV cache.

Port of ``accelerate_tpu/ops/attention.py``: the causal and length masks,
the plain (``xla``) attention that works for every mask, and
``dot_product_attention``, which picks the flash kernels by the
reference's own predicate (:208-399); the paged decode path,
``PagedKVState`` (:28), ``paged_update`` (:95) and ``paged_attention``
(:155), with ``PagedKVCache`` holding the pools the reference keeps as
flax cache variables, and the int8 paged KV: ``KV_SCALE_EPS`` (:70),
``quantize_kv`` (:75-92), the int8 branches of ``paged_update``
(:135-150) and ``paged_attention`` (:189-200), and the fp32 per-token
scale arrays beside the int8 pools. Shapes are (batch, seq, heads,
head_dim), kv (batch, seq_kv, kv_heads, head_dim). The paged path is
gathers and scatters in the reference (XLA, no Pallas) and plain PyTorch
here, with static shapes and no host sync so that a decode step can be
captured as one CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class PagedKVState:
    """Per-call view of the paged KV cache (block tables).

    ``block_table`` (B, max_blocks) int: pool indices per slot, in sequence
    order; table entry t holds global positions [t*block_size,
    (t+1)*block_size). Unused entries point at block 0, the reserved
    garbage block the allocator never hands out. ``cache_len`` (B,) int:
    tokens already written for the slot; this call's token i lands at
    global position cache_len + i. ``lengths`` (B,) int: valid tokens in
    this call (prefill: the prompt inside its padded bucket; decode: 1 for
    a seated slot, 0 for an empty one); writes beyond it go to block 0.
    """

    block_table: torch.Tensor
    cache_len: torch.Tensor
    lengths: torch.Tensor
    num_blocks: int
    block_size: int
    kv_dtype: str = "native"

    def __post_init__(self):
        if self.kv_dtype not in ("native", "int8"):
            raise ValueError(f"unknown kv_dtype {self.kv_dtype!r}")


@dataclass
class PagedKVCache:
    """The block pools of every layer, one stacked tensor each:
    (num_layers, num_blocks, block_size, kv_heads, head_dim), no batch
    dim, so sequences of any length share them. Written in place. With
    ``kv_dtype="int8"`` the pools hold int8 codes and ``key_scale`` /
    ``value_scale`` (num_layers, num_blocks, block_size) fp32 hold each
    token row's scale; otherwise the scales are None."""

    key: torch.Tensor
    value: torch.Tensor
    key_scale: Optional[torch.Tensor] = None
    value_scale: Optional[torch.Tensor] = None

    @classmethod
    def zeros(cls, num_layers: int, num_blocks: int, block_size: int, kv_heads: int,
              head_dim: int, dtype: torch.dtype, device,
              kv_dtype: str = "native") -> "PagedKVCache":
        shape = (num_layers, num_blocks, block_size, kv_heads, head_dim)
        if kv_dtype == "native":
            return cls(torch.zeros(shape, dtype=dtype, device=device),
                       torch.zeros(shape, dtype=dtype, device=device))
        if kv_dtype != "int8":
            raise ValueError(f"unknown kv_dtype {kv_dtype!r}")
        return cls(*(torch.zeros(shape, dtype=torch.int8, device=device) for _ in range(2)),
                   *(torch.zeros(shape[:3], dtype=torch.float32, device=device)
                     for _ in range(2)))

    @property
    def kv_dtype(self) -> str:
        return "int8" if self.key_scale is not None else "native"

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor whose axes 1 and 2 are (num_blocks, block_size): the
        pools, and the scale arrays when int8. Copy-on-write and the swap
        address blocks through these."""
        out = [self.key, self.value]
        if self.key_scale is not None:
            out += [self.key_scale, self.value_scale]
        return out

    def layer(self, i: int) -> tuple:
        """Layer ``i``'s (key, value, key_scale, value_scale), the scales
        None when native."""
        if self.key_scale is None:
            return self.key[i], self.value[i], None, None
        return self.key[i], self.value[i], self.key_scale[i], self.value_scale[i]

    @property
    def nbytes(self) -> int:
        return sum(t.nbytes for t in self.tensors())


# floor on the per-token amax scale: all-zero rows (the garbage block, slots
# never written) divide to exact 0 instead of NaN
KV_SCALE_EPS = 1e-8


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-token int8 quantisation of a K or V tensor: ``x`` (B,
    S, Hkv, D) -> int8 codes of the same shape and (B, S) fp32 scales, one
    amax scale a token row over all kv heads and head dims. A decode write
    of token t touches only its own row and scale; a per-block amax would
    requantise every earlier row whenever it grew. ``torch.round`` is
    half to even, as ``jnp.round`` is. Both divisions are tensor by tensor:
    PyTorch's CUDA division by a host scalar multiplies by its reciprocal,
    which is not the reference's correctly rounded quotient."""
    xf = x.float()
    amax = xf.abs().amax(dim=(2, 3))
    scale = torch.clamp(amax / torch.full_like(amax, 127.0), min=KV_SCALE_EPS)
    q = torch.round(xf / scale[:, :, None, None])
    return torch.clamp(q, -127.0, 127.0).to(torch.int8), scale


def _slot_positions(state: PagedKVState, s: int) -> torch.Tensor:
    """(B, s) global positions cache_len + i of this call's tokens."""
    ar = torch.arange(s, device=state.cache_len.device)
    return state.cache_len[:, None].long() + ar[None, :]


def _need_scales(state: PagedKVState, key_scale, value_scale) -> bool:
    if state.kv_dtype != "int8":
        return False
    if key_scale is None or value_scale is None:
        raise ValueError("kv_dtype='int8' needs the key_scale/value_scale arrays")
    return True


def paged_update(key_pool: torch.Tensor, value_pool: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, state: PagedKVState, key_scale: Optional[torch.Tensor] = None,
                 value_scale: Optional[torch.Tensor] = None) -> tuple[torch.Tensor, ...]:
    """Scatter one call's K/V (B, S, Hkv, D) into one layer's pools
    (num_blocks, block_size, Hkv, D), in place; returns the pools. Token i
    of slot b goes to table entry (cache_len[b] + i) // block_size at
    offset (cache_len[b] + i) % block_size; tokens at or past lengths[b]
    go to block 0. Padding rows of several slots may write the same place
    of block 0, which is harmless because nothing reads it unmasked. Under
    ``kv_dtype="int8"`` the rows are quantised on the way in, their scales
    go to ``key_scale``/``value_scale`` (num_blocks, block_size) at the same
    places, and the return is the four arrays."""
    b, s = k.shape[:2]
    bs = state.block_size
    pos = _slot_positions(state, s)
    valid = torch.arange(s, device=k.device)[None, :] < state.lengths[:, None]
    entry = (pos // bs).clamp(0, state.block_table.shape[1] - 1)
    blocks = state.block_table.long().gather(1, entry)
    blocks = torch.where(valid, blocks, torch.zeros_like(blocks))
    index = (blocks.reshape(-1), (pos % bs).reshape(-1))
    if _need_scales(state, key_scale, value_scale):
        k, k_s = quantize_kv(k)
        v, v_s = quantize_kv(v)
        key_scale.index_put_(index, k_s.reshape(-1))
        value_scale.index_put_(index, v_s.reshape(-1))
    key_pool.index_put_(index, k.reshape(b * s, *k.shape[2:]).to(key_pool.dtype))
    value_pool.index_put_(index, v.reshape(b * s, *v.shape[2:]).to(value_pool.dtype))
    if state.kv_dtype == "int8":
        return key_pool, value_pool, key_scale, value_scale
    return key_pool, value_pool


def paged_attention(q: torch.Tensor, key_pool: torch.Tensor, value_pool: torch.Tensor,
                    state: PagedKVState, scale: Optional[float] = None,
                    window: Optional[int] = None, key_scale: Optional[torch.Tensor] = None,
                    value_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Attention read through the block table: each slot's blocks are
    gathered into a (B, max_blocks*block_size, Hkv, D) view, so gathered
    column j is global position j, and the plain path runs over it with the
    band anchored at global positions: the query at position r sees column
    c iff c <= r (and c > r - window under a sliding window). Table entries
    past a slot's blocks point at block 0, whose columns sit past every
    row and are masked. Under ``kv_dtype="int8"`` the gathered codes are
    dequantised (code times its row's scale, in fp32) to the query's dtype
    before the math; the pools stay int8."""
    b, s = q.shape[:2]
    width = state.block_table.shape[1] * state.block_size
    table = state.block_table.long()
    k = key_pool[table].reshape(b, width, *key_pool.shape[2:])
    v = value_pool[table].reshape(b, width, *value_pool.shape[2:])
    if _need_scales(state, key_scale, value_scale):
        k_s = key_scale[table].reshape(b, width)
        v_s = value_scale[table].reshape(b, width)
        k = (k.float() * k_s[:, :, None, None]).to(q.dtype)
        v = (v.float() * v_s[:, :, None, None]).to(q.dtype)
    rows = _slot_positions(state, s)[:, None, :, None]
    cols = torch.arange(width, device=q.device)[None, None, None, :]
    keep = cols <= rows  # (B, 1, S, width)
    if window is not None:
        keep = keep & (cols > rows - window)
    return xla_attention(q, k, v, mask=keep, scale=scale)


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
    launch. "ring" runs ``ops/ring_attention.py`` over the running sharded
    step's sp group on the model's sequence chunks (the plain path at sp
    1, dense attention where the model kept a length sp does not tile). Score soft-capping and per-layer windows (Gemma-2) are not
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
        from ..parallel import runtime
        from . import ring_attention as ring

        if mask is not None or bias is not None or kv_lengths is not None:
            raise ValueError("ring attention supports no custom mask/bias")
        if window is not None:
            raise ValueError(
                "ring attention supports neither sliding windows nor score soft-capping — "
                "use implementation='flash' or 'xla' (at window << seq the flash band-skip "
                "already bounds memory and work)"
            )
        sp = runtime.sp_state()
        if sp is None:  # no sp above 1 in the running step: the whole sequence here
            return xla_attention(q, k, v, scale=scale, causal=causal)
        if not runtime.sequence_split():  # the model kept a length sp does not tile
            return ring.dense_fallback(q, k, v, scale=scale, causal=causal, sp_size=sp.size)
        return ring.ring_attention(q, k, v, scale=scale, causal=causal)
    raise ValueError(f"unknown attention implementation {implementation!r}")
