"""Flash attention: hand-written Hopper kernels, forward and backward.

Port of ``accelerate_tpu/ops/flash_attention.py``. Its four Pallas TPU
kernels become CUDA kernels in ``csrc/flash_attention.cu`` (built with nvcc
for sm_90a, bound with ctypes):

* ``flash_fwd``       <- ``_fwd_kernel``:       O and lse = m + log l
* ``flash_bwd_dq``    <- ``_bwd_dq_kernel``:    dq
* ``flash_bwd_dkv``   <- ``_bwd_dkv_kernel``:   dk, dv (no atomics: one CTA
  owns a kv tile and sweeps its GQA group and every q tile)
* ``flash_bwd_fused`` <- ``_bwd_fused_kernel``: dq, dk and dv in one pass
  (the dk/dv CTA also adds each pair's dq into an fp32 buffer with vector
  reductions); taken by the backward when ``FUSED_BWD`` is True, as in the
  reference

Each kernel has two designs, chosen before the launch by ``kernel_design``
from the dtype and head_dim alone, by one rule for all four: ``"wgmma"``
(Hopper wgmma, softmax or p and ds in registers, tiles streamed by TMA) for
bf16/fp16 at head_dim 64 or 128, ``"wmma"`` (the first port's kernels)
otherwise, every head_dim that is a multiple of 16 up to 256 (Gemma's) in
bf16, fp16 and fp32; above 128 the wmma tiles are shorter
(``wmma_tiles``), so that each kernel's shared tiles fit a block. The wgmma dk/dv kernel is the single pass's body without its dq
part, so the two give the same dk and dv bit for bit; the wgmma dq kernel
keeps dq in registers over its q tile's sweep (no atomics).

Beside each kernel sits its plain PyTorch version (``*_reference``): the
same function with the same masks, sentinels and rounding points, computed
densely. A wrapper takes the plain version only for a tensor on the CPU;
for a CUDA tensor it launches its kernel or raises. Each wrapper counts its
kernel launches in ``<wrapper>.launches`` and in ``<wrapper>.by_design``,
under ``kernel_design``'s answer at the launch.

Layout: the public function takes (batch, seq, heads, head_dim) like
``ops.attention``; the kernels read that layout directly. lse and delta
are (batch, heads, seq) float32. GQA: query head h reads kv head
h // (H / Hkv).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build

NEG_INF = -1e30  # large-negative instead of -inf: avoids NaN from inf - inf

# The reference's module switch (``FUSED_BWD`` :418): the autograd backward
# takes the single-pass kernel instead of dq + dk/dv when True. The
# reference also gates it on ``S * D * 4 <= _FUSED_DQ_SCRATCH_LIMIT`` (:419,
# :556), a limit of TPU VMEM that holds the full-sequence dq scratch; here
# dq accumulates in device memory, so there is no such limit.
FUSED_BWD = False

_MAX_HEAD_DIM = 256
WGMMA_HEAD_DIMS = (64, 128)
# the wmma design's tiles (q rows, kv rows) by element type, narrow (head_dim
# <= 128) and wide (above): ``Tile`` in csrc/flash_attention.cu
_WMMA_TILES = {"narrow": {2: (64, 64), 4: (32, 32)}, "wide": {2: (32, 32), 4: (16, 32)}}
# the opt-in maximum of dynamic shared memory a block may take on an H100
MAX_DYNAMIC_SMEM = 232448


def kernel_design(dtype: torch.dtype, head_dim: int) -> str:
    """The design every flash kernel (forward, dq, dk/dv and the single
    pass) takes for these inputs: ``"wgmma"`` for bf16/fp16 at head_dim 64
    or 128, else ``"wmma"``. ``wgmma_design`` in csrc/flash_attention.cu
    applies the same rule at the launch; its export ``flash_design`` (by
    kernel kind) lets a run on the card check that the two agree."""
    if dtype in (torch.bfloat16, torch.float16) and head_dim in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "wmma"


def wmma_tiles(dtype: torch.dtype, head_dim: int) -> tuple[int, int]:
    """(q rows, kv rows) of the wmma design's tiles for these inputs: the
    launcher's ``Tile`` rule (shorter tiles above head_dim 128, where the
    shared tiles would not fit)."""
    width = "wide" if head_dim > 128 else "narrow"
    return _WMMA_TILES[width][4 if dtype == torch.float32 else 2]


def wmma_smem_bytes(kind: str, dtype: torch.dtype, head_dim: int) -> int:
    """The dynamic shared memory of one wmma-design kernel (``kind``: fwd,
    dq, dkv, fused) at these inputs: the C ``*Smem::carve`` on the host,
    each tile padded by 16 bytes a row and rounded up to 128 bytes."""
    bq, bk = wmma_tiles(dtype, head_dim)
    size = 4 if dtype == torch.float32 else 2
    ld_t = lambda cols: cols + 16 // size  # noqa: E731
    ld_f = lambda cols: cols + 4  # noqa: E731

    def take(n, elem):
        return (n * elem + 127) & ~127

    t_rows = {"fwd": (bq, bk, bk), "dq": (bq, bq, bk, bk)}.get(kind, (bk, bk, bq, bq))
    total = sum(take(r * ld_t(head_dim), size) for r in t_rows)  # q/k/v/do tiles
    n_p = {"fwd": 1, "dq": 1}.get(kind, 2)  # p and/or ds
    total += n_p * take(bq * ld_t(bk), size)
    total += (1 if kind == "fwd" else 2) * take(bq * ld_f(bk), 4)  # s (and dp)
    acc_rows = {"fwd": (bq,), "dq": (bq,), "dkv": (bk, bk), "fused": (bk, bk, bq)}[kind]
    total += sum(take(r * ld_f(head_dim), 4) for r in acc_rows)
    return total + 2 * take(bq, 4)  # m and l, or lse and delta


# ---------------------------------------------------------------------- #
# plain versions
# ---------------------------------------------------------------------- #
def _keep_mask(B, S, Skv, causal, window, kv_lengths, device):
    """(B or 1, 1, S, Skv) bool, True = attend: end-aligned causal
    (offset = Skv - S), the window band col > row + offset - window, and
    cols < kv_lengths[b]."""
    rows = torch.arange(S, device=device)[:, None]
    cols = torch.arange(Skv, device=device)[None, :]
    offset = Skv - S
    keep = torch.ones(S, Skv, dtype=torch.bool, device=device)
    if causal:
        keep = keep & (cols <= rows + offset)
    if window is not None:
        keep = keep & (cols > rows + offset - window)
    keep = keep[None, None]
    if kv_lengths is not None:
        keep = keep & (cols[None, None] < kv_lengths.to(device)[:, None, None, None])
    return keep


def _repeat_heads(x, group):
    return x if group == 1 else x.repeat_interleave(group, dim=2)


def _scores(q, k, scale, causal, kv_lengths, window):
    """Masked fp32 scores (B, H, S, Skv): masked entries are NEG_INF."""
    B, S, H, _ = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    kr = _repeat_heads(k, H // Hkv)
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), kr.float()) * scale
    keep = _keep_mask(B, S, Skv, causal, window, kv_lengths, q.device)
    return torch.where(keep, s, torch.full_like(s, NEG_INF))


def _probs(s, lse):
    """p = exp(s - lse), zero on rows whose lse is the masked sentinel."""
    lse = lse[..., None]
    return torch.where(lse <= NEG_INF * 0.5, torch.zeros_like(s), torch.exp(s - lse))


def flash_fwd_reference(q, k, v, scale, causal=True, kv_lengths=None, window=None):
    """Plain version of the forward kernel: (O in q's dtype, lse (B,H,S)
    fp32). A row that sees no column gets O = 0 and lse = NEG_INF (not
    the mean of v that a plain softmax gives). p is rounded to v's dtype
    before p.v, as in the kernel."""
    H, Hkv = q.shape[2], k.shape[2]
    s = _scores(q, k, scale, causal, kv_lengths, window)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(m <= NEG_INF * 0.5, torch.zeros_like(s), torch.exp(s - m))
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    vr = _repeat_heads(v, H // Hkv)
    acc = torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype).float(), vr.float())
    out = (acc / l_safe.permute(0, 2, 1, 3)).to(q.dtype)
    lse = (m + torch.log(l_safe))[..., 0]
    return out, lse


def flash_bwd_dq_reference(q, k, v, dout, lse, delta, scale, causal=True,
                           kv_lengths=None, window=None):
    """Plain version of the dq kernel: ds = p (dp - delta) scale rounded to
    k's dtype, dq = ds . k accumulated in fp32, returned in q's dtype."""
    H, Hkv = q.shape[2], k.shape[2]
    p = _probs(_scores(q, k, scale, causal, kv_lengths, window), lse)
    vr = _repeat_heads(v, H // Hkv)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vr.float())
    ds = (p * (dp - delta[..., None]) * scale).to(k.dtype)
    kr = _repeat_heads(k, H // Hkv)
    return torch.einsum("bhqk,bkhd->bqhd", ds.float(), kr.float()).to(q.dtype)


def flash_bwd_dkv_reference(q, k, v, dout, lse, delta, scale, causal=True,
                            kv_lengths=None, window=None):
    """Plain version of the dk/dv kernel: dv = p^T . do with p rounded to
    do's dtype, dk = ds^T . q with ds rounded to q's dtype, each summed in
    fp32 over the query heads of a kv head's group, returned in k's/v's
    dtype."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    p = _probs(_scores(q, k, scale, causal, kv_lengths, window), lse)
    vr = _repeat_heads(v, g)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vr.float())
    ds = (p * (dp - delta[..., None]) * scale).to(q.dtype)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.float(), q.float())
    dk = dk.reshape(B, Skv, Hkv, g, D).sum(dim=3)
    dv = dv.reshape(B, Skv, Hkv, g, D).sum(dim=3)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_bwd_fused_reference(q, k, v, dout, lse, delta, scale, causal=True,
                              kv_lengths=None, window=None):
    """Plain version of the single-pass backward (``_bwd_fused_kernel``
    :455-481): p and ds formed once; ds = p (dp - delta) scale rounded to
    k's dtype, p rounded to do's dtype before p^T . do; dq = ds . k and the
    per-head dk, dv summed in fp32 over each kv head's group; returned in
    q's, k's and v's dtypes."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    g = H // Hkv
    p = _probs(_scores(q, k, scale, causal, kv_lengths, window), lse)
    vr = _repeat_heads(v, g)
    dp = torch.einsum("bqhd,bkhd->bhqk", dout.float(), vr.float())
    ds = (p * (dp - delta[..., None]) * scale).to(k.dtype)
    dq = torch.einsum("bhqk,bkhd->bqhd", ds.float(), _repeat_heads(k, g).float())
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(dout.dtype).float(), dout.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds.float(), q.float())
    dk = dk.reshape(B, Skv, Hkv, g, D).sum(dim=3)
    dv = dv.reshape(B, Skv, Hkv, g, D).sum(dim=3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def attention_delta(out, dout):
    """delta = rowsum(dout * out) in fp32, (B, H, S) — computed outside the
    kernels, as the reference does (``_bwd``)."""
    return (dout.float() * out.float()).sum(dim=-1).transpose(1, 2).contiguous()


# ---------------------------------------------------------------------- #
# the kernels
# ---------------------------------------------------------------------- #
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_SHAPE_ARGS = [_I] * 6 + [_F, _I, _I, _I, _P]  # B S Skv H Hkv D scale causal window dtype stream
_SIGNATURES = {
    "flash_fwd": [_P] * 6 + _SHAPE_ARGS,
    "flash_bwd_dq": [_P] * 8 + _SHAPE_ARGS,
    "flash_bwd_dkv": [_P] * 9 + _SHAPE_ARGS,
    "flash_bwd_fused": [_P] * 10 + _SHAPE_ARGS,
    "flash_design": [_I, _I, _I],
    "flash_wmma_smem": [_I, _I, _I],
}


def _require(cond, msg):
    if not cond:
        raise ValueError(f"flash attention kernel: {msg}")


def _check_tensor(name, t, q):
    _require(t.is_cuda, f"{name} is not a CUDA tensor")
    _require(t.device == q.device, f"{name} is on {t.device}, q on {q.device}")
    _require(t.dim() == 4, f"{name} must be (batch, seq, heads, head_dim)")
    _require(t.is_contiguous(), f"{name} must be contiguous")
    _require(t.data_ptr() % 16 == 0, f"{name} must be 16-byte aligned")
    _require(t.dtype == q.dtype, f"{name} is {t.dtype}, q is {q.dtype}")


def _check_inputs(q, k, v, kv_lengths, window, causal, dout=None):
    """Everything the kernels assume, checked before any launch."""
    for name, t in (("q", q), ("k", k), ("v", v), ("dout", dout)):
        if t is not None:
            _check_tensor(name, t, q)
    _require(dout is None or dout.shape == q.shape, "dout must have q's shape")
    _require(q.dtype in _build.DTYPE_CODES, f"dtype {q.dtype} not in {list(_build.DTYPE_CODES)}")
    B, S, H, D = q.shape
    _require(k.shape == v.shape, f"k {tuple(k.shape)} and v {tuple(v.shape)} differ")
    _require(k.shape[0] == B and k.shape[3] == D, "q and k differ in batch or head_dim")
    _require(S >= 1 and k.shape[1] >= 1, "empty sequence")
    _require(H % k.shape[2] == 0, f"{H} query heads not a multiple of {k.shape[2]} kv heads")
    _require(D % 16 == 0 and 16 <= D <= _MAX_HEAD_DIM,
             f"head_dim {D} must be a multiple of 16 in [16, {_MAX_HEAD_DIM}]")
    _require(window is None or (causal and window > 0), "window needs causal and > 0")
    if kv_lengths is not None:
        _require(kv_lengths.device == q.device and kv_lengths.dtype == torch.int32
                 and kv_lengths.shape == (B,) and kv_lengths.is_contiguous(),
                 "kv_lengths must be a contiguous (batch,) int32 tensor on q's device")


def _check_stats(q, *stats):
    B, S, H, _ = q.shape
    for t in stats:
        _require(t.device == q.device and t.dtype == torch.float32
                 and t.shape == (B, H, S) and t.is_contiguous(),
                 "lse/delta must be contiguous (batch, heads, seq) float32 on q's device")


def _launch(wrapper, tensors, q, k, scale, causal, window):
    """The C function of ``wrapper``'s name on ``tensors``; one launch is
    counted on the wrapper, in total and under ``kernel_design``'s design."""
    B, S, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    lib = _build.bind("flash_attention", _SIGNATURES, "flash_error_string")
    ptrs = [None if t is None else t.data_ptr() for t in tensors]
    _build.launch(lib, wrapper.__name__, *ptrs, B, S, Skv, H, Hkv, D, float(scale),
                  int(causal), int(window or 0), _build.DTYPE_CODES[q.dtype], device=q.device)
    wrapper.launches += 1
    wrapper.by_design[kernel_design(q.dtype, D)] += 1


def flash_fwd(q, k, v, scale, causal=True, kv_lengths=None, window=None):
    """(O, lse) — the forward kernel on CUDA tensors, its plain version on
    CPU tensors."""
    _build.refuse_dtensor("flash_fwd", q, k, v, kv_lengths)
    if not q.is_cuda:
        return flash_fwd_reference(q, k, v, scale, causal, kv_lengths, window)
    _check_inputs(q, k, v, kv_lengths, window, causal)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[0], q.shape[2], q.shape[1], dtype=torch.float32,
                      device=q.device)
    _launch(flash_fwd, (q, k, v, kv_lengths, out, lse), q, k, scale, causal, window)
    return out, lse


def flash_bwd_dq(q, k, v, dout, lse, delta, scale, causal=True, kv_lengths=None,
                 window=None):
    """dq — the dq kernel on CUDA tensors, its plain version on CPU tensors."""
    _build.refuse_dtensor("flash_bwd_dq", q, k, v, dout, lse, delta, kv_lengths)
    if not q.is_cuda:
        return flash_bwd_dq_reference(q, k, v, dout, lse, delta, scale, causal,
                                      kv_lengths, window)
    _check_inputs(q, k, v, kv_lengths, window, causal, dout)
    _check_stats(q, lse, delta)
    dq = torch.empty_like(q)
    _launch(flash_bwd_dq, (q, k, v, dout, lse, delta, kv_lengths, dq), q, k, scale,
            causal, window)
    return dq


def flash_bwd_dkv(q, k, v, dout, lse, delta, scale, causal=True, kv_lengths=None,
                  window=None):
    """(dk, dv) — the dk/dv kernel on CUDA tensors, its plain version on CPU
    tensors."""
    _build.refuse_dtensor("flash_bwd_dkv", q, k, v, dout, lse, delta, kv_lengths)
    if not q.is_cuda:
        return flash_bwd_dkv_reference(q, k, v, dout, lse, delta, scale, causal,
                                       kv_lengths, window)
    _check_inputs(q, k, v, kv_lengths, window, causal, dout)
    _check_stats(q, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(flash_bwd_dkv, (q, k, v, dout, lse, delta, kv_lengths, dk, dv), q, k,
            scale, causal, window)
    return dk, dv


def flash_bwd_fused(q, k, v, dout, lse, delta, scale, causal=True, kv_lengths=None,
                    window=None):
    """(dq, dk, dv) — the single-pass kernel on CUDA tensors, its plain
    version on CPU tensors. dq is summed in a zeroed fp32 buffer by the
    kernel's vector reductions, then cast to q's dtype."""
    _build.refuse_dtensor("flash_bwd_fused", q, k, v, dout, lse, delta, kv_lengths)
    if not q.is_cuda:
        return flash_bwd_fused_reference(q, k, v, dout, lse, delta, scale, causal,
                                         kv_lengths, window)
    _check_inputs(q, k, v, kv_lengths, window, causal, dout)
    _check_stats(q, lse, delta)
    dq_acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch(flash_bwd_fused, (q, k, v, dout, lse, delta, kv_lengths, dq_acc, dk, dv), q,
            k, scale, causal, window)
    return dq_acc.to(q.dtype), dk, dv


KERNEL_WRAPPERS = (flash_fwd, flash_bwd_dq, flash_bwd_dkv, flash_bwd_fused)
for _wrapper in KERNEL_WRAPPERS:
    _wrapper.launches = 0
    _wrapper.by_design = {"wgmma": 0, "wmma": 0}
del _wrapper


# ---------------------------------------------------------------------- #
# public entry with autograd
# ---------------------------------------------------------------------- #
class FlashAttention(torch.autograd.Function):
    """The forward kernel joined to its backward kernels (the reference's
    ``jax.custom_vjp`` around ``_flash``): dq + dk/dv, or the single-pass
    kernel when ``FUSED_BWD`` is True."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lengths, scale, causal, window):
        out, lse = flash_fwd(q, k, v, scale, causal, kv_lengths, window)
        ctx.save_for_backward(q, k, v, out, lse, kv_lengths)
        ctx.scale, ctx.causal, ctx.window = scale, causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, kv_lengths = ctx.saved_tensors
        dout = dout.contiguous()
        delta = attention_delta(out, dout)
        args = (ctx.scale, ctx.causal, kv_lengths, ctx.window)
        if FUSED_BWD:
            dq, dk, dv = flash_bwd_fused(q, k, v, dout, lse, delta, *args)
        else:
            dq = flash_bwd_dq(q, k, v, dout, lse, delta, *args)
            dk, dv = flash_bwd_dkv(q, k, v, dout, lse, delta, *args)
        return dq, dk, dv, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: Optional[float] = None,
    causal: bool = True,
    kv_lengths: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Flash attention, (batch, seq, heads, head_dim) layout, GQA-aware.

    ``window`` (requires ``causal``): query row r sees keys
    (r + offset - window, r + offset]. ``kv_lengths`` (B,) marks keys
    [0, len) valid per batch row. Any sequence lengths work: the kernels
    mask the ragged last tile. A row that sees no key returns 0 and gets
    zero gradients.
    """
    scale = scale if scale is not None else q.shape[-1] ** -0.5
    if window is not None:
        if not causal:
            raise ValueError("sliding window requires causal attention")
        window = int(window)
        if window <= 0:
            raise ValueError(f"window must be positive, got {window}")
    if kv_lengths is not None:
        if tuple(kv_lengths.shape) != (q.shape[0],):
            raise ValueError(
                f"kv_lengths must be shape ({q.shape[0]},), got {tuple(kv_lengths.shape)}"
            )
        if kv_lengths.device != q.device:
            raise ValueError(f"kv_lengths is on {kv_lengths.device}, q on {q.device}")
        kv_lengths = kv_lengths.to(torch.int32).contiguous()
    return FlashAttention.apply(q, k, v, kv_lengths, scale, causal, window)
