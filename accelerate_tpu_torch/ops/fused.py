"""Fused train-step kernels: the attention prologue and the AdamW epilogue.

Port of ``accelerate_tpu/ops/fused.py``. Its two Pallas TPU kernels become
CUDA kernels in ``csrc/fused.cu`` (built with nvcc for sm_90a, bound with
ctypes):

* ``qkv_prologue``   <- ``_prologue_call``'s kernel (:214): RMSNorm ->
  x.[Wq|Wk|Wv] + bias -> rope on the q and k columns, reading the three
  (out, in) weights in place and writing q, k and v. Two designs, chosen
  before the launch by ``prologue_kernel_design``: ``"wgmma"`` (a pre-pass
  writes each row's rstd, then a TMA-fed wgmma GEMM applies the norm on its
  A operand and rope on its accumulator registers) for bf16/fp16 at
  head_dim 64 or 128, ``"wmma"`` (the first port's kernel) otherwise.
* ``adamw_epilogue`` <- ``_adamw_leaf_kernel``'s kernel (:426): AdamW in
  optax's operation order plus the non-finite hold, in ONE launch over
  every leaf of the tree (the reference launches once per leaf), updating
  p, mu and nu in place.

Beside each kernel sits its plain PyTorch version: ``prologue_reference``
(and ``_prologue_reference_tables``) and ``adamw_leaf_reference``, which
the epilogue wrapper applies leaf by leaf. A wrapper takes the plain
version only for a tensor on the CPU; for a CUDA tensor it launches its
kernel or raises. Each wrapper counts its launches in
``<wrapper>.launches``; the prologue's also in ``qkv_prologue.by_design``,
under ``prologue_kernel_design``'s answer at the launch.

``fused_qkv_prologue`` is a ``torch.autograd.Function`` whose backward
differentiates the plain chain (the reference's ``custom_vjp`` does
``jax.vjp`` of it, :345-350). ``fused_adamw`` is the port's ``AdamW`` with
the reference's opt-in attributes; ``maybe_fused_epilogue`` runs the
kernel for it inside ``Accelerator.unified_step``, or returns None and the
caller takes the plain optimizer path.
"""

from __future__ import annotations

import ctypes
import math
import os
from typing import Optional

import torch
import torch.nn.functional as F

from ..optimizer import AdamW
from . import _build
from .rope import rope_inv_freqs

_MAX_COL_BLOCK = 512  # shared-memory tiles of the prologue's wmma design
WGMMA_HEAD_DIMS = (64, 128)  # rope's partner D/2 columns away in the thread's registers


# copied from accelerate_tpu/ops/flash_attention.py:66-80 (the port imports
# nothing of the JAX package)
MIN_BLOCK = 8  # f32 sublane granularity; small blocks run, just slowly


def fit_block(seq: int, preferred: int):
    """Largest block <= preferred that divides ``seq`` AND is a multiple of
    8, halving down from preferred; None when there is none."""
    b = min(preferred, seq)
    while b >= MIN_BLOCK:
        if seq % b == 0 and b % MIN_BLOCK == 0:
            return b
        b //= 2
    return None


# ---------------------------------------------------------------------- #
# fused prologue: RMSNorm -> QKV -> rope, plain versions
# ---------------------------------------------------------------------- #
def rms_norm_reference(x, scale, *, eps: float, norm_offset: bool):
    """RMSNorm's math on an explicit scale: used when a Block handed
    Attention the raw residual stream and the norm scale but the fused
    kernel does not take the shape."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.square().mean(dim=-1, keepdim=True) + eps)
    mult = (1.0 + scale) if norm_offset else scale
    return (y * mult).to(x.dtype)


def _rope_tables(positions, inv_freqs):
    """(rows, D) duplicated cos/sin tables for the rotate-half identity
    [x1 cos - x2 sin, x2 cos + x1 sin] == x [cos, cos] + [-x2, x1] [sin, sin]
    (exact in IEEE arithmetic: a - b == a + (-b))."""
    angles = positions.reshape(-1, 1).float() * inv_freqs
    cos, sin = torch.cos(angles), torch.sin(angles)
    return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)


def _rope_apply_tables(x, cosd, sind):
    """Rotate with precomputed (rows, D) tables; x is (B, S, H, D)."""
    b, s, _, d = x.shape
    cos = cosd.reshape(b, s, 1, d)
    sin = sind.reshape(b, s, 1, d)
    xf = x.float()
    half = d // 2
    rot = torch.cat([-xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + rot * sin).to(x.dtype)


def _prologue_reference_tables(x, scale, wq, wk, wv, bq, bk, bv, cosd, sind, *,
                               eps: float, norm_offset: bool, num_heads: int,
                               num_kv_heads: int, head_dim: int, dtype):
    """The unfused module chain with the reference's rounding points: xn
    cast to ``dtype`` before the matmul, the projection rounded to
    ``dtype``, the bias added in ``dtype``, rope in fp32 on the rounded
    projection. Weights are PyTorch's (out, in)."""
    b, s = x.shape[:2]
    xn = rms_norm_reference(x, scale, eps=eps, norm_offset=norm_offset).to(dtype)

    def dense(w, bias):
        y = F.linear(xn, w.to(dtype))
        if bias is not None:
            y = y + bias.to(dtype)
        return y

    q = dense(wq, bq).reshape(b, s, num_heads, head_dim)
    k = dense(wk, bk).reshape(b, s, num_kv_heads, head_dim)
    v = dense(wv, bv).reshape(b, s, num_kv_heads, head_dim)
    return _rope_apply_tables(q, cosd, sind), _rope_apply_tables(k, cosd, sind), v


def prologue_reference(x, scale, wq, wk, wv, bq, bk, bv, positions, inv_freqs, *,
                       eps: float, norm_offset: bool, num_heads: int, num_kv_heads: int,
                       head_dim: int, dtype):
    """Plain prologue: the exact math of the unfused chain (RMSNorm ->
    q/k/v projections -> reshape -> rope on q and k)."""
    cosd, sind = _rope_tables(positions, inv_freqs)
    return _prologue_reference_tables(
        x, scale, wq, wk, wv, bq, bk, bv, cosd, sind, eps=eps, norm_offset=norm_offset,
        num_heads=num_heads, num_kv_heads=num_kv_heads, head_dim=head_dim, dtype=dtype,
    )


def _col_block(num_heads: int, num_kv_heads: int, head_dim: int, limit: int = 512) -> int:
    """Widest weight-column tile <= ``limit`` that is a whole number of
    heads AND divides both the q and k/v column spans, so no tile straddles
    the q/k/v boundaries and rope's partner column is in the tile. The
    wmma design's tile (limit 512, the reference's); the wgmma design's is
    ``limit=256`` (``pro_wgmma_tile`` in csrc/fused.cu)."""
    g = math.gcd(num_heads, num_kv_heads)
    best = head_dim
    for m in range(1, g + 1):
        if g % m == 0 and m * head_dim <= limit:
            best = m * head_dim
    return best


def prologue_kernel_design(dtype: torch.dtype, num_heads: int, num_kv_heads: int,
                           head_dim: int, hidden: int) -> str:
    """The design the prologue kernel takes for these inputs: ``"wgmma"``
    for bf16/fp16 at head_dim 64 or 128 with hidden a multiple of 64, else
    ``"wmma"``. ``pro_wgmma_design`` in csrc/fused.cu applies the same rule
    at the launch; its export ``prologue_design`` lets a run on the card
    check that the two agree."""
    if (dtype in (torch.bfloat16, torch.float16) and head_dim in WGMMA_HEAD_DIMS
            and num_heads > 0 and num_kv_heads > 0 and hidden > 0 and hidden % 64 == 0):
        return "wgmma"
    return "wmma"


def prologue_supported(num_heads: int, num_kv_heads: int, head_dim: int, batch: int,
                       seq: int, hidden: int, device=None, dtype=None) -> bool:
    """Shape gate for the fused prologue; callers take the unfused chain
    when False. For a CPU device it is the reference's interpret-mode
    answer (even head_dim, rows with an 8-aligned block divisor <= 256).
    For a CUDA device it adds the kernel's own limits: a column tile that
    is a multiple of 64 and at most 512, hidden a multiple of 64, and a
    dtype the kernel takes."""
    if head_dim % 2:
        return False  # rope pairs i with i + D/2
    if fit_block(batch * seq, 256) is None:
        return False
    if device is None or torch.device(device).type != "cuda":
        return True
    c = _col_block(num_heads, num_kv_heads, head_dim)
    return (c % 64 == 0 and c <= _MAX_COL_BLOCK and hidden % 64 == 0
            and (dtype is None or dtype in _build.DTYPE_CODES))


# ---------------------------------------------------------------------- #
# the kernels
# ---------------------------------------------------------------------- #
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
_SIGNATURES = {
    # x mult wq wk wv bq bk bv cos sin q k v rstd, rows E H Hkv D col_block, eps, dtype,
    # stream
    "fused_qkv_prologue": [_P] * 14 + [_I] * 6 + [_F, _I, _P],
    "prologue_design": [_I] * 5,
    # table, n_leaves, n_chunks, row, b1 b2 (1-b1) (1-b2) eps eps_root wd, stream
    "adamw_epilogue": [_P, _I, _L, _P] + [_F] * 7 + [_P],
    "adamw_chunk_elements": [],
}


def _kernels() -> ctypes.CDLL:
    return _build.bind("fused", _SIGNATURES, "fused_error_string",
                       returns={"adamw_chunk_elements": _L})


def _require(cond, msg):
    if not cond:
        raise ValueError(f"fused kernel: {msg}")


def _check_prologue(x, mult, ws, bs, cosd, sind, num_heads, num_kv_heads, head_dim, dtype):
    """Everything the prologue kernel assumes, checked before the launch."""
    _require(x.is_cuda, "x is not a CUDA tensor")
    _require(dtype in _build.DTYPE_CODES,
             f"dtype {dtype} not in {list(_build.DTYPE_CODES)}")
    _require(x.dtype == dtype, f"x is {x.dtype}, the compute dtype is {dtype}")
    _require(x.dim() == 3 and x.is_contiguous(), "x must be a contiguous (batch, seq, hidden)")
    rows, hidden = x.shape[0] * x.shape[1], x.shape[2]
    _require(head_dim % 2 == 0, f"head_dim {head_dim} must be even (rope pairs i, i + D/2)")
    c = _col_block(num_heads, num_kv_heads, head_dim)
    _require(c % 64 == 0 and c <= _MAX_COL_BLOCK,
             f"column tile {c} (whole heads of {head_dim}) must be a multiple of 64 <= 512")
    _require(hidden % 64 == 0, f"hidden {hidden} must be a multiple of 64")
    widths = (num_heads * head_dim, num_kv_heads * head_dim, num_kv_heads * head_dim)
    named = [("mult", mult, (hidden,), torch.float32), ("cos", cosd, (rows, head_dim), torch.float32),
             ("sin", sind, (rows, head_dim), torch.float32)]
    named += [(f"w{n}", w, (width, hidden), dtype) for n, w, width in zip("qkv", ws, widths)]
    named += [(f"b{n}", b, (width,), dtype) for n, b, width in zip("qkv", bs, widths)
              if b is not None]
    for name, t, shape, dt in named:
        _require(t.device == x.device, f"{name} is on {t.device}, x on {x.device}")
        _require(tuple(t.shape) == shape and t.dtype == dt and t.is_contiguous(),
                 f"{name} must be a contiguous {shape} {dt}, got {tuple(t.shape)} {t.dtype}")
    _require(x.data_ptr() % 16 == 0 and all(w.data_ptr() % 16 == 0 for w in ws),
             "x and the weights must be 16-byte aligned")
    return rows, hidden, c


def prologue_launch(x, scale, wq, wk, wv, bq, bk, bv, cosd, sind, q, k, v, *, eps: float,
                    norm_offset: bool, num_heads: int, num_kv_heads: int, head_dim: int,
                    dtype) -> str:
    """Launch the prologue kernel on CUDA tensors into the given (B, S, H, D)
    / (B, S, Hkv, D) outputs, uncounted; returns the design it took.
    ``qkv_prologue`` is the counted entry; a check on the card calls this
    to write into outputs it placed itself."""
    _build.refuse_dtensor("prologue_launch", x, scale, wq, wk, wv, bq, bk, bv, q, k, v)
    # the multiplier in the scale's own dtype, as rms_norm_reference forms it
    mult = ((1.0 + scale) if norm_offset else scale).float().contiguous()
    if mult.data_ptr() % 16:
        mult = mult.clone()  # the wgmma design copies it in 16-byte-aligned slices
    ws = [w.to(dtype) for w in (wq, wk, wv)]
    bs = [None if b is None else b.to(dtype) for b in (bq, bk, bv)]
    rows, hidden, c = _check_prologue(x, mult, ws, bs, cosd, sind, num_heads, num_kv_heads,
                                      head_dim, dtype)
    shapes = ((num_heads, q), (num_kv_heads, k), (num_kv_heads, v))
    for n, out in shapes:
        _require(out.device == x.device and out.dtype == dtype and out.is_contiguous()
                 and tuple(out.shape) == (*x.shape[:2], n, head_dim),
                 f"an output must be a contiguous {(*x.shape[:2], n, head_dim)} {dtype}")
    design = prologue_kernel_design(dtype, num_heads, num_kv_heads, head_dim, hidden)
    rstd = (torch.empty(rows, dtype=torch.float32, device=x.device) if design == "wgmma"
            else None)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    _build.launch(
        _kernels(), "fused_qkv_prologue", x.data_ptr(), mult.data_ptr(), *map(ptr, ws),
        *map(ptr, bs), cosd.data_ptr(), sind.data_ptr(), q.data_ptr(), k.data_ptr(),
        v.data_ptr(), ptr(rstd), rows, hidden, num_heads, num_kv_heads, head_dim, c,
        float(eps), _build.DTYPE_CODES[dtype], device=x.device,
    )
    return design


def qkv_prologue(x, scale, wq, wk, wv, bq, bk, bv, cosd, sind, *, eps: float,
                 norm_offset: bool, num_heads: int, num_kv_heads: int, head_dim: int,
                 dtype):
    """(q, k, v) — the prologue kernel on CUDA tensors, its plain version
    on CPU tensors. x is the raw (B, S, E) residual stream, the weights
    are (out, in), cos/sin the (B*S, D) tables of ``_rope_tables``."""
    _build.refuse_dtensor("qkv_prologue", x, scale, wq, wk, wv, bq, bk, bv, cosd, sind)
    kw = dict(eps=eps, norm_offset=norm_offset, num_heads=num_heads,
              num_kv_heads=num_kv_heads, head_dim=head_dim, dtype=dtype)
    if not x.is_cuda:
        return _prologue_reference_tables(x, scale, wq, wk, wv, bq, bk, bv, cosd, sind, **kw)
    b, s = x.shape[:2]
    q = torch.empty(b, s, num_heads, head_dim, dtype=dtype, device=x.device)
    k = torch.empty(b, s, num_kv_heads, head_dim, dtype=dtype, device=x.device)
    v = torch.empty_like(k)
    design = prologue_launch(x, scale, wq, wk, wv, bq, bk, bv, cosd, sind, q, k, v, **kw)
    qkv_prologue.launches += 1
    qkv_prologue.by_design[design] += 1
    return q, k, v


# ---------------------------------------------------------------------- #
# fused prologue: public entry with autograd
# ---------------------------------------------------------------------- #
class FusedQKVPrologue(torch.autograd.Function):
    """The prologue kernel in the forward; the backward recomputes the
    plain chain under autograd and differentiates it (the reference's
    custom_vjp, :342-350). cos/sin get no gradient."""

    @staticmethod
    def forward(ctx, x, scale, wq, wk, wv, bq, bk, bv, cosd, sind, statics):
        q, k, v = qkv_prologue(x, scale, wq, wk, wv, bq, bk, bv, cosd, sind, **statics)
        ctx.save_for_backward(x, scale, wq, wk, wv, bq, bk, bv, cosd, sind)
        ctx.statics = statics
        return q, k, v

    @staticmethod
    def backward(ctx, dq, dk, dv):
        *diff, cosd, sind = ctx.saved_tensors
        needs = ctx.needs_input_grad[:len(diff)]
        with torch.enable_grad():
            inputs = [t if t is None else t.detach().requires_grad_(n)
                      for t, n in zip(diff, needs)]
            outs = _prologue_reference_tables(*inputs, cosd, sind, **ctx.statics)
            wrt = [t for t, n in zip(inputs, needs) if t is not None and n]
            grads = iter(torch.autograd.grad(outs, wrt, (dq, dk, dv), allow_unused=True)
                         if wrt else ())
        out = [next(grads) if t is not None and n else None for t, n in zip(inputs, needs)]
        return (*out, None, None, None)


def fused_qkv_prologue(x, scale, wq, wk, wv, bq, bk, bv, positions, *, eps: float,
                       norm_offset: bool, num_heads: int, num_kv_heads: int, head_dim: int,
                       theta: float, scaling: Optional[dict] = None, dtype=torch.float32):
    """Fused RMSNorm -> QKV -> rope -> head split.

    Inputs are the raw residual stream ``x (B, S, E)``, the norm ``scale
    (E,)``, the three projection weights ``(H*D, E)`` / ``(Hkv*D, E)`` in
    PyTorch's (out, in) layout (+ optional biases) and ``positions (B, S)``.
    Returns ``q (B, S, H, D)`` and ``k, v (B, S, Hkv, D)`` in ``dtype``."""
    # cos/sin are built outside the Function and get no gradient: the
    # unfused chain treats them as constants of integer positions too
    # (the reference's reason, :317-320)
    cosd, sind = _rope_tables(positions, rope_inv_freqs(head_dim, theta, scaling,
                                                        positions.device))
    statics = dict(eps=eps, norm_offset=norm_offset, num_heads=num_heads,
                   num_kv_heads=num_kv_heads, head_dim=head_dim, dtype=dtype)
    return FusedQKVPrologue.apply(x, scale, wq, wk, wv, bq, bk, bv, cosd.contiguous(),
                                  sind.contiguous(), statics)


# ---------------------------------------------------------------------- #
# fused optimizer epilogue
# ---------------------------------------------------------------------- #
class FusedAdamW(AdamW):
    """The port's :class:`AdamW` (same state layout and arithmetic, so
    ``prepare`` and the plain path take it unchanged) that also carries the
    hyperparameters and the opt-in the fused epilogue reads."""

    def __init__(self, learning_rate, b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0,
                 weight_decay=1e-4, *, fused: Optional[bool] = None):
        super().__init__(learning_rate, b1, b2, eps, eps_root, weight_decay)
        self.hyperparams = dict(learning_rate=learning_rate, b1=b1, b2=b2, eps=eps,
                                eps_root=eps_root, weight_decay=weight_decay)
        if fused is None:
            fused = os.environ.get("ACCELERATE_TPU_FUSED_EPILOGUE", "1") not in (
                "0", "false", "False",
            )
        self.fused = bool(fused)


def fused_adamw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                eps_root: float = 0.0, weight_decay: float = 1e-4, *,
                fused: Optional[bool] = None) -> FusedAdamW:
    """adamw whose ``unified_step`` epilogue runs as one kernel launch over
    every leaf. State and numerics are ``adamw``'s; ``fused=None`` reads
    ACCELERATE_TPU_FUSED_EPILOGUE (default on: constructing this optimizer
    is already the opt-in)."""
    return FusedAdamW(learning_rate, b1, b2, eps, eps_root, weight_decay, fused=fused)


def epilogue_scalars(b1: float, b2: float, count_inc: int, step_size: float, finite: bool,
                     device) -> torch.Tensor:
    """The (1, 8) fp32 row [reserved, bc1, bc2, -lr, finite, 0, 0, 0], made
    on ``device`` with no host sync; bc_i = 1 - b_i^count as
    ``AdamW.apply_`` forms it."""
    one = torch.ones((), dtype=torch.float32, device=device)
    row = torch.zeros(1, 8, dtype=torch.float32, device=device)
    row[0, 1] = one - (one * b1) ** count_inc
    row[0, 2] = one - (one * b2) ** count_inc
    row[0, 3] = step_size
    row[0, 4] = 1.0 if finite else 0.0
    return row


@torch.no_grad()
def adamw_leaf_reference(g, p, mu, nu, row, *, b1, b2, eps, eps_root, weight_decay):
    """Plain version of the epilogue kernel for one leaf, in place: the
    operations of ``AdamW.apply_`` with bc1, bc2 and -lr read from ``row``,
    and p, mu, nu held where ``row[0, 4]`` is 0."""
    bc1, bc2, step, fin = row[0, 1], row[0, 2], row[0, 3], row[0, 4] != 0
    mu2 = (1 - b1) * g + b1 * mu
    nu2 = (1 - b2) * (g ** 2) + b2 * nu
    u = (mu2 / bc1) / (torch.sqrt(nu2 / bc2 + eps_root) + eps)
    u = u + weight_decay * p
    newp = p + step * u
    p.copy_(torch.where(fin, newp, p))
    mu.copy_(torch.where(fin, mu2, mu))
    nu.copy_(torch.where(fin, nu2, nu))


def _check_epilogue(leaves, row):
    dev = leaves[0][1].device
    _require(row.is_cuda and row.device == dev and row.dtype == torch.float32
             and tuple(row.shape) == (1, 8) and row.is_contiguous(),
             "the scalar row must be a contiguous (1, 8) float32 tensor on the leaves' device")
    for g, p, mu, nu in leaves:
        for name, t in (("grad", g), ("param", p), ("mu", mu), ("nu", nu)):
            _require(t.is_cuda and t.device == dev, f"a {name} leaf is not on {dev}")
            _require(t.dtype == torch.float32, f"a {name} leaf is {t.dtype}, not float32")
            _require(t.is_contiguous(), f"a {name} leaf is not contiguous")
            _require(t.shape == p.shape, f"a {name} leaf has shape {tuple(t.shape)}, "
                                         f"its param {tuple(p.shape)}")


def adamw_epilogue(grads, params, mus, nus, row, *, b1, b2, eps, eps_root, weight_decay):
    """One AdamW step over lists of fp32 leaves, in place: one kernel
    launch over all of them on CUDA tensors, the plain version leaf by leaf
    on CPU tensors."""
    _build.refuse_dtensor("adamw_epilogue", grads, params, mus, nus, row)
    hp = dict(b1=b1, b2=b2, eps=eps, eps_root=eps_root, weight_decay=weight_decay)
    leaves = list(zip(grads, params, mus, nus))
    _require(len(leaves) > 0 and len(leaves) == len(params),
             "no leaves, or lists of unequal length")
    if not params[0].is_cuda:
        for leaf in leaves:
            adamw_leaf_reference(*leaf, row, **hp)
        return
    _check_epilogue(leaves, row)
    lib = _kernels()
    chunk = lib.adamw_chunk_elements()
    sizes = [p.numel() for p in params]
    starts = [0]
    for n in sizes:
        starts.append(starts[-1] + (n + chunk - 1) // chunk)
    ptrs = [t.data_ptr() for column in zip(*leaves) for t in column]
    host = torch.tensor(ptrs + sizes + starts, dtype=torch.int64).pin_memory()
    table = host.to(row.device, non_blocking=True)
    # the constants as the plain version forms them: Python doubles (1 - b1
    # computed in double), each rounded once to fp32 by ctypes
    _build.launch(lib, "adamw_epilogue", table.data_ptr(), len(leaves), starts[-1],
                  row.data_ptr(), b1, b2, 1 - b1, 1 - b2, eps, eps_root, weight_decay,
                  device=row.device)
    adamw_epilogue.launches += 1


qkv_prologue.launches = 0
qkv_prologue.by_design = {"wgmma": 0, "wmma": 0}
adamw_epilogue.launches = 0
KERNEL_WRAPPERS = (qkv_prologue, adamw_epilogue)


def maybe_fused_epilogue(optimizer, grads, opt_state, params, *, clip_scale, finite):
    """Run the fused AdamW epilogue if ``optimizer`` opted in and the state
    has the layout the kernel knows; else None and the caller takes the
    plain optimizer path. Replaces the clip multiply -> update -> apply ->
    non-finite hold tail of ``unified_step``'s epilogue; mean, unscale and
    global norm stay with the caller. Updates params and ``opt_state`` in
    place (and scales ``grads`` in place by ``clip_scale``); returns
    (params, opt_state)."""
    hp = getattr(optimizer, "hyperparams", None)
    if not isinstance(hp, dict) or not getattr(optimizer, "fused", False):
        return None
    if not (isinstance(opt_state, dict) and set(opt_state) == {"count", "mu", "nu"}
            and params and set(opt_state["mu"]) == set(params) == set(opt_state["nu"])
            and set(grads) >= set(params)):
        return None
    names = list(params)
    tensors = [t for n in names for t in (params[n], grads[n], opt_state["mu"][n],
                                          opt_state["nu"][n])]
    if not all(t.dtype == torch.float32 for t in tensors):
        return None  # the bitwise contract is scoped to fp32 trees
    if clip_scale is not None:
        # the clip multiply stays outside the kernel, where the unfused
        # chain applies it: folded in, a compiler may contract it with the
        # moment products into an fma, a 1-ulp change (reference :410-414)
        for n in names:
            grads[n].mul_(clip_scale)
    count = opt_state["count"]
    step_size = -optimizer.lr_at(count)  # the schedule sees the old count
    row = epilogue_scalars(hp["b1"], hp["b2"], count + 1, step_size, bool(finite),
                           params[names[0]].device)
    adamw_epilogue(
        [grads[n] for n in names], [params[n].detach() for n in names],
        [opt_state["mu"][n] for n in names], [opt_state["nu"][n] for n in names], row,
        b1=hp["b1"], b2=hp["b2"], eps=hp["eps"], eps_root=hp["eps_root"],
        weight_decay=hp["weight_decay"],
    )
    if finite:  # a held step does not advance the count
        opt_state["count"] = count + 1
    return params, opt_state
