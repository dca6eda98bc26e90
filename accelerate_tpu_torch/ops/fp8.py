"""FP8 training ops: e4m3 forward and e5m2 backward products with
per-tensor scales.

Port of ``accelerate_tpu/ops/fp8.py``: ``E4M3_MAX``/``E5M2_MAX``,
``_scale_for`` (:38), ``quantize_fp8`` (:44), ``fp8_matmul`` (:51-99, a
``custom_vjp`` there, a ``torch.autograd.Function`` here), the delayed
scaling recipe (``DelayedScaleState``, ``init_delayed_state`` :116,
``update_delayed_state`` :125, ``fp8_matmul_delayed`` :170). The
reference's ``Fp8Dense`` (:218) and ``convert_model`` (:194) know the
model's layers, so the port keeps them beside ``Dense`` in
``models/transformer.py``; this module holds the products alone.

The forward quantises x and w to ``float8_e4m3fn`` with scales from their
current amax and multiplies the codes; the backward quantises the incoming
gradient to ``float8_e5m2`` and computes dx = g wq^T and dw = xq^T g from
the saved codes and scales alone. The reference multiplies in XLA (codes
cast up to bf16, fp32 accumulation), so the port's product is PyTorch's
fp8 GEMM, ``torch._scaled_mm``, on a CUDA tensor (the inverse scales passed
as fp32 device scalars: no host sync), and the reference's own formula,
its plain version, on a CPU tensor. There is no fallback: on a CUDA tensor
the fp8 GEMM runs or raises. ``scaled_mm.calls`` counts the calls of
the wrapper on CUDA tensors, which is not the count of GEMMs launched: a
product that a selective-checkpoint recompute takes from its cache still
calls the wrapper.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

E4M3_MAX = 448.0
E5M2_MAX = 57344.0
_EPS = 1e-12
_FMAX = {torch.float8_e4m3fn: E4M3_MAX, torch.float8_e5m2: E5M2_MAX}


def _scale_for(x: torch.Tensor, fmax: float) -> torch.Tensor:
    """Per-tensor scale s so that s * amax lands on the format's max (a
    0-d fp32 tensor on x's device)."""
    amax = torch.linalg.vector_norm(x, float("inf"), dtype=torch.float32)
    return _over(fmax, amax.clamp_min(_EPS))


def _over(fmax: float, t: torch.Tensor) -> torch.Tensor:
    """fmax / t, correctly rounded (``fmax / t`` in torch multiplies by the
    reciprocal, one rounding more than the reference's division)."""
    return torch.full_like(t, fmax) / t


def quantize_fp8(x: torch.Tensor, dtype: torch.dtype, scale: torch.Tensor) -> torch.Tensor:
    """clip(x * scale, -fmax, fmax) in fp32, cast to the fp8 ``dtype``."""
    fmax = _FMAX[dtype]
    return x.to(torch.float32, copy=True).mul_(scale).clamp_(-fmax, fmax).to(dtype)


def scaled_mm_reference(a, b, a_scale, b_scale, out_dtype):
    """The plain product of codes: a (M, k) and b (k, n) cast up (exact in
    fp32), multiplied with fp32 accumulation, divided by the product of
    their scales — the reference's formula."""
    out = torch.matmul(a.to(torch.float32), b.to(torch.float32)) / (a_scale * b_scale)
    return out.to(out_dtype)


def scaled_mm(a, b, a_scale, b_scale, out_dtype):
    """(a / a_scale) @ (b / b_scale) for fp8 codes a (M, k) and b (k, n):
    ``torch._scaled_mm`` on CUDA tensors (a row-major and b column-major,
    as it requires; k and n multiples of 16), the plain version on CPU
    tensors."""
    if not a.is_cuda:
        return scaled_mm_reference(a, b, a_scale, b_scale, out_dtype)
    a = a if a.stride(-1) == 1 else a.contiguous()
    b = b if b.stride(0) == 1 else b.t().contiguous().t()
    out = torch._scaled_mm(a, b, scale_a=a_scale.reciprocal(), scale_b=b_scale.reciprocal(),
                           out_dtype=out_dtype, use_fast_accum=False)
    scaled_mm.calls += 1
    return out


scaled_mm.calls = 0


class _Fp8Matmul(torch.autograd.Function):
    """x (..., k) @ w (k, n) on e4m3 codes with the given scales (None:
    current scaling); the backward quantises g to e5m2 with its current
    scale. Saves the codes and scales only."""

    @staticmethod
    def forward(ctx, x, w, xs, ws, out_dtype):
        xs = _scale_for(x, E4M3_MAX) if xs is None else xs
        ws = _scale_for(w, E4M3_MAX) if ws is None else ws
        xq = quantize_fp8(x.reshape(-1, x.shape[-1]), torch.float8_e4m3fn, xs)
        wq = quantize_fp8(w, torch.float8_e4m3fn, ws)
        out = scaled_mm(xq, wq, xs, ws, out_dtype)
        ctx.save_for_backward(xq, wq, xs, ws)
        ctx.x_shape, ctx.x_dtype, ctx.w_dtype = x.shape, x.dtype, w.dtype
        return out.reshape(*x.shape[:-1], w.shape[-1])

    @staticmethod
    def backward(ctx, g):
        xq, wq, xs, ws = ctx.saved_tensors
        g = g.reshape(-1, g.shape[-1])
        gs = _scale_for(g, E5M2_MAX)
        gq = quantize_fp8(g, torch.float8_e5m2, gs)
        dx = scaled_mm(gq, wq.t(), gs, ws, ctx.x_dtype)  # e5m2 x e4m3
        dw = scaled_mm(gq.t(), xq, gs, xs, ctx.w_dtype).t()  # e5m2 x e4m3, (n, k) -> (k, n)
        return dx.reshape(ctx.x_shape), dw, None, None, None


def fp8_matmul(x: torch.Tensor, w: torch.Tensor, out_dtype=torch.float32) -> torch.Tensor:
    """``x @ w`` with fp8 codes and current scaling: x (..., k), w (k, n)
    -> (..., n) in ``out_dtype`` (float32, as the reference returns). dx
    comes back in x's dtype and dw in w's."""
    return _Fp8Matmul.apply(x, w, None, None, out_dtype)


class DelayedScaleState(NamedTuple):
    """Per-tensor delayed-scaling state: ``amax_history`` (history_len,)
    fp32, newest first, and ``scale``, the 0-d fp32 scale the next product
    quantises with (from the history's max)."""

    amax_history: torch.Tensor
    scale: torch.Tensor


def init_delayed_state(history_len: int = 16, device=None) -> DelayedScaleState:
    """Empty history and the identity scale (the first step quantises
    unscaled)."""
    return DelayedScaleState(torch.zeros(history_len, dtype=torch.float32, device=device),
                             torch.ones((), dtype=torch.float32, device=device))


def update_delayed_state(state: DelayedScaleState, amax: torch.Tensor,
                         fmax: float = E4M3_MAX) -> DelayedScaleState:
    """Record one amax and recompute the scale from the rolled history; an
    all-zero history keeps the previous scale."""
    history = torch.roll(state.amax_history, 1)
    history[0] = amax.to(torch.float32)
    amax_r = history.max()
    scale = torch.where(amax_r > 0.0, _over(fmax, amax_r.clamp_min(_EPS)), state.scale)
    return DelayedScaleState(history, scale)


def fp8_matmul_delayed(x: torch.Tensor, w: torch.Tensor, x_state: DelayedScaleState,
                       w_state: DelayedScaleState, out_dtype=torch.float32):
    """``x @ w`` in fp8 with the scales the states' histories chose; the
    observed amaxes fold into the returned next states. Gradients keep
    current scaling in e5m2."""
    out = _Fp8Matmul.apply(x, w, x_state.scale, w_state.scale, out_dtype)
    with torch.no_grad():
        amax_x = torch.linalg.vector_norm(x, float("inf"), dtype=torch.float32)
        amax_w = torch.linalg.vector_norm(w, float("inf"), dtype=torch.float32)
    return out, update_delayed_state(x_state, amax_x), update_delayed_state(w_state, amax_w)

