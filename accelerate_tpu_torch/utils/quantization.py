"""Int8 / int4 weight-only quantization: the frozen base of QLoRA.

Port of ``accelerate_tpu/utils/quantization.py`` (``QuantizationConfig``
:38, ``QuantizedTensor`` :68, ``quantize_tensor`` :138, ``quantize_params``
:195, ``dequantize_tree`` :230, ``quantized_apply`` :254). A quantized
model is the same module fed a state dict whose weight entries are
:class:`QuantizedTensor`s (int8 codes and fp32 scales);
:func:`dequantize_tree` turns them back into dense tensors of the compute
dtype before the forward (``torch.func.functional_call``). Formats, as in
the reference:

* **int8**: symmetric absmax per output channel, one scale a column;
* **int4**: symmetric absmax per ``block_size`` group along the reduction
  dim, two codes packed per byte.

The codes describe a matrix in the reference's ``(..., in, out)`` layout.
An ``nn.Linear`` weight is ``(out, in)``: :func:`quantize_params` quantizes
its transpose and marks the result ``transposed``, so the codes of
``layers.0.attn.q_proj.weight`` are the reference's codes of
``layers/attn/q_proj/kernel[0]`` and ``dequantize`` gives back ``(out,
in)``. Every quotient divides tensor by tensor: PyTorch's CUDA division by
a host scalar multiplies by its reciprocal, which is not the reference's
correctly rounded quotient.

``load_and_quantize_model`` streams a checkpoint through ``big_modeling``
and ``hf_interop``, which are not ported yet: it raises naming its queue
item (ROADMAP.md, A8).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import torch

from ..logging import get_logger

logger = get_logger(__name__)


@dataclass
class QuantizationConfig:
    """The reference's ``BnbQuantizationConfig`` shape."""

    load_in_8bit: bool = False
    load_in_4bit: bool = False
    # name substrings kept un-quantized (lm_head and the embeddings are
    # accuracy-critical; an embedding gather gains nothing from int8)
    skip_modules: list[str] = field(
        default_factory=lambda: ["embed", "lm_head", "norm", "router", "bias"])
    compute_dtype: Any = torch.bfloat16
    int4_block_size: int = 64
    # leaves with fewer elements than this stay un-quantized
    min_weight_size: int = 2**12

    def __post_init__(self):
        if self.load_in_8bit and self.load_in_4bit:
            raise ValueError("choose one of load_in_8bit / load_in_4bit")
        if not (self.load_in_8bit or self.load_in_4bit):
            raise ValueError("set load_in_8bit or load_in_4bit")
        if self.int4_block_size % 2:
            raise ValueError("int4_block_size must be even")

    @property
    def bits(self) -> int:
        return 8 if self.load_in_8bit else 4


class QuantizedTensor:
    """Int codes and their scales. ``codes``: int8, in the ``(..., in,
    out)`` layout of ``shape``; for 4 bits two nibbles are packed per byte
    along ``in``. ``scales``: fp32, ``(..., 1, out)`` for int8 and ``(...,
    blocks, out)`` for int4. ``transposed``: the dense tensor is ``shape``
    with its last two axes swapped (an ``nn.Linear`` weight)."""

    def __init__(self, codes: torch.Tensor, scales: torch.Tensor, bits: int, shape,
                 block_size: int = 0, transposed: bool = False):
        self.codes = codes
        self.scales = scales
        self.bits = int(bits)
        self.shape = tuple(shape)
        self.block_size = int(block_size)
        self.transposed = bool(transposed)

    @property
    def dtype(self) -> torch.dtype:  # the dense tensor's dtype
        return self.scales.dtype

    @property
    def device(self) -> torch.device:
        return self.codes.device

    @property
    def nbytes(self) -> int:
        return int(self.codes.nbytes + self.scales.nbytes)

    def to(self, device) -> "QuantizedTensor":
        return QuantizedTensor(self.codes.to(device), self.scales.to(device), self.bits,
                               self.shape, self.block_size, self.transposed)

    def dequantize(self, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        dtype = dtype or self.scales.dtype
        if self.bits == 8:
            out = (self.codes.float() * self.scales).to(dtype)
        else:
            # unpack the nibbles, low then high, along the reduction dim; the
            # shifts on int8 are arithmetic, so each nibble is sign-extended
            low = torch.bitwise_right_shift(torch.bitwise_left_shift(self.codes, 4), 4)
            high = torch.bitwise_right_shift(self.codes, 4)
            lead, (k2, out_dim) = self.codes.shape[:-2], self.codes.shape[-2:]
            codes = torch.stack([low, high], dim=-2).reshape(*lead, k2 * 2, out_dim)
            blocks = codes.shape[-2] // self.block_size
            grouped = codes.reshape(*lead, blocks, self.block_size, out_dim)
            deq = grouped.float() * self.scales[..., :, None, :]
            out = deq.reshape(self.shape).to(dtype)
        return out.transpose(-1, -2) if self.transposed else out

    def __repr__(self) -> str:
        return f"QuantizedTensor(int{self.bits}, shape={self.shape}, nbytes={self.nbytes})"


def _div(x: torch.Tensor, d: float) -> torch.Tensor:
    return x / torch.full_like(x, d)


def quantize_tensor(w: Any, bits: int = 8, block_size: int = 64,
                    dtype: torch.dtype = torch.float32) -> QuantizedTensor:
    """Symmetric absmax quantization of one weight of >= 2 dims in the
    ``(..., in, out)`` layout."""
    w = torch.as_tensor(w).float()
    if w.dim() < 2:
        raise ValueError(f"quantize_tensor needs >=2 dims, got {tuple(w.shape)}")
    if bits == 8:
        absmax = w.abs().amax(dim=-2, keepdim=True)  # one scale an output column
        scale = torch.where(absmax > 0, _div(absmax, 127.0), torch.ones_like(absmax))
        codes = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
        return QuantizedTensor(codes, scale.to(dtype), 8, w.shape)
    if bits == 4:
        k = w.shape[-2]
        if k % 2:
            # nibble packing needs an even reduction dim: int8 instead
            logger.debug(f"odd reduction dim {k}: falling back to int8")
            return quantize_tensor(w, 8, block_size, dtype)
        if k % block_size:
            block_size = _largest_even_divisor(k, block_size)
        lead, out_dim = w.shape[:-2], w.shape[-1]
        blocks = k // block_size
        grouped = w.reshape(*lead, blocks, block_size, out_dim)
        absmax = grouped.abs().amax(dim=-2)  # (..., blocks, out)
        scale = torch.where(absmax > 0, _div(absmax, 7.0), torch.ones_like(absmax))
        codes = torch.clamp(torch.round(grouped / scale[..., :, None, :]), -7, 7)
        pairs = codes.to(torch.int8).reshape(*lead, k // 2, 2, out_dim)
        packed = torch.bitwise_or(torch.bitwise_and(pairs[..., 0, :], 0x0F),
                                  torch.bitwise_left_shift(pairs[..., 1, :], 4))
        return QuantizedTensor(packed.to(torch.int8), scale.to(dtype), 4, w.shape, block_size)
    raise ValueError(f"unsupported bits {bits}; use 8 or 4")


def _largest_even_divisor(k: int, upper: int) -> int:
    for b in range(min(upper, k), 1, -1):
        if k % b == 0 and b % 2 == 0:
            return b
    return 2 if k % 2 == 0 else 1


def is_quantized(leaf: Any) -> bool:
    return isinstance(leaf, QuantizedTensor)


def _is_linear_weight(name: str, leaf: torch.Tensor) -> bool:
    """An ``nn.Linear`` weight, stored ``(out, in)``: the port's projections
    are named ``<module>.weight``; the MoE expert stacks ``(E, in, out)``
    are not."""
    return name.endswith(".weight") and leaf.dim() == 2


def quantize_params(params: Any, config: QuantizationConfig) -> dict:
    """Quantize every eligible weight of a state dict (a module's
    parameters, or a name -> tensor dict, or a nested one); returns a new
    dict of the same shape with :class:`QuantizedTensor`s in place of the
    eligible tensors (detached). Eligible: floating, >= 2 dims, at least
    ``min_weight_size`` elements, and no ``skip_modules`` substring in its
    name (the reference's keep-in-fp32 rule). The size gate reads each
    tensor as stored: the port keeps one tensor a layer where the
    reference's scanned tree stacks the layers."""

    quantized, total = 0, 0

    def convert(name, leaf):
        nonlocal quantized, total
        total += 1
        eligible = (isinstance(leaf, torch.Tensor) and leaf.dim() >= 2
                    and leaf.is_floating_point() and leaf.numel() >= config.min_weight_size
                    and not any(s in name for s in config.skip_modules))
        if not eligible:
            return leaf
        quantized += 1
        w = leaf.detach()
        if _is_linear_weight(name, w):
            q = quantize_tensor(w.t(), config.bits, config.int4_block_size)
            q.transposed = True
            return q
        return quantize_tensor(w, config.bits, config.int4_block_size)

    def walk(tree, prefix=""):
        if isinstance(tree, torch.nn.Module):
            tree = dict(tree.named_parameters())
        return {k: walk(v, f"{prefix}{k}.") if isinstance(v, dict) else convert(f"{prefix}{k}", v)
                for k, v in tree.items()}

    out = walk(params)
    logger.info(f"quantized {quantized}/{total} leaves to int{config.bits}")
    return out


def dequantize_tree(params: Any, dtype: Optional[torch.dtype] = None) -> Any:
    """Every :class:`QuantizedTensor` of a (nested) dict dequantized to
    ``dtype`` (None: its scales' dtype, fp32); other leaves as they are."""
    if isinstance(params, dict):
        return {k: dequantize_tree(v, dtype) for k, v in params.items()}
    if is_quantized(params):
        return params.dequantize(dtype)
    return params


def quantized_apply(module: torch.nn.Module, qparams: Any, *args, dtype=None, **kwargs):
    """``module(*args, **kwargs)`` with its parameters taken from ``qparams``
    dequantized to ``dtype`` (the weight-only inference entry): a
    ``torch.func.functional_call`` over the dequantized state dict."""
    return torch.func.functional_call(module, dequantize_tree(qparams, dtype), args, kwargs)


def load_and_quantize_model(*args, **kwargs):
    """Streams a checkpoint and quantizes it tensor by tensor in the
    reference; that needs ``big_modeling`` and ``hf_interop``."""
    raise NotImplementedError(
        "load_and_quantize_model is not ported yet: it needs big_modeling and hf_interop "
        "(ROADMAP.md, queue A8)")
