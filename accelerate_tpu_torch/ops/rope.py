"""Rotary embedding frequencies, shared by the model and the fused prologue.

Port of ``accelerate_tpu/models/transformer.py:_scale_rope_freqs`` (:80)
and ``accelerate_tpu/ops/fused.py:rope_inv_freqs`` (:74).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..models.config import rope_type


def scale_rope_freqs(freqs: torch.Tensor, scaling: Optional[dict]) -> torch.Tensor:
    """HF-style rope frequency scaling of the inverse frequencies
    (``llama3`` as transformers' ``_compute_llama3_parameters``, ``linear``
    as position interpolation)."""
    rt = rope_type(scaling)
    if rt == "default":
        return freqs
    factor = float(scaling["factor"])
    if rt == "linear":
        return freqs / factor
    if rt == "llama3":
        low = float(scaling["low_freq_factor"])
        high = float(scaling["high_freq_factor"])
        old_len = float(scaling["original_max_position_embeddings"])
        wavelen = 2.0 * math.pi / freqs
        smooth = (old_len / wavelen - low) / (high - low)
        smoothed = (1.0 - smooth) * freqs / factor + smooth * freqs
        scaled = torch.where(wavelen > old_len / low, freqs / factor, freqs)
        is_medium = (wavelen <= old_len / low) & (wavelen >= old_len / high)
        return torch.where(is_medium, smoothed, scaled)
    raise ValueError(f"unsupported rope_scaling type {rt!r}")


def rope_inv_freqs(head_dim: int, theta: float, scaling: Optional[dict],
                   device=None) -> torch.Tensor:
    """(D/2,) fp32 inverse frequencies theta^(-2i/D), scaled."""
    exponent = torch.arange(0, head_dim, 2, dtype=torch.float32, device=device) / head_dim
    return scale_rope_freqs(1.0 / (theta ** exponent), scaling)
