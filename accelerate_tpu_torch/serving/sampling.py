"""Per-slot sampling for the continuous decode batch.

Port of ``accelerate_tpu/serving/sampling.py`` (``sample_tokens`` :20,
``SlotSampling`` :44). Slots carry different requests, so temperature is a
(B,) tensor (a slot's value changes at admission without rebuilding the
decode step) while top-k/top-p stay engine-wide.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..models.generation import _filter_logits, _gumbel_argmax


def sample_tokens(logits: torch.Tensor, generator: torch.Generator, temperature: torch.Tensor,
                  top_k: Optional[int] = None, top_p: Optional[float] = None) -> torch.Tensor:
    """(B, V) logits + (B,) per-slot temperatures -> (B,) token ids.

    Rows with ``temperature == 0`` are the argmax, as in the reference.
    Every call draws one noise row per slot from ``generator`` whatever the
    temperatures, so a slot's draw is its own row of that call's noise and
    never depends on which requests share the batch. Gumbel-max samples
    without ``torch.multinomial``, so an idle or fully masked row cannot
    fire a device assert."""
    greedy = torch.argmax(logits, dim=-1)
    safe_t = temperature.clamp_min(1e-6)[:, None]
    scaled = _filter_logits(logits.float() / safe_t, top_k, top_p)
    sampled = _gumbel_argmax(scaled, generator)
    return torch.where(temperature > 0, sampled, greedy)


class SlotSampling:
    """Host mirror of per-slot temperatures, with the device copy kept
    until a slot changes."""

    def __init__(self, max_slots: int, device):
        self._temperature = np.zeros(max_slots, np.float32)
        self._device = torch.device(device)
        self._copy: Optional[torch.Tensor] = None

    def set_slot(self, index: int, temperature: float) -> None:
        self._temperature[index] = temperature
        self._copy = None

    def clear_slot(self, index: int) -> None:
        self.set_slot(index, 0.0)

    def temperatures(self) -> torch.Tensor:
        if self._copy is None:
            self._copy = torch.from_numpy(self._temperature.copy()).to(self._device)
        return self._copy
