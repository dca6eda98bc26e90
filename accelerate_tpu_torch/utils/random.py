"""Seeding, and the accelerator's own random stream.

Port of ``accelerate_tpu/utils/random.py`` (``set_seed`` :24,
``KeyChain`` :74) for one process. ``set_seed`` seeds Python's
``random``, numpy's global generator and torch's CPU and CUDA generators.
The reference's ``KeyChain`` splits JAX keys; here it holds an explicit
``torch.Generator`` that the accelerator owns, whose state goes into a
checkpoint through ``state_dict``/``load_state_dict``.
"""

from __future__ import annotations

import os
import random as _py_random

import numpy as np
import torch


def set_seed(seed: int, device_specific: bool = False) -> torch.Generator:
    """Seed python, numpy and torch (every CUDA device too); returns a fresh
    CPU ``torch.Generator`` seeded ``seed``. One process, so
    ``device_specific`` adds process index 0."""
    _py_random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)
    os.environ["PYTHONHASHSEED"] = str(seed)
    return torch.Generator().manual_seed(seed)


class KeyChain:
    """A seeded CPU ``torch.Generator`` whose state is checkpointable."""

    def __init__(self, seed: int = 0):
        self.generator = torch.Generator().manual_seed(seed)

    def state_dict(self) -> dict:
        return {"generator": self.generator.get_state()}

    def load_state_dict(self, state: dict) -> None:
        self.generator.set_state(state["generator"])
