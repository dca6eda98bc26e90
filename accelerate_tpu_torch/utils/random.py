"""Seeding, the accelerator's own random stream, and aligning the
processes' generators.

Port of ``accelerate_tpu/utils/random.py`` (``set_seed`` :24,
``synchronize_rng_state`` :39, ``synchronize_rng_states`` :63, ``KeyChain``
:74). ``set_seed`` seeds Python's ``random``, numpy's global generator and
torch's CPU and CUDA generators. The reference's ``KeyChain`` splits JAX
keys; here it holds an explicit ``torch.Generator`` that the accelerator
owns, whose state goes into a checkpoint through ``state_dict``/
``load_state_dict``. ``synchronize_rng_state`` broadcasts process 0's state
of a generator onto every process, through the process group.
"""

from __future__ import annotations

import os
import random as _py_random
from typing import Any, Iterable, Optional

import numpy as np
import torch

from .dataclasses import RNGType


def set_seed(seed: int, device_specific: bool = False) -> torch.Generator:
    """Seed python, numpy and torch (every CUDA device too); returns a fresh
    CPU ``torch.Generator`` seeded ``seed``. ``device_specific`` adds the
    process index first, so host-side draws differ by process."""
    if device_specific:
        from ..state import current_process_index

        seed += current_process_index()
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

    def fold_in(self, data: int) -> "KeyChain":
        """A new chain, seeded from this chain's state and ``data``: the
        same (state, data) gives the same chain, and distinct ``data``
        distinct chains. This chain is left as it was."""
        draw = torch.Generator().set_state(self.generator.get_state())
        base = int(torch.randint(0, 2**62, (1,), generator=draw))
        chain = KeyChain()
        chain.generator.manual_seed((base + 0x9E3779B97F4A7C15 * (data + 1)) % 2**63)
        return chain


def synchronize_rng_state(rng_type: Optional[RNGType] = None, generator: Any = None):
    """Process 0's state of a generator on every process (reference :39):
    ``python`` and ``numpy`` (both when ``rng_type`` is None), ``torch``
    (the global CPU generator), or ``generator``: a ``torch.Generator`` or a
    :class:`KeyChain`, set in place. Returns ``generator``."""
    from .operations import broadcast_object_list

    rng_type = None if rng_type is None else RNGType(rng_type)
    if rng_type in (RNGType.PYTHON, None):
        _py_random.setstate(broadcast_object_list([_py_random.getstate()])[0])
    if rng_type in (RNGType.NUMPY, None):
        np.random.set_state(broadcast_object_list([np.random.get_state()])[0])
    if rng_type == RNGType.TORCH:
        torch.set_rng_state(broadcast_object_list([torch.get_rng_state()])[0])
    if rng_type == RNGType.GENERATOR and generator is not None:
        if isinstance(generator, KeyChain):
            generator.load_state_dict(broadcast_object_list([generator.state_dict()])[0])
        else:
            generator.set_state(broadcast_object_list([generator.get_state()])[0])
    return generator


def synchronize_rng_states(rng_types: Iterable[str | RNGType], generator: Any = None):
    """``synchronize_rng_state`` for each of ``rng_types`` (reference :63)."""
    for rng_type in rng_types:
        synchronize_rng_state(RNGType(rng_type), generator)
    return generator
