"""Compute kernels: the attention entry point and its mask helper.

Port of ``accelerate_tpu/ops/__init__.py``. The hand-written Hopper
kernels (``flash_attention``, ``fused``) are built on their first CUDA
call, never at import; each name here is read from its module on first
use (PEP 562).
"""

from __future__ import annotations

import importlib

__all__ = ["dot_product_attention", "make_causal_mask"]


def __getattr__(name: str):
    if name not in __all__:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.attention"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
