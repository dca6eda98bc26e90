"""Carry a flax parameter tree of the JAX package over to the port.

``params_from_jax(tree, cfg)`` maps the reference ``CausalLM``'s tree —
layers scanned (one ``layers`` subtree whose leaves carry a leading
``num_layers`` axis) or unrolled (``layer_<i>`` subtrees) — onto the
port's ``CausalLM`` state dict, ready for ``load_state_dict(strict=True)``.
Leaf names map ``kernel`` -> ``weight`` transposed from flax's (in, out) to
torch's (out, in), ``scale`` and ``embedding`` -> ``weight``, ``bias`` ->
``bias``. A gradient tree of the same shape maps the same way.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"layer_(\d+)$")


def _leaf(name: str, value) -> tuple[str, np.ndarray]:
    arr = np.asarray(value, dtype=np.float32)
    if name == "kernel":
        return "weight", arr.T
    if name in ("scale", "embedding"):
        return "weight", arr
    if name == "bias":
        return "bias", arr
    raise ValueError(f"unknown flax parameter leaf {name!r}")


def _flatten(tree: Mapping, prefix: str, out: dict, layer=None) -> None:
    for name, value in tree.items():
        if isinstance(value, Mapping):
            _flatten(value, f"{prefix}{name}.", out, layer)
        else:
            if layer is not None:
                value = np.asarray(value)[layer]
            key, arr = _leaf(name, value)
            out[prefix + key] = arr


def params_from_jax(tree: Mapping[str, Any], cfg) -> dict[str, torch.Tensor]:
    """flax ``CausalLM`` params (numpy or jax arrays) -> the port's state dict."""
    flat: dict[str, np.ndarray] = {}
    for name, sub in tree.items():
        match = _LAYER.match(name)
        if name == "layers":  # scanned: slice every leaf's layer axis
            for i in range(cfg.num_layers):
                _flatten(sub, f"layers.{i}.", flat, layer=i)
        elif match:
            _flatten(sub, f"layers.{match.group(1)}.", flat)
        else:
            _flatten(sub, f"{name}.", flat)
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in flat.items()}
