"""Carry a flax parameter tree, or a training state, of the JAX package
over to the port.

``params_from_jax(tree, cfg)`` maps the reference ``CausalLM``'s or
``SequenceClassifier``'s tree — layers scanned (one ``layers`` subtree
whose leaves carry a leading ``num_layers`` axis) or unrolled
(``layer_<i>`` subtrees) — onto the port's state dict, ready for
``load_state_dict(strict=True)``; top-level modules (``pooler``,
``classifier``) map by the same rule. Leaf names map ``kernel`` ->
``weight`` transposed from flax's (in, out) to torch's (out, in),
``scale`` and ``embedding`` -> ``weight``, ``bias`` -> ``bias``. The MoE
block's expert stacks (``moe/gate_proj``, ``up_proj``, ``down_proj``: raw
(E, in, out) params with no ``kernel`` leaf) keep their names and layout,
untransposed; its router is a ``Dense`` like any other. A gradient or
moment tree of the same shape maps the same way.

``carry_from_jax(named, model, optimizer)`` builds the port's train-step
carry from the flat ``name -> array`` dict of a reference checkpoint
(``accelerate_tpu/checkpointing.py:70``, names joined by ``//``): the
params, optax ``adamw``'s ``count``/``mu``/``nu`` and the step counters.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

_LAYER = re.compile(r"layer_(\d+)$")
_EXPERT_STACKS = ("gate_proj", "up_proj", "down_proj")


def _leaf(name: str, value) -> tuple[str, np.ndarray]:
    arr = np.asarray(value, dtype=np.float32)
    if name == "kernel":
        if arr.ndim != 2:
            raise ValueError(f"a Dense kernel of shape {arr.shape}: only 2-D kernels transpose")
        return "weight", arr.T
    if name in ("scale", "embedding"):
        return "weight", arr
    if name == "bias":
        return "bias", arr
    if name in _EXPERT_STACKS and arr.ndim == 3:  # (E, in, out), as the port keeps it
        return name, arr
    raise ValueError(f"unknown flax parameter leaf {name!r} of shape {arr.shape}")


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


_SEP = "//"


def _nest(named: Mapping[str, Any], prefix: str) -> dict:
    """The subtree of flat ``named`` under ``prefix``, as nested dicts."""
    tree: dict = {}
    for key, value in named.items():
        if not key.startswith(prefix + _SEP):
            continue
        *path, leaf = key[len(prefix) + len(_SEP):].split(_SEP)
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = value
    return tree


def _copy_from_jax(named: Mapping[str, Any], prefix: str, cfg,
                   target: dict[str, torch.Tensor]) -> None:
    state = params_from_jax(_nest(named, prefix), cfg)
    if set(state) != set(target):
        raise KeyError(f"{prefix}: the checkpoint's names {sorted(set(state) ^ set(target))} "
                       "do not match the model's")
    with torch.no_grad():
        for name, t in target.items():
            t.copy_(state[name])


def carry_from_jax(named: Mapping[str, Any], model: torch.nn.Module, optimizer) -> dict:
    """The port's carry from a reference checkpoint's flat tensors (for
    example ``dist_checkpoint.load_full_named`` of a directory the
    reference's ``save_state`` wrote): the model's parameters and the
    prepared ``optimizer``'s moments receive the saved values in place;
    optax's ``ScaleByAdamState`` (``count``, ``mu``, ``nu``) is found in
    its chain by its ``mu``. Loss-scale and accumulation state are not
    carried over."""
    if any(k.startswith(("loss_scale", "accum_grads")) for k in named):
        raise NotImplementedError("carrying fp16 loss-scale or accumulation state over from "
                                  "the reference is not ported yet (ROADMAP.md, queue A6)")
    cfg = model.config
    params = dict(model.named_parameters())
    _copy_from_jax(named, "params", cfg, params)
    adam = sorted({k.split(_SEP)[1] for k in named
                   if k.startswith(f"opt_state{_SEP}") and f"{_SEP}mu{_SEP}" in k})
    if len(adam) != 1:
        raise KeyError(f"expected one optax ScaleByAdamState in opt_state, found {adam}")
    prefix = f"opt_state{_SEP}{adam[0]}"
    if optimizer.opt_state is None:
        optimizer.init(params)
    state = optimizer.opt_state
    _copy_from_jax(named, f"{prefix}{_SEP}mu", cfg, state["mu"])
    _copy_from_jax(named, f"{prefix}{_SEP}nu", cfg, state["nu"])
    state["count"] = int(np.asarray(named[f"{prefix}{_SEP}count"]))
    return {"params": params, "opt_state": state,
            "opt_step": int(np.asarray(named["opt_step"])),
            "micro_step": int(np.asarray(named["micro_step"]))}
