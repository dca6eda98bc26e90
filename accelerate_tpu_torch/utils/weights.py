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
moment tree of the same shape maps the same way. A LoRA adapter tree maps
to the same nested tree of tensors, untransposed.

``carry_from_jax(named, model, optimizer)`` builds the port's train-step
carry from the flat ``name -> array`` dict of a reference checkpoint
(``accelerate_tpu/checkpointing.py:70``, names joined by ``//``): the
params, optax ``adamw``'s ``count``/``mu``/``nu``, the step counters, the
fp16 loss scale and the unfused accumulation buffer. ``carry_to_jax(named,
like)`` goes the other way: the port's flat carry (``dist_checkpoint.
load_full_named`` of a directory the port saved) under the reference's
names, so that ``accelerate_tpu``'s ``load_state`` reads it.
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


_ADAPTER_TARGETS = ("q_proj", "k_proj", "v_proj", "o_proj", "gate_proj", "up_proj", "down_proj")
_ADAPTER_LEAVES = {"lora_a", "lora_b"}


def _is_adapter_tree(tree: Mapping[str, Any]) -> bool:
    return bool(tree) and all(
        name in _ADAPTER_TARGETS and isinstance(pair, Mapping) and set(pair) == _ADAPTER_LEAVES
        for name, pair in tree.items())


def params_from_jax(tree: Mapping[str, Any], cfg) -> dict[str, Any]:
    """flax ``CausalLM`` params (numpy or jax arrays) -> the port's state dict.
    An adapter tree (``{target: {"lora_a": (L, in, r), "lora_b": (L, r,
    out)}}``, ``accelerate_tpu/adapters/lora.py``), or its gradient, keeps
    its nesting and its layout, untransposed: the port's adapters multiply
    from the right as the reference's do."""
    if _is_adapter_tree(tree):
        return {name: {leaf: torch.from_numpy(np.array(value, dtype=np.float32, order="C"))
                       for leaf, value in pair.items()}
                for name, pair in tree.items()}
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
    its chain by its ``mu``. An fp16 run's ``loss_scale`` and an unfused
    accumulation's ``accum_grads`` and ``micro_step`` come along; a fused
    carry has neither counter nor buffer."""
    from ..optimizer import LossScaleState

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
    carry = {"params": params, "opt_state": state, "opt_step": int(np.asarray(named["opt_step"]))}
    if "micro_step" in named:
        carry["micro_step"] = int(np.asarray(named["micro_step"]))
    if any(k.startswith(f"accum_grads{_SEP}") for k in named):
        accum = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()}
        _copy_from_jax(named, "accum_grads", cfg, accum)
        carry["accum_grads"] = accum
    if f"loss_scale{_SEP}scale" in named:
        device = next(iter(params.values())).device
        carry["loss_scale"] = LossScaleState(
            scale=torch.tensor(np.asarray(named[f"loss_scale{_SEP}scale"]), dtype=torch.float32,
                               device=device),
            growth_count=int(np.asarray(named[f"loss_scale{_SEP}growth_count"])),
            fin_steps=int(np.asarray(named[f"loss_scale{_SEP}fin_steps"])))
    return carry


def _port_name(parts: list[str]) -> tuple[str, bool, bool]:
    """A reference parameter path (below ``params``) as the port's name
    (``{i}`` in place of a scanned layer's index), whether the leaf
    transposes, and whether the layers are scanned (stacked on axis 0)."""
    *mods, leaf = parts
    if leaf == "kernel":
        new, transpose = "weight", True
    elif leaf in ("scale", "embedding"):
        new, transpose = "weight", False
    elif leaf == "bias" or leaf in _EXPERT_STACKS:
        new, transpose = leaf, False
    else:
        raise ValueError(f"unknown flax parameter leaf {leaf!r}")
    scanned = bool(mods) and mods[0] == "layers"
    if scanned:
        mods = ["layers", "{i}", *mods[1:]]
    elif mods and _LAYER.match(mods[0]):
        mods = ["layers", _LAYER.match(mods[0]).group(1), *mods[1:]]
    return ".".join([*mods, new]), transpose, scanned


def _numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def carry_to_jax(named: Mapping[str, Any], like: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """The port's flat carry ``named`` (its ``//`` names: ``params//layers.0.
    attn.q_proj.weight``, ``opt_state//mu//...``, ``opt_state//count``, the
    counters, ``accum_grads//...``, ``loss_scale//...``) under the reference's
    names, one array for each name of ``like`` (the reference carry's
    ``flatten_tree``, or anything with its names, shapes and dtypes):
    weights transposed back to flax's (in, out), scanned layers stacked,
    every optax ``count`` from the port's one count, each array in ``like``'s
    dtype and checked against its shape."""
    out = {}
    for key, ref in like.items():
        parts = key.split(_SEP)
        src = None
        if parts[0] in ("params", "accum_grads"):
            src, below = parts[0], parts[1:]
        elif parts[0] == "opt_state" and len(parts) > 3 and parts[2] in ("mu", "nu"):
            src, below = f"opt_state{_SEP}{parts[2]}", parts[3:]
        if src is not None:
            name, transpose, scanned = _port_name(below)

            def leaf(i=None):
                arr = _numpy(named[f"{src}{_SEP}{name.format(i=i)}"]).astype(np.float32)
                return arr.T if transpose else arr

            value = np.stack([leaf(i) for i in range(ref.shape[0])]) if scanned else leaf()
        elif parts[0] == "opt_state" and parts[-1] == "count":
            value = _numpy(named[f"opt_state{_SEP}count"])
        elif key in named:  # opt_step, micro_step, loss_scale//<field>
            value = _numpy(named[key])
        else:
            raise KeyError(f"the port's carry has nothing for the reference's {key!r}")
        value = np.array(value, dtype=np.dtype(ref.dtype), order="C")
        if value.shape != tuple(ref.shape):
            raise ValueError(f"{key}: the port gives shape {value.shape}, the reference expects "
                             f"{tuple(ref.shape)}")
        out[key] = value
    return out
