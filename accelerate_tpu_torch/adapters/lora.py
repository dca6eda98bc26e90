"""LoRA/QLoRA training over the Llama-layout model.

Port of ``accelerate_tpu/adapters/lora.py`` (``ALL_TARGETS`` :33,
``LoraConfig`` :40, ``target_shapes`` :88, ``init_adapter`` :106,
``adapter_num_params`` :131, ``adapter_num_bytes`` :146,
``build_lora_state`` :153, ``lora_loss_fn`` :174, ``assert_adapter_only``
:218). Freeze the base, optionally int8/int4 through
:mod:`..utils.quantization`, and train low-rank ``A``/``B`` deltas on the
projections: the adapter tree is the only thing the optimizer sees.
:func:`lora_loss_fn` runs the model over the frozen base, dequantized to
the compute dtype and detached, so no base tensor takes part in autograd:
its gradient does not exist, rather than being zero, and no base gradient
buffer is allocated.

Adapter trees are ``{target: {"lora_a": (L, in, r), "lora_b": (L, r,
out)}}``: one leaf a target covers every layer, as in the reference's
scanned layout (``A`` multiplies from the right, ``x @ A``, so ``in`` comes
first; the port's ``nn.Linear`` weights are ``(out, in)`` but the adapter
keeps the reference's orientation).
"""

from __future__ import annotations

import functools

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from ..models.config import TransformerConfig
from .runtime import A_KEY, B_KEY, LoraState, stack_adapter

#: every module LoRA can target (the 7 Llama-layout projections)
ALL_TARGETS = (
    "q_proj", "k_proj", "v_proj", "o_proj",
    "gate_proj", "up_proj", "down_proj",
)


@dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    target_modules: tuple = ("q_proj", "v_proj")
    dropout: float = 0.0

    def __post_init__(self):
        if self.rank <= 0:
            raise ValueError(f"rank must be positive, got {self.rank}")
        if not (0.0 <= self.dropout < 1.0):
            raise ValueError(f"dropout must be in [0, 1), got {self.dropout}")
        object.__setattr__(self, "target_modules", tuple(self.target_modules))
        unknown = [t for t in self.target_modules if t not in ALL_TARGETS]
        if unknown:
            raise ValueError(f"unknown target_modules {unknown}; "
                             f"supported: {', '.join(ALL_TARGETS)}")
        if not self.target_modules:
            raise ValueError("target_modules must name at least one module")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank

    def to_dict(self) -> dict:
        return {"rank": self.rank, "alpha": self.alpha,
                "target_modules": list(self.target_modules), "dropout": self.dropout}

    @classmethod
    def from_dict(cls, d: dict) -> "LoraConfig":
        return cls(rank=int(d["rank"]), alpha=float(d["alpha"]),
                   target_modules=tuple(d["target_modules"]),
                   dropout=float(d.get("dropout", 0.0)))


def target_shapes(cfg: TransformerConfig) -> dict[str, tuple[int, int]]:
    """(in_features, out_features) of each targetable projection."""
    h = cfg.hidden_size
    q_dim = cfg.num_heads * cfg.head_dim
    kv_dim = cfg.num_kv_heads * cfg.head_dim
    f = cfg.intermediate_size
    return {
        "q_proj": (h, q_dim),
        "k_proj": (h, kv_dim),
        "v_proj": (h, kv_dim),
        "o_proj": (q_dim, h),
        "gate_proj": (h, f),
        "up_proj": (h, f),
        "down_proj": (f, h),
    }


def init_adapter(generator: torch.Generator, model_config: TransformerConfig,
                 lora_config: LoraConfig, dtype: torch.dtype = torch.float32) -> dict:
    """A fresh adapter on ``generator``'s device: A ~ N(0, 0.02), drawn
    target by target in ``lora_config.target_modules``' order, B = 0, so
    its delta is exactly zero and the adapted model starts at the base
    model's outputs bit for bit (the LoRA init contract)."""
    shapes = target_shapes(model_config)
    L, r = model_config.num_layers, lora_config.rank
    device = generator.device
    adapter = {}
    for t in lora_config.target_modules:
        in_dim, out_dim = shapes[t]
        a = torch.empty((L, in_dim, r), dtype=dtype, device=device)
        a.normal_(0.0, 0.02, generator=generator)
        adapter[t] = {A_KEY: a, B_KEY: torch.zeros((L, r, out_dim), dtype=dtype, device=device)}
    return adapter


def adapter_num_params(model_config: TransformerConfig, lora_config: LoraConfig) -> int:
    """``sum over targets of L * r * (in + out)``."""
    shapes = target_shapes(model_config)
    L, r = model_config.num_layers, lora_config.rank
    return sum(L * r * (shapes[t][0] + shapes[t][1]) for t in lora_config.target_modules)


def _leaves(tree: Any):
    if isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _leaves(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _leaves(value)
    elif tree is not None:
        yield tree


def adapter_num_bytes(tree: Any) -> int:
    """Bytes of every tensor (or array) leaf of a tree or a module."""
    total = 0
    for leaf in _leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        else:
            arr = np.asarray(leaf)
            total += arr.size * arr.dtype.itemsize
    return total


def build_lora_state(adapter_params: dict, lora_config: LoraConfig, batch_size: int,
                     deterministic: bool = True, dropout_seed: Optional[int] = None) -> LoraState:
    """One adapter tree as a capacity-1 :class:`LoraState`: every batch row
    reads stack row 0, the same gather the multi-tenant stacks take."""
    device = next(iter(_leaves(adapter_params))).device
    return LoraState(
        stacks=stack_adapter(adapter_params),
        slot_ids=torch.zeros((batch_size,), dtype=torch.long, device=device),
        scales=torch.tensor([lora_config.scaling], dtype=torch.float32, device=device),
        dropout_rate=lora_config.dropout,
        deterministic=deterministic,
        dropout_seed=dropout_seed,
    )


def lora_loss_fn(model, base_params: Any, lora_config: LoraConfig,
                 compute_dtype: Optional[torch.dtype] = None):
    """Next-token cross-entropy closure for ``Accelerator.unified_step``
    whose differentiated tree is the adapter, not the model.

    ``fn(adapter_params, batch)`` with batch {input_ids, [loss_mask],
    [dropout_seed]}. ``base_params``: the model's parameters (a module or a
    name -> tensor dict), plain or quantized (:func:`..utils.quantization.
    quantize_params`); quantized entries are dequantized to
    ``compute_dtype`` at each call, and every base tensor is detached. LoRA
    dropout runs only when the config asks for it and the batch carries a
    ``dropout_seed``."""
    from ..models.transformer import next_token_count, next_token_loss
    from ..utils.quantization import dequantize_tree

    if isinstance(base_params, torch.nn.Module):
        base_params = dict(base_params.named_parameters())

    def fn(adapter_params, batch):
        ids = batch["input_ids"]
        base = {k: v.detach() for k, v in dequantize_tree(base_params, compute_dtype).items()}
        use_dropout = lora_config.dropout > 0.0 and "dropout_seed" in batch
        state = build_lora_state(adapter_params, lora_config, ids.shape[0],
                                 deterministic=not use_dropout,
                                 dropout_seed=int(batch["dropout_seed"]) if use_dropout else None)
        logits = torch.func.functional_call(model, base, (ids,), {"lora": state})
        return next_token_loss(logits, batch, ring)

    ring = getattr(model.config, "attention_impl", None) == "ring"
    fn.fused_kernels = bool(getattr(model.config, "fused_kernels", False))
    # read by the step across processes: the loss is the global batch's
    fn.loss_weight = functools.partial(next_token_count, ring=ring)
    return fn


def assert_adapter_only(tree: Any, lora_config: LoraConfig) -> None:
    """Raise unless ``tree`` is exactly an adapter tree: the check that the
    optimizer carry holds only adapter leaves."""
    if not isinstance(tree, dict):
        raise AssertionError(f"adapter tree must be a dict, got {type(tree)}")
    extra = set(tree) - set(lora_config.target_modules)
    missing = set(lora_config.target_modules) - set(tree)
    if extra or missing:
        raise AssertionError(f"carry is not adapter-only: extra keys {sorted(extra)}, "
                             f"missing keys {sorted(missing)}")
    for t, pair in tree.items():
        keys = set(pair)
        if keys != {A_KEY, B_KEY}:
            raise AssertionError(f"target {t!r} must hold exactly {{lora_a, lora_b}}, "
                                 f"got {sorted(keys)}")
