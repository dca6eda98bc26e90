"""The LoRA delta that training and serving share.

Port of ``accelerate_tpu/adapters/runtime.py`` (``LoraState`` :41,
``lora_delta`` :71, ``stack_adapter`` :97, ``pad_rank`` :105,
``empty_stacks`` :118, ``write_adapter_row`` :140). The adapter
contribution is computed the same way whether the adapter tree is a
differentiated capacity-1 stack (training) or one row of a resident
multi-adapter stack (serving)::

    delta(x) = scale[id] * ((dropout(x) @ A[id]) @ B[id])

``A``/``B`` live in fixed-capacity stacks ``(L, A_cap, in, r)`` /
``(L, A_cap, r, out)`` and ``id`` is per batch row data. Row 0 is the
all-zero identity adapter (a row without an adapter gathers zeros), and an
adapter of rank ``r < r_max`` pads A's columns and B's rows with zeros.

One change of idiom from the reference: :func:`write_adapter_row` writes
the row in place (``copy_`` into the resident stacks) and returns the same
tensors. The serving engine's decode step is a CUDA graph that reads the
stacks where they are, so a load or an eviction must change their
contents, never rebind them.

Model-free (nothing from ``..models``), so ``models/transformer.py`` can
import it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Optional

import torch

#: key names inside a per-target adapter pair
A_KEY = "lora_a"
B_KEY = "lora_b"


@dataclass
class LoraState:
    """What the forward needs to apply adapters.

    ``stacks``: ``{target: {"lora_a": (L, A, in, r), "lora_b": (L, A, r,
    out)}}``. ``slot_ids``: ``(B,)`` int64 or int32, the stack row each
    batch row reads (0: the identity adapter). ``scales``: ``(A,)`` fp32,
    ``alpha / rank`` a row. Dropout falls on the delta's input when
    ``dropout_rate > 0`` and not ``deterministic``; its masks are drawn
    from ``dropout_seed`` (the reference's per-step ``dropout_seed``), one
    generator a layer and target, so a recompute under remat draws the
    same masks. ``presplit``: under tensor parallelism the stacks hold this
    rank's share already (a serving registry split by
    :meth:`~.registry.AdapterRegistry.split_tp`), so the delta cuts
    nothing."""

    stacks: Any
    slot_ids: torch.Tensor
    scales: torch.Tensor
    dropout_rate: float = 0.0
    deterministic: bool = True
    dropout_seed: Optional[int] = None
    presplit: bool = False

    def context(self) -> "LoraState":
        """Everything but the stacks."""
        return dataclasses.replace(self, stacks=None)

    def layer(self, i: int) -> "LayerLora":
        """Layer ``i``'s slice: its ``(A, in, r)``/``(A, r, out)`` pair a
        target, with the shared slot ids, scales and dropout settings."""
        pairs = {t: (pair[A_KEY][i], pair[B_KEY][i]) for t, pair in self.stacks.items()}
        return LayerLora(pairs, self.slot_ids, self.scales, self.dropout_rate,
                         self.deterministic, self.dropout_seed, i, self.presplit)


@dataclass
class LayerLora:
    """One layer's adapters: ``pairs`` {target: (A, B)} with the stack row
    axis first."""

    pairs: dict
    slot_ids: torch.Tensor
    scales: torch.Tensor
    dropout_rate: float = 0.0
    deterministic: bool = True
    dropout_seed: Optional[int] = None
    layer: int = 0
    presplit: bool = False

    def only(self, targets) -> Optional["LayerLora"]:
        """The same adapters restricted to ``targets``; None if none is
        adapted."""
        pairs = {t: p for t, p in self.pairs.items() if t in targets}
        return dataclasses.replace(self, pairs=pairs) if pairs else None

    def tensors(self) -> list[torch.Tensor]:
        """Every tensor the layer reads, in a fixed order (the inputs of a
        checkpointed layer)."""
        out = [t for pair in self.pairs.values() for t in pair]
        return out + [self.slot_ids, self.scales]

    def with_tensors(self, tensors) -> "LayerLora":
        """The same layer over ``tensors`` (in :meth:`tensors`' order)."""
        tensors = list(tensors)
        pairs = {t: (tensors[2 * i], tensors[2 * i + 1]) for i, t in enumerate(self.pairs)}
        return dataclasses.replace(self, pairs=pairs, slot_ids=tensors[-2], scales=tensors[-1])

    def delta(self, x: torch.Tensor, target: str, tp=None, cols: Optional[slice] = None,
              rows: Optional[slice] = None) -> Optional[torch.Tensor]:
        """The delta of projection ``target`` on its input ``x``, or None
        when the layer's adapters do not target it.

        Under tensor parallelism (``tp``, a ``parallel.runtime.
        TensorParallel``) the projection is split and so is its delta: a
        column-split projection's output holds ``cols`` of its features, so
        B keeps those columns; a row-split projection's input holds ``rows``
        of them, so A keeps those rows, and the delta is a partial sum that
        joins the projection's before the sum over tp. A and B are whole on
        every tp rank and enter through ``tp.copy``, whose backward sums
        each rank's share of their gradients over tp. Dropout draws its mask
        over the whole input and keeps ``rows`` of it, as one card would.
        ``presplit`` stacks hold the rank's rows of A and columns of B
        already."""
        pair = self.pairs.get(target)
        if pair is None:
            return None
        a, b = pair
        if self.presplit:
            rows = cols = None
        if tp is not None:
            a, b = tp.copy(a), tp.copy(b)
        if self.dropout_rate > 0.0 and not self.deterministic:
            x = _dropout(x, self.dropout_rate, self._seed(target),
                         None if rows is None else (a.shape[1], rows))
        if rows is not None:
            a = a[:, rows]
        if cols is not None:
            b = b[..., cols]
        return lora_delta(x, {A_KEY: a, B_KEY: b}, self.slot_ids, self.scales)

    def _seed(self, target: str) -> int:
        from .lora import ALL_TARGETS  # the target's index names its stream

        base = 0 if self.dropout_seed is None else int(self.dropout_seed)
        return (base * 1_000_003 + self.layer * 31 + ALL_TARGETS.index(target)) % (2**63)


def _dropout(x: torch.Tensor, rate: float, seed: int, part=None) -> torch.Tensor:
    """Inverted dropout as flax's ``nn.Dropout``: keep with probability
    ``1 - rate`` and scale the kept values by ``1 / (1 - rate)``. ``part``:
    ``(width, features)`` when ``x`` holds those features of a ``width``
    wide input, whose mask is drawn whole and cut."""
    g = torch.Generator(device=x.device).manual_seed(seed)
    shape = x.shape if part is None else x.shape[:-1] + (part[0],)
    keep = torch.rand(shape, generator=g, device=x.device) < 1.0 - rate
    if part is not None:
        keep = keep[..., part[1]]
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def lora_delta(x: torch.Tensor, pair: dict, slot_ids: torch.Tensor,
               scales: torch.Tensor) -> torch.Tensor:
    """The gathered low-rank delta of one projection: ``x`` (B, S, in),
    ``pair`` {"lora_a": (A, in, r), "lora_b": (A, r, out)}, ``slot_ids``
    (B,), ``scales`` (A,); returns (B, S, out) in ``x``'s dtype. Row b reads
    only stack row ``slot_ids[b]``: a gather, then two batched products."""
    a = pair[A_KEY].index_select(0, slot_ids).to(x.dtype)  # (B, in, r)
    b = pair[B_KEY].index_select(0, slot_ids).to(x.dtype)  # (B, r, out)
    s = scales.index_select(0, slot_ids).to(x.dtype)  # (B,)
    return torch.bmm(torch.bmm(x, a), b) * s[:, None, None]


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def stack_adapter(adapter_params: Any) -> Any:
    """An adapter tree ``{target: {lora_a: (L, in, r), lora_b: (L, r,
    out)}}`` as capacity-1 stacks ``(L, 1, ...)`` (views: gradients reach
    the adapter's own leaves), the training form."""
    return _tree_map(lambda leaf: leaf[:, None], adapter_params)


def pad_rank(arr: torch.Tensor, axis: int, r_max: int) -> torch.Tensor:
    """Zero-pad an adapter leaf's rank axis up to ``r_max``."""
    r = arr.shape[axis]
    if r > r_max:
        raise ValueError(f"adapter rank {r} exceeds registry max rank {r_max}")
    if r == r_max:
        return arr
    shape = list(arr.shape)
    shape[axis] = r_max - r
    return torch.cat([arr, arr.new_zeros(shape)], dim=axis)


def empty_stacks(target_shapes: dict[str, tuple[int, int]], num_layers: int, capacity: int,
                 rank: int, dtype: torch.dtype = torch.float32, device=None) -> dict:
    """All-zero fixed-capacity stacks: ``{target: {"lora_a": (L, cap, in,
    r), "lora_b": (L, cap, r, out)}}``; every row starts as the identity."""
    return {
        target: {
            A_KEY: torch.zeros((num_layers, capacity, in_dim, rank), dtype=dtype, device=device),
            B_KEY: torch.zeros((num_layers, capacity, rank, out_dim), dtype=dtype, device=device),
        }
        for target, (in_dim, out_dim) in target_shapes.items()
    }


@torch.no_grad()
def write_adapter_row(stacks: dict, slot: int, adapter_params: Any,
                      r_max: Optional[int] = None) -> dict:
    """Write one adapter into stack row ``slot`` in place, rank-padded;
    targets it does not carry are zeroed (identity). Returns ``stacks``,
    whose tensors are the same objects as before."""
    for target, pair in stacks.items():
        a_dst, b_dst = pair[A_KEY], pair[B_KEY]
        if adapter_params is not None and target in adapter_params:
            src = adapter_params[target]
            a = torch.as_tensor(src[A_KEY]).to(device=a_dst.device, dtype=a_dst.dtype)
            b = torch.as_tensor(src[B_KEY]).to(device=b_dst.device, dtype=b_dst.dtype)
            a_dst[:, slot].copy_(pad_rank(a, axis=-1, r_max=r_max or a_dst.shape[-1]))
            b_dst[:, slot].copy_(pad_rank(b, axis=-2, r_max=r_max or b_dst.shape[-2]))
        else:
            a_dst[:, slot].zero_()
            b_dst[:, slot].zero_()
    return stacks
