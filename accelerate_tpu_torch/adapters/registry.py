"""Host-side residency manager for the multi-tenant serving stacks.

Port of ``accelerate_tpu/adapters/registry.py:AdapterRegistry`` (:26). The
registry owns the resident adapter stacks the serving engine's programs
read: ``{target: {"lora_a": (L, rows, in, r_max), "lora_b": (L, rows,
r_max, out)}}`` and a ``(rows,)`` scale vector, allocated once on
``device``. Row 0 is always the all-zero identity adapter; rows
1..capacity hold tenants. ``load`` and ``evict`` write rows of these
tensors in place (:func:`.runtime.write_adapter_row`), so their shapes and
their memory never change: a decode step captured as a CUDA graph reads
every later load where it was made. Names, slots, refcounts and the LRU
order are host bookkeeping.

Under tensor parallelism (an engine over a model split over tp) the stacks
hold one rank's share (:meth:`AdapterRegistry.split_tp`): B's output
columns of a column-split projection, A's input rows of a row-split one,
as ``LayerLora.delta`` cuts them for training. A load writes its share of
the adapter into them in place, as it writes a whole row otherwise.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..models.config import TransformerConfig
from ..state import resolve_device
from .lora import ALL_TARGETS, LoraConfig, target_shapes
from .runtime import A_KEY, B_KEY, empty_stacks, write_adapter_row


class AdapterRegistry:
    """Load, evict and refcount resident adapters over fixed-capacity stacks.

    ``capacity``: tenants resident at once (the identity row is extra).
    ``max_rank``: the stacks' rank; smaller adapters are zero-padded.
    ``target_modules``: the projections the stacks cover; an adapter may
    target any subset. ``device``: where the stacks live, CUDA unless the
    caller passes ``"cpu"`` (the engine's model must be on the same
    device)."""

    def __init__(self, model_config: TransformerConfig, capacity: int = 4, max_rank: int = 8,
                 target_modules: tuple = ("q_proj", "v_proj"),
                 dtype: torch.dtype = torch.float32, device=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        unknown = [t for t in target_modules if t not in ALL_TARGETS]
        if unknown:
            raise ValueError(f"unknown target_modules {unknown}; "
                             f"supported: {', '.join(ALL_TARGETS)}")
        self.model_config = model_config
        self.capacity = int(capacity)
        self.max_rank = int(max_rank)
        self.target_modules = tuple(target_modules)
        self.device = resolve_device(cpu=False) if device is None else torch.device(device)
        shapes = target_shapes(model_config)
        self._stacks = empty_stacks({t: shapes[t] for t in self.target_modules},
                                    num_layers=model_config.num_layers,
                                    capacity=self.capacity + 1,  # + the identity row 0
                                    rank=self.max_rank, dtype=dtype, device=self.device)
        self._scales = torch.zeros((self.capacity + 1,), dtype=torch.float32, device=self.device)
        self._slots: dict[str, int] = {}  # name -> row (1..capacity)
        self._refcounts: dict[str, int] = {}
        self._lru: list[str] = []  # least recent first
        self.load_total = 0
        self.evict_total = 0
        #: {target: (leaf, slice)} when the stacks hold one tp rank's share
        self.tp_slices: Optional[dict] = None

    def split_tp(self, slices: dict) -> None:
        """Keep only one tensor-parallel rank's share of every stack:
        ``slices`` maps each target to ``("lora_b", columns)`` (a
        column-split projection) or ``("lora_a", rows)`` (a row-split one),
        ``models.transformer.tp_adapter_slices``. The resident rows keep
        their share. Done once, before any program reads the stacks (the
        tensors are new); the same split again is a no-op."""
        if self.tp_slices is not None:
            if self.tp_slices != slices:
                raise ValueError("the registry's stacks are split for another tp rank")
            return
        for target, pair in self._stacks.items():
            leaf, part = slices[target]
            pair[leaf] = _cut(pair[leaf], leaf, part).contiguous()
        self.tp_slices = dict(slices)

    def _share(self, adapter_params: dict) -> dict:
        """An adapter tree cut to the stacks' tp share (whole when they are
        whole)."""
        if self.tp_slices is None:
            return adapter_params
        out = {}
        for target, pair in adapter_params.items():
            leaf, part = self.tp_slices[target]
            out[target] = {**pair, leaf: _cut(torch.as_tensor(pair[leaf]), leaf, part)}
        return out

    # ------------------------------------------------------------------ #
    # residency
    # ------------------------------------------------------------------ #
    def load(self, name: str, adapter_params: dict, config: LoraConfig) -> int:
        """Make ``name`` resident; returns its stack row. Loading a resident
        name again overwrites its row. When full, the least recently used
        tenant with no request in flight is evicted; if every row is pinned,
        raises RuntimeError."""
        self._validate(name, adapter_params, config)
        if name in self._slots:
            slot = self._slots[name]
        else:
            slot = self._free_slot()
            self._slots[name] = slot
            self._refcounts[name] = 0
        write_adapter_row(self._stacks, slot, self._share(adapter_params), r_max=self.max_rank)
        self._scales[slot] = config.scaling
        self._touch(name)
        self.load_total += 1
        return slot

    def evict(self, name: str) -> None:
        if name not in self._slots:
            raise KeyError(f"adapter {name!r} is not resident")
        if self._refcounts.get(name, 0) > 0:
            raise RuntimeError(f"adapter {name!r} has {self._refcounts[name]} in-flight "
                               "request(s); release them before evicting")
        self._clear_row(self._slots.pop(name))
        self._refcounts.pop(name, None)
        if name in self._lru:
            self._lru.remove(name)
        self.evict_total += 1

    def resident(self, name: Optional[str]) -> bool:
        return name is None or name in self._slots

    def slot_of(self, name: Optional[str]) -> int:
        """The stack row a request reads: 0 (identity) for no adapter."""
        if name is None:
            return 0
        return self._slots[name]

    def resident_names(self) -> list[str]:
        return sorted(self._slots)

    # ------------------------------------------------------------------ #
    # refcounts: an adapter stays resident while requests use it
    # ------------------------------------------------------------------ #
    def acquire(self, name: Optional[str]) -> None:
        if name is None:
            return
        if name not in self._slots:
            raise KeyError(f"adapter {name!r} is not resident")
        self._refcounts[name] = self._refcounts.get(name, 0) + 1
        self._touch(name)

    def release(self, name: Optional[str]) -> None:
        if name is None:
            return
        count = self._refcounts.get(name, 0)
        if count <= 0:
            raise RuntimeError(f"adapter {name!r} released more than acquired")
        self._refcounts[name] = count - 1

    # ------------------------------------------------------------------ #
    # what the engine's programs read
    # ------------------------------------------------------------------ #
    def stacks(self) -> dict:
        return self._stacks

    def scales(self) -> torch.Tensor:
        return self._scales

    def hbm_bytes(self) -> int:
        """Device bytes of the stacks and the scales."""
        return sum(leaf.nbytes for pair in self._stacks.values()
                   for leaf in pair.values()) + self._scales.nbytes

    # ------------------------------------------------------------------ #
    # internals
    # ------------------------------------------------------------------ #
    def _validate(self, name, adapter_params, config):
        if not name:
            raise ValueError("adapter name must be non-empty")
        if config.rank > self.max_rank:
            raise ValueError(f"adapter {name!r} rank {config.rank} exceeds registry "
                             f"max_rank {self.max_rank}")
        extra = set(adapter_params) - set(self.target_modules)
        if extra:
            raise ValueError(f"adapter {name!r} targets {sorted(extra)} which this "
                             f"registry's stacks do not cover (covered: "
                             f"{', '.join(self.target_modules)})")
        shapes = target_shapes(self.model_config)
        L = self.model_config.num_layers
        for t, pair in adapter_params.items():
            in_dim, out_dim = shapes[t]
            a, b = pair[A_KEY], pair[B_KEY]
            if a.shape[0] != L or a.shape[1] != in_dim:
                raise ValueError(f"adapter {name!r} {t} lora_a shape {tuple(a.shape)} does not "
                                 f"match model layout (expected ({L}, {in_dim}, r))")
            if b.shape[0] != L or b.shape[2] != out_dim:
                raise ValueError(f"adapter {name!r} {t} lora_b shape {tuple(b.shape)} does not "
                                 f"match model layout (expected ({L}, r, {out_dim}))")

    def _free_slot(self) -> int:
        used = set(self._slots.values())
        for row in range(1, self.capacity + 1):
            if row not in used:
                return row
        # full: evict the least recently used tenant with nothing in flight
        for name in self._lru:
            if self._refcounts.get(name, 0) == 0:
                row = self._slots[name]
                self.evict(name)
                return row
        raise RuntimeError(f"registry full ({self.capacity} adapters, all with in-flight "
                           "requests): raise capacity or drain traffic")

    def _clear_row(self, row: int) -> None:
        write_adapter_row(self._stacks, row, None)
        self._scales[row] = 0.0

    def _touch(self, name: str) -> None:
        if name in self._lru:
            self._lru.remove(name)
        self._lru.append(name)


def _cut(t: torch.Tensor, leaf: str, part: slice) -> torch.Tensor:
    """A's rows (its ``in`` axis, second to last) or B's columns (its
    ``out`` axis, last) in ``part``."""
    dim = t.dim() - 2 if leaf == A_KEY else t.dim() - 1
    return t.narrow(dim, part.start, part.stop - part.start)
