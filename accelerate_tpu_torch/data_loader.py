"""Data loading for one process: host batches moved to the device.

Port of ``accelerate_tpu/data_loader.py`` (``SeedableRandomSampler`` :62,
``BatchSamplerShard`` :100, ``_stack_superbatches`` :258,
``_default_collate`` :291, ``DataLoaderStateMixin`` :303,
``DataLoaderShard`` :315, ``prepare_data_loader`` :707,
``_loader_shuffles`` :839, ``DataLoader`` :849, ``skip_first_batches``
:891) for one process on one device. The batch indices, the shuffle (a
permutation drawn from ``seed + epoch``, the reference's default seedable
sampler), the tail rule (a short last batch wraps around the epoch to full
size and records its true size as ``remainder``), the superbatch mode of
fused accumulation (K consecutive microbatches stacked as ``[K, micro,
...]``, a short last stack padded with its last microbatch), the loader's
position in its epoch and the resume by skipped batches are the
reference's; each batch is collated on the host and copied to the
accelerator's device. The host work runs in the loop (the reference
prefetches on a thread), so all of it is reported to telemetry as
dataloader wait. Sharding across processes comes with a later slice
(ROADMAP.md, queue A4).
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from .logging import get_logger
from .state import AcceleratorState, GradientState
from .utils.operations import recursively_apply, send_to_device

__all__ = ["DataLoader", "DataLoaderShard", "find_batch_size", "prepare_data_loader",
           "send_to_device", "skip_first_batches"]

logger = get_logger(__name__)


def find_batch_size(data: Any) -> Optional[int]:
    """Leading dimension of the first array leaf with one."""
    sizes = []
    recursively_apply(lambda x: sizes.append(x.shape[0]) if x.ndim > 0 else None, data)
    return int(sizes[0]) if sizes else None


def _stack_group(group: list[Any]) -> Any:
    """Microbatch trees stacked leaf by leaf on a new leading axis."""
    first = group[0]
    if isinstance(first, dict):
        return {k: _stack_group([g[k] for g in group]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_stack_group([g[i] for g in group]) for i in range(len(first)))
    if isinstance(first, torch.Tensor):
        return torch.stack(group)
    return np.stack([np.asarray(g) for g in group])


def _stack_superbatches(source: Iterator[tuple[Any, int]],
                        k: int) -> Iterator[tuple[Any, int]]:
    """Every ``k`` consecutive microbatches collated into one stacked
    ``[k, micro, ...]`` batch, the input of the fused accumulation step. A
    short last group is padded by repeating its last microbatch, so the
    shape stays fixed; ``valid`` is the true sample count summed over the
    ``k`` slots."""
    group: list[Any] = []
    valid_total = 0
    for host_batch, valid in source:
        group.append(host_batch)
        valid_total += valid
        if len(group) == k:
            yield _stack_group(group), valid_total
            group, valid_total = [], 0
    if group:
        while len(group) < k:
            group.append(group[-1])
        yield _stack_group(group), valid_total


def _default_collate(items: list[Any]) -> Any:
    """Stack a list of samples into a batch pytree of numpy arrays."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_default_collate([it[i] for it in items]) for i in range(len(first)))
    return np.stack([np.asarray(it) for it in items])


class SeedableRandomSampler:
    """Epoch-seeded permutation: the same (seed, epoch) gives the same order."""

    def __init__(self, data_source_len: int, seed: int = 0, epoch: int = 0):
        self.length = data_source_len
        self.seed = seed
        self.epoch = epoch

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return self.length

    def __iter__(self) -> Iterator[int]:
        yield from np.random.default_rng(self.seed + self.epoch).permutation(self.length).tolist()


def _batches(order: list[int], batch_size: int,
             drop_last: bool) -> Iterator[tuple[list[int], int]]:
    """(indices, valid) per batch: a short tail is dropped, or wrapped
    around the epoch to a full batch with ``valid`` its true size."""
    for start in range(0, len(order), batch_size):
        batch = order[start:start + batch_size]
        valid = len(batch)
        if valid < batch_size:
            if drop_last:
                return
            while len(batch) < batch_size:
                batch += order[: batch_size - len(batch)]
        yield batch, valid


class DataLoaderStateMixin:
    """Registers the loader with GradientState while it is iterated."""

    def begin(self) -> None:
        self.end_of_dataloader = False
        self.remainder = -1
        GradientState()._add_dataloader(self)

    def end(self) -> None:
        GradientState()._remove_dataloader(self)


class DataLoaderShard(DataLoaderStateMixin):
    """The prepared loader: yields each host batch on the device. The last
    batch of an epoch is known before it is yielded, so while the loop body
    runs on it ``end_of_dataloader`` is True and ``remainder`` is the true
    size of a wrapped tail (0 for a full one). With ``superbatch=K`` each
    yielded batch stacks K microbatches as ``[K, micro, ...]``;
    ``batch_size`` stays the microbatch's. ``telemetry`` (set by
    ``Accelerator.prepare_data_loader``) is told the host time spent making
    each batch."""

    def __init__(self, batch_factory: Callable[[], Iterator[tuple[Any, int]]],
                 num_batches: Optional[int], device, batch_size: int,
                 sampler: Optional[SeedableRandomSampler] = None, superbatch: int = 1,
                 _skip_batches: int = 0):
        self._factory = batch_factory
        self._num_batches = num_batches
        self.device = device
        self.batch_size = batch_size
        self.sampler = sampler
        self.superbatch = max(1, int(superbatch))
        self.epoch = 0
        self._skip_batches = _skip_batches
        self._batches_yielded = 0  # position within the current epoch
        self.end_of_dataloader = False
        self.remainder = -1
        self.telemetry = None

    def __len__(self) -> int:
        if self._num_batches is None:
            raise TypeError("this dataloader has no length")
        return max(0, math.ceil(self._num_batches / self.superbatch) - self._skip_batches)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def state_dict(self) -> dict:
        """The epoch and the batches already yielded in it."""
        return {"epoch": self.epoch, "batches_yielded": self._batches_yielded,
                "global_batch_size": self.batch_size * self.superbatch}

    def load_state_dict(self, state: dict) -> None:
        """Resume at the saved position: the next iteration skips the
        batches already yielded. Saved under another batch size, the
        position is re-derived from the samples seen, rounded down."""
        self.set_epoch(int(state.get("epoch", 0)))
        seen = int(state.get("batches_yielded", 0))
        saved = int(state.get("global_batch_size", 0) or 0)
        live = self.batch_size * self.superbatch
        if saved and live and saved != live:
            samples = seen * saved
            seen = samples // live
            logger.warning("dataloader cursor re-derived for a changed batch size (%d -> %d): "
                           "%d samples seen -> resume at batch %d", saved, live, samples, seen)
        self._skip_batches = seen
        self._batches_yielded = seen

    def _next_timed(self, source: Iterator) -> Any:
        """The next host batch, its making reported as dataloader wait."""
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return next(source, None)
        t0 = time.perf_counter()
        item = next(source, None)
        tel.record_dataloader_wait(time.perf_counter() - t0, source="shard")
        return item

    def __iter__(self) -> Iterator[Any]:
        self.begin()
        try:
            source = iter(self._factory())
            if self.superbatch > 1:
                source = _stack_superbatches(source, self.superbatch)
            for _ in range(self._skip_batches):
                if next(source, None) is None:
                    break
            # skipped batches count as consumed positions
            self._batches_yielded = self._skip_batches
            current = self._next_timed(source)
            while current is not None:
                nxt = self._next_timed(source)  # one ahead: mark the last before yielding it
                host_batch, valid = current
                if self.batch_size == 0:
                    # iterable of batches: the first batch gives the size, so
                    # a short tail's remainder is seen
                    self.batch_size = valid // self.superbatch
                if nxt is None:
                    self.end_of_dataloader = True
                    full = self.batch_size * self.superbatch
                    self.remainder = valid if valid != full else 0
                yield send_to_device(host_batch, self.device)
                self._batches_yielded += 1
                current = nxt
        finally:
            self.end()
            self._skip_batches = 0
            if self.end_of_dataloader:
                self._batches_yielded = 0  # full epoch consumed


def _loader_shuffles(dataloader: Any) -> bool:
    """Whether the incoming loader shuffles: its ``shuffle`` flag (this
    module's :class:`DataLoader`), else its sampler's type
    (``torch.utils.data.DataLoader(shuffle=True)`` holds a RandomSampler)."""
    if getattr(dataloader, "shuffle", None) is not None:
        return bool(dataloader.shuffle)
    sampler = getattr(dataloader, "sampler", None)
    if sampler is not None:
        return type(sampler).__name__ in ("RandomSampler", "SeedableRandomSampler")
    return False


def prepare_data_loader(dataloader: Any, state: Optional[AcceleratorState] = None,
                        seed: int = 0, skip_batches: int = 0,
                        superbatch: int = 1) -> DataLoaderShard:
    """Turn a host loader into a :class:`DataLoaderShard` on the
    accelerator's device. Takes a loader with a map-style ``dataset`` and a
    ``batch_size`` (this module's :class:`DataLoader`, or
    ``torch.utils.data.DataLoader``; a shuffling one draws the seedable
    permutation of ``seed``), or any iterable of batches, each a tree of
    arrays or tensors taken as it is. ``superbatch=K`` (K > 1) stacks K
    consecutive microbatches into each yielded ``[K, micro, ...]`` batch for
    fused accumulation; a short last stack is padded with its last
    microbatch and its true sample count is the loader's ``remainder``."""
    state = state or AcceleratorState()
    dataset = getattr(dataloader, "dataset", None)
    batch_size = getattr(dataloader, "batch_size", None)
    if dataset is not None and batch_size is not None and hasattr(dataset, "__len__"):
        collate = getattr(dataloader, "collate_fn", None) or _default_collate
        n = len(dataset)
        sampler = SeedableRandomSampler(n, seed) if _loader_shuffles(dataloader) else None
        drop_last = bool(getattr(dataloader, "drop_last", False))

        def factory():
            order = list(sampler) if sampler is not None else list(range(n))
            for indices, valid in _batches(order, batch_size, drop_last):
                yield collate([dataset[i] for i in indices]), valid

        num_batches = n // batch_size if drop_last else math.ceil(n / batch_size)
        return DataLoaderShard(factory, num_batches, state.device, batch_size, sampler,
                               superbatch=superbatch, _skip_batches=skip_batches)

    def batches():
        for batch in dataloader:
            yield batch, find_batch_size(batch) or 0

    try:
        num_batches = len(dataloader)
    except TypeError:
        num_batches = None
    return DataLoaderShard(batches, num_batches, state.device,
                           getattr(dataloader, "global_batch_size", 0) or 0,
                           superbatch=superbatch, _skip_batches=skip_batches)


def _loader_shuffles(dataloader: Any) -> bool:
    """Whether the incoming loader shuffles: its ``shuffle`` flag (this
    module's :class:`DataLoader`), else its sampler's type
    (``torch.utils.data.DataLoader(shuffle=True)`` holds a RandomSampler)."""
    if getattr(dataloader, "shuffle", None) is not None:
        return bool(dataloader.shuffle)
    sampler = getattr(dataloader, "sampler", None)
    if sampler is not None:
        return type(sampler).__name__ in ("RandomSampler", "SeedableRandomSampler")
    return False


class DataLoader:
    """Minimal host loader: map-style dataset + batch/shuffle/collate.
    Iterated unprepared it yields collated host batches, in a permutation
    drawn from ``seed + epoch`` when it shuffles (``set_epoch``)."""

    def __init__(self, dataset: Any, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn: Optional[Callable] = None, seed: int = 0):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or _default_collate
        self.seed = seed
        self._epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self._epoch = epoch

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        indices = (np.random.default_rng(self.seed + self._epoch).permutation(n)
                   if self.shuffle else np.arange(n))
        for start in range(0, n, self.batch_size):
            chunk = indices[start:start + self.batch_size]
            if self.drop_last and len(chunk) < self.batch_size:
                return
            yield self.collate_fn([self.dataset[int(i)] for i in chunk])


def skip_first_batches(dataloader: DataLoaderShard, num_batches: int = 0) -> DataLoaderShard:
    """Resume mid-epoch: the prepared loader's next iteration skips its
    first ``num_batches`` (the same loader is returned)."""
    if not isinstance(dataloader, DataLoaderShard):
        raise TypeError(
            "skip_first_batches expects a loader returned by prepare()/prepare_data_loader()"
        )
    dataloader._skip_batches = num_batches
    return dataloader
