"""Data loading for one process: host batches moved to the device.

Port of ``accelerate_tpu/data_loader.py`` (``SeedableRandomSampler`` :62,
``BatchSamplerShard`` :100, ``_default_collate`` :291,
``DataLoaderStateMixin`` :303, ``DataLoaderShard`` :315,
``prepare_data_loader`` :707, ``_loader_shuffles`` :839, ``DataLoader``
:849, ``skip_first_batches`` :891) for one process on one device. The
batch indices, the shuffle (a permutation drawn from ``seed + epoch``, the
reference's default seedable sampler), the tail rule (a short last batch
wraps around the epoch to full size and records its true size as
``remainder``), the loader's position in its epoch and the resume by
skipped batches are the reference's; each batch is collated on the host
and copied to the accelerator's device. Sharding across processes comes
with a later slice (ROADMAP.md, queue A4).
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, Optional

import numpy as np

from .logging import get_logger
from .state import AcceleratorState, GradientState
from .utils.operations import send_to_device

__all__ = ["DataLoader", "DataLoaderShard", "prepare_data_loader", "send_to_device",
           "skip_first_batches"]

logger = get_logger(__name__)


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
    size of a wrapped tail (0 for a full one)."""

    def __init__(self, batch_factory: Callable[[], Iterator[tuple[Any, int]]],
                 num_batches: int, device, batch_size: int,
                 sampler: Optional[SeedableRandomSampler] = None, _skip_batches: int = 0):
        self._factory = batch_factory
        self._num_batches = num_batches
        self.device = device
        self.batch_size = batch_size
        self.sampler = sampler
        self.epoch = 0
        self._skip_batches = _skip_batches
        self._batches_yielded = 0  # position within the current epoch
        self.end_of_dataloader = False
        self.remainder = -1

    def __len__(self) -> int:
        return max(0, self._num_batches - self._skip_batches)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def state_dict(self) -> dict:
        """The epoch and the batches already yielded in it."""
        return {"epoch": self.epoch, "batches_yielded": self._batches_yielded,
                "global_batch_size": self.batch_size}

    def load_state_dict(self, state: dict) -> None:
        """Resume at the saved position: the next iteration skips the
        batches already yielded. Saved under another batch size, the
        position is re-derived from the samples seen, rounded down."""
        self.set_epoch(int(state.get("epoch", 0)))
        seen = int(state.get("batches_yielded", 0))
        saved = int(state.get("global_batch_size", 0) or 0)
        if saved and saved != self.batch_size:
            samples = seen * saved
            seen = samples // self.batch_size
            logger.warning("dataloader cursor re-derived for a changed batch size (%d -> %d): "
                           "%d samples seen -> resume at batch %d", saved, self.batch_size,
                           samples, seen)
        self._skip_batches = seen
        self._batches_yielded = seen

    def __iter__(self) -> Iterator[Any]:
        self.begin()
        try:
            source = iter(self._factory())
            for _ in range(self._skip_batches):
                if next(source, None) is None:
                    break
            # skipped batches count as consumed positions
            self._batches_yielded = self._skip_batches
            current = next(source, None)
            while current is not None:
                nxt = next(source, None)  # one batch ahead: mark the last before yielding it
                host_batch, valid = current
                if nxt is None:
                    self.end_of_dataloader = True
                    self.remainder = valid if valid != self.batch_size else 0
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
                        seed: int = 0, skip_batches: int = 0) -> DataLoaderShard:
    """Turn a host loader with a map-style ``dataset`` and a ``batch_size``
    (this module's :class:`DataLoader`, or ``torch.utils.data.DataLoader``)
    into a :class:`DataLoaderShard` on the accelerator's device. A
    shuffling loader draws the seedable permutation of ``seed``."""
    state = state or AcceleratorState()
    dataset = getattr(dataloader, "dataset", None)
    batch_size = getattr(dataloader, "batch_size", None)
    if dataset is None or batch_size is None or not hasattr(dataset, "__len__"):
        raise TypeError(
            "prepare_data_loader needs a loader with a map-style dataset and a batch_size"
        )
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
                           _skip_batches=skip_batches)


class DataLoader:
    """Minimal host loader: map-style dataset + batch/shuffle/collate."""

    def __init__(self, dataset: Any, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn: Optional[Callable] = None):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or _default_collate

    def __len__(self) -> int:
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)


def skip_first_batches(dataloader: DataLoaderShard, num_batches: int = 0) -> DataLoaderShard:
    """Resume mid-epoch: the prepared loader's next iteration skips its
    first ``num_batches`` (the same loader is returned)."""
    if not isinstance(dataloader, DataLoaderShard):
        raise TypeError(
            "skip_first_batches expects a loader returned by prepare()/prepare_data_loader()"
        )
    dataloader._skip_batches = num_batches
    return dataloader
