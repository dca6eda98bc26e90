"""Data loading for one process: host batches moved to the device.

Port of ``accelerate_tpu/data_loader.py`` (``_default_collate`` :291,
``DataLoaderShard`` :315, ``prepare_data_loader`` :707, ``DataLoader``
:849) for one process on one device. The batch indices, the tail rule
(a short last batch wraps around the epoch to full size, the reference's
``even_batches`` default) and the epoch-seeded shuffle are the
reference's; each batch is collated on the host and copied to the
accelerator's device. Sharding across processes comes with a later slice.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Iterator, Optional

import numpy as np
import torch

from .state import AcceleratorState


def _default_collate(items: list[Any]) -> Any:
    """Stack a list of samples into a batch pytree of numpy arrays."""
    first = items[0]
    if isinstance(first, dict):
        return {k: _default_collate([it[k] for it in items]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_default_collate([it[i] for it in items]) for i in range(len(first)))
    return np.stack([np.asarray(it) for it in items])


def send_to_device(batch: Any, device: torch.device) -> Any:
    """Every array leaf of a dict/list/tuple tree as a tensor on ``device``."""
    if isinstance(batch, dict):
        return {k: send_to_device(v, device) for k, v in batch.items()}
    if isinstance(batch, (tuple, list)):
        return type(batch)(send_to_device(v, device) for v in batch)
    if isinstance(batch, np.ndarray):
        batch = torch.from_numpy(batch)
    if isinstance(batch, torch.Tensor):
        return batch.to(device, non_blocking=True)
    return batch


def _batch_indices(order: list[int], batch_size: int, drop_last: bool) -> Iterator[list[int]]:
    """Indices per batch; a short tail is dropped or wrapped around the
    epoch to a full batch."""
    for start in range(0, len(order), batch_size):
        batch = order[start:start + batch_size]
        if len(batch) < batch_size:
            if drop_last:
                return
            while len(batch) < batch_size:
                batch += order[: batch_size - len(batch)]
        yield batch


class SeedableRandomSampler:
    """Epoch-seeded permutation: the same (seed, epoch) gives the same order."""

    def __init__(self, length: int, seed: int = 0):
        self.length = length
        self.seed = seed
        self.epoch = 0

    def __iter__(self) -> Iterator[int]:
        yield from np.random.default_rng(self.seed + self.epoch).permutation(self.length).tolist()


class DataLoaderShard:
    """The prepared training loader: yields each host batch on the device."""

    def __init__(self, batch_factory: Callable[[], Iterator[Any]], num_batches: int,
                 device: torch.device, sampler: Optional[SeedableRandomSampler] = None):
        self._factory = batch_factory
        self._num_batches = num_batches
        self.device = device
        self.sampler = sampler

    def __len__(self) -> int:
        return self._num_batches

    def set_epoch(self, epoch: int) -> None:
        if self.sampler is not None:
            self.sampler.epoch = epoch

    def __iter__(self) -> Iterator[Any]:
        for batch in self._factory():
            yield send_to_device(batch, self.device)


def prepare_data_loader(dataloader: Any, state: Optional[AcceleratorState] = None,
                        seed: int = 0) -> DataLoaderShard:
    """Turn a host loader with ``dataset`` and ``batch_size`` (this module's
    :class:`DataLoader`, or ``torch.utils.data.DataLoader``) into a
    :class:`DataLoaderShard` on the accelerator's device."""
    state = state or AcceleratorState()
    dataset = getattr(dataloader, "dataset", None)
    batch_size = getattr(dataloader, "batch_size", None)
    if dataset is None or batch_size is None or not hasattr(dataset, "__len__"):
        raise TypeError(
            "prepare_data_loader needs a loader with a map-style dataset and a batch_size"
        )
    collate = getattr(dataloader, "collate_fn", None) or _default_collate
    n = len(dataset)
    sampler = SeedableRandomSampler(n, seed) if getattr(dataloader, "shuffle", False) else None
    drop_last = bool(getattr(dataloader, "drop_last", False))

    def factory():
        order = list(sampler) if sampler is not None else list(range(n))
        for indices in _batch_indices(order, batch_size, drop_last):
            yield collate([dataset[i] for i in indices])

    num_batches = n // batch_size if drop_last else math.ceil(n / batch_size)
    return DataLoaderShard(factory, num_batches, state.device, sampler)


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
