"""Data loading: each process's share of every batch, moved to its device.

Port of ``accelerate_tpu/data_loader.py`` (``SeedableRandomSampler`` :62,
``RandomSampler`` :83, ``SequentialSampler`` :101, ``BatchSamplerShard``
:115, ``IterableDatasetShard`` :200, ``_stack_superbatches`` :258,
``_default_collate`` :291, ``DataLoaderStateMixin`` :303,
``DataLoaderShard`` :315, ``DataLoaderDispatcher`` :618,
``prepare_data_loader`` :707, ``_loader_shuffles`` :839, ``DataLoader``
:849, ``skip_first_batches`` :891). The batch indices, the shuffles (a
permutation drawn from ``seed + epoch``, the reference's default seedable
sampler, or from numpy's global generator), the tail rules (``even_batches``:
a short last batch wraps around the epoch to full size; otherwise it is
padded with its last sample; either way its true size is ``remainder``),
``split_batches``, ``drop_last``, the superbatch mode of fused accumulation
(K consecutive microbatches stacked as ``[K, micro, ...]``, a short last
stack padded with its last microbatch), the loader's position in its epoch
and the resume by skipped batches are the reference's; each batch is
collated on the host and copied to the accelerator's device. The host work
runs in the loop (the reference prefetches on a thread), so all of it is
reported to telemetry as dataloader wait.

Across processes the reference's prepared loader yields the *global* batch
as one sharded array; here each process holds its own rows of it (process
``p`` the ``p``-th slice of every global batch, ``BatchSamplerShard``), and
``DataLoaderDispatcher`` reads every batch on process 0 and sends each
process its rows. So a yielded batch has ``batch_size`` rows, while the
counts the reference keeps in global samples stay global here:
``global_batch_size``, ``remainder`` (the real samples of a short last
global batch), the cursor of ``state_dict`` and ``skip_first_batches`` (a
global batch is one batch on every process). Under a mesh the rows go by
data-parallel rank (``AcceleratorState.data_parallel_rank``, over dp x
fsdp): the processes of one tp group read the same rows.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np
import torch

from .logging import get_logger
from .state import AcceleratorState, GradientState, current_process_index
from .utils.dataclasses import DataLoaderConfiguration
from .utils.operations import (
    broadcast_object_list,
    find_batch_size,
    recursively_apply,
    send_to_device,
)

__all__ = ["BatchSamplerShard", "DataLoader", "DataLoaderDispatcher", "DataLoaderShard",
           "IterableDatasetShard", "RandomSampler", "SeedableRandomSampler",
           "SequentialSampler", "find_batch_size", "prepare_data_loader", "send_to_device",
           "skip_first_batches"]

logger = get_logger(__name__)


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
    """Epoch-seeded permutation: the same (seed, epoch) gives the same order
    on every process."""

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


class RandomSampler:
    """A shuffle drawn from numpy's global generator (``use_seedable_sampler
    =False``): the processes agree only after ``synchronize_rng_states``."""

    def __init__(self, data_source_len: int):
        self.length = data_source_len

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return self.length

    def __iter__(self) -> Iterator[int]:
        yield from np.random.permutation(self.length).tolist()


class SequentialSampler:
    def __init__(self, data_source_len: int):
        self.length = data_source_len

    def set_epoch(self, epoch: int) -> None:
        pass

    def __len__(self) -> int:
        return self.length

    def __iter__(self) -> Iterator[int]:
        yield from range(self.length)


class BatchSamplerShard:
    """This process's slice of each global batch of indices, with the global
    batch's real sample count: ``(local_indices, valid)`` pairs. The global
    batch is ``batch_size`` x ``num_processes`` (``split_batches``: the
    incoming ``batch_size`` is already global and is split). A short last
    batch is dropped (``drop_last``), wrapped around the dataset
    (``even_batches``) or padded with its last index."""

    def __init__(self, sampler, batch_size: int, drop_last: bool = False,
                 num_processes: int = 1, process_index: int = 0, split_batches: bool = False,
                 even_batches: bool = True):
        if split_batches and batch_size % num_processes != 0:
            raise ValueError(f"batch_size {batch_size} must be divisible by num_processes "
                             f"{num_processes} when split_batches=True")
        self.sampler = sampler
        self.batch_size = batch_size
        self.drop_last = drop_last
        self.num_processes = num_processes
        self.process_index = process_index
        self.split_batches = split_batches
        self.even_batches = even_batches

    @property
    def global_batch_size(self) -> int:
        return self.batch_size if self.split_batches else self.batch_size * self.num_processes

    @property
    def local_batch_size(self) -> int:
        return self.global_batch_size // self.num_processes

    def __len__(self) -> int:
        n = len(self.sampler)
        if self.drop_last:
            return n // self.global_batch_size
        return math.ceil(n / self.global_batch_size)

    def set_epoch(self, epoch: int) -> None:
        if hasattr(self.sampler, "set_epoch"):
            self.sampler.set_epoch(epoch)

    def _local(self, batch: list[int]) -> list[int]:
        lo = self.process_index * self.local_batch_size
        return batch[lo:lo + self.local_batch_size]

    def __iter__(self) -> Iterator[tuple[list[int], int]]:
        indices = list(self.sampler)
        gbs = self.global_batch_size
        for start in range(0, len(indices), gbs):
            batch = indices[start:start + gbs]
            if len(batch) < gbs:
                if self.drop_last:
                    return
                valid = len(batch)
                if self.even_batches:
                    while len(batch) < gbs:
                        batch += indices[: gbs - len(batch)]
                else:
                    batch = batch + [batch[-1]] * (gbs - len(batch))
                yield self._local(batch), valid
            else:
                yield self._local(batch), gbs


class IterableDatasetShard:
    """This process's slice of each global batch of a stream (no length, no
    random access): global batches of ``batch_size`` x ``num_processes``
    items are collected in order and each process keeps its slice, with the
    batch's real item count. A short last batch is dropped (``drop_last``)
    or filled: from the first batch onwards (``even_batches``) or with its
    last item."""

    def __init__(self, iterable: Iterable, batch_size: int, num_processes: int = 1,
                 process_index: int = 0, drop_last: bool = False, even_batches: bool = True):
        self.iterable = iterable
        self.batch_size = batch_size
        self.num_processes = num_processes
        self.process_index = process_index
        self.drop_last = drop_last
        self.even_batches = even_batches

    def _local(self, buffer: list[Any]) -> list[Any]:
        lo = self.process_index * self.batch_size
        return buffer[lo:lo + self.batch_size]

    def __iter__(self) -> Iterator[tuple[list[Any], int]]:
        gbs = self.batch_size * self.num_processes
        buffer: list[Any] = []
        first_batch: Optional[list[Any]] = None
        for item in self.iterable:
            buffer.append(item)
            if len(buffer) == gbs:
                if first_batch is None:
                    first_batch = list(buffer)
                yield self._local(buffer), gbs
                buffer = []
        if buffer and not self.drop_last:
            valid = len(buffer)
            pad_src = buffer if not self.even_batches else buffer + (first_batch or buffer)
            while len(buffer) < gbs:
                buffer.append(pad_src[len(buffer) % len(pad_src)] if self.even_batches
                              else buffer[-1])
            yield self._local(buffer), valid


class DataLoaderStateMixin:
    """Registers the loader with GradientState while it is iterated."""

    def begin(self) -> None:
        self.end_of_dataloader = False
        self.remainder = -1
        GradientState()._add_dataloader(self)

    def end(self) -> None:
        GradientState()._remove_dataloader(self)


class DataLoaderShard(DataLoaderStateMixin):
    """The prepared loader: yields this process's rows of each batch on the
    device. The last batch of an epoch is known before it is yielded, so
    while the loop body runs on it ``end_of_dataloader`` is True and
    ``remainder`` is the real sample count of a short global tail (0 for a
    full one). ``batch_size`` is the rows a yielded batch holds on this
    process, ``global_batch_size`` those of all processes together. With
    ``superbatch=K`` each yielded batch stacks K microbatches as ``[K, micro,
    ...]``; the batch sizes stay the microbatch's. ``telemetry`` (set by
    ``Accelerator.prepare_data_loader``) is told the host time spent making
    each batch."""

    def __init__(self, batch_factory: Callable[[], Iterator[tuple[Any, int]]],
                 num_batches: Optional[int], device, batch_size: int, sampler=None,
                 superbatch: int = 1, _skip_batches: int = 0, num_processes: int = 1,
                 process_index: int = 0):
        self._factory = batch_factory
        self._num_batches = num_batches
        self.device = device
        self.batch_size = batch_size
        self.sampler = sampler
        self.superbatch = max(1, int(superbatch))
        self.num_processes = num_processes
        self.process_index = process_index
        self.epoch = 0
        self._skip_batches = _skip_batches
        self._batches_yielded = 0  # position within the current epoch
        self.end_of_dataloader = False
        self.remainder = -1
        self.telemetry = None

    @property
    def global_batch_size(self) -> int:
        return self.batch_size * self.num_processes

    @property
    def total_batch_size(self) -> int:
        return self.global_batch_size

    def __len__(self) -> int:
        if self._num_batches is None:
            raise TypeError("this dataloader has no length")
        return max(0, math.ceil(self._num_batches / self.superbatch) - self._skip_batches)

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch
        if self.sampler is not None:
            self.sampler.set_epoch(epoch)

    def state_dict(self) -> dict:
        """The epoch, the batches already yielded in it, and the global
        batch size they were counted under."""
        return {"epoch": self.epoch, "batches_yielded": self._batches_yielded,
                "global_batch_size": self.global_batch_size * self.superbatch}

    def load_state_dict(self, state: dict) -> None:
        """Resume at the saved position: the next iteration skips the
        batches already yielded. Saved under another global batch size (a
        restore onto another world size), the position is re-derived from
        the samples seen, rounded down to a whole batch."""
        self.set_epoch(int(state.get("epoch", 0)))
        seen = int(state.get("batches_yielded", 0))
        saved = int(state.get("global_batch_size", 0) or 0)
        live = self.global_batch_size * self.superbatch
        if saved and live and saved != live:
            samples = seen * saved
            seen = samples // live
            logger.warning("dataloader cursor re-derived for a changed batch size (%d -> %d): "
                           "%d samples seen -> resume at batch %d", saved, live, samples, seen)
        self._skip_batches = seen
        self._batches_yielded = seen

    def _timed(self, fetch: Callable[[], Any]) -> Any:
        """``fetch()``, its host time reported as dataloader wait."""
        tel = self.telemetry
        if tel is None or not tel.enabled:
            return fetch()
        t0 = time.perf_counter()
        item = fetch()
        tel.record_dataloader_wait(time.perf_counter() - t0, source="shard")
        return item

    def _source(self) -> Iterator[tuple[Any, int]]:
        """``(host batch of this process's rows, global valid count)``
        pairs, stacked under ``superbatch``."""
        source = iter(self._factory())
        if self.superbatch > 1:
            source = _stack_superbatches(source, self.superbatch)
        return source

    def _mark(self, valid: int, last: bool) -> None:
        if self.batch_size == 0:
            # iterable of batches: the first batch gives the size, so a
            # short tail's remainder is seen
            self.batch_size = valid // self.superbatch // self.num_processes
        if last:
            self.end_of_dataloader = True
            full = self.global_batch_size * self.superbatch
            self.remainder = valid if valid != full else 0

    def __iter__(self) -> Iterator[Any]:
        self.begin()
        try:
            source = self._source()
            for _ in range(self._skip_batches):
                if next(source, None) is None:
                    break
            # skipped batches count as consumed positions
            self._batches_yielded = self._skip_batches
            current = self._timed(lambda: next(source, None))
            while current is not None:
                nxt = self._timed(lambda: next(source, None))  # one ahead: mark the last
                host_batch, valid = current
                self._mark(valid, nxt is None)
                yield send_to_device(host_batch, self.device)
                self._batches_yielded += 1
                current = nxt
        finally:
            self.end()
            self._skip_batches = 0
            if self.end_of_dataloader:
                self._batches_yielded = 0  # full epoch consumed


class DataLoaderDispatcher(DataLoaderShard):
    """Process 0 reads every global batch and broadcasts it; each process
    keeps its rows (reference :618), for data only process 0 can read. The
    factory runs on process 0 alone and yields global batches; the
    broadcast is one object collective a batch."""

    def _slice(self, host_batch: Any) -> Any:
        def one(x):
            axis = 1 if self.superbatch > 1 and x.ndim > 1 else 0
            lo = self.process_index * self.batch_size
            return x[:, lo:lo + self.batch_size] if axis == 1 else x[lo:lo + self.batch_size]

        return recursively_apply(one, host_batch,
                                 test_type=lambda x: isinstance(x, (np.ndarray, torch.Tensor)))

    def __iter__(self) -> Iterator[Any]:
        if self.num_processes == 1:
            yield from super().__iter__()
            return
        self.begin()
        try:
            # the world's rank 0 reads: under tensor parallelism the data
            # rank 0 is several processes
            source = self._source() if current_process_index() == 0 else None
            skipped = 0

            def payload():
                msg = [None, 0, True]
                nonlocal skipped
                while source is not None:
                    item = next(source, None)
                    if item is None:
                        break
                    if skipped < self._skip_batches:
                        skipped += 1
                        continue
                    msg = [item[0], item[1], False]
                    break
                return broadcast_object_list(msg, from_process=0)

            self._batches_yielded = self._skip_batches
            current = self._timed(payload)
            while not current[2]:
                nxt = self._timed(payload)
                host_batch, valid, _ = current
                self._mark(valid, nxt[2])
                yield send_to_device(self._slice(host_batch), self.device)
                self._batches_yielded += 1
                current = nxt
        finally:
            self.end()
            self._skip_batches = 0
            if self.end_of_dataloader:
                self._batches_yielded = 0


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
                        config: Optional[DataLoaderConfiguration] = None, seed: int = 0,
                        skip_batches: int = 0, superbatch: int = 1) -> DataLoaderShard:
    """Turn a host loader into a :class:`DataLoaderShard` on the
    accelerator's device (reference :707). Takes a loader with a map-style
    ``dataset`` and a ``batch_size`` (this module's :class:`DataLoader`, or
    ``torch.utils.data.DataLoader``), whose ``batch_size`` is each
    process's (``split_batches``: the global batch, split), sharded by
    :class:`BatchSamplerShard` and shuffled by the seedable permutation of
    ``seed`` (or numpy's global generator, ``use_seedable_sampler=False``);
    or any iterable of batches, each a tree of arrays or tensors taken as it
    is on every process. ``config`` defaults to the state's.
    ``dispatch_batches`` with several processes reads on process 0 only
    (:class:`DataLoaderDispatcher`). ``superbatch=K`` (K > 1) stacks K
    consecutive microbatches into each yielded ``[K, micro, ...]`` batch for
    fused accumulation; a short last stack is padded with its last
    microbatch and its true sample count is the loader's ``remainder``."""
    state = state or AcceleratorState()
    config = config or getattr(state, "dataloader_config", None) or DataLoaderConfiguration()
    # the data-parallel ranks (dp x fsdp of a mesh): tp peers read the same rows
    num_processes = getattr(state, "data_parallel_size", state.num_processes)
    process_index = getattr(state, "data_parallel_rank", state.process_index)
    dataset = getattr(dataloader, "dataset", None)
    batch_size = getattr(dataloader, "batch_size", None)
    if dataset is not None and batch_size is not None and hasattr(dataset, "__len__"):
        collate = getattr(dataloader, "collate_fn", None) or _default_collate
        n = len(dataset)
        if not _loader_shuffles(dataloader):
            sampler = SequentialSampler(n)
        elif config.use_seedable_sampler:
            sampler = SeedableRandomSampler(n, seed=seed)
        else:
            sampler = RandomSampler(n)
        drop_last = bool(getattr(dataloader, "drop_last", False) or config.drop_last)
        shard = BatchSamplerShard(sampler, batch_size, drop_last=drop_last,
                                  num_processes=num_processes, process_index=process_index,
                                  split_batches=config.split_batches,
                                  even_batches=config.even_batches)
        dispatching = bool(config.dispatch_batches) and num_processes > 1
        # dispatching: process 0 alone reads, and reads whole global batches
        factory_shard = BatchSamplerShard(
            sampler, shard.global_batch_size, drop_last=drop_last,
            even_batches=config.even_batches) if dispatching else shard

        def factory():
            for indices, valid in iter(factory_shard):
                yield collate([dataset[i] for i in indices]), valid

        cls = DataLoaderDispatcher if dispatching else DataLoaderShard
        out = cls(factory, len(factory_shard), state.device, shard.local_batch_size, sampler,
                  superbatch=superbatch, _skip_batches=skip_batches,
                  num_processes=num_processes, process_index=process_index)
        # join_uneven_inputs flips .even_batches here; the next epoch reads it
        out.batch_sampler = factory_shard
        return out

    def batches():
        for batch in dataloader:
            yield batch, (find_batch_size(batch) or 0) * num_processes

    try:
        num_batches = len(dataloader)
    except TypeError:
        num_batches = None
    return DataLoaderShard(batches, num_batches, state.device,
                           getattr(dataloader, "global_batch_size", 0) // num_processes or 0,
                           superbatch=superbatch, _skip_batches=skip_batches,
                           num_processes=num_processes, process_index=process_index)


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
