"""Buffer census: whose tensors hold the device memory.

Port of ``accelerate_tpu/profiling/census.py:BufferCensus`` (167 lines).
The allocator says how much device memory is in use; the census says
whose it is. A subsystem registers an owner: a name and a zero-argument
provider that returns the tensors it holds now (a tensor, a module, a
dataclass, or a dict, list or tuple of those). :meth:`BufferCensus.sample`
calls every provider and adds up the untyped storages it reaches, each
counted once by data pointer and given to the first owner that reaches it
(the reference walks ``jax.live_arrays`` by identity; a PyTorch view
shares its base's storage, so the storage is the unit here). What no owner
claims is ``census_unowned_bytes``: ``torch.cuda.memory_allocated()`` less
the owners' device bytes on a CUDA machine, 0 without one (there is no
allocator total to read on the CPU).

A DTensor (a parameter ``Accelerator.prepare`` sharded) counts at its
whole size in its owner's bytes, as the reference's ``nbytes`` of a global
array does; the device bytes set against the allocator are its shard's.

Providers, not captured tensors, so a cache that is replaced stays
attributed without registering again. A provider that raises counts 0
and ``sample`` never raises.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Callable, Iterator, Optional, Union

import torch

from ..logging import get_logger
from ..parallel.sharding import is_dtensor

logger = get_logger(__name__)

Provider = Callable[[], Any]


def _iter_tensors(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of a provider's result, depth first."""
    if tree is None:
        return
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, torch.nn.Module):
        yield from tree.parameters()
        yield from tree.buffers()
    elif isinstance(tree, dict):
        for value in tree.values():
            yield from _iter_tensors(value)
    elif isinstance(tree, (list, tuple)):
        for value in tree:
            yield from _iter_tensors(value)
    elif dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        for f in dataclasses.fields(tree):
            yield from _iter_tensors(getattr(tree, f.name))


class BufferCensus:
    """Owner-attributed snapshot of the tensors the owners hold."""

    def __init__(self, min_interval_s: float = 0.0):
        self._lock = threading.Lock()
        self._owners: dict[str, Provider] = {}
        self.min_interval_s = float(min_interval_s)
        # None, not 0.0, so the first sample always lands
        self._last_sample_t: Optional[float] = None
        self._host_rss_peak = 0
        #: the most recent sample
        self.last: Optional[dict] = None

    def set_owner(self, name: str, provider: Union[Provider, Any]) -> None:
        """Register or replace one owner; a non-callable is wrapped as a
        constant."""
        if not callable(provider) or isinstance(provider, torch.nn.Module):
            tree = provider
            provider = lambda: tree  # noqa: E731
        with self._lock:
            self._owners[name] = provider

    def remove_owner(self, name: str) -> None:
        with self._lock:
            self._owners.pop(name, None)

    def owners(self) -> list[str]:
        with self._lock:
            return list(self._owners)

    def sample(self) -> dict:
        """One census: ``census_owner_bytes`` ({owner: bytes}, 0 for an
        owner that holds nothing), ``census_unowned_bytes``,
        ``census_total_bytes`` (the allocator's bytes in use on a CUDA
        machine, else the owners' sum), ``census_arrays`` (distinct
        storages the owners hold), ``host_rss_bytes`` and
        ``host_rss_peak_bytes`` (the largest RSS over the samples)."""
        from ..utils.profiling import host_memory_rss

        with self._lock:
            owners = dict(self._owners)
        seen: set[tuple[str, int]] = set()
        owner_bytes: dict[str, int] = {}
        device_claimed = 0
        for name, provider in owners.items():
            claimed = 0
            try:
                tensors = list(_iter_tensors(provider()))
            except Exception as exc:  # noqa: BLE001 - a broken owner counts 0
                logger.debug(f"census owner {name!r} provider failed: {exc}")
                tensors = []
            for t in tensors:
                if t.device.type == "meta":
                    continue
                # a DTensor (a sharded parameter) counts at its whole size,
                # as the reference counts a global array; its device bytes
                # are its local shard's
                local = t._local_tensor if is_dtensor(t) else t
                storage = local.untyped_storage()
                key = (str(local.device), storage.data_ptr())
                if key in seen:
                    continue
                seen.add(key)
                claimed += (t.numel() * t.element_size() if local is not t
                            else storage.nbytes())
                if local.device.type == "cuda":
                    device_claimed += storage.nbytes()
            owner_bytes[name] = claimed
        claimed_all = sum(owner_bytes.values())
        if torch.cuda.is_available():
            total = int(torch.cuda.memory_allocated())
            unowned = max(0, total - device_claimed)
        else:
            total, unowned = claimed_all, 0
        rss = host_memory_rss()
        self._host_rss_peak = max(self._host_rss_peak, rss)
        self._last_sample_t = time.monotonic()
        self.last = {
            "census_total_bytes": total,
            "census_unowned_bytes": unowned,
            "census_owner_bytes": owner_bytes,
            "census_arrays": len(seen),
            "host_rss_bytes": rss,
            "host_rss_peak_bytes": self._host_rss_peak,
        }
        return self.last

    def maybe_sample(self, *, force: bool = False) -> Optional[dict]:
        """Throttled :meth:`sample`: None while the last sample is more
        recent than ``min_interval_s`` (``force`` skips the wait)."""
        if (not force and self.min_interval_s > 0 and self._last_sample_t is not None
                and time.monotonic() - self._last_sample_t < self.min_interval_s):
            return None
        try:
            return self.sample()
        except Exception as exc:  # noqa: BLE001 - the census never raises
            logger.debug(f"census sample failed: {exc}")
            return None
