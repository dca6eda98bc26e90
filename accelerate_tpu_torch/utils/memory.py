"""Out-of-memory handling: release memory and search for a batch size.

Port of ``accelerate_tpu/utils/memory.py`` (``release_memory`` :20,
``should_reduce_batch_size`` :35, ``find_executable_batch_size`` :50): the
decorator that halves the batch size on an out-of-memory error and calls
again. The error is CUDA's here: ``torch.OutOfMemoryError`` (what the
caching allocator raises), or a RuntimeError whose message says a CUDA
library ran out of memory; they take the place of XLA's
RESOURCE_EXHAUSTED.
"""

from __future__ import annotations

import functools
import gc
import inspect
from typing import Callable, Optional

import torch

_OOM_MESSAGES = (
    "CUDA out of memory",
    "CUDA error: out of memory",
    "CUBLAS_STATUS_ALLOC_FAILED",
    "cuDNN error: CUDNN_STATUS_ALLOC_FAILED",
)


def release_memory(*objects) -> list:
    """Collect garbage and hand the CUDA allocator's cached blocks back.
    Returns one None for each object: rebind them (``a, b =
    release_memory(a, b)``), since a tensor a caller still holds stays
    allocated."""
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return [None for _ in objects]


def should_reduce_batch_size(exception: BaseException) -> bool:
    """Whether ``exception`` is the device running out of memory."""
    if isinstance(exception, torch.OutOfMemoryError):
        return True
    return isinstance(exception, RuntimeError) and any(
        m in str(exception) for m in _OOM_MESSAGES)


def find_executable_batch_size(function: Optional[Callable] = None,
                               starting_batch_size: int = 128) -> Callable:
    """Decorator: run ``function(batch_size, *args, **kwargs)``, halving
    ``batch_size`` and calling again whenever the device runs out of memory.
    Before each retry the failed call's exception and frames are released,
    garbage is collected and the allocator's cache emptied, so the retry
    does not fail on what the failed call left behind. The size found is
    kept for the next call of the wrapped function.

    Usage::

        @find_executable_batch_size(starting_batch_size=64)
        def train(batch_size, ...): ...
    """
    if function is None:
        return functools.partial(find_executable_batch_size,
                                 starting_batch_size=starting_batch_size)

    batch_size_holder = [starting_batch_size]

    @functools.wraps(function)
    def wrapper(*args, **kwargs):
        params = list(inspect.signature(function).parameters.keys())
        if not params or params[0] != "batch_size":
            raise TypeError(
                f"Batch size was passed into `{function.__name__}` as the first argument, "
                f"but its signature must start with `batch_size` (got {params})")
        while True:
            if batch_size_holder[0] == 0:
                raise RuntimeError("No executable batch size found, reached zero.")
            try:
                return function(batch_size_holder[0], *args, **kwargs)
            except Exception as e:  # noqa: BLE001 - anything but an OOM is re-raised
                if not should_reduce_batch_size(e):
                    raise
            # outside the handler: the exception and the frames it held are free
            release_memory()
            batch_size_holder[0] //= 2

    return wrapper
