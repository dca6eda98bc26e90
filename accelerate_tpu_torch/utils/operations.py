"""Tree helpers and the collectives' one-process forms.

Port of ``accelerate_tpu/utils/operations.py`` (``recursively_apply``
:64, ``send_to_device`` :87, ``gather`` :192, ``gather_object`` :221,
``reduce`` :278, ``pad_across_processes`` :301) for one process: a
collective over one process returns its input (as a tensor), so the
reference's call sites keep their shape. The multi-process forms come with
``torch.distributed`` (ROADMAP.md, queue A4).
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch


def is_tensor(x: Any) -> bool:
    return isinstance(x, (torch.Tensor, np.ndarray))


def recursively_apply(func: Callable, data: Any, *args,
                      test_type: Callable[[Any], bool] = is_tensor,
                      error_on_other_type: bool = False, **kwargs) -> Any:
    """``func`` applied to every leaf of a dict/list/tuple tree that passes
    ``test_type``; other leaves are kept (or refused)."""
    if isinstance(data, dict):
        return type(data)({k: recursively_apply(func, v, *args, test_type=test_type,
                                                error_on_other_type=error_on_other_type,
                                                **kwargs) for k, v in data.items()})
    if isinstance(data, (tuple, list)):
        items = [recursively_apply(func, v, *args, test_type=test_type,
                                   error_on_other_type=error_on_other_type, **kwargs)
                 for v in data]
        return type(data)(*items) if hasattr(data, "_fields") else type(data)(items)
    if test_type(data):
        return func(data, *args, **kwargs)
    if error_on_other_type:
        raise TypeError(f"Unsupported type {type(data)} passed to "
                        f"{getattr(func, '__name__', func)}.")
    return data


def _as_tensor(x: Any) -> torch.Tensor:
    return torch.from_numpy(x) if isinstance(x, np.ndarray) else x


def send_to_device(data: Any, device: Any, non_blocking: bool = True,
                   skip_keys: Optional[list[str]] = None) -> Any:
    """Every array leaf of a dict/list/tuple tree as a tensor on ``device``."""
    if isinstance(data, dict) and skip_keys:
        return {k: v if k in skip_keys else send_to_device(v, device, non_blocking)
                for k, v in data.items()}
    return recursively_apply(lambda x: _as_tensor(x).to(device, non_blocking=non_blocking),
                             data)


def gather(tensor: Any) -> Any:
    """One process: every leaf as a tensor, unchanged."""
    return recursively_apply(_as_tensor, tensor)


def gather_object(object: Any) -> list[Any]:
    """One process: ``[object]``."""
    return [object]


def reduce(tensor: Any, reduction: str = "mean", scale: float = 1.0) -> Any:
    """One process: the sum or mean over one copy, times ``scale``."""
    if reduction not in ("sum", "mean"):
        raise ValueError(f"reduction must be 'sum' or 'mean', got {reduction!r}")
    return recursively_apply(lambda x: _as_tensor(x) * scale, tensor)


def pad_across_processes(tensor: Any, dim: int = 0, pad_index: int = 0,
                         pad_first: bool = False) -> Any:
    """One process: nothing to pad to."""
    return tensor
