"""Deprecated shim: port of ``accelerate_tpu/memory_utils.py``, which keeps
the pre-0.12 import path of ``find_executable_batch_size`` with a warning.
Import from ``accelerate_tpu_torch.utils.memory`` instead."""

import warnings

from .utils.memory import find_executable_batch_size  # noqa: F401

warnings.warn(
    "memory_utils is deprecated; import from accelerate_tpu_torch.utils.memory instead",
    FutureWarning,
)
