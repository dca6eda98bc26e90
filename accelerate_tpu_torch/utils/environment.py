"""Environment-variable flags.

Port of ``accelerate_tpu/utils/environment.py`` (``str_to_bool`` :16,
``parse_flag_from_env`` :26): the truth values the reference accepts in an
``ACCELERATE_TPU_*`` variable, read the same way.
"""

from __future__ import annotations

import os


def str_to_bool(value: str) -> int:
    """A case-insensitive truthy or falsy string as 1 or 0."""
    value = value.lower()
    if value in ("y", "yes", "t", "true", "on", "1"):
        return 1
    if value in ("n", "no", "f", "false", "off", "0"):
        return 0
    raise ValueError(f"invalid truth value {value!r}")


def parse_flag_from_env(key: str, default: bool = False) -> bool:
    """The boolean in environment variable ``key``, ``default`` when unset."""
    value = os.environ.get(key, str(default))
    try:
        return bool(str_to_bool(value))
    except ValueError:
        raise ValueError(f"If set, {key} must be yes/no/true/false, got {value!r}.")
