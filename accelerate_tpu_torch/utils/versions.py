"""Version comparisons.

Port of ``accelerate_tpu/utils/versions.py``: ``compare_versions`` reads a
library's installed version through ``importlib.metadata``;
``is_torch_version`` stands where the reference's ``is_jax_version`` does.
"""

from __future__ import annotations

import importlib.metadata
import operator as op
from typing import Union

from packaging.version import Version, parse

STR_OPERATION_TO_FUNC = {
    ">": op.gt, ">=": op.ge, "==": op.eq, "!=": op.ne, "<=": op.le, "<": op.lt,
}


def compare_versions(library_or_version: Union[str, Version], operation: str,
                     requirement_version: str) -> bool:
    """``compare_versions("torch", ">=", "2.4")``: a library's name resolves
    to its installed version."""
    if operation not in STR_OPERATION_TO_FUNC:
        raise ValueError(f"operation must be one of {sorted(STR_OPERATION_TO_FUNC)}, "
                         f"got {operation!r}")
    if isinstance(library_or_version, str):
        library_or_version = parse(importlib.metadata.version(library_or_version))
    return STR_OPERATION_TO_FUNC[operation](library_or_version, parse(requirement_version))


def is_torch_version(operation: str, version: str) -> bool:
    import torch

    return compare_versions(parse(torch.__version__), operation, version)
