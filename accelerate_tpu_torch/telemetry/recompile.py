"""Rebuild (retrace) detection.

Port of ``accelerate_tpu/telemetry/recompile.py``. In the reference a batch
whose shape or dtype drifts makes XLA retrace and recompile the step. The
port runs eagerly, so nothing is recompiled, but a drifting shape still
defeats what keys on it (the kernels' designs, the CUDA graphs of the
serving path, the allocator's cached blocks), and the signal is the same:
:class:`RecompileDetector` fingerprints the abstract values of every call
(shape and dtype per tensor, never data), counts a signature seen before as
a hit and a new one after the first as a rebuild, and logs the shape diff.
"""

from __future__ import annotations

from typing import Any, Optional

from ..logging import get_logger

logger = get_logger(__name__)

# leaves without shape/dtype (python scalars etc.): only their type counts
_TYPE_ONLY = object()


def _flatten_with_path(tree: Any, path: str, out: list) -> None:
    """(path, leaf) of a dict/list/tuple tree, dict keys in sorted order
    and paths spelled as ``jax.tree_util.keystr`` spells them."""
    if isinstance(tree, dict):
        for key in sorted(tree, key=str):
            _flatten_with_path(tree[key], f"{path}[{key!r}]", out)
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            _flatten_with_path(item, f"{path}[{i}]", out)
    elif tree is not None:
        out.append((path, tree))


def tree_fingerprint(*trees: Any) -> tuple:
    """Abstract fingerprint of trees: ``(path, shape, dtype)`` per tensor
    leaf, ``(path, _TYPE_ONLY, type name)`` per other leaf. Hashable,
    data-free, and a host-side walk (no device sync)."""
    out = []
    for i, tree in enumerate(trees):
        flat: list = []
        _flatten_with_path(tree, f"arg{i}", flat)
        for key, leaf in flat:
            if hasattr(leaf, "shape") and hasattr(leaf, "dtype"):
                out.append((key, tuple(leaf.shape), str(leaf.dtype).replace("torch.", "")))
            else:
                out.append((key, _TYPE_ONLY, type(leaf).__name__))
    return tuple(out)


def _diff_fingerprints(old: tuple, new: tuple) -> str:
    """Human-readable diff naming the changed dimensions."""
    old_map = {k: (s, d) for k, s, d in old}
    new_map = {k: (s, d) for k, s, d in new}
    lines = []
    for key, (shape, dtype) in new_map.items():
        if key not in old_map:
            lines.append(f"{key}: new input {shape} {dtype}")
            continue
        oshape, odtype = old_map[key]
        if oshape == shape and odtype == dtype:
            continue
        if oshape is _TYPE_ONLY or shape is _TYPE_ONLY:
            lines.append(f"{key}: {odtype} -> {dtype}")
            continue
        msg = f"{key}: shape {oshape} -> {shape}"
        if len(oshape) == len(shape):
            dims = [f"dim {i}: {a} -> {b}" for i, (a, b) in enumerate(zip(oshape, shape))
                    if a != b]
            if dims:
                msg += " (" + ", ".join(dims) + ")"
        if odtype != dtype:
            msg += f", dtype {odtype} -> {dtype}"
        lines.append(msg)
    for key in old_map:
        if key not in new_map:
            lines.append(f"{key}: input removed")
    return "; ".join(lines) or "argument tree structure changed"


class RecompileDetector:
    """The abstract input signatures one step function has seen.

    ``check(*trees)`` returns True when the call's signature is new (the
    first call, or a rebuild); a rebuild also logs a WARNING with the shape
    diff against the previous call's signature. Going back to a signature
    seen before is silent."""

    def __init__(self, name: str, max_signatures: int = 128):
        self.name = name
        self.max_signatures = max_signatures
        self.retraces = 0  # new signatures beyond the first
        self._seen: set = set()
        self._last: Optional[tuple] = None

    def check(self, *trees: Any) -> bool:
        fp = tree_fingerprint(*trees)
        if fp in self._seen:
            self._last = fp
            return False
        first = not self._seen
        if len(self._seen) < self.max_signatures:
            # bounded: a shape-unstable loop must not keep one tuple a step
            self._seen.add(fp)
        if not first:
            self.retraces += 1
            logger.warning(
                "rebuild #%d of %s: input shapes/dtypes changed (pad inputs to static "
                "shapes). %s", self.retraces, self.name, _diff_fingerprints(self._last, fp))
        self._last = fp
        return True
