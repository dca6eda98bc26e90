"""A small reader and writer of the safetensors format.

The reference writes its checkpoints with the ``safetensors`` package
(``accelerate_tpu/checkpointing.py:169``, ``dist_checkpoint.py``). The
port reads and writes the same files with this codec instead, so that a
machine without that package can save, resume, and read the reference's
checkpoints. The format: an 8-byte little-endian header length N, N bytes
of JSON (``{name: {"dtype", "shape", "data_offsets": [begin, end]},
"__metadata__": {str: str}}``, padded with spaces to a multiple of 8), then
the tensors' raw little-endian bytes, back to back from offset 0.
"""

from __future__ import annotations

import json
import math
import os
import struct
import sys
from typing import Optional

import torch

DTYPES = {
    "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I32": torch.int32, "I64": torch.int64, "U8": torch.uint8,
}
CODES = {dtype: code for code, dtype in DTYPES.items()}

if sys.byteorder != "little":  # the format is little-endian, and so is every tensor here
    raise ImportError("the safetensors codec assumes a little-endian host")


def _raw(t: torch.Tensor) -> memoryview:
    """The tensor's bytes, in row-major order, as a flat view."""
    t = t.detach().to("cpu").contiguous().reshape(-1)
    return memoryview(t.view(torch.uint8).numpy())


def save_file(tensors: dict[str, torch.Tensor], path: str,
              metadata: Optional[dict[str, str]] = None) -> int:
    """Write ``tensors`` to ``path``; returns the bytes of tensor data."""
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    names = sorted(tensors)
    for name in names:
        t = tensors[name]
        if t.dtype not in CODES:
            raise TypeError(f"{name}: dtype {t.dtype} is not one of {list(DTYPES.values())}")
        size = t.numel() * t.element_size()
        header[name] = {"dtype": CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + size]}
        offset += size
    blob = json.dumps(header, separators=(",", ":")).encode()
    blob += b" " * (-len(blob) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(blob)))
        f.write(blob)
        for name in names:
            if tensors[name].numel():
                f.write(_raw(tensors[name]))
        f.flush()
        os.fsync(f.fileno())
    return offset


class SafeFile:
    """An open safetensors file: its header read once, tensors read by name.
    Close it, or use it in a ``with`` statement."""

    def __init__(self, path: str):
        self.path = path
        self._f = open(path, "rb")
        try:
            head = self._f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: not a safetensors file (shorter than 8 bytes)")
            (n,) = struct.unpack("<Q", head)
            self.header = json.loads(self._f.read(n))
        except BaseException:
            self._f.close()
            raise
        self.metadata = self.header.pop("__metadata__", None)
        self._start = 8 + n

    def keys(self) -> list[str]:
        return list(self.header)

    def get(self, name: str) -> torch.Tensor:
        """The tensor ``name`` as a CPU tensor."""
        entry = self.header[name]
        dtype = DTYPES.get(entry["dtype"])
        if dtype is None:
            raise TypeError(f"{self.path}: {name} has dtype {entry['dtype']}, "
                            f"not one of {list(DTYPES)}")
        begin, end = entry["data_offsets"]
        shape = tuple(entry["shape"])
        if end - begin != math.prod(shape) * torch.empty((), dtype=dtype).element_size():
            raise ValueError(f"{self.path}: {name} has {end - begin} bytes for shape {shape}")
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        buf = bytearray(end - begin)
        self._f.seek(self._start + begin)
        if self._f.readinto(buf) != len(buf):
            raise ValueError(f"{self.path}: truncated at {name}")
        return torch.frombuffer(buf, dtype=dtype).reshape(shape)

    def close(self) -> None:
        self._f.close()

    def __enter__(self) -> "SafeFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_file(path: str) -> dict[str, torch.Tensor]:
    """Every tensor of ``path`` as a CPU tensor."""
    with SafeFile(path) as f:
        return {name: f.get(name) for name in f.keys()}
