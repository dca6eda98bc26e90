"""Build the port's CUDA sources into shared libraries and bind them.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for Hopper (``sm_90a``) into ``build/lib<name>-<hash>.so`` beside
this file, on first use and never at import, and loaded with ``ctypes``.
The hash covers the source, the headers beside it and the flags, so an
edited source or header is rebuilt and a stale library is never loaded.
The build directory is not committed.
``bind`` types a library's functions once; ``launch`` calls one on the
current stream and raises on the error code it returns.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",  # registers, shared memory and spills go to the build log
)

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOGS: dict[str, str] = {}  # name -> nvcc output of this process's build


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (neither on PATH nor under CUDA_HOME): the CUDA "
        "toolkit is needed to build the port's kernels"
    )


def _target(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of that source,
    every ``csrc/*.cuh`` header (sorted by name) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh"), key=lambda p: p.name):
        digest.update(header.name.encode() + header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str]) -> dict[str, float]:
    """Compile every source in ``names`` that has no up-to-date library,
    one ``nvcc`` per source, all started together. Returns the seconds each
    build took (0.0 when the library was already there). Raises with the
    compiler's output when a build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    started = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        started[name] = (proc, tmp, out, time.perf_counter())
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            tmp.replace(out)  # atomic: a reader never sees a partial library
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``csrc/<name>.cu``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


# ---------------------------------------------------------------------- #
# the C interface every source shares: pointers and the stream as void*,
# dtypes by these codes, a cudaError code returned, and an exported
# ``const char* <prefix>_error_string(int)``
# ---------------------------------------------------------------------- #
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def bind(name: str, signatures: dict, error_string: str, returns: dict = None) -> ctypes.CDLL:
    """``load(name)`` with its functions typed once: each of ``signatures``
    (function -> argtypes) returns an int error code, unless ``returns``
    gives its restype."""
    lib = load(name)
    if not getattr(lib, "_typed", False):
        for fn_name, argtypes in signatures.items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = (returns or {}).get(fn_name, ctypes.c_int)
        lib.error_string = getattr(lib, error_string)
        lib.error_string.argtypes = [ctypes.c_int]
        lib.error_string.restype = ctypes.c_char_p
        lib._typed = True
    return lib


def launch(lib: ctypes.CDLL, fn_name: str, *args, device) -> None:
    """Call ``fn_name(*args, stream)`` on ``device``'s current stream;
    raise on a non-zero cudaError."""
    with torch.cuda.device(device):
        err = getattr(lib, fn_name)(*args, torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"{fn_name} launch failed: cudaError {err} ({lib.error_string(err).decode()})"
        )
