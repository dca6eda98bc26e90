"""Copies of the port with text edits, built together: what
tools/flash_mutants.py (planted faults) and tools/flash_variants.py (timed
variants) share.

A copy holds the port and chip_smoke.py under the gitignored build
directory ``accelerate_tpu_torch/ops/build/``. Each edit must match its
source exactly once, so a kernel rewrite must update the tools' anchors;
the committed source never carries a fault or a variant.
"""

from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
BUILD = REPO / "accelerate_tpu_torch" / "ops" / "build"


def make_copy(root: Path, edits) -> Path:
    """The port and chip_smoke.py copied into ``root`` (without the build
    directory), then ``edits`` applied: (source relative to the repo, old
    text, new text), each old text found exactly once."""
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "accelerate_tpu_torch", root / "accelerate_tpu_torch",
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    shutil.copy2(REPO / "chip_smoke.py", root / "chip_smoke.py")
    for source, old, new in edits:
        src = root / source
        text = src.read_text()
        if text.count(old) != 1:
            raise SystemExit(f"{root.name}: the text to replace is not in {source} exactly "
                             f"once:\n{old}")
        src.write_text(text.replace(old, new))
    return root


def build_copies(roots: dict, sources) -> dict:
    """Build ``sources`` in every copy of ``roots`` (name -> root), one
    process a copy and one nvcc a source, all started together. Returns each
    copy's nvcc output (ptxas's registers and spills); exits on a failed
    build."""
    script = ("from accelerate_tpu_torch.ops import _build; "
              f"_build.build({list(sources)!r}); print(''.join(_build.BUILD_LOGS.values()))")
    procs = {name: subprocess.Popen([sys.executable, "-c", script], cwd=root,
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for name, root in roots.items()}
    logs = {}
    for name, proc in procs.items():
        logs[name], _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise SystemExit(f"{name}: the build failed:\n{logs[name][-3000:]}")
    return logs


def library(root: Path, source: str) -> Path:
    """The library that a copy built from ``csrc/<source>.cu``."""
    (lib,) = (root / "accelerate_tpu_torch" / "ops" / "build").glob(f"lib{source}-*.so")
    return lib
