"""Atomic commit protocol for checkpoint directories, one process.

Port of ``accelerate_tpu/checkpoint_async/commit.py:40-208`` for one
process. A checkpoint is either committed or invisible:

1. the save writes its files into ``<final>.tmp/``, the work dir;
2. it drops its ``done_00000`` marker and the ``topology.json`` record;
3. it writes the ``COMMITTED`` marker and makes ONE
   ``os.rename(work, final)``.

Readers only take ``checkpoint_<n>`` names and directories that carry
``COMMITTED``, so a ``.tmp`` work dir, the only state a crash before the
rename can leave, is never restored from, counted or rotated; the next save
to the same name discards it. With one process the reference's barrier on
the done markers has nothing to wait for.
"""

from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

from ..logging import get_logger

logger = get_logger(__name__)

TMP_SUFFIX = ".tmp"
COMMITTED_MARKER = "COMMITTED"
DONE_MARKER_PATTERN = "done_{:05d}"
TOPOLOGY_FILE = "topology.json"


def work_dir_for(final_dir: str) -> str:
    """The uncommitted work dir a save targets before the commit rename."""
    return os.path.normpath(final_dir) + TMP_SUFFIX


def is_work_dir(path: str) -> bool:
    return os.path.normpath(path).endswith(TMP_SUFFIX)


def is_committed(path: str) -> bool:
    return os.path.isfile(os.path.join(path, COMMITTED_MARKER))


def _fsync_path(path: str) -> None:
    """fsync a file or directory entry; best-effort where a filesystem
    refuses directory fsync."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def write_marker(directory: str, name: str) -> str:
    """Durably create the empty marker file ``directory/name``."""
    path = os.path.join(directory, name)
    with open(path, "w") as f:
        f.flush()
        os.fsync(f.fileno())
    _fsync_path(directory)
    return path


def write_topology(work_dir: str, topology: dict[str, Any]) -> str:
    """Durably write the save-time topology record into the work dir."""
    path = os.path.join(work_dir, TOPOLOGY_FILE)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(topology, f, indent=2, sort_keys=True)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    _fsync_path(work_dir)
    return path


def read_topology(checkpoint_dir: str) -> Optional[dict[str, Any]]:
    """The topology record a checkpoint was saved under, or None."""
    path = os.path.join(checkpoint_dir, TOPOLOGY_FILE)
    if not os.path.isfile(path):
        return None
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def commit(work_dir: str, final_dir: str, topology: Optional[dict[str, Any]] = None) -> str:
    """Steps 2-3 of the protocol; returns ``final_dir``. An existing
    ``final_dir`` (an explicit output dir saved to again) is swapped aside
    first so the rename still lands atomically."""
    write_marker(work_dir, DONE_MARKER_PATTERN.format(0))
    if topology is not None:
        write_topology(work_dir, topology)
    write_marker(work_dir, COMMITTED_MARKER)
    if os.path.isdir(final_dir):
        backup = f"{final_dir}.old.{os.getpid()}"
        os.rename(final_dir, backup)
        os.rename(work_dir, final_dir)
        shutil.rmtree(backup, ignore_errors=True)
    else:
        os.rename(work_dir, final_dir)
    _fsync_path(os.path.dirname(os.path.normpath(final_dir)) or ".")
    logger.info(f"committed checkpoint {final_dir}")
    return final_dir


def discard_work_dir(work_dir: str) -> None:
    """Remove an uncommitted work dir (a stale one from a crashed save)."""
    if is_work_dir(work_dir):
        shutil.rmtree(work_dir, ignore_errors=True)
