"""Atomic commit protocol for checkpoint directories.

Port of ``accelerate_tpu/checkpoint_async/commit.py:40-208``. A checkpoint
is either committed or invisible:

1. every process writes its files into ``<final>.tmp/``, the work dir;
2. each drops its ``done_{p:05d}`` marker once its files are on the disk
   (``mark_done``), and waits until every process's marker is there
   (``wait_for_done_markers``, a barrier through the filesystem that times
   out naming the processes whose markers are missing);
3. process 0 writes the ``topology.json`` record and the ``COMMITTED``
   marker and makes ONE ``os.rename(work, final)``; the others return once
   ``final`` exists.

Readers only take ``checkpoint_<n>`` names and directories that carry
``COMMITTED``, so a ``.tmp`` work dir, the only state a crash before the
rename can leave, is never restored from, counted or rotated; the next save
to the same name discards it.
"""

from __future__ import annotations

import json
import os
import shutil
import time
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


def mark_done(work_dir: str, process_index: int) -> str:
    """Publish that this process's files in ``work_dir`` are on the disk."""
    return write_marker(work_dir, DONE_MARKER_PATTERN.format(process_index))


def wait_for_done_markers(work_dir: str, world: int, timeout_s: float = 600.0,
                          poll_s: float = 0.05) -> None:
    """Block until every process's done marker is in ``work_dir`` (at once
    for ``world`` 1). The work dir vanishing counts as passing: process 0
    renames it the moment it sees the last marker, so a process whose scan
    loses that race must not poll a missing directory until the timeout.
    Raises TimeoutError naming the processes whose markers are missing."""
    deadline = time.monotonic() + timeout_s
    missing = list(range(world))
    while missing:
        if not os.path.isdir(work_dir):
            return  # renamed away by process 0: every marker existed
        missing = [p for p in missing
                   if not os.path.isfile(os.path.join(work_dir, DONE_MARKER_PATTERN.format(p)))]
        if not missing:
            return
        if time.monotonic() > deadline:
            raise TimeoutError(f"checkpoint commit barrier timed out after {timeout_s}s: "
                               f"missing done markers from processes {missing} in {work_dir}")
        time.sleep(poll_s)


def commit(work_dir: str, final_dir: str, process_index: int = 0, world: int = 1,
           timeout_s: float = 600.0, topology: Optional[dict[str, Any]] = None) -> str:
    """Steps 2-3 of the protocol for this process; returns ``final_dir``.
    Process 0 renames (an existing ``final_dir``, an explicit output dir
    saved to again, is swapped aside first so the rename still lands
    atomically) and stamps ``topology`` after the barrier, so it records a
    save every process finished; the others return once ``final_dir`` is
    visible, so they may read it back at once."""
    mark_done(work_dir, process_index)
    wait_for_done_markers(work_dir, world, timeout_s=timeout_s)
    if process_index != 0:
        deadline = time.monotonic() + timeout_s
        while not os.path.isdir(final_dir):
            if time.monotonic() > deadline:
                raise TimeoutError(f"process {process_index}: {final_dir} did not appear "
                                   f"within {timeout_s}s of the commit barrier")
            time.sleep(0.05)
        return final_dir
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
