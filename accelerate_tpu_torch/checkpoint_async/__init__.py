"""Async checkpointing: saves whose disk IO runs behind the next training
steps, and the atomic commit protocol every save uses.

* :mod:`.commit`: the commit protocol (``<dir>.tmp`` work dirs, every
  process's done marker and the barrier on them, one rename and
  ``COMMITTED``), shared by sync and async saves, so no save leaves a torn
  checkpoint.
* :mod:`.writer`: :class:`AsyncCheckpointer` (the bounded writer thread
  and its page-locked buffer sets) and :func:`save_accelerator_state_async`
  (snapshot, then enqueue).

Entry points: ``CheckpointManager(..., async_saves=True)`` for managed
loops, ``accelerator.save_state(..., block=False)`` for direct use.
"""

from .commit import COMMITTED_MARKER, TMP_SUFFIX, is_committed, work_dir_for
from .writer import AsyncCheckpointer, CheckpointJob, save_accelerator_state_async

__all__ = [
    "AsyncCheckpointer",
    "CheckpointJob",
    "save_accelerator_state_async",
    "COMMITTED_MARKER",
    "TMP_SUFFIX",
    "is_committed",
    "work_dir_for",
]
