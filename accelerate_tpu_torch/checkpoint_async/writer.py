"""The bounded background checkpoint writer.

Port of ``accelerate_tpu/checkpoint_async/writer.py``. Across processes
every process submits its own job (process 0's holds the state, the others'
only their RNG file) and its writer thread ends in the done-marker barrier
of ``commit.py``. The train loop's share of an async save is the snapshot: every CUDA leaf
of the state copied into a set of page-locked host buffers with
``non_blocking`` copies on the current stream, one event recorded after
the last copy, every CPU leaf cloned, and the host state (RNG, counters,
loader cursors, schedulers) captured. One writer thread then waits on the
event, serialises, writes, fsyncs and commits, while the next steps run.

The reference relies on JAX arrays being immutable. Here the step updates
params, moments and counters in place, so the snapshot never shares
storage with them, and stream order is what makes the copies read the
state of the step the save was given: they are queued after that step's
kernels and before the next step's in-place updates. The price is that
the next step's kernels start only once the copies are done on the card.

Backpressure: the job queue holds ``max_pending`` jobs (default 1), and
there are ``max_pending + 1`` sets of pinned buffers, allocated at the
first save and reused after; a set goes back to the pool only when its job
has finished writing. A save that finds every set in flight waits, so
saves are never dropped. The blocked time (buffer and queue waits,
snapshot, capture) and the background time are reported apart through
telemetry as ``kind="checkpoint"`` records.

The writer thread's only CUDA call is the event's ``synchronize``.
A background failure is kept and re-raised on the next ``submit`` or
``wait``: its work dir is discarded, so nothing half-written is visible.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import threading
import time
from typing import Any, Optional

from .. import dist_checkpoint
from ..logging import get_logger
from . import commit as commit_mod

logger = get_logger(__name__)

_STOP = object()


@dataclasses.dataclass
class CheckpointJob:
    """Everything one async save needs after the snapshot: host copies of
    the tensors, the captured host state and where to commit."""

    final_dir: str
    work_dir: str
    shard_snapshot: Optional[dist_checkpoint.ShardSnapshot]
    host_files: list  # [(filename, kind, payload)] from _capture_host_state
    named_files: list  # [(filename, {name: host tensor}, safe)] raw-loop optimizer states
    step: Optional[int]
    blocked_s: float  # buffer wait + snapshot + capture + queue wait
    buffers: Optional[dist_checkpoint.HostBuffers] = None  # the pinned set the job holds
    # the save-time topology record (checkpointing.topology_metadata)
    topology: Optional[dict] = None
    process_index: int = 0  # this process's done marker; process 0 commits
    world: int = 1


class AsyncCheckpointer:
    """Owns the writer thread, the pinned buffer sets and the in-flight
    bookkeeping. Jobs run in submission order on one thread, so two saves
    never interleave or commit out of order. ``wait()`` drains everything
    in flight (the preemption contract: drain, then write the final
    checkpoint synchronously); ``close()`` drains and stops the thread."""

    def __init__(self, telemetry: Any = None, max_pending: int = 1):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        self.telemetry = telemetry
        self.max_pending = max_pending
        self.buffers = dist_checkpoint.HostBufferPool(max_pending + 1)
        self._queue: queue.Queue = queue.Queue(maxsize=max_pending)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._pending = 0  # jobs submitted and not yet finished
        self._idle = threading.Event()
        self._idle.set()
        self.saves_completed = 0

    # ------------------------------------------------------------------ #
    @property
    def in_flight(self) -> bool:
        """True while any submitted save has not finished writing."""
        return not self._idle.is_set()

    def _raise_pending_error(self) -> None:
        with self._lock:
            err, self._error = self._error, None
        if err is not None:
            raise RuntimeError(
                "a background checkpoint write failed; the checkpoint was NOT committed (its "
                ".tmp work dir was discarded)") from err

    def _ensure_thread(self) -> None:
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, name="ckpt-writer", daemon=True)
            self._thread.start()

    def submit(self, job: CheckpointJob) -> float:
        """Enqueue a job; blocks only while ``max_pending`` jobs are queued.
        The queue wait is added to ``job.blocked_s`` before the job is
        enqueued (the writer reads the job afterwards) and returned."""
        self._raise_pending_error()
        self._ensure_thread()
        wait_s = 0.0
        if self._queue.full():
            # one producer: once not full, the put below cannot block
            t0 = time.perf_counter()
            while self._queue.full():
                time.sleep(0.005)
            wait_s = time.perf_counter() - t0
            job.blocked_s += wait_s
        with self._lock:
            self._pending += 1
            self._idle.clear()
        self._queue.put(job)
        return wait_s

    def wait(self, timeout_s: Optional[float] = None) -> None:
        """Drain: block until every submitted save has committed or failed
        (a failure re-raises here)."""
        if not self._idle.wait(timeout=timeout_s):
            raise TimeoutError(f"async checkpoint drain did not finish within {timeout_s}s")
        self._raise_pending_error()

    def close(self) -> None:
        """Drain and stop the writer thread (idempotent)."""
        if self._thread is not None and self._thread.is_alive():
            self.wait()
            self._queue.put(_STOP)
            self._thread.join()
        self._thread = None
        self._raise_pending_error()

    # ------------------------------------------------------------------ #
    def _run(self) -> None:
        while True:
            job = self._queue.get()
            if job is _STOP:
                return
            try:
                self._write(job)
            except BaseException as exc:  # noqa: BLE001 — kept, re-raised on submit/wait
                logger.warning(f"background checkpoint write for {job.final_dir} failed: {exc!r}")
                commit_mod.discard_work_dir(job.work_dir)
                with self._lock:
                    self._error = exc
            finally:
                if job.buffers is not None:
                    self.buffers.release(job.buffers)
                with self._lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.set()

    def _write(self, job: CheckpointJob) -> None:
        from ..checkpointing import _nbytes, _save_named, _write_host_state

        t0 = time.perf_counter()
        if job.buffers is not None:
            job.buffers.wait()  # the copies into the pinned set have landed
        os.makedirs(job.work_dir, exist_ok=True)
        nbytes = 0
        if job.shard_snapshot is not None:
            nbytes += dist_checkpoint.write_snapshot(job.shard_snapshot, job.work_dir, fsync=True)
        for fname, named, safe in job.named_files:
            _save_named(named, os.path.join(job.work_dir, fname), safe)
            nbytes += _nbytes(named)
        _write_host_state(job.host_files, job.work_dir)
        commit_mod.commit(job.work_dir, job.final_dir, job.process_index, job.world,
                          topology=job.topology)
        background_s = time.perf_counter() - t0
        self.saves_completed += 1
        if self.telemetry is not None:
            self.telemetry.record_checkpoint(
                step=job.step, directory=job.final_dir, mode="async", blocked_s=job.blocked_s,
                background_s=background_s, bytes_written=nbytes)


def save_accelerator_state_async(accelerator, checkpointer: AsyncCheckpointer,
                                 output_dir: Optional[str] = None, carry: Any = None,
                                 params: Any = None) -> str:
    """The background counterpart of
    ``checkpointing.save_accelerator_state``. What runs here: the directory
    (and rotation), a pinned buffer set (waiting while every set is in
    flight), the snapshot's copies queued on the current stream, and the
    host-state capture. Serialisation, IO, fsync and the commit run on the
    writer thread. Returns the FINAL directory the save will commit to; it
    does not exist yet (``checkpointer.wait()`` blocks until it does)."""
    from ..checkpointing import (
        _capture_host_state,
        _checkpoint_dir,
        _tree_of,
        flatten_tree,
        topology_metadata,
    )
    from ..utils.constants import OPTIMIZER_NAME

    t0 = time.perf_counter()
    checkpointer._raise_pending_error()
    final_dir = _checkpoint_dir(accelerator, output_dir)
    work_dir = commit_mod.work_dir_for(final_dir)
    is_main = accelerator.is_main_process
    if is_main:
        commit_mod.discard_work_dir(work_dir)  # a stale one from a crashed run
    accelerator.wait_for_everyone()
    logger.info(f"Async-saving current state to {final_dir}")

    tree = carry if carry is not None else _tree_of(params)
    # the raw loop's optimizer states (no carry) go to files of their own;
    # the tree and those files are the main process's to write
    opt_states = [] if carry is not None or not is_main else [
        (f"{OPTIMIZER_NAME}_{i}", flatten_tree(opt.opt_state))
        for i, opt in enumerate(accelerator._optimizers) if opt.opt_state is not None]
    layout = ([] if tree is None or not is_main
              else dist_checkpoint.device_layout(flatten_tree(tree)))
    for name, named in opt_states:
        layout += dist_checkpoint.device_layout(named, prefix=f"{name}/")
    buffers = checkpointer.buffers.acquire(layout)  # waits while every set is in flight
    try:
        snapshot = None if tree is None else dist_checkpoint.snapshot_tree(
            tree, buffers, process_index=accelerator.process_index)
        named_files = [(f"{name}.safetensors",
                        dist_checkpoint.host_copies(named, buffers, prefix=f"{name}/"), True)
                       for name, named in opt_states]
        buffers.seal()
        host_files = _capture_host_state(accelerator, carry)
    except BaseException:
        checkpointer.buffers.release(buffers)
        raise
    accelerator.project_configuration.iteration += 1
    job = CheckpointJob(
        final_dir=final_dir, work_dir=work_dir, shard_snapshot=snapshot, host_files=host_files,
        named_files=named_files, step=accelerator.step, blocked_s=0.0, buffers=buffers,
        topology=topology_metadata(accelerator), process_index=accelerator.process_index,
        world=accelerator.num_processes)
    job.blocked_s = time.perf_counter() - t0
    queue_wait = checkpointer.submit(job)
    if queue_wait > 0.01:
        logger.info(f"async checkpoint backpressure: waited {queue_wait:.2f}s for the previous "
                    "save to drain (disk slower than the cadence)")
    return final_dir
