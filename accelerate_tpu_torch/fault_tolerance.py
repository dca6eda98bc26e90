"""Periodic checkpoints, preemption handling and automatic resume.

Port of ``accelerate_tpu/fault_tolerance.py:42-280``:

* **cadence and rotation**: a checkpoint every ``every_n_steps`` calls of
  :meth:`CheckpointManager.step`, rotated by the project's ``total_limit``;
* **preemption**: a SIGTERM (and SIGINT, when asked) turns the next
  ``step()`` into a drain of the saves in flight, a final synchronous
  checkpoint and a clean stop, so a preempted job loses at most one step;
* **resume**: :meth:`restore_or_init` continues from the newest committed
  checkpoint, falling back to the next-newest when one fails to load (a
  load that fails changes nothing, ``checkpointing.load_accelerator_state``).

Usage::

    manager = CheckpointManager(accelerator, every_n_steps=500)
    carry, resumed = manager.restore_or_init(carry)
    for batch in loader:
        carry, metrics = step(carry, batch)
        manager.step(carry)
        if manager.should_stop:
            break

Saves and restores run across processes through ``checkpointing.py``
(restore onto another world size with ``allow_reshape``); the elastic
supervisor that relaunches a run on a changed fleet is not ported yet
(ROADMAP.md, queue A4).
"""

from __future__ import annotations

import atexit
import os
import signal
import threading
from typing import Any, Iterable, Optional, Tuple

from .checkpoint_async import AsyncCheckpointer, save_accelerator_state_async
from .checkpointing import _list_checkpoints
from .logging import get_logger

logger = get_logger(__name__)


class CheckpointManager:
    """Periodic and preemption-driven checkpoints, with resume.

    ``every_n_steps``: the cadence, in ``step()`` calls. ``handle_signals``:
    install handlers (main thread only) for ``signals`` (SIGTERM by default;
    add ``signal.SIGINT`` to give Ctrl-C the same final-checkpoint-then-stop
    contract) that request a final checkpoint instead of dying mid-write.
    ``heartbeat``: any object with ``beat(count)``, called on every
    ``step()`` (default: the telemetry's ``heartbeat``, if it has one).

    ``async_saves=True`` makes the cadence saves background saves
    (``checkpoint_async``): ``step()`` blocks only for the snapshot. On a
    preemption signal the manager drains the saves in flight, then writes
    the final checkpoint synchronously: it is committed, and the newest,
    before ``should_stop`` turns True. ``max_pending`` bounds the queued
    background saves (backpressure; no save is dropped).

    Needs ``ProjectConfiguration(project_dir=..., automatic_checkpoint_naming=True)``,
    checked here so the failure comes at construction, not at the first
    (perhaps preemption-triggered) save.
    """

    def __init__(self, accelerator, every_n_steps: int = 500, handle_signals: bool = True,
                 heartbeat=None, async_saves: bool = False, max_pending: int = 1,
                 signals: Iterable[int] = (signal.SIGTERM,)):
        if every_n_steps < 1:
            raise ValueError("every_n_steps must be >= 1")
        if not accelerator.project_configuration.automatic_checkpoint_naming:
            raise ValueError(
                "CheckpointManager needs automatic checkpoint naming: Accelerator(project_config="
                "ProjectConfiguration(project_dir=..., automatic_checkpoint_naming=True))")
        self.accelerator = accelerator
        self.every_n_steps = every_n_steps
        if heartbeat is None:
            heartbeat = getattr(getattr(accelerator, "telemetry", None), "heartbeat", None)
        self.heartbeat = heartbeat
        self.async_saves = async_saves
        self._checkpointer = None
        if async_saves:
            self._checkpointer = AsyncCheckpointer(
                telemetry=getattr(accelerator, "telemetry", None), max_pending=max_pending)
        self._count = 0
        self._preempted = threading.Event()
        self._preemption_logged = False
        self._stopped = False
        self._closed = False
        self._prev_handlers: dict[int, Any] = {}
        if handle_signals and threading.current_thread() is threading.main_thread():
            for sig in signals:
                self._prev_handlers[sig] = signal.signal(sig, self._on_preemption)
        # an abandoned manager still drains its writer at interpreter exit;
        # close() is idempotent, so close() then atexit is safe
        atexit.register(self.close)

    # ------------------------------------------------------------------ #
    def _on_preemption(self, signum, frame):
        # async-signal-safe: only set the flag (logging here could deadlock
        # on the handler lock if the signal interrupts a logging call)
        self._preempted.set()

    @property
    def preempted(self) -> bool:
        return self._preempted.is_set()

    @property
    def should_stop(self) -> bool:
        """True once a preemption's final checkpoint has been written."""
        return self._stopped

    # ------------------------------------------------------------------ #
    def restore_or_init(self, carry: Any, allow_reshape: Optional[bool] = None
                        ) -> Tuple[Any, bool]:
        """Resume from the newest committed checkpoint if there is one, else
        return ``carry`` unchanged; call once before the loop. A committed
        checkpoint that fails to load (a shard file lost, a torn manifest)
        is skipped with a warning for the next-newest; only when every one
        fails does the newest failure propagate. ``allow_reshape`` goes to
        ``Accelerator.load_state``."""
        pc = self.accelerator.project_configuration
        base = os.path.join(pc.project_dir or ".", "checkpoints")
        if not os.path.isdir(base) or not _list_checkpoints(base):
            return carry, False
        last_exc: Optional[Exception] = None
        for ck in reversed(_list_checkpoints(base)):
            try:
                restored = self.accelerator.load_state(ck, carry=carry,
                                                       allow_reshape=allow_reshape)
            except Exception as exc:
                logger.warning(f"checkpoint {ck} is unusable ({exc!r}); falling back to the "
                               "next-newest committed checkpoint")
                # name the skip in the flight recorder, where there is one
                diagnostics = getattr(getattr(self.accelerator, "telemetry", None),
                                      "diagnostics", None)
                recorder = getattr(diagnostics, "recorder", None)
                if recorder is not None:
                    try:
                        recorder.event("checkpoint_skipped", checkpoint=ck, error=repr(exc))
                    except Exception:
                        pass  # observability must not break the fallback
                last_exc = exc
                continue
            logger.info(f"resumed from step {self.accelerator.step} ({ck})")
            return restored, True
        raise RuntimeError(f"every checkpoint under {base} failed to load; the newest failure "
                           "is chained below") from last_exc

    def step(self, carry: Any) -> Optional[str]:
        """Call once per optimizer step. Saves on the cadence (in the
        background when so configured), or at once when preempted (then
        ``should_stop`` turns True). Returns the checkpoint dir of a save
        started or written: for a background save the name it will commit
        to (:meth:`wait` blocks until it has)."""
        self._count += 1
        if self.heartbeat is not None:
            self.heartbeat.beat(self._count)
        preempted = self.preempted
        if preempted and not self._preemption_logged:
            self._preemption_logged = True
            logger.warning("preemption signal received: writing the final checkpoint")
        if not preempted and self._count % self.every_n_steps:
            return None
        if preempted:
            # drain the background saves first (their commits must not race
            # the final checkpoint's rotation), then save synchronously
            self.wait()
            out = self.accelerator.save_state(carry=carry)
            self._stopped = True
            logger.warning(f"preemption checkpoint written to {out}")
            diagnostics = getattr(self.accelerator.telemetry, "diagnostics", None)
            if diagnostics is not None:
                diagnostics.dump("preemption")
            return out
        if self.async_saves:
            return save_accelerator_state_async(self.accelerator, self._checkpointer,
                                                carry=carry)
        return self.accelerator.save_state(carry=carry)

    @property
    def in_flight(self) -> bool:
        """True while a background save has not committed yet."""
        return self._checkpointer is not None and self._checkpointer.in_flight

    def wait(self) -> None:
        """Drain every background save in flight (a no-op in sync mode);
        a background write's failure re-raises here."""
        if self._checkpointer is not None:
            self._checkpointer.wait()

    def close(self) -> None:
        """Drain the background saves and put back the signal handlers found
        at construction. Idempotent: ``__exit__`` and the atexit hook both
        call it, and a second call neither re-installs handlers (clobbering
        one installed since) nor touches the stopped writer."""
        if self._closed:
            return
        self._closed = True
        atexit.unregister(self.close)
        if self._checkpointer is not None:
            self._checkpointer.close()
        if threading.current_thread() is threading.main_thread():
            for sig, handler in self._prev_handlers.items():
                # only our own handler: a newer manager's stays in place
                if signal.getsignal(sig) == self._on_preemption:
                    signal.signal(sig, handler)
        self._prev_handlers.clear()

    def __enter__(self) -> "CheckpointManager":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
