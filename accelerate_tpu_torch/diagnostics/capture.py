"""Anomaly-triggered (and operator-triggered) ``torch.profiler`` capture.

Port of ``accelerate_tpu/diagnostics/capture.py``: a capture is a
``torch.profiler.profile`` over the CPU and CUDA activities
(``utils.profiling.start_trace``) where the reference starts
``jax.profiler`` (:135). It is started at a step boundary, stepped at each
boundary after, and stopped after ``capture_steps`` steps, when its trace
is exported as Chrome JSON into the capture's directory (:162). One
profiler session records at a time: a capture requested while
``Accelerator.profile`` records fails to start, and is logged, as the
reference's is.

The profile you need is the one of the step that just went wrong — by
the time a human attaches TensorBoard the straggler is gone. When an
anomaly fires (or a trigger file appears, or SIGUSR1 arrives on a live
job), the next ``capture_steps`` steps are captured into a fresh
subdirectory of ``trace_dir``; at most ``max_captures`` captures per run
bound the disk and overhead. Reuses the ``utils/profiling.py`` tracer
plumbing (``ProfileKwargs`` options) so ``Accelerator(profile_kwargs=...)``
tracer levels apply to triggered captures too.

All step-path methods run on the train-loop thread (the collector calls
them from ``end_step``), matching the profiler's single-session
model; trigger *requests* may come from any thread or a signal handler
(they only set flags).
"""

from __future__ import annotations

import os
import signal
import threading
import time
from typing import Optional

from ..logging import get_logger
from ..utils import profiling
from ..utils.profiling import ProfileKwargs
from .config import DiagnosticsConfig

logger = get_logger(__name__)


class TraceCapture:
    """Bounded, triggered profiler captures for one process."""

    def __init__(
        self,
        config: Optional[DiagnosticsConfig] = None,
        profile_kwargs: Optional[ProfileKwargs] = None,
    ):
        self.config = config or DiagnosticsConfig()
        self.profile_kwargs = profile_kwargs or ProfileKwargs()
        self.captures: list[dict] = []  # one entry per started capture
        self._finished: list[dict] = []  # stopped, not yet drained
        self._pending: Optional[str] = None  # reason of the queued capture
        self._active: Optional[dict] = None
        self._prof = None  # the running torch.profiler session
        self._remaining = 0
        self._signal_flag = False
        self._prev_sigusr1 = None
        self._trigger_mtime: Optional[float] = None
        self._lock = threading.Lock()

    # ------------------------------------------------------------------ #
    @property
    def enabled(self) -> bool:
        return self.config.trace_dir is not None and self.config.max_captures > 0

    @property
    def exhausted(self) -> bool:
        return len(self.captures) >= self.config.max_captures

    @property
    def active(self) -> bool:
        return self._active is not None

    def request(self, reason: str) -> bool:
        """Queue a capture (from any thread / the anomaly path). The next
        step boundary starts it. Returns False when disabled, exhausted,
        or a capture is already active/pending."""
        if not self.enabled:
            return False
        with self._lock:
            if self.exhausted or self._active is not None or self._pending:
                return False
            self._pending = reason
            return True

    def install_signal(self) -> bool:
        """SIGUSR1 -> capture request (main thread only; live-job story:
        ``kill -USR1 <pid>`` profiles the next N steps)."""
        if threading.current_thread() is not threading.main_thread():
            return False
        self._prev_sigusr1 = signal.signal(signal.SIGUSR1, self._on_sigusr1)
        return True

    def _on_sigusr1(self, signum, frame):
        # async-signal-safe: only set the flag; the step path consumes it
        self._signal_flag = True

    def check_external(self) -> None:
        """Poll the operator triggers (trigger file mtime, SIGUSR1 flag);
        called once per step from the collector."""
        if self._signal_flag:
            self._signal_flag = False
            self.request("sigusr1")
        path = self.config.trigger_file
        if path is None:
            return
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            return
        # each touch of the file is one request (consume by mtime)
        if self._trigger_mtime is None or mtime > self._trigger_mtime:
            self._trigger_mtime = mtime
            self.request("trigger_file")

    # ------------------------------------------------------------------ #
    def on_step(self, step: Optional[int] = None) -> Optional[dict]:
        """Advance the capture state machine at one step boundary; returns
        the capture entry when a capture STARTED at this boundary."""
        self.check_external()
        with self._lock:
            if self._active is not None:
                self._prof.step()
                self._remaining -= 1
                if self._remaining <= 0:
                    self._stop_locked()
                return None
            reason = self._pending
            if reason is None:
                return None
            self._pending = None
            return self._start_locked(reason, step)

    def _start_locked(self, reason: str, step: Optional[int]) -> Optional[dict]:
        idx = len(self.captures)
        target = os.path.join(
            self.config.trace_dir, f"capture{idx:02d}_{reason}"
        )
        try:
            os.makedirs(target, exist_ok=True)
            self._prof = profiling.start_trace(target, self.profile_kwargs)
        except Exception as exc:  # a live TensorBoard session may own the
            # profiler — diagnostics must never take down training
            logger.warning(f"triggered trace capture failed to start: {exc}")
            return None
        entry = {
            "dir": target,
            "reason": reason,
            "start_step": step,
            "steps": self.config.capture_steps,
            "time_unix": time.time(),
        }
        self.captures.append(entry)
        self._active = entry
        self._remaining = self.config.capture_steps
        logger.warning(
            "capturing the next %d step(s) with torch.profiler -> %s "
            "(trigger: %s; capture %d/%d this run)",
            self.config.capture_steps, target, reason,
            idx + 1, self.config.max_captures,
        )
        return entry

    def _stop_locked(self) -> None:
        try:
            profiling.stop_trace(self._prof, self._active["dir"], self.profile_kwargs)
        except Exception as exc:
            logger.warning(f"triggered trace capture failed to stop: {exc}")
        else:
            # the trace is on disk now — queue it for post-processing
            # (the manager derives overlap_pct at the next step boundary)
            self._finished.append(self._active)
        self._active = None
        self._prof = None
        self._remaining = 0

    def pop_finished(self) -> Optional[dict]:
        """Drain one completed (stopped-and-written) capture entry, oldest
        first; None when nothing finished since the last call."""
        with self._lock:
            return self._finished.pop(0) if self._finished else None

    def close(self) -> None:
        """Stop any in-flight capture and restore the signal handler."""
        with self._lock:
            if self._active is not None:
                self._stop_locked()
        if self._prev_sigusr1 is not None:
            try:
                signal.signal(signal.SIGUSR1, self._prev_sigusr1)
            except (ValueError, OSError):
                pass  # not the main thread anymore
            self._prev_sigusr1 = None

    def summary(self) -> dict:
        return {
            "trace_captures": len(self.captures),
            "trace_capture_dirs": [c["dir"] for c in self.captures],
        }
