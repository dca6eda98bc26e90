"""Profiling and measurement: memory probes, step timing and the profiler.

Port of ``accelerate_tpu/utils/profiling.py``: ``device_memory_stats``,
``host_memory_rss``, ``PeakHostMemory``, ``start_measure``/``end_measure``/
``log_measures``, ``StepTimer``, ``ProfileKwargs`` (:272), ``profile()`` and
``ProfileHandle`` (:319-346) and ``annotate``, with ``torch.profiler`` where
the reference uses ``jax.profiler`` and a CUDA synchronise where it calls
``block_until_ready``.

A profiler session is a ``torch.profiler.profile`` started, stepped once a
training step and stopped; at its stop the trace is exported as Chrome JSON
(``*.pt.trace.json``, which Perfetto and ``chrome://tracing`` open) into the
session's directory. One session records at a time in a process, as with
``jax.profiler``: :func:`start_trace` refuses a second.
"""

from __future__ import annotations

import contextlib
import gc
import os
import resource
import socket
import statistics
import threading
import time
import weakref
from dataclasses import dataclass
from typing import Any, Optional, Union

import torch

from ..logging import get_logger

logger = get_logger(__name__)


# ---------------------------------------------------------------------- #
# device / host memory probes
# ---------------------------------------------------------------------- #
def device_memory_stats(device: Optional[Union[int, str, torch.device]] = None) -> dict[str, int]:
    """Bytes in use, peak bytes in use and the capacity of one CUDA device
    (``device``: an index or a ``torch.device``; None: the current CUDA
    device), from ``torch.cuda.memory_stats`` of that device. Keys:
    ``bytes_in_use``, ``peak_bytes_in_use``, ``bytes_limit``; zeros for a
    device that gives no numbers (the CPU, or no CUDA device at all)."""
    zeros = {"bytes_in_use": 0, "peak_bytes_in_use": 0, "bytes_limit": 0}
    if device is None:
        if not torch.cuda.is_available():
            return zeros
        device = torch.cuda.current_device()
    device = torch.device("cuda", device) if isinstance(device, int) else torch.device(device)
    if device.type != "cuda":
        return zeros
    stats = torch.cuda.memory_stats(device)
    return {
        "bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
        "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
        "bytes_limit": int(torch.cuda.get_device_properties(device).total_memory),
    }


def host_memory_rss() -> int:
    """The process's resident set size in bytes (Linux)."""
    with open("/proc/self/statm") as f:
        return int(f.read().split()[1]) * resource.getpagesize()


class PeakHostMemory:
    """Background sampler for peak host RSS (the reference's :69).

    The monitor thread holds only a weak reference to the tracker: a
    bracket abandoned without ``stop()`` exits its thread as soon as the
    tracker is collected. ``stop()`` wakes the thread and joins it, so when
    it returns the thread is gone and repeated ``start()``/``stop()``
    brackets never stack threads."""

    def __init__(self):
        self._stop_event = threading.Event()
        self._peak = -1
        self._thread: Optional[threading.Thread] = None

    @staticmethod
    def _monitor(ref: "weakref.ref[PeakHostMemory]", stop_event: threading.Event):
        while not stop_event.is_set():
            self = ref()
            if self is None:
                break
            self._peak = max(self._peak, host_memory_rss())
            del self  # don't pin the tracker between samples
            stop_event.wait(0.001)

    def start(self):
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "PeakHostMemory.start() while already monitoring; use one "
                "tracker per measurement bracket"
            )
        self._stop_event = threading.Event()  # fresh per bracket
        self._peak = host_memory_rss()
        self._thread = threading.Thread(
            target=PeakHostMemory._monitor,
            args=(weakref.ref(self), self._stop_event),
            daemon=True,
        )
        self._thread.start()

    def stop(self) -> int:
        """Stop and join the monitor thread; returns the observed peak.
        Idempotent: extra calls return the last peak."""
        self._stop_event.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        return self._peak


def _cuda_indices() -> range:
    return range(torch.cuda.device_count()) if torch.cuda.is_available() else range(0)


def start_measure() -> dict[str, Any]:
    """Snapshot wall time, host RSS and the bytes in use of every CUDA
    device (the reference's ``start_measure``, from its
    benchmarks/measures_util.py:52)."""
    gc.collect()
    measures: dict[str, Any] = {"time": time.perf_counter(), "host": host_memory_rss()}
    for i in _cuda_indices():
        stats = device_memory_stats(i)
        measures[f"device:{i}"] = stats["bytes_in_use"]
        measures[f"device:{i}-peak"] = stats["peak_bytes_in_use"]
    tracker = PeakHostMemory()  # one tracker per bracket
    tracker.start()
    measures["_tracker"] = tracker
    return measures


def end_measure(start: dict[str, Any]) -> dict[str, Any]:
    """Deltas since :func:`start_measure`: seconds elapsed, host RSS delta
    and peak growth, and for each CUDA device the bytes-in-use delta and
    ``device:{i}-peak``, the growth of its high-water mark inside the window
    (0 when the window stayed below an earlier peak, as the reference
    reports; the peak is not reset, so an enclosing measurement keeps
    its own)."""
    out: dict[str, Any] = {"time": time.perf_counter() - start["time"]}
    gc.collect()
    out["host"] = host_memory_rss() - start["host"]
    out["host-peak"] = max(0, start["_tracker"].stop() - start["host"])
    for i in _cuda_indices():
        stats = device_memory_stats(i)
        out[f"device:{i}"] = stats["bytes_in_use"] - start[f"device:{i}"]
        out[f"device:{i}-peak"] = max(0, stats["peak_bytes_in_use"] - start[f"device:{i}-peak"])
    return out


def log_measures(measures: dict[str, Any], description: str = "run") -> None:
    """Human-readable dump (the reference's ``log_measures``)."""
    print(f"{description}:")
    print(f"- Time: {measures['time']:.2f}s")
    for key, value in measures.items():
        if key.startswith(("device", "host")):
            print(f"- {key}: {value >> 20} MiB")


# ---------------------------------------------------------------------- #
# step timing
# ---------------------------------------------------------------------- #
class StepTimer:
    """Wall-clock timer for steps. A step returns before the CUDA device
    finishes it, so ``tick`` synchronises the devices of the result it is
    handed, charging the step its whole device time. The first ``skip``
    ticks (builds, warm-up) are left out of the statistics."""

    def __init__(self, skip: int = 1):
        self.skip = skip
        self.times: list[float] = []
        self._count = 0
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        pass

    def tick(self, result: Any = None) -> float:
        """Mark one step done (waiting for ``result`` if given); returns
        the step's seconds."""
        if result is not None:
            from ..telemetry.collector import _synchronize  # the step records' wait

            _synchronize(result)
        now = time.perf_counter()
        dt = now - self._t0 if self._t0 is not None else 0.0
        self._t0 = now
        self._count += 1
        if self._count > self.skip:
            self.times.append(dt)
        return dt

    def summary(self) -> dict[str, float]:
        if not self.times:
            return {"steps": 0}
        ordered = sorted(self.times)
        pos = 0.9 * (len(ordered) - 1)  # numpy's linear percentile
        lo = int(pos)
        hi = min(lo + 1, len(ordered) - 1)
        return {
            "steps": len(ordered),
            "mean_s": statistics.fmean(ordered),
            "median_s": statistics.median(ordered),
            "p90_s": ordered[lo] + (ordered[hi] - ordered[lo]) * (pos - lo),
            "min_s": ordered[0],
            "total_s": sum(ordered),
        }


# ---------------------------------------------------------------------- #
# the profiler
# ---------------------------------------------------------------------- #
@dataclass
class ProfileKwargs:
    """Configuration for :meth:`Accelerator.profile` and the diagnostics'
    triggered captures (the reference's fields, each given its
    ``torch.profiler`` meaning).

    ``output_trace_dir``: where the trace goes; None makes profiling a
    no-op, so ``accelerator.profile()`` can wrap the loop unconditionally.
    ``skip_first``: steps left out before the trace starts; the loop calls
    :meth:`ProfileHandle.step` once a step so the handle knows when they are
    over. ``host_tracer_level``: 0 traces the CUDA device alone, 1 and up
    add the CPU activity (PyTorch operators and ``record_function``
    ranges, which :func:`annotate` opens), 3 and up also record each
    operator's input shapes (``record_shapes``). ``python_tracer_level``:
    above 0 records the Python stack of each operator (``with_stack``).
    ``create_perfetto_link``: ``torch.profiler`` makes no link; the Chrome
    JSON trace opens in ui.perfetto.dev as it is, so when True its path is
    logged at warning level at the stop.
    """

    output_trace_dir: Optional[str] = None
    skip_first: int = 0
    host_tracer_level: int = 2
    python_tracer_level: int = 0
    create_perfetto_link: bool = False


def _profiler_kwargs(kw: ProfileKwargs) -> dict:
    activities = []
    if kw.host_tracer_level >= 1 or not torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CPU)
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    return {
        "activities": activities,
        "record_shapes": kw.host_tracer_level >= 3,
        "with_stack": kw.python_tracer_level > 0,
    }


def start_trace(target: str, kw: ProfileKwargs) -> torch.profiler.profile:
    """Start one ``torch.profiler`` session with ``kw``'s options, whose
    trace :func:`stop_trace` will write into ``target``, and return it.
    Raises RuntimeError while another session records in this process (one
    at a time, as ``jax.profiler`` allows)."""
    if torch.autograd._profiler_enabled():
        raise RuntimeError("a torch.profiler session is already recording in this process")
    prof = torch.profiler.profile(**_profiler_kwargs(kw))
    prof.start()
    return prof


def stop_trace(prof: torch.profiler.profile, target: str,
               kw: Optional[ProfileKwargs] = None) -> str:
    """Stop ``prof`` and export its trace into ``target`` as
    ``{host}_{pid}.{time_ns}.pt.trace.json`` (the name
    ``torch.profiler.tensorboard_trace_handler`` gives); returns its path."""
    prof.stop()
    path = os.path.join(target, f"{socket.gethostname()}_{os.getpid()}."
                                f"{time.time_ns()}.pt.trace.json")
    prof.export_chrome_trace(path)
    if kw is not None and kw.create_perfetto_link:
        logger.warning(f"profiler trace: open {path} in https://ui.perfetto.dev")
    return path


class ProfileHandle:
    """A live profiling session. ``dir`` is the trace directory. With
    ``skip_first > 0`` the trace starts lazily at the ``skip_first``-th
    :meth:`step` call; otherwise it is already running on entry.
    ``trace_path`` names the exported trace once the session stopped."""

    def __init__(self, target: str, kw: ProfileKwargs):
        self.dir = target
        self.trace_path: Optional[str] = None
        self._kw = kw
        self._prof: Optional[torch.profiler.profile] = None
        self._started = False
        self._stopped = False
        self._steps = 0

    def _start(self):
        if self._started:
            return
        logger.info(f"torch.profiler trace -> {self.dir}")
        self._prof = start_trace(self.dir, self._kw)
        self._started = True

    def step(self):
        """Mark one training step done: starts the trace at the
        ``skip_first``-th call, and marks the step in a running trace."""
        self._steps += 1
        if self._prof is not None:
            self._prof.step()
        elif self._steps >= self._kw.skip_first:
            self._start()

    def _stop(self):
        if self._started and not self._stopped:
            self.trace_path = stop_trace(self._prof, self.dir, self._kw)
        self._stopped = True


@contextlib.contextmanager
def profile(output_trace_dir: Optional[str] = None, kwargs: Optional[ProfileKwargs] = None):
    """Trace the enclosed steps with ``torch.profiler``; yields a
    :class:`ProfileHandle` (or None when no directory is configured). An
    error inside the block propagates after the trace is stopped."""
    kw = kwargs or ProfileKwargs(output_trace_dir=output_trace_dir)
    target = output_trace_dir or kw.output_trace_dir
    if target is None:
        yield None
        return
    os.makedirs(target, exist_ok=True)
    handle = ProfileHandle(target, kw)
    if kw.skip_first <= 0:
        handle._start()
    try:
        yield handle
    finally:
        handle._stop()


def annotate(name: str):
    """A named range in the trace timeline (``torch.profiler.record_function``;
    the reference's ``jax.profiler.TraceAnnotation``)."""
    return torch.profiler.record_function(name)
