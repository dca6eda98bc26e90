"""Diagnostics configuration.

Port of ``accelerate_tpu/diagnostics/config.py``, as it stands.

One dataclass controls the interpretation layer on top of the telemetry
stream: goodput accounting, anomaly detection, triggered trace capture,
and the flight recorder. Reaches the collector through
``TelemetryConfig(diagnostics=...)`` or ``Accelerator(diagnostics=...)``
(``True`` for defaults).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class DiagnosticsConfig:
    """Knobs for :class:`~accelerate_tpu_torch.diagnostics.DiagnosticsManager`.

    ``dir``: where this process dumps its flight-recorder file
    (``flightrec-rank{i}.json``, atomic tmp+rename). Point every host at
    the same shared directory — ideally the telemetry ``heartbeat_dir`` —
    and ``diagnose <dir>`` aggregates the fleet. ``None``
    disables dumps (goodput/anomaly still run in-memory).

    **Goodput** — every second of run wall-clock lands in exactly one
    bucket: ``productive`` (step execution minus in-step compile),
    ``compile`` (in-step retraces + AOT warmups), ``dataloader`` (host
    blocked waiting for a batch), ``checkpoint`` (train-loop blocked
    seconds of saves; async background time is hidden by design and NOT
    badput), ``idle`` (the unaccounted remainder: setup, eval,
    recovery). ``goodput_interval`` steps between ``kind="goodput"``
    records (0 keeps it summary-only); ``goodput_window_s`` sizes the
    rolling ``rolling_goodput_pct``.

    **Anomaly detection** — a rolling median/MAD baseline over
    ``step_time_s``, ``loss`` and ``grad_norm``. ``slow_step_factor``:
    a non-retraced step slower than ``factor * median`` (and beyond
    ``mad_z`` robust z-scores) is a straggler. ``mad_z``: robust z
    threshold for loss spikes. NaN/inf loss or grad norm fires
    ``nan_grad`` immediately. Each type is rate-limited to one
    ``kind="anomaly"`` record per ``anomaly_cooldown_steps`` steps (and
    ``anomaly_cooldown_s`` seconds); suppressed repeats are counted on
    the next record. ``anomaly_sample_every``: observe the median/MAD
    baselines only every Nth step record (NaN/inf detection still runs
    on EVERY record — a skipped NaN is a lost run). The baseline fold
    sorts the rolling window (O(w log w) per observation host-side);
    sampling makes the per-step cost O(1) amortized for sub-millisecond
    steps where even that shows up. 1 (default) checks every step.

    **Leak detection** — over ``kind="memory"`` census records:
    ``memory_leak`` fires when *unowned* census bytes rise on every one
    of the last ``leak_min_samples`` censuses by at least
    ``leak_min_growth_bytes`` total (owned growth — a KV pool filling —
    never alarms). Same cooldown machinery as the other types.

    **Triggered trace capture** — when an anomaly fires (or
    ``trigger_file`` appears / SIGUSR1 arrives), the next
    ``capture_steps`` steps are captured with ``torch.profiler`` into
    ``trace_dir/capture<k>_<reason>/``; at most ``max_captures`` per
    run. ``trace_dir=None`` disables captures.

    **Flight recorder** — a ring of the last ``ring_size`` telemetry
    records and ``max_events`` events per process, dumped atomically to
    ``dir`` every ``dump_interval_s`` seconds and immediately on
    unhandled exception (``install_excepthook``), heartbeat stall, and
    preemption — so a SIGKILLed/OOM-killed process still leaves its
    last committed dump behind for ``diagnose``.
    """

    dir: Optional[str] = None
    # goodput
    goodput: bool = True
    goodput_interval: int = 16
    goodput_window_s: float = 300.0
    # anomaly detection
    anomaly: bool = True
    anomaly_window: int = 64
    anomaly_min_samples: int = 8
    slow_step_factor: float = 3.0
    mad_z: float = 8.0
    anomaly_cooldown_steps: int = 50
    anomaly_cooldown_s: float = 30.0
    anomaly_sample_every: int = 1
    # leak detection (over kind="memory" census records)
    leak_min_samples: int = 5
    leak_min_growth_bytes: int = 1 << 20
    # triggered trace capture
    trace_dir: Optional[str] = None
    capture_steps: int = 3
    max_captures: int = 3
    capture_on_anomaly: bool = True
    trigger_file: Optional[str] = None
    sigusr1: bool = False
    # flight recorder
    ring_size: int = 256
    max_events: int = 128
    dump_interval_s: float = 30.0
    install_excepthook: bool = True
    # a single dataloader wait longer than this becomes a flight-recorder
    # event naming the blocked loader (sustained small waits stay pure
    # goodput accounting)
    dataloader_stall_event_s: float = 1.0

    def __post_init__(self):
        if self.goodput_interval < 0:
            raise ValueError("goodput_interval must be >= 0")
        if self.goodput_window_s <= 0:
            raise ValueError("goodput_window_s must be > 0")
        if self.anomaly_window < 2 or self.anomaly_min_samples < 2:
            raise ValueError("anomaly_window/min_samples must be >= 2")
        if self.anomaly_min_samples > self.anomaly_window:
            raise ValueError("anomaly_min_samples must be <= anomaly_window")
        if self.slow_step_factor <= 1.0:
            raise ValueError("slow_step_factor must be > 1")
        if self.anomaly_sample_every < 1:
            raise ValueError("anomaly_sample_every must be >= 1")
        if self.leak_min_samples < 2:
            raise ValueError("leak_min_samples must be >= 2")
        if self.leak_min_growth_bytes < 0:
            raise ValueError("leak_min_growth_bytes must be >= 0")
        if self.capture_steps < 1:
            raise ValueError("capture_steps must be >= 1")
        if self.max_captures < 0:
            raise ValueError("max_captures must be >= 0")
        if self.ring_size < 1 or self.max_events < 1:
            raise ValueError("ring_size/max_events must be >= 1")
