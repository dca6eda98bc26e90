"""Telemetry configuration.

Port of ``accelerate_tpu/telemetry/config.py:TelemetryConfig`` (:18) with
the fields of the serving records, the sinks, the training step records
(:82-87), the training census, the heartbeat watchdog and diagnostics, and
the reference's ``__post_init__`` (:97-131). The step records always carry
the step's 0-d metrics (the reference's default). Across processes the
records go to the sinks on process 0 only, the reference's default; its
``all_ranks`` switch (every process's sinks) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Callable, Optional, Union

if TYPE_CHECKING:  # import cycle: diagnostics reads telemetry records
    from ..diagnostics.config import DiagnosticsConfig


@dataclass
class TelemetryConfig:
    """Knobs for :class:`~accelerate_tpu_torch.telemetry.StepTelemetry`.

    ``enabled``: master switch; a disabled collector's hooks are no-ops,
    so the step wrapper adds no synchronise. ``jsonl_path``: attach a
    :class:`~accelerate_tpu_torch.telemetry.JSONLSink` writing one record a
    line to this path. ``memory_interval``: put device and host memory on
    every N-th step record (0: never). ``census_interval``: take a buffer
    census (``profiling.census.BufferCensus``) and emit it as a
    ``kind="memory"`` record every N emitted step records (0, the default:
    never; diagnostics' leak rule reads these records).
    ``census_min_interval_s``: the least wall-clock spacing between two
    census samples (the serving engine asks for one at every gauge
    sample). ``tokens_fn``: ``batch -> int`` for throughput; by default the
    first tensor with two dims gives ``shape[0] * shape[1]``.
    ``flops_per_token`` (with ``device_peak_flops``, per device): records
    carry ``model_flops_per_s`` (and ``mfu``). ``history``: records kept in
    memory (a ring; sinks see every record).

    ``heartbeat``: start the :class:`~accelerate_tpu_torch.telemetry.HeartbeatMonitor`
    hang watchdog (beaten at every step record, stall after
    ``heartbeat_stall_timeout_s`` of silence). ``heartbeat_dir``
    additionally writes ``heartbeat-rank{i}.json`` at most every
    ``heartbeat_interval_s``, and implies ``heartbeat``.

    ``diagnostics``: attach the interpretation layer
    (:class:`~accelerate_tpu_torch.diagnostics.DiagnosticsManager`): goodput
    accounting, anomaly detection, anomaly-triggered trace capture and the
    per-process flight recorder. ``True`` for defaults, a path string for
    ``DiagnosticsConfig(dir=path)``, or a full
    :class:`~accelerate_tpu_torch.diagnostics.DiagnosticsConfig`. When the
    diagnostics dir is set and no ``heartbeat_dir`` was given, the
    heartbeat files land in the same dir: ``diagnose`` wants both in one
    place."""

    enabled: bool = True
    jsonl_path: Optional[str] = None
    memory_interval: int = 1
    census_interval: int = 0
    census_min_interval_s: float = 1.0
    tokens_fn: Optional[Callable[[Any], Optional[int]]] = None
    flops_per_token: Optional[float] = None
    device_peak_flops: Optional[float] = None
    history: int = 1024
    heartbeat: bool = False
    heartbeat_dir: Optional[str] = None
    heartbeat_interval_s: float = 10.0
    heartbeat_stall_timeout_s: float = 300.0
    diagnostics: Optional[Union[bool, str, "DiagnosticsConfig"]] = None

    def __post_init__(self):
        if self.memory_interval < 0:
            raise ValueError("memory_interval must be >= 0")
        if self.census_interval < 0:
            raise ValueError("census_interval must be >= 0")
        if self.census_min_interval_s < 0:
            raise ValueError("census_min_interval_s must be >= 0")
        if self.history < 1:
            raise ValueError("history must be >= 1")
        if self.diagnostics is not None:
            # lazy import: diagnostics.diagnose reads telemetry heartbeats
            from ..diagnostics.config import DiagnosticsConfig

            if self.diagnostics is False:
                self.diagnostics = None
            elif self.diagnostics is True:
                self.diagnostics = DiagnosticsConfig()
            elif isinstance(self.diagnostics, str):
                self.diagnostics = DiagnosticsConfig(dir=self.diagnostics)
            elif not isinstance(self.diagnostics, DiagnosticsConfig):
                raise TypeError(
                    "diagnostics must be bool, a dump-dir path, or a "
                    f"DiagnosticsConfig; got {type(self.diagnostics).__name__}"
                )
        if (
            self.diagnostics is not None
            and self.diagnostics.dir is not None
            and self.heartbeat_dir is None
        ):
            self.heartbeat_dir = self.diagnostics.dir
        if self.heartbeat_dir is not None:
            # a dir implies the watchdog: writing rank files without the
            # monitor thread would leave them permanently stale
            self.heartbeat = True
