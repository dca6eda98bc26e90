"""Telemetry configuration.

Port of ``accelerate_tpu/telemetry/config.py:TelemetryConfig`` (:18) with
the fields the serving records and the sinks read. The training-side
fields (``memory_interval``, ``census_interval``, ``tokens_fn``,
``flops_per_token``, ``device_peak_flops``, ``include_step_metrics``, the
heartbeat and diagnostics switches) belong to the step records, which are
not ported yet (ROADMAP.md, queue A10); ``all_ranks`` belongs to
multi-process runs, which the serving port does not have (records go to
the sinks on rank 0 only, the reference's default).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional


@dataclass
class TelemetryConfig:
    """Knobs for :class:`~accelerate_tpu_torch.telemetry.StepTelemetry`.

    ``enabled``: master switch; a disabled collector's hooks are no-ops.
    ``jsonl_path``: attach a :class:`~accelerate_tpu_torch.telemetry.JSONLSink`
    writing one record a line to this path. ``census_min_interval_s``: the
    least wall-clock spacing between two ``kind="memory"`` samples (the
    engine asks for one at every gauge sample). ``history``: records kept
    in memory (a ring; sinks see every record)."""

    enabled: bool = True
    jsonl_path: Optional[str] = None
    census_min_interval_s: float = 1.0
    history: int = 1024

    def __post_init__(self):
        if self.census_min_interval_s < 0:
            raise ValueError("census_min_interval_s must be >= 0")
        if self.history < 1:
            raise ValueError("history must be >= 1")
