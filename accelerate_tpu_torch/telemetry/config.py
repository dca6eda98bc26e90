"""Telemetry configuration.

Port of ``accelerate_tpu/telemetry/config.py:TelemetryConfig`` (:18) with
the fields of the serving records, the sinks and the training step
records (:82-87). The step records always carry the step's 0-d metrics
(the reference's default), and the census rides the serving engine's
gauge samples only. The heartbeat and diagnostics switches wait for
``diagnostics/`` (ROADMAP.md, queue A item 2b); ``all_ranks`` belongs to
multi-process runs, which the port does not have yet (records go to the
sinks on rank 0 only, the reference's default).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional


@dataclass
class TelemetryConfig:
    """Knobs for :class:`~accelerate_tpu_torch.telemetry.StepTelemetry`.

    ``enabled``: master switch; a disabled collector's hooks are no-ops,
    so the step wrapper adds no synchronise. ``jsonl_path``: attach a
    :class:`~accelerate_tpu_torch.telemetry.JSONLSink` writing one record a
    line to this path. ``memory_interval``: put device and host memory on
    every N-th step record (0: never). ``census_min_interval_s``: the least
    wall-clock spacing between two ``kind="memory"`` census samples (the
    serving engine asks for one at every gauge sample). ``tokens_fn``:
    ``batch -> int`` for throughput; by default the first tensor with two
    dims gives ``shape[0] * shape[1]``. ``flops_per_token`` (with
    ``device_peak_flops``, per device): records carry ``model_flops_per_s``
    (and ``mfu``). ``history``: records kept in memory (a ring; sinks see
    every record)."""

    enabled: bool = True
    jsonl_path: Optional[str] = None
    memory_interval: int = 1
    census_min_interval_s: float = 1.0
    tokens_fn: Optional[Callable[[Any], Optional[int]]] = None
    flops_per_token: Optional[float] = None
    device_peak_flops: Optional[float] = None
    history: int = 1024

    def __post_init__(self):
        if self.memory_interval < 0:
            raise ValueError("memory_interval must be >= 0")
        if self.census_min_interval_s < 0:
            raise ValueError("census_min_interval_s must be >= 0")
        if self.history < 1:
            raise ValueError("history must be >= 1")
