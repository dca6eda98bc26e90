"""Telemetry for the training step and the serving path.

Port of ``accelerate_tpu/telemetry/``: :class:`StepTelemetry` with its
training step records, its serving and soak records and its buffer census
(``profiling/census.py``), rebuild detection (:class:`RecompileDetector`),
:class:`TelemetryConfig`, the sinks (:class:`JSONLSink`,
:class:`PrometheusTextSink`) and the heartbeat watchdog
(:class:`HeartbeatMonitor`, :func:`scan_heartbeats`). The HTTP exporter
and ``TrackerBridgeSink`` are not ported yet (ROADMAP.md, queue A10).
"""

from .collector import StepTelemetry
from .config import TelemetryConfig
from .heartbeat import HeartbeatMonitor, partition_liveness, scan_heartbeats
from .recompile import RecompileDetector, tree_fingerprint
from .sinks import SCHEMA_VERSION, JSONLSink, PrometheusTextSink, TelemetrySink

__all__ = [
    "HeartbeatMonitor",
    "JSONLSink",
    "PrometheusTextSink",
    "RecompileDetector",
    "SCHEMA_VERSION",
    "StepTelemetry",
    "TelemetryConfig",
    "TelemetrySink",
    "partition_liveness",
    "scan_heartbeats",
    "tree_fingerprint",
]
