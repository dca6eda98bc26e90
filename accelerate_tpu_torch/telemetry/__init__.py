"""Telemetry for the training step and the serving path.

Port of ``accelerate_tpu/telemetry/``: :class:`StepTelemetry` with its
training step records, its serving and soak records and its buffer census
(``profiling/census.py``), rebuild detection (:class:`RecompileDetector`),
:class:`TelemetryConfig` and the sinks (:class:`JSONLSink`,
:class:`PrometheusTextSink`). The heartbeat watchdog, the HTTP exporter
and ``TrackerBridgeSink`` are not ported yet (ROADMAP.md, queue A item 6).
"""

from .collector import StepTelemetry
from .config import TelemetryConfig
from .recompile import RecompileDetector, tree_fingerprint
from .sinks import SCHEMA_VERSION, JSONLSink, PrometheusTextSink, TelemetrySink

__all__ = [
    "JSONLSink",
    "PrometheusTextSink",
    "RecompileDetector",
    "SCHEMA_VERSION",
    "StepTelemetry",
    "TelemetryConfig",
    "TelemetrySink",
    "tree_fingerprint",
]
