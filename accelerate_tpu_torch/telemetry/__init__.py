"""Telemetry for the serving path.

Port of the serving half of ``accelerate_tpu/telemetry/``:
:class:`StepTelemetry` with its serving records, :class:`TelemetryConfig`
and the sinks (:class:`JSONLSink`, :class:`PrometheusTextSink`). The step
records, the heartbeat watchdog, retrace detection, the HTTP exporter and
``TrackerBridgeSink`` are not ported yet (ROADMAP.md, queue A10).
"""

from .collector import StepTelemetry
from .config import TelemetryConfig
from .sinks import SCHEMA_VERSION, JSONLSink, PrometheusTextSink, TelemetrySink

__all__ = [
    "JSONLSink",
    "PrometheusTextSink",
    "SCHEMA_VERSION",
    "StepTelemetry",
    "TelemetryConfig",
    "TelemetrySink",
]
