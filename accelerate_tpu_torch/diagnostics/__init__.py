"""Run diagnostics on top of the telemetry stream: goodput accounting,
anomaly detection, anomaly-triggered ``torch.profiler`` captures, and a
per-process flight recorder aggregated by ``diagnose``
(``python -m accelerate_tpu_torch.commands.accelerate_cli diagnose <dir>``).

Port of ``accelerate_tpu/diagnostics/``: the host code is the reference's,
copied; the captures use ``torch.profiler`` where the reference uses
``jax.profiler`` (``capture.py``), and the process index comes from the
port's ``state.PartialState``.

Enable through telemetry::

    accelerator = Accelerator(
        telemetry=TelemetryConfig(
            jsonl_path="/tmp/run/telemetry.jsonl",
            heartbeat_dir="/tmp/run/diag",
            diagnostics=DiagnosticsConfig(
                dir="/tmp/run/diag", trace_dir="/tmp/run/traces"
            ),
        )
    )

or simply ``Accelerator(telemetry=True, diagnostics="/tmp/run/diag")``.
"""

from .anomaly import AnomalyDetector
from .capture import TraceCapture
from .config import DiagnosticsConfig
from .diagnose import build_report, format_report
from .flight_recorder import DUMP_PREFIX, FlightRecorder, list_dumps
from .goodput import BADPUT_BUCKETS, BUCKETS, GoodputAccounting
from .manager import DiagnosticsManager

__all__ = [
    "AnomalyDetector",
    "BADPUT_BUCKETS",
    "BUCKETS",
    "DUMP_PREFIX",
    "DiagnosticsConfig",
    "DiagnosticsManager",
    "FlightRecorder",
    "GoodputAccounting",
    "TraceCapture",
    "build_report",
    "format_report",
    "list_dumps",
]
