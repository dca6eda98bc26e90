"""The soak and chaos harness.

Host-only copy of ``accelerate_tpu/loadgen/``: open-loop seeded load
against the serving engine, a warmup -> ramp -> soak -> fault -> recovery
phase program, serving faults in the ``FAULT_ENV`` grammar, and an
atomically written ``soak-report.json`` with goodput at the SLO and
capacity at the breach point as headlines. Nothing here runs unless a
caller builds a :class:`SoakHarness`.
"""

from .chaos import ChaosAdapter
from .harness import SoakClock, SoakConfig, SoakHarness
from .phases import Phase, phase_bounds, standard_program, total_duration_s
from .report import REPORT_BASENAME, lag_histogram, read_report, write_report
from .workload import SoakRequest, WorkloadConfig, build_trace, trace_fingerprint

__all__ = [
    "ChaosAdapter",
    "Phase",
    "REPORT_BASENAME",
    "SoakClock",
    "SoakConfig",
    "SoakHarness",
    "SoakRequest",
    "WorkloadConfig",
    "build_trace",
    "lag_histogram",
    "phase_bounds",
    "read_report",
    "standard_program",
    "total_duration_s",
    "trace_fingerprint",
    "write_report",
]
