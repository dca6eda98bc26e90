"""soak-report.json: the machine-readable outcome of one soak run.

Host-only copy of ``accelerate_tpu/loadgen/report.py``. Written atomically
(a ``tmp.<pid>`` file and ``os.replace``) so a reader never sees a torn
file, and from the harness's ``finally`` so a run that dies mid-burn
still leaves its final SLO snapshot and shed totals on disk.

Schema (version 1), top-level keys:

* ``headline``: ``goodput_tokens_per_s_at_slo`` (soak-phase tokens/s of
  the requests whose TTFT met the objective; ``slo_ok`` says whether the
  soak phase's p95 TTFT itself met it), ``capacity_rps_at_breach_point``
  (the highest ramp rate whose phase kept both burn windows under the
  threshold; ``capacity_saturated`` when even the top ramp never
  breached).
* ``phases``: the per-phase table: offered and achieved rates, goodput,
  latency percentiles, sheds, breach flag.
* ``arrival_lag``: p50/p95/max and a histogram of (submit - scheduled).
* ``fault``: armed specs, window bounds, events, damage inside the window
  (sheds, SLO-violating finishes, preemptions) and ``recovery_s``.
* ``slo_final``: the SLO snapshot at report time; ``shed_totals``: the
  engine's sheds by reason.
* ``trace_sha256``: fingerprint of the request trace (replay proof).
* ``interrupted``: True when the run loop raised or was cut short.
"""


from __future__ import annotations

import json
import os
from typing import Optional, Sequence

REPORT_VERSION = 1
REPORT_BASENAME = "soak-report.json"

#: arrival-lag histogram bucket upper bounds (seconds); the last bucket
#: is open-ended
LAG_BUCKETS_S = (0.001, 0.01, 0.1, 1.0, 10.0)


def lag_histogram(lags: Sequence[float]) -> dict:
    """p50/p95/max plus fixed-bucket counts over recorded arrival lags."""
    from ..serving.telemetry import percentile

    lags = [max(0.0, float(v)) for v in lags]
    counts = {f"le_{hi:g}s": 0 for hi in LAG_BUCKETS_S}
    overflow = f"gt_{LAG_BUCKETS_S[-1]:g}s"
    counts[overflow] = 0
    for v in lags:
        for hi in LAG_BUCKETS_S:
            if v <= hi:
                counts[f"le_{hi:g}s"] += 1
                break
        else:
            counts[overflow] += 1
    return {
        "count": len(lags),
        "p50_s": percentile(lags, 50) if lags else 0.0,
        "p95_s": percentile(lags, 95) if lags else 0.0,
        "max_s": max(lags) if lags else 0.0,
        "histogram": counts,
    }


def write_report(path: str, report: dict) -> str:
    """Atomic JSON write; returns ``path``."""
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(report, f, indent=2, sort_keys=True, default=_json_safe)
    os.replace(tmp, path)
    return path


def read_report(path: str) -> Optional[dict]:
    """Parse a soak report; None when absent or torn (torn should be
    impossible given the atomic write, but diagnose never crashes on a
    bad input file)."""
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def _json_safe(obj):
    try:
        import numpy as np

        if isinstance(obj, np.generic):
            return obj.item()
    except ImportError:
        pass
    if isinstance(obj, tuple):
        return list(obj)
    return str(obj)
