"""Phase program for the soak harness: warmup, ramp, soak, fault, recovery.

Host-only copy of ``accelerate_tpu/loadgen/phases.py``. Every phase fixes
an offered rate and an arrival process for its span; :func:`phase_bounds`
turns the sequence into absolute ``[start, end)`` windows on the run
clock. A phase's ``kind`` keys the harness's accounting:

* ``ramp``: the breach-point probe. Capacity at the breach point is the
  highest ramp rate whose phase saw no burn-rate breach.
* ``soak``: the headline window, where goodput tokens/s at the TTFT
  objective is measured.
* ``fault``: the chaos window: fault specs armed at entry, damage (sheds
  and SLO-violating finishes) counted inside it.
* ``recovery``: time to recover runs from the fault window's end until
  the burn rate is back under its threshold.
"""


from __future__ import annotations

import dataclasses
from typing import Sequence

PHASE_KINDS = ("warmup", "ramp", "soak", "fault", "recovery")


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    kind: str
    duration_s: float
    rate_rps: float
    process: str = "poisson"  # or "uniform" (deterministic metronome)

    def __post_init__(self):
        if self.kind not in PHASE_KINDS:
            raise ValueError(
                f"phase kind {self.kind!r} not in {PHASE_KINDS}"
            )
        if self.duration_s <= 0:
            raise ValueError("duration_s must be > 0")
        if self.rate_rps < 0:
            raise ValueError("rate_rps must be >= 0")
        if self.process not in ("poisson", "uniform"):
            raise ValueError("process must be 'poisson' or 'uniform'")


def phase_bounds(phases: Sequence[Phase]) -> list[tuple]:
    """``[(phase, start_s, end_s), ...]`` with cumulative boundaries."""
    out = []
    t = 0.0
    for p in phases:
        out.append((p, t, t + p.duration_s))
        t += p.duration_s
    return out


def total_duration_s(phases: Sequence[Phase]) -> float:
    return sum(p.duration_s for p in phases)


def standard_program(
    *,
    warmup_s: float = 2.0,
    warmup_rps: float = 2.0,
    ramp_rates: Sequence[float] = (4.0, 8.0, 16.0, 32.0),
    ramp_step_s: float = 2.0,
    soak_s: float = 4.0,
    soak_rps: float = 8.0,
    fault_s: float = 2.0,
    recovery_s: float = 4.0,
    process: str = "poisson",
) -> tuple:
    """The canonical five-act program. The fault and recovery phases
    keep offering the soak rate — a chaos window with no traffic would
    measure nothing, and recovery is only proven under load."""
    phases = [Phase("warmup", "warmup", warmup_s, warmup_rps, process)]
    for i, rate in enumerate(ramp_rates):
        phases.append(
            Phase(f"ramp-{i + 1}", "ramp", ramp_step_s, rate, process)
        )
    phases.append(Phase("soak", "soak", soak_s, soak_rps, process))
    if fault_s > 0:
        phases.append(Phase("fault", "fault", fault_s, soak_rps, process))
    if recovery_s > 0:
        phases.append(
            Phase("recovery", "recovery", recovery_s, soak_rps, process)
        )
    return tuple(phases)
