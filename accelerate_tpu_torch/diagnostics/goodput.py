"""Goodput accounting: classify run wall-clock into productive/badput buckets.

Port of ``accelerate_tpu/diagnostics/goodput.py``, as it stands. The
port's step records carry no ``compile_time_s`` (PyTorch runs eagerly, so
no step compiles a program); a record that has one still splits it out.

The question a fleet operator actually asks — "what fraction of the last
hour trained the model?" — is answered by folding the telemetry stream:
every ``kind="step"`` record contributes its execution time (minus any
in-step compile cost the CompileMonitor attributed), ``kind="compile"``
records (AOT warmups) are pure compile badput, ``kind="checkpoint"``
records contribute their *blocked* seconds (async background time is
hidden from the train loop by design, so it is NOT badput), and
dataloader waits land in their own bucket. Whatever wall-clock remains
is ``idle`` — setup, eval, recovery after a failure — so the buckets
always sum to wall-clock exactly.

All methods take an optional ``now`` (monotonic seconds) so synthetic
record streams are exactly reproducible in tests; real use omits it.
"""

from __future__ import annotations

import collections
import time
from typing import Optional

BUCKETS = ("productive", "compile", "dataloader", "checkpoint", "idle")
#: buckets that count against goodput (everything but productive; idle is
#: derived at snapshot time)
BADPUT_BUCKETS = ("compile", "dataloader", "checkpoint", "idle")


class GoodputAccounting:
    """Fold telemetry records into wall-clock buckets.

    ``fold_dataloader``: fold each step record's ``dataloader_wait_s``
    into the dataloader bucket. The live collector feeds waits directly
    through :meth:`add` as they happen (so a wait with no subsequent step
    still counts) and sets this False; standalone folding of a recorded
    stream keeps the default True.
    """

    def __init__(
        self,
        window_s: float = 300.0,
        fold_dataloader: bool = True,
        now: Optional[float] = None,
    ):
        self.window_s = float(window_s)
        self.fold_dataloader = fold_dataloader
        self._start = time.monotonic() if now is None else now
        self.totals: dict[str, float] = {b: 0.0 for b in BUCKETS}
        # (now, bucket, seconds) for the rolling window
        self._recent: collections.deque = collections.deque()

    # ------------------------------------------------------------------ #
    def add(self, bucket: str, seconds: float, now: Optional[float] = None) -> None:
        """Attribute ``seconds`` of wall-clock to ``bucket``."""
        if bucket not in BUCKETS:
            raise ValueError(f"unknown goodput bucket {bucket!r}; one of {BUCKETS}")
        if seconds <= 0:
            return
        now = time.monotonic() if now is None else now
        self.totals[bucket] += seconds
        self._recent.append((now, bucket, seconds))
        self._prune(now)

    def observe(self, record: dict, now: Optional[float] = None) -> None:
        """Fold one telemetry record (dispatch on ``kind``)."""
        kind = record.get("kind")
        if kind == "step":
            dur = float(record.get("step_time_s") or 0.0)
            # in-step compile (a retrace) is part of step_time_s; split it
            # out so a retrace storm shows up as compile badput, not as
            # "productive" training
            compile_s = min(float(record.get("compile_time_s") or 0.0), dur)
            self.add("productive", dur - compile_s, now)
            self.add("compile", compile_s, now)
            if self.fold_dataloader:
                self.add(
                    "dataloader", float(record.get("dataloader_wait_s") or 0.0), now
                )
        elif kind == "compile":
            self.add("compile", float(record.get("compile_time_s") or 0.0), now)
        elif kind == "checkpoint":
            # only the train-loop stall; async background IO is hidden
            self.add("checkpoint", float(record.get("blocked_s") or 0.0), now)

    # ------------------------------------------------------------------ #
    def _prune(self, now: float) -> None:
        cutoff = now - self.window_s
        recent = self._recent
        while recent and recent[0][0] < cutoff:
            recent.popleft()

    def snapshot(self, now: Optional[float] = None) -> dict:
        """Bucket totals + goodput percentages.

        ``idle`` is the wall-clock remainder, so
        ``sum(buckets.values()) == wall_s`` exactly (unless attributed
        time exceeds wall-clock — overlapping brackets — in which case
        idle clamps to 0 and the overshoot is visible as the excess).
        """
        now = time.monotonic() if now is None else now
        wall = max(0.0, now - self._start)
        accounted = sum(self.totals[b] for b in BUCKETS if b != "idle")
        buckets = dict(self.totals)
        buckets["idle"] = max(0.0, wall - accounted)
        out = {
            "wall_s": wall,
            "buckets": buckets,
            "goodput_pct": 100.0 * buckets["productive"] / wall if wall > 0 else None,
        }
        # rolling window: same derivation over only the recent entries
        self._prune(now)
        span = min(self.window_s, wall)
        win: dict[str, float] = {b: 0.0 for b in BUCKETS}
        for _, bucket, seconds in self._recent:
            win[bucket] += seconds
        out["rolling_window_s"] = span
        out["rolling_goodput_pct"] = (
            100.0 * win["productive"] / span if span > 0 else None
        )
        return out

    def record(self, step: Optional[int] = None, now: Optional[float] = None) -> dict:
        """A flat ``kind="goodput"`` telemetry record of the current
        snapshot (per-bucket badput as ``badput_<bucket>_s`` so every
        sink — Prometheus gauges included — sees the breakdown)."""
        snap = self.snapshot(now)
        rec = {
            "kind": "goodput",
            "label": "goodput",
            "step": step,
            "time_unix": time.time(),
            "wall_s": snap["wall_s"],
            "goodput_pct": snap["goodput_pct"],
            "rolling_goodput_pct": snap["rolling_goodput_pct"],
            "productive_s": snap["buckets"]["productive"],
        }
        for bucket in BADPUT_BUCKETS:
            rec[f"badput_{bucket}_s"] = snap["buckets"][bucket]
        return rec
