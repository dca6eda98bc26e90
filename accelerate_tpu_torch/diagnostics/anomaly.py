"""Anomaly detection over the step-record stream.

Port of ``accelerate_tpu/diagnostics/anomaly.py``, as it stands.

A rolling median/MAD baseline (robust to the outliers it exists to
catch) over ``step_time_s``, ``loss`` and ``grad_norm`` flags three
event classes:

* ``slow_step`` — a non-retraced step beyond ``slow_step_factor x
  median`` AND ``mad_z`` robust z-scores (the straggler signature;
  retraced steps are excluded: their slowness is compile, already
  attributed by goodput);
* ``loss_spike`` — loss beyond ``mad_z`` robust z-scores above the
  rolling median;
* ``nan_grad`` — non-finite loss or grad norm, or ``grads_finite == 0``
  (the fp16 overflow-skip signal), flagged immediately with no baseline
  needed;
* ``memory_leak`` — over the ``kind="memory"`` census stream (not step
  records): ``census_unowned_bytes`` growing monotonically across
  ``leak_min_samples`` consecutive censuses by at least
  ``leak_min_growth_bytes`` total. Memory *nobody claims* that only
  ever grows is the leak signature; owned growth (a filling KV pool) is
  expected and never alarms.

Each fired anomaly becomes one ``kind="anomaly"`` record carrying the
offending step's FULL record (the evidence travels with the alarm), and
each type is rate-limited: at most one record per ``cooldown_steps``
steps / ``cooldown_s`` seconds, with suppressed repeats counted on the
next record that does fire.
"""

from __future__ import annotations

import collections
import math
import time
from typing import Any, Optional

from .config import DiagnosticsConfig

#: MAD -> sigma for normally-distributed data
_MAD_SCALE = 1.4826


def _median_mad(values) -> tuple[float, float]:
    xs = sorted(values)
    n = len(xs)
    mid = n // 2
    median = xs[mid] if n % 2 else 0.5 * (xs[mid - 1] + xs[mid])
    devs = sorted(abs(x - median) for x in xs)
    mad = devs[mid] if n % 2 else 0.5 * (devs[mid - 1] + devs[mid])
    return median, mad


class AnomalyDetector:
    """Stateful per-process detector; feed every step record through
    :meth:`observe` and emit whatever it returns."""

    def __init__(self, config: Optional[DiagnosticsConfig] = None):
        self.config = config or DiagnosticsConfig()
        w = self.config.anomaly_window
        self._windows: dict[str, collections.deque] = {
            "step_time_s": collections.deque(maxlen=w),
            "loss": collections.deque(maxlen=w),
            "grad_norm": collections.deque(maxlen=w),
        }
        # per-type rate limiting: (last emitted step, last emitted time)
        self._last_emit: dict[str, tuple[int, float]] = {}
        self._suppressed: dict[str, int] = collections.defaultdict(int)
        self.counts: dict[str, int] = collections.defaultdict(int)
        self._observed = 0  # step records seen, for baseline sampling
        # unowned-census trail for the leak rule: (sample, bytes) pairs
        self._unowned: collections.deque = collections.deque(
            maxlen=max(self.config.leak_min_samples, 2)
        )

    # ------------------------------------------------------------------ #
    def _fire(
        self,
        type_: str,
        record: dict,
        now: float,
        **fields: Any,
    ) -> Optional[dict]:
        """Build the anomaly record, or None while rate-limited."""
        self.counts[type_] += 1
        step = record.get("step")
        last = self._last_emit.get(type_)
        if last is not None:
            last_step, last_time = last
            step_gap = (
                step - last_step
                if isinstance(step, int) and isinstance(last_step, int)
                else None
            )
            within_steps = (
                step_gap is not None and step_gap < self.config.anomaly_cooldown_steps
            )
            within_time = now - last_time < self.config.anomaly_cooldown_s
            # suppress while EITHER cooldown is open: a NaN storm emits one
            # record, not one per step
            if within_steps or within_time:
                self._suppressed[type_] += 1
                return None
        self._last_emit[type_] = (step if isinstance(step, int) else 0, now)
        out = {
            "kind": "anomaly",
            "label": "anomaly",
            "anomaly_type": type_,
            "step": step,
            "time_unix": time.time(),
            "suppressed_since_last": self._suppressed.pop(type_, 0),
            "total_of_type": self.counts[type_],
            # the offending step's full record: the evidence travels with
            # the alarm (sinks/flight dumps need no join against the stream)
            "record": dict(record),
        }
        out.update(fields)
        return out

    @staticmethod
    def _finite(value: Any) -> bool:
        try:
            return math.isfinite(float(value))
        except (TypeError, ValueError):
            return True  # non-numeric: not evidence of a NaN

    def observe(
        self,
        record: dict,
        scalars: Optional[dict] = None,
        now: Optional[float] = None,
    ) -> list[dict]:
        """Check one step record against the baselines; returns the
        ``kind="anomaly"`` records to emit (usually empty).

        ``scalars`` is the UNfiltered 0-d metric dict from the step — the
        collector strips non-finite ``grad_norm`` from the record itself
        (NaN is invalid JSON), so NaN detection needs the raw values.
        """
        if record.get("kind") != "step":
            return []
        now = time.monotonic() if now is None else now
        scalars = scalars or {}
        cfg = self.config
        out: list[dict] = []
        self._observed += 1
        # baseline sampling: the median/MAD fold sorts the rolling window
        # (O(w log w) host-side) — at sub-millisecond steps that is the
        # harness's whole per-step cost, so it runs every Nth record.
        # The NaN/inf section below is exempt: it is O(1) and a skipped
        # NaN is a lost run.
        sampled = self._observed % cfg.anomaly_sample_every == 0

        # --- nan/inf: immediate, no baseline needed ------------------- #
        loss = scalars.get("loss", record.get("loss"))
        gnorm = scalars.get("grad_norm", record.get("grad_norm"))
        grads_finite = scalars.get("grads_finite")
        bad = []
        if loss is not None and not self._finite(loss):
            bad.append(("loss", float(loss)))
        if gnorm is not None and not self._finite(gnorm):
            bad.append(("grad_norm", float(gnorm)))
        if grads_finite is not None and not grads_finite:
            bad.append(("grads_finite", 0.0))
        if bad:
            rec = self._fire(
                "nan_grad", record, now,
                fields=", ".join(name for name, _ in bad),
                value=bad[0][1],
            )
            if rec:
                out.append(rec)

        # --- slow step / straggler ------------------------------------ #
        st = record.get("step_time_s")
        window = self._windows["step_time_s"]
        if sampled and st is not None and not record.get("retraced"):
            if len(window) >= cfg.anomaly_min_samples:
                median, mad = _median_mad(window)
                sigma = _MAD_SCALE * mad
                z = (st - median) / sigma if sigma > 0 else math.inf
                if st > cfg.slow_step_factor * median and z > cfg.mad_z:
                    rec = self._fire(
                        "slow_step", record, now,
                        value=float(st),
                        baseline_median=median,
                        baseline_mad=mad,
                        slowdown=float(st / median) if median > 0 else None,
                    )
                    if rec:
                        out.append(rec)
            # anomalous samples still enter the window — the median is
            # robust, and a persistent regime change becomes the new
            # baseline instead of alarming forever
            window.append(float(st))

        # --- loss spike ------------------------------------------------ #
        if sampled and loss is not None and self._finite(loss):
            loss = float(loss)
            window = self._windows["loss"]
            if len(window) >= cfg.anomaly_min_samples:
                median, mad = _median_mad(window)
                sigma = _MAD_SCALE * mad
                z = (loss - median) / sigma if sigma > 0 else math.inf
                if loss > median and z > cfg.mad_z:
                    rec = self._fire(
                        "loss_spike", record, now,
                        value=loss,
                        baseline_median=median,
                        baseline_mad=mad,
                        z=None if math.isinf(z) else z,
                    )
                    if rec:
                        out.append(rec)
            window.append(loss)

        if sampled and gnorm is not None and self._finite(gnorm):
            self._windows["grad_norm"].append(float(gnorm))
        return out

    def observe_memory(
        self,
        record: dict,
        now: Optional[float] = None,
    ) -> list[dict]:
        """Check one ``kind="memory"`` census record for the leak
        signature: *unowned* bytes rising on EVERY one of the last
        ``leak_min_samples`` censuses, with total growth of at least
        ``leak_min_growth_bytes``. Strict monotonicity is the filter
        that keeps a noisy-but-stable pool quiet — one flat or falling
        census resets the trail."""
        if record.get("kind") != "memory":
            return []
        unowned = record.get("census_unowned_bytes")
        if unowned is None:
            return []
        now = time.monotonic() if now is None else now
        cfg = self.config
        trail = self._unowned
        if trail and unowned <= trail[-1]:
            trail.clear()
        trail.append(int(unowned))
        if len(trail) < cfg.leak_min_samples:
            return []
        growth = trail[-1] - trail[0]
        if growth < cfg.leak_min_growth_bytes:
            return []
        rec = self._fire(
            "memory_leak", record, now,
            value=float(unowned),
            growth_bytes=int(growth),
            samples=len(trail),
        )
        return [rec] if rec else []

    def observe_slo(
        self,
        record: dict,
        now: Optional[float] = None,
    ) -> list[dict]:
        """Check one ``kind="slo"`` record: a multi-window burn-rate
        breach becomes a ``slo_breach`` anomaly (same rate limiting as
        the step-record types — the tracker emits every interval while
        burning, the detector emits one alarm per cooldown). The serving
        engine already did the statistics; this routes the verdict into
        the anomaly/capture machinery."""
        if record.get("kind") != "slo" or not record.get("breach"):
            return []
        now = time.monotonic() if now is None else now
        rec = self._fire(
            "slo_breach", record, now,
            value=float(record.get("max_burn_rate") or 0.0),
            breached_objectives=list(record.get("breached_objectives") or []),
        )
        return [rec] if rec else []

    def observe_soak(
        self,
        record: dict,
        now: Optional[float] = None,
    ) -> list[dict]:
        """Check one ``kind="soak"`` record (a loadgen phase summary): a
        phase that saw a burn breach becomes a ``soak_breach`` anomaly.
        The harness already folded the SLO verdict per phase — this
        routes it into the same rate-limited anomaly/capture machinery
        as live ``slo_breach`` records, so a breached soak phase shows
        up in the flight ring and `diagnose` like any other alarm."""
        if record.get("kind") != "soak" or not record.get("breach"):
            return []
        now = time.monotonic() if now is None else now
        rec = self._fire(
            "soak_breach", record, now,
            value=float(record.get("goodput_tokens_per_s") or 0.0),
            phase=str(record.get("phase") or ""),
        )
        return [rec] if rec else []

    def observe_audit(
        self,
        record: dict,
        now: Optional[float] = None,
    ) -> list[dict]:
        """Check one ``kind="audit"`` record (a compiled program's
        collective inventory from the sharding X-ray): any contract
        violation — a collective or sharding-changing copy the program's
        layout does not explain — becomes a ``sharding_violation``
        anomaly naming the offending HLO op. The auditor already did the
        HLO walk and contract check; this routes the verdict into the
        same rate-limited anomaly/capture machinery as every alarm."""
        viols = record.get("violations") or []
        # the collector stamps kind="audit"; a bare ProgramAudit
        # .to_record() payload (no kind yet) is accepted too
        if record.get("kind") not in (None, "audit") or not viols:
            return []
        now = time.monotonic() if now is None else now
        first = viols[0] if isinstance(viols[0], dict) else {}
        rec = self._fire(
            "sharding_violation", record, now,
            value=float(len(viols)),
            program=str(record.get("program") or record.get("label") or ""),
            op=str(first.get("op") or ""),
            op_kind=str(first.get("op_kind") or ""),
            ops=[str(v.get("op") or "") for v in viols if isinstance(v, dict)][:8],
        )
        return [rec] if rec else []

    def summary(self) -> dict:
        return {
            "anomalies": dict(self.counts),
            "anomalies_total": sum(self.counts.values()),
        }
