"""The soak harness: open-loop load against a live serving engine.

Host-only copy of ``accelerate_tpu/loadgen/harness.py``. A closed-loop load
generator waits for a response before the next request, so a slow server
slows the load down and the measured latencies drop the requests that hurt
(coordinated omission). Here the arrival process is open loop: every
request has an arrival time drawn up front from one seed
(:mod:`.workload`) and is submitted at that time however far behind the
engine is; when the submit loop itself falls behind (a wedged decode step)
the gap is recorded as arrival lag.

The harness owns the run clock and the engine must stamp from the same
one:

* virtual (``step_dt_s`` set): a :class:`SoakClock` starts at 0 and
  advances ``step_dt_s`` an engine step (or what ``step_cost`` charges),
  so the run is deterministic in virtual time whatever the host's speed;
  build the engine with ``now=clock``;
* wall (``step_dt_s=None``): ``time.monotonic`` on both sides; the
  harness sleeps only when idle.

The run is a phase program (:mod:`.phases`); fault specs are armed when
the clock enters the ``fault`` phase, their steps counted from the
window's first engine step (``stall_decode@0:secs=1`` stalls for 1 s at
the window's start). What is observed lands in an atomically written
``soak-report.json`` (:mod:`.report`), through the ``finally`` path also
for a run that died. Tenant adapters (``WorkloadConfig.adapters``) are
loaded into the engine's adapter registry at the start and again after a
fault (zero-weight adapters, as in the reference); without a registry,
loading them is a no-op.
"""


from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, Optional

from ..test_utils.fault_injection import FAULT_ENV, FaultInjector, FaultSpec
from ..utils.constants import ENV_PREFIX
from .chaos import ChaosAdapter, zero_adapter
from .phases import Phase, phase_bounds, standard_program, total_duration_s
from .report import REPORT_VERSION, lag_histogram, write_report
from .workload import WorkloadConfig, build_trace, trace_fingerprint


class SoakClock:
    """The virtual run clock (monotonic, harness-advanced). Pass the
    SAME instance as the engine's ``now=`` so scheduler deadlines, SLO
    windows and span stamps all live on soak time."""

    def __init__(self, start: float = 0.0):
        self.t = float(start)

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> None:
        self.t += dt


@dataclasses.dataclass
class SoakConfig:
    """One soak run: workload x phase program x clocking x chaos.

    ``step_dt_s``: virtual seconds per engine step (None = wall clock).
    ``step_cost``: virtual mode only — a callable taking the engine and
    returning THIS step's virtual duration, consulted after each engine
    step instead of the flat ``step_dt_s`` quantum. Use it to charge
    steps by the work they actually issued (e.g. a delta of the
    engine's ``prefill_bucket_tokens_total``), so compute serialization
    — a giant prefill stalling the whole batch for one long step — is
    visible on hosts whose wall clock is all dispatch overhead. Idle
    gaps still advance at the flat quantum.
    ``fault_specs``: a string in the ``FAULT_ENV`` grammar with
    steps relative to the fault-window entry step; empty string reads
    the env var (and stays inert if that is unset too).
    ``slo``: a :class:`~accelerate_tpu_torch.serving.SLOConfig` (or existing
    tracker) attached for the run; None leaves the engine's posture
    untouched. ``report_path``: where soak-report.json lands (None
    skips the file; the report dict is still returned).
    """

    workload: WorkloadConfig = dataclasses.field(
        default_factory=WorkloadConfig
    )
    phases: tuple = dataclasses.field(default_factory=standard_program)
    seed: int = 0
    step_dt_s: Optional[float] = 0.01
    step_cost: Optional[Callable] = None
    slo: object = None
    gauge_interval: int = 4
    fault_specs: str = ""
    report_path: Optional[str] = None
    drain_grace_s: float = 60.0
    recovery_poll_steps: int = 8
    max_engine_steps: int = 2_000_000
    label: str = "soak"


def _phase_acc(phase: Phase) -> dict:
    return {
        "phase": phase, "offered": 0, "finished": 0, "new_tokens": 0,
        "goodput_tokens": 0, "slo_violations": 0, "sheds": {},
        "ttfts": [], "itls": [], "lags": [], "breach_seen": False,
        "ran_s": 0.0,
    }


class SoakHarness:
    """Drives one engine through one :class:`SoakConfig`.

    The engine is duck-typed: ``add_request``/``step``/``has_work`` are
    required, everything else (``set_observability``, ``slo_tracker``,
    ``stats``, ``pool``, ``adapters``, ``trace_counts``) is optional —
    fake engines on a fake clock exercise the arrival process and the
    coordinated-omission guard with no model at all.
    """

    def __init__(
        self,
        engine,
        config: Optional[SoakConfig] = None,
        clock: Optional[Callable[[], float]] = None,
        telemetry=None,
        on_phase_end: Optional[Callable[[dict], None]] = None,
    ):
        self.engine = engine
        self.config = config or SoakConfig()
        if clock is None:
            clock = (
                SoakClock() if self.config.step_dt_s is not None
                else time.monotonic
            )
        self.clock = clock
        self.telemetry = telemetry
        self.on_phase_end = on_phase_end
        self.report: Optional[dict] = None
        # run state
        self._steps = 0
        self._t0 = 0.0
        self._cur = 0  # current phase index
        self._accs: list[dict] = []
        self._interrupted = False
        self._stop_reason: Optional[str] = None
        self._warm_traces: Optional[dict] = None
        self._fault_window: Optional[tuple] = None  # (start_rel, end_rel)
        self._fault_armed = False
        self._recovering = False
        self._recovered_after_s: Optional[float] = None
        self._fault_sheds = 0
        self._fault_violations = 0
        self._fault_preempts = 0
        self._preempts_total = 0
        self.slo_tracker = None
        self.chaos: Optional[ChaosAdapter] = None

    # ------------------------------------------------------------------ #
    # run loop
    # ------------------------------------------------------------------ #
    def run(self) -> dict:
        cfg = self.config
        trace = build_trace(cfg.workload, cfg.phases, cfg.seed)
        self._trace_sha = trace_fingerprint(trace)
        bounds = phase_bounds(cfg.phases)
        self._accs = [_phase_acc(p) for p in cfg.phases]
        for p, start, end in bounds:
            if p.kind == "fault" and self._fault_window is None:
                self._fault_window = (start, end)
        raw = cfg.fault_specs or os.environ.get(FAULT_ENV, "")
        self._specs = [
            FaultSpec.parse(s) for s in raw.split(";") if s.strip()
        ]
        injector = FaultInjector([], rank=0, generation=0)
        self.chaos = ChaosAdapter(
            self.engine, injector, self.clock, restore=self._load_tenants
        )
        self._injector = injector
        if cfg.phases and cfg.phases[0].kind == "fault":
            self._arm_fault()
        self._attach_observability()
        self._load_tenants()
        total_s = total_duration_s(cfg.phases)
        self._t0 = self.clock()
        next_i = 0
        try:
            while True:
                now = self.clock()
                rel = now - self._t0
                self._cross_phase_boundaries(bounds, rel)
                # open-loop arrivals: everything scheduled up to now
                # goes in, stalled engine or not — lag is the record
                while (
                    next_i < len(trace)
                    and trace[next_i].arrival_s <= rel
                ):
                    req = trace[next_i]
                    lag = rel - req.arrival_s
                    acc = self._accs[min(self._cur, len(self._accs) - 1)]
                    acc["offered"] += 1
                    acc["lags"].append(lag)
                    self.engine.add_request(
                        list(req.prompt),
                        max_new_tokens=req.max_new_tokens,
                        adapter=req.adapter,
                        request_id=f"soak-{req.index}",
                    )
                    next_i += 1
                self.chaos.poll()
                drained = next_i >= len(trace) and not self.engine.has_work
                if rel >= total_s and drained:
                    break
                if rel >= total_s + cfg.drain_grace_s:
                    self._stop_reason = "drain_timeout"
                    break
                if self._steps >= cfg.max_engine_steps:
                    self._stop_reason = "step_backstop"
                    self._interrupted = True
                    break
                if self.chaos.stalled():
                    # decode wedged: time passes, arrivals keep landing
                    self._advance_idle(rel, trace, next_i, total_s)
                    continue
                if self.engine.has_work:
                    self._steps += 1
                    self._injector.maybe_fire(self._step_key())
                    if self.chaos.stalled():
                        continue  # the fault fired on THIS step
                    self.engine.step()
                    if cfg.step_dt_s is not None:
                        self.clock.advance(
                            cfg.step_cost(self.engine)
                            if cfg.step_cost is not None
                            else cfg.step_dt_s
                        )
                    self._poll_recovery()
                else:
                    self._advance_idle(rel, trace, next_i, total_s)
        except BaseException:
            self._interrupted = True
            raise
        finally:
            self.chaos.release()
            try:
                self.report = self._finalize(trace, next_i, bounds)
            except Exception:
                if not self._interrupted:
                    raise
        return self.report

    def _step_key(self) -> int:
        """Engine-step key the injector matches on: 0 for the first
        step taken inside the fault window, counting up from there."""
        if not self._fault_armed:
            return -1
        return self._steps - self._fault_entry_step - 1

    def _advance_idle(self, rel, trace, next_i, total_s) -> None:
        cfg = self.config
        if cfg.step_dt_s is None:
            time.sleep(0.001)
            return
        # virtual idle: jump straight to the next scheduled event
        targets = [rel + cfg.step_dt_s]
        if next_i < len(trace):
            targets.append(trace[next_i].arrival_s)
        nxt = max(rel + 1e-9, min(t for t in targets if t > rel))
        if self.chaos.stalled():
            # never jump past the stall's end in one go — pins/stall
            # release and damage accounting need the edge
            nxt = min(nxt, rel + cfg.step_dt_s)
        self.clock.advance(min(nxt, total_s + cfg.drain_grace_s) - rel)

    # ------------------------------------------------------------------ #
    # phase machinery
    # ------------------------------------------------------------------ #
    def _cross_phase_boundaries(self, bounds, rel: float) -> None:
        while self._cur < len(bounds) and rel >= bounds[self._cur][2]:
            phase, start, end = bounds[self._cur]
            self._close_phase(self._cur, end - start)
            self._cur += 1
            if self._cur < len(bounds):
                entering, _, _ = bounds[self._cur]
                if entering.kind == "fault" and not self._fault_armed:
                    self._arm_fault()
                if entering.kind == "recovery":
                    self.chaos.release()
                    self._recovering = True

    def _arm_fault(self) -> None:
        self._fault_armed = True
        self._fault_entry_step = self._steps
        self._injector.specs = list(self._specs)

    def _close_phase(self, idx: int, ran_s: float) -> None:
        acc = self._accs[idx]
        if acc["ran_s"]:
            return  # already closed (finalize path)
        acc["ran_s"] = ran_s
        phase = acc["phase"]
        if phase.kind == "warmup" and self._warm_traces is None:
            tc = getattr(self.engine, "trace_counts", None)
            self._warm_traces = dict(tc()) if tc else None
        if self.slo_tracker is not None:
            snap = self.slo_tracker.snapshot(self.clock())
            acc["breach_seen"] = acc["breach_seen"] or bool(snap["breach"])
        rec = self._phase_record(acc)
        self._emit_soak(rec)
        if self.on_phase_end is not None:
            self.on_phase_end(rec)

    def _phase_record(self, acc: dict) -> dict:
        from ..serving.telemetry import percentile

        phase: Phase = acc["phase"]
        ran = acc["ran_s"] or 1e-9
        ttfts = acc["ttfts"]
        return {
            "phase": phase.name,
            "kind": phase.kind,
            "duration_s": round(ran, 6),
            "offered": acc["offered"],
            "offered_rps": round(phase.rate_rps, 6),
            "achieved_rps": round(acc["finished"] / ran, 6),
            "finished": acc["finished"],
            "shed": sum(acc["sheds"].values()),
            "sheds_by_reason": dict(acc["sheds"]),
            "new_tokens": acc["new_tokens"],
            "goodput_tokens": acc["goodput_tokens"],
            "goodput_tokens_per_s": round(acc["goodput_tokens"] / ran, 6),
            "slo_violations": acc["slo_violations"],
            "p50_ttft_s": percentile(ttfts, 50) if ttfts else None,
            "p95_ttft_s": percentile(ttfts, 95) if ttfts else None,
            "p50_itl_s": (
                percentile(acc["itls"], 50) if acc["itls"] else None
            ),
            "p95_itl_s": (
                percentile(acc["itls"], 95) if acc["itls"] else None
            ),
            "arrival_lag_p95_s": (
                percentile(acc["lags"], 95) if acc["lags"] else 0.0
            ),
            "breached": bool(acc["breach_seen"]),
        }

    # ------------------------------------------------------------------ #
    # observability tee
    # ------------------------------------------------------------------ #
    def _attach_observability(self) -> None:
        cfg = self.config
        tee = _TelemetryTee(self, self.telemetry)
        setter = getattr(self.engine, "set_observability", None)
        if setter is not None:
            slo = cfg.slo
            if slo is None:
                slo = self._default_slo()
            setter(
                telemetry=tee, gauge_interval=cfg.gauge_interval,
                slo=slo, spans=True,
            )
            self.slo_tracker = self.engine.slo_tracker
        else:
            self.slo_tracker = getattr(self.engine, "slo_tracker", None)

    def _default_slo(self):
        """Objectives scaled to the run clock: in virtual time, "fast"
        means a small multiple of the per-step quantum."""
        from ..serving.slo import SLOConfig

        dt = self.config.step_dt_s or 0.01
        total = total_duration_s(self.config.phases)
        return SLOConfig(
            ttft_objective_s=50 * dt,
            e2e_objective_s=500 * dt,
            target=0.9,
            fast_window_s=max(10 * dt, total / 16.0),
            slow_window_s=max(20 * dt, total / 4.0),
            burn_threshold=1.0,
            interval_steps=8,
            min_requests=3,
        )

    def _ttft_objective(self) -> Optional[float]:
        if self.slo_tracker is not None:
            return self.slo_tracker.config.ttft_objective_s
        return None

    def _in_fault_window(self, rel: float) -> bool:
        return (
            self._fault_window is not None
            and self._fault_window[0] <= rel <= self._fault_window[1]
        )

    # tee callbacks ----------------------------------------------------- #
    def _on_serve(self, fields: dict) -> None:
        rel = self.clock() - self._t0
        acc = self._accs[min(self._cur, len(self._accs) - 1)]
        acc["finished"] += 1
        new_tokens = int(fields.get("new_tokens") or 0)
        acc["new_tokens"] += new_tokens
        ttft = fields.get("ttft_s")
        obj = self._ttft_objective()
        met = ttft is not None and (obj is None or ttft <= obj)
        if ttft is not None:
            acc["ttfts"].append(float(ttft))
        # inter-token latency: the decode-side experience a prefill
        # burst degrades on a colocated engine (the disagg headline)
        dtps = fields.get("decode_tokens_per_s")
        if dtps:
            acc["itls"].append(1.0 / float(dtps))
        if met:
            acc["goodput_tokens"] += new_tokens
        else:
            acc["slo_violations"] += 1
            if self._in_fault_window(rel):
                self._fault_violations += 1

    def _on_preempt(self, fields: dict) -> None:
        rel = self.clock() - self._t0
        self._preempts_total += 1
        if self._in_fault_window(rel):
            self._fault_preempts += 1

    def _on_shed(self, fields: dict) -> None:
        rel = self.clock() - self._t0
        acc = self._accs[min(self._cur, len(self._accs) - 1)]
        reason = fields.get("reason") or "unknown"
        acc["sheds"][reason] = acc["sheds"].get(reason, 0) + 1
        if self._in_fault_window(rel):
            self._fault_sheds += 1

    def _on_slo(self, fields: dict) -> None:
        acc = self._accs[min(self._cur, len(self._accs) - 1)]
        if fields.get("breach"):
            acc["breach_seen"] = True
        self._check_recovered(fields)

    def _poll_recovery(self) -> None:
        if (
            self._recovering
            and self.slo_tracker is not None
            and self._steps % max(1, self.config.recovery_poll_steps) == 0
        ):
            self._check_recovered(self.slo_tracker.snapshot(self.clock()))

    def _check_recovered(self, snap: dict) -> None:
        if not self._recovering or self.slo_tracker is None:
            return
        threshold = self.slo_tracker.config.burn_threshold
        if snap.get("max_burn_rate", 0.0) < threshold:
            fault_end = (
                self._fault_window[1] if self._fault_window else 0.0
            )
            self._recovered_after_s = max(
                0.0, (self.clock() - self._t0) - fault_end
            )
            self._recovering = False

    # ------------------------------------------------------------------ #
    # tenants
    # ------------------------------------------------------------------ #
    def _load_tenants(self) -> None:
        """Load the workload's tenant adapters into the engine's registry (a
        no-op without one): zero-weight rank-1 adapters, valid residents
        whose delta is exactly 0. A registry pinned full stops the loading;
        the requests of a tenant left out wait or shed."""
        names = self.config.workload.adapters
        registry = getattr(self.engine, "adapters", None)
        if not names or registry is None:
            return
        params, cfg = zero_adapter(registry)
        for name in names:
            if not registry.resident(name):
                try:
                    registry.load(name, params, cfg)
                except RuntimeError:
                    break  # every row pinned by requests in flight

    # ------------------------------------------------------------------ #
    # report
    # ------------------------------------------------------------------ #
    def _finalize(self, trace, submitted: int, bounds) -> dict:
        import time as _time

        cfg = self.config
        now = self.clock()
        rel = now - self._t0
        # close every phase that ran, including a partial current one
        for idx in range(len(bounds)):
            phase, start, end = bounds[idx]
            if rel > start and not self._accs[idx]["ran_s"]:
                self._close_phase(idx, min(end, max(rel, start + 1e-9)) - start)
        phase_records = [
            self._phase_record(acc) for acc in self._accs if acc["ran_s"]
        ]
        slo_final = (
            self.slo_tracker.snapshot(now)
            if self.slo_tracker is not None else None
        )
        stats = getattr(self.engine, "stats", None)
        shed_totals = (
            dict(stats.shed_counts)
            if stats is not None and hasattr(stats, "shed_counts") else {}
        )
        tc = getattr(self.engine, "trace_counts", None)
        traces = dict(tc()) if tc else None
        decode_retraces = None
        if traces is not None and self._warm_traces is not None:
            decode_retraces = (
                traces.get("decode", 0) - self._warm_traces.get("decode", 0)
            )
        all_lags = [l for acc in self._accs for l in acc["lags"]]
        headline = self._headline(phase_records)
        report = {
            "version": REPORT_VERSION,
            "kind": "soak_report",
            "label": cfg.label,
            "rank": int(os.environ.get(ENV_PREFIX + "PROCESS_ID", "0")),
            "time_unix": _time.time(),
            "seed": cfg.seed,
            "clock": "virtual" if cfg.step_dt_s is not None else "wall",
            "step_dt_s": cfg.step_dt_s,
            "trace_sha256": self._trace_sha,
            "requests_planned": len(trace),
            "requests_submitted": submitted,
            "requests_finished": sum(a["finished"] for a in self._accs),
            "requests_shed": sum(
                sum(a["sheds"].values()) for a in self._accs
            ),
            "elapsed_s": round(rel, 6),
            "engine_steps": self._steps,
            "headline": headline,
            "phases": phase_records,
            "arrival_lag": lag_histogram(all_lags),
            "fault": self._fault_report(),
            "slo_final": slo_final,
            "shed_totals": shed_totals,
            "trace_counts": traces,
            "decode_retraces": decode_retraces,
            "interrupted": self._interrupted,
            "stop_reason": self._stop_reason,
        }
        # fleet soaks: the engine is a FleetRouter — surface its
        # placement/re-route ledger (policy, per-replica routed counts,
        # requeued vs lost) alongside the serving numbers
        rsum = getattr(self.engine, "router_summary", None)
        if rsum is not None:
            report["router"] = rsum()
        # disagg fleets: the KV hand-off ledger (plane totals, dedup
        # ratio, per-role replica gauges, stall/drop damage)
        tsum = getattr(self.engine, "transfer_summary", None)
        if tsum is not None:
            section = tsum()
            if section:
                report["transfer"] = section
        # sharding X-ray: the compiled-collective audit roll-up (ICI/DCN
        # bytes per program, violation verdicts) when audit_programs ran
        asum = getattr(self.engine, "audit_summary", None)
        if asum is not None:
            try:
                section = asum()
            except Exception:  # noqa: BLE001 — observability never fatal
                section = {}
            if section:
                report["audit"] = section
        self._emit_soak_final(report)
        if cfg.report_path:
            write_report(cfg.report_path, report)
        return report

    def _headline(self, phase_records) -> dict:
        soaks = [p for p in phase_records if p["kind"] == "soak"]
        ramps = [p for p in phase_records if p["kind"] == "ramp"]
        obj = self._ttft_objective()
        goodput = soaks[-1]["goodput_tokens_per_s"] if soaks else None
        p95 = soaks[-1]["p95_ttft_s"] if soaks else None
        p95_itl = soaks[-1].get("p95_itl_s") if soaks else None
        ok_rates = [p["offered_rps"] for p in ramps if not p["breached"]]
        breach_found = any(p["breached"] for p in ramps)
        return {
            "goodput_tokens_per_s_at_slo": goodput,
            "soak_p95_ttft_s": p95,
            "soak_p95_itl_s": p95_itl,
            "ttft_objective_s": obj,
            "slo_ok": (
                p95 is not None and obj is not None and p95 <= obj
                if soaks else None
            ),
            "capacity_rps_at_breach_point": (
                max(ok_rates) if ok_rates else 0.0
            ),
            "capacity_saturated": bool(ramps) and not breach_found,
        }

    def _fault_report(self) -> dict:
        window = self._fault_window
        return {
            "specs": [s.render() for s in self._specs],
            "window_start_s": window[0] if window else None,
            "window_end_s": window[1] if window else None,
            "events": list(self.chaos.events) if self.chaos else [],
            "sheds_in_window": self._fault_sheds,
            "slo_violations_in_window": self._fault_violations,
            # preemption turns would-be sheds into pauses: the soak's
            # acceptance check compares sheds_in_window against a
            # shed-only baseline and expects strictly fewer here
            "preempts_in_window": self._fault_preempts,
            "preempts_total": self._preempts_total,
            "recovery_s": (
                round(self._recovered_after_s, 6)
                if self._recovered_after_s is not None else None
            ),
            "recovered": self._recovered_after_s is not None,
        }

    # ------------------------------------------------------------------ #
    # kind="soak" telemetry records
    # ------------------------------------------------------------------ #
    def _emit_soak(self, rec: dict) -> None:
        fn = getattr(self.telemetry, "record_soak", None)
        if fn is None:
            return
        fn(
            label=self.config.label,
            phase=rec["phase"],
            phase_kind=rec["kind"],
            offered_rps=rec["offered_rps"],
            achieved_rps=rec["achieved_rps"],
            goodput_tokens_per_s=rec["goodput_tokens_per_s"],
            arrival_lag_p95_s=rec["arrival_lag_p95_s"],
            shed=rec["shed"],
            slo_violations=rec["slo_violations"],
            breach=rec["breached"],
        )

    def _emit_soak_final(self, report: dict) -> bool:
        fn = getattr(self.telemetry, "record_soak", None)
        if fn is None:
            return False
        head = report["headline"]
        fn(
            label=self.config.label,
            phase="final",
            phase_kind="final",
            goodput_tokens_per_s=head["goodput_tokens_per_s_at_slo"],
            capacity_rps_at_breach_point=head["capacity_rps_at_breach_point"],
            arrival_lag_p95_s=report["arrival_lag"]["p95_s"],
            recovery_s=report["fault"]["recovery_s"],
            sheds_in_fault_window=report["fault"]["sheds_in_window"],
            breach=bool(
                report["slo_final"] and report["slo_final"].get("breach")
            ),
            interrupted=report["interrupted"],
        )
        return True


class _TelemetryTee:
    """Sits where the engine expects a telemetry collector: the records
    the harness accounts on (serve/shed/slo) are teed into it, and
    EVERYTHING — including kinds the harness ignores — forwards to the
    wrapped inner collector when one is attached. The engine's ``_tele``
    dispatch is ``getattr``-guarded, so missing methods (no inner) are
    simply skipped."""

    def __init__(self, harness: SoakHarness, inner=None):
        self._harness = harness
        self._inner = inner

    def record_serve(self, **fields):
        self._harness._on_serve(fields)
        if self._inner is not None:
            fn = getattr(self._inner, "record_serve", None)
            if fn is not None:
                fn(**fields)

    def record_shed(self, **fields):
        self._harness._on_shed(fields)
        if self._inner is not None:
            fn = getattr(self._inner, "record_shed", None)
            if fn is not None:
                fn(**fields)

    def record_slo(self, **fields):
        self._harness._on_slo(fields)
        if self._inner is not None:
            fn = getattr(self._inner, "record_slo", None)
            if fn is not None:
                fn(**fields)

    def record_preempt(self, **fields):
        self._harness._on_preempt(fields)
        if self._inner is not None:
            fn = getattr(self._inner, "record_preempt", None)
            if fn is not None:
                fn(**fields)

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        inner = self.__dict__.get("_inner")
        if inner is None:
            raise AttributeError(name)
        return getattr(inner, name)

