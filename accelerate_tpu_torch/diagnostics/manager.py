"""DiagnosticsManager: the glue between the telemetry stream and the
four diagnostics pieces.

Port of ``accelerate_tpu/diagnostics/manager.py``, as it stands; a
finished capture's ``top_ops`` and ``overlap_pct`` come from its
``torch.profiler`` trace (``compilation/overlap.py``).

Owned by :class:`~accelerate_tpu_torch.telemetry.StepTelemetry` (built when
``TelemetryConfig.diagnostics`` is set); the collector feeds every
emitted record through :meth:`observe`, which returns the extra records
(``kind="anomaly"``, ``kind="goodput"``) to emit through the same sinks.
The step path runs on the train-loop thread; checkpoint records arrive
from the async writer thread and stall callbacks from the heartbeat
watchdog — each sub-piece is internally thread-safe and the manager adds
no blocking of its own.
"""

from __future__ import annotations

from typing import Optional

from ..logging import get_logger
from .anomaly import AnomalyDetector
from .capture import TraceCapture
from .config import DiagnosticsConfig
from .flight_recorder import FlightRecorder
from .goodput import GoodputAccounting

logger = get_logger(__name__)


class DiagnosticsManager:
    def __init__(
        self,
        config: Optional[DiagnosticsConfig] = None,
        process_index: Optional[int] = None,
    ):
        self.config = config or DiagnosticsConfig()
        cfg = self.config
        # the collector feeds dataloader waits directly (record_wait), so
        # the goodput fold must not re-count them from step records
        self.goodput = (
            GoodputAccounting(window_s=cfg.goodput_window_s, fold_dataloader=False)
            if cfg.goodput
            else None
        )
        self.anomaly = AnomalyDetector(cfg) if cfg.anomaly else None
        self.capture = TraceCapture(cfg)
        self.recorder = FlightRecorder(cfg, process_index=process_index)
        self._steps_seen = 0
        # fields derived from a finished profile capture (overlap_pct);
        # the collector drains them onto the NEXT step record — the step
        # that triggered the stop has already been emitted by then
        self._pending_step_fields: dict = {}
        if cfg.install_excepthook and cfg.dir is not None:
            self.recorder.install_excepthook()
        if cfg.sigusr1:
            self.capture.install_signal()

    # ------------------------------------------------------------------ #
    def observe(self, record: dict, scalars: Optional[dict] = None) -> list[dict]:
        """Fold one telemetry record; returns derived records to emit.

        Derived records (anomaly/goodput) re-enter through the collector's
        emit path, so they land in the ring and every sink — they come
        back here once, get archived in the flight ring, and derive
        nothing further (no recursion).

        This runs on the train-loop thread, so its cost IS harness
        overhead. Everything here is O(1) per step except the anomaly
        median/MAD fold, which sorts its rolling window; with
        ``DiagnosticsConfig.anomaly_sample_every > 1`` that fold runs on
        every Nth step only (NaN detection still every step), making the
        whole path O(1) amortized — chip_smoke.py's phase 15 (the
        reference's ON-vs-OFF ``overhead`` variant) measures the result as
        ``harness_overhead_pct``.
        """
        kind = record.get("kind")
        if kind in ("anomaly", "goodput"):
            self.recorder.observe(record)
            return []
        if self.goodput is not None:
            self.goodput.observe(record)
        self.recorder.observe(record)
        if kind == "slo":
            # the serving SLO tracker did the burn-rate statistics; a
            # breach gets the same treatment as a detected step anomaly
            # (alarm record, flight event, optional profile capture)
            out = []
            if self.anomaly is not None:
                for anom in self.anomaly.observe_slo(record):
                    out.append(anom)
                    self.recorder.event(
                        "anomaly",
                        anomaly_type=anom["anomaly_type"],
                        value=anom.get("value"),
                        breached_objectives=anom.get("breached_objectives"),
                    )
                    if self.config.capture_on_anomaly:
                        self.capture.request("anomaly_slo_breach")
            return out
        if kind == "soak":
            # loadgen phase summaries: a breached soak phase raises the
            # same alarm machinery as a live slo breach
            out = []
            if self.anomaly is not None:
                for anom in self.anomaly.observe_soak(record):
                    out.append(anom)
                    self.recorder.event(
                        "anomaly",
                        anomaly_type=anom["anomaly_type"],
                        value=anom.get("value"),
                        phase=anom.get("phase"),
                    )
                    if self.config.capture_on_anomaly:
                        self.capture.request("anomaly_soak_breach")
            return out
        if kind == "memory":
            # the live-buffer census stream: the leak rule watches the
            # unowned bucket for monotone growth (same alarm/capture
            # treatment as step anomalies)
            out = []
            if self.anomaly is not None:
                for anom in self.anomaly.observe_memory(record):
                    out.append(anom)
                    self.recorder.event(
                        "anomaly",
                        anomaly_type=anom["anomaly_type"],
                        value=anom.get("value"),
                        growth_bytes=anom.get("growth_bytes"),
                    )
                    if self.config.capture_on_anomaly:
                        self.capture.request("anomaly_memory_leak")
            return out
        if kind == "audit":
            # sharding X-ray verdicts: a compiled program whose HLO holds
            # collectives its layout does not explain raises the same
            # alarm machinery as every other anomaly source
            out = []
            if self.anomaly is not None:
                for anom in self.anomaly.observe_audit(record):
                    out.append(anom)
                    self.recorder.event(
                        "anomaly",
                        anomaly_type=anom["anomaly_type"],
                        value=anom.get("value"),
                        program=anom.get("program"),
                        op=anom.get("op"),
                    )
                    if self.config.capture_on_anomaly:
                        self.capture.request("anomaly_sharding_violation")
            return out
        if kind != "step":
            return []

        out: list[dict] = []
        self._steps_seen += 1
        if self.anomaly is not None:
            for anom in self.anomaly.observe(record, scalars):
                out.append(anom)
                self.recorder.event(
                    "anomaly",
                    anomaly_type=anom["anomaly_type"],
                    step=anom.get("step"),
                    value=anom.get("value"),
                )
                if self.config.capture_on_anomaly:
                    self.capture.request(f"anomaly_{anom['anomaly_type']}")
        # the step boundary drives the capture state machine (external
        # trigger polling, pending-capture start, active countdown/stop)
        started = self.capture.on_step(record.get("step"))
        if started is not None:
            self.recorder.event(
                "trace_capture", dump=False,
                dir=started["dir"], reason=started["reason"],
                start_step=started["start_step"],
            )
        finished = self.capture.pop_finished()
        if finished is not None:
            # collective/compute overlap evidence from the fresh trace
            # (best-effort: None on CPU / unparseable dumps)
            from ..compilation.overlap import (
                collective_compute_overlap,
                top_self_time_ops,
            )

            top_ops = top_self_time_ops(finished["dir"], k=5)
            if top_ops:
                self._pending_step_fields["top_ops"] = top_ops
                self._pending_step_fields["top_ops_capture_dir"] = (
                    finished["dir"]
                )
            report = collective_compute_overlap(finished["dir"])
            if report is not None:
                self._pending_step_fields["overlap_pct"] = round(
                    report["overlap_pct"], 2
                )
                self._pending_step_fields["overlap_capture_dir"] = (
                    finished["dir"]
                )
                self.recorder.event(
                    "overlap_report", dump=False,
                    dir=finished["dir"],
                    overlap_pct=report["overlap_pct"],
                )
        if (
            self.goodput is not None
            and self.config.goodput_interval
            and self._steps_seen % self.config.goodput_interval == 0
        ):
            out.append(self.goodput.record(step=record.get("step")))
        return out

    def pop_step_fields(self) -> dict:
        """Fields the next step record should carry (capture-derived
        ``overlap_pct``); drained once by the collector pre-emit."""
        fields, self._pending_step_fields = self._pending_step_fields, {}
        return fields

    def record_wait(self, seconds: float, source: str = "dataloader") -> None:
        """Live dataloader-wait attribution (called as each wait ends, so
        a starved loop with no subsequent step still shows up)."""
        if self.goodput is not None:
            self.goodput.add("dataloader", seconds)
        if seconds >= self.config.dataloader_stall_event_s:
            self.recorder.event(
                "dataloader_stall", dump=False, seconds=seconds, source=source
            )

    def on_stall(self, monitor) -> None:
        """Heartbeat watchdog callback: the hang evidence goes to disk NOW
        — by the time the scheduler kills the job it is too late."""
        self.recorder.event(
            "heartbeat_stall",
            last_step=getattr(monitor, "last_step", None),
            stall_timeout_s=getattr(monitor, "stall_timeout_s", None),
        )

    def dump(self, reason: str) -> Optional[str]:
        """Force a flight-recorder dump (preemption / shutdown paths)."""
        extra = (
            {"goodput": self.goodput.snapshot()} if self.goodput is not None else None
        )
        return self.recorder.dump(reason, extra=extra)

    # ------------------------------------------------------------------ #
    def summary(self) -> dict:
        out: dict = {}
        if self.goodput is not None:
            snap = self.goodput.snapshot()
            out["goodput"] = {
                "goodput_pct": snap["goodput_pct"],
                "rolling_goodput_pct": snap["rolling_goodput_pct"],
                "wall_s": snap["wall_s"],
                "buckets_s": snap["buckets"],
            }
        if self.anomaly is not None:
            out.update(self.anomaly.summary())
        out.update(self.capture.summary())
        if self.config.dir is not None:
            out.update(self.recorder.summary())
        return out

    def close(self) -> None:
        """Final dump + release hooks (idempotent)."""
        self.capture.close()
        if self.config.dir is not None:
            self.dump("shutdown")
        self.recorder.uninstall_excepthook()

    def set_profile_kwargs(self, profile_kwargs) -> None:
        """Adopt the Accelerator-level ``ProfileKwargs`` tracer options
        for triggered captures (the dir still comes from ``trace_dir``)."""
        if profile_kwargs is not None:
            self.capture.profile_kwargs = profile_kwargs
