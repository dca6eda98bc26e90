"""The port's diagnostics plane against the JAX reference's, on the CPU.

The cases of ``tests/test_diagnostics.py`` run on the port (goodput
accounting, anomaly detection, triggered captures with the profiler
stubbed, the flight recorder, the manager, the sinks, ``PeakHostMemory``,
``Accelerator.profile``, ``diagnose`` and its CLI, the accelerator end to
end, a SIGKILLed child that imports the port only), the leak-rule pair of
``tests/test_profiling.py``, and three parity checks: one synthetic record
stream with a fake clock through both packages' ``DiagnosticsManager``
(the derived ``anomaly`` and ``goodput`` records equal field for field);
``build_report``/``format_report`` of both packages on a directory the port
wrote (equal, with paths and times excepted); and a tiny ``CausalLM`` with
``diagnostics=`` for 4 fp32 steps in both packages (the step, goodput and
anomaly records equal in keys and values, times excepted, losses and
norms at 2e-5). No case bounds the host's time.
"""

import json
import math
import os
import re
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu.diagnostics as jdiag  # noqa: E402
import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu.diagnostics import anomaly as janomaly  # noqa: E402
from accelerate_tpu.diagnostics import flight_recorder as jflight  # noqa: E402
from accelerate_tpu.diagnostics import goodput as jgoodput  # noqa: E402
from accelerate_tpu.models.config import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu_torch import DiagnosticsConfig  # noqa: E402
from accelerate_tpu_torch.checkpoint_async import commit as pcommit  # noqa: E402
from accelerate_tpu_torch.diagnostics import (  # noqa: E402
    AnomalyDetector,
    DiagnosticsManager,
    FlightRecorder,
    GoodputAccounting,
    TraceCapture,
    build_report,
    format_report,
    list_dumps,
)
from accelerate_tpu_torch.diagnostics import anomaly as panomaly  # noqa: E402
from accelerate_tpu_torch.diagnostics import flight_recorder as pflight  # noqa: E402
from accelerate_tpu_torch.diagnostics import goodput as pgoodput  # noqa: E402
from accelerate_tpu_torch.loadgen.report import write_report  # noqa: E402
from accelerate_tpu_torch.telemetry import (  # noqa: E402
    JSONLSink,
    PrometheusTextSink,
    StepTelemetry,
    TelemetryConfig,
)
from accelerate_tpu_torch.utils import profiling  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
# the reference's step records carry XLA's compile accounting
XLA_ONLY = {"compile_time_s", "persistent_cache_hits", "persistent_cache_misses",
            "compile_time_saved_s"}
# measured by each process for itself: present in both, values not compared
TIMES = {"time_unix", "step_time_s", "dispatch_s", "dataloader_wait_s", "tokens_per_s",
         "wall_s", "goodput_pct", "rolling_goodput_pct", "productive_s", "badput_compile_s",
         "badput_dataloader_s", "badput_checkpoint_s", "badput_idle_s"}
MEMORY = {"peak_hbm_bytes", "hbm_bytes_in_use", "hbm_bytes_limit", "host_rss_bytes"}


def _reset():
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()


@pytest.fixture(autouse=True)
def reset_singletons():
    _reset()
    yield
    _reset()


def _step_record(step, step_time_s=0.1, **fields):
    return {
        "kind": "step",
        "label": "step",
        "step": step,
        "time_unix": time.time(),
        "step_time_s": step_time_s,
        "retraced": False,
        **fields,
    }


class _Session:
    """What the stubbed ``start_trace`` returns: a session that steps."""

    def __init__(self):
        self.steps = 0

    def step(self):
        self.steps += 1


class _ProfilerStub:
    """Stand-in for the port's ``start_trace``/``stop_trace`` (a real
    ``torch.profiler`` session is process-global; the capture logic is what
    is under test; ``tests/test_torch_profiling.py`` runs the real one)."""

    def __init__(self, monkeypatch):
        self.starts: list[str] = []
        self.stops = 0

        def start(target, kw):
            self.starts.append(target)
            return _Session()

        def stop(prof, target, kw=None):
            self.stops += 1

        monkeypatch.setattr(profiling, "start_trace", start)
        monkeypatch.setattr(profiling, "stop_trace", stop)


# ---------------------------------------------------------------------- #
# goodput accounting
# ---------------------------------------------------------------------- #
def test_goodput_buckets_sum_to_wall_clock():
    g = GoodputAccounting(window_s=60.0, now=0.0)
    now = 0.0
    for i in range(20):
        now += 0.5
        g.observe(_step_record(i, step_time_s=0.4, dataloader_wait_s=0.05), now=now)
    now += 3.0
    g.observe({"kind": "compile", "compile_time_s": 2.5}, now=now)
    now += 1.0
    g.observe({"kind": "checkpoint", "blocked_s": 0.7}, now=now)
    snap = g.snapshot(now=now)
    assert snap["wall_s"] == pytest.approx(14.0)
    assert sum(snap["buckets"].values()) == pytest.approx(snap["wall_s"], abs=1e-9)
    assert snap["buckets"]["productive"] == pytest.approx(20 * 0.4)
    assert snap["buckets"]["compile"] == pytest.approx(2.5)
    assert snap["buckets"]["dataloader"] == pytest.approx(20 * 0.05)
    assert snap["buckets"]["checkpoint"] == pytest.approx(0.7)
    assert snap["goodput_pct"] == pytest.approx(100.0 * 8.0 / 14.0)


def test_goodput_in_step_compile_is_badput_not_productive():
    g = GoodputAccounting(now=0.0)
    g.observe(_step_record(0, step_time_s=5.0, compile_time_s=4.5), now=5.0)
    snap = g.snapshot(now=5.0)
    assert snap["buckets"]["productive"] == pytest.approx(0.5)
    assert snap["buckets"]["compile"] == pytest.approx(4.5)


def test_goodput_rolling_window_forgets_old_badput():
    g = GoodputAccounting(window_s=10.0, now=0.0)
    g.observe({"kind": "compile", "compile_time_s": 50.0}, now=1.0)  # old
    now = 100.0
    for i in range(8):
        now += 1.0
        g.observe(_step_record(i, step_time_s=1.0), now=now)
    snap = g.snapshot(now=now)
    assert snap["goodput_pct"] < 10.0
    assert snap["rolling_goodput_pct"] == pytest.approx(80.0)


def test_goodput_record_is_flat_and_sink_ready():
    g = GoodputAccounting(now=0.0)
    g.observe(_step_record(3, step_time_s=1.0), now=2.0)
    rec = g.record(step=3, now=4.0)
    assert rec["kind"] == "goodput"
    assert rec["wall_s"] == pytest.approx(4.0)
    assert rec["productive_s"] == pytest.approx(1.0)
    for bucket in ("compile", "dataloader", "checkpoint", "idle"):
        assert isinstance(rec[f"badput_{bucket}_s"], float)
    assert rec["badput_idle_s"] == pytest.approx(3.0)
    json.dumps(rec)


def test_goodput_rejects_unknown_bucket():
    with pytest.raises(ValueError):
        GoodputAccounting().add("naptime", 1.0)


# ---------------------------------------------------------------------- #
# anomaly detection
# ---------------------------------------------------------------------- #
def test_slow_step_fires_exactly_once_under_cooldown():
    det = AnomalyDetector(DiagnosticsConfig(anomaly_min_samples=4))
    fired = []
    now = 0.0
    for i in range(10):
        now += 0.1
        fired += det.observe(_step_record(i, step_time_s=0.1), now=now)
    assert fired == []
    for i in range(10, 16):
        now += 5.0
        fired += det.observe(_step_record(i, step_time_s=5.0), now=now)
    assert len(fired) == 1
    rec = fired[0]
    assert rec["kind"] == "anomaly"
    assert rec["anomaly_type"] == "slow_step"
    assert rec["step"] == 10
    assert rec["value"] == pytest.approx(5.0)
    assert rec["baseline_median"] == pytest.approx(0.1)
    assert rec["record"]["step_time_s"] == pytest.approx(5.0)
    assert det._suppressed["slow_step"] == 5
    assert det.counts["slow_step"] == 6


def test_suppressed_count_reported_on_next_fire():
    det = AnomalyDetector(DiagnosticsConfig(anomaly_min_samples=4, anomaly_cooldown_steps=3,
                                            anomaly_cooldown_s=0.0))
    fired = []
    for i in range(20):
        scalars = {"loss": float("nan")} if i >= 10 else {"loss": 1.0}
        fired += det.observe(_step_record(i), scalars, now=float(i))
    assert [f["step"] for f in fired] == [10, 13, 16, 19]
    assert fired[0]["suppressed_since_last"] == 0
    assert fired[1]["suppressed_since_last"] == 2
    assert fired[-1]["total_of_type"] == 10


def test_nan_grad_fires_immediately_without_baseline():
    det = AnomalyDetector(DiagnosticsConfig())
    fired = det.observe(_step_record(0), {"loss": 1.0, "grad_norm": float("inf")}, now=0.0)
    assert len(fired) == 1
    assert fired[0]["anomaly_type"] == "nan_grad"
    assert fired[0]["fields"] == "grad_norm"


def test_grads_finite_zero_is_a_nan_signal():
    det = AnomalyDetector(DiagnosticsConfig())
    fired = det.observe(_step_record(0), {"loss": 1.0, "grads_finite": 0.0}, now=0.0)
    assert [f["anomaly_type"] for f in fired] == ["nan_grad"]


def test_loss_spike_fires_and_retraced_steps_never_slow_step():
    det = AnomalyDetector(DiagnosticsConfig(anomaly_min_samples=4))
    fired = []
    now = 0.0
    for i in range(8):
        now += 0.1
        fired += det.observe(_step_record(i), {"loss": 1.0}, now=now)
    now += 60.0
    fired += det.observe(_step_record(8, step_time_s=60.0, retraced=True), {"loss": 1.0},
                         now=now)
    assert fired == []
    now += 0.1
    fired += det.observe(_step_record(9), {"loss": 500.0}, now=now)
    assert [f["anomaly_type"] for f in fired] == ["loss_spike"]
    assert fired[0]["value"] == pytest.approx(500.0)


def test_nan_grad_detected_through_collector_raw_scalars():
    """The collector takes a non-finite grad_norm off the record (NaN is no
    JSON); detection still sees it, and one anomaly record reaches the
    stream. The port's step reports ``is_sync_step`` as a host bool."""
    tel = StepTelemetry(TelemetryConfig(
        heartbeat=False, diagnostics=DiagnosticsConfig(dir=None, goodput_interval=0)))
    for i in range(5):
        tel.begin_step()
        tel.end_step(None, step=i, metrics={"loss": 1.0, "grad_norm": float("nan"),
                                            "is_sync_step": True})
    steps = [r for r in tel.records if r["kind"] == "step"]
    assert all("grad_norm" not in r for r in steps)
    anomalies = [r for r in tel.records if r["kind"] == "anomaly"]
    assert len(anomalies) == 1
    assert anomalies[0]["anomaly_type"] == "nan_grad"
    tel.close()


def test_leak_rule_fires_on_monotone_unowned_growth():
    det = AnomalyDetector(DiagnosticsConfig(leak_min_samples=3, leak_min_growth_bytes=1000))
    mk = lambda step, b: {"kind": "memory", "step": step, "census_unowned_bytes": b}  # noqa: E731
    assert det.observe_memory(mk(1, 1000), now=1.0) == []
    assert det.observe_memory(mk(2, 3000), now=2.0) == []
    out = det.observe_memory(mk(3, 5000), now=3.0)
    assert len(out) == 1
    rec = out[0]
    assert rec["kind"] == "anomaly"
    assert rec["anomaly_type"] == "memory_leak"
    assert rec["growth_bytes"] == 4000
    assert rec["samples"] == 3


def test_leak_rule_flat_census_resets_the_trail():
    det = AnomalyDetector(DiagnosticsConfig(leak_min_samples=3, leak_min_growth_bytes=1000))
    mk = lambda step, b: {"kind": "memory", "step": step, "census_unowned_bytes": b}  # noqa: E731
    det.observe_memory(mk(1, 1000), now=1.0)
    det.observe_memory(mk(2, 3000), now=2.0)
    assert det.observe_memory(mk(3, 3000), now=3.0) == []
    assert det.observe_memory(mk(4, 3100), now=4.0) == []
    assert det.observe_memory(mk(5, 3200), now=5.0) == []
    assert det.observe_memory(mk(6, 9000), now=6.0) != []
    assert det.observe_memory({"kind": "step", "step": 7}, now=7.0) == []
    assert det.observe_memory({"kind": "memory", "step": 8}, now=8.0) == []


def test_training_census_rides_the_step_cadence_and_feeds_the_leak_rule():
    """``census_interval`` takes a census every N step records; memory
    records whose unowned bytes grow at every census fire one
    ``memory_leak`` anomaly through the collector (on the CPU the census
    has no allocator total, so its unowned bytes are 0 and the growth is
    given here)."""
    tel = StepTelemetry(TelemetryConfig(
        census_interval=2, census_min_interval_s=0.0,
        diagnostics=DiagnosticsConfig(leak_min_samples=3, leak_min_growth_bytes=1, goodput=False)))
    tel.census.set_owner("weights", torch.zeros(16))
    for i in range(8):
        tel.begin_step()
        tel.end_step(None, step=i)
    memory = [r for r in tel.records if r["kind"] == "memory"]
    assert [r["step"] for r in memory] == [1, 3, 5, 7]
    assert memory[0]["census_owner_bytes"] == {"weights": 64}
    for i in range(4):
        tel.record_memory(step=8, census_unowned_bytes=(i + 1) << 20)
    leaks = [r for r in tel.records if r.get("anomaly_type") == "memory_leak"]
    assert len(leaks) == 1 and leaks[0]["growth_bytes"] == 2 << 20
    tel.close()


# ---------------------------------------------------------------------- #
# triggered trace capture
# ---------------------------------------------------------------------- #
def test_capture_bounded_by_max_captures(tmp_path, monkeypatch):
    stub = _ProfilerStub(monkeypatch)
    cap = TraceCapture(DiagnosticsConfig(trace_dir=str(tmp_path), capture_steps=2,
                                         max_captures=2))
    for step in range(20):
        cap.request("anomaly_slow_step")
        cap.on_step(step)
    assert len(cap.captures) == 2
    assert stub.starts == [c["dir"] for c in cap.captures]
    assert stub.stops == 2
    assert cap.exhausted and not cap.active
    for entry in cap.captures:
        assert os.path.isdir(entry["dir"])
        assert "anomaly_slow_step" in os.path.basename(entry["dir"])
    assert cap.request("more") is False


def test_capture_runs_for_capture_steps_then_stops(tmp_path, monkeypatch):
    stub = _ProfilerStub(monkeypatch)
    cap = TraceCapture(DiagnosticsConfig(trace_dir=str(tmp_path), capture_steps=3))
    cap.request("x")
    started = cap.on_step(0)
    assert started is not None and cap.active
    session = cap._prof
    cap.on_step(1)
    cap.on_step(2)
    assert cap.active and stub.stops == 0
    cap.on_step(3)
    assert not cap.active and stub.stops == 1
    assert session.steps == 3  # the session was stepped at each boundary


def test_capture_disabled_without_trace_dir(monkeypatch):
    stub = _ProfilerStub(monkeypatch)
    cap = TraceCapture(DiagnosticsConfig(trace_dir=None))
    assert cap.request("anomaly") is False
    cap.on_step(0)
    assert stub.starts == [] and cap.captures == []


def test_trigger_file_touch_starts_one_capture(tmp_path, monkeypatch):
    stub = _ProfilerStub(monkeypatch)
    trigger = tmp_path / "trace-now"
    cap = TraceCapture(DiagnosticsConfig(trace_dir=str(tmp_path / "traces"), capture_steps=1,
                                         trigger_file=str(trigger)))
    cap.on_step(0)
    assert stub.starts == []
    trigger.write_text("go")
    cap.on_step(1)
    assert len(stub.starts) == 1
    assert "trigger_file" in stub.starts[0]
    cap.on_step(2)
    cap.on_step(3)
    assert len(stub.starts) == 1


def test_capture_start_failure_never_raises(tmp_path, monkeypatch):
    def _boom(target, kw):
        raise RuntimeError("profiler already active")

    monkeypatch.setattr(profiling, "start_trace", _boom)
    cap = TraceCapture(DiagnosticsConfig(trace_dir=str(tmp_path)))
    cap.request("anomaly")
    assert cap.on_step(0) is None
    assert cap.captures == [] and not cap.active


# ---------------------------------------------------------------------- #
# flight recorder
# ---------------------------------------------------------------------- #
def test_flight_recorder_dump_atomic_with_ring_and_checkpoint(tmp_path):
    rec = FlightRecorder(DiagnosticsConfig(dir=str(tmp_path), ring_size=4, dump_interval_s=1e9),
                         process_index=0)
    for i in range(10):
        rec.observe(_step_record(i))
    rec.observe({"kind": "checkpoint", "step": 8, "dir": "/ck/checkpoint_8", "time_unix": 123.0})
    path = rec.dump("test")
    assert path == str(tmp_path / "flightrec-rank0.json")
    payload = json.loads(open(path).read())
    assert payload["kind"] == "flight_recorder"
    assert payload["reason"] == "test"
    assert payload["last_step"] == 9
    assert payload["last_checkpoint"]["dir"] == "/ck/checkpoint_8"
    assert payload["last_checkpoint"]["step"] == 8
    assert len(payload["records"]) == 4
    assert not [f for f in os.listdir(tmp_path) if ".tmp" in f]


def test_flight_recorder_periodic_dump_from_observe(tmp_path):
    rec = FlightRecorder(DiagnosticsConfig(dir=str(tmp_path), dump_interval_s=0.0))
    rec.observe(_step_record(1))
    dumps = list_dumps(str(tmp_path))
    assert dumps and dumps[rec.process_index]["reason"] == "periodic"


def test_flight_recorder_excepthook_dumps_then_chains(tmp_path):
    rec = FlightRecorder(DiagnosticsConfig(dir=str(tmp_path)), process_index=0)
    seen = []
    prev, sys.excepthook = sys.excepthook, lambda *a: seen.append(a)
    try:
        rec.install_excepthook()
        try:
            raise ValueError("boom")
        except ValueError:
            sys.excepthook(*sys.exc_info())
    finally:
        rec.uninstall_excepthook()
        sys.excepthook = prev
    assert len(seen) == 1
    payload = list_dumps(str(tmp_path))[0]
    assert payload["reason"] == "exception:ValueError"
    events = [e for e in payload["events"] if e["event"] == "exception"]
    assert "ValueError: boom" in events[0]["exception"]
    assert "boom" in events[0]["traceback"]


def test_list_dumps_skips_torn_files(tmp_path):
    (tmp_path / "flightrec-rank0.json").write_text('{"process_index": 0, "x"')
    (tmp_path / "flightrec-rank1.json").write_text(json.dumps({"process_index": 1,
                                                               "last_step": 7}))
    assert list(list_dumps(str(tmp_path))) == [1]


def test_process_index_comes_from_the_port_state():
    assert FlightRecorder(DiagnosticsConfig()).process_index == 0
    from accelerate_tpu_torch.state import PartialState

    state = PartialState(cpu=True)
    state.process_index = 3  # what a later multi-process state would set
    try:
        assert FlightRecorder(DiagnosticsConfig()).process_index == 3
        assert port.HeartbeatMonitor().process_index == 3
    finally:
        state.process_index = 0


# ---------------------------------------------------------------------- #
# the manager
# ---------------------------------------------------------------------- #
def test_manager_anomaly_triggers_bounded_captures(tmp_path, monkeypatch):
    stub = _ProfilerStub(monkeypatch)
    mgr = DiagnosticsManager(DiagnosticsConfig(
        dir=str(tmp_path / "diag"), trace_dir=str(tmp_path / "traces"), capture_steps=1,
        max_captures=2, anomaly_cooldown_steps=0, anomaly_cooldown_s=0.0, goodput_interval=0,
        install_excepthook=False), process_index=0)
    for i in range(6):
        out = mgr.observe(_step_record(i), {"loss": float("nan")})
        assert [r["kind"] for r in out] == ["anomaly"]
    assert len(stub.starts) == 2
    assert mgr.capture.exhausted
    events = [e["event"] for e in mgr.recorder.events]
    assert events.count("anomaly") == 6
    assert events.count("trace_capture") == 2
    mgr.close()


def test_manager_emits_goodput_records_on_interval():
    mgr = DiagnosticsManager(DiagnosticsConfig(goodput_interval=3, anomaly=False))
    kinds = []
    for i in range(9):
        kinds += [r["kind"] for r in mgr.observe(_step_record(i))]
    assert kinds == ["goodput", "goodput", "goodput"]
    assert mgr.observe({"kind": "goodput", "wall_s": 1.0}) == []


def test_manager_record_wait_feeds_goodput_and_stall_events(tmp_path):
    mgr = DiagnosticsManager(DiagnosticsConfig(dir=str(tmp_path), dataloader_stall_event_s=1.0,
                                               install_excepthook=False))
    mgr.record_wait(0.2, source="shard")
    mgr.record_wait(2.5, source="shard")
    assert mgr.goodput.totals["dataloader"] == pytest.approx(2.7)
    stalls = [e for e in mgr.recorder.events if e["event"] == "dataloader_stall"]
    assert len(stalls) == 1 and stalls[0]["seconds"] == pytest.approx(2.5)
    mgr.close()


def test_manager_on_stall_dumps(tmp_path):
    mgr = DiagnosticsManager(DiagnosticsConfig(dir=str(tmp_path), install_excepthook=False))
    mgr.on_stall(type("FakeMonitor", (), {"last_step": 41, "stall_timeout_s": 300.0})())
    payload = list_dumps(str(tmp_path))[mgr.recorder.process_index]
    assert payload["reason"] == "heartbeat_stall"
    assert payload["events"][-1]["last_step"] == 41
    mgr.close()


def test_collector_dataloader_wait_reaches_the_manager(tmp_path):
    tel = StepTelemetry(TelemetryConfig(diagnostics=DiagnosticsConfig(
        dataloader_stall_event_s=1.0, install_excepthook=False)))
    tel.record_dataloader_wait(0.25)
    tel.record_dataloader_wait(1.5, source="dispatcher")
    assert tel.diagnostics.goodput.totals["dataloader"] == pytest.approx(1.75)
    stalls = [e for e in tel.diagnostics.recorder.events if e["event"] == "dataloader_stall"]
    assert [e["source"] for e in stalls] == ["dispatcher"]
    tel.begin_step()
    rec = tel.end_step(None, step=0)
    assert rec["dataloader_wait_s"] == pytest.approx(1.75)
    tel.close()


# ---------------------------------------------------------------------- #
# sinks
# ---------------------------------------------------------------------- #
def test_prometheus_sink_escapes_label_values(tmp_path):
    path = tmp_path / "metrics.prom"
    sink = PrometheusTextSink(str(path))
    sink.emit({"kind": "step", "label": 'train"fn\\v1\nx', "step_time_s": 0.5})
    text = path.read_text()
    assert 'label="train\\"fn\\\\v1\\nx"' in text
    assert "\nx" not in text.split("label=")[1].split(" ")[0]


def test_prometheus_sink_exports_goodput_records(tmp_path):
    path = tmp_path / "metrics.prom"
    sink = PrometheusTextSink(str(path))
    sink.emit({"kind": "goodput", "label": "goodput", "goodput_pct": 87.5,
               "badput_compile_s": 12.0})
    text = path.read_text()
    assert "accelerate_tpu_goodput_pct" in text
    assert "87.5" in text
    assert "accelerate_tpu_badput_compile_s" in text


def test_prometheus_training_text_equals_the_reference():
    """Step, goodput and anomaly records render as the reference renders
    them (the anomaly record is not a gauge in either)."""
    records = [
        {"kind": "meta", "schema": 1, "time_unix": 1.0},
        _step_record(3, step_time_s=0.25, dispatch_s=0.01, dataloader_wait_s=0.002,
                     tokens_per_s=1234.5, loss=2.5, label='unified_step#0"x'),
        {"kind": "goodput", "label": "goodput", "step": 3, "time_unix": 2.0, "wall_s": 10.0,
         "goodput_pct": 87.5, "rolling_goodput_pct": None, "productive_s": 8.75,
         "badput_compile_s": 0.0, "badput_dataloader_s": 0.25, "badput_checkpoint_s": 0.5,
         "badput_idle_s": 0.5},
        {"kind": "anomaly", "label": "anomaly", "anomaly_type": "nan_grad", "step": 4,
         "value": float("nan"), "suppressed_since_last": 0, "total_of_type": 1,
         "record": {"kind": "step"}},
        {"label": "custom", "value": 7},
    ]
    sinks = (PrometheusTextSink(None), jax_pkg.PrometheusTextSink(None))
    for sink in sinks:
        for rec in records:
            sink.emit(rec)
    text = sinks[0].render()
    assert text == sinks[1].render()
    assert "accelerate_tpu_step_time_seconds" in text and "anomaly" not in text


def test_jsonl_sink_close_flushes_durably(tmp_path):
    path = tmp_path / "t.jsonl"
    sink = JSONLSink(str(path))
    sink.emit({"kind": "step", "step": 1})
    sink.close()
    sink.close()
    assert json.loads(path.read_text().strip())["step"] == 1


# ---------------------------------------------------------------------- #
# PeakHostMemory
# ---------------------------------------------------------------------- #
def test_peak_host_memory_stop_joins_thread_and_restarts():
    tracker = profiling.PeakHostMemory()
    before = threading.active_count()
    for _ in range(3):
        tracker.start()
        thread = tracker._thread
        peak = tracker.stop()
        assert peak > 0
        assert not thread.is_alive()
        assert tracker._thread is None
    assert threading.active_count() == before
    assert tracker.stop() == peak


def test_peak_host_memory_double_start_raises():
    tracker = profiling.PeakHostMemory()
    tracker.start()
    try:
        with pytest.raises(RuntimeError):
            tracker.start()
    finally:
        tracker.stop()


# ---------------------------------------------------------------------- #
# Accelerator.profile with the profiler stubbed
# ---------------------------------------------------------------------- #
def test_profile_creates_trace_dir_and_brackets_trace(tmp_path, monkeypatch):
    stub = _ProfilerStub(monkeypatch)
    acc = port.Accelerator(cpu=True)
    target = tmp_path / "trace"
    with acc.profile(str(target)) as handle:
        assert os.path.isdir(target)
        assert handle.dir == str(target)
        assert stub.starts == [str(target)]
        assert stub.stops == 0
    assert stub.stops == 1


def test_profile_skip_first_starts_lazily(tmp_path, monkeypatch):
    stub = _ProfilerStub(monkeypatch)
    acc = port.Accelerator(cpu=True, profile_kwargs=port.ProfileKwargs(
        output_trace_dir=str(tmp_path), skip_first=2))
    with acc.profile() as handle:
        assert stub.starts == []
        handle.step()
        assert stub.starts == []
        handle.step()
        assert stub.starts == [str(tmp_path)]
        handle.step()
    assert stub.stops == 1


def test_profile_noop_without_dir_stays_noop(monkeypatch):
    stub = _ProfilerStub(monkeypatch)
    acc = port.Accelerator(cpu=True)
    with acc.profile() as handle:
        assert handle is None
    assert stub.starts == [] and stub.stops == 0


# ---------------------------------------------------------------------- #
# diagnose: aggregation and CLI (each report held against the reference's)
# ---------------------------------------------------------------------- #
def _write_rank(dir, rank, last_step, heartbeat_age_s, goodput=None, checkpoint=None,
                reason="periodic"):
    payload = {
        "kind": "flight_recorder", "schema": 1, "process_index": rank,
        "pid": 1000 + rank, "reason": reason, "time_unix": time.time(),
        "last_step": last_step, "last_checkpoint": checkpoint,
        "dumps": 3, "events": [], "records": [],
    }
    if goodput:
        payload["goodput"] = goodput
    with open(os.path.join(dir, f"flightrec-rank{rank}.json"), "w") as f:
        json.dump(payload, f)
    with open(os.path.join(dir, f"heartbeat-rank{rank}.json"), "w") as f:
        json.dump({"process_index": rank, "pid": 1000 + rank, "step": last_step,
                   "time_unix": time.time() - heartbeat_age_s, "stalled": False}, f)


def _drop_times(obj):
    """The report with every age and time value set to None (each build
    reads the clock for itself)."""
    if isinstance(obj, dict):
        return {k: (None if ("age_s" in str(k) or "time_unix" in str(k)) else _drop_times(v))
                for k, v in obj.items()}
    if isinstance(obj, list):
        return [_drop_times(v) for v in obj]
    return obj


def _both_reports(d, stall_timeout_s=300.0):
    mine = build_report(d, stall_timeout_s=stall_timeout_s)
    ref = jdiag.build_report(d, stall_timeout_s=stall_timeout_s)
    assert json.dumps(_drop_times(mine), sort_keys=True, default=str) == json.dumps(
        _drop_times(ref), sort_keys=True, default=str)
    # the text's only clock reading is the straggler's silence, in whole seconds
    silent = re.compile(r"heartbeat silent \d+s")
    assert silent.sub("", format_report(mine)) == silent.sub("", jdiag.format_report(ref))
    return mine


def test_diagnose_names_straggler_checkpoint_and_badput(tmp_path):
    d = str(tmp_path)
    ckpt = {"dir": "/gcs/run/checkpoint_1000", "step": 1000, "time_unix": 5.0}
    snap = {"wall_s": 100.0, "goodput_pct": 80.0, "rolling_goodput_pct": 75.0,
            "buckets": {"productive": 80.0, "compile": 10.0, "dataloader": 4.0,
                        "checkpoint": 1.0, "idle": 5.0}}
    _write_rank(d, 0, 1200, heartbeat_age_s=600, goodput=snap, checkpoint=ckpt)
    _write_rank(d, 1, 1180, heartbeat_age_s=640, goodput=snap, checkpoint=ckpt)
    _write_rank(d, 2, 1200, heartbeat_age_s=590, goodput=snap,
                checkpoint={"dir": "/gcs/run/checkpoint_900", "step": 900, "time_unix": 4.0})
    report = _both_reports(d)
    assert report["num_ranks"] == 3
    assert report["straggler"]["rank"] == 1
    assert report["last_checkpoint"]["step"] == 1000
    assert report["goodput_pct"] == pytest.approx(80.0)
    assert report["badput_s"]["compile"] == pytest.approx(30.0)
    text = format_report(report)
    assert "STRAGGLER: rank 1" in text
    assert "last step 1180" in text
    assert "checkpoint_1000" in text
    assert "80.0% productive" in text
    assert "compile" in text and "dataloader" in text


def test_diagnose_clean_shutdown_names_no_straggler(tmp_path):
    d = str(tmp_path)
    _write_rank(d, 0, 500, heartbeat_age_s=0, reason="shutdown")
    _write_rank(d, 1, 500, heartbeat_age_s=0, reason="shutdown")
    report = _both_reports(d)
    assert report["straggler"] is None
    assert "No straggler" in format_report(report)


def test_diagnose_cli_empty_dir_exits_nonzero(tmp_path, capsys):
    from accelerate_tpu_torch.commands.accelerate_cli import main

    with pytest.raises(SystemExit) as exc:
        main(["diagnose", str(tmp_path)])
    assert exc.value.code == 1
    assert "No flight-recorder dumps" in capsys.readouterr().err


def test_diagnose_cli_json_output(tmp_path, capsys):
    from accelerate_tpu_torch.commands.accelerate_cli import main

    _write_rank(str(tmp_path), 0, 42, heartbeat_age_s=0)
    main(["diagnose", str(tmp_path), "--json"])
    report = json.loads(capsys.readouterr().out)
    assert report["num_dumps"] == 1
    assert report["ranks"]["0"]["last_step"] == 42


def test_diagnose_runs_as_a_module(tmp_path):
    """``python -m accelerate_tpu_torch.commands.accelerate_cli diagnose``:
    exit 0 with a dump, 1 on an empty directory."""
    _write_rank(str(tmp_path), 0, 7, heartbeat_age_s=0, reason="shutdown")
    empty = tmp_path / "empty"
    empty.mkdir()
    env = dict(os.environ, PYTHONPATH=str(REPO))
    cmd = [sys.executable, "-m", "accelerate_tpu_torch.commands.accelerate_cli", "diagnose"]
    ok = subprocess.run(cmd + [str(tmp_path)], cwd=REPO, env=env, capture_output=True,
                        text=True, timeout=300)
    assert ok.returncode == 0, ok.stderr
    assert "1 flight dump(s)" in ok.stdout
    bad = subprocess.run(cmd + [str(empty)], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300)
    assert bad.returncode == 1 and "No flight-recorder dumps" in bad.stderr


# ---------------------------------------------------------------------- #
# end to end through the Accelerator
# ---------------------------------------------------------------------- #
def test_accelerator_diagnostics_end_to_end(tmp_path, capsys):
    diag_dir = tmp_path / "diag"
    acc = port.Accelerator(cpu=True, diagnostics=DiagnosticsConfig(dir=str(diag_dir),
                                                                   goodput_interval=2))
    assert acc.telemetry.diagnostics is not None
    assert acc.telemetry.config.heartbeat_dir == str(diag_dir)

    def loss_fn(params, batch):
        return torch.mean((batch["x"] * params["w"]) ** 2)

    ds = [{"x": np.full((1,), float(i), np.float32)} for i in range(64)]
    opt, loader = acc.prepare(port.sgd(0.1), port.DataLoader(ds, batch_size=16))
    step_fn = acc.unified_step(loss_fn, opt)
    carry = acc.init_carry({"w": torch.tensor(1.0)}, opt)
    for batch in loader:
        carry, _ = step_fn(carry, batch)
    acc.telemetry.begin_step()
    acc.telemetry.end_step(None, step=98, metrics={"loss": float("nan")})

    kinds = [r["kind"] for r in acc.telemetry.records]
    assert "goodput" in kinds
    assert kinds.count("anomaly") == 1
    summary = acc.telemetry.summary()
    assert summary["goodput_pct"] is not None
    assert summary["anomalies"] == {"nan_grad": 1}
    assert summary["stalls"] == 0

    acc.end_training()
    dumps = list_dumps(str(diag_dir))
    assert dumps[0]["reason"] == "shutdown"
    assert dumps[0]["last_step"] == 98

    from accelerate_tpu_torch.commands.accelerate_cli import main

    main(["diagnose", str(diag_dir)])
    out = capsys.readouterr().out
    assert "1 flight dump(s)" in out
    assert "nan_grad=1" in out
    assert "Goodput:" in out


_CHILD = r"""
import os, signal, sys
for name in ("jax", "jaxlib", "flax", "optax", "accelerate_tpu"):
    sys.modules[name] = None  # the child runs the port alone
d = sys.argv[1]
from accelerate_tpu_torch.telemetry import StepTelemetry, TelemetryConfig
from accelerate_tpu_torch.diagnostics import DiagnosticsConfig

tel = StepTelemetry(TelemetryConfig(
    diagnostics=DiagnosticsConfig(dir=d, dump_interval_s=0.0),
    heartbeat_interval_s=0.01,
))
for i in range(6):
    tel.begin_step()
    tel.end_step(None, step=i)
tel.record_checkpoint(
    step=4, directory=os.path.join(d, "checkpoint_4"), mode="async",
    blocked_s=0.01, background_s=0.02, bytes_written=1024,
)
tel.begin_step()
tel.end_step(None, step=6)  # the periodic dump now carries the checkpoint
open(os.path.join(d, "READY"), "w").write("ok")
os.kill(os.getpid(), signal.SIGKILL)  # no handler runs: the periodic dump is what is left
"""


def test_sigkilled_run_leaves_dump_diagnose_names_it(tmp_path, capsys):
    d = str(tmp_path)
    proc = subprocess.run([sys.executable, "-c", _CHILD, d], cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO)), timeout=300)
    assert proc.returncode == -signal.SIGKILL
    assert os.path.exists(os.path.join(d, "READY"))
    dumps = list_dumps(d)
    assert 0 in dumps
    assert dumps[0]["last_step"] == 6
    assert dumps[0]["last_checkpoint"]["step"] == 4

    # a healthy second rank reported later progress; rank 0's heartbeat is
    # stale once it is older than the (short) stall timeout
    heartbeat = json.loads((tmp_path / "heartbeat-rank0.json").read_text())
    while time.time() - heartbeat["time_unix"] <= 1.0:
        time.sleep(0.05)
    _write_rank(d, 1, 50, heartbeat_age_s=0)
    report = _both_reports(d, stall_timeout_s=1.0)
    assert report["straggler"]["rank"] == 0
    assert report["last_checkpoint"]["step"] == 4
    assert "checkpoint_4" in report["last_checkpoint"]["dir"]

    from accelerate_tpu_torch.commands.accelerate_cli import main

    main(["diagnose", d, "--stall-timeout", "1.0"])
    out = capsys.readouterr().out
    assert "STRAGGLER: rank 0" in out
    assert "checkpoint_4" in out


# ---------------------------------------------------------------------- #
# parity: derived records, reports, a tiny model
# ---------------------------------------------------------------------- #
class FakeClock:
    """Both packages' ``time`` in the goodput, anomaly and flight-recorder
    modules: every reading comes from here."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def perf_counter(self):
        return self.now

    def time(self):
        return 1.7e9 + self.now


def _stream():
    """(seconds to advance, record, scalars) of a run that meets every
    rule: a steady baseline, compiles, checkpoints, a straggler, a loss
    spike, NaN and inf signals, a retraced step, a leaking census, SLO and
    soak breaches, and a dataloader stall."""
    out = []
    for i in range(12):
        out.append((0.1, _step_record(i, step_time_s=0.1, tokens=64), {"loss": 2.0 - 0.01 * i,
                                                                        "grad_norm": 1.0}))
    out.append((3.0, {"kind": "compile", "compile_time_s": 2.5}, None))
    out.append((1.0, {"kind": "checkpoint", "step": 11, "dir": "/ck/checkpoint_11",
                      "blocked_s": 0.7, "background_s": 0.0}, None))
    out.append((2.0, _step_record(12, step_time_s=2.0), {"loss": 1.88, "grad_norm": 1.0}))
    out.append((0.1, _step_record(13, step_time_s=0.1), {"loss": 60.0, "grad_norm": 1.0}))
    out.append((0.1, _step_record(14, step_time_s=0.1), {"loss": float("nan")}))
    out.append((0.1, _step_record(15, step_time_s=0.1), {"loss": 1.8, "grad_norm": float("inf")}))
    out.append((40.0, _step_record(16, step_time_s=0.1), {"loss": 1.8, "grads_finite": 0.0}))
    out.append((9.0, _step_record(17, step_time_s=9.0, retraced=True, compile_time_s=8.0),
                {"loss": 1.8}))
    for j in range(6):
        out.append((0.5, {"kind": "memory", "step": 17, "census_unowned_bytes": (j + 1) << 21},
                    None))
    out.append((0.1, {"kind": "slo", "breach": True, "max_burn_rate": 14.4,
                      "breached_objectives": ["ttft"]}, None))
    out.append((0.1, {"kind": "soak", "breach": True, "phase": "fault",
                      "goodput_tokens_per_s": 812.5}, None))
    out.append(("wait", 2.5, None))
    for i in range(18, 26):
        out.append((0.1, _step_record(i, step_time_s=0.1), {"loss": 1.7, "grad_norm": 1.0}))
    return out


def test_manager_derived_records_equal_the_reference(monkeypatch):
    clock = FakeClock()
    for mod in (jgoodput, janomaly, jflight, pgoodput, panomaly, pflight):
        monkeypatch.setattr(mod, "time", clock)
    cfg = dict(goodput_interval=4, anomaly_min_samples=4, anomaly_cooldown_steps=3,
               anomaly_cooldown_s=30.0, leak_min_samples=4, install_excepthook=False)
    managers = (DiagnosticsManager(DiagnosticsConfig(**cfg), process_index=0),
                jdiag.DiagnosticsManager(jdiag.DiagnosticsConfig(**cfg), process_index=0))
    derived = ([], [])
    for advance, record, scalars in _stream():
        if advance == "wait":
            for mgr in managers:
                mgr.record_wait(record, source="shard")
            continue
        clock.now += advance
        for out, mgr in zip(derived, managers):
            out.extend(mgr.observe(dict(record), scalars))
    kinds = [r["kind"] + ":" + str(r.get("anomaly_type", "")) for r in derived[0]]
    assert {"anomaly:slow_step", "anomaly:loss_spike", "anomaly:nan_grad",
            "anomaly:memory_leak", "anomaly:slo_breach", "anomaly:soak_breach",
            "goodput:"} <= set(kinds)
    # field for field, NaN included (json spells it the same on both sides)
    assert json.dumps(derived[0], sort_keys=True) == json.dumps(derived[1], sort_keys=True)
    clock.now += 1.0
    assert json.dumps(managers[0].summary(), sort_keys=True) == json.dumps(
        managers[1].summary(), sort_keys=True)
    assert [e["event"] for e in managers[0].recorder.events] == [
        e["event"] for e in managers[1].recorder.events]


def test_reports_on_a_port_written_dir_equal_the_reference(tmp_path):
    """The port writes the directory (flight dump with a NaN anomaly, a
    heartbeat, a committed checkpoint through the port's commit, a soak
    report through the port's loadgen writer); both packages read it."""
    d = tmp_path / "diag"
    final = tmp_path / "ckpt" / "checkpoint_3"
    work = pcommit.work_dir_for(str(final))
    os.makedirs(work)
    (Path(work) / "model.safetensors").write_bytes(b"x")
    pcommit.commit(work, str(final), topology={"world_size": 1, "num_devices": 1, "step": 3})
    tel = StepTelemetry(TelemetryConfig(diagnostics=DiagnosticsConfig(
        dir=str(d), goodput_interval=2, install_excepthook=False), heartbeat_interval_s=0.0))
    for i in range(4):
        tel.record_dataloader_wait(0.001)
        tel.begin_step()
        tel.end_step(None, step=i, metrics={"loss": float("nan") if i == 2 else 1.0})
    tel.record_checkpoint(step=3, directory=str(final), mode="sync", blocked_s=0.05,
                          background_s=0.0, bytes_written=1)
    write_report(str(d / "soak-report-rank0.json"), {
        "rank": 0, "seed": 0, "clock": "virtual", "interrupted": False,
        "headline": {"goodput_tokens_per_s_at_slo": 900.0, "ttft_objective_s": 0.5,
                     "soak_p95_ttft_s": 0.25, "slo_ok": True,
                     "capacity_rps_at_breach_point": 3.5},
        "phases": [{"phase": "warmup", "offered_rps": 1.0, "finished": 8,
                    "goodput_tokens_per_s": 500.0, "p95_ttft_s": 0.2, "shed": 0}],
        "fault": {"specs": ["stall_decode"], "sheds_in_window": 1, "recovery_s": 1.5},
    })
    tel.close()
    report = _both_reports(str(d))
    assert report["anomalies"] == {"nan_grad": 1}
    assert report["last_checkpoint"]["committed"] is True
    assert report["soak"] and report["goodput_pct"] is not None
    text = format_report(report)
    assert "[committed]" in text and "SOAK (rank 0" in text and "nan_grad=1" in text


BATCH = 8  # divisible by the reference's 8 virtual CPU devices
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=64)
SEQ = 16
TOL = 2e-5


def _run_tiny(pkg, tmp_path):
    """4 fp32 steps of the tiny CausalLM (sgd 0.1, clip 1.0) with
    ``diagnostics=`` in one package, then an injected NaN step record."""
    ids = np.random.default_rng(0).integers(0, MODEL["vocab_size"], (4 * BATCH, SEQ),
                                            dtype=np.int32)
    dataset = [{"input_ids": row} for row in ids]
    jmodel = JaxCausalLM(JaxConfig(**MODEL))
    init = jax.tree.map(np.asarray, nn.unbox(jmodel.init_params(jax.random.PRNGKey(0),
                                                                seq_len=SEQ)))
    diag = dict(dir=str(tmp_path / pkg), goodput_interval=2, install_excepthook=False)
    if pkg == "port":
        acc = port.Accelerator(cpu=True, diagnostics=DiagnosticsConfig(**diag))
        model = port.CausalLM(port.TransformerConfig(**MODEL), device="cpu")
        model.load_state_dict(port.params_from_jax(init, model.config), strict=True)
        model, opt, loader = acc.prepare(model, port.sgd(0.1),
                                         port.DataLoader(dataset, batch_size=BATCH))
        step = acc.unified_step(port.CausalLM.loss_fn(model), opt, max_grad_norm=1.0)
        carry = acc.init_carry(model, opt)
    else:
        acc = jax_pkg.Accelerator(diagnostics=jdiag.DiagnosticsConfig(**diag))
        params, opt, loader = acc.prepare(jax.tree.map(jnp.asarray, init), optax.sgd(0.1),
                                          jax_pkg.DataLoader(dataset, batch_size=BATCH))
        step = acc.unified_step(JaxCausalLM.loss_fn(jmodel), opt, max_grad_norm=1.0)
        carry = acc.init_carry(params, opt)
    for batch in loader:
        carry, _ = step(carry, batch)
    acc.telemetry.begin_step()
    acc.telemetry.end_step(None, step=98, metrics={"loss": float("nan")})
    records = [r for r in acc.telemetry.records if r["kind"] in ("step", "goodput", "anomaly")]
    acc.end_training()
    return records


def _hold(got: dict, want: dict, where: str):
    assert set(got) == set(want) - XLA_ONLY, where
    for key, value in got.items():
        if key in TIMES or key in MEMORY:
            continue
        if key == "record":
            _hold(value, want[key], f"{where}.record")
        elif key in ("loss", "grad_norm", "value") and isinstance(value, float):
            if math.isnan(value):
                assert math.isnan(want[key]), (where, key)
            else:
                np.testing.assert_allclose(value, want[key], rtol=TOL, err_msg=f"{where}.{key}")
        else:
            assert value == want[key], (where, key, value, want[key])


def test_tiny_causal_lm_records_equal_the_reference(tmp_path):
    got = _run_tiny("port", tmp_path)
    _reset()
    want = _run_tiny("jax", tmp_path)
    assert [r["kind"] for r in got] == [r["kind"] for r in want] == [
        "step", "step", "goodput", "step", "step", "goodput", "step", "anomaly"]
    for i, (g, w) in enumerate(zip(got, want)):
        _hold(g, w, f"{g['kind']}#{i}")
    dumps = list_dumps(str(tmp_path / "port"))
    assert dumps[0]["reason"] == "shutdown" and dumps[0]["last_step"] == 98
