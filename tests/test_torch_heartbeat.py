"""The port's heartbeat watchdog against the JAX reference's, on the CPU.

The three heartbeat cases of ``tests/test_telemetry.py`` (a stall flagged
and recovered, the monitor through ``TelemetryConfig`` and its close, old
files read as stale) run on the port; the heartbeat files and
``partition_liveness`` are held against the reference's; a stall reaches
diagnostics' flight recorder through the collector; the watchdog holds
only a weak reference to its monitor; and ``CheckpointManager`` takes the
telemetry's monitor and names the committed checkpoint in its preemption
dump. ``summary()`` counts checkpoints and stalls as the reference's does
(its checkpoint fields were once missing: ROADMAP.md, queue C). Stalls are
waited for on events, with timeouts far beyond the stall timeout; no case
bounds the host's time.
"""

import json
import os
import signal
import threading
import time
import weakref

import pytest
import torch

jax = pytest.importorskip("jax")
from accelerate_tpu.telemetry import StepTelemetry as JaxTelemetry  # noqa: E402
from accelerate_tpu.telemetry import TelemetryConfig as JaxConfig  # noqa: E402
from accelerate_tpu.telemetry import heartbeat as jheartbeat  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.diagnostics import DiagnosticsConfig, list_dumps  # noqa: E402
from accelerate_tpu_torch.telemetry import (  # noqa: E402
    HeartbeatMonitor,
    StepTelemetry,
    TelemetryConfig,
    partition_liveness,
    scan_heartbeats,
)

WAIT_S = 10.0  # the longest any case waits for a watchdog's verdict


@pytest.fixture(autouse=True)
def reset_port_singletons():
    yield
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()


def _wait_for(predicate, timeout=WAIT_S):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def test_heartbeat_flags_stall_and_recovery(tmp_path):
    hb_dir = tmp_path / "hb"
    stalled = threading.Event()
    mon = HeartbeatMonitor(dir=str(hb_dir), interval_s=0.01, stall_timeout_s=0.3,
                           on_stall=lambda m: stalled.set()).start()
    try:
        mon.beat(1)
        assert mon.stalled is False
        assert stalled.wait(WAIT_S)  # silence > stall_timeout_s
        assert mon.stalled is True and mon.stalls == 1
        # the file is written before the callback runs
        ranks = scan_heartbeats(str(hb_dir), stall_timeout_s=60.0)
        assert ranks[0]["stale"] is True  # self-flagged even though fresh
        assert ranks[0]["step"] == 1
        mon.beat(2)  # recovery clears the flag
        assert mon.stalled is False
        assert mon.stalls == 1
        ranks = scan_heartbeats(str(hb_dir), stall_timeout_s=60.0)
        assert ranks[0]["stale"] is False
        assert ranks[0]["step"] == 2
    finally:
        mon.stop()


def test_heartbeat_via_config_and_close(tmp_path):
    tel = StepTelemetry(TelemetryConfig(heartbeat_dir=str(tmp_path / "hb"),
                                        heartbeat_interval_s=0.01,
                                        heartbeat_stall_timeout_s=30.0))
    assert tel.config.heartbeat is True  # a dir implies the watchdog
    assert tel.heartbeat is not None
    tel.begin_step()
    tel.end_step(torch.ones(()), step=7)
    assert tel.heartbeat.last_step == 7
    thread = tel.heartbeat._thread
    tel.close()
    assert tel.heartbeat._thread is None and not thread.is_alive()  # watchdog joined
    assert tel.summary()["stalls"] == 0


def test_scan_heartbeats_marks_old_files_stale(tmp_path):
    (tmp_path / "heartbeat-rank3.json").write_text(json.dumps(
        {"process_index": 3, "pid": 1, "step": 40, "time_unix": time.time() - 1000,
         "stalled": False}))
    ranks = scan_heartbeats(str(tmp_path), stall_timeout_s=300.0)
    assert ranks[3]["stale"] is True
    assert ranks[3]["age_s"] > 999


def test_heartbeat_file_and_liveness_equal_the_reference(tmp_path, monkeypatch):
    """Both packages' monitors stamp the same fields (the elastic generation
    and the fault domain from the ``ACCELERATE_TPU_*`` environment), and
    ``partition_liveness`` splits one directory the same way."""
    monkeypatch.setenv("ACCELERATE_TPU_ELASTIC_GENERATION", "4")
    monkeypatch.setenv("ACCELERATE_TPU_FAULT_DOMAIN", "1")
    files = {}
    for name, cls in (("port", HeartbeatMonitor), ("jax", jheartbeat.HeartbeatMonitor)):
        d = tmp_path / name
        mon = cls(dir=str(d), interval_s=0.0, stall_timeout_s=60.0, process_index=0)
        mon.beat(5)
        files[name] = json.loads((d / "heartbeat-rank0.json").read_text())
    for f in files.values():
        f.pop("time_unix")
    assert files["port"] == files["jax"]
    assert files["port"]["generation"] == 4 and files["port"]["fault_domain"] == 1

    d = tmp_path / "fleet"
    d.mkdir()
    now = time.time()
    for rank, age, gen, stalled in ((0, 1, 4, False), (1, 900, 4, False), (2, 1, 3, False),
                                    (3, 1, 4, True)):
        (d / f"heartbeat-rank{rank}.json").write_text(json.dumps(
            {"process_index": rank, "pid": rank, "step": 10, "time_unix": now - age,
             "stalled": stalled, "generation": gen}))
    for kw in ({}, {"generation": 4}, {"generation": 4, "world": 6}):
        assert partition_liveness(str(d), 300.0, **kw) == jheartbeat.partition_liveness(
            str(d), 300.0, **kw)
    assert partition_liveness(str(d), 300.0, generation=4, world=6) == ({0}, {1, 3, 2, 4, 5})


def test_collector_stall_reaches_the_flight_recorder(tmp_path):
    """A heartbeat stall goes to diagnostics' ``on_stall``: an event and an
    immediate dump naming the last step."""
    d = tmp_path / "diag"
    tel = StepTelemetry(TelemetryConfig(
        heartbeat_interval_s=0.01, heartbeat_stall_timeout_s=0.3,
        diagnostics=DiagnosticsConfig(dir=str(d), install_excepthook=False)))
    assert tel.config.heartbeat_dir == str(d)  # one dir for both
    tel.begin_step()
    tel.end_step(None, step=3)
    try:
        assert _wait_for(lambda: tel.heartbeat.stalls == 1)
        assert _wait_for(lambda: list_dumps(str(d)).get(0, {}).get("reason")
                         == "heartbeat_stall")
        event = list_dumps(str(d))[0]["events"][-1]
        assert event["event"] == "heartbeat_stall" and event["last_step"] == 3
        assert event["stall_timeout_s"] == 0.3
    finally:
        tel.close()
    assert list_dumps(str(d))[0]["reason"] == "shutdown"


def test_abandoned_monitor_thread_exits():
    """The watchdog holds its monitor weakly: dropping the last reference
    ends the thread."""
    mon = HeartbeatMonitor(interval_s=0.01, stall_timeout_s=0.05).start()
    thread, ref = mon._thread, weakref.ref(mon)
    del mon
    assert _wait_for(lambda: ref() is None and not thread.is_alive())


def test_checkpoint_manager_takes_the_monitor_and_dumps_on_preemption(tmp_path):
    """``heartbeat=None`` takes the telemetry's monitor; a preemption writes
    the final checkpoint, then the ``"preemption"`` dump, which names that
    committed checkpoint."""
    d = tmp_path / "diag"
    acc = port.Accelerator(cpu=True, diagnostics=DiagnosticsConfig(
        dir=str(d), install_excepthook=False), project_config=port.ProjectConfiguration(
            project_dir=str(tmp_path / "run"), automatic_checkpoint_naming=True))

    def loss_fn(params, batch):
        return torch.mean((batch["x"] * params["w"]) ** 2)

    opt = acc.prepare(port.sgd(0.1))
    step = acc.unified_step(loss_fn, opt)
    carry = acc.init_carry({"w": torch.tensor(1.0)}, opt)
    mgr = port.CheckpointManager(acc, every_n_steps=100, handle_signals=False)
    try:
        assert mgr.heartbeat is acc.telemetry.heartbeat is not None
        for i in range(3):
            carry, _ = step(carry, {"x": torch.full((4,), float(i))})
            assert mgr.step(carry) is None
        mgr._on_preemption(signal.SIGTERM, None)  # what the handler does
        carry, _ = step(carry, {"x": torch.ones(4)})
        final = mgr.step(carry)
        assert mgr.should_stop and port.checkpointing._list_checkpoints(
            str(tmp_path / "run" / "checkpoints"))[-1] == final
        dump = list_dumps(str(d))[0]
        assert dump["reason"] == "preemption"
        assert dump["last_checkpoint"]["dir"] == final
        assert dump["last_checkpoint"]["step"] == acc.step == 4
        assert mgr.heartbeat.last_step == 4
    finally:
        mgr.close()
        acc.end_training()
    assert os.path.isdir(final)


def test_summary_counts_checkpoints_as_the_reference(tmp_path):
    """The summary's checkpoint and stall fields equal the reference's over
    the same records (the checkpoint fields were missing: queue C)."""
    summaries = []
    for tel in (StepTelemetry(TelemetryConfig(heartbeat=True)),
                JaxTelemetry(JaxConfig(heartbeat=True))):
        for step, (blocked, background) in enumerate(((0.25, 0.0), (0.125, 1.5))):
            tel.record_checkpoint(step=step, directory=str(tmp_path / f"checkpoint_{step}"),
                                  mode="async", blocked_s=blocked, background_s=background,
                                  bytes_written=1024)
        summary = tel.summary()
        tel.close()
        summaries.append({k: summary.get(k) for k in (
            "steps", "recompiles", "dataloader_wait_total_s", "checkpoints",
            "checkpoint_blocked_total_s", "checkpoint_background_total_s", "stalls")})
    assert summaries[0] == summaries[1]
    assert summaries[0]["checkpoints"] == 2 and summaries[0]["checkpoint_blocked_total_s"] == 0.375
