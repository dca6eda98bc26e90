"""The port's profiling tools against the JAX reference's, on the CPU.

The cases of ``tests/test_profiling.py:26-113`` run on the port
(``start_measure``/``end_measure``, host RSS, ``PeakHostMemory``,
``device_memory_stats``, ``StepTimer``, ``profile`` and
``Accelerator.profile``, here with a real ``torch.profiler`` session on the
CPU); the trace readers of ``compilation/overlap.py`` are held against the
reference's interval math and self-time walk on the same events, and run on
a trace the profiler wrote; and a triggered capture is refused while
``Accelerator.profile`` records, then runs and puts ``top_ops`` on the next
step record. No case bounds the host's time.
"""

import glob
import json
import logging
import os

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from accelerate_tpu.compilation import overlap as joverlap  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.compilation import overlap  # noqa: E402
from accelerate_tpu_torch.diagnostics import DiagnosticsConfig, TraceCapture  # noqa: E402
from accelerate_tpu_torch.telemetry import StepTelemetry, TelemetryConfig  # noqa: E402
from accelerate_tpu_torch.utils.profiling import (  # noqa: E402
    PeakHostMemory,
    ProfileKwargs,
    StepTimer,
    annotate,
    device_memory_stats,
    end_measure,
    host_memory_rss,
    profile,
    start_measure,
)


@pytest.fixture(autouse=True)
def reset_port_singletons():
    yield
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()


def _traces(target):
    return glob.glob(os.path.join(target, "**", "*.pt.trace.json"), recursive=True)


def _names(path):
    return {e.get("name") for e in overlap.trace_events(path)}


def test_measure_roundtrip():
    start = start_measure()
    x = torch.ones(256, 256) @ torch.ones(256, 256)
    out = end_measure(start)
    assert float(x[0, 0]) == 256.0
    assert out["time"] > 0
    assert "host" in out and "host-peak" in out
    # one device:{i} pair per CUDA device; the CPU has no allocator to read
    cuda = torch.cuda.device_count() if torch.cuda.is_available() else 0
    assert {k for k in out if k.startswith("device")} == {
        f"device:{i}{s}" for i in range(cuda) for s in ("", "-peak")}


def test_host_memory_rss_positive():
    assert host_memory_rss() > 1 << 20


def test_peak_host_memory_monitor():
    tracker = PeakHostMemory()
    tracker.start()
    blob = np.ones((4 << 20,), np.uint8)
    peak = tracker.stop()
    assert peak >= host_memory_rss() - (64 << 20)
    del blob


def test_device_memory_stats_shape():
    stats = device_memory_stats()
    assert set(stats) == {"bytes_in_use", "peak_bytes_in_use", "bytes_limit"}
    # an explicit device that gives no numbers reads zeros
    assert device_memory_stats("cpu") == {"bytes_in_use": 0, "peak_bytes_in_use": 0,
                                          "bytes_limit": 0}


def test_step_timer_skips_compile():
    timer = StepTimer(skip=1)
    with timer:
        for i in range(4):
            y = torch.sin(torch.ones(64) * i).sum()
            timer.tick(y)
    s = timer.summary()
    assert s["steps"] == 3
    assert s["mean_s"] >= 0 and s["p90_s"] >= s["median_s"] >= 0
    assert s["min_s"] <= s["median_s"] and s["total_s"] >= s["mean_s"]


def test_profile_noop_without_dir():
    with profile() as p:
        assert p is None


def test_profile_writes_trace(tmp_path):
    target = str(tmp_path / "trace")
    with profile(target) as p:
        assert p.dir == target
        with annotate("matmul-region"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    found = _traces(target)
    assert found == [p.trace_path], os.listdir(target)
    names = _names(found[0])
    assert "matmul-region" in names and "aten::mm" in names


def test_profile_skip_first_defers_start(tmp_path):
    target = str(tmp_path / "trace")
    kw = ProfileKwargs(output_trace_dir=target, skip_first=2)
    with profile(kwargs=kw) as p:
        assert not p._started
        p.step()
        assert not p._started
        p.step()  # the skip_first-th step: the trace starts here
        assert p._started and torch.autograd._profiler_enabled()
        torch.ones(32, 32) @ torch.ones(32, 32)
        p.step()
    assert not torch.autograd._profiler_enabled()
    found = _traces(target)
    assert found and "aten::mm" in _names(found[0])


def test_profile_user_error_propagates(tmp_path):
    with pytest.raises(TypeError, match="user bug"):
        with profile(str(tmp_path / "t")):
            raise TypeError("user bug")
    assert not torch.autograd._profiler_enabled()  # the session was stopped


def test_accelerator_profile_context(tmp_path):
    acc = port.Accelerator(cpu=True, profile_kwargs=ProfileKwargs(
        output_trace_dir=str(tmp_path / "t")))
    with acc.profile() as p:
        torch.ones(32, 32) @ torch.ones(32, 32)
    assert p.dir == str(tmp_path / "t")
    assert os.path.isdir(p.dir) and _traces(p.dir)


def test_accelerator_profile_noop_default():
    acc = port.Accelerator(cpu=True)
    with acc.profile() as p:
        assert p is None


def test_profile_kwargs_map_to_the_profiler():
    from accelerate_tpu_torch.utils.profiling import _profiler_kwargs

    got = _profiler_kwargs(ProfileKwargs(host_tracer_level=3, python_tracer_level=1))
    assert torch.profiler.ProfilerActivity.CPU in got["activities"]
    assert got["record_shapes"] and got["with_stack"]
    got = _profiler_kwargs(ProfileKwargs(host_tracer_level=0))
    assert not got["record_shapes"] and not got["with_stack"]
    # without CUDA the CPU activity stays, whatever the level
    assert got["activities"] == ([torch.profiler.ProfilerActivity.CUDA]
                                 if torch.cuda.is_available()
                                 else [torch.profiler.ProfilerActivity.CPU])


# ---------------------------------------------------------------------- #
# trace readers
# ---------------------------------------------------------------------- #
def _synthetic(seed):
    """The same nested events as a reference device plane and as Chrome
    trace events (microseconds = picoseconds / 1e6)."""
    rng = np.random.default_rng(seed)
    names = ["fusion", "dot", "all-reduce-start", "all-reduce-done", "copy", "ncclKernel_x"]
    plane = {"name": "/device:TPU:0", "lines": [], "event_names": dict(enumerate(names))}
    chrome = []
    for line in range(2):
        events, t = [], 0
        for _ in range(12):
            t += int(rng.integers(0, 5)) * 1_000_000
            dur = int(rng.integers(1, 20)) * 1_000_000
            meta = int(rng.integers(0, len(names)))
            events.append((meta, t, dur))
            if rng.random() < 0.5:  # a child inside it
                cdur = max(1_000_000, dur // 2)
                events.append((int(rng.integers(0, len(names))), t + (dur - cdur) // 2, cdur))
            t += dur // 2
        plane["lines"].append({"name": str(line), "timestamp_ns": 0, "events": events})
        chrome += [{"ph": "X", "cat": "kernel", "pid": 0, "tid": line, "name": names[m],
                    "ts": off / 1e6, "dur": dur / 1e6} for m, off, dur in events]
    return plane, chrome


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_self_times_equal_the_reference_walk(seed):
    plane, chrome = _synthetic(seed)
    want = joverlap.self_times_from_plane(plane)
    got = overlap.self_times(chrome)
    assert set(got) == set(want)
    for name, (ps, n) in want.items():
        assert got[name][1] == n
        assert got[name][0] == pytest.approx(ps / 1e6, abs=1e-9)
    # and the spans' overlap, through the same interval math (classified by
    # the reference's rule, which knows no NCCL kernel names)
    spans = [dict(s, kind="collective" if joverlap.is_collective_event(s["name"]) else "compute")
             for s in joverlap.spans_from_plane(plane)]
    mine = overlap.overlap_from_spans([dict(s, start=s["start"] / 1e6, end=s["end"] / 1e6)
                                       for s in spans])
    ref = joverlap.overlap_from_spans(spans)
    assert (mine is None) == (ref is None)
    if ref is not None:
        assert mine["overlap_pct"] == pytest.approx(ref["overlap_pct"])


def test_collective_names_include_nccl_kernels():
    assert overlap.is_collective_event("ncclDevKernel_AllReduce_Sum_f32_RING_LL")
    assert overlap.is_collective_event("all-gather-start")
    assert not overlap.is_collective_event("flash_fwd_kernel")
    assert not overlap.is_collective_event("nvjet_tst_128x256_64x4_2x1_v_bz_TNN")


def test_overlap_reads_a_trace_with_a_collective(tmp_path):
    events = [
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 7, "name": "flash_fwd_kernel",
         "ts": 0.0, "dur": 10.0},
        {"ph": "X", "cat": "kernel", "pid": 0, "tid": 9,
         "name": "ncclDevKernel_AllReduce_Sum_f32_RING_LL", "ts": 5.0, "dur": 10.0},
        {"ph": "X", "cat": "cpu_op", "pid": 1, "tid": 1, "name": "aten::mm", "ts": 0.0,
         "dur": 50.0},
    ]
    (tmp_path / "a.pt.trace.json").write_text(json.dumps({"traceEvents": events}))
    report = overlap.collective_compute_overlap(str(tmp_path))
    assert report["overlap_pct"] == pytest.approx(50.0) and report["devices"] == 1
    top = overlap.top_self_time_ops(str(tmp_path), k=5)
    assert [o["op"] for o in top] == ["flash_fwd_kernel", "ncclDevKernel_AllReduce_Sum_f32_RING_LL"]
    assert top[0] == {"op": "flash_fwd_kernel", "self_time_ms": 0.01, "count": 1}


def test_top_self_time_ops_reads_a_cpu_trace(tmp_path):
    """On a trace with no device work the host operators rank, each by its
    self time (a caller less its callees); no collective on the CPU."""
    target = str(tmp_path / "t")
    with profile(target):
        a = torch.ones(128, 128)
        for _ in range(3):
            a = torch.nn.functional.linear(a, torch.ones(128, 128)) / 128.0
    top = overlap.top_self_time_ops(target, k=50)
    assert top and all(o["self_time_ms"] > 0 and o["count"] >= 1 for o in top)
    assert [o["self_time_ms"] for o in top] == sorted((o["self_time_ms"] for o in top),
                                                      reverse=True)
    ops = {o["op"]: o for o in top}
    assert ops["aten::linear"]["count"] == 3
    assert overlap.collective_compute_overlap(target) is None
    assert overlap.top_self_time_ops(str(tmp_path / "nothing")) is None


def test_capture_refused_while_accelerator_profile_records(tmp_path, caplog):
    """One profiler session at a time: a capture asked for while
    ``Accelerator.profile`` records fails to start and is logged, never
    raised; once the profile ends, a capture runs, writes its trace, and
    the next step record carries its ``top_ops``."""
    acc = port.Accelerator(cpu=True)
    cap = TraceCapture(DiagnosticsConfig(trace_dir=str(tmp_path / "traces"), capture_steps=1))
    with caplog.at_level(logging.WARNING):
        with acc.profile(str(tmp_path / "profile")):
            assert cap.request("sigusr1")
            assert cap.on_step(0) is None and cap.captures == []
    assert "failed to start" in caplog.text

    tel = StepTelemetry(TelemetryConfig(diagnostics=DiagnosticsConfig(
        trace_dir=str(tmp_path / "traces"), capture_steps=1, goodput=False)))
    assert tel.diagnostics.capture.request("operator")
    for i in range(3):
        tel.begin_step()
        torch.ones(64, 64) @ torch.ones(64, 64)
        rec = tel.end_step(None, step=i)
    assert rec["top_ops"] and rec["top_ops_capture_dir"].endswith("capture00_operator")
    assert _traces(rec["top_ops_capture_dir"])
    assert not torch.autograd._profiler_enabled()
    tel.close()
