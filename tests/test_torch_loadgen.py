"""The port's soak and chaos harness against the JAX reference, on the CPU.

Mirrors ``tests/test_loadgen.py`` without its diagnostics and anomaly
tests (``diagnostics/`` is ROADMAP.md queue A10) and with the adapter churn
test replaced by the skip the port records (no adapter registry, queue
A8):

* the trace: the same ``(workload, phases, seed)`` gives the reference's
  requests and ``trace_fingerprint``;
* the open-loop arrivals, the chaos grammar and handlers on a fake engine
  and clock, the report's atomic round trip and lag histogram, the
  ``soak`` records' Prometheus gauges (the reference's text);
* the end-to-end soak on the tiny model on the virtual clock (the
  reference marks its twin slow; this one runs in seconds);
* the virtual-clock chunked-prefill and preemption arms of
  ``chip_smoke.py``'s phase 12 (``soak_plan``/``soak_ab_arms``, the
  reference benchmark's ``measure.py:1319-1508``) at a tiny config, run
  through both packages: the reports agree phase for phase.
"""

import dataclasses
import importlib.util
import json
import pathlib
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import flax.linen as nn  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu.loadgen as jax_loadgen  # noqa: E402
import accelerate_tpu.serving as jax_serving  # noqa: E402
from accelerate_tpu.test_utils import fault_injection as jax_faults  # noqa: E402
from accelerate_tpu.models import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu_torch import CausalLM, TransformerConfig, params_from_jax  # noqa: E402
from accelerate_tpu_torch import loadgen, serving  # noqa: E402
from accelerate_tpu_torch.loadgen import (  # noqa: E402
    ChaosAdapter,
    Phase,
    SoakClock,
    SoakConfig,
    SoakHarness,
    WorkloadConfig,
    build_trace,
    lag_histogram,
    phase_bounds,
    read_report,
    standard_program,
    total_duration_s,
    trace_fingerprint,
    write_report,
)
from accelerate_tpu_torch.test_utils.fault_injection import (  # noqa: E402
    FAULT_ENV,
    SERVING_ACTIONS,
    FaultInjector,
    FaultSpec,
    render_specs,
)

REPO = pathlib.Path(__file__).resolve().parents[1]


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def tick(self, dt=1.0):
        self.t += dt

    def __call__(self):
        return self.t


class FakeEngine:
    """A duck-typed engine that completes ``tokens_per_step`` request
    tokens a step, optionally sleeping ``step_sleep_s`` of real time a step
    (the wedged engine of the wall-clock test)."""

    def __init__(self, tokens_per_step=4, step_sleep_s=0.0):
        self.tokens_per_step = tokens_per_step
        self.step_sleep_s = step_sleep_s
        self.active = []
        self.added = []
        self.steps = 0

    @property
    def has_work(self):
        return bool(self.active)

    def add_request(self, prompt, max_new_tokens=16, adapter=None, request_id=None):
        self.added.append(request_id)
        self.active.append([request_id, int(max_new_tokens)])
        return request_id

    def step(self):
        self.steps += 1
        if self.step_sleep_s:
            time.sleep(self.step_sleep_s)
        budget = self.tokens_per_step
        for row in list(self.active):
            if budget <= 0:
                break
            row[1] -= 1
            budget -= 1
            if row[1] <= 0:
                self.active.remove(row)


# --------------------------------------------------------------------- #
# workload and phases
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("kw", [
    dict(), dict(cohort_fraction=1.0, max_total_tokens=32),
    dict(long_prompt_fraction=0.1, long_prompt_tokens=40, adapters=("a", "b"),
         adapter_fraction=0.5),
])
def test_trace_and_fingerprint_equal_the_reference(kw):
    phases = standard_program(soak_s=2.0, fault_s=1.0, recovery_s=1.0)
    ref_phases = jax_loadgen.standard_program(soak_s=2.0, fault_s=1.0, recovery_s=1.0)
    got = build_trace(WorkloadConfig(**kw), phases, seed=3)
    want = jax_loadgen.build_trace(jax_loadgen.WorkloadConfig(**kw), ref_phases, seed=3)
    assert [tuple(vars(r).values()) for r in got] == [tuple(vars(r).values()) for r in want]
    assert trace_fingerprint(got) == jax_loadgen.trace_fingerprint(want)


def test_same_seed_identical_trace():
    wl = WorkloadConfig()
    phases = standard_program(soak_s=2.0, fault_s=0.0, recovery_s=0.0)
    a = build_trace(wl, phases, seed=3)
    assert a == build_trace(wl, phases, seed=3)
    assert trace_fingerprint(a) == trace_fingerprint(build_trace(wl, phases, seed=3))
    assert trace_fingerprint(a) != trace_fingerprint(build_trace(wl, phases, seed=4))


def test_arrivals_ordered_and_phase_bound():
    phases = standard_program()
    trace = build_trace(WorkloadConfig(), phases, seed=0)
    assert trace
    total = total_duration_s(phases)
    bounds = {p.name: (s, e) for p, s, e in phase_bounds(phases)}
    last = 0.0
    for req in trace:
        assert last <= req.arrival_s < total
        last = req.arrival_s
        start, end = bounds[req.phase]
        assert start <= req.arrival_s < end


def test_cohort_prefix_sharing():
    wl = WorkloadConfig(cohort_fraction=1.0)
    trace = build_trace(wl, (Phase("p", "soak", 4.0, 8.0),), seed=1)
    by_cohort = {}
    for req in trace:
        by_cohort.setdefault(req.cohort, []).append(req.prompt)
    shared = [prompts for prompts in by_cohort.values() if len(prompts) >= 2]
    assert shared
    for prompts in shared:
        assert all(p[:wl.prefix_tokens] == prompts[0][:wl.prefix_tokens] for p in prompts)


def test_token_budget_respected():
    trace = build_trace(WorkloadConfig(max_total_tokens=32), (Phase("p", "soak", 4.0, 16.0),),
                        seed=2)
    assert all(len(r.prompt) + r.max_new_tokens <= 32 for r in trace)


def test_phase_and_workload_validation():
    with pytest.raises(ValueError):
        Phase("x", "nope", 1.0, 1.0)
    with pytest.raises(ValueError):
        Phase("x", "soak", -1.0, 1.0)
    with pytest.raises(ValueError):
        Phase("x", "soak", 1.0, 1.0, process="bursty")
    with pytest.raises(ValueError, match="adapter names"):
        WorkloadConfig(adapter_fraction=0.5)
    with pytest.raises(ValueError, match="long_prompt_tokens"):
        WorkloadConfig(long_prompt_tokens=1, prompt_tokens_min=2)


# --------------------------------------------------------------------- #
# open-loop arrivals
# --------------------------------------------------------------------- #
def test_slow_engine_cannot_slow_arrivals():
    """An engine that barely finishes anything still gets every planned
    request submitted (offered == planned), which a closed loop would not
    do; the run stops at the drain grace."""
    wl = WorkloadConfig(output_tokens_min=64, output_tokens_median=64, output_tokens_max=64,
                        tail_alpha=8.0, max_total_tokens=None)
    phases = (Phase("burst", "soak", 1.0, 32.0, process="uniform"),)
    cfg = SoakConfig(workload=wl, phases=phases, seed=0, step_dt_s=0.01, drain_grace_s=0.5)
    report = SoakHarness(FakeEngine(tokens_per_step=1), cfg).run()
    planned = len(build_trace(wl, phases, 0))
    assert report["requests_planned"] == report["requests_submitted"] == planned
    assert report["requests_finished"] < planned
    assert report["stop_reason"] == "drain_timeout"


def test_wall_clock_stall_recorded_as_arrival_lag():
    wl = WorkloadConfig(output_tokens_min=2, output_tokens_median=2, output_tokens_max=4)
    phases = (Phase("burst", "soak", 0.25, 80.0, process="uniform"),)
    cfg = SoakConfig(workload=wl, phases=phases, seed=0, step_dt_s=None, drain_grace_s=5.0)
    report = SoakHarness(FakeEngine(tokens_per_step=64, step_sleep_s=0.05), cfg).run()
    assert report["clock"] == "wall"
    assert report["requests_submitted"] == report["requests_planned"]
    assert report["arrival_lag"]["max_s"] > 0.01
    assert report["trace_sha256"] == trace_fingerprint(build_trace(wl, phases, 0))


def test_mid_run_abort_still_writes_report(tmp_path):
    from accelerate_tpu_torch.serving import SLOConfig
    from accelerate_tpu_torch.serving.slo import SloTracker

    class DyingEngine(FakeEngine):
        def step(self):
            super().step()
            if self.steps >= 5:
                raise RuntimeError("boom")

    engine = DyingEngine()
    engine.slo_tracker = SloTracker(SLOConfig())

    class Stats:
        shed_counts = {"queue_full": 3}

    engine.stats = Stats()
    path = str(tmp_path / "soak-report.json")
    cfg = SoakConfig(workload=WorkloadConfig(), phases=(Phase("soak", "soak", 5.0, 16.0),),
                     seed=0, step_dt_s=0.01, report_path=path)
    with pytest.raises(RuntimeError, match="boom"):
        SoakHarness(engine, cfg).run()
    report = read_report(path)
    assert report["interrupted"] is True and report["slo_final"] is not None
    assert report["shed_totals"] == {"queue_full": 3} and report["phases"]


# --------------------------------------------------------------------- #
# fault grammar and chaos handlers
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("text", ["stall_decode@3:secs=2.5", "kill@7:rank=2:gen=1",
                                  "dcn_stall@4:slice=1:secs=3", "replica_slow@2:replica=1:secs=1",
                                  "transfer_drop@0:replica=0", "pool_pressure@1"])
def test_fault_spec_round_trip_equals_the_reference(text):
    spec = FaultSpec.parse(text)
    assert FaultSpec.parse(spec.render()) == spec
    assert spec.render() == jax_faults.FaultSpec.parse(text).render()
    assert render_specs([spec, spec]) == jax_faults.render_specs(
        [jax_faults.FaultSpec.parse(text)] * 2)


def test_bad_specs_rejected():
    with pytest.raises(ValueError, match="secs"):
        FaultSpec.parse("adapter_churn@1:secs=2")
    with pytest.raises(ValueError, match="secs"):
        FaultSpec.parse("kill@1:secs=2")
    with pytest.raises(ValueError, match="replica"):
        FaultSpec.parse("stall_decode@1:replica=2")
    with pytest.raises(ValueError, match="bad fault spec"):
        FaultSpec.parse("explode@1")


def test_from_env_and_unhandled_serving_action_is_inert(monkeypatch):
    assert FAULT_ENV == "ACCELERATE_TPU_FAULT_INJECT"
    monkeypatch.setenv(FAULT_ENV, "stall_decode@0:secs=1;pool_pressure@2")
    inj = FaultInjector.from_env(rank=0, generation=0)
    assert [s.action for s in inj.specs] == ["stall_decode", "pool_pressure"]
    inj.maybe_fire(0)  # no handler installed: nothing happens


def test_handler_dispatch_and_fatal_actions_refused():
    fired = []
    inj = FaultInjector([FaultSpec.parse("pool_pressure@2")], rank=0, generation=0)
    inj.install_handler("pool_pressure", fired.append)
    with pytest.raises(ValueError):
        inj.install_handler("kill", lambda spec: None)
    inj.maybe_fire(1)
    assert not fired
    inj.maybe_fire(2)
    inj.maybe_fire(2)  # once a spec
    assert [s.action for s in fired] == ["pool_pressure"]


def test_stall_and_pool_pressure_on_fake_clock():
    clock = FakeClock()
    engine = FakeEngine()
    engine.pool = serving.BlockPool(num_blocks=32, block_size=8)
    inj = FaultInjector([], rank=0, generation=0)
    chaos = ChaosAdapter(engine, inj, clock)
    assert set(inj._handlers) == set(SERVING_ACTIONS)
    chaos._on_stall_decode(FaultSpec.parse("stall_decode@0:secs=2"))
    assert chaos.stalled()
    clock.tick(2.5)
    assert not chaos.stalled()
    free_before = engine.pool.num_free
    chaos._on_pool_pressure(FaultSpec.parse("pool_pressure@0:secs=1"))
    assert engine.pool.num_free == free_before - free_before // 2
    chaos.poll()
    assert engine.pool.num_free < free_before
    clock.tick(1.0)
    chaos.poll()  # the pin's time is up
    assert engine.pool.num_free == free_before
    chaos.release()  # idempotent
    assert engine.pool.num_free == free_before
    assert [e["action"] for e in chaos.events] == ["stall_decode", "pool_pressure",
                                                   "pool_release"]


def test_registry_fleet_and_transfer_faults_skip_on_one_engine():
    """A single engine has no adapter registry, no replicas and no transfer
    plane: those faults record the reference's ``skipped`` events and do
    nothing, as the reference's ChaosAdapter does on such an engine."""
    clock = FakeClock()
    events = {}
    for pkg, chaos_cls, faults in (("port", ChaosAdapter, FaultSpec),
                                   ("reference", jax_loadgen.ChaosAdapter, jax_faults.FaultSpec)):
        injector = (FaultInjector if pkg == "port" else jax_faults.FaultInjector)(
            [], rank=0, generation=0)
        chaos = chaos_cls(FakeEngine(), injector, clock)
        for text in ("adapter_churn@0", "replica_kill@1:replica=0", "replica_slow@2:secs=1",
                     "transfer_stall@3", "transfer_drop@4", "pool_pressure@5"):
            spec = faults.parse(text)  # the fake engine has no pool either
            getattr(chaos, "_on_" + spec.action)(spec)
        events[pkg] = chaos.events
    assert events["port"] == events["reference"]
    assert [e.get("skipped") for e in events["port"]] == [
        "no_adapter_registry", "not_a_fleet", "not_a_fleet", "not_a_disagg_fleet",
        "not_a_disagg_fleet", "no_pool"]


def test_slo_tracker_single_pass_matches_brute_force():
    from accelerate_tpu_torch.serving import SLOConfig
    from accelerate_tpu_torch.serving.slo import SloTracker

    cfg = SLOConfig(ttft_objective_s=0.1, e2e_objective_s=1.0, target=0.9, fast_window_s=5.0,
                    slow_window_s=20.0, min_requests=1)
    tracker = SloTracker(cfg)
    rng = np.random.default_rng(0)
    t, events = 0.0, []
    for _ in range(400):
        t += float(rng.exponential(0.2))
        events.append((t, float(rng.exponential(0.1)), float(rng.exponential(0.8))))
        tracker.observe(*events[-1])
    snap = tracker.snapshot(t)
    for span, key in ((cfg.fast_window_s, "fast"), (cfg.slow_window_s, "slow")):
        window = [e for e in events if e[0] >= t - span]
        assert snap[f"requests_{key}_window"] == len(window)
        for obj, bound, idx in (("ttft", 0.1, 1), ("e2e", 1.0, 2)):
            errors = sum(1 for e in window if e[idx] > bound)
            assert snap[f"{obj}_burn_{key}"] == pytest.approx(
                (errors / len(window)) / (1.0 - cfg.target))


# --------------------------------------------------------------------- #
# report plumbing
# --------------------------------------------------------------------- #
def test_atomic_roundtrip(tmp_path):
    path = str(tmp_path / "sub" / "soak-report.json")
    write_report(path, {"version": 1, "rank": 0, "x": (1, 2), "n": np.int64(3)})
    assert read_report(path) == {"version": 1, "rank": 0, "x": [1, 2], "n": 3}
    assert read_report(str(tmp_path / "missing.json")) is None
    bad = tmp_path / "bad.json"
    bad.write_text("{nope")
    assert read_report(str(bad)) is None


def test_lag_histogram_buckets_equal_the_reference():
    lags = [0.0005, 0.005, 0.5, 20.0, -1.0, 0.05]
    h = lag_histogram(lags)
    assert h == jax_loadgen.lag_histogram(lags)
    assert h["count"] == 6 and h["max_s"] == 20.0
    assert h["histogram"]["le_0.001s"] == 2 and h["histogram"]["gt_10s"] == 1
    assert lag_histogram([])["count"] == 0


def test_record_soak_prometheus_gauges_equal_the_reference():
    from accelerate_tpu.telemetry import PrometheusTextSink as JaxSink
    from accelerate_tpu.telemetry import StepTelemetry as JaxTelemetry
    from accelerate_tpu_torch.telemetry import PrometheusTextSink, StepTelemetry

    texts = []
    for tel_cls, sink_cls in ((JaxTelemetry, JaxSink), (StepTelemetry, PrometheusTextSink)):
        tel = tel_cls(True)
        sink = tel.add_sink(sink_cls(path=None))
        rec = tel.record_soak(phase="soak", phase_kind="soak", offered_rps=8.0,
                              achieved_rps=7.5, goodput_tokens_per_s=120.0,
                              arrival_lag_p95_s=0.01, shed=2, slo_violations=1, breach=False)
        assert rec["kind"] == "soak" and rec["label"] == "soak"
        texts.append(sink.render())
        tel.close()
    assert texts[1] == texts[0]
    for name in ("goodput_tokens_per_s", "offered_rps", "shed"):
        assert f"accelerate_tpu_loadgen_{name}" in texts[1]


# --------------------------------------------------------------------- #
# the harness on the tiny model
# --------------------------------------------------------------------- #
@pytest.fixture
def one_torch_thread():
    """The soak tests run thousands of engine steps of a tiny model, whose
    ops are too small to split; under a loaded host, intra-op threads only
    wait on each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = JaxConfig.tiny(max_seq_len=128)
    model = JaxCausalLM(cfg)
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    port_cfg = TransformerConfig.tiny(max_seq_len=128)
    port = CausalLM(port_cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, port_cfg), strict=True)
    return cfg, model, params, port


def test_soak_smoke_end_to_end(tiny_pair, tmp_path, one_torch_thread):
    """The reference's end-to-end soak (``tests/test_loadgen.py``'s slow
    twin) on the port: a seeded ramp -> soak -> fault -> recovery program
    against the engine on the virtual clock writes a report with a measured
    breach point, a stall that fired and was recovered from, every request
    accounted for, no decode rebuild, and bounded rings."""
    from accelerate_tpu_torch.serving import SLOConfig
    from accelerate_tpu_torch.telemetry import StepTelemetry

    cfg, port = tiny_pair[0], tiny_pair[3]
    clock = SoakClock()
    tel = StepTelemetry(True)
    engine = serving.ServingEngine(port, max_slots=2, block_size=8, now=clock,
                                   max_retained_results=64)
    wl = WorkloadConfig(vocab_size=cfg.vocab_size, prompt_tokens_min=2, prompt_tokens_median=4,
                        prompt_tokens_max=16, output_tokens_min=2, output_tokens_median=4,
                        output_tokens_max=12, max_total_tokens=48)
    phases = standard_program(warmup_s=0.5, warmup_rps=4.0, ramp_rates=(8.0, 16.0, 32.0, 64.0),
                              ramp_step_s=0.5, soak_s=1.0, soak_rps=12.0, fault_s=0.5,
                              recovery_s=1.0)
    slo = SLOConfig(ttft_objective_s=0.05, e2e_objective_s=0.5, target=0.9, fast_window_s=0.1,
                    slow_window_s=0.25, burn_threshold=1.0, interval_steps=4, min_requests=3)
    report_path = str(tmp_path / "soak-report.json")
    soak_cfg = SoakConfig(workload=wl, phases=phases, seed=7, step_dt_s=0.01, slo=slo,
                          fault_specs="stall_decode@0:secs=0.2", report_path=report_path,
                          drain_grace_s=10.0)
    report = SoakHarness(engine, soak_cfg, clock=clock, telemetry=tel).run()
    tel.close()
    assert read_report(report_path)["trace_sha256"] == report["trace_sha256"]
    assert report["requests_submitted"] == report["requests_planned"] > 0
    assert report["requests_finished"] + report["requests_shed"] == report["requests_submitted"]
    assert not report["interrupted"]
    head = report["headline"]
    assert head["goodput_tokens_per_s_at_slo"] > 0 and head["soak_p95_ttft_s"] is not None
    assert not head["capacity_saturated"] and 0 < head["capacity_rps_at_breach_point"] < 64.0
    fault = report["fault"]
    assert fault["events"][0]["action"] == "stall_decode"
    assert fault["recovered"] and 0.0 <= fault["recovery_s"] < 1.0
    assert report["phases"][-1]["kind"] == "recovery" and not report["phases"][-1]["breached"]
    assert report["decode_retraces"] == 0
    assert len(engine.span_log.closed) <= engine.span_log.closed.maxlen
    assert len(engine.stats.requests) <= engine.stats.requests.maxlen
    assert len(engine._results) <= 64
    assert len(engine.slo_tracker._events) < report["requests_finished"]
    assert trace_fingerprint(build_trace(wl, phases, 7)) == report["trace_sha256"]
    kinds = {r["kind"] for r in tel.records}
    assert {"soak", "serve", "serve_gauge", "slo"} <= kinds
    assert [r["phase"] for r in tel.records if r["kind"] == "soak"][-1] == "final"


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _comparable(report: dict) -> dict:
    """A report without its wall time stamp and with the build counts the
    two engines both keep."""
    out = {k: v for k, v in report.items() if k not in ("time_unix", "trace_counts")}
    out["decode_builds"] = report["trace_counts"]["decode"]
    return json.loads(json.dumps(out, default=str))


def _quarter(phases):
    return tuple(dataclasses.replace(p, duration_s=p.duration_s / 4) for p in phases)


def test_virtual_clock_arms_match_the_reference(tiny_pair, one_torch_thread):
    """``chip_smoke.py``'s chunked and preemption A/B arms (the reference
    benchmark's ``measure.py:1319-1508``) at a tiny config (max_seq_len
    128, 4 slots, blocks of 8: giants of 80 tokens in chunks of 32, a
    26-block burst pool, a 9-block pressure pool), every phase and the
    pressure fault a quarter of their length (the reference's engine steps
    are the test's cost), through both packages.
    Scheduling is host arithmetic on the virtual clock and greedy tokens
    match, so the reports agree phase for phase: requests planned,
    finished and shed, sheds and preemptions in the fault window, soak
    p95 TTFT; and so do the engines' preemption, resume and chunk counts
    and every request's tokens."""
    cfg, model, params, port = tiny_pair
    cs = _chip_smoke()
    runs = {}
    for name, pkg, make in (
            ("reference", jax_loadgen, lambda clock, **kw: jax_serving.ServingEngine(
                model, params, max_slots=4, block_size=8, now=clock, **kw)),
            ("port", loadgen, lambda clock, **kw: serving.ServingEngine(
                port, max_slots=4, block_size=8, now=clock, **kw))):
        plan = cs.soak_plan(pkg, cfg, max_slots=4, block_size=8, seed=0)
        plan.update(burst_phases=_quarter(plan["burst_phases"]),
                    pressure_phases=_quarter(plan["pressure_phases"]),
                    pressure_fault="pool_pressure@0:secs=0.3")
        runs[name] = cs.soak_ab_arms(pkg, make, plan)
    assert plan["chunk_budget"] == 32 and plan["long_tokens"] == 80
    assert (plan["ab_blocks"], plan["pressure_blocks"]) == (26, 9)
    for arm in ("chunked-off", "chunked-on", "preempt-off", "preempt-on"):
        (ref_rep, ref_eng), (rep, eng) = runs["reference"][arm], runs["port"][arm]
        assert _comparable(rep) == _comparable(ref_rep), arm
        assert (eng._preempt_counts, eng._resumes_total, eng._prefill_chunks_total) == (
            ref_eng._preempt_counts, ref_eng._resumes_total, ref_eng._prefill_chunks_total)
        ids = [r["request_id"] for r in ref_eng.stats.requests]
        assert [eng.result(r) for r in ids] == [ref_eng.result(r) for r in ids], arm
        assert rep["decode_retraces"] == 0 and eng.pool.stats()["allocated"] == 0
    port_runs = runs["port"]
    assert port_runs["chunked-on"][1]._prefill_chunks_total > 0
    assert sum(port_runs["preempt-on"][1]._preempt_counts.values()) > 0
