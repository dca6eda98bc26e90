"""The serving observability plane in the port against the JAX reference,
on the CPU.

Mirrors ``tests/test_serving_obs.py`` for the parts ported:

* ``SLOConfig`` and ``SloTracker`` under a fake clock: each of the
  reference's scenarios, and a seeded random stream, give snapshots equal
  to the reference's after every observation;
* the sinks: ``PrometheusTextSink`` renders the reference's text for the
  same serving records, ``path=None`` writes nothing, ``JSONLSink`` keeps
  every record; ``StepTelemetry``'s emit path (meta first, disabled
  no-ops, a failing sink rate-limited), ``sample_memory`` on the CPU, and
  the training hooks refused naming A10;
* the engine's wiring on the reference's tiny model with a fake clock:
  ``serve``, ``span``, ``serve_gauge``, ``shed`` and ``slo`` records equal
  to the reference's (``time_unix`` aside), and ``set_observability`` on a
  warm engine emitting them, changing no token and building nothing.
"""

import json
import random

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import flax.linen as nn  # noqa: E402

import accelerate_tpu.serving as jax_serving  # noqa: E402
import accelerate_tpu.telemetry as jax_telemetry  # noqa: E402
from accelerate_tpu.models import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu_torch import CausalLM, TransformerConfig, params_from_jax  # noqa: E402
from accelerate_tpu_torch import serving, telemetry  # noqa: E402

PACKAGES = {"port": (serving, telemetry), "reference": (jax_serving, jax_telemetry)}
SLO_CFG = dict(ttft_objective_s=0.1, e2e_objective_s=1.0, target=0.9, fast_window_s=10.0,
               slow_window_s=100.0, burn_threshold=1.0, min_requests=2)


class FakeClock:
    def __init__(self, t=0.0):
        self.t = t

    def tick(self, dt=1.0):
        self.t += dt

    def __call__(self):
        return self.t


@pytest.fixture(params=sorted(PACKAGES))
def pkgs(request):
    return PACKAGES[request.param]


@pytest.fixture(scope="module")
def tiny_pair():
    cfg = JaxConfig.tiny(max_seq_len=64)
    model = JaxCausalLM(cfg)
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])
    port_cfg = TransformerConfig.tiny(max_seq_len=64)
    port = CausalLM(port_cfg, device="cpu")
    port.load_state_dict(params_from_jax(params, port_cfg), strict=True)
    return model, params, port


# ---------------------------------------------------------------------- #
# SLO arithmetic under a fake clock
# ---------------------------------------------------------------------- #
def _burn(t):
    for i in range(10):  # 2 of 10 miss ttft: error 0.2 over a 0.1 budget
        t.observe(float(i), 0.5 if i < 2 else 0.05, 0.5)
    return 9.0


def _burst(t):
    for i in range(90):
        t.observe(float(i), 0.05, 0.5)
    for i in range(3):
        t.observe(90.0 + i, 0.5, 0.5)
    return 93.0


def _one_miss(t):
    t.observe(0.0, 99.0, 99.0)
    return 0.0


def _aged_out(t):
    for i in range(5):
        t.observe(float(i), 99.0, 99.0)
    return 500.0


def _none_latency(t):
    t.observe(0.0, None, None)
    t.observe(1.0, 0.05, None)
    return 1.0


SLO_SCENARIOS = {"burn_rate": _burn, "multi_window_gate": _burst, "min_requests_gate": _one_miss,
                 "events_age_out": _aged_out, "none_is_a_miss": _none_latency}


@pytest.mark.parametrize("scenario", sorted(SLO_SCENARIOS))
def test_slo_snapshots_equal_the_reference(scenario):
    trackers = [pkg.SloTracker(pkg.SLOConfig(**SLO_CFG)) for pkg in (serving, jax_serving)]
    now = [SLO_SCENARIOS[scenario](t) for t in trackers][0]
    got, want = (t.snapshot(now) for t in trackers)
    assert got == want
    assert trackers[0].met_total == trackers[1].met_total
    if scenario == "burn_rate":
        assert got["ttft_burn_fast"] == pytest.approx(2.0) and got["breach"]
        assert got["breached_objectives"] == ["ttft"]
    elif scenario == "multi_window_gate":
        assert got["ttft_burn_fast"] >= 1.0 > got["ttft_burn_slow"] and not got["breach"]
    elif scenario == "min_requests_gate":
        assert got["ttft_burn_fast"] > 1.0 and not got["breach"]
    elif scenario == "events_age_out":
        assert got["requests_slow_window"] == 0 and got["requests_total"] == 5
        assert got["ttft_attainment"] == 0.0
    else:
        assert trackers[0].met_total == {"ttft": 1, "e2e": 0}


@pytest.mark.parametrize("seed", [0, 1])
def test_slo_random_stream_equals_the_reference_after_every_observation(seed):
    rng = random.Random(seed)
    cfg = dict(SLO_CFG, min_requests=3, fast_window_s=5.0, slow_window_s=30.0)
    trackers = [pkg.SloTracker(pkg.SLOConfig(**cfg)) for pkg in (serving, jax_serving)]
    now = 0.0
    for _ in range(300):
        now += rng.expovariate(2.0)
        ttft = None if rng.random() < 0.05 else rng.expovariate(12.0)
        e2e = None if ttft is None else ttft + rng.expovariate(1.5)
        for t in trackers:
            t.observe(now, ttft, e2e)
        at = now + rng.random()
        got, want = (t.snapshot(at) for t in trackers)
        assert got == want
    assert trackers[0].breaches == trackers[1].breaches > 0


@pytest.mark.parametrize("bad", [dict(target=1.0), dict(ttft_objective_s=0.0),
                                 dict(fast_window_s=700.0), dict(burn_threshold=0.0),
                                 dict(interval_steps=-1), dict(min_requests=0)])
def test_slo_config_rejects_what_the_reference_rejects(pkgs, bad):
    with pytest.raises(ValueError):
        pkgs[0].SLOConfig(**bad)


# ---------------------------------------------------------------------- #
# sinks and the collector
# ---------------------------------------------------------------------- #
SERVING_RECORDS = [
    {"kind": "serve", "label": "serve", "time_unix": 1.0, "request_id": "a", "adapter_id": None,
     "prompt_tokens": 5, "new_tokens": 4, "queue_s": 0.5, "ttft_s": 0.75, "e2e_s": 2.0,
     "decode_tokens_per_s": 3.0, "spec_proposed": 6, "spec_accepted": 4, "accept_rate": 4 / 6},
    {"kind": "serve", "label": "serve", "request_id": "b", "prompt_tokens": 2, "new_tokens": 1,
     "queue_s": 0.0, "ttft_s": 0.25, "e2e_s": 0.25, "decode_tokens_per_s": None,
     "spec_proposed": 0, "spec_accepted": 0, "accept_rate": None},
    {"kind": "serve_gauge", "label": 'we"ird\\lab\nel', "queue_depth": 7, "slot_occupancy": 0.75,
     "time_unix": 1.0},
    {"kind": "shed", "reason": "queue_full", "request_id": "r"},
    {"kind": "shed", "reason": "queue_full", "request_id": "r2"},
    {"kind": "shed", "reason": "queue_deadline", "request_id": "r3"},
    {"kind": "slo", "breach": True, "max_burn_rate": 3.5, "breached_objectives": ["ttft"],
     "ttft_attainment": None, "time_unix": 1.0},
    {"kind": "span", "request_id": "r", "submit_t": 1.0},
]


def test_prometheus_text_equals_the_reference_for_serving_records():
    sinks = [pkg.PrometheusTextSink(path=None, summary_window=2)
             for pkg in (telemetry, jax_telemetry)]
    for record in SERVING_RECORDS:
        for sink in sinks:
            sink.emit(dict(record))
        assert sinks[0].render() == sinks[1].render()
    text = sinks[0].render()
    assert 'accelerate_tpu_serve_queue_depth{label="we\\"ird\\\\lab\\nel"} 7.0' in text
    assert 'accelerate_tpu_serve_shed_total{reason="queue_full"} 2.0' in text
    assert 'accelerate_tpu_slo_breach{label="serve"} 1.0' in text
    assert 'accelerate_tpu_serve_spec_proposed_total{adapter="none"} 6.0' in text
    assert "accelerate_tpu_serve_ttft_seconds_count" in text and "breached_objectives" not in text


def test_span_records_are_not_gauges_and_path_none_never_touches_disk(pkgs, tmp_path,
                                                                     monkeypatch):
    monkeypatch.chdir(tmp_path)
    sink = pkgs[1].PrometheusTextSink(path=None)
    sink.emit({"kind": "span", "request_id": "r", "submit_t": 1.0})
    assert sink.render() == "\n"
    sink.emit({"kind": "serve_gauge", "queue_depth": 1})
    sink.close()
    assert list(tmp_path.iterdir()) == []


def test_prometheus_file_and_jsonl_sinks_write(tmp_path):
    prom = telemetry.PrometheusTextSink(path=tmp_path / "m" / "serve.prom")
    jsonl = telemetry.JSONLSink(tmp_path / "j" / "serve.jsonl")
    for record in SERVING_RECORDS:
        prom.emit(dict(record))
        jsonl.emit(dict(record))
    prom.close()
    jsonl.close()
    jsonl.close()  # idempotent
    assert (tmp_path / "m" / "serve.prom").read_text() == prom.render()
    lines = (tmp_path / "j" / "serve.jsonl").read_text().splitlines()
    assert [json.loads(line)["kind"] for line in lines] == [r["kind"] for r in SERVING_RECORDS]


def test_step_telemetry_emit_path_and_disabled_noops():
    class Broken(telemetry.TelemetrySink):
        def emit(self, record):
            raise RuntimeError("sink exploded")

    seen = []

    class Keep(telemetry.TelemetrySink):
        def emit(self, record):
            seen.append(record)

    tele = telemetry.StepTelemetry(True)
    tele.add_sink(Broken())
    tele.add_sink(Keep())
    for i in range(5):
        tele.record_serve(request_id=f"r{i}", prompt_tokens=3, new_tokens=2, ttft_s=0.1,
                          cached_prefix_tokens=0)
    tele.record_shed(request_id="s", reason="queue_full")
    tele.record_slo(breach=False)
    tele.record_span(request_id="r0", state="finished")
    tele.record_serve_gauge(queue_depth=0)
    assert seen[0]["kind"] == "meta" and seen[0]["schema"] == telemetry.SCHEMA_VERSION
    assert [r["kind"] for r in seen[1:]] == ["serve"] * 5 + ["shed", "slo", "span", "serve_gauge"]
    assert seen[1]["cached_prefix_tokens"] == 0 and seen[1]["prompt_tokens"] == 3
    summary = tele.summary()
    assert summary["records"] == 9 and summary["by_kind"]["serve"] == 5
    assert summary["sink_errors"] == 10  # every emit, meta included, failed in Broken
    tele.close()
    off = telemetry.StepTelemetry(False)
    assert off.record_serve(request_id="x", prompt_tokens=1, new_tokens=1) is None
    assert off.record_span(request_id="x") is None and off.sample_memory(force=True) is None
    assert len(off.records) == 0


def test_sample_memory_on_the_cpu_and_its_throttle():
    tele = telemetry.StepTelemetry(telemetry.TelemetryConfig(census_min_interval_s=3600.0))
    first = tele.sample_memory()
    assert first["kind"] == "memory" and first["host_rss_bytes"] > 0
    assert first["hbm_bytes_in_use"] == first["hbm_bytes_limit"] == 0  # no CUDA device here
    assert tele.sample_memory() is None  # within the interval
    assert tele.sample_memory(force=True)["kind"] == "memory"


@pytest.mark.parametrize("hook", ["begin_step", "end_step", "record_checkpoint",
                                  "record_compile", "record_dataloader_wait"])
def test_training_hooks_raise_naming_a10(hook):
    """The training hooks the serving slice refused (queue A10) are ported
    and run: the step hooks since the accumulation slice
    (``tests/test_torch_telemetry_train.py`` holds their records against the
    reference's), ``record_checkpoint`` since the async checkpoint slice
    (``tests/test_torch_checkpoint_async.py``)."""
    tele = telemetry.StepTelemetry(True)
    if hook == "record_checkpoint":
        record = tele.record_checkpoint(step=1, mode="async", background_s=0.5,
                                        bytes_written=100)
        assert record["kind"] == "checkpoint" and record["write_bandwidth_bytes_per_s"] == 200
        assert telemetry.StepTelemetry(False).record_checkpoint(step=1) is None
        return
    args = {"record_dataloader_wait": (0.5,)}.get(hook, ())
    getattr(tele, hook)(*args)
    assert telemetry.StepTelemetry(False).end_step(None) is None


# ---------------------------------------------------------------------- #
# the engine's wiring against the reference's
# ---------------------------------------------------------------------- #
def _both(tiny_pair, **kw):
    model, params, port = tiny_pair
    out = {}
    for name in ("reference", "port"):
        clock = FakeClock()
        tel = (jax_telemetry if name == "reference" else telemetry).StepTelemetry(True)
        pkg = jax_serving if name == "reference" else serving
        slo = kw.get("slo")
        opts = dict(kw, telemetry=tel, now=clock,
                    slo=pkg.SLOConfig(**slo) if slo is not None else None)
        engine = (jax_serving.ServingEngine(model, params, **opts) if name == "reference"
                  else serving.ServingEngine(port, **opts))
        out[name] = (engine, clock, tel)
    return out


def _run(engine, clock, trace, tag=None):
    # with a tag, request ids are f"{tag}{i}" on every engine; without, the
    # engine numbers them from its module's process-wide counter
    rids = [engine.add_request(p, max_new_tokens=n,
                               request_id="" if tag is None else f"{tag}{i}")
            for i, (p, n) in enumerate(trace)]
    while engine.has_work:
        engine.step()
        clock.tick(0.25)
    return [engine.result(r) for r in rids], rids


def _records(tel, kind):
    return [{k: v for k, v in r.items() if k != "time_unix"} for r in tel.records
            if r.get("kind") == kind]


def test_records_equal_the_reference_under_a_fake_clock(tiny_pair):
    """Six requests through two slots and a queue bound of 3: the serve,
    span, serve_gauge, shed and slo records and the summaries are the
    reference's; span stamps keep their order."""
    runs = _both(tiny_pair, max_slots=2, block_size=8, max_queue=3, gauge_interval=2,
                 slo=dict(ttft_objective_s=0.6, e2e_objective_s=2.0, interval_steps=3,
                          min_requests=1))
    rng = np.random.default_rng(2)
    trace = [(rng.integers(1, 50, int(rng.integers(3, 12))).tolist(), int(rng.integers(2, 7)))
             for _ in range(6)]
    outs = {name: _run(engine, clock, trace, tag="r") for name, (engine, clock, _) in runs.items()}
    assert outs["port"][0] == outs["reference"][0]
    (ref, _, ref_tel), (got, _, tel) = runs["reference"], runs["port"]
    for kind in ("serve", "span", "shed", "slo"):
        mine, want = _records(tel, kind), _records(ref_tel, kind)
        assert len(mine) == len(want) > 0, kind
        assert mine == [{k: v for k, v in r.items() if k in m} for r, m in zip(want, mine)], kind
    gauges, ref_gauges = _records(tel, "serve_gauge"), _records(ref_tel, "serve_gauge")
    assert gauges == ref_gauges and len(gauges) > 0
    for rec in _records(tel, "span"):
        if rec["state"] == "finished":
            assert (rec["submit_t"] <= rec["admit_t"] <= rec["prefill_start_t"]
                    <= rec["first_token_t"] <= rec["finish_t"])
    assert got.summary()["slo"] == ref.summary()["slo"]
    assert got.summary()["gauges"] == ref.summary()["gauges"]
    assert sum(1 for r in tel.records if r.get("kind") == "memory") >= 1
    tel.close()


def test_set_observability_on_a_warm_engine(tiny_pair):
    """Off: no record, no span, the same tokens. On: serve, span,
    serve_gauge and slo records reach the Prometheus sink, which writes
    nothing to disk; no token changes and no program is built."""
    _, _, port = tiny_pair
    engine = serving.ServingEngine(port, max_slots=2, block_size=8, seed=3)
    trace = [([1, 2, 3, 4], 5), ([5, 6, 7, 8, 9, 10], 3), ([11, 12], 6)]
    clock = FakeClock()
    want, _ = _run(engine, clock, trace)
    builds = engine.trace_counts()
    tele = telemetry.StepTelemetry(True)
    prom = tele.add_sink(telemetry.PrometheusTextSink(path=None))
    tracker = serving.SloTracker(serving.SLOConfig(ttft_objective_s=1.0, interval_steps=2,
                                                   min_requests=1))
    engine.set_observability(telemetry=None, gauge_interval=0, slo=None, spans=False)
    closed = len(engine.span_log.closed)
    assert _run(engine, clock, trace)[0] == want and len(engine.span_log.closed) == closed
    engine.set_observability(telemetry=tele, gauge_interval=1, slo=tracker, spans=True)
    assert _run(engine, clock, trace)[0] == want
    assert engine.trace_counts() == builds
    kinds = {r["kind"] for r in tele.records}
    assert {"serve", "span", "serve_gauge", "slo", "memory"} <= kinds
    assert engine.slo_tracker is tracker and tracker.total_requests == 3
    text = prom.render()
    assert "accelerate_tpu_serve_queue_depth" in text and "accelerate_tpu_slo_" in text
    assert "accelerate_tpu_serve_ttft_seconds" in text
    with pytest.raises(ValueError, match="gauge_interval"):
        engine.set_observability(gauge_interval=-1)
    tele.close()


def test_queue_bound_sheds_with_terminal_span_and_record(pkgs, tiny_pair):
    model, params, port = tiny_pair
    pkg, tele_pkg = pkgs
    tel = tele_pkg.StepTelemetry(True)
    kw = dict(max_slots=2, block_size=8, max_queue=2, telemetry=tel, now=FakeClock())
    engine = (serving.ServingEngine(port, **kw) if pkg is serving
              else jax_serving.ServingEngine(model, params, **kw))
    rng = np.random.default_rng(0)
    rids = [engine.add_request(rng.integers(1, 50, size=4), max_new_tokens=4) for _ in range(6)]
    shed = [r for r in rids if engine.shed_reason(r) == "queue_full"]
    assert len(shed) == 4
    for _ in engine.stream():
        pass
    for rid in rids:
        assert (engine.result(rid) is not None) ^ (engine.shed_reason(rid) is not None)
    assert engine.summary()["shed_queue_full"] == 4
    spans = {s.request_id: s for s in engine.span_log.closed}
    assert all(spans[r].state == "shed" for r in shed)
    assert [r["reason"] for r in tel.records if r.get("kind") == "shed"] == ["queue_full"] * 4
    assert engine.trace_counts()["decode"] == 1


def test_impossible_slo_breaches_on_the_real_clock(tiny_pair):
    _, _, port = tiny_pair
    tel = telemetry.StepTelemetry(True)
    engine = serving.ServingEngine(port, max_slots=2, block_size=8, telemetry=tel,
                                   slo=serving.SLOConfig(ttft_objective_s=1e-9,
                                                         e2e_objective_s=1e-9, interval_steps=1,
                                                         min_requests=1))
    for seed in range(2):
        engine.add_request(np.random.default_rng(seed).integers(1, 50, size=4), max_new_tokens=2)
    for _ in engine.stream():
        pass
    slo = [r for r in tel.records if r.get("kind") == "slo"]
    assert slo and slo[-1]["breach"] and slo[-1]["ttft_attainment"] == 0.0
    assert engine.slo_tracker.breaches >= 1


def test_result_fifo_eviction_and_export_trace(tiny_pair, tmp_path):
    _, _, port = tiny_pair
    engine = serving.ServingEngine(port, max_slots=2, block_size=8, max_retained_results=2)
    rids = [engine.add_request(np.random.default_rng(i).integers(1, 50, size=4),
                               max_new_tokens=2) for i in range(4)]
    for _ in engine.stream():
        pass
    assert [engine.result(r) is not None for r in rids] == [False, False, True, True]
    payload = json.load(open(engine.export_trace(str(tmp_path / "trace.json"))))
    assert {e["name"] for e in payload["traceEvents"] if e["ph"] == "X"} >= {
        "queue", "prefill", "decode"}
