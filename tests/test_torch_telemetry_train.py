"""The port's training step records against the JAX reference's, on the CPU.

The one-process cases of ``tests/test_telemetry.py`` for step records:
``unified_step`` with telemetry on writes a JSONL whose records equal the
reference's field for field apart from times and memory readings (which
each process measures for itself); the rebuild detector warns with the
changed dimension and marks the records; ``tree_fingerprint`` is abstract
and spelled as the reference spells it; telemetry off adds no synchronise
and no record; ``memory_interval`` gates the memory fields; the throughput
fields and ``record_compile``'s record.
"""

import json
import logging

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu.telemetry import StepTelemetry as JaxTelemetry  # noqa: E402
from accelerate_tpu.telemetry import TelemetryConfig as JaxConfig  # noqa: E402
from accelerate_tpu.telemetry.recompile import tree_fingerprint as jax_fingerprint  # noqa: E402
from accelerate_tpu_torch.telemetry import collector  # noqa: E402
from accelerate_tpu_torch.telemetry import (  # noqa: E402
    RecompileDetector,
    StepTelemetry,
    TelemetryConfig,
    tree_fingerprint,
)

# measured by each process for itself: present in both, values not compared
TIMES = {"time_unix", "step_time_s", "dispatch_s", "dataloader_wait_s", "tokens_per_s"}
MEMORY = {"peak_hbm_bytes", "hbm_bytes_in_use", "hbm_bytes_limit", "host_rss_bytes"}
# the reference attributes XLA compile cost to the step that traced
XLA_ONLY = {"compile_time_s", "persistent_cache_hits", "persistent_cache_misses",
            "compile_time_saved_s"}


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


def port_loss(params, batch):
    return torch.mean((batch["x"] * params["w"] + params["b"]) ** 2)


def jax_loss(params, batch):
    return jnp.mean((batch["x"] * params["w"] + params["b"]) ** 2)


def _jsonl(path):
    return [json.loads(line) for line in path.read_text().splitlines()]


@pytest.mark.parametrize("accum", [1, 2])
def test_unified_step_jsonl_matches_reference(tmp_path, accum):
    ds = [{"x": np.full((1,), float(i), np.float32)} for i in range(64)]
    pacc = port.Accelerator(cpu=True, gradient_accumulation_steps=accum,
                            telemetry=TelemetryConfig(jsonl_path=str(tmp_path / "p.jsonl")))
    opt, loader = pacc.prepare(port.sgd(0.01), port.DataLoader(ds, batch_size=16))
    step = pacc.unified_step(port_loss, opt)
    carry = pacc.init_carry({"w": torch.tensor(1.0), "b": torch.tensor(0.5)}, opt)
    for batch in loader:
        carry, _ = step(carry, batch)
    pacc.telemetry.close()

    jacc = jax_pkg.Accelerator(gradient_accumulation_steps=accum,
                               telemetry=JaxConfig(jsonl_path=str(tmp_path / "j.jsonl")))
    params, jopt, jloader = jacc.prepare({"w": jnp.asarray(1.0), "b": jnp.asarray(0.5)},
                                         optax.sgd(0.01), jax_pkg.DataLoader(ds, batch_size=16))
    jstep = jacc.unified_step(jax_loss, jopt)
    jcarry = jacc.init_carry(params, jopt)
    for batch in jloader:
        jcarry, _ = jstep(jcarry, batch)
    jacc.telemetry.close()

    got, want = _jsonl(tmp_path / "p.jsonl"), _jsonl(tmp_path / "j.jsonl")
    assert len(got) == len(want) == 5  # meta + 4 steps
    for key in ("kind", "schema", "backend", "process_index", "process_count"):
        assert got[0][key] == want[0][key]
    for g, w in zip(got[1:], want[1:]):
        assert set(g) == set(w) - XLA_ONLY
        for key in set(w) - TIMES - MEMORY - XLA_ONLY:
            if isinstance(w[key], float):
                np.testing.assert_allclose(g[key], w[key], rtol=2e-5, err_msg=key)
            else:
                assert g[key] == w[key], key
        assert g["step_time_s"] > 0 and 0 < g["dispatch_s"] <= g["step_time_s"]
        assert g["tokens_per_s"] > 0 and g["host_rss_bytes"] > 0
    assert [r["retraced"] for r in got[1:]] == [True, False, False, False]
    assert sum(r["dataloader_wait_s"] for r in got[1:]) > 0  # the loader reports its host time
    summary = pacc.telemetry.summary()
    assert summary["steps"] == 4 and summary["recompiles"] == 0
    assert summary["step_time_mean_s"] > 0 and summary["tokens_per_s_mean"] > 0
    assert set(JaxTelemetry(True).summary()) <= set(summary) | {"records", "by_kind"}


def test_retrace_warning_names_changed_dim(caplog):
    acc = port.Accelerator(cpu=True, telemetry=True)
    opt = acc.prepare(port.sgd(0.01))
    step = acc.unified_step(port_loss, opt)
    carry = acc.init_carry({"w": torch.tensor(1.0), "b": torch.tensor(0.0)}, opt)
    with caplog.at_level(logging.WARNING, logger="accelerate_tpu_torch.telemetry.recompile"):
        for seq in (16, 16, 32, 16):  # first build, hit, rebuild, seen before
            carry, _ = step(carry, {"x": torch.ones(8, seq)})
    warnings = [r for r in caplog.records if r.name == "accelerate_tpu_torch.telemetry.recompile"]
    assert len(warnings) == 1
    msg = warnings[0].getMessage()
    assert "dim 1: 16 -> 32" in msg and "(8, 16)" in msg and "(8, 32)" in msg
    assert acc.telemetry.recompiles == 1
    assert [r["retraced"] for r in acc.telemetry.records] == [True, False, True, False]


def test_recompile_detector_unit():
    det = RecompileDetector("f")
    a = {"x": torch.ones(4, 8)}
    b = {"x": torch.ones(4, 8, dtype=torch.bfloat16)}
    assert det.check(a) is True and det.retraces == 0
    assert det.check(a) is False
    assert det.check(b) is True and det.retraces == 1  # a dtype change rebuilds too
    assert det.check(a) is False and det.retraces == 1


def test_tree_fingerprint_is_abstract_and_the_reference_spelling():
    assert tree_fingerprint({"x": torch.zeros(2, 3)}) == tree_fingerprint({"x": torch.ones(2, 3)})
    assert tree_fingerprint({"x": torch.zeros(2, 3)}) != tree_fingerprint({"x": torch.zeros(2, 4)})
    tree = {"b": [np.zeros((2, 3), np.float32), np.zeros(4, np.int32)], "a": 1.5}
    ptree = {"b": [torch.zeros(2, 3), torch.zeros(4, dtype=torch.int32)], "a": 1.5}

    def spelled(fp):  # each package has its own marker for a leaf with no shape
        return [(key, shape if isinstance(shape, tuple) else "type", dtype)
                for key, shape, dtype in fp]

    assert spelled(tree_fingerprint(ptree, {})) == spelled(jax_fingerprint(tree, {}))


def test_telemetry_off_never_synchronises(monkeypatch):
    calls = []
    monkeypatch.setattr(collector, "_synchronize", lambda result: calls.append(1))
    acc = port.Accelerator(cpu=True)  # default: telemetry disabled
    assert acc.telemetry.enabled is False
    opt = acc.prepare(port.sgd(0.01))
    step = acc.unified_step(port_loss, opt)
    carry = acc.init_carry({"w": torch.tensor(1.0), "b": torch.tensor(0.0)}, opt)
    for _ in range(3):
        carry, _ = step(carry, {"x": torch.ones(8, 4)})
    assert calls == [] and len(acc.telemetry.records) == 0
    assert acc.telemetry.end_step(None) is None
    on = StepTelemetry(True)
    on.begin_step()
    on.end_step(torch.ones(()))
    assert calls == [1]  # enabled: one synchronise a step


def test_memory_interval_gates_sampling():
    for tel in (StepTelemetry(TelemetryConfig(memory_interval=2)),
                JaxTelemetry(JaxConfig(memory_interval=2))):
        recs = []
        for i in range(4):
            tel.begin_step()
            recs.append(tel.end_step(np.ones(()), step=i))
        assert ["peak_hbm_bytes" in r for r in recs] == [True, False, True, False]
        tel.close()
    off = StepTelemetry(TelemetryConfig(memory_interval=0))
    off.begin_step()
    assert "host_rss_bytes" not in off.end_step(None)


def test_config_validation():
    for kw, match in ((dict(memory_interval=-1), "memory_interval"),
                      (dict(census_min_interval_s=-1.0), "census_min_interval_s"),
                      (dict(history=0), "history")):
        with pytest.raises(ValueError, match=match):
            TelemetryConfig(**kw)


def test_throughput_fields_and_compile_record():
    """``tokens_fn`` counts the tokens; with ``flops_per_token`` and
    ``device_peak_flops`` the record carries model FLOP/s and MFU (one
    device); ``record_compile`` emits the reference's record."""
    cfg = dict(tokens_fn=lambda b: 10 * len(b["x"]), flops_per_token=6e6,
               device_peak_flops=1e12)
    tel = StepTelemetry(TelemetryConfig(**cfg))
    tel.begin_step()
    rec = tel.end_step(torch.ones(()), batch={"x": torch.ones(3)})
    assert rec["tokens"] == 30
    assert rec["model_flops_per_s"] == pytest.approx(6e6 * rec["tokens_per_s"])
    assert rec["mfu"] == pytest.approx(rec["model_flops_per_s"] / 1e12)
    assert StepTelemetry(True).end_step(None, batch={"ids": torch.ones(4, 7)})["tokens"] == 28
    got = StepTelemetry(True).record_compile(label="s", compile_time_s=1.5, extra_field=3)
    want = JaxTelemetry(True).record_compile(label="s", compile_time_s=1.5, extra_field=3)
    assert {k: v for k, v in got.items() if k != "time_unix"} == {
        k: v for k, v in want.items() if k != "time_unix"}
    assert StepTelemetry(False).record_compile(label="s") is None
