"""The port's profiler and FSDP examples run tiny on the CPU
(``TESTING_TINY_MODEL=1``, one epoch, the reference test's config; the
runner of ``test_torch_examples_drift.py``), held to their reference
tests' bounds (``tests/test_examples.py``):

* ``profiler.py --profile_dir D`` above 0.55, and a ``torch.profiler``
  trace (``*.pt.trace.json``, where the reference writes an ``.xplane.pb``)
  under ``D`` that holds PyTorch operators' events (read as text: a whole
  tiny epoch's trace is ~150 MB, deleted once checked);
* ``fsdp_with_peak_mem_tracking.py`` under FULL_SHARD (a group of one) at
  least 0.55, and a JSONL record holding ``host_peak_bytes``.
"""

import json

import pytest

pytest.importorskip("jax")
from test_torch_examples_drift import run_example  # noqa: E402


def test_profiler_example(tmp_path):
    trace = tmp_path / "trace"
    metric, out = run_example("profiler", ["--cpu", "--profile_dir", str(trace)],
                              config={"num_epochs": 1}, env={"TESTING_NUM_EPOCHS": "1"})
    assert metric["accuracy"] > 0.55, metric
    files = list(trace.rglob("*.pt.trace.json"))
    assert len(files) == 1
    with open(files[0]) as f:
        assert f.read(64).lstrip().startswith("{")  # Chrome JSON
        operators = False
        while not operators and (chunk := f.read(1 << 24)):
            operators = '"aten::' in chunk  # a PyTorch operator's event
    files[0].unlink()
    assert operators
    assert "step timing:" in out and "training run:" in out


def test_fsdp_with_peak_mem_tracking_example(tmp_path):
    metric, _ = run_example("fsdp_with_peak_mem_tracking", ["--cpu", "--project_dir",
                                                            str(tmp_path)],
                            env={"TESTING_NUM_EPOCHS": "1"})
    assert metric["accuracy"] >= 0.55, metric
    records = []
    for path in tmp_path.rglob("*.jsonl"):
        records += [json.loads(ln) for ln in path.read_text().splitlines()]
    logged = [r for r in records if "host_peak_bytes" in r]
    assert logged, f"no memory record in tracker output: {records[:5]}"
    assert logged[0]["host_peak_bytes"] >= 0 and logged[0]["epoch"] == 0
