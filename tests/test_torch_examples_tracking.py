"""The port's tracking, metrics and complete NLP examples run tiny on the
CPU (``TESTING_TINY_MODEL=1``, one epoch, the reference test's config; the
runner of ``test_torch_examples_drift.py``), held to their reference
tests' checks (``tests/test_examples.py``):

* ``tracking.py --with_tracking`` writes JSONL under ``--project_dir``:
  one line an epoch, with its accuracy, mean train loss and step;
* ``multi_process_metrics.py`` returns exactly ``{"accuracy", "f1"}``, F1
  in [0, 1].

The complete examples are in ``test_torch_examples_complete.py``.
"""

import json

import pytest

pytest.importorskip("jax")
from test_torch_examples_drift import run_example  # noqa: E402


def test_tracking_example(tmp_path):
    logdir = tmp_path / "logs"
    metric, _ = run_example("tracking", ["--cpu", "--with_tracking", "--project_dir",
                                         str(logdir)], env={"TESTING_NUM_EPOCHS": "1"})
    logged = list(logdir.rglob("*.jsonl"))
    assert logged, f"no jsonl logs written under {logdir}"
    records = [json.loads(ln) for ln in logged[0].read_text().splitlines()]
    assert [r["epoch"] for r in records] == [0]
    assert records[0]["accuracy"] == metric["accuracy"] and records[0]["train_loss"] > 0
    assert records[0]["_step"] == 128  # the tiny epoch's steps


def test_multi_process_metrics_example():
    metric, _ = run_example("multi_process_metrics", ["--cpu"], env={"TESTING_NUM_EPOCHS": "1"})
    assert set(metric) == {"accuracy", "f1"}
    assert 0.0 <= metric["f1"] <= 1.0
