"""The port's complete examples run tiny on the CPU (``TESTING_TINY_MODEL=1``,
one epoch, the reference test's config; the runner of
``test_torch_examples_drift.py``), each with ``--checkpointing_steps epoch
--with_tracking``:

* ``complete_cv_example.py`` (lr 3e-3, B 32) at least 0.70, ``epoch_0``
  saved and one JSONL line for the epoch;
* ``complete_nlp_example.py`` beats chance with ``{"accuracy", "f1"}``,
  ``epoch_0`` saved and one JSONL line for the epoch.
"""

import json

import pytest

pytest.importorskip("jax")
from test_torch_examples_drift import run_example  # noqa: E402


def test_complete_cv_example_checkpoints_and_tracks(tmp_path):
    out, logs = tmp_path / "ckpt", tmp_path / "logs"
    metric, _ = run_example(
        "complete_cv_example",
        ["--cpu", "--checkpointing_steps", "epoch", "--output_dir", str(out), "--with_tracking",
         "--project_dir", str(logs)],
        config={"lr": 3e-3, "batch_size": 32}, env={"TESTING_NUM_EPOCHS": "1"})
    assert metric["accuracy"] >= 0.70, metric
    assert (out / "epoch_0").is_dir()
    lines = (logs / "complete_cv_example" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(ln)["epoch"] for ln in lines] == [0]


def test_complete_nlp_example_checkpoints_and_tracks(tmp_path):
    out, logs = tmp_path / "ckpt", tmp_path / "logs"
    metric, _ = run_example(
        "complete_nlp_example",
        ["--cpu", "--checkpointing_steps", "epoch", "--output_dir", str(out), "--with_tracking",
         "--project_dir", str(logs)], env={"TESTING_NUM_EPOCHS": "1"})
    assert set(metric) == {"accuracy", "f1"} and metric["accuracy"] > 0.5, metric
    assert (out / "epoch_0").is_dir()
    lines = (logs / "complete_nlp_example" / "metrics.jsonl").read_text().splitlines()
    assert [json.loads(ln)["epoch"] for ln in lines] == [0]
