"""The port's examples on the CPU, at the tiny size.

``accelerate_tpu_torch/examples/checkpointing.py`` trains one epoch with
``--checkpointing_steps epoch``, then resumes from ``epoch_0`` for a second
epoch: both checkpoints exist and the second epoch's accuracy is at least
the first's minus 0.05 (the reference's bound, ``tests/test_examples.py``,
``test_checkpointing_example_resume``). ``nlp_example.py`` trains one
epoch and must beat chance, and so must the by-feature examples
``gradient_accumulation.py`` (K 2), ``automatic_gradient_accumulation.py``
(a target batch of 32 over steps of 16) and ``memory.py``;
``early_stopping.py`` at threshold 10 must stop on the first step (the
reference's case), and ``cross_validation.py`` over 2 folds must give an
ensemble no worse than its worst fold (the reference's bound). Each run is
a subprocess with the examples' ``TESTING_TINY_MODEL`` and
``TESTING_NUM_EPOCHS``; one tiny epoch is 128 steps, about 10-20 s on the
CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "accelerate_tpu_torch" / "examples"


def _run(name, args, epochs) -> str:
    # one thread: beside busy processes (the suite's other workers) torch's
    # OpenMP threads oversubscribe the cores; one tiny checkpointing epoch
    # read 115.5 s at 4 threads against 28.1 s at 1 beside five busy
    # processes on 8 cores (11.3 s and 19.8 s alone)
    env = dict(os.environ, TESTING_TINY_MODEL="1", TESTING_NUM_EPOCHS=str(epochs),
               OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    result = subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py"), "--cpu", *args],
                            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stderr[-3000:]
    return result.stdout


def _run_example(name, args, epochs):
    last = _run(name, args, epochs).strip().splitlines()[-1]  # "... {'accuracy': A}"
    return ast.literal_eval(last[last.index("{"):])


def test_checkpointing_example_resume(tmp_path):
    out = str(tmp_path / "ckpts")
    metric = _run_example("checkpointing", ["--checkpointing_steps", "epoch",
                                            "--output_dir", out], epochs=1)
    assert os.path.isdir(os.path.join(out, "epoch_0"))
    metric2 = _run_example("checkpointing", [
        "--checkpointing_steps", "epoch", "--output_dir", out,
        "--resume_from_checkpoint", os.path.join(out, "epoch_0")], epochs=2)
    assert metric2["accuracy"] >= metric["accuracy"] - 0.05
    assert os.path.isdir(os.path.join(out, "epoch_1"))
    assert sorted(os.listdir(out)) == ["epoch_0", "epoch_1"]  # no work dir left behind


def test_nlp_example_trains():
    metric = _run_example("nlp_example", [], epochs=1)
    assert metric["accuracy"] > 0.5


@pytest.mark.parametrize("name,args", [
    ("gradient_accumulation", ["--gradient_accumulation_steps", "2"]),
    ("automatic_gradient_accumulation", ["--observed_batch_size", "32"]),
    ("memory", []),
])
def test_by_feature_example_trains(name, args):
    metric = _run_example(name, args, epochs=1)
    assert metric["accuracy"] > 0.5


def test_early_stopping_example_stops_at_once():
    out = _run("early_stopping", ["--early_stopping_threshold", "10.0"], epochs=1)
    assert "early stop at epoch 0 step 0" in out
    last = out.strip().splitlines()[-1]
    assert "accuracy" in ast.literal_eval(last[last.index("{"):])


def test_cross_validation_example_ensembles_the_folds():
    metric = _run_example("cross_validation", ["--num_folds", "2"], epochs=1)
    assert len(metric["folds"]) == 2
    assert metric["accuracy"] >= min(metric["folds"]) - 1e-9
