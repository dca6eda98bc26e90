"""The port's examples on the CPU, at the tiny size.

``accelerate_tpu_torch/examples/checkpointing.py`` trains one epoch with
``--checkpointing_steps epoch``, then resumes from ``epoch_0`` for a second
epoch: both checkpoints exist and the second epoch's accuracy is at least
the first's minus 0.05 (the reference's bound, ``tests/test_examples.py``,
``test_checkpointing_example_resume``). ``nlp_example.py`` trains one
epoch and must beat chance. Each run is a subprocess with the examples'
``TESTING_TINY_MODEL`` and ``TESTING_NUM_EPOCHS``; one tiny epoch is 128
steps, about 10-20 s on the CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "accelerate_tpu_torch" / "examples"


def _run_example(name, args, epochs):
    env = dict(os.environ, TESTING_TINY_MODEL="1", TESTING_NUM_EPOCHS=str(epochs),
               OMP_NUM_THREADS="4", PYTHONPATH=str(REPO))
    result = subprocess.run([sys.executable, str(EXAMPLES / f"{name}.py"), "--cpu", *args],
                            cwd=REPO, env=env, capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stderr[-3000:]
    last = result.stdout.strip().splitlines()[-1]  # "epoch N: train_loss X {'accuracy': A}"
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
