"""The port's schedule-free and inference examples, on the CPU:

* ``schedule_free.py`` (``TESTING_TINY_MODEL=1``, the reference test's
  config; the runner of ``test_torch_examples_drift.py``) at least 0.60,
  evaluated at ``schedule_free_eval_params``: one epoch of the reference
  test's two (a slow test there; one tiny epoch reads 0.660, 40 s alone at
  two);
* ``inference/streaming_serve.py --requests 5 --cpu`` passes its own
  asserts (streamed tokens equal the stored results, the pool drained, one
  decode build, a serve record a request);
* ``inference/distributed.py`` at world 2 over gloo through the port's
  ``debug_launcher`` (the reference launches it through its CLI's
  ``launch --debug_num_processes 2``, which is queue A10 in the port):
  process 0 prints "5 completions from 2 process(es)".
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("jax")
from test_torch_examples_drift import run_example  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
INFERENCE = REPO / "accelerate_tpu_torch" / "examples" / "inference"


def test_schedule_free_example():
    metric, _ = run_example("schedule_free", ["--cpu"], env={"TESTING_NUM_EPOCHS": "1"})
    assert metric["accuracy"] >= 0.60, metric


def test_streaming_serve_example():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    result = subprocess.run([sys.executable, str(INFERENCE / "streaming_serve.py"),
                             "--requests", "5", "--cpu"], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stderr[-3000:]
    assert "streaming serve example passed" in result.stdout
    assert "served 5 requests" in result.stdout


LAUNCH = """
from accelerate_tpu_torch.launchers import debug_launcher
from accelerate_tpu_torch.examples.inference import distributed
debug_launcher(distributed.main, (["--cpu", "--new_tokens", "4", "--num_prompts", "5"],),
               num_processes=2, timeout=60.0)
"""


def test_inference_distributed_example_world2():
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=str(REPO))
    result = subprocess.run([sys.executable, "-c", LAUNCH], cwd=REPO, env=env,
                            capture_output=True, text=True, timeout=600)
    assert result.returncode == 0, result.stderr[-3000:]
    assert "5 completions from 2 process(es)" in result.stdout
    assert result.stdout.count("prompt ") == 5  # printed once, by process 0
