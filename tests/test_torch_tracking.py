"""The port's experiment trackers against the JAX reference, on the CPU.

Mirrors ``tests/test_tracking.py``'s six tests: the JSONL tracker's files
(the records and config equal to the reference tracker's, ``_time``
aside), ``Accelerator(log_with=...)``'s ``init_trackers``/``log``/
``end_training``, ``filter_trackers`` skipping a tracker that needs a
logging dir, a custom tracker passed through, the available trackers and
the registry's names, and TensorBoard event files (skipped where the
``tensorboard`` package is missing, as on the H100 machine).
"""

import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu.tracking as jax_tracking  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.tracking import (  # noqa: E402
    LOGGER_TYPE_TO_CLASS,
    GeneralTracker,
    JSONLTracker,
    filter_trackers,
    get_available_trackers,
    is_tensorboard_available,
)


@pytest.fixture(autouse=True)
def reset_port_singletons():
    def reset():
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()

    reset()
    yield
    reset()


def _lines(path):
    return [{k: v for k, v in json.loads(line).items() if k != "_time"} for line in open(path)]


def test_jsonl_tracker_logs(tmp_path):
    """A tensor, a numpy and a Python value log as numbers, the same lines
    and config as the reference tracker writes for jax arrays."""
    t = JSONLTracker("run1", logging_dir=str(tmp_path / "port"))
    t.store_init_configuration({"lr": 1e-3, "layers": 2, "shape": np.arange(3)})
    t.log({"loss": torch.tensor(0.5), "acc": 0.9, "vec": torch.arange(2.0)}, step=1)
    t.log({"loss": np.float32(0.4)}, step=2)
    t.finish()
    r = jax_tracking.JSONLTracker("run1", logging_dir=str(tmp_path / "ref"))
    r.store_init_configuration({"lr": 1e-3, "layers": 2, "shape": np.arange(3)})
    r.log({"loss": jnp.asarray(0.5), "acc": 0.9, "vec": jnp.arange(2.0)}, step=1)
    r.log({"loss": np.float32(0.4)}, step=2)
    r.finish()
    got = _lines(tmp_path / "port" / "run1" / "metrics.jsonl")
    assert got[0]["loss"] == 0.5 and got[0]["_step"] == 1 and got[1]["_step"] == 2
    assert got == _lines(tmp_path / "ref" / "run1" / "metrics.jsonl")
    cfg = json.load(open(tmp_path / "port" / "run1" / "config.json"))
    assert cfg["lr"] == 1e-3
    assert cfg == json.load(open(tmp_path / "ref" / "run1" / "config.json"))


def test_accelerator_log_with_jsonl(tmp_path):
    acc = port.Accelerator(log_with="jsonl", project_dir=str(tmp_path), cpu=True)
    acc.init_trackers("proj", config={"bs": 8})
    acc.log({"loss": 1.0}, step=0)
    assert acc.get_tracker("jsonl").name == "jsonl"
    assert acc.get_tracker("jsonl", unwrap=True) is acc.trackers[0].tracker
    with pytest.raises(ValueError):
        acc.get_tracker("wandb")
    acc.end_training()
    assert os.path.isfile(tmp_path / "proj" / "metrics.jsonl")
    assert acc.trackers[0].tracker.closed  # end_training finished it
    assert _lines(tmp_path / "proj" / "metrics.jsonl") == [{"_step": 0, "loss": 1.0}]


def test_filter_trackers_skips_missing_dir():
    # jsonl needs a dir; with None it is skipped with a warning
    assert filter_trackers(["jsonl"], logging_dir=None) == []
    assert jax_tracking.filter_trackers(["jsonl"], logging_dir=None) == []


def test_custom_tracker_passthrough():
    class MyTracker(GeneralTracker):
        name = "my"
        requires_logging_directory = False

        def __init__(self):
            super().__init__()
            self.logged = []

        @property
        def tracker(self):
            return self

        def store_init_configuration(self, values):
            self.config = values

        def log(self, values, step=None, **kw):
            self.logged.append((step, values))

    t = MyTracker()
    out = filter_trackers([t], logging_dir=None)
    assert out == [t]
    acc = port.Accelerator(cpu=True)
    acc.trackers = out
    acc.log({"x": 1}, step=3)
    assert t.logged == [(3, {"x": 1})]


def test_available_trackers_includes_jsonl():
    avail = get_available_trackers()
    assert any(str(a) == "jsonl" for a in avail)
    assert set(LOGGER_TYPE_TO_CLASS) == set(jax_tracking.LOGGER_TYPE_TO_CLASS)
    assert set(LOGGER_TYPE_TO_CLASS) >= {"tensorboard", "wandb", "mlflow", "jsonl"}
    for name in ("wandb", "mlflow", "comet_ml", "aim", "clearml", "dvclive"):
        # a tracker whose package is missing is skipped, not made
        if all(str(a) != name for a in avail):
            assert filter_trackers([name], logging_dir=".") == []


@pytest.mark.skipif(not is_tensorboard_available(), reason="tensorboard missing")
def test_tensorboard_tracker(tmp_path):
    from accelerate_tpu_torch.tracking import TensorBoardTracker

    t = TensorBoardTracker("run_tb", logging_dir=str(tmp_path))
    t.store_init_configuration({"lr": 0.1})
    t.log({"loss": torch.tensor(0.25), "note": "hello"}, step=1)
    t.finish()
    assert os.path.isdir(tmp_path / "run_tb")
    assert len(os.listdir(tmp_path / "run_tb")) >= 1
