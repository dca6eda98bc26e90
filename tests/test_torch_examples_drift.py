"""The port's examples against the reference's: the drift tests, the CV
model, and the CV and seq2seq examples run tiny, on the CPU.

* Drift (the reference's ``tests/test_examples.py:43, :56``, through the
  port's ``test_utils/examples.compare_against_test``): every line that
  ``gradient_accumulation.py``, ``checkpointing.py``, ``tracking.py`` and
  ``multi_process_metrics.py`` add to ``nlp_example.py`` appears in
  ``complete_nlp_example.py``, for ``main`` and for ``training_function``;
  and ``complete_cv_example.py``'s additions to ``cv_example.py`` are
  ``complete_nlp_example.py``'s.
* The CV model: the reference's flax ``ConvClassifier`` (imported from its
  ``examples/cv_example.py``) and the port's on weights carried by
  ``cv_example.params_from_flax``: logits, loss and every gradient within
  2e-5 relative to the leaf's largest value (fp32).
* Runs (``TESTING_TINY_MODEL=1``, each a subprocess with one OpenMP thread,
  the reference test's config given to ``training_function`` as its
  ``_run_example`` gives it): ``cv_example`` at lr 3e-3, B 32, 2 epochs at
  least 0.70; ``seq2seq_example`` at 30 epochs, lr 5e-3, B 32, no mixed
  precision, above 0.9. The complete examples are in
  ``test_torch_examples_complete.py``.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from accelerate_tpu_torch.test_utils.examples import compare_against_test  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
EXAMPLES = REPO / "accelerate_tpu_torch" / "examples"
DRIFT_CHECKED = ["gradient_accumulation.py", "checkpointing.py", "tracking.py",
                 "multi_process_metrics.py"]
# the reference's _run_example config (tests/test_examples.py:80)
BASE_CONFIG = {"lr": 3e-4, "num_epochs": 2, "seed": 42, "batch_size": 16}
RUNNER = """
import importlib, json, sys
name, argv, config = sys.argv[1], json.loads(sys.argv[2]), json.loads(sys.argv[3])
mod = importlib.import_module("accelerate_tpu_torch.examples." + name)
got = {}
real = mod.training_function
mod.training_function = lambda cfg, args: got.update(metric=real(config, args))
sys.argv = [name + ".py"] + argv
mod.main()
print("METRIC " + json.dumps(got["metric"]))
"""


def run_example(name, argv, config=None, env=None, timeout=600):
    """The example's ``main`` with ``argv`` and the reference test's config
    (``BASE_CONFIG`` updated by ``config``) handed to its
    ``training_function``, in a subprocess at ``TESTING_TINY_MODEL=1`` with
    one OpenMP thread (beside the suite's other workers). Returns the
    metric and the output."""
    cfg = dict(BASE_CONFIG, **(config or {}))
    full_env = dict(os.environ, TESTING_TINY_MODEL="1", OMP_NUM_THREADS="1",
                    PYTHONPATH=str(REPO), **(env or {}))
    result = subprocess.run([sys.executable, "-c", RUNNER, name, json.dumps(argv),
                             json.dumps(cfg)], cwd=REPO, env=full_env, capture_output=True,
                            text=True, timeout=timeout)
    assert result.returncode == 0, result.stderr[-3000:]
    line = [ln for ln in result.stdout.splitlines() if ln.startswith("METRIC ")][-1]
    return json.loads(line[len("METRIC "):]), result.stdout


@pytest.mark.parametrize("feature", DRIFT_CHECKED)
@pytest.mark.parametrize("parser_only", [True, False], ids=["main", "training"])
def test_example_drift(feature, parser_only):
    diff = compare_against_test(str(EXAMPLES / "complete_nlp_example.py"),
                                str(EXAMPLES / feature), parser_only)
    assert diff == [], f"{feature} holds lines complete_nlp_example.py lacks:\n" + "\n".join(diff)


@pytest.mark.parametrize("parser_only", [True, False], ids=["main", "training"])
def test_cv_family_drift(parser_only):
    diff = compare_against_test(str(EXAMPLES / "complete_nlp_example.py"),
                                str(EXAMPLES / "complete_cv_example.py"), parser_only,
                                base_filename=str(EXAMPLES / "cv_example.py"))
    assert diff == [], "complete_cv_example.py drifted from complete_nlp_example.py:\n" + \
        "\n".join(diff)


def test_drift_is_detected():
    """A feature line the complete example lacks is reported."""
    import tempfile

    src = (EXAMPLES / "tracking.py").read_text().replace(
        "overall_step += 1", "overall_step += 1\n            drifted = True")
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(src)
    try:
        diff = compare_against_test(str(EXAMPLES / "complete_nlp_example.py"), f.name, False,
                                    base_filename=str(EXAMPLES / "nlp_example.py"))
    finally:
        os.unlink(f.name)
    assert diff == ["drifted = True"]


def _reference_conv_classifier():
    sys.path.insert(0, str(REPO / "examples"))
    try:
        import cv_example as reference
    finally:
        sys.path.remove(str(REPO / "examples"))
    return reference


def test_conv_classifier_matches_the_flax_module():
    from accelerate_tpu_torch.examples import cv_example

    reference = _reference_conv_classifier()
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 32, 32, 1)).astype(np.float32)
    labels = np.array([0, 1, 2, 3], np.int32)
    jmodel = reference.ConvClassifier()
    params = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]

    def jloss(p):
        logits = jmodel.apply({"params": p}, jnp.asarray(x))
        return optax.softmax_cross_entropy_with_integer_labels(logits, labels).mean(), logits

    (jl, jlogits), jgrads = jax.value_and_grad(jloss, has_aux=True)(params)
    model = cv_example.ConvClassifier(device="cpu")
    model.load_state_dict(cv_example.params_from_flax(params), strict=True)
    tparams = dict(model.named_parameters())
    logits = torch.func.functional_call(model, tparams, (torch.from_numpy(x),))
    loss = F.cross_entropy(logits, torch.from_numpy(labels).long())

    def close(got, want, what):
        want = np.asarray(want)
        err = float(np.abs(got - want).max()) / (float(np.abs(want).max()) + 1e-12)
        assert err <= 2e-5, (what, err)

    close(logits.detach().numpy(), jlogits, "logits")
    close(np.float32(loss.item()), np.float32(jl), "loss")
    grads = dict(zip(tparams, torch.autograd.grad(loss, list(tparams.values()))))
    want = cv_example.params_from_flax(jax.tree.map(np.asarray, jgrads))
    assert set(want) == set(grads)
    for name, g in grads.items():
        close(g.numpy(), want[name].numpy(), name)


def test_cv_example_quality():
    metric, _ = run_example("cv_example", ["--cpu"], config={"lr": 3e-3, "batch_size": 32})
    assert metric["accuracy"] >= 0.70, metric


def test_seq2seq_example_quality():
    """BOS-started cached generation must reproduce trained sources."""
    metric, _ = run_example("seq2seq_example", ["--mixed_precision", "no", "--cpu"],
                            config={"num_epochs": 30, "lr": 5e-3, "batch_size": 32})
    assert metric["accuracy"] > 0.9, metric
