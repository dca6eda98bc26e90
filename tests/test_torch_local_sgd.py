"""The port's Local SGD against the JAX reference's, on the CPU.

Mirrors the 5 tests of ``tests/test_local_sgd.py`` on both packages: the
step count and the one-process identity, a disabled block, the refusal of
``local_sgd_steps`` 0, replicas trained apart on a leading axis and
averaged (``replicate_params``/``average_replicas``, the reference's 8
replicas of its dp axis, to the same numbers), and the flush on leaving the
block. Then the example ``accelerate_tpu_torch/examples/local_sgd.py`` at two
processes over gloo: the replicas drift apart between syncs (each step keeps
its process's gradients inside the block) and land near the generating
weights, the reference example's bounds.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
from accelerate_tpu.local_sgd import LocalSGD as JaxLocalSGD  # noqa: E402
from accelerate_tpu.local_sgd import average_replicas as jax_average  # noqa: E402
from accelerate_tpu.local_sgd import replicate_params as jax_replicate  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.local_sgd import (  # noqa: E402
    LocalSGD,
    average_replicas,
    replicate_params,
)

REPO = Path(__file__).resolve().parent.parent


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


def test_local_sgd_step_counts_and_averages():
    for cls, acc, w in ((JaxLocalSGD, jax_pkg.Accelerator(), jnp.asarray(2.0)),
                        (LocalSGD, port.Accelerator(cpu=True), torch.tensor(2.0))):
        params = {"w": w}
        with cls(acc, local_sgd_steps=3) as lsgd:
            for i in range(1, 7):
                params = lsgd.step(params)
                assert lsgd.num_steps == i
        assert float(params["w"]) == 2.0  # one process: the average is the tree


def test_local_sgd_disabled_is_noop():
    for cls, acc, w in ((JaxLocalSGD, jax_pkg.Accelerator(), jnp.asarray(1.0)),
                        (LocalSGD, port.Accelerator(cpu=True), torch.tensor(1.0))):
        params = {"w": w}
        with cls(acc, local_sgd_steps=2, enabled=False) as lsgd:
            out = lsgd.step(params)
        assert lsgd.num_steps == 0 and out is params


def test_local_sgd_rejects_bad_steps():
    with pytest.raises(ValueError):
        JaxLocalSGD(jax_pkg.Accelerator(), local_sgd_steps=0)
    with pytest.raises(ValueError):
        LocalSGD(port.Accelerator(cpu=True), local_sgd_steps=0)


def test_replicated_independent_training_then_average():
    """Replica ``i`` regresses toward target ``i`` with no sync; the
    replicas diverge, and their average is the mean target. The port's
    replicas (a leading axis) give the reference's numbers (its dp axis of
    8)."""
    acc = jax_pkg.Accelerator()
    jreps = jax_replicate({"w": jnp.asarray(0.0)}, acc.mesh)
    n = jreps["w"].shape[0]
    assert n == acc.mesh.shape["dp"] == 8
    targets = jnp.arange(float(n))

    @jax.jit
    def jstep(reps):
        grads = jax.vmap(jax.grad(lambda w, t: (w - t) ** 2))(reps["w"], targets)
        return {"w": reps["w"] - 0.25 * grads}

    preps = replicate_params({"w": torch.tensor(0.0)}, n)
    assert preps["w"].shape == (n,)
    ptargets = torch.arange(float(n))
    for _ in range(30):
        jreps = jstep(jreps)
        preps = {"w": preps["w"] - 0.25 * 2.0 * (preps["w"] - ptargets)}
    per_replica = preps["w"].numpy()
    assert np.std(per_replica) > 1.0
    np.testing.assert_allclose(per_replica, np.arange(n), atol=1e-3)
    np.testing.assert_allclose(per_replica, np.asarray(jreps["w"]), rtol=1e-6)
    np.testing.assert_allclose(float(average_replicas(preps)["w"]),
                               float(jax_average(jreps)["w"]), rtol=1e-6)
    assert abs(float(average_replicas(preps)["w"]) - np.mean(np.arange(n))) < 1e-3


def test_exit_flush_averages_leftover_steps():
    for cls, acc, w in ((JaxLocalSGD, jax_pkg.Accelerator(), jnp.asarray(5.0)),
                        (LocalSGD, port.Accelerator(cpu=True), torch.tensor(5.0))):
        carry = {"params": {"w": w}}
        with cls(acc, local_sgd_steps=4) as lsgd:
            carry = lsgd.step(carry)  # 1 of 4: the window is not complete
        assert float(carry["params"]["w"]) == 5.0
        assert lsgd.num_steps == 1
    assert acc._local_sgd is False  # the step reduces again outside the block


def test_local_sgd_example_at_two_processes():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    result = subprocess.run(
        [sys.executable, str(REPO / "accelerate_tpu_torch" / "examples" / "local_sgd.py"),
         "--cpu", "--num_processes", "2", "--local_sgd_steps", "8"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert result.returncode == 0, result.stderr[-3000:]
    last = result.stdout.strip().splitlines()[-1]
    metric = ast.literal_eval(last[last.index("{"):])
    assert metric["weight_error"] < 0.1, metric
    assert metric["max_spread"] > 1e-3, metric  # the replicas trained apart
    assert result.stdout.count("after averaging") == 6
