"""The optimizer and scheduler wrappers on both packages: the reference's
ten tests of ``tests/test_optimizer_scheduler.py``, each run on the JAX
package and on the port, plus the port's own:

* a non-port optimizer (``object()``, ``torch.optim.SGD``) raises TypeError;
* ``AcceleratedOptimizer(scheduler_fn=)`` keeps the function, as the
  reference's does;
* ``AcceleratedScheduler.step_count`` is read-only, and the scheduler steps
  by the process count as the reference's does: at world 2 over gloo
  (``debug_launcher``) one synced step advances it by 2, by 1 under
  ``split_batches``, and a step while accumulating by nothing.

Values are exact but the sgd update (1e-6 relative, as the reference's).
"""

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu import optimizer as jax_optimizer  # noqa: E402
from accelerate_tpu.scheduler import AcceleratedScheduler as JaxScheduler  # noqa: E402
from accelerate_tpu.utils.dataclasses import MixedPrecisionPolicy as JaxPolicy  # noqa: E402
from accelerate_tpu_torch import optimizer as port_optimizer  # noqa: E402
from accelerate_tpu_torch.scheduler import AcceleratedScheduler  # noqa: E402
from accelerate_tpu_torch.utils.dataclasses import MixedPrecisionPolicy  # noqa: E402

PACKAGES = ("reference", "port")


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


class Pkg:
    """One package's names for the tests below, and its arrays."""

    def __init__(self, name):
        self.name = name
        ref = name == "reference"
        self.state = ((lambda: jax_pkg.AcceleratorState()) if ref
                      else (lambda: port.AcceleratorState(cpu=True)))
        self.GradientState = jax_pkg.GradientState if ref else port.GradientState
        self.Plugin = (jax_pkg.GradientAccumulationPlugin if ref
                       else port.GradientAccumulationPlugin)
        self.Optimizer = (jax_optimizer.AcceleratedOptimizer if ref
                          else port_optimizer.AcceleratedOptimizer)
        self.Scheduler = JaxScheduler if ref else AcceleratedScheduler
        self.sgd = optax.sgd if ref else port.sgd
        self.Policy = JaxPolicy if ref else MixedPrecisionPolicy
        self.ops = jax_optimizer if ref else port_optimizer
        self.ref = ref

    def array(self, value):
        return jnp.asarray(value, jnp.float32) if self.ref else torch.tensor(
            value, dtype=torch.float32)

    def ones(self, shape):
        return jnp.ones(shape) if self.ref else torch.ones(shape)

    def zeros(self, shape):
        return jnp.zeros(shape) if self.ref else torch.zeros(shape)

    def init_loss_scale(self, policy):
        return (self.ops.init_loss_scale(policy) if self.ref
                else self.ops.init_loss_scale(policy, "cpu"))

    def linear_schedule(self, init, end, steps):
        if self.ref:
            return optax.linear_schedule(init, end, steps)
        return lambda count: init + (end - init) * min(count, steps) / steps

    def constant_schedule(self, value):
        return optax.constant_schedule(value) if self.ref else (lambda count: value)


@pytest.fixture(params=PACKAGES)
def pkg(request):
    return Pkg(request.param)


def test_optimizer_rejects_non_optax(pkg):
    pkg.state()
    with pytest.raises(TypeError):
        pkg.Optimizer(object())


def test_optimizer_rejects_a_torch_optimizer():
    """A ``torch.optim`` optimizer is not a port optimizer: TypeError, as
    the reference raises for anything but an optax transformation."""
    port.AcceleratorState(cpu=True)
    w = torch.nn.Parameter(torch.ones(2))
    with pytest.raises(TypeError, match="optimizer of the port"):
        port.AcceleratedOptimizer(torch.optim.SGD([w], lr=0.1))


def test_optimizer_keeps_its_scheduler_fn(pkg):
    pkg.state()
    schedule = pkg.constant_schedule(0.5)
    opt = pkg.Optimizer(pkg.sgd(0.1), scheduler_fn=schedule)
    assert opt.scheduler_fn is schedule
    assert pkg.Optimizer(pkg.sgd(0.1)).scheduler_fn is None


def test_optimizer_step_and_state(pkg):
    pkg.state()
    params = {"w": pkg.ones((4,)), "b": pkg.zeros(())}
    opt = pkg.Optimizer(pkg.sgd(0.1))
    grads = {"w": pkg.ones((4,)), "b": pkg.ones(())}
    new_params = opt.step(params, grads)
    np.testing.assert_allclose(np.asarray(new_params["w"]), 0.9, rtol=1e-6)
    assert not opt.step_was_skipped
    assert opt.state_dict() is opt.opt_state


def test_optimizer_skips_while_accumulating(pkg):
    pkg.state()
    gs = pkg.GradientState(pkg.Plugin(num_steps=2))
    gs.sync_gradients = False
    params = {"w": pkg.ones((4,))}
    opt = pkg.Optimizer(pkg.sgd(0.1))
    out = opt.step(params, {"w": pkg.ones((4,))})
    assert opt.step_was_skipped
    np.testing.assert_allclose(np.asarray(out["w"]), 1.0)


def test_loss_scale_roundtrip(pkg):
    policy = pkg.Policy.from_precision("fp16")
    ls = pkg.init_loss_scale(policy)
    loss = pkg.array(2.0)
    scaled = pkg.ops.scale_loss(loss, ls)
    assert float(scaled) == 2.0 * policy.loss_scale_init
    grads = {"w": pkg.array([float(ls.scale)] * 2)}
    unscaled, finite, new_ls = pkg.ops.unscale_and_check(grads, ls, policy)
    assert bool(finite)
    np.testing.assert_allclose(np.asarray(unscaled["w"]), 1.0)
    assert int(new_ls.fin_steps) == 1


def test_loss_scale_overflow_halves(pkg):
    policy = pkg.Policy.from_precision("fp16")
    ls = pkg.init_loss_scale(policy)
    grads = {"w": pkg.array([np.inf, 1.0])}
    _, finite, new_ls = pkg.ops.unscale_and_check(grads, ls, policy)
    assert not bool(finite)
    assert float(new_ls.scale) == policy.loss_scale_init / 2
    assert int(new_ls.growth_count) == 0


def test_loss_scale_growth(pkg):
    policy = pkg.Policy.from_precision("fp16")
    policy.loss_scale_growth_interval = 2
    ls = pkg.init_loss_scale(policy)
    grads = {"w": pkg.ones(2)}
    for _ in range(2):
        _, _, ls = pkg.ops.unscale_and_check(grads, ls, policy)
    assert float(ls.scale) == policy.loss_scale_init * 2


def test_scheduler_steps_with_num_processes(pkg):
    pkg.state()
    sched = pkg.Scheduler(pkg.linear_schedule(1.0, 0.0, 100))
    sched.step()
    assert sched.step_count == 1  # single process
    assert sched.get_last_lr()[0] == pytest.approx(1.0)


def test_scheduler_frozen_while_accumulating(pkg):
    pkg.state()
    gs = pkg.GradientState()
    gs.sync_gradients = False
    sched = pkg.Scheduler(pkg.constant_schedule(0.5))
    sched.step()
    assert sched.step_count == 0
    gs.sync_gradients = True
    sched.step()
    assert sched.step_count == 1


def test_scheduler_skips_on_optimizer_skip(pkg):
    pkg.state()
    opt = pkg.Optimizer(pkg.sgd(0.1))
    opt._step_was_skipped = True
    sched = pkg.Scheduler(pkg.constant_schedule(0.5), optimizers=opt)
    sched.step()
    assert sched.step_count == 0


def test_scheduler_state_dict(pkg):
    pkg.state()
    sched = pkg.Scheduler(pkg.constant_schedule(0.5))
    sched.step()
    state = sched.state_dict()
    sched2 = pkg.Scheduler(pkg.constant_schedule(0.5))
    sched2.load_state_dict(state)
    assert sched2.step_count == 1


def test_scheduler_step_count_is_read_only(pkg):
    sched = pkg.Scheduler(pkg.constant_schedule(0.5))
    with pytest.raises(AttributeError):
        sched.step_count = 3


def test_scheduler_steps_by_the_process_count_at_world_two(tmp_path):
    """At world 2 one synced step advances the count by the process count
    (2), by 1 under ``split_batches``; a step while accumulating by nothing:
    the reference's rule (its ``scheduler.py:56-63``). On the parent the
    port advanced by 1 on every synced step."""
    from accelerate_tpu_torch.launchers import debug_launcher
    from accelerate_tpu_torch.test_utils.scripts import multiprocess_worker as workers

    debug_launcher(workers.scheduler_worker, (str(tmp_path),), num_processes=2, timeout=60.0)
    for rank in range(2):
        got = json.loads((tmp_path / f"scheduler_{rank}.json").read_text())
        assert got == {"num_processes": 2, "plain": 2, "split": 1}, (rank, got)
