"""The Accelerator's one-process surface and ``PartialState``'s helpers in
the port, against the JAX reference, on the CPU.

Mirrors ``tests/test_accelerator.py``'s ``test_prepare_dispatch_and_scheduler``
(:207), ``test_trigger_roundtrip`` (:279), ``test_get_state_dict_full_host_copy``
(:287, without the sharding plugin: queue A7) and
``test_memory_utils_shim_warns`` (:302), and ``tests/test_state.py``'s
``test_wait_for_everyone_noop`` (:32) and ``test_split_between_processes_single``
(:36), each run on both packages where the reference's runs here. Then
every attribute the reference's ``Accelerator`` has at world size 1
(``accelerator.py:207-290``, :408, :416, :1343, :1565-1591) on the port's
``Accelerator(cpu=True)``, with the reference's answers, and the
multi-process forms of the helpers against the reference's.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
from accelerate_tpu.test_utils.training import RegressionDataset  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.state import PartialState  # noqa: E402


@pytest.fixture(autouse=True)
def reset_singletons():
    def reset():
        port.AcceleratorState._reset_state(reset_partial_state=True)
        port.GradientState._reset_state()
        jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
        jax_pkg.state.GradientState._reset_state()

    reset()
    yield
    reset()


def test_prepare_dispatch_and_scheduler():
    """A params dict, an optimizer, a loader and a schedule through
    ``prepare``: the optimizer is wrapped with its state made for the
    params, the schedule becomes a scheduler that steps, and its learning
    rates are the reference's."""
    acc = port.Accelerator(cpu=True)
    loader = port.DataLoader(RegressionDataset(length=16), batch_size=8)
    p, opt, l, sched = acc.prepare({"w": torch.tensor(0.0)}, port.sgd(0.1), loader,
                                   lambda count: 1.0 - count / 10)
    assert isinstance(opt, port.AcceleratedOptimizer)
    assert isinstance(sched, port.AcceleratedScheduler)
    assert opt.opt_state is not None and set(p) == {"w"}
    sched.step()
    assert sched.step_count == 1
    ref = jax_pkg.Accelerator()
    _, ropt, _, rsched = ref.prepare({"w": jnp.asarray(0.0)}, optax.sgd(0.1),
                                     jax_pkg.DataLoader(RegressionDataset(length=16),
                                                        batch_size=8),
                                     optax.linear_schedule(1.0, 0.0, 10))
    rsched.step()
    assert rsched.step_count == sched.step_count
    np.testing.assert_allclose(sched.get_last_lr(), rsched.get_last_lr(), rtol=1e-7)
    assert acc._optimizers == [opt] and acc._schedulers == [sched]


def test_trigger_roundtrip():
    for acc in (port.Accelerator(cpu=True), jax_pkg.Accelerator()):
        assert not acc.check_trigger()
        acc.set_trigger()
        assert acc.check_trigger()
        assert not acc.check_trigger()


def test_get_state_dict_full_host_copy():
    """A nested params tree as a full named host dict, the reference's
    names (the reference's test shards it over 8 devices first, queue A7)."""
    acc = port.Accelerator(cpu=True)
    params = acc.prepare({"layer": {"kernel": torch.arange(64.0).reshape(8, 8)}})
    sd = acc.get_state_dict(params)
    want = jax_pkg.Accelerator().get_state_dict({"layer": {"kernel": jnp.arange(64.0).reshape(8,
                                                                                              8)}})
    assert set(sd) == set(want) == {"layer//kernel"}
    np.testing.assert_array_equal(sd["layer//kernel"].numpy(), np.asarray(want["layer//kernel"]))


def test_memory_utils_shim_warns():
    import importlib
    import warnings

    import accelerate_tpu_torch.memory_utils as mu

    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        importlib.reload(mu)
    assert any(issubclass(x.category, FutureWarning) for x in w)
    assert mu.find_executable_batch_size is port.find_executable_batch_size


def test_wait_for_everyone_noop():
    PartialState(cpu=True).wait_for_everyone()
    jax_pkg.PartialState().wait_for_everyone()


def test_split_between_processes_single():
    for state in (PartialState(cpu=True), jax_pkg.PartialState()):
        with state.split_between_processes([1, 2, 3]) as chunk:
            assert chunk == [1, 2, 3]
        with state.split_between_processes({"a": [1, 2]}, apply_padding=True) as chunk:
            assert chunk == {"a": [1, 2]}


_PROPERTIES = ("distributed_type", "num_processes", "process_index", "local_process_index",
               "is_main_process", "is_local_main_process", "is_last_process",
               "mixed_precision", "use_distributed", "project_dir")


@pytest.mark.parametrize("mixed_precision", ["no", "bf16"])
def test_one_process_properties_match_the_reference(mixed_precision, tmp_path):
    acc = port.Accelerator(mixed_precision=mixed_precision, project_dir=str(tmp_path), cpu=True)
    ref = jax_pkg.Accelerator(mixed_precision=mixed_precision, project_dir=str(tmp_path))
    got = {name: getattr(acc, name) for name in _PROPERTIES}
    want = {name: getattr(ref, name) for name in _PROPERTIES}
    # the reference's 8 virtual CPU devices make it "distributed" over a
    # mesh; one process on one device is not
    assert got.pop("distributed_type") == port.utils.dataclasses.DistributedType.NO
    assert got.pop("use_distributed") is False
    want.pop("distributed_type"), want.pop("use_distributed")
    assert got == want
    assert acc.mixed_precision == mixed_precision
    text = repr(acc)
    assert text.startswith("Accelerator(\n") and f"Mixed precision: {mixed_precision}" in text
    assert repr(ref).startswith("Accelerator(\n")


def test_process_helpers_at_world_size_one(capsys):
    acc = port.Accelerator(cpu=True)
    ran = []
    assert acc.on_main_process(lambda: ran.append("main") or 1)() == 1
    assert acc.on_local_main_process(lambda: ran.append("local"))() is None
    assert acc.on_process(lambda: ran.append("p0"), process_index=0)() is None
    assert acc.on_process(lambda: ran.append("p1"), process_index=1)() is None
    with acc.main_process_first():
        ran.append("first")
    with acc.local_main_process_first():
        ran.append("local_first")
    with acc.split_between_processes(list(range(5)), apply_padding=True) as chunk:
        assert chunk == list(range(5))
    acc.wait_for_everyone()
    acc.print("printed")
    assert ran == ["main", "local", "p0", "first", "local_first"]
    assert capsys.readouterr().out == "printed\n"
    with acc.autocast():  # a no-op context, as in the reference
        x = torch.ones(2) * 2
    assert x.dtype == torch.float32


def test_prepare_optimizer_and_scheduler_are_prepare_s_own(tmp_path):
    """``prepare_optimizer`` wraps and registers (and makes the state for
    the params given, a module or a nested tree), ``prepare_scheduler``
    wraps a schedule that steps with the registered optimizers; ``prepare``
    goes through both."""
    acc = port.Accelerator(cpu=True)
    model = port.CausalLM(port.TransformerConfig.tiny(num_layers=1, max_seq_len=16),
                          device="cpu")
    opt = acc.prepare_optimizer(port.adamw(1e-3), model)
    assert acc._optimizers == [opt] and set(opt.opt_state["mu"]) == set(
        dict(model.named_parameters()))
    tree = {"q_proj": {"lora_a": torch.zeros(1, 4, 2), "lora_b": torch.zeros(1, 2, 4)}}
    opt2 = acc.prepare_optimizer(opt.optimizer, tree)
    assert set(opt2.opt_state["mu"]) == {"q_proj.lora_a", "q_proj.lora_b"}
    sched = acc.prepare_scheduler(lambda count: 0.5)
    assert acc._schedulers == [sched] and sched.get_last_lr() == [0.5]


def test_multi_process_branches_raise_naming_a4():
    """The multi-process forms are ported: seen from process 1 of 2 (the
    state's topology set as a second process would see it, no group), the
    barrier has no group to wait on, and ``split_between_processes`` gives
    the reference's share of a list, a padded list and a dict."""
    state = PartialState(cpu=True)
    state.num_processes, state.process_index = 2, 1
    ref = jax_pkg.state.PartialState()
    ref.num_processes, ref.process_index = 2, 1
    try:
        state.wait_for_everyone()
        for inputs, pad in ((list(range(5)), False), (list(range(5)), True),
                            ({"a": [1, 2, 3], "b": [4, 5, 6]}, True)):
            with state.split_between_processes(inputs, apply_padding=pad) as mine, \
                    ref.split_between_processes(inputs, apply_padding=pad) as theirs:
                assert mine == theirs
        with state.split_between_processes(list(range(5)), apply_padding=True) as mine:
            assert mine == [3, 4, 4]
        assert state.is_last_process and state.use_distributed
    finally:
        PartialState._reset_state()
        jax_pkg.state.PartialState._reset_state()
