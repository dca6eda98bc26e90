"""The port's raw-loop API against the JAX reference's, on the CPU.

``accumulate``, ``no_sync``, ``backward`` (loss and gradients scaled by
1/K), ``clip_grad_norm_``, ``clip_grad_value_``, ``AcceleratedOptimizer``'s
``step`` on and off sync boundaries with ``step_was_skipped``,
``AcceleratedScheduler``'s skip and ``step_with_optimizer``, the early-stop
trigger, ``free_memory``, ``find_executable_batch_size`` on an
out-of-memory error, and ``sgd`` against ``optax.sgd``.

Tolerances: fp32, 2e-5 relative (absolute on gradients of a tiny
CausalLM, whose entries sit near 1e-3); the sync pattern, the counters and
the batch sizes tried are exact; ``sgd`` bitwise over 3 steps.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu.models.config import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.scheduler import AcceleratedScheduler as JaxScheduler  # noqa: E402
from accelerate_tpu.utils import memory as jax_memory  # noqa: E402
from accelerate_tpu.utils.dataclasses import GradientAccumulationPlugin as JaxPlugin  # noqa: E402
from accelerate_tpu_torch.utils import memory  # noqa: E402

BATCH = 8  # divisible by the 8 virtual CPU devices of tests/conftest.py
MODEL = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_layers=2,
             num_heads=4, num_kv_heads=2, max_seq_len=64)
SEQ = 16


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


class Tokens:
    def __init__(self, n, seed=0):
        self.ids = np.random.default_rng(seed).integers(
            0, MODEL["vocab_size"], size=(n, SEQ)).astype(np.int32)

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i]}


def _models():
    jmodel = JaxCausalLM(JaxConfig(**MODEL))
    init = jax.tree.map(np.asarray, nn.unbox(jmodel.init_params(jax.random.PRNGKey(0),
                                                                seq_len=SEQ)))
    pmodel = port.CausalLM(port.TransformerConfig(**MODEL), device="cpu")
    pmodel.load_state_dict(port.params_from_jax(init, pmodel.config), strict=True)
    return jmodel, init, pmodel


@pytest.mark.parametrize("plugin", [dict(num_steps=2), dict(num_steps=2, sync_each_batch=True),
                                    dict(num_steps=2, sync_with_dataloader=False)])
def test_accumulate_sync_pattern_matches_reference(plugin):
    """Five batches at K 2: ``sync_gradients`` inside ``accumulate`` on
    every call, the last batch of the loader included (``sync_with_dataloader``),
    and ``step`` after the loop, as the reference sets them."""
    ds = Tokens(5 * BATCH)
    pacc = port.Accelerator(cpu=True, gradient_accumulation_plugin=(
        port.GradientAccumulationPlugin(**plugin)))
    jacc = jax_pkg.Accelerator(gradient_accumulation_plugin=JaxPlugin(**plugin))
    patterns = []
    for acc, loader in ((pacc, pacc.prepare(port.DataLoader(ds, batch_size=BATCH))),
                        (jacc, jacc.prepare(jax_pkg.DataLoader(ds, batch_size=BATCH)))):
        seen = []
        for _ in loader:
            with acc.accumulate():
                seen.append(acc.sync_gradients)
        with acc.no_sync():
            assert acc.sync_gradients is False
        assert acc.sync_gradients == seen[-1]  # restored
        patterns.append((seen, acc.step))
    assert patterns[0] == patterns[1]


def test_backward_loss_and_scaled_grads_match_reference():
    jmodel, init, pmodel = _models()
    ids = Tokens(BATCH).ids
    pacc = port.Accelerator(cpu=True, gradient_accumulation_steps=4)
    jacc = jax_pkg.Accelerator(gradient_accumulation_steps=4)
    ploss, pgrads = pacc.backward(port.CausalLM.loss_fn(pmodel), pmodel,
                                  {"input_ids": torch.from_numpy(ids)})
    jloss, jgrads = jacc.backward(JaxCausalLM.loss_fn(jmodel), jax.tree.map(jnp.asarray, init),
                                  {"input_ids": jnp.asarray(ids)})
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=2e-5)
    want = port.params_from_jax(jax.tree.map(np.asarray, jgrads), pmodel.config)
    assert set(pgrads) == set(want)
    for name, g in pgrads.items():
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), atol=2e-5, err_msg=name)
    # 1/K scaling: the unscaled gradient is 4x
    _, full = port.Accelerator(cpu=True).backward(port.CausalLM.loss_fn(pmodel), pmodel,
                                                  {"input_ids": torch.from_numpy(ids)})
    name = "layers.0.attn.q_proj.weight"
    torch.testing.assert_close(full[name] * 0.25, pgrads[name])
    for acc, loss in ((pacc, ploss), (jacc, jnp.asarray(1.0))):
        with pytest.raises(TypeError, match="loss \\*function\\*"):
            acc.backward(loss)


def test_clip_grad_norm_and_value_match_reference():
    rng = np.random.default_rng(0)
    grads = {"a": rng.normal(size=(4, 3)).astype(np.float32),
             "b": rng.normal(size=(5,)).astype(np.float32)}
    pacc, jacc = port.Accelerator(cpu=True), jax_pkg.Accelerator()
    pt = {k: torch.from_numpy(v) for k, v in grads.items()}
    jt = {k: jnp.asarray(v) for k, v in grads.items()}
    for max_norm in (0.5, 100.0):
        pc, pn = pacc.clip_grad_norm_(pt, max_norm)
        jc, jn = jacc.clip_grad_norm_(jt, max_norm)
        np.testing.assert_allclose(float(pn), float(jn), rtol=2e-5)
        for k in grads:
            np.testing.assert_allclose(pc[k].numpy(), np.asarray(jc[k]), rtol=2e-5)
    pv, jv = pacc.clip_grad_value_(pt, 0.3), jacc.clip_grad_value_(jt, 0.3)
    for k in grads:
        np.testing.assert_array_equal(pv[k].numpy(), np.asarray(jv[k]))


@pytest.mark.parametrize("max_norm", [0.3, 1.0, 1.7])
def test_clip_scale_divides_as_the_reference(max_norm):
    """The clip's scale min(1, max_norm / (norm + 1e-6)), shared by the
    step's epilogue and ``clip_grad_norm_``, bit for bit the reference's
    over 10,000 norms: a float over a tensor is a reciprocal times the float
    in PyTorch, which differed from the division in a quarter of them."""
    from accelerate_tpu_torch.accelerator import _clip_scale

    norms = np.random.default_rng(0).uniform(0.01, 100.0, 10_000).astype(np.float32)
    got = _clip_scale(torch.from_numpy(norms), max_norm).numpy()
    want = np.asarray(jnp.minimum(1.0, max_norm / (jnp.asarray(norms) + 1e-6)))
    np.testing.assert_array_equal(got, want)


def test_raw_loop_matches_reference():
    """``accumulate`` + ``backward`` + ``optimizer.step`` + the scheduler, K 2
    over 5 batches with sgd: the params after the loop, which steps were
    skipped, and the schedulers' counts equal the reference's."""
    jmodel, init, pmodel = _models()
    ds = Tokens(5 * BATCH)
    schedule = lambda count: 0.5 / (1 + count)  # noqa: E731
    results = {}
    for name in ("port", "jax"):
        _reset()
        if name == "port":
            acc = port.Accelerator(cpu=True, gradient_accumulation_steps=2)
            opt, loader = acc.prepare(port.sgd(0.5), port.DataLoader(ds, batch_size=BATCH))
            params = dict(pmodel.named_parameters())
            loss_fn = port.CausalLM.loss_fn(pmodel)
            sched = port.AcceleratedScheduler(schedule, optimizers=[opt])
            add = lambda a, b: {k: a[k] + b[k] for k in a}  # noqa: E731
        else:
            acc = jax_pkg.Accelerator(gradient_accumulation_steps=2)
            params, opt, loader = acc.prepare(jax.tree.map(jnp.asarray, init), optax.sgd(0.5),
                                              jax_pkg.DataLoader(ds, batch_size=BATCH))
            loss_fn = JaxCausalLM.loss_fn(jmodel)
            sched = JaxScheduler(schedule, optimizers=[opt])
            add = lambda a, b: jax.tree.map(lambda x, y: x + y, a, b)  # noqa: E731
        accum, skipped, counts, losses = None, [], [], []
        for batch in loader:
            with acc.accumulate():
                loss, grads = acc.backward(loss_fn, params, batch)
                accum = grads if accum is None else add(accum, grads)
                params = opt.step(params, accum)
                skipped.append(opt.step_was_skipped)
                sched.step()
                counts.append(sched.step_count)
                losses.append(float(loss))
                if acc.sync_gradients:
                    accum = None
                    opt.zero_grad()
        results[name] = (params, skipped, counts, losses)
    (pp, ps, pc, pl), (jp, js, jc, jl) = results["port"], results["jax"]
    assert ps == js == [True, False, True, False, False]  # the last batch syncs with the loader
    assert pc == jc == [0, 1, 1, 2, 3]
    np.testing.assert_allclose(pl, jl, rtol=2e-5)
    want = port.params_from_jax(jax.tree.map(np.asarray, jp), pmodel.config)
    for name, value in want.items():
        np.testing.assert_allclose(pp[name].detach().numpy(), value.numpy(), atol=2e-5,
                                   err_msg=name)


@pytest.mark.parametrize("step_with_optimizer,split_batches", [(True, False), (False, False),
                                                               (True, True)])
def test_scheduler_counts_match_reference(step_with_optimizer, split_batches):
    """Sync pattern F T F T and a skipped optimizer step on the third sync:
    the counts of both schedulers, call by call."""

    class Opt:
        step_was_skipped = False

    counts = {}
    for name, cls, gs in (("port", port.AcceleratedScheduler, port.GradientState()),
                          ("jax", JaxScheduler, jax_pkg.state.GradientState())):
        jax_pkg.state.AcceleratorState()  # the reference reads its process count
        opt = Opt()
        sched = cls(lambda c: 1.0, optimizers=opt, step_with_optimizer=step_with_optimizer,
                    split_batches=split_batches)
        seen = []
        for sync, skip in ((False, False), (True, False), (False, False), (True, True),
                           (True, False)):
            gs.sync_gradients = sync
            opt.step_was_skipped = skip
            sched.step()
            seen.append(sched.step_count)
        counts[name] = seen
    assert counts["port"] == counts["jax"]


def test_optimizer_step_applies_only_on_sync_boundaries():
    acc = port.Accelerator(cpu=True)
    opt = acc.prepare(port.sgd(1.0))
    params = {"w": torch.tensor([1.0, 2.0])}
    grads = {"w": torch.tensor([0.5, 0.5])}
    acc.gradient_state.sync_gradients = False
    assert opt.step(params, grads) is params and opt.step_was_skipped
    torch.testing.assert_close(params["w"], torch.tensor([1.0, 2.0]))
    acc.gradient_state.sync_gradients = True
    opt.step(params, grads)
    assert not opt.step_was_skipped and opt.opt_state["count"] == 1
    torch.testing.assert_close(params["w"], torch.tensor([0.5, 1.5]))


def test_sgd_matches_optax_bitwise():
    rng = np.random.default_rng(0)
    p0 = {"a": rng.normal(size=(7, 5)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    for lr in (3e-4, lambda count: 0.1 * 0.5 ** count):
        tx = optax.sgd(lr)
        jp = {k: jnp.asarray(v) for k, v in p0.items()}
        state = tx.init(jp)
        opt = port.sgd(lr)
        pp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
        pstate = opt.init(pp)
        for step in range(3):
            g = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
            updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
            jp = optax.apply_updates(jp, updates)
            opt.apply_({k: torch.from_numpy(v) for k, v in g.items()}, pstate, pp)
            for k in p0:
                np.testing.assert_array_equal(pp[k].numpy(), np.asarray(jp[k]), err_msg=k)
        assert pstate["count"] == 3


def test_trigger_matches_reference():
    for acc in (port.Accelerator(cpu=True), jax_pkg.Accelerator()):
        assert acc.check_trigger() is False
        acc.set_trigger()
        assert acc.check_trigger() is True
        assert acc.check_trigger() is False  # reset by the check


def test_free_memory_drops_what_was_prepared():
    acc = port.Accelerator(cpu=True)
    model = port.CausalLM(port.TransformerConfig(**MODEL), device="cpu")
    model, opt, loader = acc.prepare(model, port.sgd(0.1),
                                     port.DataLoader(Tokens(BATCH), batch_size=BATCH))
    acc.step = 7
    assert acc.free_memory(model, opt) == [None, None]
    assert acc._optimizers == acc._schedulers == acc._dataloaders == [] and acc.step == 0


def test_find_executable_batch_size_halves_on_oom():
    """A CUDA out-of-memory error (``torch.OutOfMemoryError``, or CUDA's
    message in a RuntimeError) halves the batch size and calls again, as
    the reference does on XLA's RESOURCE_EXHAUSTED; the size found is kept
    for the next call; anything else propagates."""
    tried = {"port": [], "jax": []}

    def body(name, error):
        def train(batch_size, fits):
            tried[name].append(batch_size)
            if batch_size > fits:
                raise error
            return batch_size
        return train

    got = memory.find_executable_batch_size(
        body("port", torch.OutOfMemoryError("CUDA out of memory. Tried to allocate 2 GiB")),
        starting_batch_size=64)(12)
    want = jax_memory.find_executable_batch_size(
        body("jax", RuntimeError("RESOURCE_EXHAUSTED: out of memory")),
        starting_batch_size=64)(12)
    assert got == want == 8 and tried["port"] == tried["jax"] == [64, 32, 16, 8]
    assert memory.should_reduce_batch_size(RuntimeError("CUDA error: out of memory"))
    assert memory.should_reduce_batch_size(RuntimeError("CUBLAS_STATUS_ALLOC_FAILED when ..."))
    assert not memory.should_reduce_batch_size(ValueError("CUDA out of memory"))

    @memory.find_executable_batch_size(starting_batch_size=4)
    def never_fits(batch_size):
        raise torch.OutOfMemoryError("CUDA out of memory.")

    with pytest.raises(RuntimeError, match="reached zero"):
        never_fits()

    @memory.find_executable_batch_size(starting_batch_size=4)
    def broken(batch_size):
        raise KeyError("not an OOM")

    with pytest.raises(KeyError):
        broken()

    @memory.find_executable_batch_size
    def misnamed(size):
        return size

    with pytest.raises(TypeError, match="batch_size"):
        misnamed()
