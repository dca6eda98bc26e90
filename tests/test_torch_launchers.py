"""The port's launchers and its multi-process paths over gloo on the CPU.

Mirrors ``tests/test_launchers.py``'s seven tests (the reference marks six of
them slow because each JAX child recompiles; the port's children import
torch and the port only, so they run here in tier 1): the notebook launcher
at one and at two processes, the collectives, training and local-SGD
workers, the whole assertion script at world 2 and 4, and the
sharded-checkpoint worker, each process writing its own chunk. Then:

* a rank that never reaches a collective makes the launch raise within the
  group's timeout, instead of hanging;
* ``test_two_ranks_equal_the_reference_on_the_global_batch``: two processes
  train the tiny fp32 ``CausalLM`` 3 steps (sgd, clip 1.0) on global
  batches whose two halves hold different ``loss_mask`` counts; the
  reference's single-process ``unified_step`` on the same global batches
  from the same weights (``params_from_jax``) gives the same losses, grad
  norms and params within 2e-5, where a mean of per-process means would not;
* the world-2 checkpoint those processes saved: each process's RNG file,
  the done markers and ``world_size`` 2 in the topology; the load at world 2
  bit for bit (in the workers); at world 1 the reference's refusal without
  ``allow_reshape`` and a bitwise load with it, in the port and in the
  reference;
* ``test_two_ranks_train_an_adapter_on_the_global_batch``: the same for a
  LoRA adapter on the frozen tiny model, over the plain base and over its
  int8 quantization, against the reference's single-process lora
  ``unified_step``.
"""

import os
import threading
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402
from flax import linen as nn  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu.adapters as jax_adapters  # noqa: E402
from accelerate_tpu.utils import quantization as jax_quant  # noqa: E402
from accelerate_tpu.checkpointing import flatten_tree as jax_flatten  # noqa: E402
from accelerate_tpu.launchers import notebook_launcher as jax_notebook_launcher  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch import checkpointing as ckpt  # noqa: E402
from accelerate_tpu_torch import dist_checkpoint  # noqa: E402
from accelerate_tpu_torch.checkpoint_async import commit as commit_mod  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher, notebook_launcher  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import multiprocess_worker as workers  # noqa: E402
from accelerate_tpu_torch.test_utils.training import TINY_LM, TINY_SEQ, MaskedTokens  # noqa: E402

TOL = 2e-5  # fp32 on the CPU, the port's parity tolerance
STEPS, ROWS = 3, 4  # 3 steps of 2 processes x 4 rows: the reference's global batch of 8


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


def test_notebook_launcher_single_process():
    assert notebook_launcher(lambda x: x * 2, (21,), num_processes=1) == 42
    assert jax_notebook_launcher(lambda x: x * 2, (21,), num_processes=1) == 42


def _precision_seen():
    return port.Accelerator(cpu=True).mixed_precision


def test_notebook_launcher_mixed_precision_reaches_the_accelerator(monkeypatch):
    """The launcher's ``mixed_precision`` reaches an Accelerator made
    without one, through ``ACCELERATE_TPU_MIXED_PRECISION``, as in the
    reference (ROADMAP queue C: the port's AcceleratorState did not read
    the variable, so such a run trained in fp32)."""
    monkeypatch.setenv("ACCELERATE_TPU_MIXED_PRECISION", "no")  # restored after the test
    assert notebook_launcher(_precision_seen, num_processes=1, mixed_precision="bf16") == "bf16"
    _reset()
    assert jax_notebook_launcher(lambda: jax_pkg.Accelerator().mixed_precision,
                                 num_processes=1, mixed_precision="bf16") == "bf16"
    _reset()
    assert port.Accelerator(cpu=True, mixed_precision="fp16").mixed_precision == "fp16"


def test_notebook_launcher_multi_process():
    """Two processes run real collectives over gloo when the caller asks for
    the CPU; without ``cpu=True`` nothing moves off the card unasked."""
    notebook_launcher(workers.collective_worker, num_processes=2, cpu=True)
    with pytest.raises(ValueError, match="cpu=True"):
        notebook_launcher(workers.collective_worker, num_processes=2)


def test_debug_launcher_collectives():
    debug_launcher(workers.collective_worker, num_processes=2)


def test_debug_launcher_training():
    debug_launcher(workers.training_worker, num_processes=2)


def test_debug_launcher_sharded_checkpoint(tmp_path):
    """The reference's worker at world 2: each process writes only its own
    chunk of an fsdp-2 leaf (half the data each), and a restore reads each
    rank's chunk back onto the live sharding."""
    debug_launcher(workers.sharded_checkpoint_worker, (str(tmp_path),), num_processes=2)
    named = dist_checkpoint.load_full_named(str(tmp_path))
    assert torch.equal(named["k"], torch.arange(64.0).reshape(8, 8))
    assert dist_checkpoint.validate_coverage(str(tmp_path)) == {"leaves": 1, "chunks": 2,
                                                                "files": 2}


def test_debug_launcher_local_sgd():
    debug_launcher(workers.local_sgd_worker, num_processes=2)


@pytest.mark.parametrize("world", [2, 4])
def test_debug_launcher_full_test_script(world):
    from accelerate_tpu_torch.test_utils.scripts.test_script import run_all_checks

    debug_launcher(run_all_checks, num_processes=world)


def test_hung_collective_raises_within_its_timeout():
    """Rank 0 waits in an all-reduce that rank 1 never joins: the group's
    3 s timeout ends it with an error and the launch raises, once rank 1
    has slept its 6 s, instead of hanging."""
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=r"\(0, 1\)"):
        debug_launcher(workers.hang_worker, (6.0,), num_processes=2, timeout=3)
    assert time.monotonic() - t0 < 60


def test_launch_without_its_group_raises():
    """A launch asked for 2 processes whose rendezvous never completes (the
    second process never starts) raises after the timeout: no fallback to
    one process."""
    import datetime

    from accelerate_tpu_torch.state import PartialState
    from accelerate_tpu_torch.utils.dataclasses import DistributedInitKwargs

    kwargs = DistributedInitKwargs(coordinator_address=f"127.0.0.1:{_free_port()}",
                                   num_processes=2, process_id=0,
                                   initialization_timeout=datetime.timedelta(seconds=2))
    with pytest.raises(Exception, match="(?i)timed? ?out|timeout"):
        PartialState(cpu=True, init_kwargs=kwargs)
    assert not PartialState._shared_state  # nothing was left half set up


def _free_port():
    from accelerate_tpu_torch.launchers import _free_port

    return _free_port()


# ---------------------------------------------------------------------- #
# two processes against the reference's global batch
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def world_two(tmp_path_factory):
    """The tiny CausalLM's weights made by the reference, handed to two
    port processes that train, save and reload; returns their directory
    and the reference's initial params."""
    out = tmp_path_factory.mktemp("world2")
    jmodel = JaxCausalLM(JaxConfig(**TINY_LM))
    init = jax.tree.map(np.asarray, nn.unbox(jmodel.init_params(jax.random.PRNGKey(0),
                                                                seq_len=TINY_SEQ)))
    cfg = port.TransformerConfig(**TINY_LM)
    torch.save(dict(port.params_from_jax(init, cfg)), os.path.join(out, "init.pt"))
    debug_launcher(workers.tiny_lm_worker, (str(out), STEPS, ROWS), num_processes=2)
    ranks = [torch.load(os.path.join(out, f"rank{r}.pt")) for r in range(2)]
    return out, init, ranks


def _reference_run(init):
    """The reference's single-process unified_step on the global batches."""
    acc = jax_pkg.Accelerator()
    jmodel = JaxCausalLM(JaxConfig(**TINY_LM))
    params, opt, loader = acc.prepare(jax.tree.map(jnp.asarray, init), optax.sgd(0.5),
                                      jax_pkg.DataLoader(MaskedTokens(STEPS * 2 * ROWS, ROWS),
                                                         batch_size=2 * ROWS))
    step = acc.unified_step(JaxCausalLM.loss_fn(jmodel), opt, max_grad_norm=1.0)
    carry = acc.init_carry(params, opt)
    losses, norms = [], []
    for batch in loader:
        carry, metrics = step(carry, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    return losses, norms, jax.tree.map(np.asarray, carry["params"]), acc, carry


def test_two_ranks_equal_the_reference_on_the_global_batch(world_two):
    out, init, (r0, r1) = world_two
    # the two processes held different mask counts at every step
    assert all(a != b for a, b in zip(r0["mask_counts"], r1["mask_counts"]))
    # and the two ranks agree with each other bit for bit
    assert r0["losses"] == r1["losses"] and r0["norms"] == r1["norms"]
    for k, v in r0["params"].items():
        assert torch.equal(v, r1["params"][k]), k
    losses, norms, params, _, _ = _reference_run(init)
    np.testing.assert_allclose(r0["losses"], losses, rtol=TOL)
    np.testing.assert_allclose(r0["norms"], norms, rtol=TOL)
    want = port.params_from_jax(params, port.TransformerConfig(**TINY_LM))
    for k, v in want.items():
        np.testing.assert_allclose(r0["params"][k].numpy(), v.numpy(), atol=TOL, err_msg=k)
    # the case is one a mean of per-process means gets wrong
    model = port.CausalLM(port.TransformerConfig(**TINY_LM), device="cpu")
    model.load_state_dict(torch.load(os.path.join(out, "init.pt")))
    data = MaskedTokens(2 * ROWS, ROWS)
    halves = [{k: torch.from_numpy(np.stack([data[i][k] for i in rows]))
               for k in ("input_ids", "loss_mask")}
              for rows in (range(ROWS), range(ROWS, 2 * ROWS))]
    fn = port.CausalLM.loss_fn(model)
    params0 = dict(model.named_parameters())
    with torch.no_grad():
        mean_of_means = float(sum(fn(params0, h) for h in halves)) / 2
    assert abs(mean_of_means - losses[0]) > 100 * TOL * abs(losses[0])


def test_world_two_checkpoint_loads_at_world_one_and_in_the_reference(world_two):
    out, init, (r0, _) = world_two
    path = os.path.join(out, "ckpt")
    names = set(os.listdir(path))
    assert {"random_states_0.pkl", "random_states_1.pkl", "done_00000", "done_00001",
            "COMMITTED", "state_shard_00000.safetensors", "state_shard_00001.safetensors",
            "state_index_00000.json", "state_index_00001.json"} <= names
    topo = commit_mod.read_topology(path)
    assert topo["world_size"] == 2 and set(topo["process_shard_files"]) == {"0", "1"}
    assert dist_checkpoint.validate_coverage(path)["files"] == 1  # process 0 owns every leaf

    def fresh():
        acc = port.Accelerator(cpu=True)
        model = port.CausalLM(port.TransformerConfig(**TINY_LM), device="cpu",
                              generator=torch.Generator().manual_seed(5))
        model, opt = acc.prepare(model, port.sgd(0.5))
        return acc, acc.init_carry(model, opt)

    acc, carry = fresh()
    before = {k: v.clone() for k, v in carry["params"].items()}
    with pytest.raises(ValueError, match="different topology.*world size 2 -> 1"):
        acc.load_state(path, carry=carry)
    for k, v in before.items():  # the refusal changed nothing
        assert torch.equal(carry["params"][k], v), k
    restored = acc.load_state(path, carry=carry, allow_reshape=True)
    for k, v in r0["params"].items():
        assert torch.equal(restored["params"][k], v), k
    assert restored["opt_step"] == STEPS and acc.step == STEPS
    saved = dist_checkpoint.load_full_named(path)
    flat = ckpt.flatten_tree(restored)
    for k, v in saved.items():
        assert torch.equal(torch.as_tensor(flat[k]).reshape(v.shape), v), k

    # the reference loads it too: under its names, in the world-2 layout
    _, _, _, jacc, jcarry = _reference_run(init)
    like = {k: np.asarray(v) for k, v in jax_flatten(jcarry).items()}
    named = port.carry_to_jax(saved, like)
    ref_dir = str(out / "as_ref")
    work = commit_mod.work_dir_for(ref_dir)
    dist_checkpoint.save_sharded_tree(named, work, process_index=0)
    dist_checkpoint.save_sharded_tree(named, work, process_index=1)
    other = threading.Thread(target=commit_mod.commit, args=(work, ref_dir, 1, 2))
    other.start()
    commit_mod.commit(work, ref_dir, 0, 2, topology=topo)
    other.join()
    with pytest.raises(ValueError, match="different topology"):
        jacc.load_state(ref_dir, carry=jcarry)
    loaded = jacc.load_state(ref_dir, carry=jcarry, allow_reshape=True)
    for k, v in jax_flatten(loaded).items():
        if k in named:
            assert np.array_equal(np.asarray(v), named[k]), k


# ---------------------------------------------------------------------- #
# two processes training an adapter against the reference's global batch
# ---------------------------------------------------------------------- #
_LORA = dict(rank=4, alpha=8.0, target_modules=("q_proj", "v_proj"))


@pytest.fixture(scope="module")
def world_two_lora(tmp_path_factory):
    """The reference's tiny weights and a q/v adapter with a nonzero B,
    handed to two port processes that train it over the plain and the int8
    base; returns the reference's weights and adapter and both ranks'
    records."""
    out = tmp_path_factory.mktemp("world2_lora")
    jcfg = JaxConfig(**TINY_LM)
    init = jax.tree.map(np.asarray, nn.unbox(JaxCausalLM(jcfg).init_params(
        jax.random.PRNGKey(0), seq_len=TINY_SEQ)))
    ad = jax_adapters.init_adapter(jax.random.PRNGKey(1), jcfg, jax_adapters.LoraConfig(**_LORA))
    ad = jax.tree.map(np.asarray, {
        t: {"lora_a": pair["lora_a"],
            "lora_b": 0.05 * jax.random.normal(jax.random.PRNGKey(7 + i), pair["lora_b"].shape)}
        for i, (t, pair) in enumerate(sorted(ad.items()))})
    cfg = port.TransformerConfig(**TINY_LM)
    torch.save(dict(port.params_from_jax(init, cfg)), os.path.join(out, "init.pt"))
    torch.save(port.params_from_jax(ad, cfg), os.path.join(out, "adapter.pt"))
    debug_launcher(workers.tiny_lora_worker, (str(out), STEPS, ROWS), num_processes=2)
    ranks = [torch.load(os.path.join(out, f"lora_rank{r}.pt")) for r in range(2)]
    return init, ad, ranks


@pytest.mark.parametrize("base", ["lora", "qlora"])
def test_two_ranks_train_an_adapter_on_the_global_batch(world_two_lora, base):
    """LoRA (and QLoRA over the int8 base) at world 2 with different mask
    counts in each process: the losses, grad norms and adapter are those of
    the reference's single-process lora ``unified_step`` on the global
    batches within 2e-5, where a mean of per-process means would not be."""
    init, ad, ranks = world_two_lora
    r0, r1 = (r[base] for r in ranks)
    assert all(a != b for a, b in zip(r0["mask_counts"], r1["mask_counts"]))
    assert r0["losses"] == r1["losses"] and r0["norms"] == r1["norms"]
    for k, v in r0["adapter"].items():
        assert torch.equal(v, r1["adapter"][k]), k

    acc = jax_pkg.Accelerator()
    jmodel = JaxCausalLM(JaxConfig(**TINY_LM))
    params = jax.tree.map(jnp.asarray, init)
    dtype = None
    if base == "qlora":
        params = jax_quant.quantize_params(params, jax_quant.QuantizationConfig(
            load_in_8bit=True, min_weight_size=256))
        dtype = jnp.float32
    adapter, opt, loader = acc.prepare(jax.tree.map(jnp.asarray, ad), optax.sgd(0.5),
                                       jax_pkg.DataLoader(MaskedTokens(STEPS * 2 * ROWS, ROWS),
                                                          batch_size=2 * ROWS))
    fn = jax_adapters.lora_loss_fn(jmodel, params, jax_adapters.LoraConfig(**_LORA),
                                   compute_dtype=dtype)
    step = acc.unified_step(fn, opt, max_grad_norm=1.0)
    carry = acc.init_carry(adapter, opt)
    losses, norms = [], []
    for batch in loader:
        carry, metrics = step(carry, batch)
        losses.append(float(metrics["loss"]))
        norms.append(float(metrics["grad_norm"]))
    np.testing.assert_allclose(r0["losses"], losses, rtol=TOL)
    np.testing.assert_allclose(r0["norms"], norms, rtol=TOL)
    want = ckpt.flatten_tree(port.params_from_jax(jax.tree.map(np.asarray, carry["params"]),
                                                  port.TransformerConfig(**TINY_LM)))
    assert set(want) == set(r0["adapter"])
    for k, v in want.items():
        np.testing.assert_allclose(r0["adapter"][k].numpy(), v.numpy(), atol=TOL, err_msg=k)
