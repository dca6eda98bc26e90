"""LoRA adapters under tensor parallelism on the port at world 4 over gloo,
against the reference under the same plugin and the port's own world 1.

One world-4 launch of ``tp_workers.adapters_experts_worker`` runs LoRA on
q, v, o, gate and down over the GQA ``tiny`` base at fsdp 2 x tp 2
(FULL_SHARD; the adapter stays whole, below ``min_weight_size``, as the
reference's does): the adapter gradients of the first global batch, then
three adamw steps (1e-2, clip 1.0), whose losses, grad norms and adapter
match world 1 and the reference's run under the same plugin (its GSPMD
splits the products; the port splits B's columns on the column-split
projections and A's rows on the row-split ones, and sums each rank's share
of the adapter's gradients over tp).
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402
from flax import linen as nn  # noqa: E402

import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu.adapters as jax_adapters  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.adapters import target_shapes  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import tp_workers  # noqa: E402

TOL = 2e-5
LORA_CFG = dict(num_kv_heads=2, max_seq_len=64)
TARGETS = ("q_proj", "v_proj", "o_proj", "gate_proj", "down_proj")
RANK = 4
FSDP_TP = dict(dp_size=1, fsdp_size=2, tp_size=2)
LORA = [dict(name="lora_fsdp2_tp2", plugin=FSDP_TP, config=LORA_CFG, init="init_lora.pt",
             adapter="adapter.npz", targets=TARGETS, rank=RANK)]


def _reset():
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()


def _reference(config: dict):
    model = JaxCausalLM(JaxConfig.tiny(**config))
    return model, model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]


def _close(got, want, what, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=what)


def _adapter() -> dict:
    """A seeded adapter of both nonzero A and B (every delta counts)."""
    rng = np.random.default_rng(4)
    cfg = port.TransformerConfig.tiny(**LORA_CFG)
    out = {}
    for t in TARGETS:
        i, o = target_shapes(cfg)[t]
        out[f"{t}/lora_a"] = (rng.normal(size=(cfg.num_layers, i, RANK)) * 0.05).astype(np.float32)
        out[f"{t}/lora_b"] = (rng.normal(size=(cfg.num_layers, RANK, o)) * 0.05).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_lora")
    _reset()
    rng = np.random.default_rng(9)
    np.savez(os.path.join(out, "inputs.npz"), lora_ids=rng.integers(0, 1024, (3, 8, 16)))
    np.savez(os.path.join(out, "adapter.npz"), **_adapter())
    _, params = _reference(LORA_CFG)
    torch.save(dict(port.params_from_jax(jax.tree.map(np.asarray, nn.unbox(params)),
                                         port.TransformerConfig.tiny(**LORA_CFG))),
               os.path.join(out, "init_lora.pt"))
    debug_launcher(tp_workers.adapters_experts_worker, (str(out), LORA, []), num_processes=4)
    tp_workers.lora_case(str(out), {**LORA[0], "name": "lora_w1", "plugin": None})
    _reset()
    return out, {n: torch.load(os.path.join(out, f"{n}.pt"))
                 for n in ("lora_fsdp2_tp2", "lora_w1")}


def _jax_adapter(out):
    data = np.load(os.path.join(out, "adapter.npz"))
    tree = {}
    for key in data.files:
        t, leaf = key.split("/")
        tree.setdefault(t, {})[leaf] = jnp.asarray(data[key])
    return tree


def _reference_lora(out):
    """The reference's adapter gradients on the first batch (one device)
    and its three steps under dp 2 x fsdp 2 x tp 2."""
    ids = np.load(os.path.join(out, "inputs.npz"))["lora_ids"]
    model, params = _reference(LORA_CFG)
    lcfg = jax_adapters.LoraConfig(rank=RANK, alpha=2.0 * RANK, target_modules=TARGETS)
    grads = jax.grad(jax_adapters.lora_loss_fn(model, nn.unbox(params), lcfg))(
        _jax_adapter(out), {"input_ids": jnp.asarray(ids[0], jnp.int32)})
    _reset()
    acc = jax_pkg.Accelerator(parallelism_plugin=jax_pkg.ParallelismPlugin(
        dp_size=-1, fsdp_size=2, tp_size=2))
    base = acc.prepare(params)
    adapter, opt = acc.prepare(_jax_adapter(out), optax.adamw(1e-2))
    step = acc.unified_step(jax_adapters.lora_loss_fn(model, base, lcfg), max_grad_norm=1.0)
    carry = acc.init_carry(adapter, opt)
    losses, norms = [], []
    for batch in ids:
        carry, m = step(carry, {"input_ids": jnp.asarray(batch, jnp.int32)})
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    final = jax.tree.map(np.asarray, carry["params"])
    _reset()
    return jax.tree.map(np.asarray, grads), losses, norms, final


def test_lora_under_tp_matches_world_one_and_the_reference(records):
    out, recs = records
    rec, one = recs["lora_fsdp2_tp2"], recs["lora_w1"]
    grads, losses, norms, final = _reference_lora(out)
    for t in TARGETS:
        for leaf in ("lora_a", "lora_b"):
            k = f"{t}.{leaf}"
            _close(rec["grads"][k], one["grads"][k], f"grad {k} vs world 1")
            _close(rec["grads"][k], grads[t][leaf], f"grad {k} vs the reference")
            _close(rec["adapter"][k], one["adapter"][k], f"{k} vs world 1")
            _close(rec["adapter"][k], final[t][leaf], f"{k} vs the reference")
    _close(rec["losses"], one["losses"], "losses vs world 1")
    _close(rec["losses"], losses, "losses vs the reference")
    _close(rec["norms"], norms, "grad norms vs the reference")
    assert any(np.abs(rec["grads"][f"{t}.lora_a"].numpy()).max() > 0 for t in TARGETS)


def _world_one_lora_models():
    """Two tiny bases of different weights, prepared under a plugin in one
    process (a group of one: DTensor params), an adapter of nonzero A and B,
    and a batch."""
    from accelerate_tpu_torch.adapters import LoraConfig, init_adapter

    _reset()
    acc = port.Accelerator(cpu=True, parallelism_plugin=port.ParallelismPlugin(dp_size=1))
    cfg = port.TransformerConfig.tiny(num_layers=1, **LORA_CFG)
    a, b = (acc.prepare(port.CausalLM(cfg, device="cpu",
                                      generator=torch.Generator().manual_seed(seed)))
            for seed in (0, 1))
    lcfg = LoraConfig(rank=2, target_modules=TARGETS)
    adapter = init_adapter(torch.Generator().manual_seed(1), cfg, lcfg)
    for pair in adapter.values():
        pair["lora_b"].normal_(0.0, 0.02, generator=torch.Generator().manual_seed(2))
    ids = torch.randint(0, cfg.vocab_size, (2, 8), generator=torch.Generator().manual_seed(3))
    return acc, a, b, lcfg, adapter, {"input_ids": ids}


def test_lora_on_a_sharded_base_reads_the_base_it_is_given():
    """``lora_loss_fn(model, base, ...)`` with ``base`` a prepared set that is
    not ``model``'s own parameters (the reference's ``lora_loss_fn(model,
    acc.prepare(params), lcfg)``) runs on ``base``: its loss is the one of
    the model that owns those weights, not of ``model``'s."""
    from accelerate_tpu_torch.adapters import lora_loss_fn

    acc, a, b, lcfg, adapter, batch = _world_one_lora_models()
    try:
        with torch.no_grad():
            got = lora_loss_fn(a, dict(b.named_parameters()), lcfg)(adapter, batch)
            want = lora_loss_fn(b, b, lcfg)(adapter, batch)
            own = lora_loss_fn(a, a, lcfg)(adapter, batch)
        assert torch.equal(got, want), (float(got), float(want))
        assert not torch.equal(got, own)
    finally:
        acc.state.partial_state.destroy_process_group()
        _reset()


def test_lora_on_a_quantized_sharded_base_raises_naming_its_queue_item():
    """QLoRA over a sharded base is ported (it raised naming its queue item
    before): a base quantized whole and placed by ``Accelerator.prepare``
    (codes and scales DTensors) gives the loss of the same quantized base
    unsharded, bit for bit at one rank. The world-4 cases are
    ``test_torch_sharded_qlora.py``'s."""
    from accelerate_tpu_torch.adapters import lora_loss_fn
    from accelerate_tpu_torch.parallel.sharding import is_dtensor
    from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize_params

    acc, _, _, lcfg, adapter, batch = _world_one_lora_models()
    try:
        cfg = port.TransformerConfig.tiny(num_layers=1, **LORA_CFG)
        plain = port.CausalLM(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
        whole = quantize_params(plain, QuantizationConfig(load_in_8bit=True, min_weight_size=1))
        name = "layers.0.mlp.gate_proj.weight"
        base = acc.prepare(whole, logical_specs=plain)
        assert is_dtensor(base[name].codes) and is_dtensor(base[name].scales)
        with torch.no_grad():
            got = lora_loss_fn(plain, base, lcfg)(adapter, batch)
            want = lora_loss_fn(plain, whole, lcfg)(adapter, batch)
        assert torch.equal(got, want), (float(got), float(want))
    finally:
        acc.state.partial_state.destroy_process_group()
        _reset()


def test_a_stale_equal_mesh_on_a_sharded_base_resolves_to_the_running_one():
    """A base whose DTensors hold a mesh equal to the running one by value
    but whose groups no longer resolve (one made before the process group
    was ended and brought up again: PyTorch compares meshes by value, and a
    DTensor may keep the older equal mesh) runs on the running mesh's
    groups: its loss is the live base's."""
    import copy

    from torch.distributed.tensor import DTensor

    from accelerate_tpu_torch.adapters import lora_loss_fn

    acc, a, b, lcfg, adapter, batch = _world_one_lora_models()
    live = next(iter(b.parameters())).device_mesh
    stale = copy.copy(live)
    try:
        stale._dim_group_names = ["ended"] * len(live._dim_group_names)
        base = dict(b.named_parameters())
        moved = {k: DTensor.from_local(v.to_local(), stale, v.placements, run_check=False,
                                       shape=v.shape, stride=v.stride())
                 for k, v in base.items()}
        assert next(iter(moved.values())).device_mesh is stale
        with torch.no_grad():
            got = lora_loss_fn(a, moved, lcfg)(adapter, batch)
            want = lora_loss_fn(a, base, lcfg)(adapter, batch)
        assert torch.equal(got, want), (float(got), float(want))
    finally:
        # the copy may stay cached inside DTensor: leave its groups resolvable
        stale._dim_group_names = list(live._dim_group_names)
        acc.state.partial_state.destroy_process_group()
        _reset()
