"""QLoRA over a sharded quantized base on the port at world 4 over gloo,
against the reference's ``lora_loss_fn`` over the same quantized base and
the port's own world 1.

The GQA ``tiny`` weights are quantized whole (int8, and int4 at blocks of
128, ``min_weight_size`` 256) and placed by ``Accelerator.prepare`` under
FULL_SHARD fsdp 2 x tp 2: codes and scales split as the dense weight is.
At 128 a block spans the whole reduction dim of q, k, v, gate and up
(fsdp splits it) and of o_proj (tp splits it), so those leaves' codes are
gathered before they are dequantized; down_proj's 352 rows take blocks of
88, which tp 2 splits whole. One world-4 launch of
``engine_workers.qlora_worker`` runs LoRA on q, v, o, gate and down over
each base: the adapter gradients of the first global batch, three adamw
steps (eps 1e-3; the first one's loss the first batch's), and a chunked
checkpoint of the placed quantized tree restored into a zeroed one.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

import accelerate_tpu as jax_pkg  # noqa: E402
import accelerate_tpu.adapters as jax_adapters  # noqa: E402
from accelerate_tpu.models.transformer import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.utils.quantization import QuantizationConfig as JaxQuantConfig  # noqa: E402
from accelerate_tpu.utils.quantization import quantize_params as jax_quantize  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch import dist_checkpoint  # noqa: E402
from accelerate_tpu_torch.adapters import target_shapes  # noqa: E402
from accelerate_tpu_torch.launchers import debug_launcher  # noqa: E402
from accelerate_tpu_torch.test_utils.scripts import engine_workers  # noqa: E402
from accelerate_tpu_torch.utils.quantization import QuantizationConfig, quantize_params  # noqa: E402

TOL = 2e-5
CFG = dict(num_kv_heads=2, max_seq_len=64)
TARGETS = ("q_proj", "v_proj", "o_proj", "gate_proj", "down_proj")
RANK = 4
PLUGIN = dict(dp_size=1, fsdp_size=2, tp_size=2, min_weight_size=1,
              sharding_strategy="full_shard")
BASES = {"int8": dict(bits=8), "int4": dict(bits=4, block=128)}
CASES = [dict(name=f"qlora_{k}", plugin=PLUGIN, config=CFG, init="init.pt",
              adapter="adapter.npz", targets=TARGETS, rank=RANK, **v) for k, v in BASES.items()]


def _reset():
    port.AcceleratorState._reset_state(reset_partial_state=True)
    port.GradientState._reset_state()
    jax_pkg.state.AcceleratorState._reset_state(reset_partial_state=True)
    jax_pkg.state.GradientState._reset_state()


def _reference():
    model = JaxCausalLM(JaxConfig.tiny(**CFG))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"]
    return model, nn.unbox(params)


def _adapter() -> dict:
    rng = np.random.default_rng(4)
    cfg = port.TransformerConfig.tiny(**CFG)
    out = {}
    for t in TARGETS:
        i, o = target_shapes(cfg)[t]
        out[f"{t}/lora_a"] = (rng.normal(size=(cfg.num_layers, i, RANK)) * 0.05).astype(np.float32)
        out[f"{t}/lora_b"] = (rng.normal(size=(cfg.num_layers, RANK, o)) * 0.05).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded_qlora")
    _reset()
    rng = np.random.default_rng(9)
    np.savez(os.path.join(out, "inputs.npz"), lora_ids=rng.integers(0, 1024, (3, 8, 16)))
    np.savez(os.path.join(out, "adapter.npz"), **_adapter())
    _, params = _reference()
    torch.save(dict(port.params_from_jax(jax.tree.map(np.asarray, params),
                                         port.TransformerConfig.tiny(**CFG))),
               os.path.join(out, "init.pt"))
    debug_launcher(engine_workers.qlora_worker, (str(out), CASES), num_processes=4)
    one = [dict(c, name=f"{c['name']}_w1", plugin=None) for c in CASES]
    threads = torch.get_num_threads()
    try:  # one thread, as each rank runs
        engine_workers.qlora_worker(str(out), one)
    finally:
        torch.set_num_threads(threads)
    _reset()
    names = [c["name"] for c in CASES + one]
    return out, {n: torch.load(os.path.join(out, f"{n}.pt"), weights_only=False) for n in names}


def _close(got, want, what):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=TOL, atol=TOL,
                               err_msg=what)


def _reference_grads(out, base: dict):
    """The reference's loss and adapter gradients on the first batch, one
    device, over its own quantization of the same weights."""
    model, params = _reference()
    qcfg = JaxQuantConfig(load_in_8bit=base["bits"] == 8, load_in_4bit=base["bits"] == 4,
                          min_weight_size=256, int4_block_size=base.get("block", 64))
    qbase = jax_quantize(params, qcfg)
    data = np.load(os.path.join(out, "adapter.npz"))
    adapter: dict = {}
    for key in data.files:
        t, leaf = key.split("/")
        adapter.setdefault(t, {})[leaf] = jnp.asarray(data[key])
    lcfg = jax_adapters.LoraConfig(rank=RANK, alpha=2.0 * RANK, target_modules=TARGETS)
    ids = np.load(os.path.join(out, "inputs.npz"))["lora_ids"]
    loss, grads = jax.value_and_grad(
        jax_adapters.lora_loss_fn(model, qbase, lcfg, compute_dtype=jnp.float32))(
        adapter, {"input_ids": jnp.asarray(ids[0], jnp.int32)})
    return float(loss), jax.tree.map(np.asarray, grads)


@pytest.mark.parametrize("base", sorted(BASES))
def test_qlora_over_a_sharded_base_matches_the_reference(records, base):
    out, recs = records
    rec, one = recs[f"qlora_{base}"], recs[f"qlora_{base}_w1"]
    assert rec["tp"] == 2 and one["tp"] == 1
    assert rec["split"] and not one["split"]
    loss, grads = _reference_grads(out, BASES[base])
    _close(rec["losses"][0], loss, "loss vs the reference")
    for t in TARGETS:
        for leaf in ("lora_a", "lora_b"):
            k = f"{t}.{leaf}"
            _close(rec["grads"][k], grads[t][leaf], f"grad {k} vs the reference")
            _close(rec["grads"][k], one["grads"][k], f"grad {k} vs world 1")
            _close(rec["adapter"][k], one["adapter"][k], f"{k} vs world 1")
    _close(rec["losses"], one["losses"], "step losses vs world 1")


@pytest.mark.parametrize("base", sorted(BASES))
def test_chunked_checkpoint_of_a_quantized_sharded_tree_restores(records, base):
    """Every rank's chunks of the placed codes and scales come back bit for
    bit on the same mesh, and read whole they are the unsharded
    quantization's."""
    out, recs = records
    assert recs[f"qlora_{base}"]["restored"] and recs[f"qlora_{base}_w1"]["restored"]
    model = port.CausalLM(port.TransformerConfig.tiny(**CFG), device="cpu")
    model.load_state_dict(torch.load(os.path.join(out, "init.pt")))
    spec = BASES[base]
    whole = quantize_params(model, QuantizationConfig(
        load_in_8bit=spec["bits"] == 8, load_in_4bit=spec["bits"] == 4, min_weight_size=256,
        int4_block_size=spec.get("block", 64)))
    named = dist_checkpoint.load_full_named(os.path.join(out, f"qlora_{base}_ckpt"))
    for k, v in whole.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(named[k], v.detach()), k
        else:
            assert torch.equal(named[f"{k}//codes"], v.codes), k
            assert torch.equal(named[f"{k}//scales"], v.scales), k
