"""The port's int8/int4 weight-only quantization against the JAX reference,
on the CPU.

Mirrors the tests of ``tests/test_quantization.py`` that need no
``load_and_quantize_model`` (which waits for ``big_modeling`` and
``hf_interop``, queue A8): codes and scales bit for bit against the
reference's on the same seeded weights, the dequantized weights too, the
model's state dict quantized to the reference's codes (each layer of a
``(out, in)`` ``nn.Linear`` weight is the reference's ``(in, out)`` kernel
slice), and the quantized model's logits within ``QUANT_LOGITS_TOL`` of the
reference's quantized logits.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import flax.linen as nn  # noqa: E402
import torch  # noqa: E402

from accelerate_tpu.adapters import LoraConfig as JaxLoraConfig  # noqa: E402
from accelerate_tpu.adapters import init_adapter as jax_init_adapter  # noqa: E402
from accelerate_tpu.adapters import lora_loss_fn as jax_lora_loss_fn  # noqa: E402
from accelerate_tpu.models import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.utils import quantization as ref  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch.adapters import LoraConfig, lora_loss_fn  # noqa: E402
from accelerate_tpu_torch.utils import quantization as q  # noqa: E402

QUANT_LOGITS_TOL = 3e-6  # the int8 model's logits against the reference's (read 1.07e-6)


def _same(qt, rt):
    np.testing.assert_array_equal(qt.codes.numpy(), np.asarray(rt.codes))
    np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(rt.scales))
    assert qt.bits == rt.bits and qt.shape == rt.shape and qt.block_size == rt.block_size
    np.testing.assert_array_equal(qt.dequantize().numpy(), np.asarray(rt.dequantize()))


def test_int8_roundtrip_error_bounded():
    w = np.array(jax.random.normal(jax.random.PRNGKey(0), (256, 128)))
    qt = q.quantize_tensor(torch.from_numpy(w), bits=8)
    assert qt.codes.dtype == torch.int8 and tuple(qt.codes.shape) == w.shape
    _same(qt, ref.quantize_tensor(jnp.asarray(w), bits=8))
    deq = qt.dequantize().numpy()
    col_step = np.abs(w).max(axis=0) / 127.0
    assert float((np.abs(deq - w) / col_step[None, :]).max()) <= 0.51
    assert np.linalg.norm(deq - w) / np.linalg.norm(w) < 0.01


def test_int4_roundtrip_error_bounded():
    w = np.array(jax.random.normal(jax.random.PRNGKey(1), (256, 64)))
    qt = q.quantize_tensor(torch.from_numpy(w), bits=4, block_size=64)
    assert tuple(qt.codes.shape) == (128, 64)  # two codes a byte
    assert tuple(qt.dequantize().shape) == (256, 64)
    _same(qt, ref.quantize_tensor(jnp.asarray(w), bits=4, block_size=64))
    assert np.linalg.norm(qt.dequantize().numpy() - w) / np.linalg.norm(w) < 0.12


@pytest.mark.parametrize("k,block", [(128, 32), (96, 64), (66, 64), (65, 64)])
def test_int4_block_scales_shape(k, block):
    """Scales one a (block, out); a block size that does not divide the
    reduction dim falls to its largest even divisor, an odd one to int8,
    as in the reference."""
    w = np.array(jax.random.normal(jax.random.PRNGKey(2), (k, 32)))
    qt = q.quantize_tensor(torch.from_numpy(w), bits=4, block_size=block)
    _same(qt, ref.quantize_tensor(jnp.asarray(w), bits=4, block_size=block))
    if k == 128:
        assert tuple(qt.scales.shape) == (4, 32)
        assert qt.nbytes < w.size  # under a byte an element, scales included


def test_memory_savings():
    w = torch.ones((512, 512))
    q8, q4 = q.quantize_tensor(w, bits=8), q.quantize_tensor(w, bits=4)
    assert q8.nbytes < w.nbytes / 3.9
    assert q4.nbytes < w.nbytes / 7.0
    assert q8.nbytes == ref.quantize_tensor(jnp.ones((512, 512)), bits=8).nbytes
    assert q4.nbytes == ref.quantize_tensor(jnp.ones((512, 512)), bits=4).nbytes


def test_quantize_params_skips_and_config_validation():
    with pytest.raises(ValueError):
        q.QuantizationConfig()  # neither bit width chosen
    with pytest.raises(ValueError):
        q.QuantizationConfig(load_in_8bit=True, load_in_4bit=True)
    with pytest.raises(ValueError):
        q.QuantizationConfig(load_in_4bit=True, int4_block_size=3)
    cfg = q.QuantizationConfig(load_in_8bit=True, min_weight_size=16)
    params = {"layer": {"kernel": torch.ones((64, 64)), "bias": torch.ones((64,))},
              "embed": {"table": torch.ones((64, 64))},
              "norm": {"scale": torch.ones((8, 8))}}
    out = q.quantize_params(params, cfg)
    assert q.is_quantized(out["layer"]["kernel"])
    assert not q.is_quantized(out["layer"]["bias"])  # 1-dim and "bias"
    assert not q.is_quantized(out["embed"]["table"])  # the skip list
    assert not q.is_quantized(out["norm"]["scale"])
    assert cfg.skip_modules == ref.QuantizationConfig(load_in_8bit=True).skip_modules
    assert cfg.bits == 8 and q.QuantizationConfig(load_in_4bit=True).bits == 4


def test_quantized_tensor_dequantizes_in_any_dtype():
    """The reference's pytree-and-jit test: the port's QuantizedTensor is a
    plain holder of codes and scales; it moves, reports its bytes and
    dequantizes to the asked dtype inside a product."""
    qt = q.quantize_tensor(torch.ones((32, 16)), bits=8)
    assert (qt.codes.nbytes + qt.scales.nbytes) == qt.nbytes
    assert qt.to("cpu").dequantize().equal(qt.dequantize())
    out = torch.ones((4, 32)) @ qt.dequantize(torch.float32)
    np.testing.assert_allclose(out.numpy(), 32.0, rtol=1e-5)
    assert qt.dequantize(torch.bfloat16).dtype == torch.bfloat16
    want = jax.jit(lambda t, x: x @ t.dequantize(jnp.float32))(
        ref.quantize_tensor(jnp.ones((32, 16)), bits=8), jnp.ones((4, 32)))
    np.testing.assert_array_equal(out.numpy(), np.asarray(want))


@pytest.fixture(scope="module")
def tiny():
    cfg = JaxConfig.tiny()
    model = JaxCausalLM(cfg)
    ids = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
    params = nn.unbox(model.init(jax.random.PRNGKey(0), jnp.asarray(ids))["params"])
    pcfg = port.TransformerConfig.tiny()
    pmodel = port.CausalLM(pcfg, device="cpu")
    pmodel.load_state_dict(port.params_from_jax(params, pcfg), strict=True)
    return model, params, pmodel, ids


def test_quantized_model_forward_close_to_fp32(tiny):
    """The state dict quantized to the reference's codes, leaf for leaf and
    layer for layer; the int8 model's logits close to fp32 (cosine), and to
    the reference's int8 logits within QUANT_LOGITS_TOL."""
    model, params, pmodel, ids = tiny
    qcfg = q.QuantizationConfig(load_in_8bit=True, min_weight_size=256)
    qparams = q.quantize_params(pmodel, qcfg)
    rparams = ref.quantize_params(params, ref.QuantizationConfig(load_in_8bit=True,
                                                                 min_weight_size=256))
    names = [n for n, leaf in qparams.items() if q.is_quantized(leaf)]
    assert len(names) == 7 * pmodel.config.num_layers  # the projections; not embed/lm_head
    for name in names:
        parts = name.split(".")
        rt = rparams["layers"]
        for part in parts[2:-1]:
            rt = rt[part]
        rt = rt["kernel"]
        layer = int(parts[1])
        qt = qparams[name]
        assert qt.transposed
        np.testing.assert_array_equal(qt.codes.numpy(), np.asarray(rt.codes)[layer])
        np.testing.assert_array_equal(qt.scales.numpy(), np.asarray(rt.scales)[layer])
    with torch.no_grad():
        base = pmodel(torch.from_numpy(ids).long()).numpy()
        out = q.quantized_apply(pmodel, qparams, torch.from_numpy(ids).long(),
                                dtype=torch.float32).numpy()
    a, b = base.ravel(), out.ravel()
    assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9)) > 0.999
    want = np.asarray(ref.quantized_apply(model.apply, rparams, jnp.asarray(ids),
                                          dtype=jnp.float32))
    assert np.abs(out - want).max() / np.abs(want).max() <= QUANT_LOGITS_TOL


@pytest.mark.parametrize("bits,tol", [(8, 0.01), (4, 0.12)])
def test_dequant_matmul_matches_fp32_reference(bits, tol):
    """x @ dequantize(W) tracks x @ W within the bit width's error, and
    equals the reference's dequantized product."""
    rng = np.random.default_rng(bits)
    w = rng.normal(size=(128, 64)).astype(np.float32)
    x = rng.normal(size=(8, 128)).astype(np.float32)
    qt = q.quantize_tensor(torch.from_numpy(w), bits=bits, block_size=32)
    out = torch.from_numpy(x) @ qt.dequantize(torch.float32)
    refp = x @ w
    assert np.linalg.norm(out.numpy() - refp) / np.linalg.norm(refp) < tol
    rt = ref.quantize_tensor(jnp.asarray(w), bits=bits, block_size=32)
    np.testing.assert_array_equal(qt.dequantize().numpy(), np.asarray(rt.dequantize(jnp.float32)))


def test_gradients_identically_zero_through_frozen_quantized_base(tiny):
    """The frozen base takes no gradient: with every float leaf of the int8
    base (the scales and the unquantized leaves) made a leaf that asks for
    one, the loss's gradient with respect to them does not exist (the
    reference's is zero), while the adapter's flows."""
    _, _, pmodel, ids = tiny
    qbase = q.quantize_params(pmodel, q.QuantizationConfig(load_in_8bit=True,
                                                           min_weight_size=256))
    floats = []
    for name, leaf in qbase.items():
        if q.is_quantized(leaf):
            leaf.scales.requires_grad_(True)
            floats.append(leaf.scales)
        else:  # a copy: the fixture's model keeps its own parameters
            qbase[name] = leaf.detach().clone().requires_grad_(True)
            floats.append(qbase[name])
    lcfg = LoraConfig(rank=4, target_modules=("q_proj", "v_proj"))
    jcfg = JaxLoraConfig(rank=4, target_modules=("q_proj", "v_proj"))
    adapter = jax.tree.map(lambda leaf: leaf + 0.01,
                           jax_init_adapter(jax.random.PRNGKey(1), JaxConfig.tiny(), jcfg))
    tree = {t: {k: v.requires_grad_(True) for k, v in pair.items()}
            for t, pair in port.params_from_jax(jax.tree.map(np.asarray, adapter),
                                                pmodel.config).items()}
    loss = lora_loss_fn(pmodel, qbase, lcfg, compute_dtype=torch.float32)(
        tree, {"input_ids": torch.from_numpy(ids[:, :16]).long()})
    assert torch.autograd.grad(loss, floats, retain_graph=True,
                               allow_unused=True) == (None,) * len(floats)
    grads = torch.autograd.grad(loss, [v for pair in tree.values() for v in pair.values()])
    assert all(g.any() for g in grads)
    want = jax_lora_loss_fn(JaxCausalLM(JaxConfig.tiny()), ref.quantize_params(
        tiny[1], ref.QuantizationConfig(load_in_8bit=True, min_weight_size=256)), jcfg,
        compute_dtype=jnp.float32)(adapter, {"input_ids": jnp.asarray(ids[:, :16])})
    assert abs(float(loss.detach()) - float(want)) / float(want) <= 1e-5


def test_load_and_quantize_model_raises_naming_a8():
    with pytest.raises(NotImplementedError, match="queue A8"):
        q.load_and_quantize_model({}, "checkpoint", q.QuantizationConfig(load_in_8bit=True))
