"""``tests/test_quantization.py``'s loads of HF checkpoints, on the port
and the JAX reference, on the CPU.

A ``transformers`` Llama checkpoint (``tests/test_torch_hf_interop.py``'s
helpers) quantized as it loads, int8 and int4: the port's codes and scales
bit for bit the reference's layer slices on the same file, the logits
within the reference test's cosine of the fp load and within
``QUANT_LOGITS_TOL`` of the reference's quantized logits; and a checkpoint
holding a tensor the mapping never reads refused by both. Apart from
``test_torch_hf_interop.py`` to keep each file's time short.
"""

import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
pytest.importorskip("transformers")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from accelerate_tpu.models import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.utils import hf_interop as ref  # noqa: E402
from accelerate_tpu.utils import quantization as ref_q  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch import big_modeling as bm  # noqa: E402
from accelerate_tpu_torch.utils import hf_interop as hi  # noqa: E402
from accelerate_tpu_torch.utils import quantization as q  # noqa: E402
from accelerate_tpu_torch.utils import safetensors_io  # noqa: E402
from test_torch_hf_interop import (  # noqa: E402
    _IDS,
    _TINY,
    _load_both,
    _port_logits,
    _ref_abstract,
    _rel,
    _save_hf_llama,
)

QUANT_LOGITS_TOL = 1e-6  # int8 and int4 dequantized in fp32: about 3x the reading 3.03e-7


def _same_quantized(qparams, rtree, config):
    """The port quantized what the reference quantized, and each weight's
    codes and scales equal the reference's layer slice of its stacked
    weight, bit for bit (every quantized weight here is a layer's
    projection: the rest is in ``skip_modules``)."""
    rquantized = [leaf for leaf in jax.tree.leaves(rtree, is_leaf=ref_q.is_quantized)
                  if ref_q.is_quantized(leaf)]
    quantized = {k: v for k, v in qparams.items() if q.is_quantized(v)}
    assert len(quantized) == len(rquantized) * config.num_layers
    for name, leaf in quantized.items():
        _, layer, module, proj, _ = name.split(".")
        rleaf = rtree["layers"][module][proj]["kernel"]
        assert leaf.transposed and leaf.bits == rleaf.bits, name
        np.testing.assert_array_equal(leaf.codes.numpy(), np.asarray(rleaf.codes)[int(layer)],
                                      err_msg=name)
        np.testing.assert_array_equal(leaf.scales.numpy(),
                                      np.asarray(rleaf.scales)[int(layer)], err_msg=name)


@pytest.mark.parametrize("bits", [8, 4])
def test_load_and_quantize_hf_checkpoint(tmp_path, bits):
    _, path = _save_hf_llama(tmp_path)
    pcfg, model, _, rcfg, rparams = _load_both(path)
    qcfg = q.QuantizationConfig(load_in_8bit=bits == 8, load_in_4bit=bits == 4,
                                min_weight_size=256, int4_block_size=16)
    qparams = q.load_and_quantize_model(bm.init_empty_weights(port.CausalLM, pcfg), path, qcfg,
                                        device="cpu")
    assert sum(q.is_quantized(v) for v in qparams.values()) == 7 * pcfg.num_layers
    rq = ref_q.load_and_quantize_model(_ref_abstract(rcfg), path, ref_q.QuantizationConfig(
        load_in_8bit=bits == 8, load_in_4bit=bits == 4, min_weight_size=256,
        int4_block_size=16))
    rq = nn.unbox(rq)
    _same_quantized(qparams, rq, pcfg)
    ref_logits = _port_logits(model, _IDS)
    with torch.no_grad():
        out = q.quantized_apply(model, qparams, torch.from_numpy(_IDS).long(),
                                dtype=torch.float32).numpy()
    a, b = ref_logits.ravel(), out.ravel()
    assert float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-9)) > (
        0.999 if bits == 8 else 0.99)
    want = np.asarray(ref_q.quantized_apply(JaxCausalLM(rcfg).apply, rq, jnp.asarray(_IDS),
                                            dtype=jnp.float32))
    assert _rel(out, want) <= QUANT_LOGITS_TOL


def test_load_and_quantize_hf_rejects_unconsumed(tmp_path):
    _, path = _save_hf_llama(tmp_path)
    config = hi.infer_config_from_hf(path, attention_impl="xla")
    st = os.path.join(path, "model.safetensors")
    named = safetensors_io.load_file(st)
    named["model.layers.0.self_attn.q_proj.bias"] = torch.zeros(_TINY["hidden_size"])
    safetensors_io.save_file(named, st, metadata={"format": "pt"})
    qcfg = q.QuantizationConfig(load_in_8bit=True, min_weight_size=256)
    with pytest.raises(ValueError, match="not consumed"):
        q.load_and_quantize_model(bm.init_empty_weights(port.CausalLM, config), path, qcfg,
                                  device="cpu", model_config=config, hf_format=True)
    rcfg = ref.infer_config_from_hf(path, attention_impl="xla")
    with pytest.raises(ValueError, match="not consumed"):
        ref_q.load_and_quantize_model(_ref_abstract(rcfg), path, ref_q.QuantizationConfig(
            load_in_8bit=True, min_weight_size=256), model_config=rcfg, hf_format=True)
