"""The port's HF checkpoint interop against the JAX reference's and
transformers', on the CPU.

Mirrors the 19 tests of ``tests/test_hf_interop.py`` that the port's models
can represent: Llama (GQA, untied and tied), Llama-3.1 and linear rope
scaling, Mixtral, Qwen2 (biases, a sliding window), Mistral's sliding
window, sharded checkpoints with an index, bf16 checkpoints, the export and
the round trip, and the rejections. Each checkpoint is written by a
``transformers`` model built from a local config with random weights, a
third witness beside the two packages: the port reads the same files as the
reference into the same config and the same weights bit for bit, gives
transformers' logits and greedy tokens within the reference test's
tolerances and the reference's logits within ``FP32_TOL`` (bf16 within
``BF16_LOGITS_TOL``); its exports equal the reference's tensor for tensor
and load in transformers. Then ``tests/test_adapters.py::
test_peft_export_layout_map``; ``tests/test_torch_hf_quantization.py``
holds ``tests/test_quantization.py``'s HF loads. Then the GPT-2 tests (the
prefixed and the hub's unprefixed layouts, greedy generation, the export,
the attention-math refusal), Gemma's and Gemma-2's logits (every Gemma-2
switch live) and greedy tokens, and Qwen2's mixed sliding/full layers, at
the reference tests' tolerances against transformers. The GSPMD ones
(``test_gspmd_and_device_map_paths_identical``,
``test_hf_load_onto_tp_fsdp_mesh``) load at world 4 over gloo in one launch.
"""

import dataclasses
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
transformers = pytest.importorskip("transformers")
import flax.linen as nn  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from accelerate_tpu import big_modeling as ref_bm  # noqa: E402
from accelerate_tpu.adapters import LoraConfig as JaxLoraConfig  # noqa: E402
from accelerate_tpu.adapters import init_adapter as jax_init_adapter  # noqa: E402
from accelerate_tpu.models import CausalLM as JaxCausalLM  # noqa: E402
from accelerate_tpu.models import causal_model_for as jax_causal_model_for  # noqa: E402
from accelerate_tpu.models import TransformerConfig as JaxConfig  # noqa: E402
from accelerate_tpu.models.generation import generate as jax_generate  # noqa: E402
from accelerate_tpu.utils import hf_interop as ref  # noqa: E402

import accelerate_tpu_torch as port  # noqa: E402
from accelerate_tpu_torch import big_modeling as bm  # noqa: E402
from accelerate_tpu_torch.adapters import LoraConfig, adapter_to_peft, peft_to_adapter  # noqa: E402
from accelerate_tpu_torch.adapters.runtime import A_KEY, B_KEY  # noqa: E402
from accelerate_tpu_torch.models import GPT2LM, causal_model_for  # noqa: E402
from accelerate_tpu_torch.models.generation import generate  # noqa: E402
from accelerate_tpu_torch.utils import hf_interop as hi  # noqa: E402
from accelerate_tpu_torch.utils import safetensors_io  # noqa: E402

# the port's logits against the reference's, relative to the largest logit
FP32_TOL = 2e-6  # fp32: about 3x the largest reading, 6.2e-7
BF16_LOGITS_TOL = 0.02  # bf16 end to end: about 3x the reading 6.85e-3

_TINY = dict(vocab_size=256, hidden_size=64, intermediate_size=176, num_layers=2, num_heads=4,
             num_kv_heads=2, max_seq_len=64, rope_theta=500000.0, rms_norm_eps=1e-5)
_LLAMA31_ROPE_SCALING = {"rope_type": "llama3", "factor": 8.0, "low_freq_factor": 1.0,
                         "high_freq_factor": 4.0, "original_max_position_embeddings": 32}
_IDS = np.array([[3, 17, 91, 4, 200, 11, 7, 42, 9, 128, 55, 250]], dtype=np.int32)


def _hf_kw(**kw):
    return dict(vocab_size=_TINY["vocab_size"], hidden_size=_TINY["hidden_size"],
                intermediate_size=_TINY["intermediate_size"],
                num_hidden_layers=_TINY["num_layers"], num_attention_heads=_TINY["num_heads"],
                num_key_value_heads=_TINY["num_kv_heads"],
                max_position_embeddings=_TINY["max_seq_len"], rope_theta=_TINY["rope_theta"],
                rms_norm_eps=_TINY["rms_norm_eps"], attention_dropout=0.0, **kw)


def _save_hf(tmp_path, cls, cfg, seed, name, dtype=None):
    torch.manual_seed(seed)
    model = cls(cfg).eval()
    if dtype is not None:
        model = model.to(dtype)
    path = str(tmp_path / name)
    model.save_pretrained(path, safe_serialization=True)
    return model, path


def _save_hf_llama(tmp_path, tie=False, dtype=None, seed=0, rope_scaling=None):
    cfg = transformers.LlamaConfig(**_hf_kw(rope_scaling=rope_scaling, tie_word_embeddings=tie))
    return _save_hf(tmp_path, transformers.LlamaForCausalLM, cfg, seed, "hf_llama", dtype)


def _save_hf_qwen2(tmp_path, seed=12, **cfg_kw):
    cfg_kw.setdefault("use_sliding_window", False)
    cfg = transformers.Qwen2Config(**_hf_kw(tie_word_embeddings=False, **cfg_kw))
    return _save_hf(tmp_path, transformers.Qwen2ForCausalLM, cfg, seed, "hf_qwen2")


def _save_hf_mistral(tmp_path, seed=15, **cfg_kw):
    cfg = transformers.MistralConfig(**_hf_kw(tie_word_embeddings=False, **cfg_kw))
    return _save_hf(tmp_path, transformers.MistralForCausalLM, cfg, seed, "hf_mistral")


def _torch_logits(model, ids: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return model(torch.from_numpy(ids).long()).logits.float().numpy()


def _port_cls(config):
    """The port's decoder class for ``config.arch`` (``causal_model_for``'s)."""
    return GPT2LM if config.arch == "gpt2" else port.CausalLM


def _ref_abstract(config):
    model = jax_causal_model_for(config)
    return ref_bm.init_empty_weights(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))["params"])


def _ref_logits(config, params, ids) -> np.ndarray:
    return np.asarray(jax_causal_model_for(config).apply({"params": params}, jnp.asarray(ids)),
                      dtype=np.float32)


def _port_model(config, tree):
    model = bm.init_empty_weights(_port_cls(config), config)
    model.load_state_dict(tree, assign=True)
    return model.eval()


def _port_logits(model, ids) -> np.ndarray:
    with torch.no_grad():
        return model(torch.from_numpy(ids).long()).float().numpy()


def _load_both(path, **cfg_kw):
    """The checkpoint at ``path`` through both packages, as the reference's
    tests load it: the configs must agree field for field and the weights
    bit for bit. Returns (the port's config, model, tree; the reference's
    config, params)."""
    rcfg = ref.infer_config_from_hf(path, attention_impl="xla", **cfg_kw)
    rparams = ref_bm.load_checkpoint_and_dispatch(_ref_abstract(rcfg), path,
                                                  device_map={"": "cpu"})
    pcfg = hi.infer_config_from_hf(path, attention_impl="xla", **cfg_kw)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(rcfg)
    meta = bm.init_empty_weights(_port_cls(pcfg), pcfg)
    tree = bm.load_checkpoint_and_dispatch(meta, path, device_map={"": "cpu"})
    assert list(tree) == list(meta.state_dict())
    want = port.params_from_jax(nn.unbox(rparams), pcfg)
    assert set(want) == set(tree)
    for name, t in tree.items():
        np.testing.assert_array_equal(t.float().numpy(), want[name].numpy(), err_msg=name)
    return pcfg, _port_model(pcfg, tree), tree, rcfg, rparams


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a, np.float64) - b).max() / np.abs(b).max())


def _check_logits(path, hf_model, tol, port_tol=FP32_TOL, **cfg_kw):
    """Load through both packages; the port's logits against transformers'
    (the reference test's tolerance) and the reference's (``port_tol``)."""
    pcfg, model, tree, rcfg, rparams = _load_both(path, **cfg_kw)
    ours = _port_logits(model, _IDS)
    np.testing.assert_allclose(ours, _torch_logits(hf_model, _IDS), rtol=tol, atol=tol)
    assert _rel(ours, _ref_logits(rcfg, rparams, _IDS)) <= port_tol
    return pcfg, model, tree, ours


def _files(path) -> dict:
    named = {}
    for f in hi.list_hf_checkpoint_files(path):
        named.update(safetensors_io.load_file(f))
    return named


def _exports_agree(params, config, rparams, rconfig, tmp_path, name, **kw):
    """The port's export and the reference's of the same weights: the same
    files, config.json and tensors bit for bit."""
    ours, theirs = str(tmp_path / f"{name}_port"), str(tmp_path / f"{name}_ref")
    hi.save_hf_checkpoint(params, config, ours, **kw)
    ref.save_hf_checkpoint(rparams, rconfig, theirs, **kw)
    cfg = json.load(open(os.path.join(ours, "config.json")))
    assert cfg == json.load(open(os.path.join(theirs, "config.json")))
    a, b = _files(ours), _files(theirs)
    assert sorted(a) == sorted(b)
    for key in a:
        assert torch.equal(a[key], b[key]), key
    return ours, cfg


def test_llama_checkpoint_logits_match_torch(tmp_path):
    hf_model, path = _save_hf_llama(tmp_path)
    assert hi.is_hf_checkpoint(path) and ref.is_hf_checkpoint(path)
    assert hi.list_checkpoint_keys(path) == ref.list_checkpoint_keys(path)
    pcfg, _, tree, _ = _check_logits(path, hf_model, 2e-4)
    assert pcfg.num_kv_heads == 2 and not pcfg.tie_embeddings
    assert "lm_head.weight" in tree


def test_tied_llama_checkpoint_reties_lm_head(tmp_path):
    hf_model, path = _save_hf_llama(tmp_path, tie=True)
    pcfg, _, tree, _ = _check_logits(path, hf_model, 2e-4)
    assert pcfg.tie_embeddings and "lm_head.weight" not in tree
    # an untied model reading the tied checkpoint re-ties its lm_head
    untied = dataclasses.replace(pcfg, tie_embeddings=False)
    tree2 = bm.load_checkpoint_and_dispatch(bm.init_empty_weights(port.CausalLM, untied), path,
                                            device_map={"": "cpu"}, config=untied)
    assert torch.equal(tree2["lm_head.weight"], tree["embed.weight"])


def test_mixtral_checkpoint_logits_match_torch(tmp_path):
    cfg = transformers.MixtralConfig(**_hf_kw(num_local_experts=4, num_experts_per_tok=2,
                                              router_jitter_noise=0.0))
    hf_model, path = _save_hf(tmp_path, transformers.MixtralForCausalLM, cfg, 1, "hf_mixtral")
    pcfg, _, tree, _ = _check_logits(path, hf_model, 5e-4, moe_dispatch="dense")
    assert pcfg.num_experts == 4
    assert tree["layers.1.moe.down_proj"].shape == (4, 176, 64)  # (E, in, out), untransposed


def test_save_hf_checkpoint_loads_in_transformers(tmp_path):
    """The reference's weights carried over: the port's export equals the
    reference's, and transformers loads it with the port's logits."""
    rcfg = JaxConfig(**_TINY, attention_impl="xla")
    rparams = nn.unbox(JaxCausalLM(rcfg).init(jax.random.PRNGKey(2),
                                             jnp.zeros((1, 8), jnp.int32))["params"])
    pcfg = port.TransformerConfig(**_TINY, attention_impl="xla")
    params = port.params_from_jax(rparams, pcfg)
    out, cfg = _exports_agree(params, pcfg, rparams, rcfg, tmp_path, "export")
    assert os.path.isfile(os.path.join(out, "model.safetensors"))
    assert cfg["model_type"] == "llama"
    hf_model = transformers.LlamaForCausalLM.from_pretrained(out).eval()
    ours = _port_logits(_port_model(pcfg, params), _IDS)
    np.testing.assert_allclose(ours, _torch_logits(hf_model, _IDS), rtol=2e-4, atol=2e-4)
    assert _rel(ours, _ref_logits(rcfg, rparams, _IDS)) <= FP32_TOL


def test_hf_round_trip_native_identity(tmp_path):
    """The port's parameters -> HF files -> the port's parameters, bit for
    bit, from a model on the CPU and from its state dict."""
    config = port.TransformerConfig(**_TINY, attention_impl="xla")
    model = port.CausalLM(config, device="cpu", generator=torch.Generator().manual_seed(3))
    out = str(tmp_path / "rt")
    hi.save_hf_checkpoint(model, config, out)
    reloaded = bm.load_checkpoint_and_dispatch(bm.init_empty_weights(port.CausalLM, config), out,
                                               device_map={"": "cpu"})
    for name, t in model.state_dict().items():
        assert torch.equal(reloaded[name], t), name


def test_lookalike_arch_rejected(tmp_path):
    """Architectures that share the key convention but hold what the
    mapping would drop fail loudly in both packages, never load garbage."""
    _, path = _save_hf_llama(tmp_path)
    config = hi.infer_config_from_hf(path, attention_impl="xla")
    cfg_path = os.path.join(path, "config.json")
    hf_cfg = json.load(open(cfg_path))
    for field, value, match in (("model_type", "phi3", "model_type"),
                                ("rope_scaling", {"rope_type": "yarn", "factor": 8.0},
                                 "rope_scaling")):
        json.dump({**hf_cfg, field: value}, open(cfg_path, "w"))
        for pkg in (hi, ref):
            with pytest.raises(ValueError, match=match):
                pkg.infer_config_from_hf(path)
    json.dump(hf_cfg, open(cfg_path, "w"))
    # a tensor the mapping never reads
    extra = os.path.join(path, "model.safetensors")
    named = safetensors_io.load_file(extra)
    named["model.layers.0.self_attn.q_proj.bias"] = torch.zeros(_TINY["hidden_size"])
    safetensors_io.save_file(named, extra, metadata={"format": "pt"})
    with pytest.raises(ValueError, match="not consumed"):
        bm.load_checkpoint_and_dispatch(bm.init_empty_weights(port.CausalLM, config), path,
                                        device_map={"": "cpu"}, config=config, hf_format=True)
    rcfg = ref.infer_config_from_hf(path, attention_impl="xla")
    with pytest.raises(ValueError, match="not consumed"):
        ref_bm.load_checkpoint_and_dispatch(_ref_abstract(rcfg), path, device_map={"": "cpu"},
                                            config=rcfg, hf_format=True)


def test_llama31_rope_scaled_checkpoint_logits_match_torch(tmp_path):
    hf_model, path = _save_hf_llama(tmp_path, seed=6, rope_scaling=_LLAMA31_ROPE_SCALING)
    pcfg, _, tree, ours = _check_logits(path, hf_model, 2e-4)
    assert pcfg.rope_scaling.get("rope_type") == "llama3"
    # the scaling moves the forward: without it the logits leave transformers'
    theirs = _torch_logits(hf_model, _IDS)
    unscaled = _port_logits(_port_model(dataclasses.replace(pcfg, rope_scaling=None), tree), _IDS)
    assert np.abs(unscaled - theirs).max() > np.abs(ours - theirs).max()


def _greedy_three_ways(path, hf_model, new_tokens):
    """Greedy tokens of the port, the reference and transformers from the
    first 8 prompt tokens: all equal."""
    pcfg, model, _, rcfg, rparams = _load_both(path)
    prompt = _IDS[:, :8]
    ours = generate(model, torch.from_numpy(prompt).long(), max_new_tokens=new_tokens)
    theirs = jax_generate(jax_causal_model_for(rcfg), rparams, jnp.asarray(prompt),
                          max_new_tokens=new_tokens)
    with torch.no_grad():
        hf = hf_model.generate(torch.from_numpy(prompt).long(), max_new_tokens=new_tokens,
                               do_sample=False)
    assert hf.shape[1] == prompt.shape[1] + new_tokens, hf.shape  # no early EOS
    assert (ours[0, -new_tokens:].tolist() == np.asarray(theirs)[0, -new_tokens:].tolist()
            == hf[0, -new_tokens:].tolist())


def test_llama31_rope_scaled_generation_matches_torch_greedy(tmp_path):
    hf_model, path = _save_hf_llama(tmp_path, seed=11, rope_scaling=_LLAMA31_ROPE_SCALING)
    _greedy_three_ways(path, hf_model, 6)


def test_linear_rope_scaling_matches_torch(tmp_path):
    cfg = transformers.LlamaConfig(**_hf_kw(rope_scaling={"rope_type": "linear", "factor": 4.0}))
    hf_model, path = _save_hf(tmp_path, transformers.LlamaForCausalLM, cfg, 7, "hf_llama_linear")
    _check_logits(path, hf_model, 2e-4)


def test_sharded_hf_checkpoint_with_index(tmp_path):
    config = port.TransformerConfig(**_TINY, attention_impl="xla")
    model = port.CausalLM(config, device="cpu", generator=torch.Generator().manual_seed(4))
    out = str(tmp_path / "sharded")
    hi.save_hf_checkpoint(model, config, out, max_shard_size=64 * 1024)
    assert os.path.isfile(os.path.join(out, "model.safetensors.index.json"))
    assert len(hi.list_hf_checkpoint_files(out)) > 1
    assert hi.list_checkpoint_keys(out) == ref.list_checkpoint_keys(out)
    reloaded = bm.load_checkpoint_and_dispatch(bm.init_empty_weights(port.CausalLM, config), out,
                                               device_map={"": "cpu"})
    np.testing.assert_array_equal(_port_logits(_port_model(config, reloaded), _IDS),
                                  _port_logits(model, _IDS))
    # the reference reads the port's shards into the same weights
    rcfg = JaxConfig(**_TINY, attention_impl="xla")
    rparams = ref_bm.load_checkpoint_and_dispatch(_ref_abstract(rcfg), out,
                                                  device_map={"": "cpu"})
    for name, t in port.params_from_jax(nn.unbox(rparams), config).items():
        assert torch.equal(t, reloaded[name]), name


def test_bf16_checkpoint_loads(tmp_path):
    hf_model, path = _save_hf_llama(tmp_path, dtype=torch.bfloat16, seed=5)
    pcfg, _, tree, ours = _check_logits(path, hf_model, 0.12, port_tol=BF16_LOGITS_TOL,
                                        dtype="bfloat16")
    assert {t.dtype for t in tree.values()} == {torch.bfloat16}  # the checkpoint's dtype
    theirs = _torch_logits(hf_model, _IDS)
    np.testing.assert_allclose(ours, theirs, rtol=0.1, atol=0.12)
    assert np.mean(ours.argmax(-1) == theirs.argmax(-1)) > 0.9


def test_qwen2_checkpoint_logits_match_torch(tmp_path):
    hf_model, path = _save_hf_qwen2(tmp_path)
    pcfg, _, tree, _ = _check_logits(path, hf_model, 2e-4)
    assert pcfg.qkv_bias and "layers.0.attn.q_proj.bias" in tree
    out = str(tmp_path / "qwen2_export")
    hi.save_hf_checkpoint(tree, pcfg, out)
    assert json.load(open(os.path.join(out, "config.json")))["model_type"] == "qwen2"
    hf2 = transformers.Qwen2ForCausalLM.from_pretrained(out).eval()
    np.testing.assert_allclose(_torch_logits(hf2, _IDS), _torch_logits(hf_model, _IDS),
                               rtol=2e-4, atol=2e-4)


def test_qwen2_sliding_window_logits_match_torch(tmp_path):
    hf_model, path = _save_hf_qwen2(tmp_path, seed=13, use_sliding_window=True,
                                    sliding_window=4, max_window_layers=0)
    pcfg, _, tree, ours = _check_logits(path, hf_model, 2e-4)
    assert pcfg.sliding_window == 4 and pcfg.qkv_bias
    full = _port_logits(_port_model(dataclasses.replace(pcfg, sliding_window=None), tree), _IDS)
    assert float(np.max(np.abs(full - ours))) > 1e-2  # the band is live
    out = str(tmp_path / "qwen2_sw_export")
    hi.save_hf_checkpoint(tree, pcfg, out)
    cfg_json = json.load(open(os.path.join(out, "config.json")))
    assert cfg_json["use_sliding_window"] and cfg_json["sliding_window"] == 4
    assert hi.infer_config_from_hf(out).sliding_window == 4


def test_sliding_layers_with_null_window_rejected(tmp_path):
    base = dict(vocab_size=_TINY["vocab_size"], hidden_size=_TINY["hidden_size"],
                intermediate_size=_TINY["intermediate_size"], num_hidden_layers=2,
                num_attention_heads=_TINY["num_heads"],
                num_key_value_heads=_TINY["num_kv_heads"],
                max_position_embeddings=_TINY["max_seq_len"])
    for name, extra in (("qwen2_null_window", {"model_type": "qwen2", "use_sliding_window": True,
                                               "sliding_window": None, "layer_types": [
                                                   "full_attention", "sliding_attention"]}),
                        ("gemma2_null_window", {"model_type": "gemma2",
                                                "sliding_window": None})):
        d = tmp_path / name
        d.mkdir()
        (d / "config.json").write_text(json.dumps({**base, **extra}))
        for pkg in (hi, ref):
            with pytest.raises(ValueError, match="sliding_window is null"):
                pkg.infer_config_from_hf(str(d))


def test_mistral_sliding_window_logits_match_torch(tmp_path):
    hf_model, path = _save_hf_mistral(tmp_path, sliding_window=4)
    assert hi.is_hf_checkpoint(path)
    pcfg, _, tree, ours = _check_logits(path, hf_model, 2e-4)
    assert pcfg.sliding_window == 4 and not pcfg.qkv_bias
    full = _port_logits(_port_model(dataclasses.replace(pcfg, sliding_window=None), tree), _IDS)
    assert float(np.max(np.abs(full - ours))) > 1e-2
    out = str(tmp_path / "mistral_export")
    hi.save_hf_checkpoint(tree, pcfg, out)
    assert json.load(open(os.path.join(out, "config.json")))["model_type"] == "mistral"
    hf2 = transformers.MistralForCausalLM.from_pretrained(out).eval()
    np.testing.assert_allclose(_torch_logits(hf2, _IDS), _torch_logits(hf_model, _IDS),
                               rtol=2e-4, atol=2e-4)


def test_mistral_generate_matches_torch_greedy(tmp_path):
    """The decode path anchors the band at the global position: greedy
    tokens past the window equal transformers' and the reference's."""
    hf_model, path = _save_hf_mistral(tmp_path, seed=16, sliding_window=4)
    _greedy_three_ways(path, hf_model, 8)


def test_unrepresentable_export_combos_rejected():
    ok = port.TransformerConfig(**_TINY, attention_impl="xla")
    assert hi._export_arch(ok) == ref._export_arch(JaxConfig(**_TINY)) == (
        "LlamaForCausalLM", "llama")
    gemma = dict(_TINY, attention_impl="xla", norm_offset=True, mlp_activation="gelu_tanh",
                 embed_scale=True, tie_embeddings=True)
    assert hi._export_arch(port.TransformerConfig(**gemma)) == ("GemmaForCausalLM", "gemma")
    for change, match in ((dict(embed_scale=False), "partial Gemma"),
                          (dict(qkv_bias=True), "combination"),
                          (dict(num_experts=4, moe_dispatch="dense"), "combination"),
                          (dict(tie_embeddings=False), "tied")):
        for cfg_cls, pkg in ((port.TransformerConfig, hi), (JaxConfig, ref)):
            with pytest.raises(ValueError, match=match):
                pkg._export_arch(cfg_cls(**{**gemma, **change}))


def test_moe_with_qkv_bias_export_rejected(tmp_path):
    config = port.TransformerConfig(**_TINY, attention_impl="xla", num_experts=4,
                                    num_experts_per_tok=2, qkv_bias=True, moe_dispatch="dense")
    model = port.CausalLM(config, device="cpu")
    with pytest.raises(ValueError, match="combination"):
        hi.save_hf_checkpoint(model, config, str(tmp_path / "bad"))
    assert not os.path.exists(tmp_path / "bad")  # refused before anything is written


def test_gemma3_rejected(tmp_path):
    _, path = _save_hf_llama(tmp_path)
    cfg_path = os.path.join(path, "config.json")
    json.dump({**json.load(open(cfg_path)), "model_type": "gemma3"}, open(cfg_path, "w"))
    for pkg in (hi, ref):
        with pytest.raises(ValueError, match="gemma3"):
            pkg.infer_config_from_hf(path)


def test_gpt2_reads_as_the_reference_and_waits_for_its_model(tmp_path):
    """A GPT-2 checkpoint's config reads as the reference's, and its model
    and its name mapping are ported now (the slice of the model zoo): the
    config builds ``GPT2LM``, whose names map onto ``transformer.*``, and a
    Llama name has no GPT-2 counterpart."""
    cfg = transformers.GPT2Config(vocab_size=256, n_embd=64, n_layer=2, n_head=4, n_positions=64)
    _, path = _save_hf(tmp_path, transformers.GPT2LMHeadModel, cfg, 8, "hf_gpt2")
    assert hi.is_hf_checkpoint(path)
    pcfg = hi.infer_config_from_hf(path)
    assert dataclasses.asdict(pcfg) == dataclasses.asdict(ref.infer_config_from_hf(path))
    assert isinstance(causal_model_for(pcfg, device="meta"), GPT2LM)
    assert hi._plan_for("wte.weight", pcfg).keys == ["transformer.wte.weight"]
    plan = hi._plan_for("layers.1.mlp.c_fc.weight", pcfg)
    assert plan.keys == ["transformer.h.1.mlp.c_fc.weight"] and plan.transpose
    with pytest.raises(KeyError, match="GPT-2"):
        hi._plan_for("embed.weight", pcfg)


# ---------------------------------------------------------------------- #
# tests/test_adapters.py::test_peft_export_layout_map
# ---------------------------------------------------------------------- #
def test_peft_export_layout_map():
    jcfg = JaxConfig.tiny()
    pcfg = port.TransformerConfig.tiny()
    lcfg = LoraConfig(rank=4, target_modules=("q_proj", "gate_proj"))
    jlcfg = JaxLoraConfig(rank=4, target_modules=("q_proj", "gate_proj"))
    jad = jax.tree.map(lambda x: x + 0.01, jax_init_adapter(jax.random.PRNGKey(0), jcfg, jlcfg))
    ad = port.params_from_jax(jax.tree.map(np.asarray, jad), pcfg)
    sd = adapter_to_peft(ad, lcfg, pcfg)
    want = ref.adapter_to_peft(jad, jlcfg, jcfg)
    assert list(sd) == list(want) and len(sd) == 2 * 2 * pcfg.num_layers
    for key, t in sd.items():
        np.testing.assert_array_equal(t.numpy(), want[key], err_msg=key)
    h, f = pcfg.hidden_size, pcfg.intermediate_size
    assert sd["base_model.model.model.layers.0.self_attn.q_proj.lora_A.weight"].shape == (4, h)
    assert sd["base_model.model.model.layers.1.self_attn.q_proj.lora_B.weight"].shape == (
        pcfg.num_heads * pcfg.head_dim, 4)
    assert sd["base_model.model.model.layers.1.mlp.gate_proj.lora_B.weight"].shape == (f, 4)
    back = peft_to_adapter(sd, lcfg, pcfg)
    for t in lcfg.target_modules:
        for key in (A_KEY, B_KEY):
            assert torch.equal(back[t][key], ad[t][key])
    with pytest.raises(ValueError, match="layer dim"):
        adapter_to_peft({t: {k: v[:1] for k, v in pair.items()} for t, pair in ad.items()},
                        lcfg, pcfg)


# ---------------------------------------------------------------------- #
# loads onto a mesh (queue A7 part 2): one world-4 launch over gloo
# ---------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def mesh_loads(tmp_path_factory):
    """An HF Llama checkpoint built here, loaded at world 4 onto fsdp 4 and
    onto fsdp 2 x tp 2 (the model's logical axes passed explicitly, as the
    reference passes ``get_logical_specs``); returns the checkpoint, the
    transformers model, the port's config and each load's record."""
    from accelerate_tpu_torch.launchers import debug_launcher
    from accelerate_tpu_torch.test_utils.scripts import sharding_workers

    out = tmp_path_factory.mktemp("hf_mesh")
    hf_model, path = _save_hf_llama(out)
    config = hi.infer_config_from_hf(path, attention_impl="xla")
    with open(out / "config.json", "w") as f:
        json.dump(dataclasses.asdict(config), f)
    torch.save(torch.from_numpy(_IDS).long(), out / "ids.pt")
    cases = [dict(name="hf_fsdp4", plugin=dict(dp_size=1, fsdp_size=4, min_weight_size=16),
                  checkpoint=path, kind="model", hf=True, config=str(out / "config.json")),
             dict(name="hf_tp_fsdp", plugin=dict(dp_size=1, fsdp_size=2, tp_size=2,
                                                 min_weight_size=16,
                                                 sharding_strategy="full_shard"),
                  checkpoint=path, kind="model", hf=True, logical=True,
                  config=str(out / "config.json"))]
    debug_launcher(sharding_workers.mesh_load_worker, (str(out), cases), num_processes=4)
    records = {c["name"]: torch.load(out / f"{c['name']}.pt") for c in cases}
    return path, hf_model, config, records


def test_gspmd_and_device_map_paths_identical(mesh_loads):
    """The same HF checkpoint loaded onto the mesh (fsdp 4) and through the
    cpu device map: the weights bit for bit, the logits (the mesh's through
    ``apply_sharded``) within the reference test's fp32 bounds."""
    path, _, config, records = mesh_loads
    rec = records["hf_fsdp4"]
    host = bm.load_checkpoint_and_dispatch(bm.init_empty_weights(port.CausalLM, config), path,
                                           device_map={"": "cpu"})
    assert set(rec["whole"]) == set(host)
    for name, t in host.items():
        assert torch.equal(rec["whole"][name], t), name
    assert any("fsdp" in str(s) for s in rec["specs"].values())
    logits_host = _port_logits(_port_model(config, host), _IDS)
    np.testing.assert_allclose(rec["logits"].numpy(), logits_host, rtol=1e-5, atol=1e-6)


def test_hf_load_onto_tp_fsdp_mesh(mesh_loads):
    """HF weights onto a tp x fsdp mesh: the embedding takes its (vocab ->
    (tp, fsdp)) layout, the projections pick up tp, and the forward matches
    transformers' within the reference test's bound."""
    _, hf_model, _, records = mesh_loads
    rec = records["hf_tp_fsdp"]
    assert rec["specs"]["embed.weight"] == (("tp", "fsdp"), None)
    assert "tp" in str(rec["specs"]["layers.0.attn.q_proj.weight"])
    assert "tp" in str(rec["specs"]["layers.0.mlp.down_proj.weight"])
    np.testing.assert_allclose(rec["logits"].numpy(), _torch_logits(hf_model, _IDS),
                               rtol=5e-4, atol=5e-4)


# ---------------------------------------------------------------------- #
# GPT-2 (reference :440-622)
# ---------------------------------------------------------------------- #
def _save_hf_gpt2(tmp_path, seed=8):
    cfg = transformers.GPT2Config(
        vocab_size=_TINY["vocab_size"], n_embd=64, n_inner=None, n_layer=2, n_head=4,
        n_positions=64, layer_norm_epsilon=1e-5, activation_function="gelu_new",
        resid_pdrop=0.0, embd_pdrop=0.0, attn_pdrop=0.0)
    return _save_hf(tmp_path, transformers.GPT2LMHeadModel, cfg, seed, "hf_gpt2")


def test_gpt2_checkpoint_logits_match_torch(tmp_path):
    hf_model, path = _save_hf_gpt2(tmp_path)
    assert hi.is_hf_checkpoint(path)
    pcfg, model, tree, _ = _check_logits(path, hf_model, 2e-4)
    assert pcfg.arch == "gpt2" and pcfg.tie_embeddings
    assert isinstance(causal_model_for(pcfg, device="meta"), GPT2LM)
    # Conv1D's (in, out) transposed to the port's (out, in)
    assert tree["layers.0.attn.c_attn.weight"].shape == (192, 64)


def test_gpt2_unprefixed_hub_layout_loads(tmp_path):
    hf_model, path = _save_hf_gpt2(tmp_path)
    named = _files(path)
    unprefixed = {k.removeprefix("transformer."): t for k, t in named.items()}
    assert any(k.startswith("h.0.") for k in unprefixed)
    out = tmp_path / "hf_gpt2_unprefixed"
    out.mkdir()
    safetensors_io.save_file(unprefixed, str(out / "model.safetensors"),
                             metadata={"format": "pt"})
    (out / "config.json").write_text(open(os.path.join(path, "config.json")).read())
    assert hi.is_hf_checkpoint(str(out))
    _check_logits(str(out), hf_model, 2e-4)


def test_gpt2_generate_matches_torch_greedy(tmp_path):
    hf_model, path = _save_hf_gpt2(tmp_path, seed=9)
    _greedy_three_ways(path, hf_model, 6)


def test_gpt2_export_loads_in_transformers(tmp_path):
    rcfg = JaxConfig.gpt2(vocab_size=_TINY["vocab_size"], hidden_size=64, intermediate_size=256,
                          num_layers=2, num_heads=4, max_seq_len=64, attention_impl="xla")
    rparams = nn.unbox(jax_causal_model_for(rcfg).init(jax.random.PRNGKey(10),
                                                      jnp.zeros((1, 8), jnp.int32))["params"])
    pcfg = port.TransformerConfig(**dataclasses.asdict(rcfg))
    params = port.params_from_jax(rparams, pcfg)
    out, cfg = _exports_agree(params, pcfg, rparams, rcfg, tmp_path, "gpt2_export")
    assert cfg["model_type"] == "gpt2"
    hf_model = transformers.GPT2LMHeadModel.from_pretrained(out).eval()
    ours = _port_logits(_port_model(pcfg, params), _IDS)
    np.testing.assert_allclose(ours, _torch_logits(hf_model, _IDS), rtol=2e-4, atol=2e-4)


def test_gpt2_attention_math_variants_rejected(tmp_path):
    _, path = _save_hf_gpt2(tmp_path)
    cfg_path = os.path.join(path, "config.json")
    hf_cfg = json.load(open(cfg_path))
    for field in ("scale_attn_by_inverse_layer_idx", "reorder_and_upcast_attn"):
        json.dump({**hf_cfg, field: True}, open(cfg_path, "w"))
        for pkg in (hi, ref):
            with pytest.raises(ValueError, match="attention math"):
                pkg.infer_config_from_hf(path)


# ---------------------------------------------------------------------- #
# Gemma, Gemma-2 and Qwen2's mixed windows (reference :688-712, :855-926,
# :995-1035)
# ---------------------------------------------------------------------- #
def test_gemma_checkpoint_logits_match_torch(tmp_path):
    cfg = transformers.GemmaConfig(**_hf_kw(head_dim=32))
    hf_model, path = _save_hf(tmp_path, transformers.GemmaForCausalLM, cfg, 15, "hf_gemma")
    pcfg, model, tree, ours = _check_logits(path, hf_model, 3e-4)
    assert pcfg.norm_offset and pcfg.embed_scale and pcfg.mlp_activation == "gelu_tanh"
    assert pcfg.tie_embeddings and pcfg.head_dim == 32
    _, rcfg = None, ref.infer_config_from_hf(path, attention_impl="xla")
    rparams = ref_bm.load_checkpoint_and_dispatch(_ref_abstract(rcfg), path,
                                                  device_map={"": "cpu"})
    out, json_cfg = _exports_agree(tree, pcfg, nn.unbox(rparams), rcfg, tmp_path, "gemma")
    assert json_cfg["model_type"] == "gemma"
    hf2 = transformers.GemmaForCausalLM.from_pretrained(out).eval()
    np.testing.assert_allclose(_torch_logits(hf2, _IDS), _torch_logits(hf_model, _IDS),
                               rtol=3e-4, atol=3e-4)


def _save_hf_gemma2(tmp_path, seed=21):
    """The reference test's Gemma-2: head_dim 16 with the scale decoupled
    (32), a window of 4 on every other layer, tiny caps (1 and 5) and q/k
    and the embedding amplified so every switch bends the numbers; eager
    attention (transformers' sdpa path drops the softcap)."""
    cfg = transformers.Gemma2Config(
        vocab_size=_TINY["vocab_size"], hidden_size=64, intermediate_size=128,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2, head_dim=16,
        query_pre_attn_scalar=32.0, sliding_window=4, attn_logit_softcapping=1.0,
        final_logit_softcapping=5.0, max_position_embeddings=64, rope_theta=10000.0,
        rms_norm_eps=1e-5, hidden_activation="gelu_pytorch_tanh", attention_dropout=0.0)
    cfg._attn_implementation = "eager"
    torch.manual_seed(seed)
    model = transformers.Gemma2ForCausalLM(cfg).eval()
    with torch.no_grad():
        for layer in model.model.layers:
            layer.self_attn.q_proj.weight *= 10.0
            layer.self_attn.k_proj.weight *= 10.0
        model.model.embed_tokens.weight *= 4.0
    path = str(tmp_path / "hf_gemma2")
    model.save_pretrained(path, safe_serialization=True)
    return model, path


def test_gemma2_checkpoint_logits_match_torch(tmp_path):
    hf_model, path = _save_hf_gemma2(tmp_path)
    pcfg, model, tree, ours = _check_logits(path, hf_model, 3e-4)
    assert pcfg.layer_windows == (4, None) and pcfg.post_norms and pcfg.attn_softcap == 1.0
    assert pcfg.query_pre_attn_scalar == 32.0 and pcfg.tie_embeddings
    assert "layers.0.post_attn_norm.weight" in tree
    for off in ({"layer_windows": (None, None)}, {"attn_softcap": None},
                {"final_softcap": None}, {"query_pre_attn_scalar": None}):
        moved = _port_logits(_port_model(dataclasses.replace(pcfg, **off), tree), _IDS)
        assert float(np.abs(moved - ours).max()) > 1e-3, off
    rcfg = ref.infer_config_from_hf(path, attention_impl="xla")
    rparams = ref_bm.load_checkpoint_and_dispatch(_ref_abstract(rcfg), path,
                                                  device_map={"": "cpu"})
    out, json_cfg = _exports_agree(tree, pcfg, nn.unbox(rparams), rcfg, tmp_path, "gemma2")
    assert json_cfg["model_type"] == "gemma2"
    assert json_cfg["layer_types"] == ["sliding_attention", "full_attention"]
    hf2 = transformers.Gemma2ForCausalLM.from_pretrained(out, attn_implementation="eager").eval()
    np.testing.assert_allclose(_torch_logits(hf2, _IDS), _torch_logits(hf_model, _IDS),
                               rtol=3e-4, atol=3e-4)


def test_gemma2_generate_matches_torch_greedy(tmp_path):
    hf_model, path = _save_hf_gemma2(tmp_path, seed=22)
    _greedy_three_ways(path, hf_model, 8)


def test_qwen2_mixed_window_layers_load(tmp_path):
    hf_model, path = _save_hf_qwen2(tmp_path, seed=14, use_sliding_window=True,
                                    sliding_window=4, max_window_layers=1)
    pcfg, model, tree, ours = _check_logits(path, hf_model, 2e-4)
    assert pcfg.sliding_window is None and pcfg.layer_windows == (None, 4)
    full = _port_logits(_port_model(dataclasses.replace(pcfg, layer_windows=(None, None)), tree),
                        _IDS)
    assert float(np.abs(full - ours).max()) > 1e-2
