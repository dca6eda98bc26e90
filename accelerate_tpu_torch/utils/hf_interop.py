"""HF checkpoint interop: the names of HF transformers safetensors
checkpoints (the Llama and Mixtral conventions) mapped onto the port's
parameters and back.

Port of ``accelerate_tpu/utils/hf_interop.py`` (``list_hf_checkpoint_files``
:77, ``list_checkpoint_keys`` :94, ``is_hf_checkpoint`` :125,
``infer_config_from_hf`` :148, ``_plan_for`` :424, ``hf_native_reader``
:490, ``native_to_hf`` :607, ``_export_arch`` :655, ``save_hf_checkpoint``
:735, ``adapter_to_peft`` :924, ``peft_to_adapter`` :954), reading and
writing through the port's own safetensors codec.

The port's names are HF's under a renaming, one tensor a layer as in HF:
``embed.weight`` is ``model.embed_tokens.weight``, ``layers.<i>.attn.
<q|k|v|o>_proj`` is ``model.layers.<i>.self_attn.<...>``, ``attn_norm`` and
``mlp_norm`` are ``input_layernorm`` and ``post_attention_layernorm``,
``layers.<i>.mlp.*`` is ``model.layers.<i>.mlp.*``, ``final_norm`` is
``model.norm`` and ``lm_head`` is ``lm_head``. Linear weights are (out, in)
in both, so nothing transposes, with one exception: the MoE expert stacks,
kept untransposed (E, in, out) as in the reference, stack HF's per-expert
``w1``/``w3``/``w2`` (gate, up, down) transposed; the router is
``block_sparse_moe.gate``. A tied checkpoint omits ``lm_head.weight``; an
untied model reading one re-ties it from the embedding.

Gemma-2's four norms a block map as in the reference: ``post_attn_norm``
is HF's ``post_attention_layernorm`` and ``mlp_norm`` its
``pre_feedforward_layernorm`` (:345-355). GPT-2 (``arch="gpt2"``,
``models/gpt2.GPT2LM``) maps ``wte``, ``wpe``, ``ln_f`` and each layer's
``ln_1``, ``ln_2``, ``attn.c_attn``, ``attn.c_proj``, ``mlp.c_fc`` and
``mlp.c_proj`` onto ``transformer.*`` (reference ``_plan_for_gpt2``
:384-422); HF's Conv1D stores (in, out), so the port's (out, in)
projection weights transpose both ways. The hub's unprefixed GPT-2 layout
(``wte.weight``, ``h.0.attn.c_attn.weight``) reads as the prefixed one.
"""

from __future__ import annotations

import json
import os
import re
from typing import Any, Iterator

import torch
from torch import nn

from . import safetensors_io
from .constants import SAFE_WEIGHTS_INDEX_NAME as _HF_INDEX_NAME
from .constants import SAFE_WEIGHTS_NAME as _HF_WEIGHTS_NAME

# HF's file names equal the port's native ones, so the format is told from
# tensor names, never from file names.


# ---------------------------------------------------------------------- #
# checkpoint introspection
# ---------------------------------------------------------------------- #
def list_hf_checkpoint_files(checkpoint: str) -> list[str]:
    """The safetensors files of ``checkpoint`` (a directory or one file)."""
    return sorted(set(_key_files(checkpoint).values()))


def _key_files(checkpoint: str) -> dict[str, str]:
    return safetensors_io.checkpoint_files(checkpoint, _HF_INDEX_NAME, _HF_WEIGHTS_NAME)


def list_checkpoint_keys(checkpoint: str) -> list[str]:
    """Every tensor name of the checkpoint, from the index or the headers:
    no tensor is read."""
    return sorted(_key_files(checkpoint))


def _is_unprefixed_gpt2_key(k: str) -> bool:
    """The hub's GPT-2 checkpoints store the base model's names unprefixed."""
    return (k in ("wte.weight", "wpe.weight") or k.startswith("ln_f.")
            or re.match(r"h\.\d+\.", k) is not None)


def is_hf_checkpoint(checkpoint: str) -> bool:
    """True when the checkpoint's names follow HF transformers (the Llama
    family's ``model.embed_tokens.weight`` / ``model.layers.<i>...``, or
    GPT-2's, prefixed or not) rather than the port's native names."""
    try:
        keys = list_checkpoint_keys(checkpoint)
    except (FileNotFoundError, OSError):
        return False
    return any(
        k == "model.embed_tokens.weight" or k.startswith("model.layers.")
        or k == "transformer.wte.weight" or k.startswith("transformer.h.")
        or _is_unprefixed_gpt2_key(k)
        for k in keys
    )


def infer_config_from_hf(checkpoint: str, **overrides) -> Any:
    """A :class:`TransformerConfig` from the HF ``config.json`` beside the
    weights (reference :148): every field that shapes or changes the math,
    and a refusal for what no mapping represents."""
    from ..models.config import TransformerConfig

    cfg_path = os.path.join(checkpoint, "config.json")
    if not os.path.isfile(cfg_path):
        raise FileNotFoundError(f"{cfg_path} not found: pass a TransformerConfig explicitly")
    with open(cfg_path) as f:
        hf = json.load(f)
    model_type = hf.get("model_type", "llama")
    if model_type == "gpt2":
        act = hf.get("activation_function", "gelu_new")
        if act not in ("gelu_new", "gelu_pytorch_tanh"):
            raise ValueError(f"GPT-2 activation_function {act!r} is not the tanh GELU the "
                             "native GPT2LM implements")
        if (not hf.get("scale_attn_weights", True)
                or hf.get("scale_attn_by_inverse_layer_idx", False)
                or hf.get("reorder_and_upcast_attn", False)):
            raise ValueError(
                "GPT-2 checkpoints with scale_attn_weights=False, "
                "scale_attn_by_inverse_layer_idx or reorder_and_upcast_attn use attention math "
                "the native GPT2LM does not implement")
        kw = dict(
            arch="gpt2", vocab_size=hf["vocab_size"], hidden_size=hf["n_embd"],
            intermediate_size=hf.get("n_inner") or 4 * hf["n_embd"], num_layers=hf["n_layer"],
            num_heads=hf["n_head"], max_seq_len=hf.get("n_positions", hf.get("n_ctx", 1024)),
            rms_norm_eps=float(hf.get("layer_norm_epsilon", 1e-5)), tie_embeddings=True,
        )
        kw.update(overrides)
        return TransformerConfig(**kw)
    rope_scaling = hf.get("rope_scaling")

    # sliding windows as transformers resolves them: Mistral and Mixtral band
    # every layer; Qwen2 only under use_sliding_window, layers from
    # max_window_layers on; Gemma-2 every other layer. One width on every
    # layer is sliding_window, a mix layer_windows
    def _resolve_layer_types(layer_types, w):
        kinds = set(layer_types)
        if kinds == {"full_attention"}:
            return None, None
        if w is None:
            raise ValueError(
                "layer_types declares 'sliding_attention' layers but config sliding_window is "
                "null/absent; refusing to load the checkpoint as full attention")
        if kinds == {"sliding_attention"}:
            return w, None
        return None, tuple(w if t == "sliding_attention" else None for t in layer_types)

    sliding_window = layer_windows = None
    if model_type in ("mistral", "mixtral"):
        sliding_window = hf.get("sliding_window")
    elif model_type == "qwen2" and hf.get("use_sliding_window", False):
        w = hf.get("sliding_window")
        layer_types = hf.get("layer_types")
        if layer_types is None and w is not None:
            layer_types = ["sliding_attention" if i >= hf.get("max_window_layers", 28)
                           else "full_attention" for i in range(hf["num_hidden_layers"])]
        if layer_types is not None:
            sliding_window, layer_windows = _resolve_layer_types(layer_types, w)
    elif model_type == "gemma2":
        w = hf.get("sliding_window", 4096)
        layer_types = hf.get("layer_types") or [
            "sliding_attention" if (i + 1) % 2 else "full_attention"
            for i in range(hf["num_hidden_layers"])]
        sliding_window, layer_windows = _resolve_layer_types(layer_types, w)
    if model_type in ("gemma3", "gemma3_text"):
        raise ValueError(
            f"HF model_type {model_type!r} is not supported: Gemma-3 qk-norms / dual rope "
            "bases are not implemented (Gemma v1 loads via model_type 'gemma', Gemma-2 via "
            "'gemma2')")
    if model_type not in ("llama", "mistral", "mixtral", "qwen2", "gemma", "gemma2"):
        raise ValueError(
            f"HF model_type {model_type!r} is not supported by the parameter mappings; "
            "supported: llama, mistral, mixtral, qwen2, gemma, gpt2")
    kw = dict(
        vocab_size=hf["vocab_size"], hidden_size=hf["hidden_size"],
        intermediate_size=hf["intermediate_size"], num_layers=hf["num_hidden_layers"],
        num_heads=hf["num_attention_heads"],
        num_kv_heads=hf.get("num_key_value_heads", hf["num_attention_heads"]),
        max_seq_len=hf.get("max_position_embeddings", 2048),
        rope_theta=float(hf.get("rope_theta", 10000.0)), rope_scaling=rope_scaling,
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-5)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", False)),
        sliding_window=sliding_window, layer_windows=layer_windows,
        qkv_bias=model_type == "qwen2",  # Qwen2's biases on q/k/v only
    )
    if model_type == "mistral" and hf.get("head_dim"):
        kw["head_dim"] = hf["head_dim"]  # Mistral-NeMo decouples head_dim
    if model_type in ("gemma", "gemma2"):
        act = hf.get("hidden_activation") or hf.get("hidden_act")
        if act not in (None, "gelu", "gelu_pytorch_tanh"):
            raise ValueError(f"Gemma hidden_activation {act!r} is not the tanh GELU the native "
                             "model implements")
        kw.update(norm_offset=True, mlp_activation="gelu_tanh", embed_scale=True,
                  tie_embeddings=True, head_dim=hf.get("head_dim"))
    if model_type == "gemma2":
        kw.update(post_norms=True,
                  query_pre_attn_scalar=float(hf.get("query_pre_attn_scalar", 256)),
                  attn_softcap=hf.get("attn_logit_softcapping", 50.0),
                  final_softcap=hf.get("final_logit_softcapping", 30.0))
    if hf.get("num_local_experts"):
        kw["num_experts"] = hf["num_local_experts"]
        kw["num_experts_per_tok"] = hf.get("num_experts_per_tok", 2)
    kw.update(overrides)
    return TransformerConfig(**kw)


# ---------------------------------------------------------------------- #
# the port's name -> HF names
# ---------------------------------------------------------------------- #
_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_MLP = ("gate_proj", "up_proj", "down_proj")
_NORMS = {"attn_norm": "input_layernorm", "mlp_norm": "post_attention_layernorm"}
# Gemma-2's four norms a block: HF's post_attention_layernorm is the norm
# after attention, and the MLP's pre-norm is pre_feedforward_layernorm
_NORMS_POST = {"attn_norm": "input_layernorm", "post_attn_norm": "post_attention_layernorm",
               "mlp_norm": "pre_feedforward_layernorm",
               "post_mlp_norm": "post_feedforward_layernorm"}
# GPT-2: the port's top-level and per-layer names -> HF's (``transformer.``)
_GPT2_TOP = {"wte.weight": "transformer.wte.weight", "wpe.weight": "transformer.wpe.weight",
             "ln_f.weight": "transformer.ln_f.weight", "ln_f.bias": "transformer.ln_f.bias"}
_GPT2_INNER = ("ln_1", "ln_2", "attn.c_attn", "attn.c_proj", "mlp.c_fc", "mlp.c_proj")
_MOE_EXPERT = {"gate_proj": "w1", "up_proj": "w3", "down_proj": "w2"}  # Mixtral's


class _HfPlanEntry:
    """How one of the port's tensors is made of HF tensors: ``keys``, one
    name (transposed when ``transpose``: GPT-2's Conv1D weights), or
    (``experts``) one name an expert, each transposed and stacked on a new
    leading axis."""

    __slots__ = ("keys", "experts", "transpose")

    def __init__(self, keys: list[str], experts: bool = False, transpose: bool = False):
        self.keys, self.experts, self.transpose = keys, experts, transpose


def _plan_for_gpt2(name: str) -> _HfPlanEntry:
    """GPT-2's plan (reference :384-422): ``transformer.h.<i>.*`` a layer,
    the Conv1D weights transposed."""
    if name in _GPT2_TOP:
        return _HfPlanEntry([_GPT2_TOP[name]])
    m = re.fullmatch(r"layers\.(\d+)\.(.+)\.(weight|bias)", name)
    if m and m.group(2) in _GPT2_INNER:
        conv = m.group(2).startswith(("attn.", "mlp.")) and m.group(3) == "weight"
        return _HfPlanEntry([f"transformer.h.{m.group(1)}.{m.group(2)}.{m.group(3)}"],
                            transpose=conv)
    raise KeyError(f"no GPT-2 HF mapping for the port's parameter {name!r}")


def _plan_for(name: str, config) -> _HfPlanEntry:
    """The plan for one of the port's parameter names (dotted, or
    ``//``-joined); raises KeyError for a name with no HF counterpart."""
    name = name.replace("//", ".")
    if getattr(config, "arch", "llama") == "gpt2":
        return _plan_for_gpt2(name)
    top = {"embed.weight": "model.embed_tokens.weight", "final_norm.weight": "model.norm.weight",
           "lm_head.weight": "lm_head.weight"}
    if name in top:
        return _HfPlanEntry([top[name]])
    m = re.fullmatch(r"layers\.(\d+)\.(.+)", name)
    if m:
        p, rest = f"model.layers.{m.group(1)}", m.group(2).split(".")
        if len(rest) == 3 and rest[0] == "attn" and rest[1] in _ATTN and rest[2] == "weight":
            return _HfPlanEntry([f"{p}.self_attn.{rest[1]}.weight"])
        if (len(rest) == 3 and rest[0] == "attn" and rest[1] in _ATTN[:3] and rest[2] == "bias"
                and getattr(config, "qkv_bias", False)):
            return _HfPlanEntry([f"{p}.self_attn.{rest[1]}.bias"])  # Qwen2
        norms = _NORMS_POST if getattr(config, "post_norms", False) else _NORMS
        if len(rest) == 2 and rest[0] in norms and rest[1] == "weight":
            return _HfPlanEntry([f"{p}.{norms[rest[0]]}.weight"])
        if len(rest) == 3 and rest[0] == "mlp" and rest[1] in _MLP and rest[2] == "weight":
            return _HfPlanEntry([f"{p}.mlp.{rest[1]}.weight"])
        if rest == ["moe", "router", "weight"]:
            return _HfPlanEntry([f"{p}.block_sparse_moe.gate.weight"])
        if len(rest) == 2 and rest[0] == "moe" and rest[1] in _MOE_EXPERT:
            w = _MOE_EXPERT[rest[1]]
            return _HfPlanEntry([f"{p}.block_sparse_moe.experts.{e}.{w}.weight"
                                 for e in range(config.num_experts)], experts=True)
    raise KeyError(f"no HF mapping for the port's parameter {name!r}")


class _HfReader(safetensors_io.ShardedReader):
    """The port's name -> tensor over an HF checkpoint (``__call__``), with
    ``dtype`` and ``unconsumed``; see :func:`hf_native_reader`."""

    def __init__(self, checkpoint: str, config):
        super().__init__(_key_files(checkpoint))
        self.config = config
        self.consumed: set[str] = set()
        # the name each HF key is stored under: the hub's GPT-2 checkpoints
        # keep the base model's names unprefixed (reference :526-532)
        gpt2 = getattr(config, "arch", "llama") == "gpt2"
        self.stored = {(f"transformer.{k}" if gpt2 and _is_unprefixed_gpt2_key(k) else k): k
                       for k in self.files}

    def _retie(self, name: str) -> bool:
        # tied HF checkpoints omit lm_head: an untied model re-ties it
        return name.replace("//", ".") == "lm_head.weight" and "lm_head.weight" not in self.files

    def _read(self, key: str) -> torch.Tensor:
        self.consumed.add(key)
        return self.get(self.stored.get(key, key))

    def __call__(self, name: str) -> torch.Tensor:
        if self._retie(name):
            return self._read("model.embed_tokens.weight")
        plan = _plan_for(name, self.config)
        if plan.transpose:
            return self._read(plan.keys[0]).t().contiguous()
        if not plan.experts:
            return self._read(plan.keys[0])
        # filled expert by expert: the host holds the stack and one tensor
        first = self._read(plan.keys[0]).t()
        out = torch.empty((len(plan.keys), *first.shape), dtype=first.dtype)
        out[0] = first
        del first
        for e, key in enumerate(plan.keys[1:], start=1):
            out[e] = self._read(key).t()
        return out

    def dtype(self, name: str) -> torch.dtype:
        if self._retie(name):
            return super().dtype("model.embed_tokens.weight")
        key = _plan_for(name, self.config).keys[0]
        return super().dtype(self.stored.get(key, key))

    def unconsumed(self) -> list[str]:
        inert = {"lm_head.weight"} if self.config.tie_embeddings else set()
        return sorted(k for k in self.stored
                      if k not in self.consumed and k not in inert
                      and not k.endswith((".rotary_emb.inv_freq", ".attn.bias",
                                          ".attn.masked_bias")))


def hf_native_reader(checkpoint: str, config) -> _HfReader:
    """The reader ``big_modeling.load_checkpoint_and_dispatch`` takes for an
    HF checkpoint (reference :490): the port's name -> CPU tensor, each shard
    opened once, the host holding one assembled tensor and one HF tensor.
    ``unconsumed()`` lists the checkpoint's tensors never read (but a tied
    ``lm_head.weight`` and the buffers HF persisted: rotary ``inv_freq``,
    GPT-2's causal masks): after a full load a
    name there is a parameter the mapping dropped. Close it, or use it in a
    ``with`` statement."""
    return _HfReader(checkpoint, config)


# ---------------------------------------------------------------------- #
# export: the port's parameters -> an HF checkpoint
# ---------------------------------------------------------------------- #
def _named(params: Any) -> dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.state_dict())
    return dict(params)


def native_to_hf(params: Any, config) -> Iterator[tuple[str, torch.Tensor]]:
    """``(HF name, tensor)`` for every parameter of ``params`` (a module or
    its flat state dict), the expert stacks unstacked. A tied model has no
    ``lm_head``, so none is emitted, the HF convention."""
    for name, t in sorted(_named(params).items()):
        plan = _plan_for(name, config)
        t = t.detach()
        if plan.transpose:
            yield plan.keys[0], t.t().contiguous()
        elif not plan.experts:
            yield plan.keys[0], t
        else:
            for key, expert in zip(plan.keys, t):
                yield key, expert.t().contiguous()


def _hf_emission_sizes(params: Any, config) -> list[int]:
    """The bytes of each tensor :func:`native_to_hf` yields, in its order,
    from shapes alone."""
    sizes: list[int] = []
    for name, t in sorted(_named(params).items()):
        n_keys = len(_plan_for(name, config).keys)
        sizes += [t.numel() * t.element_size() // n_keys] * n_keys
    return sizes


def _export_arch(config) -> tuple[str, str]:
    """The HF (architecture, model_type) an export is written as; raises for
    a combination of switches that no HF model_type represents (reference
    :655), before anything is written."""
    gemma_flags = (getattr(config, "norm_offset", False),
                   getattr(config, "mlp_activation", "silu") == "gelu_tanh",
                   getattr(config, "embed_scale", False))
    is_gemma = all(gemma_flags)
    if any(gemma_flags) and not is_gemma:
        raise ValueError("partial Gemma switch set (norm_offset/mlp_activation='gelu_tanh'/"
                         "embed_scale must all be on or all off) matches no HF model_type; "
                         "save a native checkpoint instead")
    qkv = getattr(config, "qkv_bias", False)
    moe = bool(config.num_experts)
    post = getattr(config, "post_norms", False)
    sw = getattr(config, "sliding_window", None) is not None
    lw = getattr(config, "layer_windows", None) is not None
    if sum((is_gemma, qkv, moe)) > 1:
        raise ValueError("no HF model_type represents this switch combination "
                         f"(gemma-math={is_gemma}, qkv_bias={qkv}, moe={moe}); save a native "
                         "checkpoint instead")
    if post and not is_gemma:
        raise ValueError("post_norms without the Gemma math trio matches no HF model_type; save "
                         "a native checkpoint instead")
    if (sw or lw) and is_gemma and not post:
        raise ValueError("no HF model_type represents Gemma-v1 math with a sliding window; save "
                         "a native checkpoint instead")
    if lw and not (post or qkv):
        raise ValueError("no HF model_type represents per-layer windows outside the Gemma-2/"
                         "Qwen2 families; save a native checkpoint instead")
    if lw:
        widths = {w for w in config.layer_windows if w is not None}
        if len(widths) > 1:
            raise ValueError("HF configs carry ONE sliding_window; per-layer windows with mixed "
                             f"widths {sorted(widths)} cannot round-trip: save a native "
                             "checkpoint instead")
    if is_gemma and not config.tie_embeddings:
        raise ValueError("Gemma checkpoints are always tied; an untied lm_head would be "
                         "silently dropped by transformers: tie_embeddings=True or save a "
                         "native checkpoint")
    if moe:
        return "MixtralForCausalLM", "mixtral"
    if is_gemma and post:
        return "Gemma2ForCausalLM", "gemma2"
    if is_gemma:
        return "GemmaForCausalLM", "gemma"
    if qkv:
        return "Qwen2ForCausalLM", "qwen2"
    if sw:
        return "MistralForCausalLM", "mistral"  # the Llama layout with a band
    return "LlamaForCausalLM", "llama"


def _hf_config(config) -> dict:
    """The ``config.json`` that :func:`infer_config_from_hf` reads back."""
    if getattr(config, "arch", "llama") == "gpt2":  # reference :826-835
        return {"architectures": ["GPT2LMHeadModel"], "model_type": "gpt2",
                "vocab_size": config.vocab_size, "n_embd": config.hidden_size,
                "n_inner": config.intermediate_size, "n_layer": config.num_layers,
                "n_head": config.num_heads, "n_positions": config.max_seq_len,
                "n_ctx": config.max_seq_len, "layer_norm_epsilon": config.rms_norm_eps,
                "activation_function": "gelu_new", "tie_word_embeddings": True}
    arch_name, mt = _export_arch(config)
    hf_cfg = {
        "architectures": [arch_name], "model_type": mt, "vocab_size": config.vocab_size,
        "hidden_size": config.hidden_size, "intermediate_size": config.intermediate_size,
        "num_hidden_layers": config.num_layers, "num_attention_heads": config.num_heads,
        "num_key_value_heads": config.num_kv_heads,
        "max_position_embeddings": config.max_seq_len, "rope_theta": config.rope_theta,
        "rms_norm_eps": config.rms_norm_eps, "tie_word_embeddings": config.tie_embeddings,
    }
    if config.rope_scaling:
        hf_cfg["rope_scaling"] = config.rope_scaling
    if mt in ("gemma", "gemma2"):
        hf_cfg["head_dim"] = config.head_dim
        hf_cfg["hidden_activation"] = "gelu_pytorch_tanh"
    sw = getattr(config, "sliding_window", None)
    lw = getattr(config, "layer_windows", None)
    lw_width = next((w for w in (lw or ()) if w is not None), None)
    layer_types = (["sliding_attention" if w is not None else "full_attention" for w in lw]
                   if lw is not None else None)
    if mt in ("mistral", "mixtral"):
        hf_cfg["sliding_window"] = sw  # None: full attention, HF's default
        if mt == "mistral":
            hf_cfg["head_dim"] = config.head_dim
    elif mt == "qwen2" and (sw is not None or lw is not None):
        hf_cfg["use_sliding_window"] = True
        hf_cfg["sliding_window"] = sw if sw is not None else lw_width
        if layer_types is not None:
            hf_cfg["layer_types"] = layer_types
        else:
            hf_cfg["max_window_layers"] = 0  # every layer slides
    elif mt == "gemma2":
        hf_cfg["query_pre_attn_scalar"] = config.query_pre_attn_scalar
        hf_cfg["attn_logit_softcapping"] = config.attn_softcap
        hf_cfg["final_logit_softcapping"] = config.final_softcap
        hf_cfg["sliding_window"] = lw_width if lw is not None else sw
        hf_cfg["layer_types"] = layer_types if lw is not None else [
            "sliding_attention" if sw is not None else "full_attention"] * config.num_layers
    if config.num_experts:
        hf_cfg["num_local_experts"] = config.num_experts
        hf_cfg["num_experts_per_tok"] = config.num_experts_per_tok
    return hf_cfg


def save_hf_checkpoint(params: Any, config, save_directory: str,
                       max_shard_size: "str | int" = "5GB") -> None:
    """Write an HF-layout safetensors checkpoint (with an index when
    sharded) and its ``config.json``, which transformers loads and
    :func:`infer_config_from_hf` reads back (reference :735). ``params``: a
    module or its state dict, on any device. The shards are planned from
    shapes alone and each written as it fills, each tensor copied to the
    host as it is written: the host holds one tensor."""
    from ..checkpointing import parse_size

    hf_cfg = _hf_config(config)  # every refusal before a byte is written
    limit = parse_size(max_shard_size)
    sizes = _hf_emission_sizes(params, config)
    shard_of: list[int] = []
    shard_idx, acc = 0, 0
    for nbytes in sizes:
        if shard_of and acc + nbytes > limit:
            shard_idx, acc = shard_idx + 1, 0
        shard_of.append(shard_idx)
        acc += nbytes
    n_shards = (shard_of[-1] + 1) if shard_of else 1
    stem, ext = os.path.splitext(_HF_WEIGHTS_NAME)

    def shard_name(i: int) -> str:
        return _HF_WEIGHTS_NAME if n_shards == 1 else f"{stem}-{i + 1:05d}-of-{n_shards:05d}{ext}"

    os.makedirs(save_directory, exist_ok=True)
    weight_map: dict[str, str] = {}
    total, shard, current = 0, {}, 0

    def write(i: int, tensors: dict) -> None:
        safetensors_io.save_file(tensors, os.path.join(save_directory, shard_name(i)),
                                 metadata={"format": "pt"})

    for i, (key, t) in enumerate(native_to_hf(params, config)):
        if shard_of[i] != current:
            write(current, shard)
            shard, current = {}, shard_of[i]
        shard[key] = t
        weight_map[key] = shard_name(shard_of[i])
        total += t.numel() * t.element_size()
    write(current, shard)
    if n_shards > 1:
        with open(os.path.join(save_directory, _HF_INDEX_NAME), "w") as f:
            json.dump({"metadata": {"total_size": total}, "weight_map": weight_map}, f,
                      indent=2, sort_keys=True)
    with open(os.path.join(save_directory, "config.json"), "w") as f:
        json.dump(hf_cfg, f, indent=2, sort_keys=True)


# ---------------------------------------------------------------------- #
# PEFT adapters: the port's LoRA trees <-> PEFT's names and layouts
# ---------------------------------------------------------------------- #
# PEFT names an adapter tensor base_model.model.<module path>.lora_A.weight;
# for a Llama CausalLM the path is model.layers.<i>.self_attn.<target> or
# model.layers.<i>.mlp.<target>. lora_A is (r, in) and lora_B (out, r): each
# the transpose of one layer of the port's (L, in, r) and (L, r, out) stacks
_PEFT_ATTN = ("q_proj", "k_proj", "v_proj", "o_proj")
_PEFT_PREFIX = "base_model.model.model.layers"


def _peft_module_path(layer: int, target: str) -> str:
    group = "self_attn" if target in _PEFT_ATTN else "mlp"
    return f"{_PEFT_PREFIX}.{layer}.{group}.{target}"


def adapter_to_peft(adapter_params: Any, lora_config, model_config) -> dict[str, torch.Tensor]:
    """The port's adapter tree -> PEFT's flat names and torch layouts, what
    ``peft``'s ``set_peft_model_state_dict`` takes for a Llama-family base
    (reference :924)."""
    from ..adapters.runtime import A_KEY, B_KEY

    L = model_config.num_layers
    out: dict[str, torch.Tensor] = {}
    for target in lora_config.target_modules:
        a = torch.as_tensor(adapter_params[target][A_KEY])  # (L, in, r)
        b = torch.as_tensor(adapter_params[target][B_KEY])  # (L, r, out)
        if a.shape[0] != L or b.shape[0] != L:
            raise ValueError(f"adapter leaf for {target!r} has layer dim {a.shape[0]}/"
                             f"{b.shape[0]}, model has {L} layers")
        for i in range(L):
            mod = _peft_module_path(i, target)
            out[f"{mod}.lora_A.weight"] = a[i].t().contiguous()
            out[f"{mod}.lora_B.weight"] = b[i].t().contiguous()
    return out


def peft_to_adapter(state_dict: dict, lora_config, model_config) -> dict:
    """PEFT's flat names -> the port's adapter tree, the inverse of
    :func:`adapter_to_peft` (reference :954)."""
    from ..adapters.runtime import A_KEY, B_KEY

    L = model_config.num_layers
    adapter: dict = {}
    for target in lora_config.target_modules:
        mods = [_peft_module_path(i, target) for i in range(L)]
        adapter[target] = {
            A_KEY: torch.stack([torch.as_tensor(state_dict[f"{m}.lora_A.weight"]).t()
                                for m in mods]),
            B_KEY: torch.stack([torch.as_tensor(state_dict[f"{m}.lora_B.weight"]).t()
                                for m in mods]),
        }
    return adapter
