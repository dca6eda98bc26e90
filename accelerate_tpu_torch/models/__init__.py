"""The model zoo: the Llama-family ``CausalLM`` (with the Gemma and Gemma-2
switches), the BERT-shaped ``SequenceClassifier``, the classic ``GPT2LM``
and the encoder-decoder ``Seq2SeqLM`` over ``TransformerConfig``.

Port of ``accelerate_tpu/models/__init__.py``; each name is read from its
module on first use (PEP 562), so importing ``models.config`` does not
import the transformer.
"""

from __future__ import annotations

import importlib

_WHERE = {"TransformerConfig": "config", "CausalLM": "transformer",
          "SequenceClassifier": "transformer", "count_params": "transformer",
          "GPT2LM": "gpt2", "Seq2SeqLM": "seq2seq"}

__all__ = ["TransformerConfig", "CausalLM", "GPT2LM", "SequenceClassifier", "Seq2SeqLM",
           "causal_model_for", "count_params"]


def causal_model_for(config, device=None, generator=None):
    """The decoder LM matching ``config.arch`` (``GPT2LM`` for ``"gpt2"``,
    else ``CausalLM``), built on ``device`` from ``generator``: the
    reference's AutoModel-style dispatch for arch-agnostic callers."""
    cls = __getattr__("GPT2LM") if config.arch == "gpt2" else __getattr__("CausalLM")
    return cls(config, device=device, generator=generator)


def __getattr__(name: str):
    module = _WHERE.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
