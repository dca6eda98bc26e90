"""The model zoo: the Llama-family ``CausalLM`` and the BERT-shaped
``SequenceClassifier`` over ``TransformerConfig``.

Port of ``accelerate_tpu/models/__init__.py``; each name is read from its
module on first use (PEP 562), so importing ``models.config`` does not
import the transformer. ``GPT2LM``, ``Seq2SeqLM``, ``causal_model_for``
and ``count_params`` are not ported yet (ROADMAP.md, queue A8).
"""

from __future__ import annotations

import importlib

_WHERE = {"TransformerConfig": "config", "CausalLM": "transformer",
          "SequenceClassifier": "transformer"}

__all__ = ["CausalLM", "SequenceClassifier", "TransformerConfig"]


def __getattr__(name: str):
    module = _WHERE.get(name)
    if module is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{module}"), name)
    globals()[name] = value
    return value


def __dir__():
    return sorted(set(globals()) | set(__all__))
