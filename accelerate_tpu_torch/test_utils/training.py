"""Toy models and data of the tests.

Port of ``accelerate_tpu/test_utils/training.py`` (``RegressionDataset``,
``regression_init``, ``regression_loss``), plus the tiny ``CausalLM`` set-up
the multi-process tests share with chip_smoke.py: its widths, and global
batches whose loss masks hold different token counts in each process's
rows, made from a seed with numpy.
"""

from __future__ import annotations

import numpy as np
import torch


class RegressionDataset:
    """y = a*x + b + noise, indexable like a torch Dataset."""

    def __init__(self, a=2.0, b=3.0, length=64, seed=42):
        rng = np.random.default_rng(seed)
        self.length = length
        self.a, self.b = a, b
        self.x = rng.normal(size=(length,)).astype(np.float32)
        self.y = (a * self.x + b + 0.05 * rng.normal(size=(length,))).astype(np.float32)

    def __len__(self):
        return self.length

    def __getitem__(self, i):
        return {"x": self.x[i], "y": self.y[i]}


def regression_init(seed: int = 0) -> dict:
    del seed
    return {"a": torch.zeros(()), "b": torch.zeros(())}


def regression_loss(params, batch):
    pred = params["a"] * batch["x"] + params["b"]
    return ((pred - batch["y"]) ** 2).mean()


# a 2-layer fp32 CausalLM at tiny widths
TINY_LM = dict(vocab_size=256, hidden_size=64, intermediate_size=160, num_layers=2,
               num_heads=4, num_kv_heads=2, max_seq_len=64)
TINY_SEQ = 16


class MaskedTokens:
    """Rows of ``input_ids`` and ``loss_mask``. Cut into global batches of
    ``rows_per_process`` x world rows, process ``p`` holds rows ``[p * rows,
    (p + 1) * rows)`` of each: even processes' rows keep every token, odd
    processes' rows keep 2 to 4 tokens, so the processes' mask counts
    differ (the case where a mean of per-process means is not the global
    batch's loss)."""

    def __init__(self, n_rows: int, rows_per_process: int, seed: int = 0,
                 seq: int = TINY_SEQ, vocab: int = TINY_LM["vocab_size"]):
        rng = np.random.default_rng(seed)
        self.ids = rng.integers(0, vocab, size=(n_rows, seq)).astype(np.int64)
        self.mask = np.zeros((n_rows, seq), dtype=np.float32)
        for i in range(n_rows):
            keep = seq if (i // rows_per_process) % 2 == 0 else 2 + i % 3
            self.mask[i, :keep] = 1.0

    def __len__(self):
        return len(self.ids)

    def __getitem__(self, i):
        return {"input_ids": self.ids[i], "loss_mask": self.mask[i]}
