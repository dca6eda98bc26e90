"""Sequence-to-sequence training example, the PyTorch port of
``examples/seq2seq_example.py``.

A T5-family encoder-decoder (:class:`Seq2SeqLM`) trained on a synthetic
copy task made from a seed (no network), with the same flow as
``nlp_example.py``. Generation starts from BOS alone, so reproducing a
source runs the whole encode-once, KV-cached decode path; at these sizes
the model fits the training distribution rather than learning to copy in
general, so the eval reports generation accuracy on training rows.

    python accelerate_tpu_torch/examples/seq2seq_example.py

``--cpu`` trains on the CPU. ``TESTING_TINY_MODEL=1`` takes the tiny widths
and 256 rows.
"""

import argparse
import os
import sys

import numpy as np
import torch

# run by path without an install: put the repository root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from accelerate_tpu_torch import Accelerator, adamw  # noqa: E402
from accelerate_tpu_torch.models import Seq2SeqLM, TransformerConfig  # noqa: E402
from accelerate_tpu_torch.utils.random import set_seed  # noqa: E402

BOS, PAD = 0, 1


def make_dataset(n: int, seq_len: int, vocab: int, seed: int):
    """source = random tokens; target = source (copy task)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(2, vocab, (n, seq_len)).astype(np.int32)
    return src, src.copy()


def compute_dtype(accelerator: Accelerator) -> str:
    """The model's compute dtype from the accelerator's policy."""
    return str(accelerator.state.mixed_precision_policy.compute_dtype).replace("torch.", "")


def training_function(config, args):
    set_seed(config["seed"])
    accelerator = Accelerator(
        mixed_precision=args.mixed_precision,
        gradient_accumulation_steps=config.get("grad_accum", 1),
        cpu=args.cpu,
    )

    tiny = os.environ.get("TESTING_TINY_MODEL") == "1"
    model_cfg = TransformerConfig(
        vocab_size=128 if tiny else 512,
        hidden_size=64 if tiny else 256,
        intermediate_size=128 if tiny else 512,
        num_layers=2, num_decoder_layers=2,
        num_heads=4, max_seq_len=64, tie_embeddings=True,
        dtype=compute_dtype(accelerator),
    )
    model = Seq2SeqLM(model_cfg, device=accelerator.device,
                      generator=torch.Generator(accelerator.device).manual_seed(config["seed"]))
    seq_len = 12
    src, tgt = make_dataset(256 if tiny else 2048, seq_len, model_cfg.vocab_size, config["seed"])

    dec_in = np.concatenate([np.full((len(tgt), 1), BOS, np.int32), tgt[:, :-1]], axis=1)
    model = accelerator.prepare(model)
    opt = accelerator.prepare(adamw(config["lr"]))
    carry = accelerator.init_carry(model, opt)
    step = accelerator.unified_step(Seq2SeqLM.loss_fn(model))

    bs = config["batch_size"]
    n_batches = len(src) // bs
    for epoch in range(config["num_epochs"]):
        for i in range(n_batches):
            sl = slice(i * bs, (i + 1) * bs)
            batch = {
                "input_ids": torch.as_tensor(src[sl]),
                "decoder_input_ids": torch.as_tensor(dec_in[sl]),
                "labels": torch.as_tensor(tgt[sl]),
            }
            carry, metrics = step(carry, batch)
        accelerator.print(f"epoch {epoch}: loss {float(metrics['loss']):.4f}")

    # eval: KV-cached greedy generation (starts from BOS, so every emitted
    # token comes through cross-attention) reproduces trained sources
    ev_src, ev_tgt = src[:32], tgt[:32]
    with torch.no_grad():
        out = model.generate(torch.as_tensor(ev_src), max_new_tokens=seq_len, bos_token_id=BOS)
    acc = float(np.mean(out[:, 1:].cpu().numpy() == ev_tgt))
    accelerator.print(f"generation exact-token accuracy: {acc:.3f}")
    return {"accuracy": acc, "loss": float(metrics["loss"])}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--mixed_precision", default="bf16",
                        choices=["no", "bf16", "fp16", "fp8"])
    parser.add_argument("--cpu", action="store_true", help="Train on the CPU")
    args = parser.parse_args()
    # the reference's defaults for the full-size model: 30 epochs at 1e-3
    config = {"lr": 1e-3, "num_epochs": 30, "seed": 42, "batch_size": 32}
    training_function(config, args)


if __name__ == "__main__":
    main()
