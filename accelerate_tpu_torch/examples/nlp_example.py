"""Simple NLP fine-tune example, the PyTorch port of ``examples/nlp_example.py``.

A BERT-base-shaped :class:`SequenceClassifier` fine-tuned on an
MRPC-style paraphrase-detection task, on one GPU (or on the CPU with
``--cpu``), in fp32 or mixed precision. The data is synthesized locally
(no network), through a plain ``torch.utils.data.DataLoader``;
``accelerator.prepare`` turns it into a loader of device batches. The loop
is the reference's: ``prepare`` the model, optimizer and loaders, build the
train step with ``accelerator.unified_step``, iterate, evaluate with
``gather_for_metrics``.

    python accelerate_tpu_torch/examples/nlp_example.py --mixed_precision bf16

``TESTING_TINY_MODEL=1`` swaps in the tiny config and 2048 training rows;
``TESTING_NUM_EPOCHS`` then sets the epochs.
"""

import argparse
import os
import sys

import numpy as np
import torch
from torch.utils.data import DataLoader

# run by path without an install: put the repository root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from accelerate_tpu_torch import (  # noqa: E402
    Accelerator,
    SequenceClassifier,
    TransformerConfig,
    adamw,
    warmup_cosine_decay_schedule,
)
from accelerate_tpu_torch.parallel.runtime import apply_sharded  # noqa: E402
from accelerate_tpu_torch.utils.random import set_seed  # noqa: E402

MAX_SEQ_LENGTH = 128
EVAL_BATCH_SIZE = 32
PAD, CLS, SEP = 0, 1, 2


def make_paraphrase_dataset(num_examples: int, seed: int, vocab_size: int):
    """Deterministic MRPC-shaped sentence-pair data (the real GLUE/MRPC
    download needs network access). Label 1 = sentence2 is a shuffled light
    edit of sentence1; label 0 = unrelated sentence."""
    rng = np.random.default_rng(seed)
    examples = []
    for _ in range(num_examples):
        length = int(rng.integers(8, 24))
        sentence1 = rng.integers(4, vocab_size, length)
        if rng.random() < 0.5:
            sentence2 = sentence1.copy()
            rng.shuffle(sentence2)
            n_edit = max(1, length // 8)
            idx = rng.choice(length, n_edit, replace=False)
            sentence2[idx] = rng.integers(4, vocab_size, n_edit)
            label = 1
        else:
            sentence2 = rng.integers(4, vocab_size, int(rng.integers(8, 24)))
            label = 0
        examples.append((sentence1, sentence2, label))
    return examples


def tokenize_pair(sentence1, sentence2, label):
    """[CLS] s1 [SEP] s2 [SEP], padded to MAX_SEQ_LENGTH."""
    ids = [CLS, *sentence1.tolist(), SEP, *sentence2.tolist(), SEP]
    ids = ids[:MAX_SEQ_LENGTH]
    attention_mask = [1] * len(ids) + [0] * (MAX_SEQ_LENGTH - len(ids))
    ids = ids + [PAD] * (MAX_SEQ_LENGTH - len(ids))
    return {
        "input_ids": np.asarray(ids, np.int32),
        "attention_mask": np.asarray(attention_mask, np.int32),
        "labels": np.int32(label),
    }


def collate_fn(items):
    return {key: np.stack([item[key] for item in items]) for key in items[0]}


def get_dataloaders(accelerator: Accelerator, batch_size: int = 16,
                    model_config: TransformerConfig = None):
    """Plain ``torch.utils.data.DataLoader``s for the paraphrase task;
    ``accelerator.prepare`` turns them into device loaders."""
    vocab_size = model_config.vocab_size if model_config is not None else 30522
    n_train = 2048 if os.environ.get("TESTING_TINY_MODEL") else 16384
    train_examples = make_paraphrase_dataset(n_train, seed=1234, vocab_size=vocab_size)
    eval_examples = make_paraphrase_dataset(n_train // 4, seed=5678, vocab_size=vocab_size)
    train_dataset = [tokenize_pair(*ex) for ex in train_examples]
    eval_dataset = [tokenize_pair(*ex) for ex in eval_examples]

    train_dataloader = DataLoader(
        train_dataset, shuffle=True, collate_fn=collate_fn,
        batch_size=batch_size, drop_last=True,
    )
    eval_dataloader = DataLoader(
        eval_dataset, shuffle=False, collate_fn=collate_fn,
        batch_size=EVAL_BATCH_SIZE, drop_last=False,
    )
    return train_dataloader, eval_dataloader


def model_and_config(accelerator: Accelerator, seed: int):
    """The BERT-base-shaped classifier (tiny under ``TESTING_TINY_MODEL``),
    its weights made on the accelerator's device from ``seed``."""
    model_config = TransformerConfig.bert_base(dtype=compute_dtype(accelerator))
    if os.environ.get("TESTING_TINY_MODEL"):
        model_config = TransformerConfig.tiny(causal=False, dtype=compute_dtype(accelerator))
    generator = torch.Generator(accelerator.device).manual_seed(seed)
    model = SequenceClassifier(model_config, num_labels=2, device=accelerator.device,
                               generator=generator)
    return model, model_config


@torch.no_grad()
def evaluate(accelerator: Accelerator, model: SequenceClassifier, eval_dataloader) -> dict:
    """Accuracy over the eval loader; ``gather_for_metrics`` drops the rows a
    short last batch repeats."""
    correct = total = 0
    for batch in eval_dataloader:
        # a model prepared under a ParallelismPlugin runs on its shards
        logits = apply_sharded(model, batch["input_ids"], batch["attention_mask"])
        predictions = logits.argmax(dim=-1)
        predictions, references = accelerator.gather_for_metrics(
            (predictions, batch["labels"]))
        correct += int((predictions == references).sum())
        total += int(references.shape[0])
    return {"accuracy": correct / max(total, 1)}


def training_function(config, args):
    # Initialize accelerator
    accelerator = Accelerator(cpu=args.cpu, mixed_precision=args.mixed_precision)
    # Sample hyper-parameters for learning rate, batch size, seed and a few others
    lr = config["lr"]
    num_epochs = int(config["num_epochs"])
    seed = int(config["seed"])
    batch_size = int(config["batch_size"])

    set_seed(seed)
    # BERT-base shape unless testing tiny
    model, model_config = model_and_config(accelerator, seed)
    if os.environ.get("TESTING_TINY_MODEL"):
        num_epochs = int(os.environ.get("TESTING_NUM_EPOCHS", num_epochs))
    train_dataloader, eval_dataloader = get_dataloaders(accelerator, batch_size, model_config)

    # Instantiate the optimizer with a linear warmup-decay schedule
    steps_per_epoch = len(train_dataloader)
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=steps_per_epoch // 4,
        decay_steps=steps_per_epoch * num_epochs,
    )
    optimizer = adamw(schedule, weight_decay=0.01)

    # Prepare everything: the model moves to the device, the optimizer
    # state is made for it, loaders yield device batches. There is no
    # specific order to remember, we just need to unpack the objects in the
    # same order we gave them to the prepare method.
    model, optimizer, train_dataloader, eval_dataloader = accelerator.prepare(
        model, optimizer, train_dataloader, eval_dataloader
    )

    # The train step: forward, backward, clip, update
    carry = accelerator.init_carry(model, optimizer)
    train_step = accelerator.unified_step(SequenceClassifier.loss_fn(model), max_grad_norm=1.0)

    # Now we train the model
    for epoch in range(num_epochs):
        for step, batch in enumerate(train_dataloader):
            carry, metrics = train_step(carry, batch)
            if step % 50 == 0:
                accelerator.print(f"epoch {epoch} step {step}: loss {float(metrics['loss']):.4f}")
        train_loss = float(metrics["loss"])

        eval_metric = evaluate(accelerator, model, eval_dataloader)
        # Use accelerator.print to print only on the main process.
        accelerator.print(f"epoch {epoch}: train_loss {train_loss:.4f}", eval_metric)
    return eval_metric


def compute_dtype(accelerator: Accelerator) -> str:
    """The model's compute dtype from the accelerator's policy."""
    return str(accelerator.state.mixed_precision_policy.compute_dtype).replace("torch.", "")


def main():
    parser = argparse.ArgumentParser(description="Simple example of training script.")
    parser.add_argument(
        "--mixed_precision", type=str, default=None, choices=["no", "fp16", "bf16", "fp8"],
        help="Whether to use mixed precision. Choose between fp16 and bf16 (bfloat16).",
    )
    parser.add_argument("--cpu", action="store_true", help="If passed, will train on the CPU.")
    args = parser.parse_args()
    config = {"lr": 2e-4, "num_epochs": 3, "seed": 42, "batch_size": 16}
    training_function(config, args)


if __name__ == "__main__":
    main()
