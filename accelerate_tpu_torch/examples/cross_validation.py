"""Feature example: k-fold cross-validation, the PyTorch port of
``examples/by_feature/cross_validation.py``.

The training rows are cut into ``--num_folds`` contiguous validation
slices; fold i trains a fresh model on everything outside slice i and
validates on it, then predicts a shared held-out test set. The folds' test
logits are averaged into an ensemble, whose accuracy is the
cross-validated estimate.

    python accelerate_tpu_torch/examples/cross_validation.py --num_folds 3

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
    AcceleratorState,
    GradientState,
    SequenceClassifier,
    adamw,
    warmup_cosine_decay_schedule,
)
from accelerate_tpu_torch.examples.nlp_example import (  # noqa: E402
    EVAL_BATCH_SIZE,
    collate_fn,
    evaluate,
    make_paraphrase_dataset,
    model_and_config,
    tokenize_pair,
)
from accelerate_tpu_torch.utils.random import set_seed  # noqa: E402


def get_fold_dataloaders(accelerator: Accelerator, fold: int, num_folds: int,
                         batch_size: int = 16, model_config=None):
    """New code: loaders for fold ``fold`` of ``num_folds``: train on every
    row outside the fold's contiguous validation slice, validate on the
    slice, and a shared held-out test set (another seed) for the ensemble."""
    vocab_size = model_config.vocab_size if model_config is not None else 30522
    n_train = 2048 if os.environ.get("TESTING_TINY_MODEL") else 16384
    examples = make_paraphrase_dataset(n_train, seed=1234, vocab_size=vocab_size)
    test_examples = make_paraphrase_dataset(n_train // 4, seed=5678, vocab_size=vocab_size)
    dataset = [tokenize_pair(*ex) for ex in examples]
    fold_size = len(dataset) // num_folds
    lo, hi = fold * fold_size, (fold + 1) * fold_size
    train_dataset = dataset[:lo] + dataset[hi:]
    valid_dataset = dataset[lo:hi]
    test_dataset = [tokenize_pair(*ex) for ex in test_examples]
    train_dataloader = DataLoader(train_dataset, shuffle=True, collate_fn=collate_fn,
                                  batch_size=batch_size, drop_last=True)
    valid_dataloader = DataLoader(valid_dataset, shuffle=False, collate_fn=collate_fn,
                                  batch_size=EVAL_BATCH_SIZE, drop_last=False)
    test_dataloader = DataLoader(test_dataset, shuffle=False, collate_fn=collate_fn,
                                 batch_size=EVAL_BATCH_SIZE, drop_last=False)
    return train_dataloader, valid_dataloader, test_dataloader


def train_one_fold(config, args, fold: int):
    # New code: a fresh accelerator for each fold (the shared state reset first)
    AcceleratorState._reset_state(reset_partial_state=True)
    GradientState._reset_state()
    accelerator = Accelerator(cpu=args.cpu, mixed_precision=args.mixed_precision)
    lr = config["lr"]
    num_epochs = int(config["num_epochs"])
    seed = int(config["seed"])
    batch_size = int(config["batch_size"])

    set_seed(seed)
    model, model_config = model_and_config(accelerator, seed)
    if os.environ.get("TESTING_TINY_MODEL"):
        num_epochs = int(os.environ.get("TESTING_NUM_EPOCHS", num_epochs))
    train_dataloader, eval_dataloader, test_dataloader = get_fold_dataloaders(
        accelerator, fold, int(args.num_folds), batch_size, model_config)

    steps_per_epoch = len(train_dataloader)
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=steps_per_epoch // 4,
        decay_steps=steps_per_epoch * num_epochs,
    )
    model, optimizer, train_dataloader, eval_dataloader, test_dataloader = accelerator.prepare(
        model, adamw(schedule, weight_decay=0.01), train_dataloader, eval_dataloader,
        test_dataloader)
    carry = accelerator.init_carry(model, optimizer)
    train_step = accelerator.unified_step(SequenceClassifier.loss_fn(model), max_grad_norm=1.0)

    for epoch in range(num_epochs):
        for step, batch in enumerate(train_dataloader):
            carry, metrics = train_step(carry, batch)
            if step % 50 == 0:
                accelerator.print(f"epoch {epoch} step {step}: loss {float(metrics['loss']):.4f}")
        train_loss = float(metrics["loss"])
        eval_metric = evaluate(accelerator, model, eval_dataloader)
        accelerator.print(f"fold {fold} epoch {epoch}: train_loss {train_loss:.4f}", eval_metric)

    # New code: this fold's fp32 logits on the shared test set, and the labels
    fold_logits, fold_labels = [], []
    with torch.no_grad():
        for batch in test_dataloader:
            logits = model(batch["input_ids"], batch["attention_mask"]).float()
            logits, references = accelerator.gather_for_metrics((logits, batch["labels"]))
            fold_logits.append(logits.cpu().numpy())
            fold_labels.append(references.cpu().numpy())
    return eval_metric, np.concatenate(fold_logits), np.concatenate(fold_labels)


def training_function(config, args):
    # New code: every fold, then an ensemble by the mean of the test logits
    fold_metrics, all_logits, labels = [], [], None
    for fold in range(int(args.num_folds)):
        metric, logits, labels = train_one_fold(config, args, fold)
        fold_metrics.append(metric["accuracy"])
        all_logits.append(logits)
    ensemble = np.mean(np.stack(all_logits), axis=0).argmax(-1)
    result = {"accuracy": float(np.mean(ensemble == labels)), "folds": fold_metrics}
    print(f"fold accuracies {['%.4f' % a for a in fold_metrics]} -> ensemble", result)
    return result


def main():
    parser = argparse.ArgumentParser(description="Simple example of training script.")
    parser.add_argument(
        "--mixed_precision", type=str, default=None, choices=["no", "fp16", "bf16", "fp8"],
        help="Whether to use mixed precision. Choose between fp16 and bf16 (bfloat16).",
    )
    parser.add_argument("--cpu", action="store_true", help="If passed, will train on the CPU.")
    parser.add_argument("--num_folds", type=int, default=3,
                        help="The number of cross-validation splits to train.")
    args = parser.parse_args()
    config = {"lr": 2e-4, "num_epochs": 3, "seed": 42, "batch_size": 16}
    training_function(config, args)


if __name__ == "__main__":
    main()
