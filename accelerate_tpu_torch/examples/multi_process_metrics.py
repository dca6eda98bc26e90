"""Feature example: metrics over every process's eval rows, the PyTorch port
of ``examples/by_feature/multi_process_metrics.py``.

``accelerator.gather_for_metrics`` concatenates every process's eval
predictions and drops the rows the last batch repeated to keep the shapes
even, so the host's metric math (accuracy and F1 here) sees each example
once. The model, data and loop are ``nlp_example.py``'s.

    python accelerate_tpu_torch/examples/multi_process_metrics.py --mixed_precision bf16

``--cpu`` trains on the CPU. ``TESTING_TINY_MODEL=1`` swaps in the tiny
config and 2048 training rows; ``TESTING_NUM_EPOCHS`` then sets the epochs.
"""

import argparse
import os
import sys

import numpy as np
import torch

# run by path without an install: put the repository root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from accelerate_tpu_torch import (  # noqa: E402
    Accelerator,
    SequenceClassifier,
    adamw,
    warmup_cosine_decay_schedule,
)
from accelerate_tpu_torch.examples.nlp_example import (  # noqa: E402
    get_dataloaders,
    model_and_config,
)
from accelerate_tpu_torch.utils.random import set_seed  # noqa: E402

########################################################################
# This is a fully working simple example to use accelerate_tpu_torch,
# specifically showcasing metrics over every process's eval rows on the
# same task as nlp_example.py.
########################################################################


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

    # Prepare everything, in the order given
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

        correct = total = 0
        all_predictions = []
        all_references = []
        with torch.no_grad():
            for step, batch in enumerate(eval_dataloader):
                predictions = model(batch["input_ids"], batch["attention_mask"]).argmax(dim=-1)
                predictions, references = accelerator.gather_for_metrics(
                    (predictions, batch["labels"])
                )
                correct += int((predictions == references).sum())
                total += int(references.shape[0])
                all_predictions.append(predictions.cpu().numpy())
                all_references.append(references.cpu().numpy())
        predictions = np.concatenate(all_predictions)
        references = np.concatenate(all_references)
        true_pos = int(np.sum((predictions == 1) & (references == 1)))
        false_pos = int(np.sum((predictions == 1) & (references == 0)))
        false_neg = int(np.sum((predictions == 0) & (references == 1)))
        f1 = 2 * true_pos / max(2 * true_pos + false_pos + false_neg, 1)
        eval_metric = {"accuracy": correct / max(total, 1), "f1": f1}
        # Use accelerator.print to print only on the main process.
        accelerator.print(f"epoch {epoch}: train_loss {train_loss:.4f}", eval_metric)
    return eval_metric


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
