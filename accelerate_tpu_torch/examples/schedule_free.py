"""Feature example: schedule-free optimization, the PyTorch port of
``examples/by_feature/schedule_free.py``.

Trains ``nlp_example.py``'s classifier with ``schedule_free_adamw`` (the
port of ``optax.contrib.schedule_free_adamw``, Defazio et al.'s method: no
decay schedule to tune; the optimizer interpolates between its iterates).
The one change it asks of the loop: evaluation runs at the schedule-free
eval params (``schedule_free_eval_params``), not at the training params.

    python accelerate_tpu_torch/examples/schedule_free.py --mixed_precision bf16

``--cpu`` trains on the CPU. ``TESTING_TINY_MODEL=1`` swaps in the tiny
config and 2048 training rows; ``TESTING_NUM_EPOCHS`` then sets the epochs.
"""

import argparse
import os
import sys

import torch

# run by path without an install: put the repository root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from accelerate_tpu_torch import (  # noqa: E402
    Accelerator,
    SequenceClassifier,
    schedule_free_adamw,
    schedule_free_eval_params,
)
from accelerate_tpu_torch.examples.nlp_example import (  # noqa: E402
    get_dataloaders,
    model_and_config,
)
from accelerate_tpu_torch.utils.random import set_seed  # noqa: E402


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

    # New code: schedule-free AdamW, a flat learning rate with no decay
    # schedule; its warmup is the method's own
    optimizer = schedule_free_adamw(
        learning_rate=lr, warmup_steps=len(train_dataloader) // 4, weight_decay=0.01,
    )

    # Prepare everything, in the order given
    model, optimizer, train_dataloader, eval_dataloader = accelerator.prepare(
        model, optimizer, train_dataloader, eval_dataloader
    )

    # The train step: forward, backward, clip, update
    carry = accelerator.init_carry(model, optimizer)
    train_step = accelerator.unified_step(SequenceClassifier.loss_fn(model), max_grad_norm=1.0)

    @torch.no_grad()
    def eval_step(params, opt_state, batch):
        # New code: schedule-free evaluates at the averaged (eval) params,
        # not the training iterate: the counterpart of optimizer.eval()
        eval_params = schedule_free_eval_params(opt_state, params)
        logits = torch.func.functional_call(
            model, eval_params, (batch["input_ids"], batch["attention_mask"]))
        return logits.argmax(dim=-1)

    # Now we train the model
    for epoch in range(num_epochs):
        for step, batch in enumerate(train_dataloader):
            carry, metrics = train_step(carry, batch)
            if step % 50 == 0:
                accelerator.print(f"epoch {epoch} step {step}: loss {float(metrics['loss']):.4f}")
        train_loss = float(metrics["loss"])

        correct = total = 0
        for step, batch in enumerate(eval_dataloader):
            predictions = eval_step(carry["params"], carry["opt_state"], batch)
            predictions, references = accelerator.gather_for_metrics(
                (predictions, batch["labels"])
            )
            correct += int((predictions == references).sum())
            total += int(references.shape[0])
        eval_metric = {"accuracy": correct / max(total, 1)}
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
