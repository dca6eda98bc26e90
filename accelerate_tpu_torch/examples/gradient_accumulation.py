"""Feature example: gradient accumulation, the PyTorch port of
``examples/by_feature/gradient_accumulation.py``.

``nlp_example.py``'s BERT-shaped paraphrase classifier, trained with the
gradient of ``--gradient_accumulation_steps`` microbatches per optimizer
step. The loop is unchanged: accumulation happens inside
``Accelerator.unified_step`` (an fp32 buffer carried between calls, the
optimizer applied every K-th call), so the step is called once per
microbatch; the schedule counts optimizer steps.

    python accelerate_tpu_torch/examples/gradient_accumulation.py --gradient_accumulation_steps 2

``TESTING_TINY_MODEL=1`` swaps in the tiny config and 2048 training rows;
``TESTING_NUM_EPOCHS`` then sets the epochs.
"""

import argparse
import os
import sys

# run by path without an install: put the repository root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from accelerate_tpu_torch import (  # noqa: E402
    Accelerator,
    SequenceClassifier,
    adamw,
    warmup_cosine_decay_schedule,
)
from accelerate_tpu_torch.examples.nlp_example import (  # noqa: E402
    evaluate,
    get_dataloaders,
    model_and_config,
)
from accelerate_tpu_torch.utils.random import set_seed  # noqa: E402


def training_function(config, args):
    gradient_accumulation_steps = int(args.gradient_accumulation_steps)
    # Initialize accelerator
    accelerator = Accelerator(
        cpu=args.cpu,
        mixed_precision=args.mixed_precision,
        gradient_accumulation_steps=gradient_accumulation_steps,
    )
    lr = config["lr"]
    num_epochs = int(config["num_epochs"])
    seed = int(config["seed"])
    batch_size = int(config["batch_size"])

    set_seed(seed)
    model, model_config = model_and_config(accelerator, seed)
    if os.environ.get("TESTING_TINY_MODEL"):
        num_epochs = int(os.environ.get("TESTING_NUM_EPOCHS", num_epochs))
    train_dataloader, eval_dataloader = get_dataloaders(accelerator, batch_size, model_config)

    # the schedule counts optimizer steps: one every K microbatches
    steps_per_epoch = len(train_dataloader)
    schedule = warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=lr, warmup_steps=steps_per_epoch // 4,
        decay_steps=steps_per_epoch * num_epochs // gradient_accumulation_steps,
    )
    optimizer = adamw(schedule, weight_decay=0.01)
    model, optimizer, train_dataloader, eval_dataloader = accelerator.prepare(
        model, optimizer, train_dataloader, eval_dataloader
    )

    # New code: nothing else changes; the step accumulates K microbatches
    carry = accelerator.init_carry(model, optimizer)
    train_step = accelerator.unified_step(SequenceClassifier.loss_fn(model), max_grad_norm=1.0)

    for epoch in range(num_epochs):
        for step, batch in enumerate(train_dataloader):
            carry, metrics = train_step(carry, batch)
            if step % 50 == 0:
                accelerator.print(f"epoch {epoch} step {step}: loss {float(metrics['loss']):.4f}")
        train_loss = float(metrics["loss"])
        eval_metric = evaluate(accelerator, model, eval_dataloader)
        accelerator.print(f"epoch {epoch}: train_loss {train_loss:.4f}", eval_metric)
    return eval_metric


def main():
    parser = argparse.ArgumentParser(description="Simple example of training script.")
    parser.add_argument(
        "--mixed_precision", type=str, default=None, choices=["no", "fp16", "bf16", "fp8"],
        help="Whether to use mixed precision. Choose between fp16 and bf16 (bfloat16).",
    )
    parser.add_argument("--cpu", action="store_true", help="If passed, will train on the CPU.")
    parser.add_argument(
        "--gradient_accumulation_steps", type=int, default=1,
        help="The number of minibatches to be ran before gradients are accumulated.",
    )
    args = parser.parse_args()
    config = {"lr": 2e-4, "num_epochs": 3, "seed": 42, "batch_size": 16}
    training_function(config, args)


if __name__ == "__main__":
    main()
