"""Feature example: experiment tracking, the PyTorch port of
``examples/by_feature/tracking.py``.

``nlp_example.py``'s classifier and loop, with the Accelerator made with
``log_with="jsonl"`` and ``project_dir``: ``init_trackers`` stores the run's
config, ``accelerator.log`` writes each epoch's accuracy and mean train
loss to ``<project_dir>/tracking/metrics.jsonl``, and ``end_training``
closes the trackers.

    python accelerate_tpu_torch/examples/tracking.py --with_tracking --project_dir logs

``--cpu`` trains on the CPU. ``TESTING_TINY_MODEL=1`` swaps in the tiny
config and 2048 training rows; ``TESTING_NUM_EPOCHS`` then sets the epochs.
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

########################################################################
# This is a fully working simple example to use accelerate_tpu_torch,
# specifically showcasing the experiment tracking capability on the same
# task as nlp_example.py.
########################################################################


def training_function(config, args):
    # Initialize accelerator
    if args.with_tracking:
        accelerator = Accelerator(
            cpu=args.cpu,
            mixed_precision=args.mixed_precision,
            log_with="jsonl",
            project_dir=args.project_dir,
        )
    else:
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

    # We need to initialize the trackers we use, and also store our configuration
    if args.with_tracking:
        run = os.path.split(__file__)[-1].split(".")[0]
        accelerator.init_trackers(run, config)

    # We need to keep track of how many total steps we have iterated over
    overall_step = 0

    # Now we train the model
    for epoch in range(num_epochs):
        if args.with_tracking:
            total_loss = 0.0
        for step, batch in enumerate(train_dataloader):
            carry, metrics = train_step(carry, batch)
            overall_step += 1
            if args.with_tracking:
                total_loss += float(metrics["loss"])
            if step % 50 == 0:
                accelerator.print(f"epoch {epoch} step {step}: loss {float(metrics['loss']):.4f}")
        train_loss = float(metrics["loss"])

        eval_metric = evaluate(accelerator, model, eval_dataloader)
        # Use accelerator.print to print only on the main process.
        accelerator.print(f"epoch {epoch}: train_loss {train_loss:.4f}", eval_metric)
        if args.with_tracking:
            accelerator.log(
                {
                    "accuracy": eval_metric["accuracy"],
                    "train_loss": total_loss / steps_per_epoch,
                    "epoch": epoch,
                },
                step=overall_step,
            )
    if args.with_tracking:
        accelerator.end_training()
    return eval_metric


def main():
    parser = argparse.ArgumentParser(description="Simple example of training script.")
    parser.add_argument(
        "--mixed_precision", type=str, default=None, choices=["no", "fp16", "bf16", "fp8"],
        help="Whether to use mixed precision. Choose between fp16 and bf16 (bfloat16).",
    )
    parser.add_argument("--cpu", action="store_true", help="If passed, will train on the CPU.")
    parser.add_argument(
        "--with_tracking", action="store_true",
        help="Whether to load in all available experiment trackers from the environment and "
        "use them for logging.",
    )
    parser.add_argument(
        "--project_dir", type=str, default="logs",
        help="Location on where to store experiment tracking logs and relevent project "
        "information",
    )
    args = parser.parse_args()
    config = {"lr": 2e-4, "num_epochs": 3, "seed": 42, "batch_size": 16}
    training_function(config, args)


if __name__ == "__main__":
    main()
