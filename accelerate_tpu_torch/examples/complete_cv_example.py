"""Complete CV example: ``cv_example.py`` with checkpointing, experiment
tracking and gradient accumulation, the PyTorch port of
``examples/complete_cv_example.py``.

The feature code is line for line ``complete_nlp_example.py``'s, so the
drift test can hold the two complete scripts together. The model, data and
metric are ``cv_example.py``'s.

    python accelerate_tpu_torch/examples/complete_cv_example.py --mixed_precision bf16 \\
        --checkpointing_steps epoch --output_dir /tmp/ckpts --with_tracking

``--cpu`` trains on the CPU. ``TESTING_TINY_MODEL=1`` takes 1024 training
rows; ``TESTING_NUM_EPOCHS`` then sets the epochs.
"""

import argparse
import os
import sys

import torch

# run by path without an install: put the repository root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from accelerate_tpu_torch import Accelerator, adamw  # noqa: E402
from accelerate_tpu_torch.examples.cv_example import (  # noqa: E402
    ConvClassifier,
    compute_dtype,
    get_dataloaders,
    loss_fn,
)
from accelerate_tpu_torch.utils.random import set_seed  # noqa: E402

########################################################################
# This is a fully working simple example to use accelerate_tpu_torch,
# specifically showcasing the checkpointing, experiment tracking and
# gradient accumulation capabilities on the same task as cv_example.py.
########################################################################


def training_function(config, args):
    gradient_accumulation_steps = int(args.gradient_accumulation_steps)
    # Initialize accelerator
    if args.with_tracking:
        accelerator = Accelerator(
            cpu=args.cpu,
            mixed_precision=args.mixed_precision,
            gradient_accumulation_steps=gradient_accumulation_steps,
            log_with="jsonl",
            project_dir=args.project_dir,
        )
    else:
        accelerator = Accelerator(
            cpu=args.cpu,
            mixed_precision=args.mixed_precision,
            gradient_accumulation_steps=gradient_accumulation_steps,
        )
    # Parse out whether we are saving every epoch or after a certain number of batches
    if hasattr(args.checkpointing_steps, "isdigit"):
        if args.checkpointing_steps == "epoch":
            checkpointing_steps = args.checkpointing_steps
        elif args.checkpointing_steps.isdigit():
            checkpointing_steps = int(args.checkpointing_steps)
        else:
            raise ValueError(
                f"Argument `checkpointing_steps` must be either a number or `epoch`. "
                f"`{args.checkpointing_steps}` passed."
            )
    else:
        checkpointing_steps = None
    # Sample hyper-parameters for learning rate, batch size, seed and a few others
    lr = config["lr"]
    num_epochs = int(config["num_epochs"])
    seed = int(config["seed"])
    batch_size = int(config["batch_size"])
    if os.environ.get("TESTING_TINY_MODEL"):
        num_epochs = int(os.environ.get("TESTING_NUM_EPOCHS", num_epochs))

    set_seed(seed)
    train_dataloader, eval_dataloader = get_dataloaders(accelerator, batch_size)
    model = ConvClassifier(dtype=compute_dtype(accelerator), device=accelerator.device,
                           generator=torch.Generator(accelerator.device).manual_seed(seed))

    optimizer = adamw(lr, weight_decay=1e-4)

    # Prepare everything (same two lines as the NLP example)
    model, optimizer, train_dataloader, eval_dataloader = accelerator.prepare(
        model, optimizer, train_dataloader, eval_dataloader
    )

    carry = accelerator.init_carry(model, optimizer)
    train_step = accelerator.unified_step(loss_fn(model), max_grad_norm=1.0)
    steps_per_epoch = len(train_dataloader)

    # We need to initialize the trackers we use, and also store our configuration
    if args.with_tracking:
        run = os.path.split(__file__)[-1].split(".")[0]
        accelerator.init_trackers(run, config)

    # We need to keep track of how many total steps we have iterated over
    overall_step = 0
    # We also need to keep track of the starting epoch so files are named properly
    starting_epoch = 0
    # Potentially load in the weights and states from a previous save
    if args.resume_from_checkpoint:
        accelerator.print(f"Resumed from checkpoint: {args.resume_from_checkpoint}")
        carry = accelerator.load_state(args.resume_from_checkpoint, carry=carry)
        overall_step = carry["micro_step"] + carry["opt_step"] * gradient_accumulation_steps
        starting_epoch = overall_step // steps_per_epoch
        resume_step = overall_step % steps_per_epoch
    else:
        resume_step = 0

    # Now we train the model
    for epoch in range(starting_epoch, num_epochs):
        if args.with_tracking:
            total_loss = 0.0
        # After the first resumed epoch, iterate from the top again
        if epoch == starting_epoch and resume_step > 0:
            active_dataloader = accelerator.skip_first_batches(train_dataloader, resume_step)
        else:
            active_dataloader = train_dataloader
        for step, batch in enumerate(active_dataloader):
            carry, metrics = train_step(carry, batch)
            overall_step += 1
            if args.with_tracking:
                total_loss += float(metrics["loss"])
            if step % 50 == 0:
                accelerator.print(f"epoch {epoch} step {step}: loss {float(metrics['loss']):.4f}")
            if isinstance(checkpointing_steps, int):
                if overall_step % checkpointing_steps == 0:
                    output_dir = f"step_{overall_step}"
                    if args.output_dir is not None:
                        output_dir = os.path.join(args.output_dir, output_dir)
                    accelerator.save_state(output_dir, carry=carry)
        train_loss = float(metrics["loss"])

        correct = total = 0
        with torch.no_grad():
            for step, batch in enumerate(eval_dataloader):
                predictions = model(batch["pixel_values"]).argmax(dim=-1)
                predictions, references = accelerator.gather_for_metrics(
                    (predictions, batch["labels"])
                )
                correct += int((predictions == references).sum())
                total += int(references.shape[0])
        eval_metric = {"accuracy": correct / max(total, 1)}
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
        if checkpointing_steps == "epoch":
            output_dir = f"epoch_{epoch}"
            if args.output_dir is not None:
                output_dir = os.path.join(args.output_dir, output_dir)
            accelerator.save_state(output_dir, carry=carry)
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
        "--gradient_accumulation_steps", type=int, default=1,
        help="The number of minibatches to be ran before gradients are accumulated.",
    )
    parser.add_argument(
        "--checkpointing_steps", type=str, default=None,
        help="Whether the various states should be saved at the end of every n steps, or "
        "'epoch' for each epoch.",
    )
    parser.add_argument(
        "--output_dir", type=str, default=".",
        help="Optional save directory where all checkpoint folders will be stored. Default is "
        "the current working directory.",
    )
    parser.add_argument(
        "--resume_from_checkpoint", type=str, default=None,
        help="If the training should continue from a checkpoint folder.",
    )
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
    config = {"lr": 3e-3, "num_epochs": 3, "seed": 42, "batch_size": 32}
    training_function(config, args)


if __name__ == "__main__":
    main()
