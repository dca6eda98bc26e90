"""Feature example: checkpointing and resume, the PyTorch port of
``examples/by_feature/checkpointing.py``.

Saves the whole training state (the step carry: params, optimizer state,
counters) every N steps or every epoch with ``accelerator.save_state``,
and resumes, the loader's position included, with
``accelerator.load_state`` and ``skip_first_batches``. The model, data and
loop are ``nlp_example.py``'s.

    python accelerate_tpu_torch/examples/checkpointing.py --mixed_precision bf16 \\
        --checkpointing_steps epoch --output_dir /tmp/ckpts
    python accelerate_tpu_torch/examples/checkpointing.py --mixed_precision bf16 \\
        --checkpointing_steps epoch --output_dir /tmp/ckpts \\
        --resume_from_checkpoint /tmp/ckpts/epoch_0
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
        decay_steps=steps_per_epoch * num_epochs // gradient_accumulation_steps,
    )
    optimizer = adamw(schedule, weight_decay=0.01)

    # Prepare everything, in the order given
    model, optimizer, train_dataloader, eval_dataloader = accelerator.prepare(
        model, optimizer, train_dataloader, eval_dataloader
    )

    # The train step: forward, backward, clip, update
    carry = accelerator.init_carry(model, optimizer)
    train_step = accelerator.unified_step(SequenceClassifier.loss_fn(model), max_grad_norm=1.0)

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
        # After the first resumed epoch, iterate from the top again
        if epoch == starting_epoch and resume_step > 0:
            active_dataloader = accelerator.skip_first_batches(train_dataloader, resume_step)
        else:
            active_dataloader = train_dataloader
        for step, batch in enumerate(active_dataloader):
            carry, metrics = train_step(carry, batch)
            overall_step += 1
            if step % 50 == 0:
                accelerator.print(f"epoch {epoch} step {step}: loss {float(metrics['loss']):.4f}")
            if isinstance(checkpointing_steps, int):
                if overall_step % checkpointing_steps == 0:
                    output_dir = f"step_{overall_step}"
                    if args.output_dir is not None:
                        output_dir = os.path.join(args.output_dir, output_dir)
                    accelerator.save_state(output_dir, carry=carry)
        train_loss = float(metrics["loss"])

        eval_metric = evaluate(accelerator, model, eval_dataloader)
        # Use accelerator.print to print only on the main process.
        accelerator.print(f"epoch {epoch}: train_loss {train_loss:.4f}", eval_metric)
        if checkpointing_steps == "epoch":
            output_dir = f"epoch_{epoch}"
            if args.output_dir is not None:
                output_dir = os.path.join(args.output_dir, output_dir)
            accelerator.save_state(output_dir, carry=carry)
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
    args = parser.parse_args()
    config = {"lr": 2e-4, "num_epochs": 3, "seed": 42, "batch_size": 16}
    training_function(config, args)


if __name__ == "__main__":
    main()
