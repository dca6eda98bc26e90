"""Feature example: automatic gradient accumulation, the PyTorch port of
``examples/by_feature/automatic_gradient_accumulation.py``.

``find_executable_batch_size`` (``utils/memory.py``) runs the training body
at the largest per-step batch that fits the card, halving it on a CUDA
out-of-memory error, and the accumulation steps follow from a target
effective batch, ``--observed_batch_size``: ``target // found``, so the
optimizer's batch stays the same whatever the card holds.

    python accelerate_tpu_torch/examples/automatic_gradient_accumulation.py --observed_batch_size 64

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
    AcceleratorState,
    GradientState,
    SequenceClassifier,
    adamw,
    warmup_cosine_decay_schedule,
)
from accelerate_tpu_torch.examples.nlp_example import (  # noqa: E402
    evaluate,
    get_dataloaders,
    model_and_config,
)
from accelerate_tpu_torch.utils.memory import find_executable_batch_size  # noqa: E402
from accelerate_tpu_torch.utils.random import set_seed  # noqa: E402


def training_function(config, args):
    # The effective optimizer batch wanted; the per-step batch and the
    # accumulation steps are found below
    observed_batch_size = int(args.observed_batch_size)
    lr = config["lr"]
    seed = int(config["seed"])
    starting_batch_size = int(config["batch_size"])

    set_seed(seed)

    # New code: the decorator calls the training body again with half the
    # batch whenever the card runs out of memory; the accumulation steps
    # grow back so that the effective batch stays the same
    @find_executable_batch_size(starting_batch_size=starting_batch_size)
    def inner_training_loop(batch_size):
        # a retry builds an accelerator for its own accumulation factor: clear
        # the shared state the failed attempt left
        AcceleratorState._reset_state(reset_partial_state=True)
        GradientState._reset_state()
        num_epochs = int(config["num_epochs"])
        gradient_accumulation_steps = max(observed_batch_size // batch_size, 1)
        accelerator = Accelerator(cpu=args.cpu, mixed_precision=args.mixed_precision,
                                  gradient_accumulation_steps=gradient_accumulation_steps)
        accelerator.print(f"per-step batch {batch_size} x accumulation "
                          f"{gradient_accumulation_steps} = effective "
                          f"{batch_size * gradient_accumulation_steps}")
        model, model_config = model_and_config(accelerator, seed)
        if os.environ.get("TESTING_TINY_MODEL"):
            num_epochs = int(os.environ.get("TESTING_NUM_EPOCHS", num_epochs))
        train_dataloader, eval_dataloader = get_dataloaders(accelerator, batch_size, model_config)

        steps_per_epoch = len(train_dataloader)
        warmup_steps = max(steps_per_epoch // 4 // gradient_accumulation_steps, 1)
        schedule = warmup_cosine_decay_schedule(
            init_value=0.0, peak_value=lr, warmup_steps=warmup_steps,
            decay_steps=max(steps_per_epoch * num_epochs // gradient_accumulation_steps,
                            warmup_steps + 1),
        )
        model, optimizer, train_dataloader, eval_dataloader = accelerator.prepare(
            model, adamw(schedule, weight_decay=0.01), train_dataloader, eval_dataloader)
        carry = accelerator.init_carry(model, optimizer)
        train_step = accelerator.unified_step(SequenceClassifier.loss_fn(model),
                                              max_grad_norm=1.0)

        for epoch in range(num_epochs):
            for step, batch in enumerate(train_dataloader):
                carry, metrics = train_step(carry, batch)
                if step % 50 == 0:
                    accelerator.print(
                        f"epoch {epoch} step {step}: loss {float(metrics['loss']):.4f}")
            train_loss = float(metrics["loss"])
            eval_metric = evaluate(accelerator, model, eval_dataloader)
            accelerator.print(f"epoch {epoch}: train_loss {train_loss:.4f}", eval_metric)
        return eval_metric

    return inner_training_loop()


def main():
    parser = argparse.ArgumentParser(description="Simple example of training script.")
    parser.add_argument(
        "--mixed_precision", type=str, default=None, choices=["no", "fp16", "bf16", "fp8"],
        help="Whether to use mixed precision. Choose between fp16 and bf16 (bfloat16).",
    )
    parser.add_argument("--cpu", action="store_true", help="If passed, will train on the CPU.")
    parser.add_argument(
        "--observed_batch_size", type=int, default=64,
        help="Target effective optimizer batch; per-step batch and accumulation steps are "
             "derived automatically.",
    )
    args = parser.parse_args()
    config = {"lr": 2e-4, "num_epochs": 3, "seed": 42, "batch_size": 16}
    training_function(config, args)


if __name__ == "__main__":
    main()
