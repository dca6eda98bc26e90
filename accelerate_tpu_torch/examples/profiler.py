"""Feature example: profiling, the PyTorch port of
``examples/by_feature/profiler.py``.

``nlp_example.py``'s classifier and loop inside three measurements: a
``start_measure``/``end_measure`` bracket (wall time, host RSS, each CUDA
device's bytes), a ``StepTimer`` (per-step seconds, the first left out),
and ``accelerator.profile`` with ``ProfileKwargs(skip_first=2)``, which
writes ``torch.profiler``'s Chrome trace (``*.pt.trace.json``) into
``--profile_dir`` where the reference writes an ``.xplane.pb``.

    python accelerate_tpu_torch/examples/profiler.py --profile_dir /tmp/trace

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
from accelerate_tpu_torch.utils.profiling import (  # noqa: E402
    ProfileKwargs,
    StepTimer,
    end_measure,
    log_measures,
    start_measure,
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

    # New code: a measurement bracket, a deferred-start torch.profiler trace
    # and a step timer
    measures = start_measure()
    timer = StepTimer(skip=1)  # the first tick pays one-time set-up; left out
    profile_kwargs = ProfileKwargs(output_trace_dir=args.profile_dir, skip_first=2)

    # Now we train the model
    with accelerator.profile(profile_kwargs=profile_kwargs) as prof:
        for epoch in range(num_epochs):
            for step, batch in enumerate(train_dataloader):
                carry, metrics = train_step(carry, batch)
                # New code: one tick a step (it waits for the loss, so the
                # device's time is charged to the step); prof.step() starts
                # the trace once `skip_first` steps have run
                timer.tick(metrics["loss"])
                if prof is not None:
                    prof.step()
                if step % 50 == 0:
                    accelerator.print(
                        f"epoch {epoch} step {step}: loss {float(metrics['loss']):.4f}")
            train_loss = float(metrics["loss"])

            eval_metric = evaluate(accelerator, model, eval_dataloader)
            # Use accelerator.print to print only on the main process.
            accelerator.print(f"epoch {epoch}: train_loss {train_loss:.4f}", eval_metric)

    # New code: close the bracket and report: wall time, the host RSS delta
    # and peak, each CUDA device's bytes delta and peak growth, and the step
    # timing (the first step left out)
    results = end_measure(measures)
    if accelerator.is_main_process:
        log_measures(results, "training run")
    accelerator.print("step timing:", timer.summary())
    if prof is not None and prof.trace_path is not None:
        accelerator.print(f"torch.profiler trace written to {prof.trace_path} "
                          "(open it in ui.perfetto.dev or chrome://tracing)")
    elif args.profile_dir:
        accelerator.print("no trace captured: fewer steps ran than ProfileKwargs.skip_first")
    return eval_metric


def main():
    parser = argparse.ArgumentParser(description="Simple example of training script.")
    parser.add_argument(
        "--mixed_precision", type=str, default=None, choices=["no", "fp16", "bf16", "fp8"],
        help="Whether to use mixed precision. Choose between fp16 and bf16 (bfloat16).",
    )
    parser.add_argument("--cpu", action="store_true", help="If passed, will train on the CPU.")
    parser.add_argument(
        "--profile_dir", type=str, default=None,
        help="Write a torch.profiler trace here (Chrome JSON).",
    )
    args = parser.parse_args()
    config = {"lr": 2e-4, "num_epochs": 3, "seed": 42, "batch_size": 16}
    training_function(config, args)


if __name__ == "__main__":
    main()
