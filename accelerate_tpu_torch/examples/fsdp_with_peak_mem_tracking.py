"""Feature example: fully sharded training with peak-memory tracking, the
PyTorch port of ``examples/by_feature/fsdp_with_peak_mem_tracking.py``.

``nlp_example.py``'s classifier under ``ParallelismPlugin(fsdp_size=-1,
sharding_strategy=FULL_SHARD)`` (ZeRO-3 over every process; one process
brings up a group of one), each epoch inside a ``start_measure``/
``end_measure`` bracket whose wall time, host peak and device bytes go to
the JSONL tracker under ``--project_dir``.

    python accelerate_tpu_torch/examples/fsdp_with_peak_mem_tracking.py --project_dir logs

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
    ParallelismPlugin,
    SequenceClassifier,
    adamw,
    warmup_cosine_decay_schedule,
)
from accelerate_tpu_torch.examples.nlp_example import (  # noqa: E402
    evaluate,
    get_dataloaders,
    model_and_config,
)
from accelerate_tpu_torch.utils.dataclasses import ShardingStrategy  # noqa: E402
from accelerate_tpu_torch.utils.profiling import end_measure, start_measure  # noqa: E402
from accelerate_tpu_torch.utils.random import set_seed  # noqa: E402


def training_function(config, args):
    # New code: FULL_SHARD, params, gradients and optimizer state split over
    # every process on the fsdp axis (ZeRO-3): one plugin in place of the
    # reference's fsdp_config block; the JSONL tracker records the memory
    accelerator = Accelerator(
        cpu=args.cpu,
        mixed_precision=args.mixed_precision,
        parallelism_plugin=ParallelismPlugin(
            dp_size=1, fsdp_size=-1, sharding_strategy=ShardingStrategy.FULL_SHARD,
        ),
        log_with="jsonl",
        project_dir=args.project_dir,
    )
    accelerator.init_trackers("fsdp_peak_mem", config)
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
        # New code: a measurement bracket over the epoch: wall time, the host
        # RSS delta and peak, device 0's bytes delta and peak growth
        measures = start_measure()
        for step, batch in enumerate(train_dataloader):
            carry, metrics = train_step(carry, batch)
            if step % 50 == 0:
                accelerator.print(f"epoch {epoch} step {step}: loss {float(metrics['loss']):.4f}")
        train_loss = float(metrics["loss"])
        mem = end_measure(measures)
        accelerator.print(
            f"epoch {epoch}: {mem['time']:.1f}s, host peak +{mem['host-peak'] >> 20} MiB, "
            f"device0 delta {mem.get('device:0', 0) >> 20} MiB, peak growth "
            f"{mem.get('device:0-peak', 0) >> 20} MiB"
        )
        accelerator.log(
            {"epoch_seconds": mem["time"],
             "host_peak_bytes": mem["host-peak"],
             "device_delta_bytes": mem.get("device:0", 0),
             "device_peak_growth_bytes": mem.get("device:0-peak", 0),
             "train_loss": train_loss, "epoch": epoch},
        )

        eval_metric = evaluate(accelerator, model, eval_dataloader)
        # Use accelerator.print to print only on the main process.
        accelerator.print(f"epoch {epoch}: train_loss {train_loss:.4f}", eval_metric)
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
        "--project_dir", type=str, default="logs",
        help="Where the JSONL tracker writes the per-epoch memory records.",
    )
    args = parser.parse_args()
    config = {"lr": 2e-4, "num_epochs": 3, "seed": 42, "batch_size": 16}
    training_function(config, args)


if __name__ == "__main__":
    main()
