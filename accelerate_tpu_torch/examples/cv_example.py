"""Simple CV example, the PyTorch port of ``examples/cv_example.py``.

A small convolutional classifier trained on a synthetic shapes dataset
(squares, disks, crosses, stripes; made locally from a seed, no network),
on one GPU (or on the CPU with ``--cpu``), in fp32 or mixed precision,
with the same Accelerator flow as ``nlp_example.py``: ``prepare`` the
model, optimizer and loaders, build the train step, iterate, evaluate with
``gather_for_metrics``.

    python accelerate_tpu_torch/examples/cv_example.py --mixed_precision bf16

``ConvClassifier`` is the reference's flax module (3 x [3x3 SAME conv ->
relu -> 2x2 max-pool] at 32/64/128 features -> spatial mean -> Dense 128
-> relu -> Dense 4 in fp32) on NHWC input; ``params_from_flax`` carries a
flax parameter tree over (HWIO kernels to OIHW, Dense kernels
transposed). ``TESTING_TINY_MODEL=1`` takes 1024 training rows;
``TESTING_NUM_EPOCHS`` then sets the epochs.
"""

import argparse
import math
import os
import sys

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.data import DataLoader

# run by path without an install: put the repository root on sys.path
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from accelerate_tpu_torch import Accelerator, adamw  # noqa: E402
from accelerate_tpu_torch.utils.random import set_seed  # noqa: E402

########################################################################
# This is a fully working simple example to use accelerate_tpu_torch for
# computer vision: train a CNN to classify procedurally generated shape
# images (squares / disks / crosses / stripes), on a GPU or the CPU, with
# or without mixed precision.
########################################################################

IMAGE_SIZE = 32
NUM_CLASSES = 4
EVAL_BATCH_SIZE = 64
FEATURES = (32, 64, 128)


def render_example(rng: np.random.Generator, label: int) -> np.ndarray:
    """One (IMAGE_SIZE, IMAGE_SIZE, 1) float32 image of the given class."""
    img = rng.normal(0.0, 0.15, (IMAGE_SIZE, IMAGE_SIZE)).astype(np.float32)
    cy, cx = rng.integers(8, IMAGE_SIZE - 8, 2)
    r = int(rng.integers(4, 8))
    yy, xx = np.mgrid[0:IMAGE_SIZE, 0:IMAGE_SIZE]
    if label == 0:  # filled square
        img[cy - r:cy + r, cx - r:cx + r] += 1.0
    elif label == 1:  # disk
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] += 1.0
    elif label == 2:  # cross
        img[cy - r:cy + r, cx - 1:cx + 2] += 1.0
        img[cy - 1:cy + 2, cx - r:cx + r] += 1.0
    else:  # diagonal stripes
        img[(yy + xx) % 8 < 2] += 1.0
    return img[:, :, None]


def make_shapes_dataset(num_examples: int, seed: int):
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, NUM_CLASSES, num_examples)
    return [{"pixel_values": render_example(rng, int(y)), "labels": np.int32(y)}
            for y in labels]


def collate_fn(items):
    return {key: np.stack([item[key] for item in items]) for key in items[0]}


def get_dataloaders(accelerator: Accelerator, batch_size: int = 32):
    n_train = 1024 if os.environ.get("TESTING_TINY_MODEL") else 8192
    train_dataset = make_shapes_dataset(n_train, seed=1234)
    eval_dataset = make_shapes_dataset(n_train // 4, seed=5678)
    train_dataloader = DataLoader(
        train_dataset, shuffle=True, collate_fn=collate_fn,
        batch_size=batch_size, drop_last=True,
    )
    eval_dataloader = DataLoader(
        eval_dataset, shuffle=False, collate_fn=collate_fn,
        batch_size=EVAL_BATCH_SIZE, drop_last=False,
    )
    return train_dataloader, eval_dataloader


def _lecun_normal(shape, fan_in: int, generator) -> torch.Tensor:
    """flax's default kernel init: a normal truncated at two deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    out = torch.empty(shape, device=generator.device)
    return nn.init.trunc_normal_(out, std=std, a=-2 * std, b=2 * std, generator=generator)


class ConvClassifier(nn.Module):
    """The reference's small CNN on NHWC images: three 3x3 SAME convolutions
    with relu and 2x2 max-pooling, the spatial mean, a relu Dense of 128 and
    the fp32 Dense of ``num_classes``. fp32 parameters; the convolutions and
    the first Dense compute in ``dtype`` (its inputs and weights cast, as
    flax's ``dtype=``), the logits in fp32. Made on ``device`` (CUDA unless
    the caller passes ``device="cpu"``) from ``generator`` (seeded 0 if
    none)."""

    def __init__(self, num_classes: int = NUM_CLASSES, dtype: str = "float32", device=None,
                 generator=None):
        super().__init__()
        device = torch.device(device if device is not None else "cuda")
        if generator is None:
            generator = torch.Generator(device).manual_seed(0)
        self.dtype = getattr(torch, dtype)
        self.convs = nn.ModuleList()
        cin = 1
        for features in FEATURES:
            conv = nn.Conv2d(cin, features, 3, padding=1, device=device)
            with torch.no_grad():
                conv.weight.copy_(_lecun_normal(conv.weight.shape, cin * 9, generator))
                conv.bias.zero_()
            self.convs.append(conv)
            cin = features
        self.dense = nn.Linear(cin, 128, device=device)
        self.head = nn.Linear(128, num_classes, device=device)
        for layer in (self.dense, self.head):
            with torch.no_grad():
                layer.weight.copy_(_lecun_normal(layer.weight.shape, layer.in_features,
                                                 generator))
                layer.bias.zero_()

    def forward(self, pixel_values: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        x = pixel_values.to(dt).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv in self.convs:
            x = F.conv2d(x, conv.weight.to(dt), conv.bias.to(dt), padding=1)
            x = F.max_pool2d(F.relu(x), 2, 2)
        x = x.mean(dim=(2, 3))  # the spatial mean
        x = F.relu(F.linear(x, self.dense.weight.to(dt), self.dense.bias.to(dt)))
        return F.linear(x.float(), self.head.weight.float(), self.head.bias.float())


def params_from_flax(tree) -> dict[str, torch.Tensor]:
    """A flax ``ConvClassifier``'s params (``Conv_i``/``Dense_i`` kernels and
    biases, numpy or jax arrays) as this module's state dict: HWIO kernels
    to OIHW, Dense (in, out) kernels transposed."""
    out = {}
    for i in range(len(FEATURES)):
        conv = tree[f"Conv_{i}"]
        out[f"convs.{i}.weight"] = torch.tensor(np.asarray(conv["kernel"])).permute(3, 2, 0, 1)
        out[f"convs.{i}.bias"] = torch.tensor(np.asarray(conv["bias"]))
    for name, key in (("dense", "Dense_0"), ("head", "Dense_1")):
        out[f"{name}.weight"] = torch.tensor(np.asarray(tree[key]["kernel"])).T
        out[f"{name}.bias"] = torch.tensor(np.asarray(tree[key]["bias"]))
    return {k: v.contiguous() for k, v in out.items()}


def loss_fn(model):
    def fn(params, batch):
        logits = torch.func.functional_call(model, params, (batch["pixel_values"],))
        return F.cross_entropy(logits.float(), batch["labels"].long())

    # the terms the mean runs over, for the global batch across processes
    fn.loss_weight = lambda batch: float(len(batch["labels"]))
    return fn


def training_function(config, args):
    # Initialize accelerator
    accelerator = Accelerator(cpu=args.cpu, mixed_precision=args.mixed_precision)
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

    # Now we train the model
    for epoch in range(num_epochs):
        for step, batch in enumerate(train_dataloader):
            carry, metrics = train_step(carry, batch)
            if step % 50 == 0:
                accelerator.print(f"epoch {epoch} step {step}: loss {float(metrics['loss']):.4f}")
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
    return eval_metric


def compute_dtype(accelerator: Accelerator) -> str:
    """The model's compute dtype from the accelerator's policy."""
    return str(accelerator.state.mixed_precision_policy.compute_dtype).replace("torch.", "")


def main():
    parser = argparse.ArgumentParser(description="Simple example of training script.")
    parser.add_argument(
        "--mixed_precision", type=str, default=None, choices=["no", "fp16", "bf16", "fp8"],
        help="Whether to use mixed precision. Choose between fp16 and bf16 (bfloat16).",
    )
    parser.add_argument("--cpu", action="store_true", help="If passed, will train on the CPU.")
    args = parser.parse_args()
    config = {"lr": 3e-3, "num_epochs": 3, "seed": 42, "batch_size": 32}
    training_function(config, args)


if __name__ == "__main__":
    main()
