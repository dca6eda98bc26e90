"""The Accelerator: prepare, one train step, checkpoints and metrics.

Port of ``accelerate_tpu/accelerator.py`` (``__init__`` :88-205,
``print`` :291, ``prepare`` :297-424, ``unified_step`` :429-748 in its
unfused mode with ``_sync_apply`` :505-554, ``init_carry`` :1146,
``sync_from_carry`` :1225, ``gather``/``gather_for_metrics`` :1375-1407,
``register_for_checkpointing``/``save_state``/``load_state`` :1434-1506,
``save_model`` :1508, ``get_state_dict`` :1520, ``skip_first_batches``
:1558, ``set_seed`` :1561) for one process on one device. The step keeps
the reference's contract and arithmetic:
``step_fn(carry, batch) -> (carry, metrics)``; the loss runs on parameters
cast to the policy's compute dtype while the fp32 masters receive fp32
gradients (``_cast_floating`` :1667); K-step accumulation sums into an fp32
buffer; every K-th call takes the mean, unscales and checks it (fp16),
clips it to ``max_grad_norm`` by the global norm, applies AdamW (one fused
kernel launch over every leaf for a ``fused_adamw`` optimizer), and on a
non-finite step holds params and optimizer state.

PyTorch runs eagerly, so there is no compiled program: the step is a
Python function, and params, moments and the accumulation buffer are
updated in place (the carry returned holds the same tensors).
"""

from __future__ import annotations

import functools
import inspect
from typing import Any, Callable, Optional

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function

from . import checkpointing
from .data_loader import (
    DataLoaderShard,
    prepare_data_loader,
    send_to_device,
    skip_first_batches,
)
from .logging import get_logger
from .models.transformer import convert_model
from .ops.fused import maybe_fused_epilogue
from .optimizer import (
    AcceleratedOptimizer,
    AdamW,
    global_norm,
    init_loss_scale,
    scale_loss,
    unscale_and_check,
)
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .utils import operations
from .utils.dataclasses import GradientAccumulationPlugin, ProjectConfiguration
from .utils.random import KeyChain, set_seed

logger = get_logger(__name__)


def _cast_floating(tree: Any, dtype: torch.dtype) -> Any:
    """Every floating tensor leaf of a dict/list/tuple tree cast to ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast_floating(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_cast_floating(v, dtype) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        return tree.to(dtype)
    return tree


def _is_dataloader(obj: Any) -> bool:
    return isinstance(obj, DataLoaderShard) or (
        hasattr(obj, "dataset") and hasattr(obj, "batch_size")
    )


def _is_schedule(obj: Any) -> bool:
    """Only plain functions and partials are taken as LR schedules."""
    return inspect.isfunction(obj) or isinstance(obj, functools.partial)


class Accelerator:
    """One instance per training script, on one device: CUDA unless
    ``cpu=True``. ``seed`` seeds the accelerator's own generator
    (``keys``), which checkpoints carry."""

    def __init__(
        self,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: int = 1,
        cpu: bool = False,
        parallelism_plugin: Any = None,
        project_config: Optional[ProjectConfiguration] = None,
        project_dir: Optional[str] = None,
        seed: int = 0,
    ):
        if parallelism_plugin is not None:
            raise NotImplementedError(
                "sharded and pipelined training is not ported yet: ROADMAP.md, queue A7"
            )
        self.project_configuration = project_config or ProjectConfiguration(
            project_dir=project_dir)
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu)
        self.gradient_state = GradientState(
            GradientAccumulationPlugin(num_steps=gradient_accumulation_steps)
        )
        self.keys = KeyChain(seed)
        self._optimizers: list[AcceleratedOptimizer] = []
        self._schedulers: list[AcceleratedScheduler] = []
        self._dataloaders: list[DataLoaderShard] = []
        self._custom_objects: list[Any] = []
        self.step = 0  # train-step calls, micro steps included (host mirror)

    @property
    def device(self) -> torch.device:
        return self.state.device

    # one process on one device
    is_main_process = True
    process_index = 0
    num_processes = 1

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    def print(self, *args, **kwargs) -> None:
        """``print`` on the main process (here, always)."""
        print(*args, **kwargs)

    # ------------------------------------------------------------------ #
    # prepare
    # ------------------------------------------------------------------ #
    def prepare(self, *args):
        """Place each object by type and return them in input order: a
        model moves to the device (fp32 masters; converted to fp8
        projections under ``mixed_precision="fp8"``), an :class:`AdamW` is
        wrapped and its state made for the prepared model, a loader yields
        device batches, a plain function becomes an LR scheduler."""
        result = []
        model = None
        for obj in args:
            if isinstance(obj, nn.Module):
                prepared = model = self.prepare_model(obj)
            elif isinstance(obj, AcceleratedOptimizer):
                prepared = obj
                self._optimizers.append(prepared)
            elif isinstance(obj, AdamW):
                prepared = AcceleratedOptimizer(obj)
                self._optimizers.append(prepared)
            elif _is_dataloader(obj):
                prepared = self.prepare_data_loader(obj)
            else:
                prepared = obj
            result.append(prepared)
        for i, obj in enumerate(result):
            if isinstance(obj, AcceleratedOptimizer) and obj.opt_state is None and model is not None:
                obj.init(dict(model.named_parameters()))
            if _is_schedule(obj):
                result[i] = AcceleratedScheduler(obj)
                self._schedulers.append(result[i])
        return result[0] if len(result) == 1 else tuple(result)

    def prepare_model(self, model: nn.Module) -> nn.Module:
        """The model on the device; under ``mixed_precision="fp8"`` its
        projections are first converted to fp8 products
        (``models/transformer.convert_model``, the reference's :325-330)."""
        if self.state.mixed_precision_policy.fp8:
            model = convert_model(model)
        return model.to(device=self.device)

    def prepare_data_loader(self, dataloader: Any) -> DataLoaderShard:
        if not isinstance(dataloader, DataLoaderShard):
            dataloader = prepare_data_loader(dataloader, self.state)
        self._dataloaders.append(dataloader)
        return dataloader

    # ------------------------------------------------------------------ #
    # the train step
    # ------------------------------------------------------------------ #
    def unified_step(
        self,
        loss_fn: Callable[..., Any],
        optimizer: Optional[AcceleratedOptimizer] = None,
        max_grad_norm: Optional[float] = None,
    ) -> Callable:
        """Build the train step: forward, backward, accumulation, clipping
        and update. ``loss_fn(params, batch) -> loss`` takes a name ->
        tensor dict of params.

        Returns ``step_fn(carry, batch) -> (carry, metrics)`` with
        ``carry = accelerator.init_carry(model_or_params, optimizer)``;
        metrics are ``loss``, ``grad_norm`` (NaN on a step that only
        accumulates), ``grads_finite`` and ``is_sync_step``."""
        optimizer = optimizer or (self._optimizers[0] if self._optimizers else None)
        if optimizer is None:
            raise ValueError("prepare() an optimizer before building the step")
        policy = self.state.mixed_precision_policy
        num_accum = self.gradient_state.num_steps

        def _sync_apply(accum, opt_state, params, ls):
            """Once per optimizer step: mean, unscale/check (fp16), clip,
            update, hold on a non-finite step. Works in place on ``accum``."""
            mean_grads = accum
            if num_accum > 1:
                mean_grads = {k: a.div_(num_accum) for k, a in accum.items()}
            mean_grads, finite, new_ls = unscale_and_check(mean_grads, ls, policy)
            gnorm = global_norm(mean_grads)
            scale_c = None
            if max_grad_norm is not None:
                scale_c = torch.clamp(max_grad_norm / (gnorm + 1e-6), max=1.0)
            # fused epilogue (ops/fused.py): for a fused_adamw optimizer the
            # clip multiply -> moment update -> apply -> non-finite hold tail
            # runs as one kernel launch, bitwise the plain chain below in fp32
            if maybe_fused_epilogue(optimizer.optimizer, mean_grads, opt_state, params,
                                    clip_scale=scale_c, finite=finite) is not None:
                return new_ls, gnorm, finite
            if scale_c is not None:
                for g in mean_grads.values():
                    g.mul_(scale_c)
            if finite:  # fp16 overflow: keep params and optimizer state
                optimizer.apply_gradients(mean_grads, params, opt_state)
            return new_ls, gnorm, finite

        def step_fn(carry: dict, batch: Any):
            params = carry["params"]
            ls = carry.get("loss_scale")
            batch = send_to_device(batch, self.device)
            names = list(params)
            compute_params = _cast_floating(params, policy.compute_dtype)
            compute_batch = _cast_floating(batch, policy.compute_dtype)
            loss = loss_fn(compute_params, compute_batch)
            grads = torch.autograd.grad(
                scale_loss(loss.float(), ls), [params[k] for k in names]
            )
            del compute_params
            grads = dict(zip(names, grads))  # fp32: the masters' dtype
            if num_accum > 1:
                accum = carry["accum_grads"]
                for k, g in grads.items():
                    accum[k].add_(g)
                del grads
            else:
                accum = grads  # no buffer carried
            micro = carry["micro_step"] + 1
            is_sync = micro >= num_accum
            if is_sync:
                # names the optimizer epilogue in a torch.profiler trace (no
                # cost without a profiler); the forward and backward are not
                # wrapped: autograd launches the backward from its own thread,
                # outside any range opened here
                with record_function("unified_step.sync_apply"):
                    ls, gnorm, finite = _sync_apply(accum, carry["opt_state"], params, ls)
                if num_accum > 1:
                    for a in accum.values():
                        a.zero_()
            else:
                gnorm = torch.tensor(float("nan"))
                finite = True
            new_carry = dict(carry)
            new_carry["micro_step"] = 0 if is_sync else micro
            new_carry["opt_step"] = carry["opt_step"] + int(is_sync)
            if ls is not None:
                new_carry["loss_scale"] = ls
            self.step += 1
            self.gradient_state.sync_gradients = is_sync
            metrics = {
                "loss": loss.detach().float(),
                "grad_norm": gnorm,
                "grads_finite": finite,
                "is_sync_step": is_sync,
            }
            return new_carry, metrics

        return step_fn

    def init_carry(self, params: Any, optimizer: Optional[AcceleratedOptimizer] = None) -> dict:
        """The train-step carry: params (the model's own parameter tensors,
        updated in place), optimizer state, counters, the fp32
        accumulation buffer when K > 1, and the loss scale under fp16."""
        optimizer = optimizer or (self._optimizers[0] if self._optimizers else None)
        if optimizer is None:
            raise ValueError("prepare() an optimizer before init_carry")
        if isinstance(params, nn.Module):
            params = dict(params.named_parameters())
        for p in params.values():
            if not p.requires_grad:
                p.requires_grad_(True)
        if optimizer.opt_state is None:
            optimizer.init(params)
        policy = self.state.mixed_precision_policy
        carry = {
            "params": params,
            "opt_state": optimizer.opt_state,
            "opt_step": 0,
            "micro_step": 0,
        }
        if self.gradient_state.num_steps > 1:
            carry["accum_grads"] = {
                k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()
            }
        if policy.uses_loss_scaling:
            carry["loss_scale"] = init_loss_scale(policy, self.device)
        return carry

    def sync_from_carry(self, carry: dict) -> None:
        """Set ``step`` and ``sync_gradients`` from the carry's counters."""
        micro = int(carry["micro_step"])
        self.step = int(carry["opt_step"]) * self.gradient_state.num_steps + micro
        self.gradient_state.sync_gradients = micro == 0

    # ------------------------------------------------------------------ #
    # metrics
    # ------------------------------------------------------------------ #
    def gather(self, tensor: Any) -> Any:
        return operations.gather(tensor)

    def gather_for_metrics(self, input_data: Any, use_gather_object: bool = False) -> Any:
        """Gather eval outputs; on the last batch of a loader whose tail
        wrapped around, only the first ``remainder`` rows are real, and
        the rest are dropped."""
        if use_gather_object or not _all_tensor_leaves(input_data):
            data = operations.gather_object(input_data)
            return [x for sub in data for x in (sub if isinstance(sub, list) else [sub])]
        data = operations.gather(input_data)
        remainder = self.gradient_state.remainder
        if self.gradient_state.end_of_dataloader and remainder > 0:

            def _adjust(t):
                if t.dim() == 0:  # a scalar carries no repeated rows
                    logger.warning_once("gather_for_metrics got a 0-d leaf at the end of the "
                                        "dataloader; returning it un-truncated")
                    return t
                return t[:remainder]

            data = operations.recursively_apply(_adjust, data)
        return data

    def reduce(self, tensor: Any, reduction: str = "sum", scale: float = 1.0) -> Any:
        return operations.reduce(tensor, reduction, scale)

    def pad_across_processes(self, tensor: Any, dim: int = 0, pad_index: int = 0,
                             pad_first: bool = False) -> Any:
        return operations.pad_across_processes(tensor, dim, pad_index, pad_first)

    # ------------------------------------------------------------------ #
    # checkpoints
    # ------------------------------------------------------------------ #
    def register_for_checkpointing(self, *objects: Any) -> None:
        """Objects with ``state_dict``/``load_state_dict`` that
        ``save_state`` and ``load_state`` carry along."""
        invalid = [o for o in objects
                   if not (hasattr(o, "state_dict") and hasattr(o, "load_state_dict"))]
        if invalid:
            raise ValueError("All `objects` must include a `state_dict` and `load_state_dict` "
                             f"function to be stored; got {invalid}")
        self._custom_objects.extend(objects)

    def save_state(self, output_dir: Optional[str] = None, carry: Any = None,
                   block: bool = True, **kwargs) -> str:
        """Checkpoint the training state (``checkpointing.save_accelerator_state``);
        returns the committed directory."""
        if not block:
            raise NotImplementedError(
                "save_state(block=False), the background writer, is not ported yet: "
                "ROADMAP.md, queue A6")
        return checkpointing.save_accelerator_state(self, output_dir, carry=carry, **kwargs)

    def load_state(self, input_dir: Optional[str] = None, carry: Any = None, **kwargs) -> Any:
        """Restore a checkpoint into ``carry`` (its tensors in place) and
        return the restored carry."""
        return checkpointing.load_accelerator_state(self, input_dir, carry=carry, **kwargs)

    def save_model(self, params: Any, save_directory: str, max_shard_size: str = "10GB",
                   safe_serialization: bool = True) -> None:
        checkpointing.save_model_weights(params, save_directory, max_shard_size=max_shard_size,
                                         safe_serialization=safe_serialization)

    def get_state_dict(self, params: Any, unwrap: bool = True) -> dict[str, torch.Tensor]:
        """Every tensor of a module or parameter tree, by name, on the host."""
        return checkpointing._to_named_tensors(params)

    def unwrap_model(self, model: Any, keep_fp32_wrapper: bool = True) -> Any:
        """No wrapper is put around a prepared model: the model itself."""
        return model

    def skip_first_batches(self, dataloader: DataLoaderShard, num_batches: int = 0):
        return skip_first_batches(dataloader, num_batches)

    def set_seed(self, seed: int) -> torch.Generator:
        self.keys = KeyChain(seed)
        return set_seed(seed)


def _all_tensor_leaves(tree: Any) -> bool:
    leaves = []
    operations.recursively_apply(leaves.append, tree, test_type=lambda x: True)
    return bool(leaves) and all(isinstance(x, (torch.Tensor, np.ndarray)) for x in leaves)
