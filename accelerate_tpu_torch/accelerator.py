"""The Accelerator: prepare, then one train step.

Port of ``accelerate_tpu/accelerator.py`` (``__init__`` :88-205,
``prepare`` :297-424, ``unified_step`` :429-748 in its unfused mode with
``_sync_apply`` :505-554, ``init_carry`` :1146) for one process on one
device. The step keeps the reference's contract and arithmetic:
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

import torch
from torch import nn
from torch.profiler import record_function

from .data_loader import DataLoaderShard, prepare_data_loader, send_to_device
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
from .utils.dataclasses import GradientAccumulationPlugin


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
    ``cpu=True``."""

    def __init__(
        self,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: int = 1,
        cpu: bool = False,
        parallelism_plugin: Any = None,
    ):
        if parallelism_plugin is not None:
            raise NotImplementedError(
                "sharded and pipelined training is not ported yet: ROADMAP.md, queue A7"
            )
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu)
        self.gradient_state = GradientState(
            GradientAccumulationPlugin(num_steps=gradient_accumulation_steps)
        )
        self._optimizers: list[AcceleratedOptimizer] = []

    @property
    def device(self) -> torch.device:
        return self.state.device

    # ------------------------------------------------------------------ #
    # prepare
    # ------------------------------------------------------------------ #
    def prepare(self, *args):
        """Place each object by type and return them in input order: a
        model moves to the device (fp32 masters), an :class:`AdamW` is
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
        return result[0] if len(result) == 1 else tuple(result)

    def prepare_model(self, model: nn.Module) -> nn.Module:
        return model.to(device=self.device)

    def prepare_data_loader(self, dataloader: Any) -> DataLoaderShard:
        if isinstance(dataloader, DataLoaderShard):
            return dataloader
        return prepare_data_loader(dataloader, self.state)

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
