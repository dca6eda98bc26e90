"""The Accelerator: prepare, one train step, checkpoints and metrics.

Port of ``accelerate_tpu/accelerator.py`` (``__init__`` :88-205, the
topology properties and process helpers :207-290,
``print`` :291, ``prepare`` :297-424 with ``prepare_optimizer`` :408 and
``prepare_scheduler`` :416, ``unified_step`` :429-748 in both
accumulation modes with ``_sync_apply`` :505-554 and ``_fused_step``
:560-627, ``unified_pipeline_step`` :750-899, ``_wrap_step`` :901-1020 without its XLA-only AOT warmup and
compile monitor, ``init_carry`` :1146, ``sync_from_carry`` :1225, the raw
loop :1240-1310, ``gather``/``gather_for_metrics`` :1375-1407,
``set_trigger``/``check_trigger`` :1419, ``register_for_checkpointing``/
``save_state``/``wait_for_checkpoint``/``load_state`` :1434-1506, ``save_model`` :1508,
``get_state_dict`` :1520, ``free_memory`` :1532, ``skip_first_batches``
:1558, ``set_seed`` :1561, ``autocast`` :1343, ``profile`` :1349, the
trackers ``log``/``init_trackers``/``get_tracker`` :1565-1581,
``end_training`` :1584, ``__repr__`` :1591, ``join_uneven_inputs`` :1309,
and ``diagnostics=``/``profile_kwargs=`` :183-200), one device a process.
The step keeps the reference's contract and arithmetic:
``step_fn(carry, batch, **kw) -> (carry, metrics)``; the loss runs on
parameters cast to the policy's compute dtype while the fp32 masters
receive fp32 gradients (``_cast_floating`` :1667); K-step accumulation sums
into an fp32 buffer across calls, or, fused, over a stacked batch in one
call; every optimizer step takes the mean, unscales and checks it (fp16),
clips it to ``max_grad_norm`` by the global norm, applies the optimizer
(AdamW as one fused kernel launch over every leaf for a ``fused_adamw``
optimizer), and on a non-finite step holds params and optimizer state.

PyTorch runs eagerly, so there is no compiled program: the step is a
Python function, and params, moments and the accumulation buffer are
updated in place (the carry returned holds the same tensors). The params
may be a name -> tensor dict (a module's parameters) or a nested dict of
tensors (a LoRA adapter tree, ``adapters/lora.py``): the loss function
receives the tree as given, and the optimizer state and the accumulation
buffer are keyed by the leaves' dotted paths.

Across processes (a ``torch.distributed`` group, ``state.py``) each process
holds its own rows of every global batch, where the reference's step sees
the global batch as one array. Two things keep the reference's numbers:

* the gradients are averaged across processes once per optimizer step,
  before the unscale, the clip and the update (``_sync_apply``; the
  accumulated sum, so one all-reduce a leaf an optimizer step), and on every
  call of the raw loop's ``backward``, whose gradients are the global
  batch's as the reference's are. Whenever a group is up the mean goes
  through it, at any world size.
* the loss is the global batch's. A loss function may say how many terms
  its mean runs over in a batch (``loss_fn.loss_weight(batch)``;
  ``CausalLM.loss_fn`` and ``adapters.lora_loss_fn`` count the target tokens
  under ``loss_mask``, ``models.transformer.next_token_count``). Each
  process's loss then enters the backward times ``world * c / max(W, 1)``,
  ``c`` its own count and ``W`` the all-reduced sum of the counts (taken
  before the forward), and the reported loss is the all-reduced sum of
  those terms over ``world``: for a masked mean that is
  ``sum(nll * mask) / max(sum(mask), 1)`` over every process's rows, the
  reference's number, where a mean of per-process means would differ
  whenever the processes hold different mask counts. A loss without
  ``loss_weight`` weighs every process alike (a mean over equal row counts).
  At world size 1 the factor is exactly 1.0 and the group's sum and mean
  change no bit.

Under a ``ParallelismPlugin`` (reference :227, :297-351, :484-660,
:1150-1225, :1520) the state holds a mesh over dp, pp, fsdp, ep, sp and tp, and
``prepare`` places the params (a model's parameters become DTensors) by
``parallel.sharding``'s rules, the moments by ``moment_shardings`` and the
unfused accumulation buffer by ZeRO-2's specs. The step then runs on each
rank's local tensors through ``parallel/runtime.py``'s ``ShardedLayout``:
leaves split over fsdp are gathered as they are used (a port model's layers
one at a time), products split over tp, each sp rank takes its chunk of the
sequence and each ep rank its experts, and the loss weight, the gradient
mean and the reported loss run over the ranks that hold other tokens (dp x
fsdp x ep x sp) only, so a tp group's rows count once; a pipeline's stages
train through ``unified_pipeline_step`` (``parallel/pipeline.py``). The epilogue's norm, non-finite check and
update are the mesh's (ZeRO-1/2 update each rank's fsdp slice and gather
it). A kernel never sees a DTensor. At world size 1 every degree is 1 and
the step is the unsharded one bit for bit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import inspect
from contextlib import contextmanager
from typing import Any, Callable, Optional, Union

import numpy as np
import torch
from torch import nn
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

from . import checkpointing
from .checkpoint_async import AsyncCheckpointer, save_accelerator_state_async
from .data_loader import (
    DataLoaderShard,
    _stack_group,
    find_batch_size,
    prepare_data_loader,
    send_to_device,
    skip_first_batches,
)
from .logging import get_logger
from .models.transformer import REMAT_POLICIES, convert_model, tp_partial_leaves
from .ops.fused import maybe_fused_epilogue
from .optimizer import (
    AcceleratedOptimizer,
    Optimizer,
    global_norm,
    init_loss_scale,
    scale_loss,
    unscale_and_check,
)
from .parallel.runtime import build_layout, gather_full, layout_of_placements
from .parallel.sharding import get_logical_specs, is_dtensor
from .scheduler import AcceleratedScheduler
from .state import AcceleratorState, GradientState
from .telemetry import StepTelemetry, TelemetryConfig
from .utils import operations
from .utils.dataclasses import (
    DataLoaderConfiguration,
    DistributedType,
    GradientAccumulationPlugin,
    ProjectConfiguration,
)
from .utils.memory import release_memory
from .utils.profiling import ProfileKwargs
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


def _flat_params(tree: dict) -> dict:
    """The tensors of a params tree by dotted path: a name -> tensor dict as
    it is, a nested dict (an adapter tree) flattened; the same tensor
    objects either way."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update({f"{k}.{name}": t for name, t in _flat_params(v).items()})
        else:
            out[k] = v
    return out


def _like_tree(tree: dict, flat: dict, prefix: str = "") -> dict:
    """``tree``'s nesting over the tensors of ``flat`` (``_flat_params``'
    paths)."""
    return {k: _like_tree(v, flat, f"{prefix}{k}.") if isinstance(v, dict) else flat[prefix + k]
            for k, v in tree.items()}


def _is_param_tree(obj: Any) -> bool:
    """A (nested) dict whose leaves are all tensors."""
    if not isinstance(obj, dict) or not obj:
        return False
    return all(_is_param_tree(v) if isinstance(v, dict) else isinstance(v, torch.Tensor)
               for v in obj.values())


def _detach(tree: Any) -> Any:
    """Every tensor leaf of a dict/list/tuple tree detached."""
    return operations.recursively_apply(
        lambda t: t.detach(), tree, test_type=lambda x: isinstance(x, torch.Tensor))


def _clip_scale(gnorm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """min(1, max_norm / (gnorm + 1e-6)), divided as the reference divides
    (a float over a tensor is a reciprocal times the float in PyTorch)."""
    return torch.clamp(torch.full_like(gnorm, max_norm) / (gnorm + 1e-6), max=1.0)


def _micro_loss_fn(loss_fn: Callable, has_aux: bool, remat_policy: Any) -> Callable:
    """``(compute_params, batch, loss_scale, kw) -> (scaled fp32 loss, loss,
    aux)`` for one microbatch, under ``torch.utils.checkpoint`` when
    ``remat_policy`` is set (True: recompute everything; a name of
    ``REMAT_POLICIES``: keep what that policy keeps)."""

    def run(params, batch, ls, kw):
        out = loss_fn(params, batch, **kw)
        loss, aux = (out[0], out[1]) if has_aux else (out, None)
        return scale_loss(loss.float(), ls), loss, aux

    if remat_policy is None:
        return run
    if remat_policy is not True and remat_policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {remat_policy!r}: True or one of "
                         f"{sorted(REMAT_POLICIES)}")
    policy = None if remat_policy is True else REMAT_POLICIES[remat_policy]
    ckpt_kw = {} if policy is None else {
        "context_fn": functools.partial(create_selective_checkpoint_contexts, policy)}

    def remat(params, batch, ls, kw):
        return checkpoint(run, params, batch, ls, kw, use_reentrant=False, **ckpt_kw)

    return remat


def _loss_factor(loss_fn: Callable, batch: Any, world: int, device,
                 group: Any = None) -> torch.Tensor:
    """``world * c / max(W, 1)``: the weight of this process's loss in the
    global batch's (the module docstring), ``c`` its ``loss_weight`` count
    (1 without one) and ``W`` their sum over ``group`` (the whole group by
    default; under a mesh the data-parallel ranks, ``world`` of them)."""
    import torch.distributed as dist

    weigh = getattr(loss_fn, "loss_weight", None)
    c = torch.as_tensor(weigh(batch) if weigh is not None else 1.0,
                        dtype=torch.float32).to(device).reshape(())
    total = c.clone()
    dist.all_reduce(total, group=group)
    return world * c / total.clamp_min(1.0)


def _global_loss(loss: torch.Tensor, factor: torch.Tensor, world: int,
                 group: Any = None) -> torch.Tensor:
    """The global batch's loss from each process's weighted term."""
    import torch.distributed as dist

    term = (loss.float() * factor).reshape(())
    dist.all_reduce(term, group=group)
    return term / world


def _mean_across_processes_(grads: dict, world: int) -> None:
    """Every gradient replaced in place by its mean over the group: the
    sum goes through the group at any world size; the divide is skipped at
    world size 1, where it changes no bit and would read and write every
    gradient once more (15.4 GB a step on the main path's 1.92e9 fp32
    gradients)."""
    import torch.distributed as dist

    for g in grads.values():
        dist.all_reduce(g)
        if world > 1:
            g.div_(world)


def _apply_update(acc, lay, optimizer, policy, max_grad_norm, grads: dict, opt_state,
                  params: dict, ls):
    """The optimizer epilogue on the mean gradients, shared by
    ``unified_step`` and ``unified_pipeline_step``: unscale and check
    (fp16), the global norm and clip, the update (one fused kernel launch
    for a ``fused_adamw`` optimizer), the hold on a non-finite step. Under a
    layout the check and the norm run over the mesh and the update on each
    rank's shards (``parallel/runtime.py``). Returns the new loss scale, the
    norm and whether the gradients were finite."""
    reduce_finite = None if lay is None else (lambda f: lay.all_finite(f, acc.device))
    grads, finite, new_ls = unscale_and_check(grads, ls, policy, reduce_finite=reduce_finite)
    gnorm = global_norm(grads) if lay is None else lay.global_norm(grads)
    scale_c = None if max_grad_norm is None else _clip_scale(gnorm, max_grad_norm)
    finish = None
    if lay is not None:
        grads, params, opt_state, finish = lay.work_set(grads, params, opt_state)
    # fused epilogue (ops/fused.py): for a fused_adamw optimizer the clip
    # multiply -> moment update -> apply -> non-finite hold tail runs as one
    # kernel launch, bitwise the plain chain below in fp32
    if maybe_fused_epilogue(optimizer.optimizer, grads, opt_state, params,
                            clip_scale=scale_c, finite=finite) is None:
        if scale_c is not None:
            for g in grads.values():
                g.mul_(scale_c)
        if finite:  # fp16 overflow: keep params and optimizer state
            optimizer.apply_gradients(grads, params, opt_state)
    if finish is not None:
        finish()
    return new_ls, gnorm, finite


def _is_dataloader(obj: Any) -> bool:
    return isinstance(obj, DataLoaderShard) or (
        hasattr(obj, "dataset") and hasattr(obj, "batch_size")
    )


def _is_schedule(obj: Any) -> bool:
    """Only plain functions and partials are taken as LR schedules."""
    return inspect.isfunction(obj) or isinstance(obj, functools.partial)


class Accelerator:
    """One instance per training script and process, on one device: CUDA
    unless ``cpu=True``. ``seed`` seeds the accelerator's own generator
    (``keys``), which checkpoints carry.

    ``telemetry``: True or a :class:`TelemetryConfig` turns on the step
    records. ``diagnostics`` (True, a dump-dir path or a
    ``DiagnosticsConfig``) adds goodput accounting, anomaly detection,
    triggered ``torch.profiler`` captures and the flight recorder on top,
    and turns telemetry on. ``profile_kwargs``: a ``ProfileKwargs`` for
    :meth:`profile`, whose tracer options the triggered captures take too."""

    def __init__(
        self,
        mixed_precision: Optional[str] = None,
        gradient_accumulation_steps: int = 1,
        cpu: bool = False,
        parallelism_plugin: Any = None,
        dataloader_config: Optional[DataLoaderConfiguration] = None,
        project_config: Optional[ProjectConfiguration] = None,
        project_dir: Optional[str] = None,
        gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None,
        step_scheduler_with_optimizer: bool = True,
        split_batches: bool = False,
        seed: int = 0,
        telemetry: Optional[Union[bool, TelemetryConfig]] = None,
        diagnostics: Any = None,
        profile_kwargs: Optional[ProfileKwargs] = None,
        log_with: Optional[Union[str, list]] = None,
    ):
        self.project_configuration = project_config or ProjectConfiguration(
            project_dir=project_dir)
        if gradient_accumulation_plugin is None:
            # the plugin's __post_init__ reads the environment's fallback
            gradient_accumulation_plugin = GradientAccumulationPlugin(
                num_steps=gradient_accumulation_steps)
        if dataloader_config is None:
            dataloader_config = DataLoaderConfiguration(split_batches=split_batches)
        self.state = AcceleratorState(mixed_precision=mixed_precision, cpu=cpu,
                                      dataloader_config=dataloader_config,
                                      parallelism_plugin=parallelism_plugin)
        self._layout = None  # the prepared params' ShardedLayout under a plugin
        self.gradient_state = GradientState(gradient_accumulation_plugin)
        self.step_scheduler_with_optimizer = step_scheduler_with_optimizer
        self.keys = KeyChain(seed)
        self._optimizers: list[AcceleratedOptimizer] = []
        self._schedulers: list[AcceleratedScheduler] = []
        self._dataloaders: list[DataLoaderShard] = []
        self._custom_objects: list[Any] = []
        self.step = 0  # train-step calls, micro steps included (host mirror)
        self.flag_tensor: Optional[torch.Tensor] = None
        self.profile_handler = profile_kwargs
        # True or a TelemetryConfig turns on the step records; None or False
        # leaves a disabled collector whose hooks are no-ops (no synchronise).
        # diagnostics implies telemetry on.
        if diagnostics is not None and diagnostics is not False:
            if telemetry is None or telemetry is False or telemetry is True:
                telemetry = TelemetryConfig(diagnostics=diagnostics)
            elif telemetry.diagnostics is None:
                telemetry = dataclasses.replace(telemetry, diagnostics=diagnostics)
        self.telemetry = StepTelemetry(telemetry)
        if self.telemetry.diagnostics is not None:
            # triggered captures take the same tracer options as profile()
            self.telemetry.diagnostics.set_profile_kwargs(self.profile_handler)
        self._built_steps = 0  # names each built step's rebuild detector
        self._async_ckpt: Optional[AsyncCheckpointer] = None  # save_state(block=False)'s writer
        self._local_sgd = False  # inside a LocalSGD block: each process steps alone
        self.trackers: list[Any] = []
        self.log_with = [log_with] if isinstance(log_with, str) else list(log_with or [])

    # ------------------------------------------------------------------ #
    # topology (one process on one device) and the process helpers
    # ------------------------------------------------------------------ #
    @property
    def device(self) -> torch.device:
        return self.state.device

    @property
    def distributed_type(self) -> DistributedType:
        return self.state.distributed_type

    @property
    def num_processes(self) -> int:
        return self.state.num_processes

    @property
    def process_index(self) -> int:
        return self.state.process_index

    @property
    def local_process_index(self) -> int:
        return self.state.local_process_index

    @property
    def is_main_process(self) -> bool:
        return self.state.is_main_process

    @property
    def is_local_main_process(self) -> bool:
        return self.state.is_local_main_process

    @property
    def is_last_process(self) -> bool:
        return self.state.is_last_process

    @property
    def mesh(self):
        """The ``DeviceMesh`` under a ``ParallelismPlugin``, else None."""
        return self.state.mesh

    @property
    def mixed_precision(self) -> str:
        return self.state.mixed_precision.value

    @property
    def use_distributed(self) -> bool:
        return self.state.use_distributed

    @property
    def project_dir(self) -> Optional[str]:
        return self.project_configuration.project_dir

    def on_main_process(self, func):
        return self.state.partial_state.on_main_process(func)

    def on_local_main_process(self, func):
        return self.state.partial_state.on_local_main_process(func)

    def on_process(self, func, process_index: int = 0):
        return self.state.partial_state.on_process(func, process_index)

    @contextmanager
    def main_process_first(self):
        with self.state.partial_state.main_process_first():
            yield

    @contextmanager
    def local_main_process_first(self):
        with self.state.partial_state.local_main_process_first():
            yield

    def split_between_processes(self, inputs, apply_padding: bool = False):
        return self.state.partial_state.split_between_processes(inputs, apply_padding)

    def wait_for_everyone(self) -> None:
        self.state.partial_state.wait_for_everyone()

    @property
    def _reduces_across_processes(self) -> bool:
        """Whether the step averages gradients (and weighs the loss) across
        processes: with a process group up, outside a ``LocalSGD`` block."""
        return self.state.partial_state.group_up and not self._local_sgd

    @property
    def sync_gradients(self) -> bool:
        return self.gradient_state.sync_gradients

    @property
    def gradient_accumulation_steps(self) -> int:
        return self.gradient_state.num_steps

    @gradient_accumulation_steps.setter
    def gradient_accumulation_steps(self, value: int) -> None:
        self.gradient_state.num_steps = value

    def print(self, *args, **kwargs) -> None:
        """``print`` on the main process."""
        self.state.partial_state.print(*args, **kwargs)

    # ------------------------------------------------------------------ #
    # prepare
    # ------------------------------------------------------------------ #
    def prepare(self, *args, logical_specs: Any = None):
        """Place each object by type and return them in input order: a
        model moves to the device (fp32 masters; converted to fp8
        projections under ``mixed_precision="fp8"``), a params tree (a
        nested dict of tensors, an adapter tree for one) moves to the device
        leaf by leaf, an optimizer (``adamw``, ``sgd``) is wrapped and its
        state made for the prepared model or params, a loader yields device
        batches (stacked ``[K, micro, ...]`` under fused accumulation), a
        plain function becomes an LR scheduler. Under a
        ``ParallelismPlugin`` the model's parameters (or the tree's leaves)
        become DTensors on the mesh, placed by ``parallel.sharding``'s
        rules (``logical_specs``: a tree's logical axes, or the port model
        whose parameters it holds), and the moments follow
        ``moment_shardings``."""
        result = []
        params = None
        for obj in args:
            if isinstance(obj, nn.Module):
                model = self.prepare_model(obj)
                prepared, params = model, dict(model.named_parameters())
            elif _is_param_tree(obj):
                prepared = self.prepare_params(obj, logical_specs=logical_specs)
                params = _flat_params(prepared)
            elif isinstance(obj, (AcceleratedOptimizer, Optimizer)):
                prepared = self.prepare_optimizer(obj)
            elif _is_dataloader(obj):
                prepared = self.prepare_data_loader(obj)
            else:
                prepared = obj
            result.append(prepared)
        for i, obj in enumerate(result):
            if isinstance(obj, AcceleratedOptimizer) and obj.opt_state is None and params is not None:
                self._init_optimizer(obj, params)
            if _is_schedule(obj):
                result[i] = self.prepare_scheduler(obj)
        return result[0] if len(result) == 1 else tuple(result)

    def prepare_params(self, params: dict, logical_specs: Any = None) -> dict:
        """A params tree on the device, leaf by leaf (a leaf already there is
        returned as it is); under a plugin each leaf a DTensor on the mesh
        (``prepare``)."""
        tree = self._to_device(params)
        if self.state.parallelism_plugin is None:
            return tree
        if isinstance(logical_specs, nn.Module):
            logical_specs = get_logical_specs(logical_specs)
        flat = _flat_params(tree)
        layout = self._build_layout(flat, logical_specs)
        return _like_tree(tree, layout.place(flat, layout.param_specs))

    def _to_device(self, params: dict) -> dict:
        return {k: self._to_device(v) if isinstance(v, dict) else v.to(self.device)
                for k, v in params.items()}

    def _build_layout(self, flat: dict, logical_specs=None, lazy_prefix=None,
                      tp_partial=frozenset()):
        """The ShardedLayout of a prepared parameter set; the step and the
        carry read the last one made."""
        self._layout = build_layout(self.mesh, self.state.parallelism_plugin,
                                    {k: v.detach() for k, v in flat.items()}, logical_specs,
                                    lazy_prefix=lazy_prefix, tp_partial=tp_partial)
        return self._layout

    def _shard_module(self, model: nn.Module) -> nn.Module:
        """The module's parameters replaced, in place, by DTensors on the
        mesh under the rules; a port transformer declares its logical axes
        and gathers each layer's weights as the layer runs."""
        full = dict(model.named_parameters())
        logical = get_logical_specs(model)
        transformer = logical is not None and isinstance(getattr(model, "layers", None),
                                                         nn.ModuleList)
        tp_partial = frozenset()
        if transformer:
            suffixes = tp_partial_leaves(model.config)
            tp_partial = frozenset(n for n in full if n.startswith("layers.")
                                   and n.split(".", 2)[2] in suffixes)
        layout = self._build_layout(full, logical, "layers." if transformer else None,
                                    tp_partial)
        placed = layout.place(full, layout.param_specs)
        for name, dt in placed.items():
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner) if owner else model
            module.register_parameter(
                leaf, nn.Parameter(dt, requires_grad=full[name].requires_grad))
        return model

    def _init_optimizer(self, optimizer: AcceleratedOptimizer, params: dict) -> None:
        """The optimizer's state for ``params``; under a plugin its moments
        placed by ``moment_shardings`` (ZeRO-1/2 split them over fsdp)."""
        optimizer.init(params)
        if self._layout is not None:
            optimizer.opt_state = self._layout.place_opt_state(optimizer.opt_state)

    def prepare_optimizer(self, optimizer, params: Any = None) -> AcceleratedOptimizer:
        """Wrap ``optimizer`` (unless it is wrapped already), make its state
        for ``params`` when given (a module, a name -> tensor dict or a
        nested one) and register it."""
        if not isinstance(optimizer, AcceleratedOptimizer):
            optimizer = AcceleratedOptimizer(optimizer)
        if params is not None:
            if isinstance(params, nn.Module):
                params = dict(params.named_parameters())
            self._init_optimizer(optimizer, _flat_params(params))
        self._optimizers.append(optimizer)
        return optimizer

    def prepare_scheduler(self, scheduler) -> AcceleratedScheduler:
        """An LR schedule (a function of the step count) as a scheduler that
        steps with the registered optimizers."""
        sched = AcceleratedScheduler(
            scheduler, optimizers=self._optimizers,
            step_with_optimizer=self.step_scheduler_with_optimizer,
            split_batches=self.state.dataloader_config.split_batches)
        self._schedulers.append(sched)
        return sched

    def prepare_model(self, model: nn.Module) -> nn.Module:
        """The model on the device; under ``mixed_precision="fp8"`` its
        projections are first converted to fp8 products
        (``models/transformer.convert_model``, the reference's :325-330);
        under a plugin its parameters are DTensors on the mesh."""
        if self.state.mixed_precision_policy.fp8:
            model = convert_model(model)
        model = model.to(device=self.device)
        if self.state.parallelism_plugin is not None:
            model = self._shard_module(model)
        return model

    def prepare_data_loader(self, dataloader: Any, dispatch_batches: Optional[bool] = None,
                            superbatch: Optional[int] = None) -> DataLoaderShard:
        """A loader of this process's rows of each batch on the device, which
        reports its host time to telemetry, under the accelerator's
        ``dataloader_config`` (``dispatch_batches`` overrides its field).
        Under fused accumulation (K > 1) it stacks K microbatches into each
        batch unless ``superbatch`` says otherwise."""
        if not isinstance(dataloader, DataLoaderShard):
            config = self.state.dataloader_config
            if dispatch_batches is not None:
                config = dataclasses.replace(config, dispatch_batches=dispatch_batches)
            if superbatch is None:
                gs = self.gradient_state
                superbatch = gs.num_steps if (gs.fused and gs.num_steps > 1) else 1
            dataloader = prepare_data_loader(dataloader, self.state, config,
                                             superbatch=superbatch)
        dataloader.telemetry = self.telemetry
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
        has_aux: bool = False,
        donate: bool = True,
        fused_accumulation: Optional[bool] = None,
        remat_policy: Any = None,
    ) -> Callable:
        """Build the train step: forward, backward, accumulation, clipping
        and update. ``loss_fn(params, batch, **kw) -> loss`` (or ``(loss,
        aux)`` with ``has_aux``) takes a name -> tensor dict of params cast to
        the compute dtype; the fp32 masters receive fp32 gradients.

        Two accumulation modes (``GradientState.num_steps = K``):

        * unfused (default): one call per microbatch; gradients add into a
          carried fp32 buffer and every K-th call is the optimizer step;
        * fused (``fused_accumulation=True``, or the plugin's ``fused``): one
          call per optimizer step over a stacked ``[K, micro, ...]`` batch
          (``prepare`` makes the loader stack them), the params cast to the
          compute dtype once for the K microbatches, their gradients added
          into zeros in order, no buffer and no ``micro_step`` carried
          between calls.

        Both end in the same epilogue (mean, unscale and check under fp16,
        clip, update, hold on a non-finite step), so the two modes compute
        the same bits. ``remat_policy`` runs each microbatch's loss under
        ``torch.utils.checkpoint``: ``True`` recomputes all of it, a name of
        ``models.transformer.REMAT_POLICIES`` keeps what that policy keeps.
        ``donate`` is accepted for the reference's signature: the carry is
        always updated in place here.

        Returns ``step_fn(carry, batch, **kw) -> (carry, metrics)`` with
        ``carry = accelerator.init_carry(model_or_params, optimizer)``.
        Metrics: ``loss``, ``grad_norm`` (NaN on a step that only
        accumulates), ``grads_finite``, ``is_sync_step``, ``aux`` with
        ``has_aux``; fused adds ``loss_per_microbatch`` (each microbatch's
        unscaled fp32 loss; ``loss`` is their mean) and stacks ``aux``."""
        optimizer = optimizer or (self._optimizers[0] if self._optimizers else None)
        if optimizer is None:
            raise ValueError("prepare() an optimizer before building the step")
        policy = self.state.mixed_precision_policy
        num_accum = self.gradient_state.num_steps
        fused = self.gradient_state.fused if fused_accumulation is None else fused_accumulation
        fused = bool(fused) and num_accum > 1  # K = 1 carries no buffer anyway
        micro_loss = _micro_loss_fn(loss_fn, has_aux, remat_policy)
        world = self.num_processes
        # under a plugin: the prepared params' layout, whose collectives run
        # on the mesh's sub-groups over plain local tensors
        lay = self._layout if self.state.parallelism_plugin is not None else None
        if lay is not None:
            world = lay.data_size  # the loss and gradient means run over dp x fsdp
        data_group = None if lay is None else lay.data_group

        def _sync_apply(accum, opt_state, params, ls, scattered=False):
            """Once per optimizer step, shared by both modes: the mean
            across processes, the mean over the microbatches, unscale/check
            (fp16), clip, update, hold on a non-finite step. Works in place
            on ``accum``. Under a plugin the mean runs over the data-parallel
            ranks, the check and the norm over the mesh, and the update on
            each rank's shards (``parallel/runtime.py``)."""
            if lay is not None:
                accum = lay.reduce_grads_(accum, scattered=scattered)
            elif self._reduces_across_processes:
                _mean_across_processes_(accum, world)
            mean_grads = accum
            if num_accum > 1:
                mean_grads = {k: a.div_(num_accum) for k, a in accum.items()}
            return _apply_update(self, lay, optimizer, policy, max_grad_norm, mean_grads,
                                 opt_state, params, ls)

        def _compute_leaves(params):
            """The params cast to the compute dtype as autograd leaves: the
            gradients taken with respect to them and then cast to fp32 are
            the cast's backward, so the same bits as through the cast to the
            masters."""
            return {k: _cast_floating(p.detach(), policy.compute_dtype).requires_grad_(True)
                    for k, p in params.items()}

        def _microbatch(compute, batch, ls, kw, tree):
            """One microbatch's fp32 gradients (by name), unscaled fp32 loss
            and aux; the loss sees ``compute`` in ``tree``'s nesting. With a
            group, the loss is weighted into the global batch's (the module
            docstring) and the one reported is the global batch's."""
            context = contextlib.nullcontext() if lay is None else lay.forward_context()
            with context:  # the backward (and a remat recompute) gathers inside it too
                # inside the context: under sp the weight counts this rank's
                # share of the sequence
                factor = (_loss_factor(loss_fn, batch, world, self.device, data_group)
                          if self._reduces_across_processes else None)
                seen = compute if lay is None else lay.loss_params(compute)
                scaled, loss, aux = micro_loss(_like_tree(tree, seen),
                                               _cast_floating(batch, policy.compute_dtype), ls,
                                               kw)
                del seen
                if factor is not None:
                    scaled = scaled * factor
                grads = torch.autograd.grad(scaled, list(compute.values()))
            del scaled
            grads = {k: g.float() for k, g in zip(compute, grads)}
            loss = loss.detach().float()
            if factor is not None:
                loss = _global_loss(loss, factor, world, data_group)
            return grads, loss, _detach(aux)

        def _step(carry: dict, batch: Any, **kw):
            tree = carry["params"]
            params = _flat_params(tree)
            ls = carry.get("loss_scale")
            batch = send_to_device(batch, self.device)
            local = params if lay is None else lay.local(params)
            grads, loss, aux = _microbatch(_compute_leaves(local), batch, ls, kw, tree)
            if num_accum > 1:
                accum = carry["accum_grads"] if lay is None else lay.local(carry["accum_grads"])
                for k, g in grads.items():
                    if lay is not None and lay.zero2:  # ZeRO-2: into the sharded buffer
                        g = lay.zero2_scatter(k, g)
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
                    ls, gnorm, finite = _sync_apply(accum, carry["opt_state"], params, ls,
                                                    scattered=num_accum > 1)
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
            metrics = {"loss": loss, "grad_norm": gnorm, "grads_finite": finite,
                       "is_sync_step": is_sync}
            if has_aux and aux is not None:
                metrics["aux"] = aux
            return new_carry, metrics

        def _fused_step(carry: dict, batch: Any, **kw):
            if "accum_grads" in carry or "micro_step" in carry:
                raise ValueError(
                    "fused accumulation carries no accum_grads/micro_step — build the carry "
                    "with init_carry on an accelerator whose GradientAccumulationPlugin has "
                    "fused=True (or pass fused_accumulation=True to init_carry)")
            tree = carry["params"]
            params = _flat_params(tree)
            ls = carry.get("loss_scale")
            batch = send_to_device(batch, self.device)
            local = params if lay is None else lay.local(params)
            compute = _compute_leaves(local)  # cast once for the K microbatches
            accum = {k: torch.zeros_like(p, dtype=torch.float32) for k, p in local.items()}
            losses, auxes = [], []
            for i in range(find_batch_size(batch)):  # the stacked K axis, in order
                micro = operations.recursively_apply(lambda x: x[i], batch)
                grads, loss, aux = _microbatch(compute, micro, ls, kw, tree)
                for k, g in grads.items():
                    accum[k].add_(g)
                del grads
                losses.append(loss)
                auxes.append(aux)
            del compute
            with record_function("unified_step.sync_apply"):
                ls, gnorm, finite = _sync_apply(accum, carry["opt_state"], params, ls)
            del accum
            losses = torch.stack(losses)
            new_carry = {"params": tree, "opt_state": carry["opt_state"],
                         "opt_step": carry["opt_step"] + 1}
            if ls is not None:
                new_carry["loss_scale"] = ls
            metrics = {"loss": losses.mean(), "loss_per_microbatch": losses, "grad_norm": gnorm,
                       "grads_finite": finite, "is_sync_step": True}
            if has_aux and auxes[0] is not None:
                metrics["aux"] = _stack_group(auxes)
            return new_carry, metrics

        label = f"unified_step#{self._built_steps}"
        self._built_steps += 1
        # the step runs the port's fused kernels when the model opted into
        # the fused prologue (its loss closure says so) or the optimizer
        # carries the fused epilogue
        fused_kernels = bool(getattr(loss_fn, "fused_kernels", False)) or bool(
            getattr(optimizer.optimizer, "fused", False))
        if fused:  # every call is an optimizer step over K microbatches
            return self._wrap_step(_fused_step, label, microbatches=num_accum, dispatches=1,
                                   fused_kernels=fused_kernels)
        return self._wrap_step(_step, label, microbatches=1, dispatches=num_accum,
                               fused_kernels=fused_kernels)

    def unified_pipeline_step(
        self,
        block_fn: Callable[[dict, torch.Tensor], torch.Tensor],
        loss_fn: Callable[[torch.Tensor, Any], torch.Tensor],
        optimizer: Optional[AcceleratedOptimizer] = None,
        max_grad_norm: Optional[float] = None,
        donate: bool = True,
    ) -> Callable:
        """The train step of a pipelined model (reference :750-899): the
        1F1B schedule (``parallel.pipeline.pipeline_train_step``), then the
        epilogue of :meth:`unified_step`: unscale and check under fp16,
        clip to ``max_grad_norm`` by the global norm (every stage's layers
        counted once), the update (one fused kernel launch for a
        ``fused_adamw`` optimizer) and the hold on a non-finite step.

        ``block_fn(stage_params, x_micro) -> y_micro`` is a stage's layer
        stack; ``loss_fn(y_micro, target_micro) -> scalar`` must decompose
        over microbatches. Under fp16 each microbatch's loss is scaled, so
        the cotangents the last stage seeds and the stages pass back run
        scaled. ``ParallelismPlugin.num_micro_batches`` microbatches make
        the step, so build the Accelerator with
        ``gradient_accumulation_steps=1``. ``donate`` is accepted for the
        reference's signature.

        Returns ``step_fn(carry, x, targets) -> (carry, metrics)`` with
        ``carry = accelerator.init_carry(stacked_params, optimizer)``, the
        params placed by ``stacked_layer_shardings``; stage 0 reads ``x``
        and the last stage ``targets`` (the others may pass None). Metrics
        as ``unified_step``'s: ``loss``, ``grad_norm``, ``grads_finite``,
        ``is_sync_step``."""
        from .parallel import pipeline

        optimizer = optimizer or (self._optimizers[0] if self._optimizers else None)
        if optimizer is None:
            raise ValueError("prepare() an optimizer before building the step")
        if self.gradient_state.num_steps > 1:
            raise ValueError("unified_pipeline_step microbatches via num_micro_batches; use "
                             "gradient_accumulation_steps=1")
        plugin = self.state.parallelism_plugin
        if plugin is None:
            raise ValueError("unified_pipeline_step needs a ParallelismPlugin (the pp axis)")
        policy = self.state.mixed_precision_policy
        num_micro = plugin.num_micro_batches
        mesh = self.mesh

        def _step(carry: dict, x: Any, targets: Any):
            params = carry["params"]
            lay = self._layout
            ls = carry.get("loss_scale")
            if lay is None and self.mesh is not None and self.state.num_processes > 1:
                raise ValueError("place the stacked params on the mesh first "
                                 "(parallel.pipeline.stacked_layer_shardings + "
                                 "parallel.sharding.shard_params), then init_carry")
            local = params if lay is None else lay.local(params)  # this stage's layers
            compute = {k: _cast_floating(p.detach(), policy.compute_dtype)
                       for k, p in local.items()}
            cx = None if x is None else send_to_device(_cast_floating(x, policy.compute_dtype),
                                                       self.device)
            ct = None if targets is None else send_to_device(
                _cast_floating(targets, policy.compute_dtype), self.device)

            def scaled_loss_fn(y, t):
                # fp16: scaling each microbatch's loss scales the cotangent
                # the last stage seeds, so the whole backward runs scaled
                return scale_loss(loss_fn(y, t).float(), ls)

            loss, grads = pipeline.pipeline_train_step(block_fn, scaled_loss_fn, compute, cx, ct,
                                                       mesh=mesh, num_micro_batches=num_micro)
            grads = {k: g.float() for k, g in grads.items()}
            with record_function("unified_pipeline_step.sync_apply"):
                new_ls, gnorm, finite = _apply_update(self, lay, optimizer, policy,
                                                      max_grad_norm, grads,
                                                      carry["opt_state"], params, ls)
            new_carry = dict(carry)
            new_carry["opt_step"] = carry["opt_step"] + 1
            loss = loss.float()
            if ls is not None:
                new_carry["loss_scale"] = new_ls
                loss = loss / ls.scale  # the schedule averaged scaled losses
            metrics = {"loss": loss, "grad_norm": gnorm,
                       "grads_finite": finite if ls is not None else bool(torch.isfinite(gnorm)),
                       "is_sync_step": True}
            return new_carry, metrics

        label = f"unified_pipeline_step#{self._built_steps}"
        self._built_steps += 1
        # every call is an optimizer step over num_micro microbatches
        return self._wrap_step(_step, label, microbatches=num_micro, dispatches=1,
                               fused_kernels=bool(getattr(optimizer.optimizer, "fused", False)))

    def _wrap_step(self, step_impl: Callable, label: str, *, microbatches: int,
                   dispatches: int, fused_kernels: bool) -> Callable:
        """The step function's host bookkeeping (reference ``_wrap_step``
        :901-1020 without the XLA-only AOT and compile monitor): ``step``
        and ``sync_gradients``, and with telemetry on the step record, which
        carries how many microbatches it covers and how many calls an
        optimizer step takes (fused: K and 1; unfused: 1 and K)."""

        def step_fn(*args, **kw):
            tel = self.telemetry
            observing = tel.enabled
            if observing:
                tel.begin_step()
                retraced = tel.detector(label).check(*args, kw)
            out = step_impl(*args, **kw)
            self.step += 1
            self.gradient_state.sync_gradients = bool(out[1]["is_sync_step"])
            if observing:
                tel.end_step(out, batch=args[1] if len(args) > 1 else None, step=self.step,
                             metrics=out[1], retraced=retraced, label=label,
                             extra={"microbatches": microbatches,
                                    "dispatches_per_opt_step": dispatches,
                                    "fused_kernels": fused_kernels})
            return out

        step_fn.label = label
        return step_fn

    def init_carry(self, params: Any, optimizer: Optional[AcceleratedOptimizer] = None,
                   fused_accumulation: Optional[bool] = None) -> dict:
        """The train-step carry: params (the model's own parameter tensors,
        updated in place; DTensors under a plugin), optimizer state,
        counters, the fp32 accumulation buffer when K > 1 and unfused (under
        ZeRO-2 split over fsdp), and the loss scale under fp16.
        ``fused_accumulation`` must match the step's mode (None: the
        plugin's); the fused carry has no ``micro_step`` and no buffer."""
        optimizer = optimizer or (self._optimizers[0] if self._optimizers else None)
        if optimizer is None:
            raise ValueError("prepare() an optimizer before init_carry")
        if isinstance(params, nn.Module):
            params = dict(params.named_parameters())
        flat = _flat_params(params)
        for p in flat.values():
            if not p.requires_grad:
                p.requires_grad_(True)
        if (self._layout is None and self.state.parallelism_plugin is not None
                and any(is_dtensor(p) for p in flat.values())):
            # params placed by hand (the stacked layers of a pipeline,
            # ``parallel.pipeline.stacked_layer_shardings``): the step's
            # layout is theirs
            self._layout = layout_of_placements(flat, self.state.parallelism_plugin)
        if optimizer.opt_state is None:
            self._init_optimizer(optimizer, flat)
        policy = self.state.mixed_precision_policy
        num_accum = self.gradient_state.num_steps
        fused = self.gradient_state.fused if fused_accumulation is None else fused_accumulation
        fused = bool(fused) and num_accum > 1
        carry = {"params": params, "opt_state": optimizer.opt_state, "opt_step": 0}
        if not fused:
            carry["micro_step"] = 0
            if num_accum > 1:
                if self._layout is not None:  # the params' specs, or ZeRO-2's fsdp chunks
                    carry["accum_grads"] = self._layout.zeros_buffer(flat)
                else:
                    carry["accum_grads"] = {
                        k: torch.zeros_like(p, dtype=torch.float32) for k, p in flat.items()}
        if policy.uses_loss_scaling:
            carry["loss_scale"] = init_loss_scale(policy, self.device)
        return carry

    def sync_from_carry(self, carry: dict) -> None:
        """Set ``step`` and ``sync_gradients`` from the carry's counters
        (a fused carry: every call is an optimizer step)."""
        opt = int(carry["opt_step"])
        if "micro_step" in carry:
            micro = int(carry["micro_step"])
            self.step = opt * self.gradient_state.num_steps + micro
            self.gradient_state.sync_gradients = micro == 0
        else:
            self.step = opt
            self.gradient_state.sync_gradients = True

    # ------------------------------------------------------------------ #
    # the raw loop (reference :1240-1310)
    # ------------------------------------------------------------------ #
    @contextmanager
    def accumulate(self, *models):
        """Set ``sync_gradients`` for the next microbatch of a raw loop: an
        optimizer boundary every ``num_steps`` calls, at the end of the
        loader (``sync_with_dataloader``) or on every batch
        (``sync_each_batch``); ``step`` counts the calls."""
        gs = self.gradient_state
        gs.sync_gradients = ((self.step + 1) % gs.num_steps == 0
                             or (gs.sync_with_dataloader and gs.end_of_dataloader)
                             or gs.sync_each_batch)
        try:
            yield
        finally:
            self.step += 1

    @contextmanager
    def no_sync(self, model=None):
        """``sync_gradients`` False inside. It holds no communication back:
        ``unified_step`` averages across processes once per optimizer step
        anyway, and ``backward``'s gradients are the global batch's on every
        call (the reference's no_sync keeps the flag only, too)."""
        old = self.gradient_state.sync_gradients
        self.gradient_state.sync_gradients = False
        try:
            yield
        finally:
            self.gradient_state.sync_gradients = old

    def backward(self, loss_or_fn, *args, **kwargs):
        """The raw loop's backward, with the reference's contract:
        ``loss, grads = accelerator.backward(loss_fn, params, batch)``. The
        loss runs on ``params`` (a name -> tensor dict, or a module's)
        cast to the compute dtype; ``grads`` are fp32, by name, scaled by
        1 / ``num_steps`` for accumulation. With a process group the loss
        and the gradients are the global batch's (the module docstring): the
        gradients are averaged across processes on every call, inside
        ``no_sync`` too, since the caller adds them up before the update."""
        if not callable(loss_or_fn):
            raise TypeError(
                "accelerator.backward needs the loss *function*: backward(loss_fn, params, "
                "batch). To keep your raw loop, compute grads once per microbatch and feed "
                "optimizer.step; or use accelerator.unified_step(loss_fn) for the step.")
        params, rest = args[0], args[1:]
        if isinstance(params, nn.Module):
            params = dict(params.named_parameters())
        if any(is_dtensor(p) for p in params.values()):
            raise NotImplementedError(
                "the raw loop's backward on sharded (DTensor) params is not ported: under a "
                "ParallelismPlugin train with unified_step (ROADMAP.md, queue A7)")
        dtype = self.state.mixed_precision_policy.compute_dtype
        compute = {k: _cast_floating(p.detach(), dtype).requires_grad_(True)
                   for k, p in params.items()}
        group, world = self._reduces_across_processes, self.num_processes
        factor = (_loss_factor(loss_or_fn, rest[0] if rest else None, world, self.device)
                  if group else None)
        loss = loss_or_fn(compute, *rest, **kwargs)
        grads = torch.autograd.grad(loss if factor is None else loss * factor,
                                    list(compute.values()))
        scale = 1.0 / self.gradient_state.num_steps
        grads = {k: g.float() * scale for k, g in zip(params, grads)}
        loss = loss.detach()
        if group:
            _mean_across_processes_(grads, world)
            loss = _global_loss(loss, factor, world)
        return loss, grads

    @contextmanager
    def join_uneven_inputs(self, joinables=None, even_batches: Optional[bool] = None):
        """Train or evaluate on a dataset whose length does not divide the
        global batch (reference :1309). Every process yields the same number
        of batches (the samplers wrap around, or pad a short tail and record
        ``remainder``), so no process runs out of collectives to join, and
        ``joinables`` is accepted and ignored, as in the reference.
        ``even_batches`` overrides the prepared map-style loaders' setting
        inside the block (from their next epoch on)."""
        restore: list[tuple[Any, bool]] = []
        if even_batches is not None:
            iterable_seen = False
            for dl in self._dataloaders:
                shard = getattr(dl, "batch_sampler", None)
                if shard is None or not hasattr(shard, "even_batches"):
                    iterable_seen = True
                    continue
                restore.append((shard, shard.even_batches))
                shard.even_batches = even_batches
            if iterable_seen:
                logger.warning("Overriding even_batches is only supported for map-style "
                               "datasets; some dataloaders were iterable")
        try:
            yield
        finally:
            for shard, prev in restore:
                shard.even_batches = prev

    def clip_grad_norm_(self, grads: dict, max_norm: float) -> tuple[dict, torch.Tensor]:
        """Global-norm clip: returns (clipped grads, the norm before)."""
        gnorm = global_norm(grads)
        scale = _clip_scale(gnorm, max_norm)
        return {k: g * scale for k, g in grads.items()}, gnorm

    def clip_grad_value_(self, grads: dict, clip_value: float) -> dict:
        return {k: g.clamp(-clip_value, clip_value) for k, g in grads.items()}

    def set_trigger(self) -> None:
        """Raise the early-stop flag that ``check_trigger`` reads."""
        self.flag_tensor = torch.tensor(1, dtype=torch.int32, device=self.device)

    def check_trigger(self) -> bool:
        """Whether any process set the flag (here, this one); resets it."""
        if self.flag_tensor is None:
            self.flag_tensor = torch.tensor(0, dtype=torch.int32, device=self.device)
        if int(operations.reduce(self.flag_tensor, "sum")) > 0:
            self.flag_tensor = torch.tensor(0, dtype=torch.int32, device=self.device)
            return True
        return False

    def free_memory(self, *objects):
        """Drop the accelerator's references to what was prepared, reset
        ``step``, collect garbage and hand the CUDA allocator's cached
        blocks back. Returns one None for each object given: rebind them
        (``model, opt = accelerator.free_memory(model, opt)``), since a
        tensor a caller still holds stays allocated."""
        self._optimizers = []
        self._schedulers = []
        self._dataloaders = []
        self.step = 0
        return release_memory(*objects)

    clear = free_memory

    # ------------------------------------------------------------------ #
    # metrics
    # ------------------------------------------------------------------ #
    def gather(self, tensor: Any) -> Any:
        return operations.gather(tensor)

    def gather_for_metrics(self, input_data: Any, use_gather_object: bool = False) -> Any:
        """Every process's eval outputs, concatenated in rank order: the
        global batch's rows in the reference's order (under a mesh, the
        data-parallel ranks', so a tp group's rows come once). On the last batch of
        a loader whose global tail was wrapped or padded, only the first
        ``remainder`` (global) rows are real, and the rest are dropped."""
        group = None if self._layout is None else self._layout.rows_group
        if use_gather_object or not _all_tensor_leaves(input_data):
            data = operations.gather_object(input_data, group=group)
            return [x for sub in data for x in (sub if isinstance(sub, list) else [sub])]
        data = operations.gather(input_data, group=group)
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
        returns the committed directory. ``block=False`` returns once the
        snapshot is taken (``checkpoint_async``): the background writer
        serialises, writes and commits while training goes on, and the
        directory returned is the name it will commit to
        (``wait_for_checkpoint`` blocks until it has). A sync save first
        drains the async ones, so checkpoints commit in save order."""
        if not block:
            return save_accelerator_state_async(self, self._async_checkpointer, output_dir,
                                                carry=carry, **kwargs)
        self.wait_for_checkpoint()
        return checkpointing.save_accelerator_state(self, output_dir, carry=carry, **kwargs)

    @property
    def _async_checkpointer(self) -> AsyncCheckpointer:
        """This accelerator's background writer, made at its first use."""
        if self._async_ckpt is None:
            self._async_ckpt = AsyncCheckpointer(telemetry=self.telemetry)
        return self._async_ckpt

    def wait_for_checkpoint(self) -> None:
        """Drain the ``save_state(block=False)`` saves in flight (none: a
        no-op); a background write's failure re-raises here."""
        if self._async_ckpt is not None:
            self._async_ckpt.wait()

    def load_state(self, input_dir: Optional[str] = None, carry: Any = None, **kwargs) -> Any:
        """Restore a checkpoint into ``carry`` (its tensors in place) and
        return the restored carry, once the saves in flight have committed.
        ``allow_reshape=True`` takes a checkpoint saved at another world
        size (``checkpointing.load_accelerator_state``)."""
        self.wait_for_checkpoint()  # never restore past a save in flight
        return checkpointing.load_accelerator_state(self, input_dir, carry=carry, **kwargs)

    def save_model(self, params: Any, save_directory: str, max_shard_size: str = "10GB",
                   safe_serialization: bool = True) -> None:
        if self._layout is not None:  # gathered whole; the main process writes
            params = self.get_state_dict(params)
            if not self.is_main_process:
                return
        checkpointing.save_model_weights(params, save_directory, max_shard_size=max_shard_size,
                                         safe_serialization=safe_serialization)

    def get_state_dict(self, params: Any, unwrap: bool = True) -> dict[str, torch.Tensor]:
        """Every tensor of a module or parameter tree, by name, on the host;
        a sharded (DTensor) leaf gathered whole first (reference :1520),
        which every process must call."""
        tree = checkpointing._tree_of(params)
        named = checkpointing.flatten_tree(tree)
        if any(is_dtensor(v) for v in named.values()):
            named = {k: gather_full(v) if is_dtensor(v) else v for k, v in named.items()}
            return checkpointing._to_named_tensors(named)
        return checkpointing._to_named_tensors(params)

    def unwrap_model(self, model: Any, keep_fp32_wrapper: bool = True) -> Any:
        """No wrapper is put around a prepared model: the model itself."""
        return model

    def skip_first_batches(self, dataloader: DataLoaderShard, num_batches: int = 0):
        return skip_first_batches(dataloader, num_batches)

    def set_seed(self, seed: int) -> torch.Generator:
        self.keys = KeyChain(seed)
        return set_seed(seed)

    # ------------------------------------------------------------------ #
    # profiling, trackers and the end of training
    # ------------------------------------------------------------------ #
    @contextmanager
    def autocast(self):
        """A no-op context, as in the reference: the step casts to the
        compute dtype itself."""
        yield

    @contextmanager
    def profile(self, profile_dir: Optional[str] = None,
                profile_kwargs: Optional[ProfileKwargs] = None):
        """Trace the enclosed steps with ``torch.profiler`` (CPU and CUDA
        activities) into ``profile_dir`` or the handler's
        ``output_trace_dir``; yields a ``ProfileHandle`` (call its ``step()``
        once a step when ``skip_first`` is set). The trace is Chrome JSON,
        written at the block's end. A no-op yielding None when no directory
        is configured, so it can wrap the loop unconditionally. One profiler
        session records at a time: a triggered capture asked for meanwhile
        is refused and logged."""
        from .utils.profiling import profile as _profile

        if profile_kwargs is None and self.profile_handler is not None:
            # the handler's tracer options apply to an explicit dir too (the
            # dir wins over its output_trace_dir); an explicit-dir call is a
            # region trace with no step() calls, so skip_first would mean
            # "never start"
            profile_kwargs = self.profile_handler
            if profile_dir is not None and profile_kwargs.skip_first:
                profile_kwargs = dataclasses.replace(profile_kwargs, skip_first=0)
        with _profile(profile_dir, profile_kwargs) as handle:
            yield handle

    def log(self, values: dict, step: Optional[int] = None, **kwargs) -> None:
        """Log ``values`` to every tracker."""
        for tracker in self.trackers:
            tracker.log(values, step=step, **kwargs)

    def init_trackers(self, project_name: str, config: Optional[dict] = None,
                      init_kwargs: Optional[dict] = None) -> None:
        """Make the trackers ``log_with`` names (those whose package is
        installed), under the project configuration's ``logging_dir``."""
        from .tracking import filter_trackers

        self.trackers = filter_trackers(self.log_with, self.project_configuration.logging_dir,
                                        project_name, config or {}, init_kwargs or {})

    def get_tracker(self, name: str, unwrap: bool = False):
        for tracker in self.trackers:
            if getattr(tracker, "name", None) == name:
                return tracker.tracker if unwrap else tracker
        raise ValueError(f"tracker {name} not initialized")

    def end_training(self) -> None:
        """Drain the background saves in flight, finish every tracker and
        close the telemetry (the heartbeat stops; diagnostics writes its
        final ``"shutdown"`` dump)."""
        self.wait_for_checkpoint()  # a dropped in-flight save loses work
        for tracker in self.trackers:
            tracker.finish()
        self.telemetry.close()
        self.wait_for_everyone()

    def __repr__(self) -> str:
        return f"Accelerator(\n{self.state!r})"


def _all_tensor_leaves(tree: Any) -> bool:
    leaves = []
    operations.recursively_apply(leaves.append, tree, test_type=lambda x: True)
    return bool(leaves) and all(isinstance(x, (torch.Tensor, np.ndarray)) for x in leaves)
