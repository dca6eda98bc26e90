"""Process, accelerator and gradient state of one training process.

Port of ``accelerate_tpu/state.py`` (``PartialState`` :94,
``AcceleratorState`` :282, ``GradientState`` :377) for one process on one
device. The three are shared-state singletons, as in the reference: every
instance reads and writes one dict, reset with ``_reset_state``.
``torch.distributed`` process groups come with a later slice (ROADMAP.md).

The device is CUDA unless the caller asks for the CPU (``cpu=True``); with
no CUDA device the default raises instead of falling back to the CPU.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from .utils.constants import ENV_PREFIX
from .utils.dataclasses import (
    DataLoaderConfiguration,
    DistributedType,
    GradientAccumulationPlugin,
    MixedPrecisionPolicy,
    PrecisionType,
)
from .utils.environment import parse_flag_from_env


def resolve_device(cpu: bool) -> torch.device:
    """``cuda`` (the current CUDA device) unless ``cpu``; raises when CUDA is
    asked for and absent."""
    if cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: accelerate_tpu_torch runs on the GPU unless asked "
            "for the CPU (Accelerator(cpu=True))"
        )
    return torch.device("cuda", torch.cuda.current_device())


class PartialState:
    """Process topology: one process, one device."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, cpu: bool = False):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        self.device = resolve_device(cpu)
        self.num_processes = 1
        self.process_index = 0
        self.distributed_type = DistributedType.NO

    @property
    def initialized(self) -> bool:
        return "distributed_type" in self.__dict__

    @staticmethod
    def _reset_state():
        PartialState._shared_state.clear()

    def __repr__(self) -> str:
        return (
            f"Distributed environment: {self.distributed_type.value}\n"
            f"Num processes: {self.num_processes}\n"
            f"Device: {self.device}\n"
        )


class AcceleratorState:
    """PartialState plus the precision policy and the loader configuration."""

    _shared_state: dict[str, Any] = {}

    def __init__(self, mixed_precision: Optional[str] = None, cpu: bool = False,
                 dataloader_config: Optional[DataLoaderConfiguration] = None):
        self.__dict__ = self._shared_state
        if self.initialized:
            return
        self.partial_state = PartialState(cpu)
        self.dataloader_config = dataloader_config or DataLoaderConfiguration()
        self.mixed_precision = PrecisionType(mixed_precision or "no")
        self.mixed_precision_policy = MixedPrecisionPolicy.from_precision(
            self.mixed_precision
        )

    @property
    def initialized(self) -> bool:
        return "partial_state" in self.__dict__

    @staticmethod
    def _reset_state(reset_partial_state: bool = False):
        AcceleratorState._shared_state.clear()
        if reset_partial_state:
            PartialState._reset_state()

    def __getattr__(self, name: str):
        # process topology is delegated to PartialState
        if name in ("partial_state", "initialized") or name.startswith("__"):
            raise AttributeError(name)
        ps = self.__dict__.get("partial_state")
        if ps is not None and hasattr(ps, name):
            return getattr(ps, name)
        raise AttributeError(f"'AcceleratorState' object has no attribute '{name}'")

    def __repr__(self) -> str:
        return repr(self.partial_state) + f"Mixed precision: {self.mixed_precision.value}\n"


class GradientState:
    """Gradient-accumulation bookkeeping shared by the Accelerator, the
    optimizer, the scheduler and the loaders: the plugin's settings (the
    accumulation length, ``fused``, ``sync_with_dataloader``,
    ``sync_each_batch``, ``adjust_scheduler``), whether the last step was an
    optimizer boundary, and the loader being iterated, whose
    ``end_of_dataloader`` and ``remainder`` ``accumulate`` and
    ``gather_for_metrics`` read (reference ``state.py:377-475``)."""

    _shared_state: dict[str, Any] = {}

    def __init__(
        self, gradient_accumulation_plugin: Optional[GradientAccumulationPlugin] = None
    ):
        self.__dict__ = self._shared_state
        if not self.initialized:
            self.sync_gradients = True
            self.active_dataloader = None
            self.dataloader_references: list[Any] = [None]
            self.plugin_kwargs: dict[str, Any] = {}
            self.num_steps = 1
        if gradient_accumulation_plugin is not None:
            self.plugin_kwargs = gradient_accumulation_plugin.to_kwargs()
            self.num_steps = gradient_accumulation_plugin.num_steps

    @property
    def initialized(self) -> bool:
        return "sync_gradients" in self.__dict__

    @property
    def sync_with_dataloader(self) -> bool:
        return self.plugin_kwargs.get("sync_with_dataloader", True)

    @property
    def adjust_scheduler(self) -> bool:
        return self.plugin_kwargs.get("adjust_scheduler", True)

    @property
    def sync_each_batch(self) -> bool:
        return self.plugin_kwargs.get("sync_each_batch", False)

    @property
    def fused(self) -> bool:
        """Whether accumulation runs fused: one step call per optimizer step
        over a stacked ``[num_steps, micro, ...]`` batch. Falls back to the
        ``ACCELERATE_TPU_FUSED_ACCUM`` flag, since ``plugin_kwargs`` keeps
        only the fields that differ from the defaults."""
        if "fused" in self.plugin_kwargs:
            return self.plugin_kwargs["fused"]
        return parse_flag_from_env(ENV_PREFIX + "FUSED_ACCUM")

    @property
    def end_of_dataloader(self) -> bool:
        return self.active_dataloader is not None and getattr(
            self.active_dataloader, "end_of_dataloader", False)

    @property
    def remainder(self) -> int:
        if self.active_dataloader is None:
            return -1
        return getattr(self.active_dataloader, "remainder", -1)

    @property
    def in_dataloader(self) -> bool:
        return self.active_dataloader is not None

    def _add_dataloader(self, dataloader) -> None:
        self.dataloader_references.append(dataloader)
        self.active_dataloader = dataloader

    def _remove_dataloader(self, dataloader) -> None:
        if dataloader in self.dataloader_references:
            self.dataloader_references.remove(dataloader)
        self.active_dataloader = self.dataloader_references[-1]

    @staticmethod
    def _reset_state():
        GradientState._shared_state.clear()
