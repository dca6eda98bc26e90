"""LR scheduler wrapper, and the schedule the examples use.

Port of ``accelerate_tpu/scheduler.py:23-71``: a learning-rate schedule is
a plain callable ``step -> lr`` (the optimizer evaluates it at its own step
count), so stepping the scheduler is bookkeeping that keeps the
reference's rules: with ``step_with_optimizer`` it is frozen while
gradients accumulate and does not advance when an optimizer skipped its
step; without, every call advances it by 1. A synced step advances it by
the process count (``AcceleratorState().num_processes``), so a schedule
written for one process keeps its pace under data parallelism, unless
``split_batches`` (each process then takes a share of one batch) keeps it
at 1.

``warmup_cosine_decay_schedule`` is optax's (the reference's examples take
it from optax), written with optax's formula in float32.
"""

from __future__ import annotations

import math
from typing import Any, Callable

import numpy as np

from .state import AcceleratorState, GradientState, group_is_up


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0,
                                 exponent: float = 1.0) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, then a cosine decay to
    ``end_value`` at ``decay_steps`` (counted from step 0), held after.
    Each value is computed in float32 as optax computes it."""
    if decay_steps - warmup_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")
    f32 = np.float32
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:  # optax.linear_schedule
            frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
            return float(f32(init_value - peak_value) * frac + f32(peak_value))
        c = f32(min(count - warmup_steps, span))  # optax.cosine_decay_schedule
        cosine = f32(0.5) * (f32(1) + f32(math.cos(f32(math.pi) * c / f32(span))))
        decayed = f32(1 - alpha) * cosine ** f32(exponent) + f32(alpha)
        return float(f32(peak_value) * decayed)

    return schedule


def _num_processes() -> int:
    """``AcceleratorState().num_processes``, as the reference reads it; before
    any state is made, the process group's size (1 without one): making the
    state here would pick a device for the whole process."""
    if AcceleratorState._shared_state:
        return AcceleratorState().num_processes
    if group_is_up():
        import torch.distributed as dist

        return dist.get_world_size()
    return 1


class AcceleratedScheduler:
    def __init__(self, scheduler: Callable[[int], float], optimizers: Any = None,
                 step_with_optimizer: bool = True, split_batches: bool = False):
        self.scheduler = scheduler
        self.optimizers = (list(optimizers) if isinstance(optimizers, (list, tuple))
                           else [optimizers] if optimizers is not None else [])
        self.step_with_optimizer = step_with_optimizer
        self.split_batches = split_batches
        self.gradient_state = GradientState()
        self._step_count = 0

    @property
    def step_count(self) -> int:
        return self._step_count

    def step(self, *args, **kwargs) -> None:
        if not self.step_with_optimizer:
            self._step_count += 1
            return
        if not self.gradient_state.sync_gradients:
            return  # frozen while accumulating
        if any(getattr(opt, "step_was_skipped", False) for opt in self.optimizers):
            return
        self._step_count += 1 if self.split_batches else _num_processes()

    def get_last_lr(self) -> list[float]:
        return [float(self.scheduler(max(0, self._step_count - 1)))]

    def get_lr(self) -> list[float]:
        return [float(self.scheduler(self._step_count))]

    def state_dict(self) -> dict:
        return {"step_count": self._step_count}

    def load_state_dict(self, state: dict) -> None:
        self._step_count = int(state["step_count"])
