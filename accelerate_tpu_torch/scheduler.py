"""LR scheduler wrapper, and the schedule the examples use.

Port of ``accelerate_tpu/scheduler.py:23``: a learning-rate schedule is a
plain callable ``step -> lr`` (:class:`~.optimizer.AdamW` evaluates it at
its own step count), so stepping the scheduler is bookkeeping that keeps
the reference's rule: frozen while gradients accumulate. One process, so
no scaling by the process count.

``warmup_cosine_decay_schedule`` is optax's (the reference's examples take
it from optax), written with optax's formula in float32.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np

from .state import GradientState


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


class AcceleratedScheduler:
    def __init__(self, scheduler: Callable[[int], float]):
        self.scheduler = scheduler
        self.gradient_state = GradientState()
        self.step_count = 0

    def step(self) -> None:
        if self.gradient_state.sync_gradients:  # frozen while accumulating
            self.step_count += 1

    def get_last_lr(self) -> list[float]:
        return [float(self.scheduler(max(0, self.step_count - 1)))]

    def get_lr(self) -> list[float]:
        return [float(self.scheduler(self.step_count))]

    def state_dict(self) -> dict:
        return {"step_count": self.step_count}

    def load_state_dict(self, state: dict) -> None:
        self.step_count = int(state["step_count"])
