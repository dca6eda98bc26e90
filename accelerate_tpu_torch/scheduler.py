"""LR scheduler wrapper.

Port of ``accelerate_tpu/scheduler.py:23``: a learning-rate schedule is a
plain callable ``step -> lr`` (:class:`~.optimizer.AdamW` evaluates it at
its own step count), so stepping the scheduler is bookkeeping that keeps
the reference's rule: frozen while gradients accumulate. One process, so
no scaling by the process count.
"""

from __future__ import annotations

from typing import Callable

from .state import GradientState


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
