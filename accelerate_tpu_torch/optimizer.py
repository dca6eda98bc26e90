"""Optimizer: AdamW as optax spells it, loss scaling, and the wrapper.

Port of ``accelerate_tpu/optimizer.py:29-179`` plus the two optax pieces
the train step needs, written as plain torch functions:

* :func:`adamw` follows ``optax.adamw`` op for op (the order is spelled
  out in ``accelerate_tpu/ops/fused.py:466-498``): moments, bias
  correction with the incremented count, ``m / (sqrt(v + eps_root) + eps)``,
  decoupled weight decay added to the update, then the learning-rate
  scale. ``torch.optim.AdamW`` is a different function: it puts eps
  elsewhere and decays the weights before the update.
* :func:`global_norm` is ``optax.global_norm``.

Parameters and moments are updated in place (the reference returns new
trees): at 8B width a second copy of params and moments would not fit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import torch

Params = dict[str, torch.Tensor]


@dataclass
class LossScaleState:
    """Dynamic loss-scaling state (GradScaler semantics): fp32 scale, good
    steps since the last growth, and the count of applied steps."""

    scale: torch.Tensor
    growth_count: int = 0
    fin_steps: int = 0


def init_loss_scale(policy, device) -> LossScaleState:
    return LossScaleState(
        scale=torch.tensor(policy.loss_scale_init, dtype=torch.float32, device=device)
    )


def scale_loss(loss: torch.Tensor, ls: Optional[LossScaleState]) -> torch.Tensor:
    return loss if ls is None else loss * ls.scale


def unscale_and_check(grads: Params, ls: Optional[LossScaleState], policy=None):
    """Unscale grads; return (grads, grads_finite, new_loss_scale_state).
    On overflow the step is skipped and the scale shrinks by the factor;
    after ``growth_interval`` clean steps it grows by it. ``grads_finite``
    is a host bool (the step branches on it). fp32 grads are unscaled in
    place."""
    if ls is None:
        return grads, True, None
    inv = 1.0 / ls.scale
    grads = {k: g.float().mul_(inv) for k, g in grads.items()}
    finite = bool(torch.stack([torch.isfinite(g).all() for g in grads.values()]).all())
    growth_interval = policy.loss_scale_growth_interval if policy else 2000
    factor = policy.loss_scale_factor if policy else 2.0
    count = ls.growth_count + 1 if finite else 0
    grow = count >= growth_interval
    if not finite:
        scale = ls.scale / factor
    else:
        scale = ls.scale * factor if grow else ls.scale
    new_ls = LossScaleState(
        scale=scale,
        growth_count=0 if grow else count,
        fin_steps=ls.fin_steps + int(finite),
    )
    return grads, finite, new_ls


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(g.float() ** 2) for g in tree.values()))


class AdamW:
    """``optax.adamw`` as torch functions. State: ``{"count": int, "mu":
    {name: fp32}, "nu": {name: fp32}}``. :meth:`apply_` updates params and
    state in place."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4):
        self.learning_rate = learning_rate
        self.b1, self.b2 = b1, b2
        self.eps, self.eps_root = eps, eps_root
        self.weight_decay = weight_decay

    def init(self, params: Params) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        }

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    @torch.no_grad()
    def apply_(self, grads: Params, state: dict, params: Params) -> None:
        """One update of every leaf, in optax's operation order:
        mu' = (1-b1) g + b1 mu; nu' = (1-b2) g^2 + b2 nu;
        u = (mu'/bc1) / (sqrt(nu'/bc2 + eps_root) + eps) + wd p;
        p' = p + (-lr) u, with bc_i = 1 - b_i^(count+1) in fp32."""
        b1, b2, wd = self.b1, self.b2, self.weight_decay
        step_size = -self.lr_at(state["count"])  # schedule sees the old count
        count_inc = state["count"] + 1
        for name, p in params.items():
            g = grads[name]
            one = torch.ones((), dtype=torch.float32, device=p.device)
            bc1 = one - (one * b1) ** count_inc
            bc2 = one - (one * b2) ** count_inc
            mu = state["mu"][name]
            nu = state["nu"][name]
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g ** 2) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2 + self.eps_root) + self.eps)
            u = u + wd * p
            p.add_(step_size * u)
        state["count"] = count_inc


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw`` with its defaults (weight_decay 1e-4)."""
    return AdamW(learning_rate, b1, b2, eps, eps_root, weight_decay)


class AcceleratedOptimizer:
    """Wraps an :class:`AdamW` with its state: ``init`` creates the state
    for a parameter dict, ``apply_gradients`` is the update the train step
    runs."""

    def __init__(self, optimizer: AdamW):
        if not isinstance(optimizer, AdamW):
            raise TypeError(f"AcceleratedOptimizer expects an AdamW, got {type(optimizer)}")
        self.optimizer = optimizer
        self.opt_state: Optional[dict] = None

    def init(self, params: Params) -> dict:
        self.opt_state = self.optimizer.init(params)
        return self.opt_state

    def apply_gradients(self, grads: Params, params: Params, opt_state: dict) -> None:
        self.optimizer.apply_(grads, opt_state, params)

    def state_dict(self) -> Optional[dict]:
        """The optimizer state: ``{"count", "mu", "nu"}``."""
        return self.opt_state

    def load_state_dict(self, state: dict) -> None:
        """Take ``state``'s count and copy its moments into the current
        state's tensors (or adopt them when there is none yet)."""
        if self.opt_state is None:
            self.opt_state = state
            return
        with torch.no_grad():
            for key in ("mu", "nu"):
                for name, t in self.opt_state[key].items():
                    t.copy_(state[key][name])
        self.opt_state["count"] = int(state["count"])
