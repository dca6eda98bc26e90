"""Optimizer: AdamW as optax spells it, loss scaling, and the wrapper.

Port of ``accelerate_tpu/optimizer.py:29-179`` plus the optax pieces the
train step and the reference's benchmark need, written as plain torch
functions:

* :func:`adamw` follows ``optax.adamw`` op for op (the order is spelled
  out in ``accelerate_tpu/ops/fused.py:466-498``): moments, bias
  correction with the incremented count, ``m / (sqrt(v + eps_root) + eps)``,
  decoupled weight decay added to the update, then the learning-rate
  scale. ``torch.optim.AdamW`` is a different function: it puts eps
  elsewhere and decays the weights before the update.
* :func:`sgd` is ``optax.sgd`` without momentum: ``p + (-lr) g``.
* :func:`global_norm` is ``optax.global_norm``.
* :func:`schedule_free_adamw` and :func:`schedule_free_eval_params` are
  ``optax.contrib``'s (the reference's schedule-free example takes them
  from there), op for op.

:class:`AcceleratedOptimizer` also keeps the reference's raw-loop surface
(:153-171): ``step(params, grads)`` applies only on a sync boundary,
``zero_grad`` is a no-op (gradients are values), ``step_was_skipped``.

Parameters and moments are updated in place (the reference returns new
trees): at 8B width a second copy of params and moments would not fit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Union

import numpy as np
import torch

from .state import GradientState

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


def unscale_and_check(grads: Params, ls: Optional[LossScaleState], policy=None,
                      reduce_finite=None):
    """Unscale grads; return (grads, grads_finite, new_loss_scale_state).
    On overflow the step is skipped and the scale shrinks by the factor;
    after ``growth_interval`` clean steps it grows by it. ``grads_finite``
    is a host bool (the step branches on it). fp32 grads are unscaled in
    place. ``reduce_finite`` turns this process's answer into every
    process's (a sharded step holds only its shards)."""
    if ls is None:
        return grads, True, None
    inv = 1.0 / ls.scale
    grads = {k: g.float().mul_(inv) for k, g in grads.items()}
    finite = bool(torch.stack([torch.isfinite(g).all() for g in grads.values()]).all())
    if reduce_finite is not None:
        finite = reduce_finite(finite)
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


_LOW_PRECISION = (torch.bfloat16, torch.float16)


def square_sum(g: torch.Tensor) -> torch.Tensor:
    """One leaf's sum of squares in fp32, each square taken in the leaf's
    dtype (``jnp.sum(g * g)`` for a bf16 or fp16 leaf, before its rounding
    back): the term every global norm, sharded or not, adds per leaf."""
    return torch.sum((g * g).float()) if g.dtype in _LOW_PRECISION else torch.sum(g.float() ** 2)


def norm_of_square_sums(sums, dtypes) -> torch.Tensor:
    """sqrt of the leaves' whole square sums (fp32, in tree order) added as
    ``optax.global_norm`` adds them: a bf16 or fp16 leaf's sum rounded to
    its dtype, and the leaves' sums added in that dtype as the Python sum
    over ``jnp`` scalars promotes it (a ``grad_dtype`` of bf16)."""
    return torch.sqrt(sum(s.to(d) if d in _LOW_PRECISION else s for s, d in zip(sums, dtypes)))


def weak_scalar(x: float, like: torch.Tensor) -> float:
    """A Python scalar as JAX's weak typing takes it beside ``like``: for a
    bf16 or fp16 ``like``, rounded to that dtype (optax multiplies a bf16
    gradient by ``bf16(lr)``, not by the float); ``x`` as it is otherwise.
    The product itself is taken in fp32, as XLA's excess precision on the
    CPU leaves it unrounded inside the update."""
    if like.dtype in _LOW_PRECISION:
        return float(torch.tensor(x, dtype=like.dtype))
    return x


def global_norm(tree: Params) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf (``optax.global_norm``)."""
    return norm_of_square_sums([square_sum(g) for g in tree.values()],
                               [g.dtype for g in tree.values()])


class Optimizer:
    """An optax-shaped transformation as torch functions: ``init(params)``
    makes the state, ``apply_(grads, state, params)`` updates params and
    state in place. ``learning_rate`` is a float or a schedule of the
    state's count."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]]):
        self.learning_rate = learning_rate

    def lr_at(self, count: int) -> float:
        lr = self.learning_rate
        return float(lr(count)) if callable(lr) else float(lr)

    def init(self, params: Params) -> dict:
        raise NotImplementedError

    def apply_(self, grads: Params, state: dict, params: Params) -> None:
        raise NotImplementedError


class AdamW(Optimizer):
    """``optax.adamw`` as torch functions. State: ``{"count": int, "mu":
    {name: fp32}, "nu": {name: fp32}}``. :meth:`apply_` updates params and
    state in place."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 b1=0.9, b2=0.999, eps=1e-8, eps_root=0.0, weight_decay=1e-4):
        super().__init__(learning_rate)
        self.b1, self.b2 = b1, b2
        self.eps, self.eps_root = eps, eps_root
        self.weight_decay = weight_decay

    def init(self, params: Params) -> dict:
        return {
            "count": 0,
            "mu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
            "nu": {k: torch.zeros_like(p, dtype=torch.float32) for k, p in params.items()},
        }

    @torch.no_grad()
    def apply_(self, grads: Params, state: dict, params: Params) -> None:
        """One update of every leaf, in optax's operation order:
        mu' = (1-b1) g + b1 mu; nu' = (1-b2) g^2 + b2 nu;
        u = (mu'/bc1) / (sqrt(nu'/bc2 + eps_root) + eps) + wd p;
        p' = p + (-lr) u, with bc_i = 1 - b_i^(count+1) in fp32 (a bf16
        ``g`` times ``bf16(1-b1)`` and ``bf16(1-b2)``: :func:`weak_scalar`)."""
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
            mu.copy_(weak_scalar(1 - b1, g) * g.float() + b1 * mu)
            nu.copy_(weak_scalar(1 - b2, g) * (g.float() ** 2) + b2 * nu)
            u = (mu / bc1) / (torch.sqrt(nu / bc2 + self.eps_root) + self.eps)
            u = u + wd * p
            p.add_(step_size * u)
        state["count"] = count_inc


class SGD(Optimizer):
    """``optax.sgd`` without momentum. State: ``{"count": int}`` (the
    schedule's step). :meth:`apply_` does p' = p + (-lr) g in place (a bf16
    ``g`` times ``bf16(-lr)``: :func:`weak_scalar`)."""

    def init(self, params: Params) -> dict:
        return {"count": 0}

    @torch.no_grad()
    def apply_(self, grads: Params, state: dict, params: Params) -> None:
        step_size = -self.lr_at(state["count"])
        for name, p in params.items():
            g = grads[name]
            p.add_(g.float() * weak_scalar(step_size, g))
        state["count"] += 1


def adamw(learning_rate, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          eps_root: float = 0.0, weight_decay: float = 1e-4) -> AdamW:
    """``optax.adamw`` with its defaults (weight_decay 1e-4)."""
    return AdamW(learning_rate, b1, b2, eps, eps_root, weight_decay)


def sgd(learning_rate) -> SGD:
    """``optax.sgd(learning_rate)``: no momentum, no Nesterov."""
    return SGD(learning_rate)


def warmup_constant_schedule(init_value: float, peak_value: float,
                             warmup_steps: int) -> Callable[[int], float]:
    """``optax.warmup_constant_schedule``: linear from ``init_value`` to
    ``peak_value`` over ``warmup_steps``, held after; each value computed in
    float32 as optax's ``polynomial_schedule`` computes it (a non-positive
    ``warmup_steps`` holds ``init_value``)."""
    f32 = np.float32
    if warmup_steps <= 0:
        return lambda count: init_value

    def schedule(count: int) -> float:
        frac = f32(1) - f32(min(max(count, 0), warmup_steps)) / f32(warmup_steps)
        return float(f32(init_value - peak_value) * frac + f32(peak_value))

    return schedule


class ScheduleFreeAdamW(Optimizer):
    """``optax.contrib.schedule_free_adamw`` (optax 0.2.6,
    ``optax/contrib/_schedule_free.py``) as torch functions: AdamW without
    momentum (``scale_by_rms`` with bias correction, eps outside the root,
    decayed weights, the learning rate) as the base step, whose updates move
    ``z``; the params are the interpolation ``y = b1 x + (1 - b1) z`` of
    ``z`` and the average ``x``, weighted by ``max_lr ** weight_lr_power``.

    State, optax's fields: ``{"b1", "weight_sum", "step_count", "max_lr",
    "base_optimizer_state": {"count", "nu", "lr_count"}, "z"}``, the scalars
    0-d tensors of the params' dtype (``step_count`` starts at 1, as
    optax's), ``z`` by name. Evaluate at :func:`schedule_free_eval_params`.
    :meth:`apply_` updates params and state in place."""

    def __init__(self, learning_rate: Union[float, Callable[[int], float]],
                 warmup_steps: Optional[int] = None, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.0, weight_lr_power: float = 2.0,
                 state_dtype: Optional[torch.dtype] = None):
        if warmup_steps is not None:
            learning_rate = warmup_constant_schedule(0, learning_rate, warmup_steps)
        super().__init__(learning_rate)
        self.b1, self.b2, self.eps = b1, b2, eps
        self.weight_decay = weight_decay
        self.weight_lr_power = weight_lr_power
        self.state_dtype = state_dtype

    def init(self, params: Params) -> dict:
        first = next(iter(params.values()))
        # the params' lowest-precision dtype (optax.tree.dtype(params, "lowest"))
        dt = min((p.dtype for p in params.values()), key=lambda d: torch.finfo(d).bits)
        scalar = lambda v: torch.tensor(v, dtype=dt, device=first.device)  # noqa: E731
        z = {k: p.detach().to(self.state_dtype or p.dtype, copy=True) for k, p in params.items()}
        return {
            "b1": scalar(self.b1),
            "weight_sum": scalar(0.0),
            "step_count": 1,
            "max_lr": scalar(0.0),
            "base_optimizer_state": {
                "count": 0,
                "nu": {k: torch.zeros_like(p) for k, p in params.items()},
                "lr_count": 0,
            },
            "z": z,
        }

    @torch.no_grad()
    def apply_(self, grads: Params, state: dict, params: Params) -> None:
        """One update in optax's operation order (``schedule_free``'s
        ``update_fn``, then ``optax.apply_updates``)."""
        b1, b2 = self.b1, self.b2
        max_lr_old = state["max_lr"]
        lr = self.lr_at(state["step_count"])  # the wrapper's schedule reads step_count
        max_lr = torch.maximum(max_lr_old, torch.full_like(max_lr_old, lr))
        weight = max_lr ** self.weight_lr_power
        total = state["weight_sum"] + weight
        ck = torch.where(weight.isnan() | total.isnan(), torch.full_like(weight, float("nan")),
                         torch.nan_to_num(weight / total, nan=0.0, posinf=float("inf")))
        base = state["base_optimizer_state"]
        count_inc = base["count"] + 1
        # the base step's learning rate reads its own count, from 0
        step_size = -self.lr_at(base["lr_count"])
        for name, p in params.items():
            g = grads[name]
            nu = base["nu"][name]
            nu.copy_((1 - b2) * (g ** 2) + b2 * nu)
            one = torch.ones((), dtype=torch.float32, device=p.device)
            bc = (one - (one * b2) ** count_inc).to(nu.dtype)
            u = (1 / (torch.sqrt(nu / bc) + self.eps)) * g
            u = u + self.weight_decay * p
            u = step_size * u
            z_old = state["z"][name]
            z = (z_old + u).to(z_old.dtype)
            prev_x = (p - (1.0 - b1) * z_old) / b1
            x = (1.0 - ck) * prev_x + ck * z.to(ck.dtype)
            new_p = b1 * x + (1.0 - b1) * z
            p.add_((new_p - p).to(p.dtype))  # optax.apply_updates
            z_old.copy_(z)
        base["count"] = count_inc
        base["lr_count"] += 1
        state["max_lr"] = max_lr
        state["weight_sum"] = total
        state["step_count"] += 1


def schedule_free_adamw(learning_rate: Union[float, Callable[[int], float]] = 0.0025,
                        warmup_steps: Optional[int] = None, b1: float = 0.9, b2: float = 0.999,
                        eps: float = 1e-8, weight_decay: float = 0.0,
                        weight_lr_power: float = 2.0,
                        state_dtype: Optional[torch.dtype] = None) -> ScheduleFreeAdamW:
    """``optax.contrib.schedule_free_adamw`` with its defaults."""
    return ScheduleFreeAdamW(learning_rate, warmup_steps, b1, b2, eps, weight_decay,
                             weight_lr_power, state_dtype)


@torch.no_grad()
def schedule_free_eval_params(state: dict, params: Params) -> Params:
    """The params to evaluate a schedule-free run at, ``x = (y - (1 - b1) z)
    / b1`` (``optax.contrib.schedule_free_eval_params``): new tensors, by
    name, the state's ``b1`` a tensor as optax's."""
    b1, z = state.get("b1"), state.get("z")
    if b1 is None or z is None:
        raise ValueError("schedule_free_eval_params requires a schedule_free_adamw state")
    return {k: (y.detach() - (1.0 - b1) * z[k]) / b1 for k, y in params.items()}


class AcceleratedOptimizer:
    """Wraps an :class:`Optimizer` with its state: ``init`` creates the
    state for a parameter dict, ``apply_gradients`` is the update the train
    step runs, ``step`` the raw loop's."""

    def __init__(self, optimizer: Optimizer,
                 scheduler_fn: Optional[Callable[[int], float]] = None):
        if not isinstance(optimizer, Optimizer):
            raise TypeError(f"AcceleratedOptimizer expects an optimizer of the port "
                            f"(adamw, sgd, schedule_free_adamw, ...), got {type(optimizer)}")
        self.optimizer = optimizer
        # kept as the reference keeps it (its own step reads no schedule:
        # an optimizer's learning rate already is one)
        self.scheduler_fn = scheduler_fn
        self.opt_state: Optional[dict] = None
        self.gradient_state = GradientState()
        self._step_was_skipped = False
        # under a plugin: the ShardedLayout of the params its state was made
        # for (``Accelerator.prepare``), which the raw loop's step updates by
        self.layout = None

    def init(self, params: Params) -> dict:
        self.opt_state = self.optimizer.init(params)
        return self.opt_state

    def apply_gradients(self, grads: Params, params: Params, opt_state: dict) -> None:
        self.optimizer.apply_(grads, opt_state, params)

    @property
    def step_was_skipped(self) -> bool:
        """Whether the last ``step`` applied nothing (not a sync step)."""
        return self._step_was_skipped

    def zero_grad(self, set_to_none: bool = True) -> None:
        """No-op: the raw loop's gradients are values, not ``.grad``
        buffers (the reference's, :163)."""

    def step(self, params: Params, grads: Params) -> Params:
        """The raw loop's update: applied in place on a sync boundary only
        (``GradientState.sync_gradients``), and ``params`` returned. DTensor
        params and gradients (``Accelerator.backward`` under a plugin) are
        updated on each rank's local shards, under ZeRO-1/2 on its slice of
        the moments, by the layout the state was placed for
        (``parallel.runtime.ShardedLayout.work_set``)."""
        if self.opt_state is None:
            self.init(params)
        if not self.gradient_state.sync_gradients:
            self._step_was_skipped = True
            return params
        self._step_was_skipped = False
        from .parallel.runtime import layout_for, to_local
        from .parallel.sharding import is_dtensor

        if any(is_dtensor(p) for p in params.values()):
            lay = layout_for(params, self.layout)
            local = {k: to_local(g) for k, g in grads.items()}
            grads, work, state, finish = lay.work_set(local, params, self.opt_state,
                                                      scattered=False)
            self.apply_gradients(grads, work, state)
            finish()
            return params
        self.apply_gradients(grads, params, self.opt_state)
        return params

    def state_dict(self) -> Optional[dict]:
        """The optimizer state: ``{"count", "mu", "nu"}`` (adamw),
        ``{"count"}`` (sgd), optax's fields (schedule_free_adamw)."""
        return self.opt_state

    def load_state_dict(self, state: dict) -> None:
        """Copy ``state``'s tensors into the current state's and take its
        other values (the counts), or adopt it when there is no state yet."""
        if self.opt_state is None:
            self.opt_state = state
            return
        _load_into(self.opt_state, state)


@torch.no_grad()
def _load_into(current: dict, state: dict) -> None:
    """``state``'s values into ``current`` by key: tensors copied in place
    (the step holds them), nested dicts in turn, anything else replaced."""
    for key, value in state.items():
        have = current.get(key)
        if isinstance(have, dict):
            _load_into(have, value)
        elif isinstance(have, torch.Tensor):
            have.copy_(value)
        else:
            current[key] = int(value) if isinstance(have, int) else value
