"""Local SGD: processes train their own replicas and average the parameters
every K steps.

Port of ``accelerate_tpu/local_sgd.py`` (``LocalSGD`` :35-143,
``replicate_params`` / ``average_replicas`` :168-196). Inside an enabled
block each process steps its own copy of the parameters: the accelerator's
step and ``backward`` leave the gradients (and the loss) their own process's,
as the reference's no-sync window does; every ``local_sgd_steps``-th call of
:meth:`LocalSGD.step` replaces the params, and the optimizer's floating
state (Adam's moments, so stale moments do not undo the average), by their
mean over the processes (``utils.operations.reduce``), written into the
carry's tensors in place. Integer leaves (step counts) are kept. On one
process the mean is the identity and nothing is reduced.

The one-process form keeps replicas on a leading axis instead:
``replicate_params`` stacks ``n`` copies of every leaf and
``average_replicas`` takes the mean over that axis.
"""

from __future__ import annotations

from typing import Any

import torch

from .logging import get_logger
from .utils.operations import reduce

logger = get_logger(__name__)


class LocalSGD:
    """Context manager for periodic parameter averaging (reference :35).

    Usage::

        with LocalSGD(accelerator, local_sgd_steps=8) as lsgd:
            for batch in loader:
                carry, _ = step(carry, batch)
                carry = lsgd.step(carry)

    ``step`` is called once an optimizer step with the train carry (its
    ``"params"`` and ``"opt_state"`` are averaged) or a bare params tree; it
    returns the same structure, averaged on sync steps. Leaving the block
    averages once more unless the count already landed on a boundary
    (reference :78): in place for a dict, else with a warning to call
    :meth:`flush`."""

    def __init__(self, accelerator, local_sgd_steps: int = 8, enabled: bool = True):
        if local_sgd_steps < 1:
            raise ValueError(f"local_sgd_steps must be >= 1, got {local_sgd_steps}")
        self.accelerator = accelerator
        self.local_sgd_steps = local_sgd_steps
        self.enabled = enabled
        self.num_steps = 0
        self._last_tree: Any = None

    def __enter__(self) -> "LocalSGD":
        self.num_steps = 0
        self.accelerator._local_sgd = self.enabled
        return self

    def __exit__(self, *exc):
        self.accelerator._local_sgd = False
        if (self.enabled and exc[0] is None and self._last_tree is not None
                and self.num_steps % self.local_sgd_steps != 0):
            if isinstance(self._last_tree, dict):
                averaged = self._average(self._last_tree)
                for k in averaged:
                    self._last_tree[k] = averaged[k]
            else:
                logger.warning("LocalSGD exited mid-window with a non-dict tree; the exit flush "
                               "cannot update it in place: call `tree = local_sgd.flush(tree)` "
                               "before leaving the context or the replicas stay apart.")
        return False

    def step(self, tree: Any) -> Any:
        """Count one step; every ``local_sgd_steps``-th returns the mean of
        ``tree`` over the processes."""
        if not self.enabled:
            return tree
        self.num_steps += 1
        self._last_tree = tree
        if self.num_steps % self.local_sgd_steps != 0:
            return tree
        out = self._average(tree)
        self._last_tree = out
        return out

    def flush(self, tree: Any) -> Any:
        """Average now, wherever the window stands, and restart the count."""
        if not self.enabled:
            return tree
        out = self._average(tree)
        self._last_tree = out
        self.num_steps = 0
        return out

    def _average(self, tree: Any) -> Any:
        if not self.accelerator.state.partial_state.group_up:
            return tree  # one process: the mean is the tree
        if isinstance(tree, dict) and "params" in tree:
            out = dict(tree)
            out["params"] = _mean_in_place(tree["params"])
            if "opt_state" in tree:
                out["opt_state"] = _mean_in_place(tree["opt_state"])
            return out
        return _mean_in_place(tree)


def _mean_in_place(tree: Any) -> Any:
    """Every floating tensor leaf set in place to its mean over the
    processes; other leaves kept. Returns ``tree``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            tree[k] = _mean_in_place(v)
        return tree
    if isinstance(tree, (list, tuple)):
        return type(tree)(_mean_in_place(v) for v in tree)
    if isinstance(tree, torch.Tensor) and tree.is_floating_point():
        with torch.no_grad():
            tree.copy_(reduce(tree.detach(), "mean"))
    return tree


def replicate_params(params: Any, num_replicas: int) -> Any:
    """``num_replicas`` copies of every leaf stacked on a new leading axis:
    each replica trains on its own from here (the one-process form of "no
    gradient sync")."""
    if num_replicas < 1:
        raise ValueError(f"num_replicas must be >= 1, got {num_replicas}")
    if isinstance(params, dict):
        return {k: replicate_params(v, num_replicas) for k, v in params.items()}
    return params.detach().unsqueeze(0).expand(num_replicas, *params.shape).clone()


def average_replicas(params: Any) -> Any:
    """The leading replica axis collapsed by its mean."""
    if isinstance(params, dict):
        return {k: average_replicas(v) for k, v in params.items()}
    return params.mean(dim=0)
