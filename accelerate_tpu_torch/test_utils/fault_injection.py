"""Deterministic fault injection: faults named by an environment variable.

Host-only copy of ``accelerate_tpu/test_utils/fault_injection.py``:
``FaultSpec`` (``parse``/``render``), ``render_specs``, ``FaultInjector``
(``install_handler``, ``from_env``, ``maybe_fire``) and ``FAULT_ENV``,
``ENV_PREFIX + "FAULT_INJECT"``::

    ACCELERATE_TPU_FAULT_INJECT="kill@7:rank=2:gen=0"

A spec is ``action@step[:key=val...]``, specs are ``;``-separated:

* process actions: ``kill`` (SIGKILL to itself: no handlers run),
  ``sigterm``/``sigint`` (handlers run), ``hang`` (sleeps forever) and
  ``dcn_stall`` (a stalled link: ``secs=S`` bounds it, unset blocks until
  killed);
* serving actions (:data:`SERVING_ACTIONS`): ``stall_decode``,
  ``pool_pressure``, ``adapter_churn``, ``replica_kill``, ``replica_slow``,
  ``transfer_stall``, ``transfer_drop``. They never touch signals or
  sleep: they go to a handler the soak harness's
  ``loadgen.chaos.ChaosAdapter`` installs, and are inert without one;
* ``@step``: fire when :meth:`FaultInjector.maybe_fire` is called with
  exactly this step;
* ``rank=R`` (default 0): only this process index fires; ``slice=S``:
  every rank of fault domain S fires (overriding ``rank=``); ``gen=G``
  (default 0): only this elastic generation fires; ``secs=N`` (timed
  actions) and ``replica=N`` (fleet and transfer actions).

The process actions are handled as the reference handles them; the soak
harness fires only serving actions.
"""


from __future__ import annotations

import dataclasses
import os
import signal
import time
from typing import Optional, Sequence

from ..utils.constants import ENV_PREFIX

FAULT_ENV = ENV_PREFIX + "FAULT_INJECT"

#: serving-scoped actions: dispatched to an installed handler (the soak
#: harness's ChaosAdapter), never to signals/sleeps — non-fatal by
#: construction
SERVING_ACTIONS = (
    "stall_decode",
    "pool_pressure",
    "adapter_churn",
    "replica_kill",
    "replica_slow",
    "transfer_stall",
    "transfer_drop",
)

_ACTIONS = ("kill", "sigterm", "sigint", "hang", "dcn_stall") + SERVING_ACTIONS

#: actions whose ``secs=`` field bounds a stall duration
_TIMED_ACTIONS = (
    "dcn_stall", "stall_decode", "pool_pressure", "replica_slow",
    "transfer_stall",
)

#: actions whose ``replica=`` field targets one fleet replica by index
_REPLICA_ACTIONS = (
    "replica_kill", "replica_slow", "transfer_stall", "transfer_drop",
)


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One parsed fault:
    ``action@step:rank=R:gen=G[:slice=S][:secs=N][:replica=N]``."""

    action: str
    step: int
    rank: int = 0
    generation: int = 0
    fault_domain: Optional[int] = None  # ``slice=`` gate; None = rank gate
    stall_secs: float = 0.0  # ``secs=``; dcn_stall duration, 0 = forever
    replica: Optional[int] = None  # ``replica=``; fleet replica index

    @classmethod
    def parse(cls, text: str) -> "FaultSpec":
        head, _, tail = text.strip().partition(":")
        action, at, step = head.partition("@")
        if action not in _ACTIONS or at != "@":
            raise ValueError(
                f"bad fault spec {text!r}: want "
                f"'action@step[:rank=R][:gen=G][:slice=S][:secs=N]' "
                f"with action in {_ACTIONS}"
            )
        fields = {"rank": 0, "gen": 0, "slice": None, "secs": 0.0,
                  "replica": None}
        for part in filter(None, tail.split(":")):
            key, eq, val = part.partition("=")
            if key not in fields or eq != "=":
                raise ValueError(
                    f"bad fault spec {text!r}: unknown field {part!r}"
                )
            fields[key] = float(val) if key == "secs" else int(val)
        if fields["secs"] and action not in _TIMED_ACTIONS:
            raise ValueError(
                f"bad fault spec {text!r}: secs= only applies to "
                f"{'/'.join(_TIMED_ACTIONS)}"
            )
        if fields["replica"] is not None and action not in _REPLICA_ACTIONS:
            raise ValueError(
                f"bad fault spec {text!r}: replica= only applies to "
                f"{'/'.join(_REPLICA_ACTIONS)}"
            )
        return cls(
            action=action,
            step=int(step),
            rank=fields["rank"],
            generation=fields["gen"],
            fault_domain=fields["slice"],
            stall_secs=fields["secs"],
            replica=fields["replica"],
        )

    def render(self) -> str:
        out = f"{self.action}@{self.step}:rank={self.rank}:gen={self.generation}"
        if self.fault_domain is not None:
            out += f":slice={self.fault_domain}"
        if self.stall_secs:
            out += f":secs={self.stall_secs:g}"
        if self.replica is not None:
            out += f":replica={self.replica}"
        return out


def render_specs(specs: Sequence[FaultSpec]) -> str:
    """Env-var value for a list of specs (the supervisor-test encoder)."""
    return ";".join(s.render() for s in specs)


class FaultInjector:
    """Fires the matching :class:`FaultSpec` at the matching step.

    ``rank``/``generation``/``fault_domain`` default from the process env
    (the same ``ACCELERATE_TPU_PROCESS_ID`` /
    ``ACCELERATE_TPU_ELASTIC_GENERATION`` /
    ``ACCELERATE_TPU_FAULT_DOMAIN`` the launcher/supervisor export), so
    ``FaultInjector.from_env()`` in the training script needs no plumbing.
    """

    def __init__(
        self,
        specs: Sequence[FaultSpec] = (),
        rank: Optional[int] = None,
        generation: Optional[int] = None,
        fault_domain: Optional[int] = None,
    ):
        self.specs = list(specs)
        if rank is None:
            rank = int(os.environ.get(ENV_PREFIX + "PROCESS_ID", "0"))
        if generation is None:
            generation = int(
                os.environ.get(ENV_PREFIX + "ELASTIC_GENERATION", "0")
            )
        if fault_domain is None:
            fault_domain = int(
                os.environ.get(ENV_PREFIX + "FAULT_DOMAIN", "0")
            )
        self.rank = rank
        self.generation = generation
        self.fault_domain = fault_domain
        self._fired: set[FaultSpec] = set()
        self._handlers: dict = {}  # serving action -> callable(spec)

    def install_handler(self, action: str, handler) -> None:
        """Route a serving-scoped action to ``handler(spec)`` instead of
        the process-fatal paths. Only :data:`SERVING_ACTIONS` may be
        handled — rewiring ``kill`` would let a test pass while the
        scenario it claims to exercise never ran."""
        if action not in SERVING_ACTIONS:
            raise ValueError(
                f"only serving actions {SERVING_ACTIONS} take handlers, "
                f"got {action!r}"
            )
        self._handlers[action] = handler

    @classmethod
    def from_env(cls, env_var: str = FAULT_ENV, **kwargs) -> "FaultInjector":
        raw = os.environ.get(env_var, "")
        specs = [FaultSpec.parse(p) for p in raw.split(";") if p.strip()]
        return cls(specs, **kwargs)

    def _placement_matches(self, spec: FaultSpec) -> bool:
        # slice= gates on the fault domain and overrides rank= — the
        # whole slice fires, which is what a slice-level fault looks like
        if spec.fault_domain is not None:
            return spec.fault_domain == self.fault_domain
        return spec.rank == self.rank

    def maybe_fire(self, step: int) -> None:
        """Call once per step; executes at most once per matching spec."""
        for spec in self.specs:
            if spec in self._fired:
                continue
            if (
                spec.step == step
                and self._placement_matches(spec)
                and spec.generation == self.generation
            ):
                self._fired.add(spec)
                self._execute(spec)

    def _execute(self, spec: FaultSpec) -> None:
        if spec.action in SERVING_ACTIONS:
            handler = self._handlers.get(spec.action)
            if handler is not None:
                handler(spec)
            return  # unhandled serving faults are inert, never fatal
        if spec.action == "kill":
            os.kill(os.getpid(), signal.SIGKILL)
        elif spec.action == "sigterm":
            os.kill(os.getpid(), signal.SIGTERM)
        elif spec.action == "sigint":
            os.kill(os.getpid(), signal.SIGINT)
        elif spec.action == "hang":
            while True:  # the watchdog's job is to notice this
                time.sleep(3600.0)
        elif spec.action == "dcn_stall":
            if spec.stall_secs > 0:
                time.sleep(spec.stall_secs)  # transient link blip: recovers
            else:
                while True:  # blocked link: watchdog territory, like hang
                    time.sleep(3600.0)
