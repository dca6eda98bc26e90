"""Placement policies: pure functions of candidate snapshots.

Port of ``accelerate_tpu/router/policies.py``. A policy never touches a
replica: the router builds the candidates (live, non-draining replicas with
their cached :class:`~.replica.ReplicaSnapshot` and, when the policy asks
for it, the request's cached-chain overlap) and the policy picks one, so
each policy is testable on fake snapshots and comparable on one trace (the
``fleet_soak`` arms).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from .replica import ReplicaSnapshot


@dataclasses.dataclass
class Candidate:
    """One routable replica as the policy sees it."""

    name: str
    order: int  # registration order: the round-robin and tie-break axis
    snapshot: ReplicaSnapshot
    #: prompt tokens already cached on the replica (0 when the policy did
    #: not ask for overlap, or nothing matched)
    overlap_tokens: int = 0


def load_score(snap: ReplicaSnapshot) -> float:
    """The scalar load of least-loaded ordering and the affinity penalty: a
    queued request (a whole request of unstarted work) and a busy seat count
    one each, and pool utilization breaks ties between equally seated
    replicas (a fuller pool is nearer to blocking admission)."""
    return float(snap.queue_depth) + float(snap.slots_active) + float(snap.pool_utilization)


class RoundRobinPolicy:
    """The baseline: cycle through the candidates in registration order,
    blind to load and cache."""

    name = "round_robin"
    needs_overlap = False

    def __init__(self):
        self._next = 0

    def choose(self, candidates: Sequence[Candidate]) -> Candidate:
        # the first candidate at or after the cursor in registration order;
        # dead and draining replicas are filtered out already, so the cursor
        # skips their places
        pick = min(candidates,
                   key=lambda c: ((c.order - self._next) % _span(candidates), c.order))
        self._next = pick.order + 1
        return pick


def _span(candidates: Sequence[Candidate]) -> int:
    return max(c.order for c in candidates) + 1


class LeastLoadedPolicy:
    """The replica of lowest :func:`load_score`; registration order breaks
    exact ties."""

    name = "least_loaded"
    needs_overlap = False

    def choose(self, candidates: Sequence[Candidate]) -> Candidate:
        return min(candidates, key=lambda c: (load_score(c.snapshot), c.order))


class PrefixAffinityPolicy:
    """Route on ``overlap_tokens - load_penalty * load_score``.

    ``overlap_tokens`` is the request's longest cached chain on the
    candidate (block-granular, tenant-scoped, computed by the router from
    the replica's key digest). ``load_penalty`` is how many cached prefix
    tokens one unit of load is worth, so a replica with a deep queue must
    offer a longer warm prefix to win. With no overlap anywhere this is
    least-loaded: cold traffic spreads, templated cohorts gather.
    """

    name = "prefix_affinity"
    needs_overlap = True

    def __init__(self, load_penalty: float = 8.0):
        if load_penalty < 0:
            raise ValueError("load_penalty must be >= 0")
        self.load_penalty = load_penalty

    def choose(self, candidates: Sequence[Candidate]) -> Candidate:
        return max(candidates, key=lambda c: (
            c.overlap_tokens - self.load_penalty * load_score(c.snapshot),
            -load_score(c.snapshot), -c.order))


_POLICIES = {
    "round_robin": RoundRobinPolicy,
    "least_loaded": LeastLoadedPolicy,
    "prefix_affinity": PrefixAffinityPolicy,
}


def make_policy(policy, load_penalty: Optional[float] = None):
    """A policy by name (an instance passes through); ``load_penalty``
    applies to ``prefix_affinity`` only."""
    if not isinstance(policy, str):
        return policy
    try:
        cls = _POLICIES[policy]
    except KeyError:
        raise ValueError(f"unknown routing policy {policy!r}; "
                         f"want one of {sorted(_POLICIES)}") from None
    if cls is PrefixAffinityPolicy and load_penalty is not None:
        return cls(load_penalty=load_penalty)
    return cls()
