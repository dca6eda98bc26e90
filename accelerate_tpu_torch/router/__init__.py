"""Fleet serving: a host-side router over N ``ServingEngine`` replicas.

Port of ``accelerate_tpu/router/``. The router is host policy over what the
engines export (live gauges, the content-addressed chain digest,
``health``), so placement adds no device work. Three placement policies
(:mod:`.policies`): round robin, the baseline; least loaded, from the
replicas' gauges with staleness-tolerant cached snapshots; prefix affinity,
which routes on ``overlap_tokens - load_penalty * load`` so a templated
cohort gathers on the replica that holds its prefix. Session affinity rides
on any of them. ``FleetRouter(placement="disagg")`` splits the fleet by
engine role and hands finished KV chains from the prefill pool to the
decode pool (:mod:`..serving.transfer`).

Nothing in the single-engine path imports this package; a
:class:`FleetRouter` exists only where user code (or chip_smoke.py's fleet
phase) builds one, and ``loadgen.SoakHarness`` drives it as an engine.
"""

from .policies import (
    LeastLoadedPolicy,
    PrefixAffinityPolicy,
    RoundRobinPolicy,
    load_score,
    make_policy,
)
from .replica import HTTPReplica, InProcessReplica, ReplicaSnapshot
from .router import FleetRouter

__all__ = [
    "FleetRouter",
    "HTTPReplica",
    "InProcessReplica",
    "LeastLoadedPolicy",
    "PrefixAffinityPolicy",
    "ReplicaSnapshot",
    "RoundRobinPolicy",
    "load_score",
    "make_policy",
]
