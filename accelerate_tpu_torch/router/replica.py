"""Replica handles: the router's view of one serving engine.

Port of ``accelerate_tpu/router/replica.py``. Two transports, one
duck-typed surface:

* :class:`InProcessReplica` wraps a live ``ServingEngine``: the CPU tests
  and the virtual-clock soaks drive a whole fleet in one process, gauges
  read off the scheduler and the pool;
* :class:`HTTPReplica` is a metrics-plane client (stdlib ``urllib``): it
  reads ``/debug/state`` for gauges, ``/healthz`` for liveness and drain,
  and ``/debug/prefix`` for the chain digest. It places only; submission
  goes through the deployment's own ingress, and
  :meth:`~.router.FleetRouter.select` names the replica to send to. (The
  port serves no such endpoint yet: ROADMAP.md, queue A10.)

Any fetch can fail; handles raise, and the router keeps to the last cached
snapshot instead of blocking admission.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Optional

from ..logging import get_logger

logger = get_logger(__name__)


@dataclasses.dataclass
class ReplicaSnapshot:
    """One replica's load at ``taken_at`` (the router's clock): the gauges
    the placement policies read, and nothing more."""

    queue_depth: int = 0
    slots_active: int = 0
    slot_occupancy: float = 0.0
    pool_utilization: float = 0.0
    tokens_in_flight: int = 0
    taken_at: float = 0.0
    #: a cached snapshot served after a failed refresh
    stale: bool = False

    @classmethod
    def from_gauges(cls, gauges: dict, taken_at: float) -> "ReplicaSnapshot":
        return cls(
            queue_depth=int(gauges.get("queue_depth") or 0),
            slots_active=int(gauges.get("slots_active") or 0),
            slot_occupancy=float(gauges.get("slot_occupancy") or 0.0),
            pool_utilization=float(gauges.get("pool_utilization") or 0.0),
            tokens_in_flight=int(gauges.get("tokens_in_flight") or 0),
            taken_at=taken_at,
        )


class InProcessReplica:
    """A ``ServingEngine`` in this process. The engine needs
    ``add_request``, ``step`` and ``has_work``; every other hook is read
    through ``getattr`` with a default, so the router's tests run on fake
    engines and a fake clock."""

    def __init__(self, name: str, engine: Any):
        self.name = name
        self.engine = engine
        self._dead = False

    # -- lifecycle ----------------------------------------------------- #
    @property
    def alive(self) -> bool:
        return not self._dead

    def mark_dead(self) -> None:
        """A ``replica_kill`` landed: the handle stays registered (its build
        counts and stats still merge into the fleet's) but takes no traffic
        and no steps."""
        self._dead = True

    def health(self) -> dict:
        if self._dead:
            return {"ok": False, "state": "dead"}
        fn = getattr(self.engine, "health", None)
        if fn is not None:
            return dict(fn())
        return {"ok": True, "state": "serving"}

    @property
    def draining(self) -> bool:
        return bool(getattr(self.engine, "draining", False))

    def drain(self) -> list:
        """Stop admission and harvest the unadmitted queue (the router
        places it elsewhere); seated requests decode to the end."""
        fn = getattr(self.engine, "drain", None)
        return list(fn()) if fn is not None else []

    # -- serving surface ----------------------------------------------- #
    def add_request(self, prompt, **kwargs) -> str:
        return self.engine.add_request(prompt, **kwargs)

    def step(self):
        return self.engine.step()

    @property
    def has_work(self) -> bool:
        return bool(self.engine.has_work) and not self._dead

    def result(self, request_id: str):
        fn = getattr(self.engine, "result", None)
        return fn(request_id) if fn is not None else None

    def shed_reason(self, request_id: str):
        fn = getattr(self.engine, "shed_reason", None)
        return fn(request_id) if fn is not None else None

    # -- placement inputs ---------------------------------------------- #
    def fetch_snapshot(self, now: float) -> ReplicaSnapshot:
        gauges_fn = getattr(self.engine, "_gauge_fields", None)
        if gauges_fn is None:
            return ReplicaSnapshot(taken_at=now)
        return ReplicaSnapshot.from_gauges(gauges_fn(), now)

    def fetch_digest(self, max_entries: int) -> dict:
        fn = getattr(self.engine, "prefix_digest", None)
        if fn is None:
            return {"entries": [], "block_size": 0, "fingerprint": ""}
        return fn(max_entries)

    def queued_requests(self) -> list:
        """The unadmitted queue (``Request`` objects), which a kill can
        still save; seated requests' KV died with the replica and count as
        lost. Manifests still in a disaggregated engine's outbox or inbox
        never reached a decode seat: a :class:`~..serving.TransferManifest`
        reads like a ``Request`` for re-queueing, so those prompts prefill
        again on a survivor."""
        out: list = []
        sched = getattr(self.engine, "scheduler", None)
        if sched is not None:
            out.extend(sched.queue)
            sched.queue.clear()
        for box in ("_outbox", "_inbox"):
            pending = getattr(self.engine, box, None)
            if pending:
                out.extend(pending)
                pending.clear()
        return out

    def seated_count(self) -> int:
        sched = getattr(self.engine, "scheduler", None)
        if sched is None:
            return 0
        n = sum(1 for s in sched.slots if s.busy)
        return n + len(getattr(self.engine, "_swapped_reqs", ()))


class HTTPReplica:
    """Metrics-plane client of a replica's scrape endpoint. Every call has a
    bounded timeout and raises on failure; staleness is the router's
    business."""

    def __init__(self, name: str, base_url: str, timeout_s: float = 1.0):
        self.name = name
        self.base_url = base_url.rstrip("/")
        self.timeout_s = timeout_s
        self._dead = False
        self.digest_failures_total = 0
        self._digest_failing = False

    @property
    def alive(self) -> bool:
        return not self._dead

    def mark_dead(self) -> None:
        self._dead = True

    def _get_json(self, path: str) -> Any:
        import urllib.error
        import urllib.request

        try:
            with urllib.request.urlopen(self.base_url + path, timeout=self.timeout_s) as resp:
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as exc:
            # /healthz serves its JSON body with a 503 too: a draining or
            # dead posture is data, not an error
            if path == "/healthz":
                try:
                    return json.loads(exc.read().decode())
                except Exception:
                    pass
            raise

    def health(self) -> dict:
        if self._dead:
            return {"ok": False, "state": "dead"}
        body = self._get_json("/healthz")
        if not isinstance(body, dict):
            return {"ok": bool(body), "state": "serving"}
        body.setdefault("state", "serving" if body.get("ok") else "down")
        return body

    @property
    def draining(self) -> bool:
        try:
            return self.health().get("state") == "draining"
        except Exception:
            return False

    def fetch_snapshot(self, now: float) -> ReplicaSnapshot:
        state = self._get_json("/debug/state")
        gauges = state.get("gauges") or {} if isinstance(state, dict) else {}
        return ReplicaSnapshot.from_gauges(gauges, now)

    def fetch_digest(self, max_entries: int) -> dict:
        """The chain digest, or an empty one marked ``stale`` when the
        scrape fails: a dead ``/debug/prefix`` costs this replica its
        affinity for the tick, never the fleet its placement. The failure
        is logged once a run of consecutive failures."""
        try:
            digest = self._get_json("/debug/prefix")
            self._digest_failing = False
            return digest
        except Exception as exc:
            self.digest_failures_total += 1
            if not self._digest_failing:
                self._digest_failing = True
                logger.warning("replica %s /debug/prefix unreachable (%s): serving an empty "
                               "digest (no affinity) until the scrape recovers", self.name, exc)
            return {"entries": [], "block_size": 0, "fingerprint": "", "stale": True}

    # -- a placement-only client: no in-band submission ---------------- #
    def add_request(self, prompt, **kwargs) -> str:
        raise NotImplementedError(
            "HTTPReplica is a metrics-plane placement client; submit via the replica's own "
            "ingress (use FleetRouter.select to pick it)")

    def step(self):
        return []

    @property
    def has_work(self) -> bool:
        return False

    def result(self, request_id: str):
        return None

    def shed_reason(self, request_id: str):
        return None

    def drain(self) -> list:
        return []

    def queued_requests(self) -> list:
        return []

    def seated_count(self) -> int:
        return 0

    @property
    def engine(self) -> Optional[Any]:
        return None
