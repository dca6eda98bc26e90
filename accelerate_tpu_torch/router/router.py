"""The fleet router: lifecycle, placement and re-route accounting.

Port of ``accelerate_tpu/router/router.py``. :class:`FleetRouter` fronts N
replicas and presents the soak harness's duck-typed engine surface
(``add_request``, ``step``, ``has_work``, ``result``, ``trace_counts``,
``stats``, ``set_observability``), so ``loadgen.SoakHarness`` drives a
fleet as it drives one engine: one router step steps every live replica
once.

Placement reads snapshots and never blocks: gauges are cached a replica
with a maximum age, a failed refresh serves the last known snapshot marked
stale (``stale_snapshot_routes_total`` counts it), and a replica with no
snapshot yet routes on an optimistic zero load. Admission can misplace on
stale data; it cannot wedge.

Lifecycle:

* :meth:`register` / :meth:`remove`: add or drop a replica;
* :meth:`drain`: stop a replica's admission (its ``health`` reads
  ``draining``), place its unadmitted queue on the rest of the fleet
  (``rerouted_total``, ``requests_requeued``), let seated work finish;
* :meth:`kill`: a crash or ``replica_kill``: the unadmitted queue is
  re-queued on survivors, seated requests are lost with their KV and
  counted in ``requests_lost``;
* every :meth:`step` polls ``health()``, and a replica not ok is ejected
  through :meth:`kill`.

With ``session_affinity=True`` a ``session_id`` is pinned to a replica in
a bounded LRU map; a pinned replica that drains or dies spills the session
to the base policy (``session_spills_total``).

``placement="disagg"`` splits the fleet by engine role: prompts go to the
prefill pool, and each finished chain is handed to the decode replica with
the deepest cached-chain overlap through an in-flight ledger
(:meth:`_pump_transfers`), with re-queue on a dead endpoint and the
``transfer_stall``/``transfer_drop`` chaos actions.
"""

from __future__ import annotations

import json
import time
from collections import OrderedDict, deque
from typing import Any, Callable, Iterable, Optional

from ..serving.transfer import TransferPlane, _TransferRecord
from .policies import Candidate, load_score, make_policy
from .replica import ReplicaSnapshot


class _FleetStats:
    """The slice of ``ServeStats`` the soak harness reads off its
    engine, merged across replicas on demand."""

    def __init__(self, router: "FleetRouter"):
        self._router = router

    @property
    def shed_counts(self) -> dict:
        merged: dict[str, int] = {}
        for rep in self._router._all_replicas():
            stats = getattr(rep.engine, "stats", None)
            counts = getattr(stats, "shed_counts", None)
            if counts:
                for reason, n in counts.items():
                    merged[reason] = merged.get(reason, 0) + n
        return merged


class FleetRouter:
    """Host-side multi-replica router (see module docstring).

    ``policy``: ``"round_robin"`` | ``"least_loaded"`` |
    ``"prefix_affinity"`` or a policy instance. ``now`` must be the
    same injectable clock the replicas' engines stamp from (the soak
    harness's virtual clock in tests/benches, ``time.monotonic`` in
    production).
    """

    def __init__(
        self,
        replicas: Iterable = (),
        *,
        policy="least_loaded",
        load_penalty: Optional[float] = None,
        session_affinity: bool = False,
        max_sessions: int = 4096,
        snapshot_max_age_s: float = 0.0,
        digest_max_age_s: float = 0.05,
        digest_max_entries: int = 512,
        placement: str = "colocated",
        transfer_plane: Optional[TransferPlane] = None,
        now: Callable[[], float] = time.monotonic,
    ):
        if max_sessions < 1:
            raise ValueError("max_sessions must be >= 1")
        if placement not in ("colocated", "disagg"):
            raise ValueError(
                f'placement must be "colocated" or "disagg", '
                f"got {placement!r}"
            )
        self.policy = make_policy(policy, load_penalty=load_penalty)
        self.session_affinity = session_affinity
        self.max_sessions = max_sessions
        self.snapshot_max_age_s = snapshot_max_age_s
        self.digest_max_age_s = digest_max_age_s
        self.digest_max_entries = digest_max_entries
        self._now = now
        self._replicas: "OrderedDict[str, Any]" = OrderedDict()
        self._order: dict[str, int] = {}
        self._next_order = 0
        self._snaps: dict[str, ReplicaSnapshot] = {}
        self._digests: dict[str, dict] = {}  # name -> {keys,set, meta, at}
        self._sessions: "OrderedDict[str, str]" = OrderedDict()
        # bounded rid -> replica-name map for result()/shed_reason()
        self._placements: "OrderedDict[str, str]" = OrderedDict()
        self._max_placements = 65536
        self._slow_until: dict[str, float] = {}
        # accounting (the soak report's router section)
        self.routed_total = 0
        self.routed_by_replica: dict[str, int] = {}
        self.rerouted_total = 0
        self.requests_requeued = 0
        self.requests_lost = 0
        self.session_spills_total = 0
        self.stale_snapshot_routes_total = 0
        self.ejections_total = 0
        # disaggregation: prompts route onto the prefill pool and finished
        # KV chains hand off to the decode pool through an in-flight
        # transfer ledger (see _pump_transfers)
        self.placement = placement
        if transfer_plane is None and placement == "disagg":
            transfer_plane = TransferPlane(now=now)
        self.transfer_plane = transfer_plane
        self._transfers: list[_TransferRecord] = []
        # bounded per-request transfer accounting: rid -> delivery facts
        self._transfer_log: "OrderedDict[str, dict]" = OrderedDict()
        self._max_transfer_log = 65536
        # retained hand-off timeline slices for export_trace: delivered
        # and dropped records leave _transfers (and _transfer_log keeps
        # only derived facts), so the fleet trace rides its own ring
        self._transfer_trace: deque = deque(maxlen=4096)
        self._transfer_stall_until = 0.0
        self._transfer_stall_src: Optional[str] = None
        self._transfer_stall_started: Optional[float] = None
        self.transfers_delivered_total = 0
        self.transfers_dropped_total = 0
        self.transfer_stalls_total = 0
        self.transfer_stall_recovery_s = 0.0
        self.stats = _FleetStats(self)
        for rep in replicas:
            self.register(rep)

    # ------------------------------------------------------------------ #
    # lifecycle
    # ------------------------------------------------------------------ #
    def register(self, replica) -> None:
        if replica.name in self._replicas:
            raise ValueError(f"replica {replica.name!r} already registered")
        self._replicas[replica.name] = replica
        self._order[replica.name] = self._next_order
        self._next_order += 1
        self.routed_by_replica.setdefault(replica.name, 0)

    @property
    def replicas(self) -> list:
        return list(self._replicas.values())

    def replica(self, name: str):
        return self._replicas[name]

    def drain(self, name: str) -> dict:
        """Graceful rotation: stop ``name``'s admission and re-route
        its unadmitted queue onto the rest of the fleet. Returns the
        re-route accounting for this drain."""
        rep = self._replicas[name]
        harvested = rep.drain()
        requeued = self._requeue(harvested, exclude=name)
        return {"replica": name, "requeued": requeued, "lost": 0}

    def kill(self, name: str) -> dict:
        """Ungraceful loss (crash / ``replica_kill`` chaos): re-queue
        what never reached a seat, count what died with the replica."""
        rep = self._replicas[name]
        if not rep.alive:
            return {"replica": name, "requeued": 0, "lost": 0}
        harvested = rep.queued_requests()
        seated_lost = rep.seated_count()
        rep.mark_dead()
        self.ejections_total += 1
        requeued = self._requeue(harvested, exclude=name)
        self.requests_lost += seated_lost
        # lost = seats that died with the replica + harvested entries
        # no survivor could take (those are already in requests_lost
        # via the _requeue failure path)
        lost = seated_lost + (len(harvested) - requeued)
        return {"replica": name, "requeued": requeued, "lost": lost}

    def remove(self, name: str) -> None:
        """Unregister a replica (drain it first for a graceful exit —
        remove does not harvest)."""
        self._replicas.pop(name)
        self._order.pop(name, None)
        self._snaps.pop(name, None)
        self._digests.pop(name, None)
        self._slow_until.pop(name, None)

    def slow(self, name: str, secs: float) -> None:
        """``replica_slow`` chaos: the replica takes no steps until
        ``now + secs`` — queued work piles up on it, and load-aware
        policies route around it."""
        self._slow_until[name] = self._now() + max(0.0, secs)

    def _eject_unhealthy(self) -> None:
        for name, rep in list(self._replicas.items()):
            if not rep.alive:
                continue
            try:
                ok = bool(rep.health().get("ok"))
            except Exception:
                ok = False
            if not ok:
                self.kill(name)

    def _requeue(self, requests, exclude: Optional[str] = None) -> int:
        n = 0
        for req in requests:
            try:
                self.add_request(
                    list(req.prompt),
                    max_new_tokens=req.max_new_tokens,
                    temperature=req.temperature,
                    eos_token_id=req.eos_token_id,
                    request_id=req.request_id,
                    adapter=req.adapter,
                    priority=req.priority,
                    _exclude=exclude,
                )
                n += 1
            except RuntimeError:
                # nowhere left to put it: the request is lost, not
                # silently dropped
                self.requests_lost += 1
        self.rerouted_total += n
        self.requests_requeued += n
        return n

    # ------------------------------------------------------------------ #
    # placement
    # ------------------------------------------------------------------ #
    def _routable(self, exclude: Optional[str] = None) -> list:
        return [
            r for name, r in self._replicas.items()
            if r.alive and not r.draining and name != exclude
        ]

    @staticmethod
    def _role_of(rep) -> str:
        return getattr(getattr(rep, "engine", None), "role", None) \
            or "colocated"

    def _pool(self, role: str, exclude: Optional[str] = None) -> list:
        return [
            r for r in self._routable(exclude=exclude)
            if self._role_of(r) == role
        ]

    def _snapshot(self, rep) -> ReplicaSnapshot:
        now = self._now()
        cached = self._snaps.get(rep.name)
        if (
            cached is not None
            and not cached.stale
            and now - cached.taken_at < self.snapshot_max_age_s
        ):
            # strict <: the 0.0 default means "always refetch", which
            # is right for in-process replicas where a fetch is a dict
            # read; HTTP fleets set a real tolerance to bound scrapes
            return cached
        try:
            snap = rep.fetch_snapshot(now)
        except Exception:
            # staleness tolerance: a dead scrape must never wedge
            # admission — serve the last known posture (or an
            # optimistic zero-load default) and count it
            self.stale_snapshot_routes_total += 1
            snap = cached or ReplicaSnapshot(taken_at=now)
            snap.stale = True
        self._snaps[rep.name] = snap
        return snap

    def _digest(self, rep) -> Optional[dict]:
        now = self._now()
        cached = self._digests.get(rep.name)
        if cached is not None and now - cached["at"] <= self.digest_max_age_s:
            return cached
        try:
            raw = rep.fetch_digest(self.digest_max_entries)
        except Exception:
            return cached  # stale digest beats no digest
        if raw.get("stale") and cached is not None:
            # the handle degraded to an empty placeholder (scrape
            # error/timeout): last-known-good still beats it
            return cached
        entry = {
            "at": now,
            "keys": set(raw.get("entries") or ()),
            "block_size": int(raw.get("block_size") or 0),
            "fingerprint": raw.get("fingerprint") or "",
        }
        self._digests[rep.name] = entry
        return entry

    def _overlap_tokens(self, rep, prompt, adapter) -> int:
        digest = self._digest(rep)
        if not digest or not digest["keys"] or not digest["block_size"]:
            return 0
        from ..serving.block_pool import prefix_keys

        block_size = digest["block_size"]
        keys = prefix_keys(digest["fingerprint"], adapter, prompt, block_size)
        n = 0
        for k in keys:
            if k.hex() not in digest["keys"]:
                break
            n += 1
        # the admission tail always keeps >= 1 prompt token, so a
        # full-prompt chain is worth at most len(prompt) - 1 cached
        # tokens on the replica — mirror that here
        return min(n * block_size, max(len(prompt) - 1, 0))

    def select(
        self,
        prompt,
        adapter: Optional[str] = None,
        session_id: Optional[str] = None,
        _exclude: Optional[str] = None,
    ) -> str:
        """Pick a replica name for this request (placement only — the
        deployment's ingress does the submission when replicas are
        HTTP handles). Raises ``RuntimeError`` when no live,
        non-draining replica exists."""
        if self.placement == "disagg":
            # prompts only ever land on the prefill pool — decode
            # replicas take work exclusively through manifest hand-off
            routable = self._pool("prefill", exclude=_exclude)
            if not routable:
                raise RuntimeError(
                    "no live non-draining prefill replica to route to"
                )
        else:
            routable = self._routable(exclude=_exclude)
            if not routable:
                raise RuntimeError(
                    "no live non-draining replica to route to"
                )
        if self.session_affinity and session_id is not None:
            pinned = self._sessions.get(session_id)
            if pinned is not None:
                rep = self._replicas.get(pinned)
                if (
                    rep is not None and rep.alive and not rep.draining
                    and pinned != _exclude
                ):
                    self._sessions.move_to_end(session_id)
                    return pinned
                # pinned replica shed/drained/died: graceful spill
                self.session_spills_total += 1
        cands = []
        for rep in routable:
            snap = self._snapshot(rep)
            overlap = (
                self._overlap_tokens(rep, prompt, adapter)
                if getattr(self.policy, "needs_overlap", False) else 0
            )
            cands.append(
                Candidate(
                    name=rep.name, order=self._order[rep.name],
                    snapshot=snap, overlap_tokens=overlap,
                )
            )
        choice = self.policy.choose(cands).name
        if self.session_affinity and session_id is not None:
            self._sessions[session_id] = choice
            self._sessions.move_to_end(session_id)
            while len(self._sessions) > self.max_sessions:
                self._sessions.popitem(last=False)
        return choice

    # ------------------------------------------------------------------ #
    # the harness-facing engine surface
    # ------------------------------------------------------------------ #
    def add_request(
        self,
        prompt,
        max_new_tokens: int = 32,
        temperature: float = 0.0,
        eos_token_id: Optional[int] = None,
        request_id: str = "",
        adapter: Optional[str] = None,
        priority: int = 0,
        session_id: Optional[str] = None,
        _exclude: Optional[str] = None,
    ) -> str:
        name = self.select(
            prompt, adapter=adapter, session_id=session_id,
            _exclude=_exclude,
        )
        rid = self._replicas[name].add_request(
            prompt,
            max_new_tokens=max_new_tokens,
            temperature=temperature,
            eos_token_id=eos_token_id,
            request_id=request_id,
            adapter=adapter,
            priority=priority,
        )
        self.routed_total += 1
        self.routed_by_replica[name] = self.routed_by_replica.get(name, 0) + 1
        self._placements[rid] = name
        while len(self._placements) > self._max_placements:
            self._placements.popitem(last=False)
        return rid

    def step(self) -> list:
        """One fleet iteration: eject replicas whose health went bad
        (re-queueing what can be saved), then step every live replica
        that is not chaos-slowed. Returns the merged token events."""
        self._eject_unhealthy()
        now = self._now()
        events: list = []
        for name, rep in self._replicas.items():
            if not rep.alive:
                continue
            until = self._slow_until.get(name)
            if until is not None:
                if now < until:
                    continue
                del self._slow_until[name]
            if rep.has_work:
                out = rep.step()
                if out:
                    events.extend(out)
        if self.placement == "disagg":
            self._pump_transfers()
        return events

    @property
    def has_work(self) -> bool:
        if any(r.alive and r.has_work for r in self._replicas.values()):
            return True
        # in-flight hand-offs are work: a manifest in the ledger still
        # owes the fleet a seated decode (or a re-queue)
        return any(
            rec.state in ("pending", "stalled") for rec in self._transfers
        )

    # ------------------------------------------------------------------ #
    # KV hand-off (disagg placement)
    # ------------------------------------------------------------------ #
    def _pump_transfers(self) -> None:
        """Harvest finished prefills into the in-flight ledger, then
        deliver each manifest to the decode replica with the deepest
        cached-chain overlap (least-loaded tie-break). Delivery honors
        an active ``transfer_stall`` window; a dead/refusing endpoint
        just means the record stays pending for the next pump — and if
        the decode pool is gone entirely, the prompt re-queues."""
        now = self._now()
        for name, rep in self._replicas.items():
            if not rep.alive:
                continue
            pop = getattr(getattr(rep, "engine", None), "pop_manifests", None)
            if pop is None:
                continue
            for m in pop():
                m.src = name
                self._transfers.append(
                    _TransferRecord(manifest=m, started_at=now)
                )
        if not self._transfers:
            return
        decodes = self._pool("decode")
        done: list[_TransferRecord] = []
        for rec in self._transfers:
            if rec.state not in ("pending", "stalled"):
                done.append(rec)
                continue
            if self._stalled(rec, now):
                rec.state = "stalled"
                continue
            was_stalled = rec.state == "stalled"
            rec.state = "pending"
            if not decodes:
                # decode pool gone: the chain has no destination — give
                # the prompt back to the prefill pool instead of
                # stranding the request in the ledger forever
                self._drop_record(rec, now, reason="no_decode_replica")
                done.append(rec)
                continue
            if self._deliver(rec, decodes, now):
                if was_stalled and self._transfer_stall_started is not None:
                    self.transfer_stall_recovery_s = max(
                        self.transfer_stall_recovery_s,
                        now - self._transfer_stall_started,
                    )
                done.append(rec)
        for rec in done:
            self._transfers.remove(rec)

    def _stalled(self, rec: _TransferRecord, now: float) -> bool:
        if now >= self._transfer_stall_until:
            return False
        src = self._transfer_stall_src
        return src is None or rec.manifest.src == src

    def _deliver(
        self, rec: _TransferRecord, decodes: list, now: float
    ) -> bool:
        m = rec.manifest
        ranked = []
        for rep in decodes:
            digest = self._digest(rep)
            overlap = 0
            if digest and digest["keys"]:
                for k in m.keys:
                    if k.hex() not in digest["keys"]:
                        break
                    overlap += 1
            snap = self._snapshot(rep)
            ranked.append(
                (-overlap, load_score(snap), self._order[rep.name], rep)
            )
        ranked.sort(key=lambda t: t[:3])
        for _, _, _, rep in ranked:
            rec.attempts += 1
            try:
                res = rep.engine.acquire(m)
            except Exception:
                continue  # endpoint died mid-delivery: try the next
            rec.state = "delivered"
            rec.dst = rep.name
            rec.done_at = now
            rec.moved_blocks = int(res.get("moved_blocks", m.n_blocks))
            rec.deduped_blocks = int(res.get("reused_blocks", 0))
            rec.moved_bytes = int(
                res.get("moved_bytes", m.bytes_per_block() * rec.moved_blocks)
            )
            self.transfers_delivered_total += 1
            # the request now lives on the decode replica: result() and
            # shed_reason() must resolve there
            self._placements[m.request_id] = rep.name
            self._placements.move_to_end(m.request_id)
            ms = (now - rec.started_at) * 1000.0
            self._transfer_log[m.request_id] = {
                "src": m.src,
                "dst": rep.name,
                "transfer_ms": ms,
                "bytes": rec.moved_bytes,
                "blocks_moved": rec.moved_blocks,
                "blocks_deduped": rec.deduped_blocks,
                "attempts": rec.attempts,
            }
            while len(self._transfer_log) > self._max_transfer_log:
                self._transfer_log.popitem(last=False)
            self._transfer_trace.append({
                "request_id": m.request_id,
                "src": m.src,
                "dst": rep.name,
                "state": "delivered",
                "started_at": rec.started_at,
                "done_at": now,
                "bytes": rec.moved_bytes,
                "blocks": rec.moved_blocks,
            })
            if self.transfer_plane is not None:
                self.transfer_plane.record_delivery(
                    m,
                    src=m.src,
                    dst=rep.name,
                    moved_blocks=rec.moved_blocks,
                    deduped_blocks=rec.deduped_blocks,
                    moved_bytes=rec.moved_bytes,
                    ms=ms,
                )
            return True
        return False

    def _drop_record(
        self, rec: _TransferRecord, now: float, reason: str
    ) -> None:
        rec.state = "dropped"
        rec.done_at = now
        self.transfers_dropped_total += 1
        self._transfer_trace.append({
            "request_id": rec.manifest.request_id,
            "src": rec.manifest.src,
            "dst": None,
            "state": "dropped",
            "reason": reason,
            "started_at": rec.started_at,
            "done_at": now,
            "bytes": 0,
            "blocks": 0,
        })
        if self.transfer_plane is not None:
            self.transfer_plane.record_drop(rec.manifest, reason)
        # a TransferManifest duck-types as a Request for _requeue (same
        # prompt/knob/id attributes) — the prompt re-prefills from
        # scratch on the prefill pool, preserving its request_id
        self._requeue([rec.manifest])

    def stall_transfers(
        self, secs: float, replica: Optional[str] = None
    ) -> None:
        """``transfer_stall`` chaos: wedge hand-off delivery for
        ``secs`` (all sources, or just ``replica``'s outbound). Seated
        decodes are untouched — only the ledger waits."""
        now = self._now()
        self._transfer_stall_until = now + max(0.0, secs)
        self._transfer_stall_src = replica
        self._transfer_stall_started = now
        self.transfer_stalls_total += 1
        if self.transfer_plane is not None:
            self.transfer_plane.record_stall(max(0.0, secs), replica)

    def drop_transfers(self, replica: Optional[str] = None) -> dict:
        """``transfer_drop`` chaos: every in-flight hand-off (or just
        ``replica``'s outbound) is lost on the wire. Damage is bounded
        to a re-queue: each dropped chain's prompt goes back to the
        prefill pool under its original request id."""
        now = self._now()
        dropped = 0
        for rec in list(self._transfers):
            if rec.state not in ("pending", "stalled"):
                continue
            if replica is not None and rec.manifest.src != replica:
                continue
            self._drop_record(rec, now, reason="chaos_drop")
            self._transfers.remove(rec)
            dropped += 1
        return {"dropped": dropped}

    def transfer_record(self, request_id: str) -> Optional[dict]:
        """Per-request hand-off accounting (None = never transferred)."""
        return self._transfer_log.get(request_id)

    def transfer_summary(self) -> dict:
        """The soak report's ``transfer`` section: plane totals plus
        the fleet's per-role hand-off gauges and the ledger posture.
        Empty for a colocated fleet that never handed anything off —
        pre-disagg soak reports keep their exact shape."""
        if (
            self.placement != "disagg"
            and self.transfer_plane is None
            and not self._transfers
            and not self.transfers_delivered_total
        ):
            return {}
        per_replica = {}
        for name, rep in self._replicas.items():
            fn = getattr(getattr(rep, "engine", None), "transfer_gauges",
                         None)
            role = self._role_of(rep)
            if fn is None or role == "colocated":
                continue
            per_replica[name] = dict(fn(), role=role)
        return {
            "placement": self.placement,
            "plane": (
                self.transfer_plane.summary()
                if self.transfer_plane is not None else None
            ),
            "in_flight": sum(
                1 for rec in self._transfers
                if rec.state in ("pending", "stalled")
            ),
            "delivered_total": self.transfers_delivered_total,
            "dropped_total": self.transfers_dropped_total,
            "stalls_total": self.transfer_stalls_total,
            "stall_recovery_s": self.transfer_stall_recovery_s,
            "replicas": per_replica,
        }

    def export_trace(self, path: str) -> str:
        """Merge every replica's span log (plus the retained KV
        hand-off ledger slices) into ONE Chrome-trace/Perfetto JSON at
        ``path``: a named process row per replica and a ``kv-transfer``
        row, all referenced to the fleet's shared clock origin — a
        disaggregated request's prefill → transfer → decode hand-off
        reads left-to-right on a single timeline. Returns ``path``."""
        from ..serving.spans import spans_to_chrome_trace

        per_replica: list = []
        for name, rep in self._replicas.items():
            log = getattr(getattr(rep, "engine", None), "span_log", None)
            if log is None:
                continue
            spans = list(log.closed) + log.open_spans
            per_replica.append((name, spans))
        origin = min(
            [s.submit_t for _, spans in per_replica for s in spans]
            + [t["started_at"] for t in self._transfer_trace],
            default=0.0,
        )

        def us(t: float) -> float:
            return (t - origin) * 1e6

        events: list = []
        for pid, (name, spans) in enumerate(per_replica):
            events.append({
                "ph": "M", "name": "process_name", "pid": pid,
                "args": {"name": name},
            })
            payload = spans_to_chrome_trace(
                spans, process_index=pid, time_origin=origin,
            )
            events.extend(payload["traceEvents"])
        if self._transfer_trace:
            tpid = len(per_replica)
            events.append({
                "ph": "M", "name": "process_name", "pid": tpid,
                "args": {"name": "kv-transfer"},
            })
            for tid, t in enumerate(self._transfer_trace):
                events.append({
                    "ph": "M", "name": "thread_name", "pid": tpid,
                    "tid": tid, "args": {"name": t["request_id"]},
                })
                slice_name = (
                    f"transfer:{t['src']}->{t['dst']}"
                    if t["state"] == "delivered"
                    else f"transfer-drop:{t.get('reason')}"
                )
                events.append({
                    "ph": "X", "name": slice_name, "cat": "transfer",
                    "pid": tpid, "tid": tid,
                    "ts": us(t["started_at"]),
                    "dur": max(us(t["done_at"]) - us(t["started_at"]), 0.0),
                    "args": {
                        k: t.get(k)
                        for k in ("request_id", "src", "dst", "state",
                                  "bytes", "blocks")
                    },
                })
        with open(path, "w") as f:
            json.dump(
                {"traceEvents": events, "displayTimeUnit": "ms"}, f,
            )
        return path

    def result(self, request_id: str):
        name = self._placements.get(request_id)
        if name is not None and name in self._replicas:
            return self._replicas[name].result(request_id)
        for rep in self._replicas.values():
            out = rep.result(request_id)
            if out is not None:
                return out
        return None

    def shed_reason(self, request_id: str):
        name = self._placements.get(request_id)
        if name is not None and name in self._replicas:
            return self._replicas[name].shed_reason(request_id)
        for rep in self._replicas.values():
            out = rep.shed_reason(request_id)
            if out is not None:
                return out
        return None

    def trace_counts(self) -> dict:
        """Fleet-merged compiled-program counts. Dead replicas keep
        contributing their final counts — a kill must never make the
        zero-retrace delta go negative."""
        merged: dict[str, int] = {}
        for rep in self._all_replicas():
            fn = getattr(rep.engine, "trace_counts", None)
            if fn is None:
                continue
            for prog, n in fn().items():
                merged[prog] = merged.get(prog, 0) + n
        return merged

    def set_observability(
        self,
        *,
        telemetry: Any = None,
        gauge_interval: int = 1,
        slo: Any = None,
        spans: bool = True,
    ) -> None:
        """Attach ONE observability plane to the whole fleet: every
        replica engine tees into the same collector and the same
        :class:`~..serving.SloTracker` (fleet-level SLO
        attainment — a burn on any replica is a burn on the fleet)."""
        tracker = None
        if slo is not None:
            from ..serving.slo import SloTracker

            tracker = slo if isinstance(slo, SloTracker) else SloTracker(slo)
        self.slo_tracker = tracker
        for rep in self._all_replicas():
            setter = getattr(rep.engine, "set_observability", None)
            if setter is not None:
                setter(
                    telemetry=telemetry, gauge_interval=gauge_interval,
                    slo=tracker, spans=spans,
                )

    slo_tracker: Any = None

    def _all_replicas(self):
        return self._replicas.values()

    # ------------------------------------------------------------------ #
    # reporting
    # ------------------------------------------------------------------ #
    def router_summary(self) -> dict:
        """The soak report's ``router`` section: placement policy,
        per-replica posture, and the re-route ledger (what a kill or
        drain re-queued vs lost)."""
        reps = []
        for name, rep in self._replicas.items():
            try:
                state = rep.health().get("state", "serving")
            except Exception:
                state = "unreachable"
            reps.append({
                "name": name,
                "state": state,
                "routed": self.routed_by_replica.get(name, 0),
            })
        return {
            "policy": getattr(self.policy, "name", type(self.policy).__name__),
            "session_affinity": self.session_affinity,
            "replicas_total": len(self._replicas),
            "replicas_alive": sum(
                1 for r in self._replicas.values() if r.alive
            ),
            "replicas": reps,
            "routed_total": self.routed_total,
            "rerouted_total": self.rerouted_total,
            "requests_requeued": self.requests_requeued,
            "requests_lost": self.requests_lost,
            "ejections_total": self.ejections_total,
            "session_spills_total": self.session_spills_total,
            "sessions_tracked": len(self._sessions),
            "stale_snapshot_routes_total": self.stale_snapshot_routes_total,
        }
