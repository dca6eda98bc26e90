"""Chaos adapter: the fault-injection grammar pointed at a live engine.

Host-only copy of ``accelerate_tpu/loadgen/chaos.py``. The serving faults
are ones the engine is meant to absorb, with the damage measured:

* ``stall_decode@step:secs=N``: wedges the decode loop for N seconds. The
  harness keeps submitting arrivals on schedule while stalled, so the
  fault shows as queue growth, arrival lag, TTFT misses and burn.
* ``pool_pressure@step[:secs=N]``: pins half the free KV blocks through
  ``engine.pool`` so admission sees a nearly full pool; released after
  ``secs`` (or at :meth:`ChaosAdapter.release`).
* ``adapter_churn@step``: loads a capacity-full wave of throwaway
  adapters, evicting every resident tenant with no request in flight
  (tenants in flight are pinned by their refcounts and survive);
  :meth:`ChaosAdapter.release` calls the ``restore`` callback so the
  harness reloads its tenants. On an engine without an adapter registry the
  fault is recorded as skipped (``no_adapter_registry``).
* ``replica_kill``/``replica_slow`` and ``transfer_stall``/
  ``transfer_drop``: fleet and disaggregation faults. They act on an
  engine that has a router's ``replicas``/``kill``/``slow`` or the
  transfer plane's ``stall_transfers``/``drop_transfers``; on a single
  engine they are recorded as skipped (``not_a_fleet``,
  ``not_a_disagg_fleet``).

Handlers install on a :class:`FaultInjector` through ``install_handler``;
spec steps are engine steps counted from the fault window's first step.
"""


from __future__ import annotations

from typing import Callable, Optional

from ..test_utils.fault_injection import (
    SERVING_ACTIONS,
    FaultInjector,
    FaultSpec,
)

#: stall length when a spec omits ``secs=`` — a serving stall must
#: always end (the process-fatal "forever" semantics belong to hang)
DEFAULT_STALL_SECS = 1.0

_MAX_EVENTS = 64  # bounded event log: a soak runs for minutes


class ChaosAdapter:
    """Installs serving-fault handlers on ``injector`` and tracks the
    damage window. ``now`` is the harness clock (the same injectable
    clock the engine stamps from); ``restore`` re-loads the harness's
    tenant adapters after a churn."""

    def __init__(
        self,
        engine,
        injector: FaultInjector,
        now: Callable[[], float],
        restore: Optional[Callable[[], None]] = None,
    ):
        self.engine = engine
        self.injector = injector
        self._now = now
        self._restore = restore
        self._stall_until: float = float("-inf")
        self._pinned_blocks: list = []
        self._pin_release_at: Optional[float] = None
        self._churned = False
        self.events: list[dict] = []
        for action in SERVING_ACTIONS:
            injector.install_handler(action, getattr(self, "_on_" + action))

    # ------------------------------------------------------------------ #
    # the harness-facing surface
    # ------------------------------------------------------------------ #
    def stalled(self) -> bool:
        """True while the decode loop is wedged — the harness skips
        ``engine.step()`` but keeps submitting scheduled arrivals."""
        return self._now() < self._stall_until

    def poll(self) -> None:
        """Cheap per-iteration upkeep: release expired block pins."""
        if (
            self._pin_release_at is not None
            and self._now() >= self._pin_release_at
        ):
            self._release_pins()

    def release(self) -> None:
        """End the damage window: unpin blocks, restore churned
        tenants, clear any residual stall. Idempotent — the harness
        calls it at recovery entry AND from its ``finally``."""
        self._release_pins()
        self._stall_until = float("-inf")
        if self._churned and self._restore is not None:
            self._restore()
            self._churned = False

    def _event(self, action: str, **fields) -> None:
        if len(self.events) < _MAX_EVENTS:
            self.events.append(
                {"action": action, "time_s": self._now(), **fields}
            )

    # ------------------------------------------------------------------ #
    # handlers (called by FaultInjector._execute)
    # ------------------------------------------------------------------ #
    def _on_stall_decode(self, spec: FaultSpec) -> None:
        secs = spec.stall_secs or DEFAULT_STALL_SECS
        self._stall_until = self._now() + secs
        self._event("stall_decode", step=spec.step, secs=secs)

    def _on_pool_pressure(self, spec: FaultSpec) -> None:
        pool = getattr(self.engine, "pool", None)
        if pool is None:
            # a fleet router has no single pool; per-replica pressure
            # would need per-replica specs (not modeled yet)
            self._event("pool_pressure", step=spec.step, pinned=0,
                        skipped="no_pool")
            return
        n = pool.num_free // 2
        if n < 1:
            self._event("pool_pressure", step=spec.step, pinned=0,
                        skipped="no_free_blocks")
            return
        self._pinned_blocks.extend(pool.allocate(n))
        if spec.stall_secs:
            self._pin_release_at = self._now() + spec.stall_secs
        self._event("pool_pressure", step=spec.step, pinned=n,
                    secs=spec.stall_secs or None)

    def _release_pins(self) -> None:
        if self._pinned_blocks:
            self.engine.pool.free(self._pinned_blocks)
            self._event("pool_release", released=len(self._pinned_blocks))
            self._pinned_blocks = []
        self._pin_release_at = None

    def _on_adapter_churn(self, spec: FaultSpec) -> None:
        """Load a capacity-full wave of zero-weight adapters, evicting every
        resident tenant with no request in flight, then evict the wave
        again; the harness's ``restore`` reloads the tenants."""
        registry = getattr(self.engine, "adapters", None)
        if registry is None:
            self._event("adapter_churn", step=spec.step, loads=0,
                        skipped="no_adapter_registry")
            return
        params, cfg = zero_adapter(registry)
        evict_before = registry.evict_total
        loads = 0
        chaff = []
        for i in range(registry.capacity + 1):
            name = f"chaos-churn-{spec.step}-{i}"
            try:
                registry.load(name, params, cfg)
            except RuntimeError:
                break  # every row pinned by requests in flight: bounded
            chaff.append(name)
            loads += 1
        # the wave's own rows are freed again; real tenants stay evicted
        # until the harness's restore callback reloads them
        for name in chaff:
            if registry.resident(name):
                try:
                    registry.evict(name)
                except RuntimeError:
                    pass
        self._churned = bool(loads)
        self._event("adapter_churn", step=spec.step, loads=loads,
                    evictions=registry.evict_total - evict_before)

    # -- fleet faults (engine is a FleetRouter) ------------------------- #
    def _fleet_replica(self, action: str, spec: FaultSpec):
        """Resolve ``spec.replica`` against the router, or record why
        the fault was skipped (single-engine soaks stay inert)."""
        replicas = getattr(self.engine, "replicas", None)
        if replicas is None or not hasattr(self.engine, "kill"):
            self._event(action, step=spec.step, skipped="not_a_fleet")
            return None
        idx = spec.replica if spec.replica is not None else 0
        if not 0 <= idx < len(replicas):
            self._event(action, step=spec.step, replica=idx,
                        skipped="replica_out_of_range")
            return None
        return replicas[idx]

    def _on_replica_kill(self, spec: FaultSpec) -> None:
        rep = self._fleet_replica("replica_kill", spec)
        if rep is None:
            return
        outcome = self.engine.kill(rep.name)
        self._event(
            "replica_kill", step=spec.step, replica=rep.name,
            requeued=outcome["requeued"], lost=outcome["lost"],
        )

    def _on_replica_slow(self, spec: FaultSpec) -> None:
        rep = self._fleet_replica("replica_slow", spec)
        if rep is None:
            return
        secs = spec.stall_secs or DEFAULT_STALL_SECS
        self.engine.slow(rep.name, secs)
        self._event(
            "replica_slow", step=spec.step, replica=rep.name, secs=secs
        )

    # -- transfer faults (engine is a disagg FleetRouter) ---------------- #
    def _transfer_src(self, action: str, spec: FaultSpec):
        """Resolve the optional ``replica=`` source filter for a
        transfer fault: None targets ALL in-flight hand-offs. Returns
        ``(ok, name)`` — a non-disagg engine skips with an event, like
        the fleet faults on a single engine."""
        if not hasattr(self.engine, "stall_transfers"):
            self._event(action, step=spec.step, skipped="not_a_disagg_fleet")
            return False, None
        if spec.replica is None:
            return True, None
        replicas = getattr(self.engine, "replicas", None) or []
        if not 0 <= spec.replica < len(replicas):
            self._event(action, step=spec.step, replica=spec.replica,
                        skipped="replica_out_of_range")
            return False, None
        return True, replicas[spec.replica].name

    def _on_transfer_stall(self, spec: FaultSpec) -> None:
        ok, name = self._transfer_src("transfer_stall", spec)
        if not ok:
            return
        secs = spec.stall_secs or DEFAULT_STALL_SECS
        self.engine.stall_transfers(secs, replica=name)
        self._event(
            "transfer_stall", step=spec.step, replica=name, secs=secs
        )

    def _on_transfer_drop(self, spec: FaultSpec) -> None:
        ok, name = self._transfer_src("transfer_drop", spec)
        if not ok:
            return
        outcome = self.engine.drop_transfers(replica=name)
        self._event(
            "transfer_drop", step=spec.step, replica=name,
            dropped=outcome["dropped"],
        )


def zero_adapter(registry) -> tuple:
    """A rank-1 adapter with every weight 0 over the registry's targets,
    and its config: the soak's tenants and the churn's chaff, as in the
    reference (a valid resident whose delta is exactly 0)."""
    import numpy as np

    from ..adapters.lora import LoraConfig, target_shapes

    shapes = target_shapes(registry.model_config)
    layers = registry.model_config.num_layers
    params = {t: {"lora_a": np.zeros((layers, shapes[t][0], 1), np.float32),
                  "lora_b": np.zeros((layers, 1, shapes[t][1]), np.float32)}
              for t in registry.target_modules}
    return params, LoraConfig(rank=1, alpha=1.0, target_modules=registry.target_modules)
