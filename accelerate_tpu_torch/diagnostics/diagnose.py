"""Post-mortem aggregation: turn per-host flight-recorder dumps and
heartbeat files into one report.

Port of ``accelerate_tpu/diagnostics/diagnose.py``, copied so that the
report and its text are the reference's: it reads the port's
``checkpoint_async/commit.py`` and ``loadgen/report.py``. The OOM section
reads ``profiling/oom.py``, which is not ported yet (ROADMAP.md, queue
A10), so its lazy import fails and the section stays None, as the
reference's ``try`` allows.

``diagnose <dir>`` answers the three questions an
operator asks after a multi-host job dies or hangs:

* **who stopped first** — merge heartbeat staleness with each dump's
  ``last_step``: among the stale ranks, the one with the *lowest* last
  completed step stopped first (everyone else stalled behind it at the
  next collective);
* **where can I restart from** — the newest checkpoint any rank saw
  committed, cross-checked against the on-disk ``COMMITTED`` marker when
  the directory is reachable;
* **where did the time go** — the fleet badput breakdown summed from
  each dump's goodput snapshot, plus anomaly/exception counts.

Pure functions over files — nothing here touches the accelerator, so
the CLI works on a dead job's artifacts from any machine that can read
the directory.
"""

from __future__ import annotations

import os
from typing import Any, Optional

from ..telemetry.heartbeat import scan_heartbeats
from .flight_recorder import list_dumps
from .goodput import BADPUT_BUCKETS, BUCKETS


def _checkpoint_status(path: Optional[str]) -> Optional[bool]:
    """True/False when the checkpoint dir is reachable, None when not
    (diagnose often runs off-cluster against copied dump dirs)."""
    if not path or not os.path.isdir(path):
        return None
    try:
        from ..checkpoint_async.commit import is_committed

        return bool(is_committed(path))
    except Exception:
        return None


def build_report(dir: str, stall_timeout_s: float = 300.0) -> dict:
    """Aggregate ``dir``'s flight-recorder dumps + heartbeat files."""
    dumps = list_dumps(dir)
    heartbeats = scan_heartbeats(dir, stall_timeout_s=stall_timeout_s)

    ranks: dict[int, dict[str, Any]] = {}
    for rank in sorted(set(dumps) | set(heartbeats)):
        dump = dumps.get(rank)
        hb = heartbeats.get(rank)
        info: dict[str, Any] = {"rank": rank}
        if dump is not None:
            info.update(
                last_step=dump.get("last_step"),
                dump_reason=dump.get("reason"),
                dump_time_unix=dump.get("time_unix"),
                dump_count=dump.get("dumps"),
            )
        if hb is not None:
            info.update(
                heartbeat_age_s=hb.get("age_s"),
                stale=hb.get("stale"),
                stalled_self=hb.get("stalled"),
                fault_domain=hb.get("fault_domain"),
            )
            if info.get("last_step") is None:
                info["last_step"] = hb.get("step")
        ranks[rank] = info

    # --- who stopped first --------------------------------------------- #
    stale = [r for r in ranks.values() if r.get("stale")]
    candidates = stale or (list(ranks.values()) if heartbeats == {} else [])
    straggler = None
    if candidates:
        with_step = [r for r in candidates if r.get("last_step") is not None]
        if with_step:
            steps = {r["last_step"] for r in with_step}
            # a uniform last_step across a dump-only report is a clean
            # shutdown, not a straggler
            if stale or len(steps) > 1:
                straggler = min(with_step, key=lambda r: r["last_step"])
        elif stale:
            straggler = stale[0]

    # --- where can I restart from -------------------------------------- #
    checkpoints = [
        d["last_checkpoint"] for d in dumps.values() if d.get("last_checkpoint")
    ]
    last_checkpoint = None
    if checkpoints:
        last_checkpoint = max(
            checkpoints,
            key=lambda c: (c.get("step") or -1, c.get("time_unix") or 0.0),
        )
        last_checkpoint = dict(last_checkpoint)
        last_checkpoint["committed"] = _checkpoint_status(last_checkpoint.get("dir"))

    # --- can the survivors restart (elastic verdict) ------------------- #
    # who is still beating vs the newest committed checkpoint's saved
    # topology: names how many ranks an elastic relaunch would have, and
    # whether that relaunch is a reshaped (N -> M) restore.
    elastic = None
    if heartbeats:
        survivors = sorted(
            r
            for r, info in ranks.items()
            if info.get("heartbeat_age_s") is not None and not info.get("stale")
        )
        # hierarchical topologies: group ranks by the fault_domain their
        # heartbeats carry — a slice whose EVERY heartbeat-bearing rank is
        # stale is a lost slice, and the relaunch verdict names it
        domains: dict[int, list[dict[str, Any]]] = {}
        for info in ranks.values():
            fd = info.get("fault_domain")
            if fd is not None:
                domains.setdefault(int(fd), []).append(info)
        lost_slices = sorted(
            d
            for d, members in domains.items()
            if all(m.get("stale") for m in members)
        )
        elastic = {
            "survivors": survivors,
            "num_survivors": len(survivors),
            "num_ranks": len(ranks),
            "num_slices": len(domains) if domains else None,
            "lost_slices": lost_slices,
            "saved_topology": None,
            "needs_reshape": None,
            "restartable": None,
        }
        ck = last_checkpoint or {}
        if ck.get("dir") and ck.get("committed"):
            try:
                from ..checkpoint_async.commit import read_topology

                topo = read_topology(ck["dir"])
            except Exception:
                topo = None
            if topo is not None:
                elastic["saved_topology"] = {
                    "world_size": topo.get("world_size"),
                    "num_devices": topo.get("num_devices"),
                    "num_slices": topo.get("num_slices"),
                    "step": topo.get("step"),
                }
                if topo.get("num_slices"):
                    # save-time slice count is authoritative (heartbeats
                    # only cover ranks that ever beat)
                    elastic["num_slices"] = int(topo["num_slices"])
                elastic["needs_reshape"] = (
                    topo.get("world_size") != len(survivors)
                )
            elastic["restartable"] = len(survivors) >= 1
        elif ck.get("committed") is False:
            elastic["restartable"] = False
        # committed None (dir unreachable / no checkpoint recorded):
        # restartable stays None — "cannot verify from here"

    # --- where did the time go ----------------------------------------- #
    goodput_pcts = []
    badput: dict[str, float] = {b: 0.0 for b in BUCKETS}
    for dump in dumps.values():
        snap = dump.get("goodput")
        if not snap:
            continue
        if snap.get("goodput_pct") is not None:
            goodput_pcts.append(snap["goodput_pct"])
        for bucket, seconds in (snap.get("buckets") or {}).items():
            if bucket in badput:
                badput[bucket] += float(seconds)

    anomalies: dict[str, int] = {}
    exceptions: list[dict] = []
    stalls = 0
    for rank, dump in dumps.items():
        for ev in dump.get("events", []):
            kind = ev.get("event")
            if kind == "anomaly":
                t = ev.get("anomaly_type", "unknown")
                anomalies[t] = anomalies.get(t, 0) + 1
            elif kind == "exception":
                exceptions.append({"rank": rank, **ev})
            elif kind == "heartbeat_stall":
                stalls += 1

    # --- how was the serving plane doing -------------------------------- #
    # latest serve_gauge/slo record per rank in each dump's flight ring:
    # queue/slot/pool posture at death, cumulative shed totals, and SLO
    # attainment. Only present when serving records exist (training-only
    # jobs keep the old report shape).
    serving: dict[int, dict[str, Any]] = {}
    for rank, dump in dumps.items():
        gauge = slo = None
        shed_in_ring = 0
        for rec in dump.get("records", []):
            kind = rec.get("kind")
            if kind == "serve_gauge":
                gauge = rec  # records are in order: keep the latest
            elif kind == "slo":
                slo = rec
            elif kind == "shed":
                shed_in_ring += 1
        if gauge is None and slo is None and shed_in_ring == 0:
            continue
        entry: dict[str, Any] = {"shed_records_in_ring": shed_in_ring}
        if gauge is not None:
            for key in (
                "engine_steps", "queue_depth", "queue_age_p95_s",
                "slots_active", "slot_occupancy", "pool_utilization",
                "tokens_in_flight",
                "prefix_cache_hit_rate", "shared_blocks",
                "cow_copies_total", "prefill_tokens_saved_total",
                "spec_rounds", "spec_tokens_proposed",
                "spec_tokens_accepted", "spec_accept_rate",
                "admission_blocked_no_free_slot_total",
                "admission_blocked_pool_exhausted_total",
                "shed_queue_full_total", "shed_queue_deadline_total",
                "swapped_blocks", "swapped_requests", "swap_bytes_held",
                "preempts_total", "preempts_priority_total",
                "preempts_pool_total", "preempts_growth_total",
                "resumes_total", "prefill_chunks_total",
                "kv_bytes_per_token",
            ):
                entry[key] = gauge.get(key)
        if slo is not None:
            for key in (
                "target", "ttft_attainment", "e2e_attainment",
                "ttft_objective_s", "e2e_objective_s",
                "max_burn_rate", "breach",
            ):
                entry[f"slo_{key}"] = slo.get(key)
        serving[rank] = entry

    # --- where did the memory go ---------------------------------------- #
    # latest kind="memory" census per rank from each dump's flight ring
    # (resident-byte posture at death, by owner), the newest step record
    # carrying a top-ops breakdown, and the OOM autopsy when one landed
    # in the dump dir. Only present when memory records/autopsies exist.
    memory: dict[int, dict[str, Any]] = {}
    top_ops: Optional[dict[str, Any]] = None
    for rank, dump in dumps.items():
        mem = None
        for rec in dump.get("records", []):
            kind = rec.get("kind")
            if kind == "memory":
                mem = rec  # records are in order: keep the latest
            elif kind == "step" and rec.get("top_ops"):
                top_ops = {
                    "rank": rank,
                    "step": rec.get("step"),
                    "ops": rec["top_ops"],
                }
        if mem is None:
            continue
        memory[rank] = {
            key: mem.get(key)
            for key in (
                "step", "census_total_bytes", "census_unowned_bytes",
                "census_owner_bytes", "census_arrays",
                "hbm_bytes_in_use", "peak_hbm_bytes", "hbm_bytes_limit",
                "host_rss_bytes", "host_rss_peak_bytes",
            )
        }
    # --- what did the compiler actually emit ----------------------------- #
    # latest kind="audit" record per program per rank from each dump's
    # flight ring: the sharding X-ray's collective inventory + contract
    # verdict. Only present when auditing ran (default-on at warmup /
    # capture, so normally every rank has at least the train step).
    sharding: dict[int, dict[str, Any]] = {}
    for rank, dump in dumps.items():
        programs: dict[str, dict[str, Any]] = {}
        violations: list[dict[str, Any]] = []
        for rec in dump.get("records", []):
            if rec.get("kind") != "audit":
                continue
            program = str(rec.get("program") or rec.get("label") or "?")
            programs[program] = {  # records are in order: keep the latest
                key: rec.get(key)
                for key in (
                    "num_collectives", "by_kind", "ici_bytes", "dcn_bytes",
                    "total_bytes_moved", "contract_origin", "clean",
                )
            }
            for v in rec.get("violations") or []:
                if isinstance(v, dict):
                    violations.append({"program": program, **v})
        if programs:
            sharding[rank] = {
                "programs": programs,
                "violations": violations,
            }

    oom_report = None
    try:
        from ..profiling.oom import read_oom_report

        oom_report = read_oom_report(dir)
    except Exception:
        oom_report = None

    # --- did a soak run against this job --------------------------------- #
    # soak-report*.json files the loadgen harness wrote into the dump dir:
    # the phase table, goodput-under-SLO headline and measured fault damage,
    # keyed by the writing rank. Only present when a soak actually ran.
    soak: dict[int, dict[str, Any]] = {}
    try:
        from ..loadgen.report import read_report as _read_soak

        for name in sorted(os.listdir(dir)):
            if not (name.startswith("soak-report") and name.endswith(".json")):
                continue
            rep = _read_soak(os.path.join(dir, name))
            if rep is not None:
                soak[int(rep.get("rank") or 0)] = rep
    except Exception:
        soak = {}

    return {
        "dir": dir,
        "num_ranks": len(ranks),
        "num_dumps": len(dumps),
        "num_heartbeats": len(heartbeats),
        "ranks": {r: ranks[r] for r in sorted(ranks)},
        "straggler": straggler,
        "last_checkpoint": last_checkpoint,
        "elastic": elastic,
        "goodput_pct": (
            sum(goodput_pcts) / len(goodput_pcts) if goodput_pcts else None
        ),
        "badput_s": badput,
        "anomalies": anomalies,
        "heartbeat_stalls": stalls,
        "exceptions": exceptions,
        "serving": serving,
        "soak": soak,
        "memory": memory,
        "top_ops": top_ops,
        "oom_report": oom_report,
        "sharding": sharding,
    }


def _fmt_bytes(n: Any) -> str:
    if n is None:
        return "n/a"
    value = float(n)
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(value) < 1024.0:
            return f"{value:.0f}{unit}" if unit == "B" else f"{value:.1f}{unit}"
        value /= 1024.0
    return f"{value:.1f}TiB"


def format_report(report: dict) -> str:
    """Human-readable rendering of :func:`build_report`'s output."""
    lines = [
        f"accelerate-tpu diagnose: {report['dir']}",
        f"  ranks seen: {report['num_ranks']} "
        f"({report['num_dumps']} flight dump(s), "
        f"{report['num_heartbeats']} heartbeat(s))",
        "",
    ]

    straggler = report.get("straggler")
    if straggler is not None:
        age = straggler.get("heartbeat_age_s")
        lines.append(
            f"STRAGGLER: rank {straggler['rank']} stopped first "
            f"(last step {straggler.get('last_step')}"
            + (f", heartbeat silent {age:.0f}s" if age is not None else "")
            + ")"
        )
    elif any(r.get("stale") for r in report["ranks"].values()):
        lines.append("STALLED: stale ranks found but none could be ordered")
    else:
        lines.append("No straggler: all ranks current or shut down cleanly.")

    ckpt = report.get("last_checkpoint")
    if ckpt is not None:
        status = {True: "committed", False: "NOT COMMITTED", None: "unverified"}[
            ckpt.get("committed")
        ]
        lines.append(
            f"Last checkpoint: step {ckpt.get('step')} at {ckpt.get('dir')} "
            f"[{status}]"
        )
    else:
        lines.append("Last checkpoint: none recorded")

    elastic = report.get("elastic")
    if elastic is not None:
        m, n = elastic["num_survivors"], elastic["num_ranks"]
        lost = elastic.get("lost_slices") or []
        num_slices = elastic.get("num_slices") or 1
        if elastic["restartable"] and lost and num_slices > 1:
            # hierarchical topology: the unit of failure is a slice, and
            # the verdict names which one(s) the survivors re-form without
            noun = "slices" if len(lost) > 1 else "slice"
            ids = ",".join(str(s) for s in lost)
            line = (
                f"Elastic: {noun} {ids} of {num_slices} lost; RESTARTABLE "
                f"as {max(num_slices - len(lost), 1)}-slice reshaped restore"
            )
            topo = elastic.get("saved_topology")
            if topo is not None:
                line += f" from step {topo.get('step')}"
            line += f" ({m} survivor(s) of {n})"
            lines.append(line)
        elif elastic["restartable"]:
            line = f"Elastic: RESTARTABLE with {m} survivor(s) of {n}"
            topo = elastic.get("saved_topology")
            if topo is not None:
                line += f" from step {topo.get('step')}"
                if elastic.get("needs_reshape"):
                    line += (
                        f" (reshaped restore: checkpoint topology is "
                        f"world_size={topo.get('world_size')} — relaunch "
                        f"under --elastic or load_state(allow_reshape=True))"
                    )
            lines.append(line)
        elif elastic["restartable"] is False:
            lines.append(
                f"Elastic: NOT restartable — {m} survivor(s) of {n} but no "
                "committed checkpoint to resume from"
            )
        else:
            lines.append(
                f"Elastic: {m} survivor(s) of {n}; checkpoint not verifiable "
                "from here"
            )

    gp = report.get("goodput_pct")
    lines.append("")
    lines.append(
        "Goodput: " + (f"{gp:.1f}% productive" if gp is not None else "no data")
    )
    badput = report.get("badput_s") or {}
    total_bad = sum(badput.get(b, 0.0) for b in BADPUT_BUCKETS)
    if total_bad > 0:
        lines.append("Badput breakdown (fleet seconds):")
        for bucket in BADPUT_BUCKETS:
            seconds = badput.get(bucket, 0.0)
            pct = 100.0 * seconds / total_bad
            lines.append(f"  {bucket:<11} {seconds:10.1f}s  ({pct:4.1f}% of badput)")

    anomalies = report.get("anomalies") or {}
    if anomalies:
        parts = ", ".join(f"{t}={n}" for t, n in sorted(anomalies.items()))
        lines.append(f"Anomalies: {parts}")

    serving = report.get("serving") or {}
    if serving:
        lines.append("")
        lines.append("Serving (latest posture per rank):")
        for rank in sorted(serving):
            s = serving[rank]
            shed_full = s.get("shed_queue_full_total") or 0
            shed_deadline = s.get("shed_queue_deadline_total") or 0
            occupancy = s.get("slot_occupancy")
            pool = s.get("pool_utilization")
            lines.append(
                f"  rank {rank}: queue={s.get('queue_depth')} "
                f"slots={s.get('slots_active')}"
                + (f" ({occupancy:.0%})" if occupancy is not None else "")
                + (f" pool={pool:.0%}" if pool is not None else "")
                + f" shed: queue_full={shed_full} queue_deadline={shed_deadline}"
            )
            blocked_slot = s.get("admission_blocked_no_free_slot_total")
            blocked_pool = s.get("admission_blocked_pool_exhausted_total")
            if blocked_slot or blocked_pool:
                lines.append(
                    f"    admission blocked: no_free_slot={blocked_slot or 0} "
                    f"pool_exhausted={blocked_pool or 0}"
                )
            hit_rate = s.get("prefix_cache_hit_rate")
            saved = s.get("prefill_tokens_saved_total")
            if hit_rate or saved or s.get("cow_copies_total"):
                lines.append(
                    f"    prefix cache: hit_rate={hit_rate or 0.0:.1%} "
                    f"shared_blocks={s.get('shared_blocks') or 0} "
                    f"cow_copies={s.get('cow_copies_total') or 0} "
                    f"prefill_tokens_saved={saved or 0}"
                )
            if s.get("preempts_total") or s.get("prefill_chunks_total"):
                kvb = s.get("kv_bytes_per_token")
                lines.append(
                    f"    capacity: preempts={s.get('preempts_total') or 0} "
                    f"(priority={s.get('preempts_priority_total') or 0} "
                    f"pool={s.get('preempts_pool_total') or 0} "
                    f"growth={s.get('preempts_growth_total') or 0}) "
                    f"resumes={s.get('resumes_total') or 0} "
                    f"swapped_blocks={s.get('swapped_blocks') or 0} "
                    f"swap_bytes={s.get('swap_bytes_held') or 0} "
                    f"prefill_chunks={s.get('prefill_chunks_total') or 0}"
                    + (
                        f" kv_bytes/token={kvb:.0f}"
                        if kvb is not None else ""
                    )
                )
            if s.get("spec_tokens_proposed"):
                lines.append(
                    f"    speculation: "
                    f"accept_rate={s.get('spec_accept_rate') or 0.0:.1%} "
                    f"proposed={s.get('spec_tokens_proposed') or 0} "
                    f"accepted={s.get('spec_tokens_accepted') or 0} "
                    f"rounds={s.get('spec_rounds') or 0}"
                )
            if s.get("slo_target") is not None:
                ttft = s.get("slo_ttft_attainment")
                e2e = s.get("slo_e2e_attainment")
                lines.append(
                    f"    SLO (target {s['slo_target']:.2%}): "
                    + (f"ttft={ttft:.2%}" if ttft is not None else "ttft=n/a")
                    + (f" e2e={e2e:.2%}" if e2e is not None else " e2e=n/a")
                    + (
                        f"  BREACH (burn {s.get('slo_max_burn_rate'):.1f}x)"
                        if s.get("slo_breach")
                        else ""
                    )
                )
    soak = report.get("soak") or {}
    for rank in sorted(soak):
        rep = soak[rank]
        head = rep.get("headline") or {}
        lines.append("")
        lines.append(
            f"SOAK (rank {rank}, seed {rep.get('seed')}, "
            f"{rep.get('clock')} clock)"
            + ("  [INTERRUPTED]" if rep.get("interrupted") else "")
        )
        lines.append(
            f"  {'phase':<12} {'offered':>9} {'finished':>8} "
            f"{'goodput':>11} {'p95_ttft':>10} {'shed':>5}  slo"
        )
        for p in rep.get("phases") or []:
            p95 = p.get("p95_ttft_s")
            lines.append(
                f"  {str(p.get('phase')):<12} "
                f"{p.get('offered_rps') or 0.0:>7.1f}/s "
                f"{p.get('finished') or 0:>8} "
                f"{p.get('goodput_tokens_per_s') or 0.0:>7.1f}tok/s "
                + (f"{p95 * 1e3:>8.1f}ms " if p95 is not None
                   else f"{'n/a':>10} ")
                + f"{p.get('shed') or 0:>5}  "
                + ("BREACH" if p.get("breached") else "ok")
            )
        goodput = head.get("goodput_tokens_per_s_at_slo")
        obj = head.get("ttft_objective_s")
        soak_p95 = head.get("soak_p95_ttft_s")
        lines.append(
            "  headline: goodput@SLO="
            + (f"{goodput:.1f} tok/s" if goodput is not None else "n/a")
            + (
                f" (soak p95 TTFT {soak_p95 * 1e3:.1f}ms vs "
                f"{obj * 1e3:.1f}ms objective, "
                + ("met)" if head.get("slo_ok") else "MISSED)")
                if soak_p95 is not None and obj is not None
                else ""
            )
        )
        cap = head.get("capacity_rps_at_breach_point")
        if head.get("capacity_saturated"):
            lines.append(
                f"  capacity: >= {cap or 0.0:.1f} req/s (ramp never breached)"
            )
        elif cap:
            lines.append(f"  capacity at breach point: {cap:.1f} req/s")
        fault = rep.get("fault") or {}
        if fault.get("specs"):
            rec_s = fault.get("recovery_s")
            lines.append(
                "  fault: " + ", ".join(fault["specs"])
                + f"  damage: sheds={fault.get('sheds_in_window') or 0}"
                f" slo_violations={fault.get('slo_violations_in_window') or 0}"
                + (
                    f" preempts={fault.get('preempts_in_window')}"
                    if fault.get("preempts_in_window") is not None
                    else ""
                )
                + (
                    f"  recovered in {rec_s:.2f}s"
                    if rec_s is not None
                    else "  NOT RECOVERED"
                )
            )
        router = rep.get("router") or {}
        if router:
            lines.append(
                f"  fleet: policy={router.get('policy')}"
                f" replicas={router.get('replicas_alive')}"
                f"/{router.get('replicas_total')} alive"
                f" routed={router.get('routed_total') or 0}"
                f" rerouted={router.get('rerouted_total') or 0}"
                f" (requeued={router.get('requests_requeued') or 0}"
                f" lost={router.get('requests_lost') or 0})"
                + (
                    f" spills={router['session_spills_total']}"
                    if router.get("session_spills_total")
                    else ""
                )
                + (
                    f" stale_routes={router['stale_snapshot_routes_total']}"
                    if router.get("stale_snapshot_routes_total")
                    else ""
                )
            )
            per = ", ".join(
                f"{r.get('name')}={r.get('routed')}"
                + ("(dead)" if r.get("state") == "dead" else "")
                + ("(draining)" if r.get("state") == "draining" else "")
                for r in router.get("replicas") or []
            )
            if per:
                lines.append(f"    placement: {per}")
        transfer = rep.get("transfer") or {}
        if transfer:
            plane = transfer.get("plane") or {}
            lines.append(
                f"  transfer: placement={transfer.get('placement')}"
                f" delivered={transfer.get('delivered_total') or 0}"
                f" in_flight={transfer.get('in_flight') or 0}"
                f" dedup_ratio={plane.get('dedup_ratio') or 0:.2f}"
                f" bytes={plane.get('bytes_moved_total') or 0}"
                f" p95_ms={plane.get('transfer_ms_p95') or 0:.2f}"
                + (
                    f" stalls={transfer['stalls_total']}"
                    f" (recovered in "
                    f"{transfer.get('stall_recovery_s') or 0:.2f}s)"
                    if transfer.get("stalls_total")
                    else ""
                )
                + (
                    f" dropped={transfer['dropped_total']}"
                    if transfer.get("dropped_total")
                    else ""
                )
            )
        top_shed = sorted(
            (rep.get("shed_totals") or {}).items(), key=lambda kv: -kv[1]
        )[:3]
        if top_shed:
            lines.append(
                "  top shed reasons: "
                + " ".join(f"{r}={n}" for r, n in top_shed)
            )
    memory = report.get("memory") or {}
    if memory:
        lines.append("")
        lines.append("Memory (latest census per rank):")
        for rank in sorted(memory):
            m = memory[rank]
            owners = m.get("census_owner_bytes") or {}
            top = sorted(owners.items(), key=lambda kv: -(kv[1] or 0))[:4]
            owner_str = " ".join(
                f"{name}={_fmt_bytes(n)}" for name, n in top
            )
            lines.append(
                f"  rank {rank}: total={_fmt_bytes(m.get('census_total_bytes'))} "
                f"unowned={_fmt_bytes(m.get('census_unowned_bytes'))}"
                + (f" ({owner_str})" if owner_str else "")
            )
            if m.get("hbm_bytes_in_use") is not None:
                lines.append(
                    f"    device: in_use={_fmt_bytes(m.get('hbm_bytes_in_use'))} "
                    f"peak={_fmt_bytes(m.get('peak_hbm_bytes'))} "
                    f"limit={_fmt_bytes(m.get('hbm_bytes_limit'))}"
                )
    sharding = report.get("sharding") or {}
    if sharding:
        lines.append("")
        lines.append("SHARDING (compiled-collective audit per rank):")
        for rank in sorted(sharding):
            entry = sharding[rank]
            for program in sorted(entry.get("programs") or {}):
                p = entry["programs"][program]
                kinds = p.get("by_kind") or {}
                kind_str = " ".join(
                    f"{k}={n}" for k, n in sorted(kinds.items())
                )
                lines.append(
                    f"  rank {rank} {program}: "
                    f"{p.get('num_collectives') or 0} collective(s)"
                    + (f" [{kind_str}]" if kind_str else "")
                    + f" ici={_fmt_bytes(p.get('ici_bytes') or 0)}"
                    f" dcn={_fmt_bytes(p.get('dcn_bytes') or 0)}"
                    + f" contract={p.get('contract_origin') or 'n/a'}"
                    + ("  CLEAN" if p.get("clean") else "  VIOLATIONS")
                )
            for v in entry.get("violations") or []:
                lines.append(
                    f"    VIOLATION {v.get('program')}: {v.get('op_kind')} "
                    f"`{v.get('op')}` moved {_fmt_bytes(v.get('bytes_moved'))}"
                    f" over {v.get('fabric')} — {v.get('reason')}"
                )
    top_ops = report.get("top_ops")
    if top_ops:
        lines.append(
            f"Top ops by self-time (rank {top_ops.get('rank')}, "
            f"step {top_ops.get('step')}):"
        )
        for op in top_ops.get("ops") or []:
            lines.append(
                f"  {op.get('self_time_ms'):>10.3f}ms x{op.get('count'):<5} "
                f"{op.get('op')}"
            )
    oom = report.get("oom_report")
    if oom:
        lines.append("")
        lines.append(
            f"OOM AUTOPSY ({oom.get('context')}): "
            f"requested={_fmt_bytes(oom.get('requested_bytes'))}"
        )
        ledger = oom.get("ledger") or {}
        if ledger:
            lines.append(
                f"  ledger: budget={_fmt_bytes(ledger.get('budget_bytes'))} "
                f"capacity={_fmt_bytes(ledger.get('capacity_bytes'))} "
                f"temp_peak={_fmt_bytes(ledger.get('program_temp_peak_bytes'))}"
            )
            for name, n in sorted(
                (ledger.get("owners") or {}).items(),
                key=lambda kv: -(kv[1] or 0),
            ):
                lines.append(f"    {name:<14} {_fmt_bytes(n)}")
        for prog in oom.get("top_programs") or []:
            lines.append(
                f"  program {prog.get('label')}: "
                f"temp={_fmt_bytes(prog.get('temp_bytes'))} "
                f"args={_fmt_bytes(prog.get('argument_bytes'))}"
            )
    if report.get("heartbeat_stalls"):
        lines.append(f"Heartbeat stalls recorded: {report['heartbeat_stalls']}")
    for exc in report.get("exceptions", []):
        lines.append(
            f"Exception on rank {exc['rank']}: {exc.get('exception', '?')}"
        )

    lines.append("")
    per_rank_header = f"  {'rank':>4}  {'last_step':>9}  {'dump_reason':<22} state"
    lines.append("Per-rank detail:")
    lines.append(per_rank_header)
    for rank, info in report["ranks"].items():
        if info.get("stale"):
            state = "STALE"
        elif info.get("heartbeat_age_s") is not None:
            state = "alive"
        else:
            state = "dump-only"
        lines.append(
            f"  {rank:>4}  {str(info.get('last_step')):>9}  "
            f"{str(info.get('dump_reason')):<22} {state}"
        )
    return "\n".join(lines)
