"""Shared health-check construction.

The mon (`ceph health [detail]`) and the mgr (prometheus
`ceph_tpu_healthcheck` gauge) both derive SLOW_OPS and OSD_DOWN from the
same digest slices; building the wording in one place keeps the two
surfaces in lockstep (the reference gets this from a single
HealthMonitor check registry)."""

from __future__ import annotations


def slow_ops_summary(slow: dict[str, dict]) -> str | None:
    """The SLOW_OPS check summary for a per-daemon slow-ops slice
    ({daemon: {count, oldest_sec}}), or None when nothing is slow.
    Wording matches the reference's `N slow ops, oldest one blocked for
    S sec, daemons [...] have slow ops.`"""
    total = sum(v.get("count", 0) for v in slow.values())
    if not total:
        return None
    oldest = max(v.get("oldest_sec", 0.0) for v in slow.values())
    return (
        f"{total} slow ops, oldest one blocked for {oldest:.0f} sec, "
        f"daemons [{','.join(sorted(slow))}] have slow ops."
    )


def slow_ops_detail(slow: dict[str, dict]) -> list[str]:
    """Per-daemon breakdown lines (`health detail`)."""
    return [
        f"{d}: {v.get('count', 0)} slow ops, oldest "
        f"{v.get('oldest_sec', 0.0):.0f} sec"
        for d, v in sorted(slow.items())
    ]


def slow_peer_summary(laggy: dict[int, dict]) -> str | None:
    """The OSD_SLOW_PEER check summary for a laggy-OSD slice
    ({osd_id: {reporters, rtt_ms, since_sec}}), or None when no peer is
    laggy.  Non-fatal by construction: these OSDs answer
    heartbeats — slowly — so the check is a WARN and never feeds a
    markdown."""
    if not laggy:
        return None
    worst = max(v.get("rtt_ms", 0.0) for v in laggy.values())
    return (
        f"{len(laggy)} osd(s) laggy — heartbeats answer but service is "
        f"slow (worst rtt ewma {worst:.0f} ms): "
        f"[{','.join(f'osd.{o}' for o in sorted(laggy))}]"
    )


def slow_peer_detail(laggy: dict[int, dict]) -> list[str]:
    """Per-OSD breakdown lines (`health detail`)."""
    return [
        f"osd.{o}: laggy for {v.get('since_sec', 0.0):.0f} sec, rtt ewma "
        f"{v.get('rtt_ms', 0.0):.0f} ms, reported by "
        f"[{','.join(str(r) for r in v.get('reporters', []))}]"
        for o, v in sorted(laggy.items())
    ]


def tpu_degraded_summary(degraded: dict[str, dict]) -> str | None:
    """The TPU_BACKEND_DEGRADED check summary for a per-daemon degraded
    slice ({daemon: {degraded_for_sec, reason, fallback_launches}}), or
    None when every backend is healthy.  Shared by the mon health check
    and the mgr's healthcheck gauge so the two surfaces agree."""
    if not degraded:
        return None
    longest = max(v.get("degraded_for_sec", 0.0) for v in degraded.values())
    return (
        f"{len(degraded)} daemon(s) dispatching EC on the host fallback "
        f"(device backend degraded, longest for {longest:.0f} sec): "
        f"[{','.join(sorted(degraded))}]"
    )


def tpu_degraded_detail(degraded: dict[str, dict]) -> list[str]:
    """Per-daemon breakdown lines (`health detail`)."""
    return [
        f"{d}: degraded {v.get('degraded_for_sec', 0.0):.0f} sec "
        f"({v.get('fallback_launches', 0)} host-fallback launches): "
        f"{v.get('reason', '') or 'unknown'}"
        for d, v in sorted(degraded.items())
    ]


def hbm_pressure_summary(pressured: dict[str, dict]) -> str | None:
    """The TPU_HBM_PRESSURE check summary for a per-daemon pressure
    slice ({daemon: {ratio, target_bytes, total_bytes, stage_name,
    pools}}), or None when no daemon is under HBM pressure.  Shared by
    the mon health check and the mgr's healthcheck gauge so the two
    surfaces agree."""
    if not pressured:
        return None
    worst = max(v.get("ratio", 0.0) for v in pressured.values())
    return (
        f"{len(pressured)} daemon(s) under device HBM memory pressure "
        f"(worst at {worst:.2f}x of target): "
        f"[{','.join(sorted(pressured))}]"
    )


def hbm_pressure_detail(pressured: dict[str, dict]) -> list[str]:
    """Per-daemon breakdown lines (`health detail`): residency vs
    target, the trim stage reached, and the top pools holding bytes."""
    lines = []
    for d, v in sorted(pressured.items()):
        pools = v.get("pools") or {}
        top = ", ".join(
            f"{name}={nbytes}"
            for name, nbytes in sorted(
                pools.items(), key=lambda kv: -kv[1]
            )[:3]
        )
        lines.append(
            f"{d}: {v.get('total_bytes', 0)} bytes resident vs "
            f"{v.get('target_bytes', 0)} target "
            f"(ratio {v.get('ratio', 0.0):.2f}, "
            f"stage {v.get('stage_name', 'none')})"
            + (f"; top pools: {top}" if top else "")
        )
    return lines


def recovery_stalled_summary(stalled: dict[str, dict]) -> str | None:
    """The PG_RECOVERY_STALLED check summary for a stalled-event slice
    ({"<pgid>:<kind>": {pgid, kind, stalled_for_sec, objects_done,
    objects_total}}), or None when every event is advancing.  Shared by
    the mgr progress module and the mon health check so the two
    surfaces agree."""
    if not stalled:
        return None
    longest = max(v.get("stalled_for_sec", 0.0) for v in stalled.values())
    return (
        f"{len(stalled)} pg event(s) have recovery/backfill making no "
        f"progress (longest stalled for {longest:.0f} sec): "
        f"[{','.join(sorted(stalled))}]"
    )


def recovery_stalled_detail(stalled: dict[str, dict]) -> list[str]:
    """Per-event breakdown lines (`health detail`)."""
    return [
        f"pg {v.get('pgid', key)}: {v.get('kind', 'recovery')} stalled "
        f"{v.get('stalled_for_sec', 0.0):.0f} sec at "
        f"{v.get('objects_done', 0)}/{v.get('objects_total', 0)} objects"
        for key, v in sorted(stalled.items())
    ]


def slo_breach_summary(breaches: dict[str, dict]) -> str | None:
    """The SLO_LATENCY_BREACH check summary for a per-pool breach slice
    ({pid: {pool, target_ms, burn_fast, burn_slow, p99_ms}}), or None
    when every pool is inside its latency objective.  Shared by the mgr
    iostat module and the mon health check so the two surfaces agree."""
    if not breaches:
        return None
    worst = max(v.get("burn_slow", 0.0) for v in breaches.values())
    pools = ",".join(
        sorted(str(v.get("pool", pid)) for pid, v in breaches.items())
    )
    return (
        f"{len(breaches)} pool(s) burning their latency SLO error "
        f"budget (worst burn rate {worst:.1f}x): [{pools}]"
    )


def slo_breach_detail(breaches: dict[str, dict]) -> list[str]:
    """Per-pool breakdown lines (`health detail`)."""
    lines = []
    for pid, v in sorted(breaches.items()):
        p99 = v.get("p99_ms")
        p99_s = f"{p99:.1f} ms" if p99 is not None else "overflow"
        lines.append(
            f"pool {v.get('pool', pid)} (id {pid}): p99 {p99_s} vs "
            f"{v.get('target_ms', 0.0):.1f} ms target, burn rate "
            f"fast {v.get('burn_fast', 0.0):.1f}x / "
            f"slow {v.get('burn_slow', 0.0):.1f}x"
        )
    return lines


def throughput_regression_summary(regressions: dict[str, dict]) -> str | None:
    """The TPU_THROUGHPUT_REGRESSION check summary for a per-kind trend
    slice ({kind: {current_gbps, baseline_gbps, ratio,
    launches_per_sec}}), or None when throughput tracks its baseline.
    Shared by the mgr metrics-history module and the mon health check
    so the two surfaces agree."""
    if not regressions:
        return None
    worst = min(v.get("ratio", 1.0) for v in regressions.values())
    kinds = ",".join(sorted(regressions))
    return (
        f"EC {kinds} throughput regressed to {worst:.0%} of its "
        f"trailing baseline while launch volume persists"
    )


def throughput_regression_detail(regressions: dict[str, dict]) -> list[str]:
    """Per-kind breakdown lines (`health detail`)."""
    return [
        f"{kind}: {v.get('current_gbps', 0.0):.3f} GB/s vs "
        f"{v.get('baseline_gbps', 0.0):.3f} GB/s baseline "
        f"({v.get('ratio', 0.0):.0%}) at "
        f"{v.get('launches_per_sec', 0.0):.2f} launches/s"
        for kind, v in sorted(regressions.items())
    ]


def occupancy_collapse_summary(data: dict) -> str | None:
    """The TPU_OCCUPANCY_COLLAPSE check summary ({current, baseline,
    ratio, launches_per_sec}), or None on an empty slice."""
    if not data:
        return None
    return (
        f"device occupancy collapsed to {data.get('ratio', 0.0):.0%} of "
        f"its trailing baseline "
        f"({data.get('current', 0.0):.3f} vs "
        f"{data.get('baseline', 0.0):.3f}) while launch volume persists"
    )


def occupancy_collapse_detail(data: dict) -> list[str]:
    return [
        f"occupancy {data.get('current', 0.0):.4f} vs baseline "
        f"{data.get('baseline', 0.0):.4f} at "
        f"{data.get('launches_per_sec', 0.0):.2f} launches/s"
    ]


def queue_wait_inflation_summary(data: dict) -> str | None:
    """The TPU_QUEUE_WAIT_INFLATION check summary ({current_ms,
    baseline_ms, factor}), or None on an empty slice."""
    if not data:
        return None
    return (
        f"launch queue wait inflated {data.get('factor', 0.0):.1f}x over "
        f"its trailing baseline ({data.get('current_ms', 0.0):.2f} ms vs "
        f"{data.get('baseline_ms', 0.0):.2f} ms)"
    )


def queue_wait_inflation_detail(data: dict) -> list[str]:
    return [
        f"mean queue wait {data.get('current_ms', 0.0):.3f} ms vs "
        f"baseline {data.get('baseline_ms', 0.0):.3f} ms "
        f"({data.get('factor', 0.0):.1f}x)"
    ]


def scrub_errors_total(scrub: dict[str, dict]) -> int:
    """Total scrub errors across a per-PG slice ({pgid: {errors,
    inconsistent, ...}})."""
    return sum(int(v.get("errors", 0)) for v in scrub.values())


def osd_scrub_errors_summary(scrub: dict[str, dict]) -> str | None:
    """The OSD_SCRUB_ERRORS check summary for a per-PG scrub-error
    slice, or None when every last scrub was clean.  Wording follows
    the reference's `N scrub errors`."""
    total = scrub_errors_total(scrub)
    if not total:
        return None
    return f"{total} scrub errors"


def pg_damaged_summary(scrub: dict[str, dict]) -> str | None:
    """The PG_DAMAGED check summary (`Possible data damage: N pgs
    inconsistent`), or None when no PG holds inconsistencies."""
    if not scrub:
        return None
    return (
        f"Possible data damage: {len(scrub)} pg(s) inconsistent: "
        f"[{','.join(sorted(scrub))}]"
    )


def pg_damaged_detail(scrub: dict[str, dict]) -> list[str]:
    """Per-PG breakdown lines (`health detail`): which objects, which
    shards, why — the slice `osd/scrubber.py` recorded at compare time."""
    lines: list[str] = []
    for pgid, v in sorted(scrub.items()):
        kind = "deep-scrub" if v.get("deep") else "scrub"
        lines.append(
            f"pg {pgid} is inconsistent: {v.get('errors', 0)} {kind} errors"
        )
        for oid, bad in sorted((v.get("inconsistent") or {}).items()):
            for osd, why in sorted(bad.items()):
                lines.append(f"pg {pgid} {oid}: osd.{osd} {why}")
    return lines


# Checks whose presence escalates overall cluster health to HEALTH_ERR
# (possible data damage): everything else raised is a HEALTH_WARN.
# This set is the SINGLE severity source — the mon's overall status and
# the mgr's per-check severity field both derive from it (plus any
# explicit severity a mgr module attaches), so the two surfaces cannot
# drift.
ERR_CHECKS = frozenset({"OSD_SCRUB_ERRORS", "PG_DAMAGED"})


def check_severity(code: str) -> str:
    """Severity for a check code: the mgr's health_checks() entries and
    overall_status() both call this, keeping the escalation rule in one
    place."""
    return "HEALTH_ERR" if code in ERR_CHECKS else "HEALTH_WARN"


def overall_status(checks) -> str:
    """Overall health string from the raised checks: HEALTH_ERR when
    any damage-class check is up, HEALTH_WARN for anything else,
    HEALTH_OK when clear.  Accepts either the mon shape (code ->
    summary string) or the mgr shape (code -> {severity, summary});
    an explicit severity field wins over the code-derived default, so
    a module-raised HEALTH_ERR check escalates on both surfaces."""
    worst = "HEALTH_OK"
    for code, info in (
        checks.items() if hasattr(checks, "items")
        else ((c, None) for c in checks)
    ):
        sev = (
            info.get("severity") if isinstance(info, dict) else None
        ) or check_severity(code)
        if sev == "HEALTH_ERR":
            return "HEALTH_ERR"
        worst = "HEALTH_WARN"
    return worst


def down_in_osds(osdmap) -> list:
    """OSDs that are IN but not up — the OSD_DOWN population.  A
    decommissioned (out) osd being down is healthy by design, as in the
    reference's OSD_DOWN check."""
    return sorted(o for o, i in osdmap.osds.items() if i.in_ and not i.up)
