"""Telemetry mgr module — mirror of src/pybind/mgr/telemetry.

The reference's telemetry module assembles an anonymized cluster report
(cluster shape, pool/EC configuration, daemon versions, crash digests,
usage — never object names or user data) and, only when explicitly
enabled, posts it upstream.  This module keeps the report assembly and
the opt-in gate; the transport is a local report log (this environment
has no egress, and the reference also supports exactly this
`telemetry show`-without-send workflow).

Privacy contract mirrored from the reference: the report carries a
salted-hash cluster id, counts and shapes only — no names, addresses
beyond count, or payload-derived values.

The port's copy of `ceph_tpu/mgr/telemetry.py`.
"""

from __future__ import annotations

import hashlib
import json
import secrets
import time

from .modules import MgrModule

REPORT_INTERVAL = 60.0  # scaled-down telemetry interval


class TelemetryModule(MgrModule):
    NAME = "telemetry"

    def __init__(self, enabled: bool = False):
        super().__init__()
        self.enabled = enabled  # off unless the operator opts in
        self.last_report: dict | None = None
        self.reports: list[dict] = []  # the "sent" log (no egress here)
        self._last_sent = 0.0
        # Cluster salt (the reference's persisted report id): random so a
        # fixed salt can't make cluster_id a publicly recomputable hash of
        # the fsid, but cluster-persistent so reports from the same cluster
        # stay correlated across mgr failovers.  The durable home is the
        # centralized config DB (`telemetry_salt`, pushed by the
        # ConfigMonitor like the reference's mgr kv store); the random
        # value is the fallback for unconfigured clusters and is only
        # per-instance.
        self._salt: str | None = None

    def on(self) -> None:
        """`ceph telemetry on` — explicit opt-in."""
        self.enabled = True

    def off(self) -> None:
        self.enabled = False

    def _get_salt(self) -> str:
        configured = None
        conf = getattr(self.mgr, "conf", None)
        if conf is not None:
            try:
                configured = conf.get("telemetry_salt")
            except KeyError:
                configured = None
        if configured:
            return str(configured)
        if self._salt is None:
            self._salt = secrets.token_hex(16)
        return self._salt

    def _cluster_id(self) -> str:
        fsid = getattr(self.mgr.osdmap, "fsid", "") or "unset"
        return hashlib.sha256((self._get_salt() + fsid).encode()).hexdigest()[:16]

    def compile_report(self) -> dict:
        """telemetry's report assembly (module.py compile_report): shapes
        and counts, nothing identifying."""
        m = self.mgr.osdmap
        pools = []
        for p in m.pools.values():
            pools.append(
                {
                    "type": "erasure" if p.is_erasure() else "replicated",
                    "pg_num": p.pg_num,
                    "size": p.size,
                    "erasure_code_profile": sorted(
                        m.erasure_code_profiles.get(
                            p.erasure_code_profile, {}
                        ).items()
                    )
                    if p.erasure_code_profile
                    else [],
                }
            )
        up = sum(1 for o in m.osds.values() if o.up)
        report = {
            "cluster_id": self._cluster_id(),
            "ts": time.time(),
            "osd": {"count": len(m.osds), "up": up},
            "pools": pools,
            "daemons_reporting": len(self.mgr.daemons),
            "health_checks": sorted(
                {code for mod in self.mgr.modules for code in mod.health_checks}
            ),
            "perf_envelope": self._perf_envelope(),
        }
        self.last_report = report
        return report

    def _perf_envelope(self) -> dict:
        """Performance-envelope slice: shapes and counts
        only, honoring the privacy contract — series/eviction COUNTS
        from the metrics-history store and cluster-aggregate PEAKS
        (the label-free series: no daemon names, pool names, or client
        ids can reach the report).  Empty when the module isn't
        registered."""
        from .modules import find_module

        mod = find_module(self.mgr, "metrics_history")
        if mod is None:
            return {}
        stats = mod.store.stats()
        env = {
            "history_series": stats["series"],
            "history_points": stats["points"],
            "history_evictions": stats["evictions"],
            "sentinels_fired": mod.sentinels_fired,
        }
        # peaks over the store's full retention, cluster series only
        # ({} labels — built exclusively from aggregate sums/means)
        retention = 10 * 24 * 3600.0  # >= any configured retention
        for key, family in (
            ("peak_encode_gbps", "encode_gbps"),
            ("peak_decode_gbps", "decode_gbps"),
            ("peak_occupancy", "occupancy"),
            ("peak_queue_wait_ms", "queue_wait_ms"),
        ):
            peak = mod.store.window_value(
                family, {}, start_ago=retention, end_ago=0.0,
                aggregate="max",
            )
            if peak is not None:
                env[key] = round(peak, 4)
        return env

    def tick(self) -> None:
        if not self.enabled:
            return
        now = time.time()
        if now - self._last_sent < REPORT_INTERVAL:
            return
        self._last_sent = now
        self.reports.append(self.compile_report())

    # `ceph telemetry show` equivalent for the admin socket / CLI
    def show(self) -> str:
        return json.dumps(self.compile_report(), indent=2)
