"""dashboard mgr module — mirror of src/pybind/mgr/dashboard.

The reference dashboard is a full web UI (cherrypy + Angular, ~100k LoC);
this module keeps its architectural role — an HTTP window onto live
cluster state served FROM the active mgr — with the REST layer and a
minimal index page, dropping the SPA.  Routes mirror the reference's
/api endpoints (dashboard/controllers/*): health, osds, pools, pgs,
daemons, config.

The port's copy of `ceph_tpu/mgr/dashboard.py`.
"""

from __future__ import annotations

import json

from ..common.log import dout
from .modules import HttpServedModule, MgrModule


class DashboardModule(HttpServedModule, MgrModule):
    NAME = "dashboard"

    def __init__(self, port: int = 0):
        MgrModule.__init__(self)
        HttpServedModule.__init__(self, port)
        self.map_errors = 0  # unmappable PGs skipped (visible, not silent)

    # -- REST payloads (dashboard/controllers/{health,osd,pool,...}.py) ------

    def api_health(self) -> dict:
        """The /api/health payload: the mgr's full check set — module
        checks AND the digest-derived ones (SLOW_OPS, OSD_DOWN, ...) —
        each with severity, summary, and the per-entity detail lines
        mon `health detail` would print.  Overall status derives from
        common/health.py's single severity rule: the old module-only
        merge compared against literal "warning"/"error" strings no
        check ever used, so the dashboard banner read HEALTH_OK while
        the cluster burned."""
        from ..common import health

        checks = {
            code: {
                "severity": info.get("severity", "HEALTH_WARN"),
                "summary": info.get("summary", ""),
                "detail": list(info.get("detail") or []),
            }
            for code, info in self.mgr.health_checks().items()
        }
        m = self.mgr.osdmap
        return {
            "status": health.overall_status(checks),
            "checks": checks,
            "osdmap_epoch": m.epoch,
            "num_osds": len(m.osds),
            "num_up_osds": m.num_up_osds(),
            "num_pools": len(m.pools),
        }

    def api_osds(self) -> list[dict]:
        return [
            {
                "osd": osd,
                "up": info.up,
                "in": info.in_,
                "weight": info.weight,
                "addr": info.addr,
            }
            for osd, info in sorted(self.mgr.osdmap.osds.items())
        ]

    def api_pools(self) -> list[dict]:
        out = []
        for p in self.mgr.osdmap.pools.values():
            out.append(
                {
                    "id": p.id,
                    "name": p.name,
                    "type": "erasure" if p.is_erasure() else "replicated",
                    "size": p.size,
                    "pg_num": p.pg_num,
                    "erasure_code_profile": p.erasure_code_profile,
                    "cache_mode": p.cache_mode,
                    "tier_of": p.tier_of,
                    "read_tier": p.read_tier,
                }
            )
        return out

    def api_pgs(self) -> list[dict]:
        m = self.mgr.osdmap
        out = []
        for p in m.pools.values():
            for ps in range(p.pg_num):
                try:
                    up, primary, acting, _ = m.pg_to_up_acting_osds(p.id, ps)
                except Exception as e:
                    self.map_errors += 1
                    dout("mgr", 4,
                         f"dashboard: pg {p.id}.{ps} unmappable: {e!r}")
                    continue
                out.append(
                    {
                        "pgid": f"{p.id}.{ps}",
                        "up": up,
                        "acting": acting,
                        "primary": primary,
                    }
                )
        return out

    def api_daemons(self) -> list[dict]:
        return [
            {"daemon": d, "status": self.mgr.get_daemon_status(d)}
            for d in self.mgr.list_daemons()
        ]

    def api_perf_history(self) -> dict:
        """The /api/perf_history payload: the metrics-history
        module's series inventory, store meta-stats, and the raised
        trend sentinels — the dashboard window onto `perf history ls`.
        Empty when the module isn't registered (modules are opt-in)."""
        from .modules import find_module

        mod = find_module(self.mgr, "metrics_history")
        if mod is None:
            return {"series": [], "stats": {}, "sentinels": {}}
        return {
            **mod.history_ls(),
            "sentinels": mod.history_digest()["sentinels"],
        }

    def api_log(self) -> dict:
        """The /api/log payload (dashboard/controllers/logs.py analog):
        the clog module's recent committed entries plus the health-event
        digest.  Empty when the module isn't registered (opt-in)."""
        from .modules import find_module

        mod = find_module(self.mgr, "clog")
        if mod is None:
            return {"entries": [], "counts": {}, "events_total": 0,
                    "muted": []}
        return {"entries": mod.log_last(n=50), **mod.clog_digest()}

    def prometheus_metrics(self) -> list[tuple[str, str, str, list[str]]]:
        """Module-metrics hook: `map_errors` (PGs skipped as unmappable
        in api_pgs) was a module-local counter nobody could see — a
        CRUSH map that silently stopped mapping PGs deserves a scrape
        family, not a buried attribute."""
        return [
            ("ceph_tpu_dashboard_map_errors", "counter",
             "PGs the dashboard could not map to OSDs (skipped rows in "
             "/api/pgs)",
             [f"ceph_tpu_dashboard_map_errors {self.map_errors}"]),
        ]

    def render(self, path: str) -> tuple[int, str, str]:
        """(status, content-type, body) for a request path."""
        routes = {
            "/api/health": self.api_health,
            "/api/osds": self.api_osds,
            "/api/pools": self.api_pools,
            "/api/pgs": self.api_pgs,
            "/api/daemons": self.api_daemons,
            "/api/perf_history": self.api_perf_history,
            "/api/log": self.api_log,
        }
        fn = routes.get(path)
        if fn is not None:
            return 200, "application/json", json.dumps(fn())
        if path == "/":
            h = self.api_health()
            rows = "".join(
                f"<tr><td>osd.{o['osd']}</td><td>{'up' if o['up'] else 'down'}"
                f"</td><td>{'in' if o['in'] else 'out'}</td></tr>"
                for o in self.api_osds()
            )
            body = (
                "<html><head><title>ceph_tpu dashboard</title></head><body>"
                f"<h1>Cluster: {h['status']}</h1>"
                f"<p>epoch {h['osdmap_epoch']} — {h['num_up_osds']}/"
                f"{h['num_osds']} OSDs up — {h['num_pools']} pools</p>"
                f"<table border=1><tr><th>daemon</th><th>state</th><th>membership"
                f"</th></tr>{rows}</table>"
                "<p>API: /api/health /api/osds /api/pools /api/pgs "
                "/api/daemons /api/perf_history /api/log</p>"
                "</body></html>"
            )
            return 200, "text/html", body
        return 404, "text/plain", "not found"
