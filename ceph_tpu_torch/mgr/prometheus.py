"""prometheus mgr module — mirror of src/pybind/mgr/prometheus.

The reference's module exports every daemon's perf counters plus cluster
state in Prometheus text exposition format over HTTP.  Same here: the
module renders `scrape()` from DaemonServer state and (optionally)
serves it on a TCP port via a minimal HTTP/1.0 responder, the analog of
the reference's cherrypy server (module.py StandbyModule/Module).

The port's copy of `ceph_tpu/mgr/prometheus.py`.
"""

from __future__ import annotations

from ..common.log import dout
from ..common.perf_counters import histogram_sample_lines
from .modules import HttpServedModule, MgrModule


def _sanitize(name: str) -> str:
    return "".join(c if c.isalnum() or c == "_" else "_" for c in name)


def _perf_type(counter: str) -> str:
    """Family type for a scalar perf value.  Most daemon perf scalars
    are monotonic counters, but the flight-recorder utilization exports
    rise AND fall (occupancy is a fraction; a dump_flight reset rebases
    everything) — announcing those as counters would make PromQL
    rate()/increase() read every dip as a counter reset."""
    name = counter.rsplit(".", 1)[-1]
    if (
        "occupancy" in name
        or "mean_queue_wait" in name
        or "busy_seconds" in name
        or "flight_records" in name
        or name == "backend_degraded"
        # launch-scheduler queue depth rises and falls with the queue
        or name == "queue_depth"
        # trace-sampling exports: the live knobs and the
        # provisional-trace depth are levels, not monotone counters
        or name in ("sample_rate", "budget_per_sec", "pending_traces")
        # pipeline ring + device-cache levels: the configured
        # depth, the current in-flight count, and the cache's resident
        # footprint all rise AND fall
        or name in ("depth", "inflight", "resident_bytes", "entries")
        # recovery-storm levels: the adaptive wave size, the
        # engagement flag and the local burn rate are levels; the
        # wave/shed/ramp/storm totals stay counters
        or name in ("wave_objects", "engaged", "burn_rate")
        # padding-waste exports: the global ratio and every
        # per-label `pad_waste.<label>` slice are fractions that rise
        # AND fall as the bucketed pad targets learn
        or "waste" in counter
        # offload-runtime registry levels: a service's pending
        # submission count drains to zero, and the registered-service
        # count is a level, not a monotone total
        or name in ("pending", "services")
    ):
        return "gauge"
    return "counter"


class PrometheusModule(HttpServedModule, MgrModule):
    NAME = "prometheus"

    def __init__(self, port: int = 0):
        MgrModule.__init__(self)
        HttpServedModule.__init__(self, port)
        self.scrape_errors = 0  # module families lost (visible, not silent)

    # -- exposition ------------------------------------------------------------

    def scrape(self) -> str:
        """The /metrics payload (module.py collect).

        Exposition contract (validated by tests/test_metrics_lint.py):
        every family gets exactly one HELP + TYPE block, families never
        repeat, and histogram families carry cumulative `le` buckets
        ending in +Inf plus `_sum`/`_count` — real Prometheus histograms,
        so `histogram_quantile()` works on op latency out of the box."""
        mgr = self.mgr
        # family name -> (type, help, [sample lines]); insertion-ordered so
        # each family renders as one HELP/TYPE block with all its samples
        families: dict[str, tuple[str, str, list[str]]] = {}

        def family(name: str, ftype: str, help_: str) -> list[str]:
            if name not in families:
                families[name] = (ftype, help_, [])
            return families[name][2]

        # cluster-level gauges (ceph_osd_up/ceph_osd_in analogs)
        osdmap = mgr.osdmap
        up = family("ceph_tpu_osd_up", "gauge", "OSD up state")
        in_ = family("ceph_tpu_osd_in", "gauge", "OSD in state")
        for osd, info in sorted(osdmap.osds.items()):
            up.append(f'ceph_tpu_osd_up{{osd="{osd}"}} {int(info.up)}')
            in_.append(f'ceph_tpu_osd_in{{osd="{osd}"}} {int(info.in_)}')
        family("ceph_tpu_osdmap_epoch", "counter", "current osdmap epoch").append(
            f"ceph_tpu_osdmap_epoch {osdmap.epoch}"
        )
        # health checks (ceph_health_detail analog): one gauge sample per
        # ACTIVE check; absent when the check clears
        checks = mgr.health_checks()
        hc = family(
            "ceph_tpu_healthcheck", "gauge",
            "active cluster health checks (1 = raised)",
        )
        for code, info in sorted(checks.items()):
            sev = info.get("severity", "HEALTH_WARN")
            hc.append(
                f'ceph_tpu_healthcheck{{name="{code}",severity="{sev}"}} 1'
            )
        # pool stats from the PGMap digest (ceph_pool_stored/objects/
        # bytes_used analogs of the reference exporter)
        digest = mgr.pg_digest()
        for metric, field_, help_ in (
            ("pool_stored_bytes", "stored", "logical bytes stored (STORED)"),
            ("pool_objects", "objects", "head objects"),
            ("pool_used_raw_bytes", "used_raw", "raw bytes incl. replicas"),
        ):
            rows = family(f"ceph_tpu_{metric}", "gauge", help_)
            for pool, st in sorted(digest["pools"].items()):
                rows.append(
                    f'ceph_tpu_{metric}{{pool="{pool}"}} {st[field_]}'
                )
        # HBM mempool ledger families: per-daemon, per-pool
        # residency gauges from the OSD status blobs' hbm_mempools
        # slice, plus the pressure verdict.  Labeled families (pool as
        # a label) rather than one family per pool, so PromQL can
        # sum/topk across pools — the promised ceph_tpu_mempool_* /
        # pressure-ratio scrape surface.
        mem_bytes = family(
            "ceph_tpu_mempool_bytes", "gauge",
            "HBM mempool ledger: bytes resident per pool",
        )
        mem_buffers = family(
            "ceph_tpu_mempool_buffers", "gauge",
            "HBM mempool ledger: buffers resident per pool",
        )
        mem_peak = family(
            "ceph_tpu_mempool_peak_bytes", "gauge",
            "HBM mempool ledger: peak bytes per pool since reset",
        )
        hbm_ratio = family(
            "ceph_tpu_hbm_pressure_ratio", "gauge",
            "HBM residency over target (0 when no target set)",
        )
        hbm_target = family(
            "ceph_tpu_hbm_target_bytes", "gauge",
            "configured ec_tpu_hbm_target_bytes (0 = pressure off)",
        )
        for daemon in mgr.list_daemons():
            status = mgr.get_daemon_status(daemon)
            for pool, st in sorted((status.get("hbm_mempools") or {}).items()):
                labels = f'daemon="{daemon}",pool="{pool}"'
                mem_bytes.append(
                    f'ceph_tpu_mempool_bytes{{{labels}}} {st.get("bytes", 0)}'
                )
                mem_buffers.append(
                    f'ceph_tpu_mempool_buffers{{{labels}}} '
                    f'{st.get("buffers", 0)}'
                )
                mem_peak.append(
                    f'ceph_tpu_mempool_peak_bytes{{{labels}}} '
                    f'{st.get("peak_bytes", 0)}'
                )
            pressure = status.get("hbm_pressure") or {}
            if pressure:
                hbm_ratio.append(
                    f'ceph_tpu_hbm_pressure_ratio{{daemon="{daemon}"}} '
                    f'{pressure.get("ratio", 0.0)}'
                )
                hbm_target.append(
                    f'ceph_tpu_hbm_target_bytes{{daemon="{daemon}"}} '
                    f'{pressure.get("target_bytes", 0)}'
                )
        # module-exported families (the reference's MgrModule
        # add_metric analog): any registered module exposing
        # `prometheus_metrics() -> [(family, type, help, samples)]`
        # contributes — the progress module's per-PG gauges ride this
        for module in mgr.modules:
            metrics = getattr(module, "prometheus_metrics", None)
            if metrics is None:
                continue
            try:
                families_out = metrics()
            except Exception as e:
                # same contract as Mgr._module_loop: one faulty module
                # loses its own families, never the whole exposition —
                # but the loss is logged + counted, not invisible
                self.scrape_errors += 1
                dout("mgr", 1,
                     f"prometheus: module "
                     f"{getattr(module, 'NAME', '?')} metrics raised "
                     f"{e!r}")
                continue
            for name, ftype, help_, rows in families_out:
                family(name, ftype, help_).extend(rows)
        # per-daemon perf counters, grouped into families across daemons
        for daemon in mgr.list_daemons():
            perf = mgr.get_daemon_perf(daemon)
            for counter, value in sorted(perf.items()):
                metric = f"ceph_tpu_{_sanitize(counter)}"
                if isinstance(value, dict) and "histogram" in value:
                    family(
                        metric, "histogram", f"perf histogram {counter}"
                    ).extend(
                        histogram_sample_lines(
                            metric, value["histogram"], f'daemon="{daemon}"'
                        )
                    )
                    continue
                if isinstance(value, dict) and "histogram2d" in value:
                    # 2D size x latency grids have no Prometheus family
                    # shape; they stay on the admin socket (dump_histograms)
                    continue
                if isinstance(value, dict):  # long-run avg {avgcount, sum}
                    family(
                        f"{metric}_sum", "counter", f"perf counter {counter} sum"
                    ).append(
                        f'{metric}_sum{{daemon="{daemon}"}} {value.get("sum", 0)}'
                    )
                    family(
                        f"{metric}_count", "counter",
                        f"perf counter {counter} sample count",
                    ).append(
                        f'{metric}_count{{daemon="{daemon}"}} {value.get("avgcount", 0)}'
                    )
                    continue
                family(
                    metric, _perf_type(counter), f"perf counter {counter}"
                ).append(f'{metric}{{daemon="{daemon}"}} {value}')
        out: list[str] = []
        for name, (ftype, help_, rows) in families.items():
            out.append(f"# HELP {name} {help_}")
            out.append(f"# TYPE {name} {ftype}")
            out.extend(rows)
        return "\n".join(out) + "\n"

    # -- HTTP endpoint (scaffold in modules.HttpServedModule) ----------------

    def render(self, path: str) -> tuple[int, str, str]:
        """Every path serves the exposition (the reference's exporter also
        answers /metrics only, with / as a convenience)."""
        return 200, "text/plain; version=0.0.4", self.scrape()
