"""Mgr daemon — mirror of src/mgr/ (MgrStandby/Mgr/DaemonServer); the
port's copy of `ceph_tpu/mgr/mgr.py`.

Structure mirrored:

- Boot: beacon to the monitors (MMgrBeacon → MgrMonitor); the mon map
  decides who is active; standbys keep beaconing and take over on
  failover (MgrStandby::send_beacon).
- **DaemonServer** (src/mgr/DaemonServer.cc): receives MMgrReport from
  every daemon, keeping per-daemon perf-counter and status state
  (DaemonStateIndex analog) that modules consume.
- **Module runtime** (src/mgr/PyModuleRegistry + src/pybind/mgr):
  modules register on the active mgr and get a `serve`-style periodic
  `tick()` plus access to the daemon state, the osdmap, and mon
  commands — the same surface the reference's MgrModule exposes
  (cluster maps via `self.get()`, `mon_command`, perf counters).

Where the port differs: a module whose tick raises a device error
(`ops.guard.is_device_error`) stops the mgr, which records the error in
`failed`, as a monitor does; any other exception a module raises is
logged and the loop goes on, as in the reference.  A module with an
`on_report(daemon, status, now)` method sees every daemon report as it
arrives (the progress module's completions, ROADMAP C24).
"""

from __future__ import annotations

import asyncio
import json
import time

from ..common.clog import ClusterLogClient
from ..common.config import Config
from ..common.log import dout
from ..mon.client import MonClient
from ..mon.monmap import MonMap
from ..msg.messages import (
    MMgrBeacon,
    MMgrMap,
    MMgrReport,
    MMonMgrReport,
    MOSDMap,
)
from ..msg.messenger import Connection, Dispatcher, Messenger
from ..ops.guard import is_device_error
from ..osd.osdmap import OSDMap, advance_map


class DaemonState:
    """One daemon's latest report (DaemonStateIndex entry)."""

    def __init__(self) -> None:
        self.perf: dict = {}
        self.status: dict = {}
        self.last_report = 0.0


class Mgr(Dispatcher):
    def __init__(
        self,
        name: str,
        monmap: MonMap,
        conf: Config | None = None,
        addr: str = "127.0.0.1:0",
        keyring=None,  # KeyRing enabling cephx on this mgr's sessions
    ):
        self.name = name
        self.monmap = monmap
        self.conf = conf or Config({"name": f"mgr.{name}"})
        self._bind_addr = addr
        stack = self.conf.get("ms_type")
        # the port's: with a keyring the mgr runs cephx like the monitor
        # and the daemons, so it can serve a cluster that requires it
        auth = None
        if keyring is not None:
            from ..auth.cephx import CephxAuth

            auth = CephxAuth.for_daemon(f"mgr.{name}", keyring)
        self.msgr = Messenger(f"mgr.{name}", stack=stack, auth=auth)
        self.monc = MonClient(
            f"mgr.{name}", monmap,
            msgr=Messenger(f"mgr.{name}", stack=stack, auth=auth),
        )
        self.clogc = ClusterLogClient(f"mgr.{name}", send=self.monc.send_log)
        self.osdmap = OSDMap()
        self.mgrmap_epoch = 0
        self.active = False
        self.daemons: dict[str, DaemonState] = {}
        self.modules: list = []
        self._tasks: list[asyncio.Task] = []
        self._running = False
        self.beacon_interval = 1.0
        self.admin_socket = None
        self.failed: BaseException | None = None  # the device error that stopped it

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> None:
        await self.msgr.bind(self._bind_addr)
        self.msgr.add_dispatcher_head(self)
        self.monc.on_osdmap = self._on_osdmap
        self.monc.msgr.add_dispatcher_tail(self)  # mgrmap arrives here
        self._running = True
        await self.monc.subscribe("osdmap")
        await self.monc.subscribe("mgrmap")
        self._tasks.append(asyncio.create_task(self._beacon_loop()))
        self._tasks.append(asyncio.create_task(self._module_loop()))
        await self._start_admin_socket()

    async def _start_admin_socket(self) -> None:
        """Mgr admin socket (the `ceph tell mgr.*` surface): the iostat
        / top-clients views live here so an operator can ask "who is
        driving the load" without a prometheus stack.  A command whose
        module is not registered answers so."""
        try:
            path = self.conf.get("admin_socket")
        except KeyError:
            path = ""
        if not path:
            return
        from ..common.admin_socket import AdminSocket

        sock = AdminSocket(path)
        from .modules import find_module

        def _module(name: str):
            module = find_module(self, name)
            if module is None:
                raise ValueError(f"{name} module not registered")
            return module

        sock.register(
            "iostat top",
            lambda cmd: {
                "clients": _module("iostat").top_clients(
                    n=int(cmd["n"]) if "n" in cmd else None,
                    by=cmd.get("by", "ops_rate"),
                )
            },
            "top-N clients by IOPS/bytes/p99 (args: n, "
            "by=ops_rate|bytes_rate|p99)",
        )
        sock.register(
            "iostat",
            lambda cmd: {"pools": _module("iostat").iostat()},
            "per-pool IO rates, windowed p99, cumulative totals",
        )
        # metrics-history query surface: the stored series
        # and their multi-resolution windows, from the operator path
        sock.register(
            "perf history ls",
            lambda cmd: _module("metrics_history").history_ls(),
            "list stored perf time series + store meta stats",
        )
        sock.register(
            "perf history get",
            lambda cmd: _module("metrics_history").history_get(
                cmd.get("series", "encode_gbps"),
                daemon=cmd.get("daemon") or None,
                window=float(cmd.get("window", 300.0)),
                step=float(cmd.get("step", 0.0)),
                aggregate=cmd.get("aggregate", "avg"),
            ),
            "one series re-bucketed over a window (args: series, "
            "daemon, window, step, aggregate=avg|min|max|last|sum)",
        )
        await sock.start()
        self.admin_socket = sock

    async def stop(self) -> None:
        try:
            await asyncio.wait_for(self.clogc.flush(), timeout=0.5)
        except Exception as e:
            # best-effort: the mon may already be gone at shutdown
            dout("mgr", 5, f"final clog flush failed: {e}")
        self._running = False
        for t in self._tasks:
            t.cancel()
        self._tasks.clear()
        if self.admin_socket is not None:
            await self.admin_socket.stop()
            self.admin_socket = None
        await self.msgr.shutdown()
        await self.monc.shutdown()

    async def wait_for_active(self, timeout: float = 5.0) -> None:
        deadline = time.monotonic() + timeout
        while not self.active:
            if time.monotonic() > deadline:
                raise TimeoutError(f"mgr.{self.name} never became active")
            await asyncio.sleep(0.02)

    # -- beacons / maps --------------------------------------------------------

    async def _beacon_loop(self) -> None:
        while self._running:
            beacon = MMgrBeacon(name=self.name, addr=self.msgr.addr)
            digest = None
            if self.active:
                # PGMap digest to the mons (MMonMgrReport): what `ceph df`
                # and mon-side health read
                digest = MMonMgrReport(
                    digest=json.dumps(self.pg_digest()).encode()
                )
            for mon_name in self.monmap.ranks:
                try:
                    await self.monc.msgr.send_to(self.monmap.addrs[mon_name], beacon)
                    if digest is not None:
                        await self.monc.msgr.send_to(
                            self.monmap.addrs[mon_name], digest
                        )
                except ConnectionError:
                    continue
            try:
                await self.monc.resubscribe()
            except ConnectionError:
                pass
            await asyncio.sleep(self.beacon_interval)

    def pg_digest(self) -> dict:
        """Aggregate the OSDs' reported pool stats into the df shape:
        STORED (primary-only logical bytes), OBJECTS (primary-only head
        count), USED (raw bytes summed over every replica/shard)."""
        pools: dict[str, dict] = {}
        names = {str(p.id): p.name for p in self.osdmap.pools.values()}
        for st in self.daemons.values():
            status = st.status or {}
            for key, field in (
                ("pool_stored", "stored"),
                ("pool_heads", "objects"),
                ("pool_bytes", "used_raw"),
            ):
                for pid, v in (status.get(key) or {}).items():
                    # a pool deleted mid-report has stats from OSDs that
                    # have not yet dropped its PGs but no name in our
                    # osdmap: keep the record id-keyed and flagged
                    # rather than fabricating a "pool<N>" name that
                    # could shadow (or be shadowed by) a real pool.
                    # The "id:" prefix keeps the key out of the name
                    # namespace entirely — pool NAMES are arbitrary
                    # strings, so a live pool literally named "7" must
                    # not merge with deleted pool id 7
                    name = names.get(pid)
                    rec = pools.setdefault(
                        name if name is not None else f"id:{pid}",
                        {"stored": 0, "objects": 0, "used_raw": 0},
                    )
                    if name is None:
                        rec["deleted"] = True
                        rec["id"] = int(pid)
                    rec[field] += v
        osds = {
            daemon: sum((st.status or {}).get("pool_bytes", {}).values())
            for daemon, st in self.daemons.items()
            if daemon.startswith("osd.")
        }
        return {
            "pools": pools,
            "osds": osds,  # per-daemon raw bytes (`ceph osd df`)
            "total_used_raw": sum(p["used_raw"] for p in pools.values()),
            # per-daemon slow-request counts (OpTracker complaint ages);
            # the mon-side SLOW_OPS health check reads this slice
            "slow_ops": self.slow_ops_by_daemon(),
            # daemons whose device backend is DEGRADED (EC dispatch on
            # the host fallback); the mon-side TPU_BACKEND_DEGRADED
            # check reads this slice
            "tpu_degraded": self.tpu_degraded_by_daemon(),
            # daemons over their HBM residency target (the mempool
            # ledger's pressure verdict); the mon-side
            # TPU_HBM_PRESSURE check reads this slice
            "hbm_pressure": self.hbm_pressure_by_daemon(),
            # per-PG scrub inconsistencies from the primaries' status
            # blobs; the mon-side OSD_SCRUB_ERRORS / PG_DAMAGED
            # HEALTH_ERR checks read this slice
            "scrub_errors": self.scrub_errors_by_pg(),
            # per-PG recovery/backfill/scrub bars with rate + ETA from
            # the progress module; `ceph_cli status` renders
            # them and the mon's PG_RECOVERY_STALLED check reads the
            # `stalled` sub-slice.  Empty when no module is registered.
            "progress": self.progress_digest(),
            # per-pool IO rates + top clients from the iostat module;
            # `ceph_cli status` renders the pool rates and
            # operators read top-N through the mgr asok
            "iostat": self._module_digest("iostat_digest"),
            # per-pool SLO burn-rate slice: the mon-side
            # SLO_LATENCY_BREACH check reads `breaches`
            "slo": self._module_digest("slo_digest"),
            # gray-failure slice: per-daemon laggy-peer views
            # and hedge/shed ledgers from the OSD status blobs — the
            # evidence trail beside the mon's own OSD_SLOW_PEER state
            # (which rides the direct MOSDFailure(laggy) path, not this
            # digest) and the chaos harness's hedge-rate assertions
            "slow_peers": self.slow_peers_by_daemon(),
            # trend-sentinel slice from the metrics-history module:
            # raised TPU_THROUGHPUT_REGRESSION /
            # TPU_OCCUPANCY_COLLAPSE / TPU_QUEUE_WAIT_INFLATION checks
            # with wording built in common/health.py, plus the store's
            # meta-stats; the mon renders them like PG_RECOVERY_STALLED
            "history": self._module_digest("history_digest"),
        }

    def _module_digest(self, hook: str) -> dict:
        """A registered module's digest slice by hook name, or {} when
        no module provides it (modules are opt-in, like the
        reference's)."""
        for module in self.modules:
            digest = getattr(module, hook, None)
            if digest is not None:
                return digest()
        return {}

    def progress_digest(self) -> dict:
        """The registered progress module's digest slice, or {} when the
        module isn't loaded."""
        return self._module_digest("progress_digest")

    def slow_peers_by_daemon(self) -> dict[str, dict]:
        """Per-daemon gray-failure views: which peers each
        OSD currently flags laggy plus its hedge/deadline-shed counters.
        Daemons seeing no laggy peers and holding all-zero ledgers are
        elided; a down daemon's stale view is dropped like slow-ops."""
        out: dict[str, dict] = {}
        for daemon, st in self.daemons.items():
            sp = (st.status or {}).get("slow_peers") or {}
            if not sp.get("laggy") and not any(
                v for k, v in sp.items() if k != "laggy"
            ):
                continue
            if not self._daemon_report_live(daemon):
                continue
            out[daemon] = dict(sp)
        return out

    def tpu_degraded_by_daemon(self) -> dict[str, dict]:
        """Daemons reporting a DEGRADED device backend (the OSD status'
        tpu_backend blob, ops/guard.py verdict).  A down daemon's stale
        report is dropped like the slow-ops slice: its process — and
        with it the degraded runtime — is gone."""
        out: dict[str, dict] = {}
        for daemon, st in self.daemons.items():
            backend = (st.status or {}).get("tpu_backend") or {}
            if not backend.get("degraded"):
                continue
            if not self._daemon_report_live(daemon):
                continue
            out[daemon] = {
                "degraded_for_sec": float(backend.get("degraded_for_sec", 0.0)),
                "reason": str(backend.get("reason", "")),
                "fallback_launches": int(backend.get("fallback_launches", 0)),
            }
        return out

    def hbm_pressure_by_daemon(self) -> dict[str, dict]:
        """Daemons reporting HBM mempool pressure (the OSD status'
        hbm_pressure blob, common/mempool.py verdict).  A down daemon's
        stale report drops like the degraded slice — its process, and
        with it the resident device memory, is gone."""
        out: dict[str, dict] = {}
        for daemon, st in self.daemons.items():
            pressure = (st.status or {}).get("hbm_pressure") or {}
            if not pressure.get("pressure"):
                continue
            if not self._daemon_report_live(daemon):
                continue
            out[daemon] = {
                "ratio": float(pressure.get("ratio", 0.0)),
                "target_bytes": int(pressure.get("target_bytes", 0)),
                "total_bytes": int(pressure.get("total_bytes", 0)),
                "stage": int(pressure.get("stage", 0)),
                "stage_name": str(pressure.get("stage_name", "")),
                "pools": dict(pressure.get("pools") or {}),
            }
        return out

    def scrub_errors_by_pg(self) -> dict[str, dict]:
        """Per-PG scrub inconsistencies reported by the primaries (the
        OSD status blobs' scrub_errors slice).  Stale reports from down
        daemons drop like the other health slices; a PG whose primary
        moved clears when the new primary's clean report arrives."""
        out: dict[str, dict] = {}
        for daemon, st in self.daemons.items():
            if not self._daemon_report_live(daemon):
                continue
            for pgid, rec in ((st.status or {}).get("scrub_errors") or {}).items():
                out[pgid] = rec
        return out

    def _daemon_report_live(self, daemon: str) -> bool:
        """False when a daemon's last report is provably stale — a down
        OSD's process (and with it its in-flight ops, degraded runtime,
        ...) is gone, so its final status must not survive into the
        digest slices health checks read."""
        if daemon.startswith("osd."):
            try:
                info = self.osdmap.osds.get(int(daemon[4:]))
            except ValueError:
                info = None
            if info is not None and not info.up:
                return False
        return True

    def slow_ops_by_daemon(self) -> dict[str, dict]:
        """Daemons currently reporting slow requests (count + oldest age),
        the DaemonServer side of the OSD's `N slow requests` complaint."""
        out: dict[str, dict] = {}
        for daemon, st in self.daemons.items():
            slow = (st.status or {}).get("slow_ops") or {}
            if not slow.get("count"):
                continue
            if not self._daemon_report_live(daemon):
                continue
            out[daemon] = {
                "count": int(slow["count"]),
                "oldest_sec": float(slow.get("oldest_sec", 0.0)),
            }
        return out

    def health_checks(self) -> dict[str, dict]:
        """Mgr-visible health checks in the reference's check shape
        ({code: {severity, summary}}): what the prometheus module exports
        as the ceph_tpu_healthcheck gauge.  SLOW_OPS mirrors the mon-side
        check computed from the same digest; module checks (e.g. the
        autoscaler's POOL_PG_NUM) merge in."""
        from ..common import health

        checks: dict[str, dict] = {}
        slow = self.slow_ops_by_daemon()
        summary = health.slow_ops_summary(slow)
        if summary:
            checks["SLOW_OPS"] = {
                "severity": "HEALTH_WARN",
                "summary": summary,
                "detail": health.slow_ops_detail(slow),
            }
        down = health.down_in_osds(self.osdmap)
        if down:
            checks["OSD_DOWN"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(down)} osds down",
                "detail": [f"osd.{o} is down" for o in down],
            }
        degraded = self.tpu_degraded_by_daemon()
        summary = health.tpu_degraded_summary(degraded)
        if summary:
            checks["TPU_BACKEND_DEGRADED"] = {
                "severity": "HEALTH_WARN",
                "summary": summary,
                "detail": health.tpu_degraded_detail(degraded),
            }
        pressured = self.hbm_pressure_by_daemon()
        summary = health.hbm_pressure_summary(pressured)
        if summary:
            checks["TPU_HBM_PRESSURE"] = {
                "severity": "HEALTH_WARN",
                "summary": summary,
                "detail": health.hbm_pressure_detail(pressured),
            }
        scrub = self.scrub_errors_by_pg()
        summary = health.osd_scrub_errors_summary(scrub)
        if summary:
            # data damage is an ERR, not a WARN, in the reference too:
            # an inconsistent PG is serving reads off shards that
            # disagree.  Severity derives from health.ERR_CHECKS so the
            # mon's overall_status and this gauge stay in lockstep.
            checks["OSD_SCRUB_ERRORS"] = {
                "severity": health.check_severity("OSD_SCRUB_ERRORS"),
                "summary": summary,
                "detail": health.pg_damaged_detail(scrub),
            }
            checks["PG_DAMAGED"] = {
                "severity": health.check_severity("PG_DAMAGED"),
                "summary": health.pg_damaged_summary(scrub),
                "detail": health.pg_damaged_detail(scrub),
            }
        for module in self.modules:
            checks.update(getattr(module, "health_checks", {}) or {})
        return checks

    def _on_osdmap(self, msg: MOSDMap) -> None:
        self.osdmap = advance_map(self.osdmap, msg)

    # -- dispatch --------------------------------------------------------------

    def ms_dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, MMgrMap):
            if msg.epoch > self.mgrmap_epoch:
                self.mgrmap_epoch = msg.epoch
                was = self.active
                self.active = msg.active_name == self.name
                if self.active and not was:
                    dout("mgr", 1, f"mgr.{self.name} is now active")
                    if self._running:
                        self.clogc.info(f"mgr.{self.name} is now active")
            return True
        if isinstance(msg, MMgrReport):
            st = self.daemons.setdefault(msg.daemon, DaemonState())
            try:
                st.perf = json.loads(msg.perf.decode() or "{}")
                st.status = json.loads(msg.status.decode() or "{}")
            except json.JSONDecodeError:
                return True
            st.last_report = time.monotonic()
            # the port's (ROADMAP C24): modules that must see every
            # report, not only the one a tick finds
            for module in self.modules:
                hook = getattr(module, "on_report", None)
                if hook is None:
                    continue
                try:
                    hook(msg.daemon, st.status, st.last_report)
                except Exception as e:  # a module must not kill dispatch
                    if is_device_error(e):
                        self._fail(module, e)
                        return True
                    dout("mgr", 0, f"module {module.NAME} raised {e!r} on a report")
            return True
        return False

    # -- module runtime --------------------------------------------------------

    def register_module(self, module) -> None:
        module.mgr = self
        self.modules.append(module)

    async def _module_loop(self) -> None:
        while self._running:
            await asyncio.sleep(1.0)
            if not self.active:
                continue
            for module in self.modules:
                try:
                    result = module.tick()
                    if asyncio.iscoroutine(result):
                        await result
                except Exception as e:  # a module must not kill the mgr
                    if is_device_error(e):
                        self._fail(module, e)
                        return
                    dout("mgr", 0, f"module {module.NAME} raised {e!r}")

    def _fail(self, module, exc: BaseException) -> None:
        """A module met a device error: record it and stop the mgr (its
        beacons stop, so a standby takes over)."""
        if self.failed is not None:
            return
        self.failed = exc
        dout("mgr", 0, f"mgr.{self.name}: module {module.NAME} hit a device "
                       f"error, stopping: {exc!r}")
        asyncio.get_event_loop().create_task(self.stop())

    # -- module-facing surface (MgrModule API analog) --------------------------

    def get_daemon_perf(self, daemon: str) -> dict:
        st = self.daemons.get(daemon)
        return st.perf if st else {}

    def get_daemon_status(self, daemon: str) -> dict:
        st = self.daemons.get(daemon)
        return st.status if st else {}

    def list_daemons(self) -> list[str]:
        return sorted(self.daemons)

    async def mon_command(self, cmd: dict, timeout: float = 5.0):
        return await self.monc.command(cmd, timeout)
