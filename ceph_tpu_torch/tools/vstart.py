"""vstart — dev cluster in one process, mirror of src/vstart.sh.

The reference's vstart.sh boots MON/MGR/OSD daemons on localhost for
development (defaults MON=3 OSD=3 MGR=1, vstart.sh:120-123).  Here the
daemons are asyncio objects in one process; `DevCluster` is the library
surface (used by tools and tests), and running the module starts a
cluster, writes its monmap to `./dev-cluster.json` for the `rados` /
`ceph` CLIs, and serves until interrupted:

    python -m ceph_tpu_torch.tools.vstart --mons 1 --osds 3

The port's copy of `ceph_tpu/tools/vstart.py`.  Where it differs:
`DevCluster(device=)` (`--device`) is handed to the monitors and the
OSDs, cuda unless the caller names another; with no GPU and no
`device="cpu"` the first monitor raises, as every entry point does.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import socket

from ..common.config import Config
from ..mgr import Mgr
from ..mon import MonMap, Monitor
from ..osd.osd import OSD

CLUSTER_FILE = "dev-cluster.json"


def _free_port_addrs(n: int) -> dict[str, str]:
    addrs = {}
    socks = []
    for i in range(n):
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        addrs[chr(ord("a") + i)] = f"127.0.0.1:{s.getsockname()[1]}"
    for s in socks:
        s.close()
    return addrs


class DevCluster:
    """mons + osds + mgr (+ optional MDS with its pools) in-process
    (the vstart topology; vstart.sh also boots MDS=1 by default)."""

    def __init__(
        self,
        n_mons: int = 1,
        n_osds: int = 3,
        with_mgr: bool = True,
        with_mds: bool = False,
        with_rgw: bool = False,
        n_mds: int = 2,  # daemons to boot when with_mds (rank 0 + standby)
        conf_overrides: dict | None = None,
        asok_dir: str = "",  # enable daemon admin sockets under this dir
        device=None,  # the monitors' and OSDs' device; cuda by default
    ):
        self.device = device
        self.asok_dir = asok_dir
        self.n_mons = n_mons
        self.n_osds = n_osds
        self.with_mgr = with_mgr
        self.with_mds = with_mds
        self.with_rgw = with_rgw
        self.n_mds = n_mds
        self.conf_overrides = conf_overrides or {}
        self.monmap: MonMap | None = None
        self.mons: list[Monitor] = []
        self.osds: list[OSD] = []
        self.mgr: Mgr | None = None
        self.mds = None  # the active MDS (rank 0)
        self.mds_daemons: list = []
        self._mds_rados = None
        self._mds_radoses: list = []
        self.rgw_s3 = None
        self.rgw_swift = None
        self._rgw_rados = None

    async def start(self) -> MonMap:
        # ms_type applies cluster-wide (every daemon + client must share a
        # stack); inproc clusters use inproc monmap addresses.
        from ..msg.stack import _ALIASES

        raw = self.conf_overrides.get("ms_type", "async+posix")
        stack = self._stack = _ALIASES.get(raw, raw)
        if self.asok_dir:
            os.makedirs(self.asok_dir, exist_ok=True)
        if stack == "inproc":
            self.monmap = MonMap(
                addrs={
                    name: f"inproc:mon.{name}"
                    for name in ("abcdefghij"[: self.n_mons])
                }
            )
        else:
            self.monmap = MonMap(addrs=_free_port_addrs(self.n_mons))
        self.mons = [
            Monitor(
                name, self.monmap, election_timeout=0.3, stack=stack,
                admin_socket=self._asok(f"mon.{name}"), device=self.device,
            )
            for name in self.monmap.addrs
        ]
        for m in self.mons:
            await m.start()
        for m in self.mons:
            await m.wait_for_quorum()
        for i in range(self.n_osds):
            conf = Config(
                {
                    "name": f"osd.{i}",
                    **(
                        {"admin_socket": self._asok(f"osd.{i}")}
                        if self.asok_dir
                        else {}
                    ),
                    **self.conf_overrides,
                },
                env=False,
            )
            osd = OSD(i, self.monmap, conf=conf, device=self.device)
            await osd.start()
            self.osds.append(osd)
        for osd in self.osds:
            await osd.wait_for_up()
        if self.with_mgr:
            self.mgr = Mgr(
                "x",
                self.monmap,
                conf=Config(
                    {
                        "name": "mgr.x",
                        **(
                            {"admin_socket": self._asok("mgr.x")}
                            if self.asok_dir
                            else {}
                        ),
                        **self.conf_overrides,
                    },
                    env=False,
                ),
            )
            self.mgr.beacon_interval = 0.5
            await self.mgr.start()
            await self.mgr.wait_for_active()
            # standard module set (vstart.sh enables the same four)
            from ..mgr import (
                ClogModule,
                DashboardModule,
                IostatModule,
                MetricsHistoryModule,
                OrchestratorModule,
                ProgressModule,
                TelemetryModule,
            )
            from ..mgr.prometheus import PrometheusModule

            for module in (
                PrometheusModule(),
                DashboardModule(),
                TelemetryModule(),
                OrchestratorModule(),
                # recovery/backfill/scrub bars with rate + ETA in
                # `status`, PG_RECOVERY_STALLED health
                ProgressModule(),
                # per-pool IO rates / top clients in `status`, the SLO
                # burn-rate health check, and the ceph_tpu_pool_*
                # scrape families — registered here so the operator
                # path sees pool rates out of the box
                IostatModule(),
                # mgr-resident perf history + trend sentinels: `perf
                # history ls/get` on the mgr asok, the /api/perf_history
                # dashboard route, and the TPU_THROUGHPUT_REGRESSION
                # family of checks work in the operator path out of the box
                MetricsHistoryModule(),
                # cluster-event timeline: /api/log on the dashboard + the
                # ceph_tpu_clog_* / ceph_tpu_health_* scrape families
                ClogModule(),
            ):
                self.mgr.register_module(module)
        if self.with_mds:
            # `ceph fs new` bootstrap: metadata + data pools, the fs map,
            # then the metadata servers — vstart.sh's MDS topology; 2
            # daemons give rank 0 + one standby for mon-driven failover
            # (MDSMonitor/FSMap, mon/mds_monitor.py)
            from ..client import Rados
            from ..mds import MDS

            self._mds_rados = Rados(
                self.monmap, name="client.mds-bootstrap", stack=self._stack
            )
            await self._mds_rados.connect()
            size = min(2, self.n_osds)
            await self._mds_rados.pool_create(
                "cephfs_metadata", "replicated", size=size, pg_num=4
            )
            await self._mds_rados.pool_create(
                "cephfs_data", "replicated", size=size, pg_num=8
            )
            rv, rs, _ = await self._mds_rados.mon_command(
                {"prefix": "fs new", "fs_name": "cephfs",
                 "metadata": "cephfs_metadata", "data": "cephfs_data"}
            )
            assert rv == 0, f"fs new failed: {rs}"
            for name in ("a", "b")[: max(1, self.n_mds)]:
                # each daemon gets its own RADOS client and binds its
                # assigned filesystem's pools at promotion (multi-fs FSMap)
                r = Rados(
                    self.monmap, name=f"client.mds-{name}", stack=self._stack
                )
                await r.connect()
                self._mds_radoses.append(r)
                d = MDS(
                    stack=self._stack, name=name, monmap=self.monmap, rados=r,
                    admin_socket=self._asok(f"mds.{name}"),
                )
                await d.start()
                self.mds_daemons.append(d)
            # rank 0 comes up once the fsmap names it
            deadline = asyncio.get_event_loop().time() + 10.0
            while not any(d.state == "active" for d in self.mds_daemons):
                if asyncio.get_event_loop().time() > deadline:
                    raise TimeoutError("no MDS became active")
                await asyncio.sleep(0.05)
            self.mds = next(
                d for d in self.mds_daemons if d.state == "active"
            )
        if self.with_rgw:
            # RGW=1: the S3 + Swift personalities over one gateway pool
            # (vstart.sh's radosgw boot)
            from ..client import Rados
            from ..rgw import ObjectGateway, S3Server, SwiftServer

            self._rgw_rados = Rados(
                self.monmap, name="client.rgw", stack=self._stack
            )
            await self._rgw_rados.connect()
            await self._rgw_rados.pool_create(
                "default.rgw.data", "replicated", size=min(2, self.n_osds),
                pg_num=8,
            )
            io = await self._rgw_rados.open_ioctx("default.rgw.data")
            gw = ObjectGateway(io)
            self.rgw_s3 = S3Server(gw, lc_interval=1.0)
            await self.rgw_s3.serve()
            self.rgw_swift = SwiftServer(gw)
            await self.rgw_swift.serve()
        return self.monmap

    def _asok(self, daemon: str) -> str:
        """Admin socket path for a daemon ('' when sockets are disabled)."""
        return f"{self.asok_dir}/{daemon}.asok" if self.asok_dir else ""

    async def stop(self) -> None:
        if self.rgw_s3 is not None:
            await self.rgw_s3.shutdown()
            self.rgw_s3 = None
        if self.rgw_swift is not None:
            await self.rgw_swift.shutdown()
            self.rgw_swift = None
        if self._rgw_rados is not None:
            await self._rgw_rados.shutdown()
            self._rgw_rados = None
        for d in self.mds_daemons:
            await d.stop()
        self.mds_daemons.clear()
        self.mds = None
        for r in self._mds_radoses:
            await r.shutdown()
        self._mds_radoses.clear()
        if self._mds_rados is not None:
            await self._mds_rados.shutdown()
        if self.mgr is not None:
            await self.mgr.stop()
        for osd in self.osds:
            if osd._running:
                await osd.stop()
        for m in self.mons:
            await m.stop()
        await asyncio.sleep(0.05)

    def write_cluster_file(self, path: str = CLUSTER_FILE) -> None:
        """Connection info for out-of-process CLIs."""
        info = {"mon_addrs": self.monmap.addrs}
        # `ceph tell <daemon> <cmd>` resolves admin sockets from here —
        # recorded from what each daemon ACTUALLY bound (a conf override
        # can point an OSD elsewhere than the asok_dir convention)
        socks = {
            **{
                f"mon.{m.name}": m._admin_socket_path
                for m in self.mons
                if m._admin_socket_path
            },
            **{
                f"osd.{o.whoami}": o.conf.get("admin_socket")
                for o in self.osds
                if o.conf.get("admin_socket")
            },
            **(
                {"mgr.x": self.mgr.conf.get("admin_socket")}
                if self.mgr is not None and self.mgr.conf.get("admin_socket")
                else {}
            ),
        }
        if socks:
            info["admin_sockets"] = socks
        if self.mds is not None:
            info["mds_addr"] = self.mds.addr
        socks = info.get("admin_sockets", {})
        for d in self.mds_daemons:
            if d._admin_socket_path:
                socks[f"mds.{d.name}"] = d._admin_socket_path
        if socks:
            info["admin_sockets"] = socks
        if self.rgw_s3 is not None:
            info["rgw_s3_endpoint"] = self.rgw_s3.addr
        if self.rgw_swift is not None:
            info["rgw_swift_endpoint"] = self.rgw_swift.addr
        with open(path, "w") as f:
            json.dump(info, f)


def load_monmap(path: str = CLUSTER_FILE) -> MonMap:
    with open(path) as f:
        info = json.load(f)
    return MonMap(addrs=info["mon_addrs"])


async def _main(args) -> None:
    cluster = DevCluster(
        args.mons, args.osds, with_mgr=not args.no_mgr, with_mds=args.mds,
        asok_dir=args.asok_dir, device=args.device,
    )
    await cluster.start()
    cluster.write_cluster_file(args.cluster_file)
    print(f"cluster up: {args.mons} mon(s), {args.osds} osd(s)"
          + (", 1 mds" if args.mds else "")
          + f"; monmap -> {args.cluster_file}")
    print("mon addrs:", ", ".join(cluster.monmap.addrs.values()))
    if cluster.mds is not None:
        print("mds addr:", cluster.mds.addr)
    try:
        while True:
            await asyncio.sleep(3600)
    except (KeyboardInterrupt, asyncio.CancelledError):
        pass
    finally:
        await cluster.stop()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--mons", type=int, default=1)
    p.add_argument("--osds", type=int, default=3)
    p.add_argument("--no-mgr", action="store_true")
    p.add_argument("--mds", action="store_true",
                   help="boot an MDS with cephfs_metadata/cephfs_data pools")
    p.add_argument("--cluster-file", default=CLUSTER_FILE)
    p.add_argument("--device", default=None,
                   help="the monitors' and OSDs' torch device (default: cuda)")
    p.add_argument("--asok-dir", default="dev-asok",
                   help="daemon admin sockets dir (ceph tell); '' disables")
    args = p.parse_args()
    try:
        asyncio.run(_main(args))
    except KeyboardInterrupt:
        pass


if __name__ == "__main__":
    main()
