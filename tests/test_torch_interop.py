"""The port and the JAX package on one wire, over `posix` loopback, on the
CPU.

- The port's OSD daemons under the JAX package's real `Monitor`, serving
  its `Rados` client: an EC pool put and get, a killed daemon detected by
  the port's heartbeats (its peers' `MOSDFailure`s reach the reference
  monitor, which marks it down), and a degraded read.
- The JAX package's OSD daemons and `Rados` client under the port's
  `Monitor` and `Mgr`: the same, and the reference daemons' reports
  reaching `ceph df` through the port's mgr.
- The port's `Rados` client against the JAX package's monitor and
  daemons: pools, EC and replicated I/O, omap, classes and a striped
  object.
- A mixed quorum: two port monitors and one of the JAX package's elect,
  commit the same Paxos values byte for byte, and elect again when the
  port's leader stops (the port's lease calls that election).

The failure detections rest on heartbeat deadlines; they use the killed
daemon, a grace of 2 s and a 30 s wait."""

import asyncio

from ceph_tpu.client import Rados
from ceph_tpu.mon import Monitor
from ceph_tpu.mon import MonMap as JMonMap

from ceph_tpu_torch.common.config import Config
from ceph_tpu_torch.mon import MonMap
from ceph_tpu_torch.osd.osd import OSD

from test_mon import free_port_addrs
from test_torch_ec_backend import _pin_reference  # noqa: F401 (autouse)
from torch_daemon_host import wait_until
from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)


def test_port_osds_under_the_reference_monitor_and_client():
    async def run():
        addrs = free_port_addrs(1)
        mon = Monitor("a", JMonMap(addrs=addrs), election_timeout=0.3)
        await mon.start()
        await mon.wait_for_quorum()
        osds = [OSD(i, MonMap(addrs=addrs), device="cpu",
                    conf=Config({"name": f"osd.{i}", "osd_heartbeat_interval": 0.25,
                                 "osd_heartbeat_grace": 2.0}, env=False))
                for i in range(4)]
        client = None
        try:
            for o in osds:
                await o.start()
            for o in osds:
                await o.wait_for_up(timeout=20.0)
            client = Rados(JMonMap(addrs=addrs))
            await client.connect()
            rv, rs, _ = await client.mon_command({
                "prefix": "osd erasure-code-profile set", "name": "k2m1",
                "profile": ["k=2", "m=1", "plugin=tpu"]})
            assert rv == 0, rs
            await client.pool_create("ecpool", "erasure", profile="k2m1", pg_num=4)
            ioctx = await client.open_ioctx("ecpool")
            objs = {f"o{i}": bytes((j * 7 + i) % 256 for j in range(3 * 8192 + 100 * i))
                    for i in range(4)}
            for oid, data in objs.items():
                await ioctx.write_full(oid, data)
            for oid, data in objs.items():
                assert await ioctx.read(oid) == data
            await osds[3].stop()
            await wait_until(lambda: not mon.osdmon.osdmap.is_up(3), 30.0,
                             "the reference monitor marking osd.3 down")
            assert sum(o.perf.get("heartbeat_failures") for o in osds[:3]) >= 2
            for oid, data in objs.items():
                assert await ioctx.read(oid) == data, f"degraded read of {oid}"
        finally:
            if client is not None:
                await client.shutdown()
            for o in osds:
                if o._running:
                    await o.stop()
            await mon.stop()
            await asyncio.sleep(0.05)

    asyncio.run(run())


def test_reference_osds_and_client_under_the_port_monitor_and_mgr():
    from ceph_tpu.common.config import Config as JConfig
    from ceph_tpu.osd.osd import OSD as JOSD

    from ceph_tpu_torch.mgr import Mgr
    from ceph_tpu_torch.mon import Monitor as TMonitor

    async def run():
        addrs = free_port_addrs(1)
        mon = TMonitor("a", MonMap(addrs=addrs), election_timeout=0.3, device="cpu")
        await mon.start()
        await mon.wait_for_quorum()
        mgr = Mgr("x", MonMap(addrs=addrs))
        mgr.beacon_interval = 0.1
        osds = [JOSD(i, JMonMap(addrs=addrs),
                     conf=JConfig({"name": f"osd.{i}", "osd_heartbeat_interval": 0.25,
                                   "osd_heartbeat_grace": 2.0}, env=False))
                for i in range(4)]
        client = None
        try:
            await mgr.start()
            await mgr.wait_for_active()
            for o in osds:
                await o.start()
            for o in osds:
                await o.wait_for_up(timeout=20.0)
            client = Rados(JMonMap(addrs=addrs))
            await client.connect()
            rv, rs, _ = await client.mon_command({
                "prefix": "osd erasure-code-profile set", "name": "k2m1",
                "profile": ["k=2", "m=1", "plugin=tpu"]})
            assert rv == 0, rs
            await client.pool_create("ecpool", "erasure", profile="k2m1", pg_num=4)
            ioctx = await client.open_ioctx("ecpool")
            objs = {f"o{i}": bytes((j * 5 + i) % 256 for j in range(2 * 8192 + 77 * i))
                    for i in range(4)}
            for oid, data in objs.items():
                await ioctx.write_full(oid, data)
            for oid, data in objs.items():
                assert await ioctx.read(oid) == data
            await wait_until(lambda: (mon.pg_digest.get("pools", {}).get("ecpool") or {})
                             .get("objects") == 4, 10.0, "the reference daemons' stats in df")
            await osds[3].stop()
            await wait_until(lambda: not mon.osdmon.osdmap.is_up(3), 30.0,
                             "the port monitor marking osd.3 down")
            for oid, data in objs.items():
                assert await ioctx.read(oid) == data, f"degraded read of {oid}"
            rv, _, out = await client.mon_command({"prefix": "health"})
            assert rv == 0 and "OSD_DOWN" in __import__("json").loads(out)["checks"]
        finally:
            if client is not None:
                await client.shutdown()
            for o in osds:
                if o._running:
                    await o.stop()
            await mgr.stop()
            await mon.stop()
            await asyncio.sleep(0.05)

    asyncio.run(run())


def test_a_mixed_quorum_commits_the_same_values():
    from ceph_tpu.common.config import Config as JConfig

    from ceph_tpu_torch.mon import Monitor as TMonitor
    from ceph_tpu_torch.mon.client import MonClient

    async def run():
        ports = sorted(free_port_addrs(3).values())
        addrs = {"a": ports[0], "b": ports[1], "c": ports[2]}  # ranks 0, 1, 2
        conf = {"mon_lease": 0.5, "mon_tick_interval": 0.1}
        mons = [TMonitor(n, MonMap(addrs=addrs), election_timeout=0.3, device="cpu",
                         conf=Config({"name": f"mon.{n}", **conf}, env=False))
                for n in ("a", "b")]
        mons.append(Monitor("c", JMonMap(addrs=addrs), election_timeout=0.3,
                            conf=JConfig({"name": "mon.c", **conf}, env=False)))
        client = MonClient("client.mixed", MonMap(addrs=addrs))
        try:
            for mon in mons:
                await mon.start()
            await wait_until(lambda: mons[0].is_leader() and mons[0].quorum == [0, 1, 2]
                             and mons[2].quorum == [0, 1, 2], 10.0, "a quorum of three")

            async def cmd(c):
                rv, rs, _ = await client.command(c, 10.0)
                assert rv == 0, (c, rs)

            await cmd({"prefix": "osd erasure-code-profile set", "name": "p",
                       "profile": ["k=2", "m=1", "plugin=tpu"]})
            await cmd({"prefix": "osd pool create", "pool": "ec", "pool_type": "erasure",
                       "erasure_code_profile": "p", "pg_num": 8})
            await cmd({"prefix": "config set", "who": "osd", "name": "osd_max_backfills",
                       "value": "3"})
            await wait_until(lambda: len({m.paxos.last_committed for m in mons}) == 1, 10.0,
                             "every monitor at the same version")
            assert mons[0].paxos.store == mons[1].paxos.store == mons[2].paxos.store
            assert mons[2].osdmon.osdmap.tobytes() == mons[0].osdmon.osdmap.tobytes()
            # the port's leader stops; the port's peon calls the election on
            # the lease, and the reference's monitor follows it
            await mons[0].stop()
            await wait_until(lambda: mons[1].is_leader() and mons[2].quorum == [1, 2], 10.0,
                             "a quorum of the port's and the reference's monitor")
            client._cur_rank = 1
            await cmd({"prefix": "osd pool create", "pool": "rep", "size": 2, "pg_num": 8})
            await wait_until(lambda: mons[2].paxos.last_committed == mons[1].paxos.last_committed
                             and mons[2].osdmon.osdmap.get_pool("rep") is not None, 10.0,
                             "the reference monitor committing the port leader's value")
            assert mons[1].paxos.store == mons[2].paxos.store
        finally:
            await client.msgr.shutdown()
            for mon in mons:
                if mon._tick_task is not None:
                    await mon.stop()
            await asyncio.sleep(0.05)

    asyncio.run(run())


def test_the_port_client_against_the_reference_monitor_and_daemons():
    """The port's `Rados` (Objecter, MonClient, messenger) against the
    JAX package's monitor and OSD daemons: pool commands, an EC and a
    replicated pool's object I/O, omap, a class method (the reference's
    `lock` and `log`, through the port's `cls/client.py`), a
    `StripedObject`, and the pool listing, all byte-exact."""
    from ceph_tpu.common.config import Config as JConfig
    from ceph_tpu.osd.osd import OSD as JOSD

    from ceph_tpu_torch.client import Rados as TRados
    from ceph_tpu_torch.cls import client as cls_client
    from ceph_tpu_torch.striper import StripedObject, StripePolicy

    async def run():
        addrs = free_port_addrs(1)
        mon = Monitor("a", JMonMap(addrs=addrs), election_timeout=0.3)
        await mon.start()
        await mon.wait_for_quorum()
        osds = [JOSD(i, JMonMap(addrs=addrs),
                     conf=JConfig({"name": f"osd.{i}", "osd_heartbeat_interval": 0.25,
                                   "osd_heartbeat_grace": 5.0}, env=False))
                for i in range(4)]
        client = None
        try:
            for o in osds:
                await o.start()
            for o in osds:
                await o.wait_for_up(timeout=20.0)
            client = TRados(MonMap(addrs=addrs))
            await client.connect()
            rv, rs, _ = await client.mon_command({
                "prefix": "osd erasure-code-profile set", "name": "k2m1",
                "profile": ["k=2", "m=1", "plugin=tpu"]})
            assert rv == 0, rs
            await client.pool_create("ecpool", "erasure", profile="k2m1", pg_num=4)
            await client.pool_create("meta", "replicated", size=3, pg_num=4)
            assert {"ecpool", "meta"} <= set(await client.pool_list())
            ec = await client.open_ioctx("ecpool")
            meta = await client.open_ioctx("meta")
            objs = {f"o{i}": bytes((j * 3 + i) % 256 for j in range(3 * 8192 + 55 * i))
                    for i in range(4)}
            for oid, blob in objs.items():
                await ec.write_full(oid, blob)
            for oid, blob in objs.items():
                assert await ec.read(oid) == blob and await ec.stat(oid) == len(blob)
            assert await ec.list_objects() == sorted(objs)
            await meta.omap_set("hdr", {"a": b"1", "b": b"2"})
            assert await meta.omap_get_vals("hdr") == {"a": b"1", "b": b"2"}
            await cls_client.lock(meta, "hdr", "rbd_lock", cookie="c1")
            info = await cls_client.get_lock_info(meta, "hdr", "rbd_lock")
            assert info["type"] == "exclusive" and len(info["holders"]) == 1
            await cls_client.unlock(meta, "hdr", "rbd_lock", cookie="c1")
            assert (await cls_client.get_lock_info(meta, "hdr", "rbd_lock"))["holders"] == []
            await meta.exec("log", "log", "add", b'{"entries": [{"ts": 1.5, "section": "s",'
                                               b' "name": "n", "data": "d"}]}')
            listed = __import__("json").loads(await meta.exec("log", "log", "list", b"{}"))
            assert [e["data"] for e in listed["entries"]] == ["d"]
            so = StripedObject(meta, "img", StripePolicy(stripe_unit=4096, stripe_count=2,
                                                       object_size=8192))
            blob = bytes((j * 11) % 253 for j in range(50_000))
            await so.write(blob, 0)
            assert await so.read(0, 0) == blob and await so.size() == len(blob)
        finally:
            if client is not None:
                await client.shutdown()
            for o in osds:
                if o._running:
                    await o.stop()
            await mon.stop()
            await asyncio.sleep(0.05)

    asyncio.run(run())
