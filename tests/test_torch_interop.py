"""The port's OSD daemons under the JAX package's real `Monitor`, serving
its `Rados` client over `posix` loopback, on the CPU: an EC pool put and
get, a killed daemon detected by the port's heartbeats (its peers'
`MOSDFailure`s reach the reference monitor, which marks it down), and a
degraded read.  The port's daemon speaks the reference's wire.

The failure detection is the one case here that rests on a heartbeat
deadline; it uses the killed daemon, a grace of 2 s and a 30 s wait."""

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
