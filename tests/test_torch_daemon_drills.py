"""The port's daemon where it differs from the JAX package's, on the CPU.

- ROADMAP C12: an EC primary reads a slot's chunks from the slot's
  last-clean holder while the new member rebuilds.  When that holder is
  marked out but keeps running, the reference's daemon has dropped the PG
  and drops the sub-reads, so the rebuild never completes (its hedged
  reads, which could rescue it, are off here as in every differential);
  the port's daemon keeps the PG as a stray for backend messages, and the
  cluster gets clean.
- ROADMAP C14: a late heartbeat tick judges no peer (a stalled shared
  event loop marks no healthy daemon down); and the port's deep scrub
  timer, `osd_deep_scrub_interval`, runs the parity verify.
- A device fault armed through a daemon's admin socket (`injectargs`,
  point `codec.launch`) fails the client's write with EIO, the status
  blob's `tpu_backend.degraded` turns true, and nothing is recomputed on
  the host (`fallback_launches` stays 0); once the guard is healthy the
  next write lands.
"""

import asyncio

import pytest

from test_torch_ec_backend import _pin_reference  # noqa: F401 (autouse)
from test_torch_osd import make_cluster, quiet, settle
from torch_daemon_host import wait_until
from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

EC = [dict(name="ec", kind="ec", k=4, m=2, pg_num=8, stripe_unit=4096)]
HOLDER = 2


def data(n, seed):
    return bytes((i * 131 + seed) % 251 for i in range(n))


async def _out_a_running_holder(pkg, tmp_path):
    c = make_cluster(pkg, tmp_path, pools=EC, n_osds=7)
    try:
        await c.start(30)
        cl = c.client
        for i in range(16):
            assert (await cl.op("ec", f"o{i}", [cl.osd_op("WRITEFULL", data=data(20000, i))])
                    ).result == 0
        await settle(c)
        await asyncio.sleep(0.3)  # clean ticks: the primaries note each slot's holder
        c.mon.mark_out(HOLDER)
        try:
            await wait_until(lambda: c.all_clean(), 10.0, "clean after the out", step=0.02)
            clean = True
        except TimeoutError:
            clean = False
        stuck = sorted(str(pg.pgid) for pg in c.primaries() if pg.recovering)
        reads = []
        if clean:
            for i in range(16):
                rep = await cl.op("ec", f"o{i}", [cl.osd_op("READ", off=0, len=0)])
                reads.append(bytes(rep.outdata[0]) if rep.result == 0 else rep.result)
        strays = sum(len(getattr(o, "strays", {})) for o in c.running())
        return clean, stuck, reads, strays
    finally:
        await c.stop()


def test_out_holder_keeps_serving_sub_reads_in_the_port(tmp_path):
    ref_clean, ref_stuck, _, _ = asyncio.run(_out_a_running_holder("jax", tmp_path))
    clean, stuck, reads, strays = asyncio.run(_out_a_running_holder("torch", tmp_path))
    assert not ref_clean and ref_stuck, "the reference's rebuild was expected to stall"
    assert clean and not stuck
    assert reads == [data(20000, i) for i in range(16)]
    assert strays > 0


def test_device_fault_through_injectargs_fails_the_op_with_eio(tmp_path):
    from ceph_tpu_torch.ops import dispatch
    from ceph_tpu_torch.ops.guard import device_guard

    async def run():
        c = make_cluster("torch", tmp_path, pools=EC, n_osds=6, admin_sockets=True)
        try:
            await c.start(30)
            cl = c.client
            assert (await cl.op("ec", "a", [cl.osd_op("WRITEFULL", data=data(16384, 1))])
                    ).result == 0
            fb0 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
            primary = cl.target("ec", "b")[1]
            armed = await c.asok(primary, "injectargs", point="codec.launch", error=5, hits=1)
            assert armed["armed"] == ["codec.launch"]
            rep = await cl.op("ec", "b", [cl.osd_op("WRITEFULL", data=data(16384, 2))])
            status = c.status(primary)
            fb1 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
            await c.asok(primary, "injectargs", clear=True)
            device_guard().mark_healthy()
            healed = await cl.op("ec", "b", [cl.osd_op("WRITEFULL", data=data(16384, 3))])
            back = await cl.op("ec", "b", [cl.osd_op("READ", off=0, len=0)])
            return rep.result, status["tpu_backend"], fb0, fb1, healed.result, back
        finally:
            await c.stop()

    result, backend, fb0, fb1, healed, back = asyncio.run(run())
    assert result == -5
    assert backend["degraded"] is True and backend["fallback_launches"] == 0
    assert fb1 == fb0 == 0
    assert healed == 0 and bytes(back.outdata[0]) == data(16384, 3)


async def _stall_the_loop(pkg, tmp_path, seconds: float):
    """Block the event loop every daemon shares for `seconds`, then give
    the heartbeats two graces: which daemons does the map mark down?"""
    import time

    conf = {"osd_heartbeat_interval": 0.1, "osd_heartbeat_grace": 1.0,
            "osd_recovery_push_retry_sec": 0, "osd_ec_hedge_quantile": 0,
            "ec_tpu_shard_devices": 1}
    c = make_cluster(pkg, tmp_path, pools=EC, n_osds=6, conf=conf, honor_failures=True)
    try:
        await c.start(30)
        await asyncio.sleep(0.5)  # every peer pinged and answered once
        time.sleep(seconds)  # a callback that holds the loop
        await asyncio.sleep(2.0)
        stalls = sum(getattr(o, "heartbeat_stalls", 0) for o in c.running())
        return sorted(c.mon.down_epochs), stalls
    finally:
        await c.stop()


def test_a_stalled_loop_marks_no_daemon_down_in_the_port(tmp_path):
    """ROADMAP C14: with every daemon on one event loop, a callback that
    holds it past the grace leaves every daemon's heartbeat tick late.
    The reference's daemons then report every peer and the map marks
    healthy daemons down; the port's judge no peer on a late tick."""
    ref_downs, _ = asyncio.run(_stall_the_loop("jax", tmp_path, 2.5))
    downs, stalls = asyncio.run(_stall_the_loop("torch", tmp_path, 2.5))
    assert ref_downs, "the reference was expected to mark healthy daemons down"
    assert downs == [] and stalls > 0


def test_the_deep_scrub_timer_runs_the_parity_verify(tmp_path):
    """`osd_deep_scrub_interval` (the port's deep timer beside the
    reference's `osd_scrub_interval`): a primary's periodic scrub of an
    append-only EC PG runs deep, and the deep EC scrub verifies parity
    through the verify aggregator."""
    from ceph_tpu_torch.ops import dispatch

    async def run():
        pool = [dict(name="rgw", kind="ec", k=4, m=2, pg_num=2, stripe_unit=4096)]
        c = make_cluster("torch", tmp_path, pools=pool, n_osds=6)
        try:
            await c.start(30)
            cl = c.client
            for i in range(6):
                assert (await cl.op("rgw", f"o{i}", [cl.osd_op("WRITEFULL",
                                                               data=data(20000, i))])).result == 0
            v0 = dispatch.VERIFY_LAUNCHES.snapshot()["launches"]
            for o in c.running():
                o.conf.set("osd_deep_scrub_interval", 0.3)
                o.conf.set("osd_scrub_interval", 0.3)
            pgs = [pg for pg in c.primaries() if pg.list_heads()]
            await wait_until(lambda: all(pg.scrubber.last_result is not None
                                         and pg.scrubber.last_result.deep for pg in pgs),
                             20.0, "the timer's deep scrubs")
            results = [pg.scrubber.last_result for pg in pgs]
            return results, dispatch.VERIFY_LAUNCHES.snapshot()["launches"] - v0
        finally:
            await c.stop()

    results, verifies = asyncio.run(run())
    assert results and all(r.deep and not r.aborted and r.errors == 0 for r in results)
    assert verifies >= len(results)
