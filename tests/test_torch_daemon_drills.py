"""The port's daemon where it differs from the JAX package's, on the CPU.

- ROADMAP C12: an EC primary reads a slot's chunks from the slot's
  last-clean holder while the new member rebuilds.  When that holder is
  marked out but keeps running, the reference's daemon has dropped the PG
  and drops the sub-reads, so the rebuild never completes (its hedged
  reads, which could rescue it, are off here as in every differential);
  the port's daemon keeps the PG as a stray for backend messages, and the
  cluster gets clean.
- ROADMAP C14: a late heartbeat tick judges no peer (a stalled shared
  event loop marks no healthy daemon down), and a peer's silence is
  measured without the time the daemon's ticks lost; and the port's deep scrub
  timer, `osd_deep_scrub_interval`, runs the parity verify.
- A device fault armed through a daemon's admin socket (`injectargs`,
  point `codec.launch`) fails the client's write with EIO, the status
  blob's `tpu_backend.degraded` turns true, and nothing is recomputed on
  the host (`fallback_launches` stays 0); once the guard is healthy the
  next write lands.

And the port's monitor where it differs from the reference's:

- `OSDMonitor.on_active` seeds the default EC profile catching only the
  profile's own errors: a device error (`ops.guard.is_device_error`: a
  `DeviceError`, as the kernel builds and launches raise, or torch's
  CUDA error) stops the port's monitor, with one monitor or as the
  leader of three after its collect round, where the reference's comes
  up without a default profile; a command that meets one is answered
  -EIO and stops the monitor; any other command error, a
  `NotImplementedError` among them, is -EINVAL in both and the monitor
  runs on.
- ROADMAP C16: the reference's monitors run no lease, so a dead leader
  is never replaced (its own case calls the election by hand); the
  port's peons call one once the lease lapses, and a tick that woke
  late judges no lease.
- ROADMAP C17: a leader restarted with an empty store collects below its
  peons' proposal number; the reference's peons drop that COLLECT and
  the quorum never commits again, the port's answer it and the leader
  catches up before its services propose.
- ROADMAP C21: the reference's elector calls a second round when a
  victory is still in flight as a deferring monitor's timer ends, and
  when an older round's propose reaches a monitor after the quorum
  formed; the port's deferring monitor waits the timeout plus 1 s, its
  monitor drops an older propose from a quorum member, and a timer that
  wakes late waits again.
- ROADMAP C18: the reference's `MonClient` keeps its subscriptions on a
  monitor that stopped, and hears of no map again; the port's hunts the
  next one, and with none answering counts the failed passes and hunts
  on until one does.
- ROADMAP C19: reports that reach the quorum again before a markdown
  commits count as a second markdown in the reference, and flap
  dampening then holds a once-failed daemon in; the port counts one.

And the client and the mgr's modules:

- ROADMAP C22: a degraded EC read in flight while every daemon is marked
  down and up again is served byte-exact by both packages.
- ROADMAP C23: a held loop makes the reference's progress module raise
  PG_RECOVERY_STALLED for a recovery that never stopped; the port's
  credits the time its ticks lost.
- ROADMAP C25: an op whose reply a held loop delays past 2 s is resent by
  the reference's Objecter, not by the port's; the op's deadline holds
  in both.  A write in flight when a replica or an EC shard dies
  completes in both: the port's Objecter resends on the new interval.
- ROADMAP C24: a completion reported between two mgr ticks is counted
  expired by the reference's progress module, completed by the port's.
- A device error in a mgr module's tick stops the port's mgr; any other
  error is logged and the module runs again.
"""

import asyncio
import importlib

import pytest

from test_torch_ec_backend import _pin_reference  # noqa: F401 (autouse)
from test_torch_osd import make_cluster, quiet, settle
from torch_daemon_host import CLIENT, wait_until
from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

EC = [dict(name="ec", kind="ec", k=4, m=2, pg_num=8, stripe_unit=4096)]
ROOT = {"jax": "ceph_tpu", "torch": "ceph_tpu_torch"}
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


@pytest.mark.parametrize("lost", [0.0, 0.8])
def test_a_peers_silence_is_measured_without_the_ticks_lost(tmp_path, lost):
    """ROADMAP C14: no peer has answered for 1.6 s (grace 1.5 s) and the
    last tick was on time.  With no tick late since the replies, the
    daemon reports every peer; when its ticks lost 0.8 s in all, each
    too little to make a tick late, the silence it judges is 0.8 s and it
    reports none (a loop whose every pass is slow delays the replies
    more than it delays any one tick)."""

    async def run():
        import time

        c = make_cluster("torch", tmp_path, pools=EC, n_osds=4)
        try:
            await c.start(30)
            d = c.osds[0]
            d.conf.set("heartbeat_inject_failure", 1)  # no tick of its own meanwhile
            sent = []
            d._report_failure = lambda peer, failed_for, laggy=0: sent.append(peer)
            now = time.monotonic()
            d._hb_late = 0.1
            for peer in d._hb_peers():
                d._hb_first_tx[peer] = now - 5.0
                d._hb_last_rx[peer] = now - 1.6
                d._hb_stalled_at[peer] = d._hb_stalled - lost
            d.conf.set("osd_heartbeat_grace", 1.5)
            d._heartbeat_check(now)
            return sorted(sent), sorted(d._hb_peers())
        finally:
            await c.stop()

    sent, peers = asyncio.run(run())
    assert peers and sent == (peers if lost == 0.0 else [])


async def _slow_first_pings(pkg, tmp_path, monkeypatch, delay: float):
    """Every daemon's first ping to each peer waits `delay` seconds before
    it leaves, as when the heartbeat sessions' handshakes queue behind a
    busy loop at boot; which daemons does the map mark down?"""
    import importlib

    messenger = importlib.import_module(f"{ROOT[pkg]}.msg.messenger").Messenger
    ping = importlib.import_module(f"{ROOT[pkg]}.msg.messages").MOSDPing
    send_to = messenger.send_to
    seen: set = set()

    async def slow_send_to(self, addr, msg, *a, **kw):
        if isinstance(msg, ping) and msg.op == ping.PING and (id(self), addr) not in seen:
            seen.add((id(self), addr))
            await asyncio.sleep(delay)
        return await send_to(self, addr, msg, *a, **kw)

    monkeypatch.setattr(messenger, "send_to", slow_send_to)
    conf = {"osd_heartbeat_interval": 0.1, "osd_heartbeat_grace": 1.0,
            "osd_recovery_push_retry_sec": 0, "osd_ec_hedge_quantile": 0,
            "ec_tpu_shard_devices": 1}
    c = make_cluster(pkg, tmp_path, pools=EC, n_osds=6, conf=conf, honor_failures=True)
    try:
        await c.start(30)
        await asyncio.sleep(delay + 2.0)
        return sorted(c.mon.down_epochs)
    finally:
        await c.stop()


def test_slow_first_pings_mark_no_daemon_down_in_the_port(tmp_path, monkeypatch):
    """ROADMAP C20: each daemon's first ping to a peer leaves 1.6 s late
    (grace 1 s).  The reference starts a peer's grace when the ping is
    queued, so every daemon reports its peers and the map marks healthy
    daemons down; the port starts it when the ping went out."""
    ref_downs = asyncio.run(_slow_first_pings("jax", tmp_path, monkeypatch, 1.6))
    monkeypatch.undo()
    downs = asyncio.run(_slow_first_pings("torch", tmp_path, monkeypatch, 1.6))
    assert ref_downs, "the reference was expected to mark healthy daemons down"
    assert downs == []


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


# -- the monitor ------------------------------------------------------------------

def _mon_mods(pkg):
    from test_torch_mon import mods

    return mods(pkg)


def _conn():
    from test_torch_mon import FakeConn

    return FakeConn("client.admin")


async def _mons(pkg, n, conf=None, timeout=0.3):
    from test_torch_mon import start_mons

    return await start_mons(_mon_mods(pkg), n, timeout=timeout, conf=conf)


def _device_error(*args, **kw):
    raise RuntimeError("CUDA error: no kernel image is available for execution on the device")


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_device_error_at_bootstrap_fails_only_the_port_monitor(pkg, monkeypatch):
    m = _mon_mods(pkg)
    registry = __import__(f"{m.root}.codec.registry", fromlist=["x"])
    monkeypatch.setattr(registry.ErasureCodePluginRegistry, "factory", _device_error)

    async def run():
        from test_torch_mon import inproc_addrs, make_mon

        mon = make_mon(m, "a", m.mon.MonMap(addrs=inproc_addrs(1)))
        try:
            if pkg == "torch":
                with pytest.raises(RuntimeError, match="CUDA error"):
                    await mon.start()
                assert "CUDA error" in str(mon.failed)
            else:
                await mon.start()
                await mon.wait_for_quorum()
                assert mon.osdmon.osdmap.epoch == 1
                assert "default" not in mon.osdmon.osdmap.erasure_code_profiles
        finally:
            await mon.stop()

    asyncio.run(run())


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_bad_default_profile_is_skipped_by_both_monitors(pkg):
    async def run():
        monmap, mons = await _mons(pkg, 1, conf={
            "osd_pool_default_erasure_code_profile": "plugin=tpu k=0 m=1"})
        assert mons[0].osdmon.osdmap.epoch == 1
        assert "default" not in mons[0].osdmon.osdmap.erasure_code_profiles
        await mons[0].stop()

    asyncio.run(run())


def test_a_device_error_in_a_command_is_eio_and_propagates(monkeypatch):
    """The error reaches the monitor's own fatal path: the caller hears
    EIO, and the monitor records the error and stops."""
    m = _mon_mods("torch")

    async def run():
        monmap, mons = await _mons("torch", 1)
        assert "default" in mons[0].osdmon.osdmap.erasure_code_profiles
        monkeypatch.setattr(__import__("ceph_tpu_torch.codec.registry", fromlist=["x"])
                            .ErasureCodePluginRegistry, "factory", _device_error)
        conn = _conn()
        cmd = {"prefix": "osd erasure-code-profile set", "name": "p", "profile": ["k=2", "m=1"]}
        assert mons[0].ms_dispatch(conn, m.messages.MMonCommand(
            tid=1, cmd=__import__("json").dumps(cmd))) is True
        await wait_until(lambda: mons[0]._tick_task is None, 5.0, "the monitor stopped")
        assert [(a.tid, a.retval) for a in conn.sent] == [(1, -5)]
        assert "CUDA error" in str(mons[0].failed)
        with pytest.raises(RuntimeError, match="CUDA error"):
            await mons[0].wait_for_quorum()
        await mons[0].stop()

    asyncio.run(run())


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_command_bug_is_einval_and_the_monitor_runs_on(pkg, monkeypatch):
    """A `RuntimeError` subclass of the program's own is not the device's."""
    m = _mon_mods(pkg)

    def bug(*args, **kw):
        raise NotImplementedError("no such technique")

    async def run():
        monmap, mons = await _mons(pkg, 1)
        monkeypatch.setattr(__import__(f"{m.root}.codec.registry", fromlist=["x"])
                            .ErasureCodePluginRegistry, "factory", bug)
        conn = _conn()
        cmd = {"prefix": "osd erasure-code-profile set", "name": "p", "profile": ["k=2", "m=1"]}
        mons[0].ms_dispatch(conn, m.messages.MMonCommand(tid=1, cmd=__import__("json").dumps(cmd)))
        await asyncio.sleep(0.05)
        assert [(a.tid, a.retval) for a in conn.sent] == [(1, -22)]
        assert mons[0]._tick_task is not None and mons[0].is_leader()
        assert getattr(mons[0], "failed", None) is None
        await mons[0].stop()

    asyncio.run(run())


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_device_error_after_the_collect_round_stops_the_leader(pkg):
    """3 monitors over inproc; the leader's EC profile check raises a
    device error when its services start, which with a quorum of three
    is after the collect round, inside the dispatch of a peer's OP_LAST.
    The reference's leader comes up without a default profile; the
    port's stops, and its peers elect a leader of their own once the
    lease lapses and seed the profile there."""
    m = _mon_mods(pkg)

    async def run():
        from test_torch_mon import inproc_addrs, make_mon

        monmap = m.mon.MonMap(addrs=inproc_addrs(3))
        mons = [make_mon(m, name, monmap, 0.3, LEASE) for name in monmap.ranks]
        mons[0].osdmon._normalize_profile = _device_error
        for mon in mons:
            await mon.start()
        if pkg == "torch":
            await wait_until(lambda: mons[0].failed is not None, 5.0, "the leader failed")
            await wait_until(lambda: mons[0]._tick_task is None, 5.0, "the leader stopped")
            assert "CUDA error" in str(mons[0].failed)
            assert mons[0].osdmon.osdmap.epoch == 0
            with pytest.raises(RuntimeError, match="CUDA error"):
                await mons[0].wait_for_quorum()
            await wait_until(lambda: mons[1].is_leader() and mons[1].quorum == [1, 2], 10.0,
                             "a leader of the survivors")
            await wait_until(lambda: all("default" in mon.osdmon.osdmap.erasure_code_profiles
                                         for mon in mons[1:]), 5.0, "the default profile")
        else:
            await wait_until(lambda: all(mon.osdmon.osdmap.epoch == 1 for mon in mons), 5.0,
                             "the first map everywhere")
            assert mons[0].is_leader() and mons[0].quorum == [0, 1, 2]
            assert "default" not in mons[0].osdmon.osdmap.erasure_code_profiles
        for mon in mons:
            await mon.stop()

    asyncio.run(run())


def test_the_port_monitor_needs_a_gpu(monkeypatch):
    import torch

    from ceph_tpu_torch.mon import MonMap, Monitor

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Monitor("a", MonMap(addrs={"a": "inproc:nogpu-a"}), stack="inproc")


LEASE = {"mon_lease": 0.5, "mon_tick_interval": 0.1}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_dead_leader_is_replaced_only_in_the_port(pkg):
    """C16: 3 monitors, a lease of 0.5 s (timeout 1 s); the leader stops."""

    async def run():
        monmap, mons = await _mons(pkg, 3, conf=LEASE)
        assert mons[0].is_leader()
        await mons[0].stop()
        survivors = mons[1:]
        if pkg == "torch":
            await wait_until(lambda: any(mon.is_leader() and mon.quorum == [1, 2]
                                         for mon in survivors), 5.0, "a new leader")
            leader = next(mon for mon in survivors if mon.is_leader())
            assert "MON_DOWN" in leader.health_checks()[0]
            assert sum(mon.lease_elections for mon in survivors) >= 1
        else:
            await asyncio.sleep(3.0)  # three lease timeouts
            assert [mon.leader_rank for mon in survivors] == [0, 0]
            assert not any(mon.is_leader() for mon in survivors)
        for mon in survivors:
            await mon.stop()

    asyncio.run(run())


def test_a_stalled_loop_calls_no_election_in_the_port():
    """C16's policy: the loop held for 1.6 lease timeouts; the ticks that
    wake late judge no lease, and the quorum stands."""

    async def run():
        import time

        monmap, mons = await _mons("torch", 3, conf=LEASE)
        await asyncio.sleep(0.5)  # leases flowing
        epochs = [mon.elector.epoch for mon in mons]
        time.sleep(1.6)
        await asyncio.sleep(1.0)
        assert [mon.elector.epoch for mon in mons] == epochs
        assert sum(mon.lease_elections for mon in mons) == 0
        assert sum(mon.lease_stalls for mon in mons) >= 1
        assert mons[0].is_leader() and mons[0].quorum == [0, 1, 2]
        for mon in mons:
            await mon.stop()

    asyncio.run(run())


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_restarted_leader_catches_up_only_in_the_port(pkg):
    """C17: the leader stops, rank 1 is elected (by hand, as the
    reference's case does) and commits; the old leader comes back with an
    empty store and wins the next election."""
    m = _mon_mods(pkg)

    async def run():
        from test_torch_mon import make_mon, monclient

        monmap, mons = await _mons(pkg, 3)
        client = monclient(m, monmap)

        async def profile(name):
            return (await client.command({"prefix": "osd erasure-code-profile set",
                                          "name": name, "profile": ["k=2", "m=1"]}, 3.0))[0]

        assert await profile("before") == 0
        await mons[0].stop()
        mons[1].elector.start()
        await wait_until(lambda: mons[1].is_leader() and len(mons[1].quorum) == 2, 5.0,
                         "rank 1 leading")
        client._cur_rank = 1
        assert await profile("while-down") == 0
        committed = mons[1].paxos.last_committed
        revived = make_mon(m, "a", monmap)
        mons[0] = revived
        await revived.start()
        await wait_until(lambda: revived.is_leader() and len(revived.quorum) == 3, 5.0,
                         "the revived monitor leading")
        if pkg == "torch":
            await wait_until(lambda: revived.paxos.last_committed >= committed, 5.0,
                             "the revived leader catching up")
            assert "while-down" in revived.osdmon.osdmap.erasure_code_profiles
            assert await profile("after") == 0
            await wait_until(lambda: all("after" in mon.osdmon.osdmap.erasure_code_profiles
                                         for mon in mons), 5.0, "the new profile everywhere")
        else:
            await asyncio.sleep(1.0)
            assert revived.paxos.last_committed == 0 and revived.paxos._collecting
            assert await profile("after") != 0  # nothing commits any more
        await client.msgr.shutdown()
        for mon in mons:
            await mon.stop()

    asyncio.run(run())


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_the_monclient_hunts_on_a_reset_only_in_the_port(pkg):
    """C18: a client subscribed at rank 0; rank 0 stops, rank 1 is
    elected (by hand) and commits a boot."""
    m = _mon_mods(pkg)

    async def run():
        from test_torch_mon import monclient

        monmap, mons = await _mons(pkg, 3)
        client = monclient(m, monmap, "osd.7")
        epochs = []
        client.on_osdmap = lambda msg: epochs.append(max([*msg.maps, *msg.incrementals]))
        await client.subscribe("osdmap", 0)
        await wait_until(lambda: epochs, 5.0, "the first map")
        await mons[0].stop()
        mons[1].elector.start()
        await wait_until(lambda: mons[1].is_leader() and len(mons[1].quorum) == 2, 5.0,
                         "rank 1 leading")
        await client.msgr.send_to(monmap.addr_of_rank(1), m.messages.MOSDBoot(
            osd=7, addr="127.0.0.1:7007", epoch=0))
        await wait_until(lambda: mons[1].osdmon.osdmap.is_up(7), 5.0, "osd.7 up")
        want = mons[1].osdmon.osdmap.epoch
        if pkg == "torch":
            await wait_until(lambda: epochs[-1] == want, 5.0, "the new epoch at the client")
            assert client.hunts == 1
        else:
            await asyncio.sleep(1.0)
            assert epochs[-1] < want
        await client.msgr.shutdown()
        for mon in mons[1:]:
            await mon.stop()

    asyncio.run(run())


async def _electors(m, timeout, hold_victory=0.0):
    """Ranks 1 and 2 of three electors (rank 0 is down), wired through a
    pump task; a VICTORY is handed over `hold_victory` s late, as a busy
    loop holds it."""
    loop = asyncio.get_event_loop()
    queue, electors = [], {}
    for r in (1, 2):
        electors[r] = m.elector.Elector(
            r, 3, lambda dst, msg, src=r: queue.append((dst, msg)),
            on_win=lambda *a: None, on_lose=lambda *a: None, timeout=timeout)

    async def pump():
        while True:
            while queue:
                dst, msg = queue.pop(0)
                if dst == 0:
                    continue
                got = type(msg).frombytes(msg.tobytes())
                if got.op == m.messages.MMonElection.OP_VICTORY and hold_victory:
                    loop.call_later(hold_victory, electors[dst].handle, got)
                else:
                    electors[dst].handle(got)
            await asyncio.sleep(0.001)

    return electors, loop.create_task(pump())


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_victory_in_flight_calls_no_second_election_in_the_port(pkg):
    """C21: rank 0 is down, so rank 1 wins on its timeout with rank 2's
    ack; the victory reaches rank 2 60 ms later.  The reference's rank 2
    deferred with the same timeout, restarts the election before the
    victory lands, and its stale propose then starts a round at rank 1,
    over and over; the port's waits the timeout plus 1 s."""
    m = _mon_mods(pkg)

    async def run():
        electors, pump = await _electors(m, 0.2, hold_victory=0.06)
        electors[1].start()
        await asyncio.sleep(2.0)
        pump.cancel()
        for e in electors.values():
            e.cancel()
        return {r: (e.epoch, e.leader, e.electing) for r, e in electors.items()}

    got = asyncio.run(run())
    if pkg == "torch":
        assert got == {1: (3, 1, False), 2: (3, 1, False)}
    else:
        assert max(epoch for epoch, _, _ in got.values()) >= 7  # three rounds and more


def test_a_late_election_timer_waits_again_in_the_port():
    """C21's late rule: the loop is held 1.6 timeouts while rank 1 waits
    for its majority; the timer that wakes late waits once more, then
    rank 1 wins in one round."""
    m = _mon_mods("torch")

    async def run():
        import time

        electors, pump = await _electors(m, 0.2)
        electors[1].start()
        await asyncio.sleep(0.05)  # the propose and the ack
        time.sleep(0.32)
        await asyncio.sleep(0.5)
        pump.cancel()
        return electors

    electors = asyncio.run(run())
    assert electors[1].late_timeouts == 1
    assert [(e.epoch, e.leader, e.electing) for e in electors.values()] == [(3, 1, False)] * 2


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_an_older_propose_after_the_quorum_calls_no_election_in_the_port(pkg):
    """C21: a quorum of three at epoch 3; rank 0's propose of epoch 2,
    resent by the messenger, reaches rank 2 after the victory.  The
    reference's rank 2 defers to it again and calls a second round when
    its timer ends; the port's drops it, as Ceph's
    `ElectionLogic::receive_propose` ignores an older propose from a
    member of the quorum."""
    m = _mon_mods(pkg)

    async def run():
        monmap, mons = await _mons(pkg, 3)
        await wait_until(lambda: all(mon.elector.epoch == 3 and not mon.elector.electing
                                     for mon in mons), 5.0, "the quorum at epoch 3")
        mons[2].ms_dispatch(_conn(), m.messages.MMonElection(
            op=m.messages.MMonElection.OP_PROPOSE, epoch=2, rank=0))
        await asyncio.sleep(1.5)
        epochs = [mon.elector.epoch for mon in mons]
        for mon in mons:
            await mon.stop()
        return epochs

    epochs = asyncio.run(run())
    if pkg == "torch":
        assert epochs == [3, 3, 3]
    else:
        assert min(epochs) >= 5


def test_the_monclient_hunts_until_a_monitor_answers():
    """C18 with no monitor to answer: all three stop after the client
    subscribed, so passes over every rank fail and are counted; the hunt
    goes on, and once two fresh monitors form a quorum the client holds
    its subscriptions there and hears of their first map."""
    m = _mon_mods("torch")

    async def run():
        from test_torch_mon import make_mon, monclient

        monmap, mons = await _mons("torch", 3)
        client = monclient(m, monmap, "osd.7")
        epochs = []
        client.on_osdmap = lambda msg: epochs.append(max([*msg.maps, *msg.incrementals]))
        await client.subscribe("osdmap", 0)
        await wait_until(lambda: epochs, 5.0, "the first map")
        for mon in mons:
            await mon.stop()
        await wait_until(lambda: client.hunt_failures >= 2, 10.0, "failed passes")
        assert client.hunts >= 1 and not client._hunt.done()
        epochs.clear()
        fresh = [make_mon(m, name, monmap) for name in monmap.ranks[1:]]
        for mon in fresh:
            await mon.start()
        await wait_until(lambda: epochs, 10.0, "a map from the fresh quorum")
        assert client._cur_rank in (1, 2) and client._hunt.done()
        await client.shutdown()
        for mon in fresh:
            await mon.stop()

    asyncio.run(run())


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_one_failure_counts_one_markdown_only_in_the_port(pkg):
    """C19: 3 monitors and 5 booted OSDs; four peers report osd.4 before
    the quorum has committed its markdown.  The reference counts a second
    markdown from the third and fourth reports, so flap dampening doubles
    the down-out grace of a daemon that failed once; the port counts one."""
    m = _mon_mods(pkg)

    async def run():
        monmap, mons = await _mons(pkg, 3)
        leader = mons[0]
        for osd in range(5):
            leader.ms_dispatch(_conn(), m.messages.MOSDBoot(osd=osd, addr=f"127.0.0.1:{7200 + osd}",
                                                            epoch=0))
        await wait_until(lambda: all(mon.osdmon.osdmap.num_up_osds() == 5 for mon in mons), 5.0,
                         "5 OSDs up")
        fail = m.messages.MOSDFailure(target=4, target_addr="", failed_for=20.0, epoch=0)
        for reporter in range(4):
            leader.osdmon.prepare_failure(fail, reporter=f"osd.{reporter}")
        await wait_until(lambda: not leader.osdmon.osdmap.is_up(4), 5.0, "osd.4 down")
        stats = leader.osdmon.flap_stats()["osds"][4]
        base = float(leader.conf.get("mon_osd_down_out_interval"))
        if pkg == "torch":
            assert stats == {"markdowns": 1, "grace_sec": base}
        else:
            assert stats == {"markdowns": 2, "grace_sec": 2 * base}
        for mon in mons:
            await mon.stop()

    asyncio.run(run())


# -- C22: a degraded EC read while the PG re-peers -----------------------------


async def _read_through_a_repeer(pkg, tmp_path, yields: int):
    """Eight degraded reads in flight (one member of `o0`'s PG stopped and
    marked down) when every running daemon is marked down in one epoch
    and up again in the next, both published at once: the PGs re-peer
    while their other members are still Stray.  Each read's result and
    bytes."""
    c = make_cluster(pkg, tmp_path, pools=EC, n_osds=7)
    try:
        await c.start(30)
        cl = c.client
        for i in range(8):
            rep = await cl.op("ec", f"o{i}", [cl.osd_op("WRITEFULL", data=data(20000, i))])
            assert rep.result == 0
        await settle(c)
        pgid, primary = cl.target("ec", "o0")
        acting = c.mon.osdmap.pg_to_up_acting_osds(pgid.pool, pgid.ps)[2]
        victim = next(a for a in acting if a != primary)
        await c.stop_osd(victim)
        c.mon.mark_down(victim)
        await settle(c)
        reads = [asyncio.ensure_future(cl.op("ec", f"o{i}", [cl.osd_op("READ", off=0, len=0)]))
                 for i in range(8)]
        for _ in range(yields):  # the reads reach their primaries, sub-reads go out
            await asyncio.sleep(0)
        running = [o.whoami for o in c.running()]
        c.mon._change(new_down=running)
        c.mon._change(new_up={i: c.mon.osdmap.osds[i].addr for i in running})
        reps = await asyncio.gather(*reads)
        await settle(c)
        return [bytes(r.outdata[0]) if r.result == 0 else r.result for r in reps]
    finally:
        await c.stop()


@pytest.mark.parametrize("yields", [0, 8])
def test_a_degraded_read_through_a_repeer_is_served_in_both(tmp_path, yields):
    """ROADMAP C22: neither package answers EIO here; both serve every
    read byte-exact once the PGs have re-peered."""
    got = {pkg: asyncio.run(_read_through_a_repeer(pkg, tmp_path, yields))
           for pkg in ("jax", "torch")}
    assert got["jax"] == got["torch"] == [data(20000, i) for i in range(8)]


# -- periodic judges under a held loop (ROADMAP C23) ---------------------------


async def _progress_under_a_held_loop(pkg, hold: float):
    """A real `Mgr`'s module loop runs the progress module (stall window
    1.5 s) while a daemon reports a recovery that advances one object
    every 0.1 s; each report reaches the mgr's dispatch two loop turns
    after the daemon's tick, as a message does.  Once the module tracks
    the event, a callback holds the loop for `hold` seconds.  Every
    health check the module raised, and the event's final state."""
    import json
    import time

    mgr_mod = importlib.import_module(f"{ROOT[pkg]}.mgr.mgr")
    progress = importlib.import_module(f"{ROOT[pkg]}.mgr.progress")
    msgs = importlib.import_module(f"{ROOT[pkg]}.msg.messages")
    monmap = importlib.import_module(f"{ROOT[pkg]}.mon.monmap")
    mgr = mgr_mod.Mgr("x", monmap.MonMap(addrs={"a": "127.0.0.1:6789"}))
    mod = progress.ProgressModule(stall_sec=1.5)
    mgr.register_module(mod)
    raised = []
    set_check = mod.set_health_check
    mod.set_health_check = lambda code, *a, **kw: (raised.append(code), set_check(code, *a, **kw))
    mgr._running = mgr.active = True
    done = [0]

    async def daemon():
        while mgr._running:
            await asyncio.sleep(0.1)
            done[0] = min(done[0] + 1, 200)
            status = {"up": True, "progress": {"1.0": [{
                "kind": "recovery", "objects_done": done[0], "objects_total": 200,
                "bytes_done": done[0] << 16, "bytes_total": 200 << 16}]}}
            msg = msgs.MMgrReport(daemon="osd.0", perf=b"{}", status=json.dumps(status).encode())
            for _ in range(2):
                await asyncio.sleep(0)
            mgr.ms_dispatch(None, msg)

    tasks = [asyncio.ensure_future(mgr._module_loop()), asyncio.ensure_future(daemon())]
    try:
        await wait_until(lambda: ("1.0", "recovery") in mod.events, 5.0, "the event tracked")
        time.sleep(hold)  # a callback that holds the loop
        await asyncio.sleep(1.5)  # the ticks after the hold, fresh reports among them
        ev = mod.events[("1.0", "recovery")]
        return sorted(set(raised)), ev.done > 0 and not ev.is_stalled(time.monotonic(), 1.5)
    finally:
        mgr._running = False
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)


def test_a_held_loop_raises_no_recovery_stall_in_the_port():
    """ROADMAP C23: with the loop held 2.5 s past a 1.5 s stall window,
    the reference's progress module judges the recovery by the reports
    it had before the hold, on the first tick after it, and raises
    PG_RECOVERY_STALLED for a recovery that never stopped; the port's
    measures an event's stall and expiry without the time its own ticks
    lost, and raises nothing."""
    ref_raised, ref_moving = asyncio.run(_progress_under_a_held_loop("jax", 2.5))
    raised, moving = asyncio.run(_progress_under_a_held_loop("torch", 2.5))
    assert "PG_RECOVERY_STALLED" in ref_raised, "the reference was expected to fire"
    assert raised == [] and moving and ref_moving


async def _an_op_under_a_held_loop(pkg, tmp_path, hold: float, timeout: float):
    """A client op through the package's `Rados` whose primary holds the
    loop for `hold` seconds as the op arrives: its outcome, the
    Objecter's resends, and the object read back."""
    import time

    rados_mod = importlib.import_module(f"{ROOT[pkg]}.client.rados")
    OSDOp = importlib.import_module(f"{ROOT[pkg]}.msg.messages").OSDOp
    c = make_cluster(pkg, tmp_path, pools=EC, n_osds=6)
    r = None
    try:
        await c.start(30)
        r = rados_mod.Rados(c.monmap, name=CLIENT, secret=c.keyring.get(CLIENT), stack="inproc")
        await r.connect()
        io = await r.open_ioctx("ec")
        primary = c.osds[c.client.target("ec", "o")[1]]
        enqueue = primary._enqueue_op

        def held(conn, msg):
            primary._enqueue_op = enqueue
            time.sleep(hold)  # a callback that holds the loop
            enqueue(conn, msg)

        primary._enqueue_op = held
        try:
            outcome = (await io._op("o", [OSDOp(op=OSDOp.WRITEFULL, data=data(40000, 5))],
                                    timeout=timeout)).result
        except TimeoutError:
            outcome = "timeout"
        back = await io.read("o") if outcome == 0 else None
        return outcome, back, r.objecter.perf.get("op_resend")
    finally:
        if r is not None:
            await r.shutdown()
        await c.stop()


@pytest.mark.parametrize("hold,timeout,want", [(2.5, 10.0, 0), (2.5, 1.0, "timeout")])
def test_an_op_under_a_held_loop_is_not_resent_in_the_port(tmp_path, hold, timeout, want):
    """ROADMAP C25: an op in flight when the loop is held 2.5 s.  Held
    inside the op's deadline, it completes in both packages, but the
    reference's Objecter, whose 2 s reply timer ran out during the hold,
    resends it first (the PG answers the duplicate again: a read runs
    twice, a write is counted twice by iostat); the port's waits for the
    reply and sends it once.  Held past the deadline, both raise
    TimeoutError, as the op's wall time did pass its deadline (Ceph's
    `rados_osd_op_timeout`)."""
    got = {pkg: asyncio.run(_an_op_under_a_held_loop(pkg, tmp_path, hold, timeout))
           for pkg in ("jax", "torch")}
    for pkg in ("jax", "torch"):
        outcome, back, _resends = got[pkg]
        assert outcome == want, pkg
        if want == 0:
            assert back == data(40000, 5)
    if want == 0:
        assert got["jax"][2] >= 1, "the reference was expected to resend"
        assert got["torch"][2] == 0


MIXED = EC + [dict(name="rep", kind="rep", size=3, pg_num=8)]


async def _a_write_while_a_member_dies(pkg, tmp_path, pool: str, late_map: float):
    """A WRITEFULL through the package's `Rados` whose sub-write a
    member of the PG other than the primary drops; that member is then
    stopped and marked down with the write still in flight, and the
    primary hears of that map `late_map` seconds after the others.  The
    write's outcome, the object read back, and the Objecter's resends."""
    rados_mod = importlib.import_module(f"{ROOT[pkg]}.client.rados")
    OSDOp = importlib.import_module(f"{ROOT[pkg]}.msg.messages").OSDOp
    c = make_cluster(pkg, tmp_path, pools=MIXED, n_osds=7)
    r = None
    try:
        await c.start(30)
        r = rados_mod.Rados(c.monmap, name=CLIENT, secret=c.keyring.get(CLIENT), stack="inproc")
        await r.connect()
        io = await r.open_ioctx(pool)
        pgid, primary = c.client.target(pool, "o")
        acting = c.mon.osdmap.pg_to_up_acting_osds(pgid.pool, pgid.ps)[2]
        victim = c.osds[next(a for a in acting if a >= 0 and a != primary)]
        dropped = []
        fast = victim.ms_fast_dispatch

        def drop_sub_writes(conn, msg):
            if type(msg).__name__ in ("MOSDRepOp", "MOSDECSubOpWrite"):
                dropped.append(msg)
                return
            fast(conn, msg)

        victim.ms_fast_dispatch = drop_sub_writes
        w = asyncio.ensure_future(io._op("o", [OSDOp(op=OSDOp.WRITEFULL, data=data(40000, 7))],
                                         timeout=6.0))
        await wait_until(lambda: dropped, 5.0, "the victim's sub-write dropped", step=0.01)
        assert not w.done()
        monc = c.osds[primary].monc
        on_map = monc.on_osdmap
        if late_map:
            monc.on_osdmap = lambda m: asyncio.get_event_loop().call_later(late_map, on_map, m)
        await c.stop_osd(victim.whoami)
        c.mon.mark_down(victim.whoami)
        try:
            outcome = (await w).result
        except TimeoutError:
            outcome = "timeout"
        back = await io.read("o") if outcome == 0 else None
        return outcome, back, r.objecter.perf.get("op_resend")
    finally:
        if r is not None:
            await r.shutdown()
        await c.stop()


@pytest.mark.parametrize("late_map", [0.0, 0.3])
@pytest.mark.parametrize("pool", ["rep", "ec"])
def test_a_write_in_flight_when_a_member_dies_completes_in_both(tmp_path, pool, late_map):
    """ROADMAP C25: a replica, or an EC shard that is not the primary,
    stops and is marked down with a write in flight.  The reference's
    Objecter resends on its 2 s timer; the port's resends because the
    new map starts a new interval for the PG, and a resend that reaches
    the primary before its map does (`late_map`) is answered -EAGAIN
    when the PG re-peers.  Both complete the write inside its deadline and read it
    back byte-exact."""
    for pkg in ("jax", "torch"):
        outcome, back, resends = asyncio.run(
            _a_write_while_a_member_dies(pkg, tmp_path, pool, late_map))
        assert outcome == 0, pkg
        assert back == data(40000, 7), pkg
        assert resends >= 1, pkg


# -- a device error in a mgr module stops the mgr ------------------------------


@pytest.mark.parametrize("kind", ["device", "other"])
def test_a_device_error_in_a_mgr_module_stops_the_mgr(kind, tmp_path):
    """The port's `Mgr._module_loop`: a module whose tick raises a device
    error (`ops.guard.DeviceError`) stops the mgr, which records it in
    `failed`; one that raises `ValueError` is logged, and the loop runs
    it again next tick."""
    from ceph_tpu_torch.mgr.modules import MgrModule
    from ceph_tpu_torch.ops.guard import DeviceError
    from test_torch_mgr import cluster

    class Faulty(MgrModule):
        NAME = "faulty"
        ticks = 0

        def tick(self):
            Faulty.ticks += 1
            raise DeviceError("launch failed") if kind == "device" else ValueError("a bug")

    async def run():
        c = cluster("torch", 1, [], tmp_path)
        try:
            await c.start()
            c.mgr.register_module(Faulty())
            await wait_until(lambda: Faulty.ticks >= 2 or c.mgr.failed is not None, 10.0,
                             "the faulty module's ticks")
            await asyncio.sleep(0.1)
            return c.mgr.failed, c.mgr._running, Faulty.ticks
        finally:
            await c.stop()

    failed, running, ticks = asyncio.run(run())
    if kind == "device":
        assert isinstance(failed, DeviceError) and not running and ticks == 1
    else:
        assert failed is None and running and ticks >= 2


async def _completions_between_ticks(pkg):
    """A real `Mgr`'s module loop runs the progress module while a daemon
    reports, every 0.1 s, a PG recovery and its share of a whole-OSD
    rebuild.  Just after a tick the work completes: the daemon sends its
    final done == total reports three times, 0.1 s apart (three
    heartbeats, as the PG and the storm controller do), then reports
    nothing, all before the next tick.  What the module counts."""
    import json

    mgr_mod = importlib.import_module(f"{ROOT[pkg]}.mgr.mgr")
    progress = importlib.import_module(f"{ROOT[pkg]}.mgr.progress")
    msgs = importlib.import_module(f"{ROOT[pkg]}.msg.messages")
    monmap = importlib.import_module(f"{ROOT[pkg]}.mon.monmap")
    mgr = mgr_mod.Mgr("x", monmap.MonMap(addrs={"a": "127.0.0.1:6789"}))
    mod = progress.ProgressModule(stall_sec=30.0)
    mgr.register_module(mod)
    ticked = asyncio.Event()
    tick = mod.tick

    def tick_and_signal():
        tick()
        ticked.set()

    mod.tick = tick_and_signal
    mgr._running = mgr.active = True

    def report(done, total):
        status = {"up": True}
        if total:
            status["progress"] = {"1.0": [{"kind": "recovery", "objects_done": done,
                                           "objects_total": total, "bytes_done": done << 16,
                                           "bytes_total": 0}]}
            status["recovery_storm"] = {"victims": ["osd.3"], "objects_done": done,
                                        "objects_total": total}
        mgr.ms_dispatch(None, msgs.MMgrReport(daemon="osd.0", perf=b"{}",
                                              status=json.dumps(status).encode()))

    task = asyncio.ensure_future(mgr._module_loop())
    try:
        for done in range(4):  # in flight across two ticks
            report(done, 8)
            ticked.clear()
            await asyncio.wait_for(ticked.wait(), 5.0)
        for _ in range(3):  # the final reports, between two ticks
            report(8, 8)
            await asyncio.sleep(0.1)
        report(0, 0)
        await asyncio.sleep(progress.ProgressModule.EVENT_EXPIRE_SEC + 2.5)
        return mod.completed, mod.expired
    finally:
        mgr._running = False
        task.cancel()
        await asyncio.gather(task, return_exceptions=True)


def test_completions_between_ticks_count_completed_in_the_port():
    """ROADMAP C24: the reference's progress module reads each daemon's
    latest report at its 1 s tick, so a completion whose three final
    reports fall between two ticks is missed, and the recovery and the
    rebuild bar vanish below their totals: both counted expired.  The
    port's mgr hands every report to the module, which counts both
    completed."""
    assert asyncio.run(_completions_between_ticks("jax")) == (0, 2)
    assert asyncio.run(_completions_between_ticks("torch")) == (2, 0)
