"""Drills for the port's chaos harness (`ceph_tpu_torch/tools/chaos.py`),
on the CPU.

ROADMAP C32, the port's launch-fault policy under load: a failed launch
is EIO for its riders, never a host recompute, so a client write whose
encode launch failed is unacknowledged (-EIO) and reads back absent or
whole; a wedged pipelined group's tickets raise EIO at their reap while
the other in-flight groups' tickets stay byte-exact; and a device error
is never retried or read as a failed write.  Beside each, the reference
acknowledges the write and recomputes the wedged tickets on its host
oracle.

ROADMAP C33, C34 and C35, the port's repairs, all found running the
harness: a connection whose accept completed after its messenger's
shutdown closed the connections it knew of held that shutdown (a
daemon's stop) for its whole 15 s bound; an EC write whose interval
ended before its encode was reaped went out to the new acting set while
the PG peered, so a member that had answered the new interval's query
held a write the primary counted missing there; and a daemon's peers
judged a restarted daemon by the last reply of the instance before, so
they reported it at their next tick and it was marked down again.

Also pinned to the reference's output: `_osd_conf`, `_mon_conf`,
`_p99_from_histogram` and the configuration dicts `run_chaos` builds.
"""

import asyncio
import json
import time

import numpy as np
import pytest

from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)

import ceph_tpu.tools.chaos as ref_chaos
import ceph_tpu_torch.tools.chaos as chaos
from ceph_tpu_torch.client import Rados
from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.codec.interface import EcError
from ceph_tpu_torch.codec.matrix_codec import EncodeAggregator
from ceph_tpu_torch.codec.registry import instance as registry
from ceph_tpu_torch.common.errs import EIO, ENOENT
from ceph_tpu_torch.common.fault_injector import global_injector
from ceph_tpu_torch.mon import MonMap, Monitor
from ceph_tpu_torch.msg.frames import TAG_HELLO, Frame
from ceph_tpu_torch.msg.messenger import Messenger
from ceph_tpu_torch.ops import dispatch
from ceph_tpu_torch.ops.guard import DeviceError, device_guard
from ceph_tpu_torch.osd.osd import OSD
from ceph_tpu_torch.tools.guarded import DEVICE_ERROR_EXIT
from ceph_tpu_torch.tools.vstart import _free_port_addrs


@pytest.fixture
def cpu_guard():
    """The port's guard probes on the CPU, and is healthy before and after."""
    guard = device_guard()
    saved = guard.probe_device
    guard.probe_device = "cpu"
    guard.mark_healthy()
    yield guard
    global_injector().clear()
    guard.probe_device = saved
    guard.mark_healthy()


# ---- C32: a write failed by an armed codec.launch --------------------------


async def _rs21_cluster():
    """One monitor and four port OSDs on the CPU, pool `p` RS(2,1) plugin
    `tpu` (the chaos harness's profile), pg_num 4."""
    monmap = MonMap(addrs=_free_port_addrs(1))
    cfg = {"seed": 0}
    mons = [Monitor(n, monmap, election_timeout=0.3, conf=chaos._mon_conf(cfg), device="cpu")
            for n in monmap.addrs]
    for m in mons:
        await m.start()
    for m in mons:
        await m.wait_for_quorum()
    osds = [OSD(i, monmap, conf=chaos._osd_conf(i), device="cpu") for i in range(4)]
    for o in osds:
        await o.start()
    for o in osds:
        await o.wait_for_up()
    client = Rados(monmap)
    await client.connect()
    rv, rs, _ = await client.mon_command({"prefix": "osd erasure-code-profile set",
                                          "name": "rs21",
                                          "profile": ["k=2", "m=1", "plugin=tpu"]})
    assert rv == 0, rs
    await client.pool_create("p", "erasure", profile="rs21", pg_num=4)
    return mons, osds, client, await client.open_ioctx("p")


async def _stop(mons, osds, client):
    await client.shutdown()
    for o in osds:
        if o._running:
            await o.stop()
    for m in mons:
        await m.stop()


def test_a_write_failed_by_a_launch_fault_is_eio_and_reads_back_absent_or_whole(cpu_guard):
    async def run():
        mons, osds, client, io = await _rs21_cluster()
        try:
            await io.write_full("before", b"b" * 8192)
            degraded0, fallback0 = cpu_guard.degraded_total, dispatch.FALLBACK_LAUNCHES.snapshot()
            global_injector().inject("codec.launch", EIO, hits=1)
            data = bytes(np.random.default_rng(5).integers(0, 256, 16384, dtype=np.uint8))
            with pytest.raises(RadosError) as err:
                await io.write_full("failed", data)
            assert err.value.errno == -EIO
            global_injector().clear("codec.launch")
            assert cpu_guard.degraded_total == degraded0 + 1
            deadline = time.monotonic() + 10
            while not cpu_guard.maybe_probe():  # the probe heals it
                assert time.monotonic() < deadline
                await asyncio.sleep(0.05)
            try:
                back = await io.read("failed")
            except RadosError as e:
                assert e.errno == -ENOENT
            else:
                assert back == data  # rolled forward: whole, never other bytes
            assert dispatch.FALLBACK_LAUNCHES.snapshot() == fallback0
            # the backend healed: the next write is acknowledged
            await io.write_full("after", data)
            assert await io.read("after") == data
            assert await io.read("before") == b"b" * 8192
        finally:
            await _stop(mons, osds, client)

    asyncio.run(run())


# ---- C32: the pipelined wedge ----------------------------------------------


def _wedge(ec, agg, batches, inj, arm):
    """Submit the first half healthy, arm while those groups are in
    flight, submit the rest and flush: chaos phase 3.7's order."""
    half = len(batches) // 2
    tickets = [agg.submit(ec, b) for b in batches[:half]]
    arm()
    tickets += [agg.submit(ec, b) for b in batches[half:]]
    agg.flush()
    inj.clear("codec.launch")
    return tickets


def test_a_wedged_pipelined_ticket_raises_and_the_others_are_byte_exact(cpu_guard):
    rng = np.random.default_rng(0x11)
    batches = [rng.integers(0, 256, (2, 4, 4096), dtype=np.uint8) for _ in range(8)]
    ec = registry().factory("tpu", {"k": "4", "m": "2"}, device="cpu")
    oracle = [ec.encode_array_host(b) for b in batches]
    agg = EncodeAggregator(window=2, pipeline_depth=2)
    inj = global_injector()
    inflight = []

    def arm():
        inflight.append(dispatch.PIPELINE.snapshot()["inflight"])
        inj.inject("codec.launch", EIO, hits=2)

    tickets = _wedge(ec, agg, batches, inj, arm)
    failed = []
    for i, t in enumerate(tickets):
        try:
            got = t.result()
        except EcError as e:
            assert e.errno == -EIO
            failed.append(i)
        else:
            assert np.array_equal(got, oracle[i]), i
    assert inflight[0] >= 2  # the faults landed with two launches in flight
    assert failed == [4, 5, 6, 7]
    assert cpu_guard.maybe_probe()
    again = [agg.submit(ec, batches[i]) for i in failed]
    agg.flush()
    for i, t in zip(failed, again):
        assert np.array_equal(t.result(), oracle[i])
    agg.drain()

    # the reference recomputes the same wedged tickets on its host oracle
    from ceph_tpu.codec.matrix_codec import EncodeAggregator as RefAggregator
    from ceph_tpu.codec.registry import instance as ref_registry
    from ceph_tpu.common.fault_injector import global_injector as ref_injector
    from ceph_tpu.ops.guard import device_guard as ref_guard
    from ceph_tpu.parallel import dispatch as ref_dispatch

    width = ref_dispatch.settings()
    ref_dispatch.configure(devices=1)  # the port's width (its tests' mesh would shard)
    try:
        ref_ec = ref_registry().factory("tpu", {"k": "4", "m": "2"})
        ref_agg = RefAggregator(window=2, pipeline_depth=2)
        ref_inj = ref_injector()
        ref_tickets = _wedge(ref_ec, ref_agg, batches, ref_inj,
                             lambda: ref_inj.inject("codec.launch", EIO, hits=2))
        assert all(np.array_equal(np.asarray(t.result()), o)
                   for t, o in zip(ref_tickets, oracle))
        ref_agg.drain()
    finally:
        ref_inj.clear()
        ref_guard().mark_healthy()
        ref_dispatch.configure(*width)


# ---- a device error in phase 2's read loop ---------------------------------


def test_a_device_error_in_the_eio_read_loop_is_not_retried(monkeypatch):
    """Phase 2 retries a read that answers -EIO; a device error raised by
    a read ends the run on the spot."""
    from ceph_tpu_torch.client.rados import IoCtx

    reads_after_arm = []
    real_inject, real_read = global_injector().inject, IoCtx.read

    def inject(point, err, hits=-1):
        if point == "ec.sub_read":
            async def read(self, oid, *args, **kwargs):
                reads_after_arm.append(oid)
                raise DeviceError("device lost")

            monkeypatch.setattr(IoCtx, "read", read)
        return real_inject(point, err, hits=hits)

    monkeypatch.setattr(global_injector(), "inject", inject)
    with pytest.raises(DeviceError, match="device lost"):
        chaos.run_chaos(seed=0xC405, smoke=True, device="cpu")
    assert reads_after_arm == ["base0"]  # one read, no retry
    monkeypatch.setattr(IoCtx, "read", real_read)


# ---- main's exits -----------------------------------------------------------


@pytest.mark.parametrize("error, rc", [(DeviceError("card gone"), DEVICE_ERROR_EXIT),
                                       (AssertionError("chaos: lost"), 1)])
def test_main_writes_the_payload_then_exits(monkeypatch, tmp_path, capsys, error, rc):
    def fail(**kwargs):
        assert kwargs["device"] == "cpu"
        raise error

    monkeypatch.setattr(chaos, "run_chaos", fail)
    out = tmp_path / "chaos.json"
    assert chaos.main(["--smoke", "--device", "cpu", "--out", str(out)]) == rc
    payload = json.loads(out.read_text())
    assert payload == {"converged": False, "error": repr(error)}
    captured = capsys.readouterr()
    assert json.loads(captured.out.splitlines()[0]) == payload
    assert ("device error" in captured.err) == (rc == DEVICE_ERROR_EXIT)


# ---- C33: an accept that completes during a shutdown -----------------------


def test_a_connection_accepted_during_shutdown_does_not_hold_it_in_the_port():
    async def run():
        m = Messenger("osd.9")
        await m.bind("127.0.0.1:0")
        host, port = m.addr.rsplit(":", 1)
        reader, writer = await asyncio.open_connection(host, int(port))
        await asyncio.sleep(0.05)  # accepted: the handler waits for the hello
        t0 = time.monotonic()
        stop = asyncio.create_task(m.shutdown())
        await asyncio.sleep(0.05)  # the shutdown closed what it knew of
        writer.write(Frame(TAG_HELLO, [b"osd.8", b"127.0.0.1:1", bytes([0])]).pack(m.crc_data))
        await writer.drain()
        await stop
        writer.close()
        return time.monotonic() - t0, m._accepted

    seconds, accepted = asyncio.run(run())
    assert seconds < 2.0  # the reference's copy waits out its 15 s bound
    assert accepted == []


# ---- C34: a write whose interval ended before its encode was reaped ---------


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_write_reaped_after_its_interval_ended_sends_nothing_in_the_port(pkg):
    """RS(2,1) on three backends: a write is submitted, then shard 1's
    member goes (the acting set changes) before the encode is reaped.  The
    port answers the write -EAGAIN (the client resends it into the new
    interval) and sends no sub-write; the reference sends the old
    interval's write to the new acting set and commits it there."""
    from test_torch_ec_backend import Cluster

    from ceph_tpu_torch.common.errs import EAGAIN

    c = Cluster(pkg, k=2, m=1)
    c.write("before", 0, b"a" * c.sw)
    events = []
    c.sent.clear()
    c.submit(c.pgt("obj").write(0, b"b" * c.sw), 7, events, "w")
    c.acting = [0, c.m.osdmap.PG_NONE, 2]  # a new interval before the reap
    c.pump()
    sub_writes = [name for _osd, name, _raw in c.sent if name == "MOSDECSubOpWrite"]
    if pkg == "torch":
        assert events == [("w", "fail", -EAGAIN)]
        assert sub_writes == []
        assert not c.listeners[0].clog  # an interval change is no error
    else:
        assert events == [("w", "commit")]
        assert len(sub_writes) == 2


# ---- C35: a restarted peer's grace starts over ------------------------------


@pytest.mark.parametrize("root", ["ceph_tpu", "ceph_tpu_torch"])
def test_a_restarted_peer_is_judged_from_its_first_ping_in_the_port(root, monkeypatch):
    """osd.0 last heard osd.3 two seconds ago (grace 0.6 s); the map then
    marks osd.3 down and brings it back at another address.  At osd.0's
    next heartbeat check the port reports nothing (osd.3's grace starts
    at the first ping to the new instance); the reference reports it."""
    import importlib
    import time as _time

    osd_mod = importlib.import_module(f"{root}.osd.osd")
    om = importlib.import_module(f"{root}.osd.osdmap")
    mm = importlib.import_module(f"{root}.msg.messages")
    mon_mod = importlib.import_module(f"{root}.mon")
    kw = {"device": "cpu"} if root == "ceph_tpu_torch" else {}
    o = osd_mod.OSD(0, mon_mod.MonMap(addrs={"a": "127.0.0.1:1"}), conf=chaos._osd_conf(0), **kw)
    reports = []
    monkeypatch.setattr(o, "_report_failure", lambda peer, failed_for, laggy=0:
                        reports.append(peer))
    m = om.OSDMap()
    for i in range(4):
        m.add_osd(i, addr=f"127.0.0.1:{100 + i}")
    maps = []
    for change in (None, (False, None), (True, "127.0.0.1:200")):
        m.epoch += 1
        if change is not None:
            m.set_osd_state(3, *change)
        maps.append(m.tobytes())
    o._on_osdmap_msg(mm.MOSDMap(fsid="", maps={1: maps[0]}, incrementals={}))
    now = _time.monotonic()
    o._hb_first_tx[3] = now - 5.0
    o._hb_last_rx[3] = now - 2.0  # the old instance's last reply
    for epoch in (2, 3):
        o._on_osdmap_msg(mm.MOSDMap(fsid="", maps={epoch: maps[epoch - 1]}, incrementals={}))
    assert o.osdmap.osds[3].up and o.osdmap.osds[3].addr == "127.0.0.1:200"
    o._heartbeat_check(_time.monotonic())
    assert reports == ([] if root == "ceph_tpu_torch" else [3])


# ---- pinned to the reference ------------------------------------------------


def test_confs_and_p99_match_the_reference():
    for i in range(6):
        assert chaos._osd_conf(i).diff() == ref_chaos._osd_conf(i).diff()
    for cfg in ({"seed": 1}, {"seed": 2, "smoke": True}):
        assert chaos._mon_conf(cfg).diff() == ref_chaos._mon_conf(cfg).diff()
    assert chaos._osd_complaint_default() == ref_chaos._osd_complaint_default()
    dumps = [
        None, {}, {"histogram": {"count": 0, "buckets": []}},
        {"histogram": {"count": 100, "buckets": [[0.001, 50], [0.01, 99], [0.1, 100],
                                                  ["+Inf", 100]]}},
        {"histogram": {"count": 10, "buckets": [[0.001, 1], ["+Inf", 10]]}},
        {"histogram": {"count": 10, "buckets": [[0.001, 1], [0.002, 5]]}},
    ]
    for d in dumps:
        assert chaos._p99_from_histogram(d) == ref_chaos._p99_from_histogram(d)


@pytest.mark.parametrize("kwargs", [{}, {"smoke": True}, {"seed": 7, "osds": 6, "objects": 12,
                                                          "pg_num": 8}])
def test_run_chaos_builds_the_references_configuration(monkeypatch, kwargs):
    seen = {}

    async def port_run(cfg, device):
        seen["port"], seen["device"] = cfg, device
        return {}

    async def ref_run(cfg):
        seen["ref"] = cfg
        return {}

    monkeypatch.setattr(chaos, "_run", port_run)
    monkeypatch.setattr(ref_chaos, "_run", ref_run)
    chaos.run_chaos(device="cpu", **kwargs)
    ref_chaos.run_chaos(**kwargs)
    assert seen["port"] == seen["ref"]
    assert seen["device"].type == "cpu"
