"""Where the port's MDS differs from the JAX package's, on the CPU: each
drill runs the reference beside the port.

- C29, an EIO taken for "absent" (C26's fault, in the MDS).  The
  inode table and the dirfrags live on an RS(4,2) overwrites pool (the
  embedded mode, the map service's cluster; the journal on a replicated
  pool, `SplitMeta`), and the daemon holding the first data shard of
  `mds_inotable` and of one directory's frag (all the bytes of such small
  objects) stops, so their reads decode.  A `codec.launch` fault (the
  fault point of the C6-C8 drills) fails the next launch, once before a
  promotion and once before a create in that directory.  The reference
  recomputes the failed decode on its host and keeps every entry.  The
  port recomputes nothing: the promotion fails (the daemon records the
  EIO in `failed` and stops) and the create is answered -EIO; once the
  guard is healthy a new daemon serves every entry.  With the
  reference's catches the port would re-make the filesystem over live
  metadata, or write the directory back holding only the new file; the
  drill runs that variant too.
- C30, the MDS monitor's beacon judge under a held loop: with the monitor
  loop held past `BEACON_GRACE`, the reference fails a healthy active
  over and the port does not.  And under a slow loop: the loop is held
  in slices, each less than half the grace, that add up past it, while
  the beacons wait (a beacon crosses several of the loop's passes, a
  tick one); no tick is late enough to judge nothing, the reference
  fails the active over, and the port, which measures a daemon's silence
  without the ticks' lost time, does not.
- The revoke wait under a held loop: a holder's overwrite is in flight
  when another client's open revokes its caps, and the loop is held past
  `REVOKE_TIMEOUT`.  The reference drops the holder and grants the cap
  before the holder's write has landed; the port waits again, the holder
  acks once its write is done, and then the cap is granted.  A holder
  that stays silent is dropped in both.
- A device error in the flush and in a request stops the port's MDS
  (`MDS.failed`; the request is answered -EIO); the reference logs it
  and goes on.
- A resend of a request still in flight is harmless in both: it waits
  for the first and replays its reply.
- In mon mode a failed activation stops the daemon, and the monitor's
  grace hands rank 0 to a standby, which serves the namespace.
"""

import asyncio
import importlib
import json
import time

import pytest

from test_torch_ec_backend import _pin_reference  # noqa: F401 (autouse)
from test_torch_mds_diff import mods
from torch_access_host import ROOT, connect, make_cluster, settle
from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)
from torch_ported import cpu_daemons  # noqa: F401 (fixture)

EC_META = [dict(name="meta", kind="ec", k=4, m=2, pg_num=8, stripe_unit=4096, overwrites=True),
           dict(name="data", kind="rep", size=3, pg_num=8)]
JOURNAL_OIDS = ("mds_journal", "mds_journal_head", "mds_completed")
REP = [dict(name="meta", kind="rep", size=3, pg_num=8),
       dict(name="data", kind="ec", k=4, m=2, pg_num=8, stripe_unit=4096, overwrites=True)]
CUDA_ERROR = "CUDA error: an illegal memory access was encountered"


def first_shard(c, pool: str, oid: str) -> int:
    """The daemon holding `oid`'s first data shard, where the bytes of an
    object smaller than a stripe unit lie."""
    pgid, _primary = c.client.target(pool, oid)
    return c.mon.osdmap.pg_to_up_acting_osds(pgid.pool, pgid.ps)[2][0]


class SplitMeta:
    """The MDS's metadata I/O context: the inode table and the dirfrags
    on `ec`, the journal, its head and the completed table on `rep`.  The
    reference trims its journal with a zero-length `write_full`, which
    hangs on an EC overwrites pool (ROADMAP C27), so its journal cannot
    live on one."""

    def __init__(self, ec, rep):
        self.ec, self.rep = ec, rep

    def _io(self, oid: str):
        return self.rep if oid in JOURNAL_OIDS else self.ec

    def read(self, oid, *a, **kw):
        return self._io(oid).read(oid, *a, **kw)

    def write_full(self, oid, *a, **kw):
        return self._io(oid).write_full(oid, *a, **kw)

    def append(self, oid, *a, **kw):
        return self._io(oid).append(oid, *a, **kw)

    def remove(self, oid, *a, **kw):
        return self._io(oid).remove(oid, *a, **kw)


def broad_catches(monkeypatch, root: str) -> None:
    """The reference's catches on the port's MDS."""
    mds_mod = importlib.import_module(f"{root}.mds.mds")
    MDS = mds_mod.MDS

    async def _load_or_mkfs(self):
        try:
            self._next_ino = json.loads((await self.meta.read(mds_mod.INOTABLE_OID)).decode())["next"]
        except Exception:
            self._next_ino = 2
            await self.meta.write_full(mds_mod.INOTABLE_OID, json.dumps({"next": 2}).encode())
            await self.meta.write_full(f"dir.{mds_mod.ROOT_INO}", b"{}")
        try:
            raw = await self.meta.read(mds_mod.COMPLETED_OID)
            for client, tid, rec in json.loads(raw.decode() or "[]"):
                self._completed[(client, int(tid))] = rec
        except Exception:
            pass

    async def _dir(self, ino):
        d = self._dirs.get(ino)
        if d is None:
            try:
                d = json.loads((await self.meta.read(f"dir.{ino}")).decode() or "{}")
            except Exception:
                d = {}
            self._dirs[ino] = d
            for name, entry in d.items():
                if entry.get("type") == "file":
                    self._ino_loc.setdefault(entry["ino"], (ino, name))
        return d

    monkeypatch.setattr(MDS, "_load_or_mkfs", _load_or_mkfs)
    monkeypatch.setattr(MDS, "_dir", _dir)


async def listing(m, fsc, path: str):
    try:
        return await fsc.listdir(path)
    except m.client.FsClientError as e:
        return e.errno


async def eio_under_the_mds(pkg: str, tmp_path, monkeypatch, at: str, broad: bool) -> dict:
    root = ROOT[pkg]
    m = mods(pkg)
    faults = importlib.import_module(f"{root}.common.fault_injector").global_injector()
    guard_mod = importlib.import_module(f"{root}.ops.guard")
    if pkg == "torch":
        # the probe heals the guard, as on a card whose fault was transient
        monkeypatch.setattr(guard_mod, "_default_probe", lambda: None)
    if broad:
        broad_catches(monkeypatch, root)
    c = make_cluster(pkg, tmp_path, pools=EC_META, n_osds=7)
    r = None
    daemons, clients = [], []

    async def new_mds(fail_ok: bool = False):
        d = m.mds.MDS(meta, data, addr="", stack="inproc")
        daemons.append(d)
        try:
            await d.start()
        except m.rados.RadosError as e:
            assert fail_ok
            return d, e.errno
        return d, 0

    def client(d):
        fsc = m.client.CephFSClient(d.addr, data, stack="inproc", name=f"client.{len(clients)}")
        clients.append(fsc)
        return fsc

    try:
        await c.start(30)
        r, _ = await connect(pkg, c)
        data = await r.open_ioctx("data")
        meta = SplitMeta(await r.open_ioctx("meta"), data)
        victim = first_shard(c, "meta", m.mds.INOTABLE_OID)
        target = next(n for n in range(2, 400) if first_shard(c, "meta", f"dir.{n}") == victim)
        mds, _ = await new_mds()
        fsc = client(mds)
        for n in range(2, target + 1):
            await fsc.mkdir(f"/d{n}")
        assert (await fsc.stat(f"/d{target}"))["ino"] == target
        for j in range(3):
            await fsc.write_file(f"/d{target}/f{j}", bytes([j]) * 3000)
        await mds.stop()  # flushed: the entries are in their dirfrags
        await c.stop_osd(victim)
        c.mon.mark_down(victim)
        await settle(c)
        out = {}
        if at == "promotion":
            faults.inject("codec.launch", 5, hits=1)
        mds2, out["promotion"] = await new_mds(fail_ok=True)
        out["failed"] = repr(getattr(mds2, "failed", None))
        faults.clear()
        guard_mod.device_guard().mark_healthy()
        if out["promotion"]:
            mds2, _ = await new_mds()
        fsc2 = client(mds2)
        out["served"] = await listing(m, fsc2, "/")  # the root's frag is cached now
        if at == "create":
            faults.inject("codec.launch", 5, hits=1)
        try:
            await (await fsc2.create(f"/d{target}/new")).close()
            out["create"] = 0
        except m.client.FsClientError as e:
            out["create"] = e.errno
        faults.clear()
        guard_mod.device_guard().mark_healthy()
        await mds2._flush()
        await mds2.stop()
        mds3, _ = await new_mds()
        fsc3 = client(mds3)
        out["root"] = await listing(m, fsc3, "/")
        out["dir"] = await listing(m, fsc3, f"/d{target}")
        out["target"] = target
        return out
    finally:
        faults.clear()
        for fsc in clients:
            await fsc.shutdown()
        for d in daemons:
            await d.stop(flush=False)
        if r is not None:
            await r.shutdown()
        await c.stop()


@pytest.mark.parametrize("at", ["promotion", "create"])
def test_an_eio_under_the_mds_loses_no_entry(tmp_path, monkeypatch, at):
    ref = asyncio.run(eio_under_the_mds("jax", tmp_path, monkeypatch, at, False))
    dirs = [f"d{n}" for n in range(2, ref["target"] + 1)]
    assert ref == {"promotion": 0, "failed": "None", "served": sorted(dirs), "create": 0,
                   "root": sorted(dirs), "dir": ["f0", "f1", "f2", "new"],
                   "target": ref["target"]}
    ours = asyncio.run(eio_under_the_mds("torch", tmp_path, monkeypatch, at, False))
    if at == "promotion":
        # the promotion failed, the daemon stopped; a new one serves all
        assert ours["promotion"] == -5 and "RadosError" in ours["failed"]
        assert ours["create"] == 0 and ours["dir"] == ["f0", "f1", "f2", "new"]
    else:
        assert ours["promotion"] == 0 and ours["failed"] == "None"
        assert ours["create"] == -5 and ours["dir"] == ["f0", "f1", "f2"]
    assert ours["root"] == sorted(dirs)


@pytest.mark.parametrize("at", ["promotion", "create"])
def test_the_reference_catches_would_lose_the_entries_in_the_port(tmp_path, monkeypatch, at):
    got = asyncio.run(eio_under_the_mds("torch", tmp_path, monkeypatch, at, True))
    if at == "promotion":
        # a fresh filesystem over the live one: the root is empty
        assert (got["promotion"], got["root"], got["dir"]) == (0, [], -2)
        assert got["create"] == -2
    else:
        # the unreadable frag taken for empty, written back with the new file
        assert (got["create"], got["dir"]) == (0, ["new"])


# -- C30: the beacon judge under a held loop -----------------------------------


async def held_monitor(pkg: str, slices: int) -> dict:
    """A dev cluster with an active MDS and a standby; the one event loop
    is held for 1.5 s past the beacon grace, in one piece or in `slices`
    holds with a 50 ms turn of the loop between them while the beacons
    wait; what the FSMap says afterwards."""
    root = ROOT[pkg]
    vstart = importlib.import_module(f"{root}.tools.vstart")
    grace = importlib.import_module(f"{root}.mon.mds_monitor").BEACON_GRACE
    interval = importlib.import_module(f"{root}.mds.mds").BEACON_INTERVAL
    kw = {"device": "cpu"} if pkg == "torch" else {}
    cluster = vstart.DevCluster(n_mons=1, n_osds=3, with_mgr=False, with_mds=True, **kw)
    await cluster.start()
    try:
        active = cluster.mds
        mdsmon = cluster.mons[0].mdsmon
        await asyncio.sleep(1.5)  # beacons flowing
        hold = (grace + 1.5) / slices
        assert slices == 1 or hold < grace / 2
        waiting: list = []
        if slices > 1:
            mdsmon.prepare_beacon = waiting.append
        for _ in range(slices):
            time.sleep(hold)  # the held loop
            if slices > 1:
                await asyncio.sleep(0.05)
        if slices > 1:
            del mdsmon.prepare_beacon
            for msg in waiting:  # the beacons land once the loop runs freely
                mdsmon.prepare_beacon(msg)
        # watched past one grace and one beacon interval after the hold
        deadline = time.monotonic() + grace + interval + 13.0
        moved = False
        while time.monotonic() < deadline:
            await asyncio.sleep(0.1)
            fs = mdsmon.map.filesystems["cephfs"]
            if fs["active_name"] != active.name:
                moved = True
                if any(d.state == "active" and d is not active for d in cluster.mds_daemons):
                    break
            elif pkg == "torch" and time.monotonic() > deadline - 11.0:
                break  # a grace, a beacon interval and 2 s after the hold
        out = {"moved": moved, "active_state": active.state,
               "stalls": getattr(mdsmon, "beacon_stalls", None)}
        if moved:  # the daemon the reference failed over is the zombie now
            cluster.mds_daemons.remove(active)
            cluster.mds = next(d for d in cluster.mds_daemons if d.state == "active")
            for t in (active._flush_task, active._activate_task, active._beacon_task):
                if t is not None:
                    t.cancel()
            await active.msgr.shutdown()
            if active.monc is not None:
                await active.monc.msgr.shutdown()
        return out
    finally:
        await cluster.stop()


@pytest.mark.usefixtures("cpu_daemons")
def test_a_held_monitor_loop_fails_no_healthy_mds_over_in_the_port():
    ref = asyncio.run(held_monitor("jax", 1))
    assert ref["moved"] and ref["stalls"] is None
    ours = asyncio.run(held_monitor("torch", 1))
    assert ours == {"moved": False, "active_state": "active", "stalls": 1}


@pytest.mark.usefixtures("cpu_daemons")
def test_a_slow_monitor_loop_fails_no_healthy_mds_over_in_the_port():
    """Ticks each less than half the grace late, whose lateness adds up
    past the grace: only the silence rule keeps the active."""
    ref = asyncio.run(held_monitor("jax", 4))
    assert ref["moved"] and ref["stalls"] is None
    ours = asyncio.run(held_monitor("torch", 4))
    assert ours == {"moved": False, "active_state": "active", "stalls": 0}


# -- the revoke wait under a held loop -----------------------------------------


async def revoke_under_a_held_loop(pkg: str, tmp_path, hold: bool) -> dict:
    """Client a holds a file for writing with an overwrite in flight (its
    data write waits on `gate`); client b opens the file for writing.
    With `hold`, the loop is held past the revoke timeout once the revoke
    is out, and the gate opens as the hold ends; without, the gate never
    opens (a silent holder).  The order of a's write landing and b's
    grant, and the port's late revoke waits."""
    m = mods(pkg)
    c = make_cluster(pkg, tmp_path, pools=REP)
    r = mds = None
    clients = []
    try:
        await c.start(30)
        r, _ = await connect(pkg, c)
        meta = await r.open_ioctx("meta")
        mds = m.mds.MDS(meta, await r.open_ioctx("data"), addr="", stack="inproc")
        await mds.start()
        io_a, io_b = await r.open_ioctx("data"), await r.open_ioctx("data")
        a = m.client.CephFSClient(mds.addr, io_a, name="client.a", stack="inproc")
        b = m.client.CephFSClient(mds.addr, io_b, name="client.b", stack="inproc")
        clients += [a, b]
        fh = await a.create("/f")
        await fh.write(b"a" * 100)
        gate = asyncio.Event()
        write = io_a.write

        async def gated(*args, **kw):
            await gate.wait()
            return await write(*args, **kw)

        io_a.write = gated
        timeline = []

        async def overwrite():
            try:
                await fh.write(b"A" * 50, 0)  # within the size: no setattr
                timeline.append("a's write landed")
            except m.client.FsClientError as e:
                timeline.append(f"a's write failed {e.errno}")

        async def open_b():
            fh_b = await b.open("/f", "w")
            timeline.append("b granted")
            return fh_b

        w = asyncio.ensure_future(overwrite())
        await asyncio.sleep(0.05)
        o = asyncio.ensure_future(open_b())
        while not mds._revoke_waiters:
            await asyncio.sleep(0)
        await asyncio.sleep(0.05)  # the MDS waits for a's ack now
        if hold:
            time.sleep(m.mds.REVOKE_TIMEOUT + 0.5)
            gate.set()
        fh_b = await asyncio.wait_for(o, 20.0)
        gate.set()
        await asyncio.wait_for(w, 20.0)
        await fh_b.close()
        return {"timeline": timeline, "stalls": getattr(mds, "revoke_stalls", None),
                "data": await b.read_file("/f")}
    finally:
        for fsc in clients:
            await fsc.shutdown()
        if mds is not None:
            await mds.stop()
        if r is not None:
            await r.shutdown()
        await c.stop()


def test_a_held_loop_drops_no_live_holder_in_the_port(tmp_path):
    ref = asyncio.run(revoke_under_a_held_loop("jax", tmp_path, hold=True))
    assert ref["timeline"] == ["b granted", "a's write landed"] and ref["stalls"] is None
    ours = asyncio.run(revoke_under_a_held_loop("torch", tmp_path, hold=True))
    assert ours == {"timeline": ["a's write landed", "b granted"], "stalls": 1,
                    "data": b"A" * 50 + b"a" * 50}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_a_silent_holder_is_dropped_in_both(tmp_path, pkg):
    got = asyncio.run(revoke_under_a_held_loop(pkg, tmp_path, hold=False))
    assert got["timeline"] == ["b granted", "a's write landed"]
    assert got["stalls"] == (0 if pkg == "torch" else None)


# -- a device error on the MDS's paths -----------------------------------------


async def device_error(pkg: str, tmp_path, where: str) -> dict:
    """A device error (torch's bare CUDA RuntimeError) raised in the
    MDS's flush or in a request's handler."""
    m = mods(pkg)
    c = make_cluster(pkg, tmp_path, pools=REP)
    r = mds = fsc = None
    try:
        await c.start(30)
        r, _ = await connect(pkg, c)
        meta, data = await r.open_ioctx("meta"), await r.open_ioctx("data")
        mds = m.mds.MDS(meta, data, addr="", stack="inproc")
        await mds.start()
        fsc = m.client.CephFSClient(mds.addr, data, stack="inproc")
        await fsc.mkdir("/before")

        async def broken(*args, **kw):
            raise RuntimeError(CUDA_ERROR)

        out = {}
        if where == "flush":
            meta.write_full = broken
            await fsc.mkdir("/dirty")
            await asyncio.sleep(m.mds.FLUSH_INTERVAL * 3)
        else:
            mds._op_mkdir = broken
            try:
                await fsc.mkdir("/boom")
                out["request"] = 0
            except m.client.FsClientError as e:
                out["request"] = e.errno
        await asyncio.sleep(0.2)
        out["failed"] = repr(getattr(mds, "failed", None))
        try:
            out["after"] = await fsc.listdir("/")
        except m.client.FsClientError as e:
            out["after"] = e.errno
        return out
    finally:
        if fsc is not None:
            await fsc.shutdown()
        if mds is not None:
            mds._running = False  # its flush would meet the broken write again
            await mds.stop(flush=False)
        if r is not None:
            await r.shutdown()
        await c.stop()


@pytest.mark.parametrize("where", ["flush", "request"])
def test_a_device_error_stops_the_mds_in_the_port(tmp_path, where):
    ref = asyncio.run(device_error("jax", tmp_path, where))
    ours = asyncio.run(device_error("torch", tmp_path, where))
    failed = f"RuntimeError('{CUDA_ERROR}')"
    if where == "flush":
        assert ref == {"failed": "None", "after": ["before", "dirty"]}
        assert ours["failed"] == failed and ours["after"] == -11
    else:
        assert ref == {"request": -22, "failed": "None", "after": ["before"]}
        assert ours == {"request": -5, "failed": failed, "after": -11}


# -- a resend of a request still in flight -------------------------------------


async def resend_in_flight(pkg: str, tmp_path) -> dict:
    """A create whose journal append is slow is sent twice with one reqid
    on one session, the second while the first is in flight."""
    m = mods(pkg)
    c = make_cluster(pkg, tmp_path, pools=REP)
    r = mds = fsc = None
    try:
        await c.start(30)
        r, _ = await connect(pkg, c)
        meta, data = await r.open_ioctx("meta"), await r.open_ioctx("data")
        mds = m.mds.MDS(meta, data, addr="", stack="inproc")
        await mds.start()
        fsc = m.client.CephFSClient(mds.addr, data, stack="inproc")
        append = meta.append

        async def slow(*args, **kw):
            await asyncio.sleep(0.5)
            return await append(*args, **kw)

        meta.append = slow
        replies = []
        dispatch = fsc.ms_dispatch

        def recording(conn, msg):
            if type(msg).__name__ == "MClientReply" and msg.tid == 99:
                replies.append((msg.result, json.loads(msg.payload.decode())))
                return True
            return dispatch(conn, msg)

        fsc.ms_dispatch = recording
        request = m.messages.MClientRequest(
            tid=99, op="create", args=json.dumps({"path": "/once", "caps": "w"}).encode(),
            client=fsc.client_id)
        await fsc.msgr.send_to(mds.addr, request)
        await asyncio.sleep(0.1)
        await fsc.msgr.send_to(mds.addr, request)
        for _ in range(500):
            if len(replies) == 2:
                break
            await asyncio.sleep(0.01)
        meta.append = append
        fh = await fsc.open("/once", "w")  # the session holds the caps already
        await fh.write(b"x" * 10)
        await fh.close()
        return {"replies": replies, "listing": await fsc.listdir("/"),
                "size": (await fsc.stat("/once"))["size"]}
    finally:
        if fsc is not None:
            await fsc.shutdown()
        if mds is not None:
            await mds.stop()
        if r is not None:
            await r.shutdown()
        await c.stop()


def test_a_resend_of_a_request_in_flight_is_harmless_in_both(tmp_path, monkeypatch):
    got = {}
    for pkg in ("jax", "torch"):
        monkeypatch.setattr(mods(pkg).mds, "time", type("T", (), {"time": staticmethod(lambda: 1.0)}))
        got[pkg] = asyncio.run(resend_in_flight(pkg, tmp_path))
    assert got["jax"] == got["torch"]
    first, again = got["torch"]["replies"]
    assert first == again and first[0] == 0 and first[1]["caps"] == "w"
    assert got["torch"]["listing"] == ["once"] and got["torch"]["size"] == 10


# -- a failed activation in mon mode -------------------------------------------


@pytest.mark.usefixtures("cpu_daemons")
def test_a_failed_activation_hands_rank_0_to_a_standby():
    """mds.a is active, mds.b and mds.c stand by; b's reads of the
    metadata pool fail.  a crashes: b takes rank 0, fails its activation
    and stops (`failed`), its beacons end, and the monitor's grace hands
    rank 0 to c, which serves every entry."""
    from ceph_tpu_torch.client import Rados
    from ceph_tpu_torch.client.rados import RadosError
    from ceph_tpu_torch.mds import MDS, CephFSClient
    from ceph_tpu_torch.tools.vstart import DevCluster

    async def run():
        cluster = DevCluster(n_mons=1, n_osds=3, with_mgr=False, with_mds=True, device="cpu")
        await cluster.start()
        extra = Rados(cluster.monmap, name="client.mds-c")
        await extra.connect()
        c = MDS(name="c", monmap=cluster.monmap, rados=extra)
        await c.start()
        rados = Rados(cluster.monmap)
        await rados.connect()
        fsc = None
        try:
            data = await rados.open_ioctx("cephfs_data")
            fsc = CephFSClient(data_ioctx=data, monmap=cluster.monmap)
            await fsc.connect()
            await fsc.mkdir("/kept")
            await fsc.write_file("/kept/f", b"still here")
            a = cluster.mds
            b = next(d for d in cluster.mds_daemons if d is not a)

            async def eio(self):
                raise RadosError(-5, "read mds_inotable")

            b._load_or_mkfs = eio.__get__(b)
            await a.stop(flush=False)
            for _ in range(400):
                if c.state == "active":
                    break
                await asyncio.sleep(0.1)
            assert c.state == "active" and isinstance(b.failed, RadosError)
            assert b.state != "active"
            listed = await fsc.listdir("/kept"), await fsc.read_file("/kept/f")
            cluster.mds_daemons.remove(a)
            cluster.mds_daemons.remove(b)
            cluster.mds = c
            cluster.mds_daemons.append(c)
            return listed
        finally:
            if fsc is not None:
                await fsc.shutdown()
            await rados.shutdown()
            await cluster.stop()
            await extra.shutdown()

    assert asyncio.run(run()) == (["f"], b"still here")


# -- the striper's absent objects (C26's remainder) ----------------------------


class FailingIoCtx:
    """A data pool whose `stat` and `remove` fail with `errno`, for a
    striped file of 300000 bytes in 64 KiB units over 2 objects of 1 MiB."""

    def __init__(self, error):
        self.error = error

    async def getxattr(self, oid, name):
        return b"300000"

    async def setxattr(self, oid, name, value):
        pass

    async def truncate(self, oid, size):
        pass

    async def write(self, oid, data, off=0):
        pass

    async def stat(self, oid):
        raise self.error

    async def remove(self, oid):
        raise self.error


async def striper_calls(pkg: str, errno: int) -> dict:
    m = mods(pkg)
    striper = importlib.import_module(f"{ROOT[pkg]}.striper")
    io = FailingIoCtx(m.rados.RadosError(errno, "injected"))
    obj = striper.StripedObject(io, "5", striper.StripePolicy(
        stripe_unit=64 << 10, stripe_count=2, object_size=1 << 20))
    fsc = m.client.CephFSClient("", io)
    entry = {"ino": 5, "layout": {"stripe_unit": 64 << 10, "stripe_count": 2,
                                  "object_size": 1 << 20}}
    out = {}
    for name, call in (("exists", obj.exists), ("truncate", lambda: obj.truncate(1000)),
                       ("remove", obj.remove), ("purge", lambda: fsc._purge(entry))):
        try:
            out[name] = await call()
        except m.rados.RadosError as e:
            out[name] = e.errno
    return out


@pytest.mark.parametrize("errno", [-2, -5])
def test_the_striper_hides_only_an_absent_object_in_the_port(errno):
    """A file's truncate and purge (the MDS client's) and `exists` go
    through the striper.  An absent object is absent in both packages;
    an EIO reaches the port's caller, where the reference's catches take
    it for an absent object and report success over objects left."""
    ref = asyncio.run(striper_calls("jax", errno))
    ours = asyncio.run(striper_calls("torch", errno))
    assert ref == {"exists": False, "truncate": None, "remove": None, "purge": None}
    if errno == -2:
        assert ours == ref
    else:
        assert ours == {"exists": -5, "truncate": -5, "remove": -5, "purge": -5}
