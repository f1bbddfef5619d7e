"""The access layers where the port differs from the JAX package's, on
the CPU (ROADMAP C26).

A bucket with three objects and a directory with two images live on two
RS(4,2) overwrites pools.  The daemon that holds the first data shard
of the bucket index and of the image directory (all the bytes of such
small objects) stops, so their reads decode.  A
`codec.launch` fault (the fault point of the C6-C8 drills) fails the
next launch, once before a fourth key is PUT over S3 and once before a
third image is created.  Once the guard is healthy, both are listed.

- The reference recomputes the failed launches on its host oracle: both
  reads are served, the PUT and the create land, and nothing is lost.
  The port recomputes nothing (ops/guard.py), so the reads fail with
  EIO.
- With the reference's catches (`except Exception` around the reads)
  the port would take each EIO for an absent object: the guard's probe
  heals it at the next launch, as on a card whose fault was transient,
  and the PUT stores an index holding only its own key, the create a
  directory holding only the new image.  The drill runs that variant too.
- The port's catches take only a missing object for absent
  (`client/absent.py`): the PUT is answered `500 InternalError`, the
  create raises `RadosError(EIO)`, and every earlier entry is listed.

And the two periodic loops, `MirrorDaemon.run` and the S3 front end's
lifecycle loop: a failed pass is retried, a device error ends the loop.
"""

import asyncio
import importlib

import pytest

from test_torch_ec_backend import _pin_reference  # noqa: F401 (autouse)
from torch_access_host import ROOT, connect, http, make_cluster, settle
from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)

POOLS = [dict(name=name, kind="ec", k=4, m=2, pg_num=8, stripe_unit=4096, overwrites=True)
         for name in ("rgw", "rbd")]
N_OSDS = 7


def first_shard(c, pool: str, oid: str) -> int:
    """The daemon holding `oid`'s first data shard, where the bytes of an
    object smaller than a stripe unit lie."""
    pgid, _primary = c.client.target(pool, oid)
    return c.mon.osdmap.pg_to_up_acting_osds(pgid.pool, pgid.ps)[2][0]


def pick(c) -> tuple:
    """A bucket name and a victim: the victim holds the first data shard
    of the bucket's index and of the image directory, and not that of
    the bucket registry (the PUT's other read)."""
    victim = first_shard(c, "rbd", "rbd_directory")
    if first_shard(c, "rgw", "rgw.buckets") != victim:
        for n in range(200):
            if first_shard(c, "rgw", f"rgw.bucket.index.b{n}") == victim:
                return f"b{n}", victim
    raise AssertionError("no bucket name puts a victim where the drill needs it")


def broad_catches(monkeypatch, root: str) -> None:
    """The reference's catches on the port's gateway and RBD."""
    rgw = importlib.import_module(f"{root}.rgw.rgw")
    rbd = importlib.import_module(f"{root}.rbd.rbd")

    async def _load(self, oid):
        try:
            raw = await self.ioctx.read(oid)
            return rgw.json.loads(raw.decode() or "{}")
        except Exception:
            return {}

    async def _read_directory(self):
        try:
            raw = await self.ioctx.read(rbd.DIRECTORY_OID)
            return rbd.json.loads(raw.decode() or "{}")
        except Exception:
            return {}

    monkeypatch.setattr(rgw.ObjectGateway, "_load", _load)
    monkeypatch.setattr(rbd.RBD, "_read_directory", _read_directory)


async def eio_under_the_access_layers(pkg: str, tmp_path, monkeypatch, broad: bool) -> dict:
    root = ROOT[pkg]
    rgw = importlib.import_module(f"{root}.rgw")
    rbd_mod = importlib.import_module(f"{root}.rbd")
    rados_mod = importlib.import_module(f"{root}.client.rados")
    faults = importlib.import_module(f"{root}.common.fault_injector")
    guard_mod = importlib.import_module(f"{root}.ops.guard")
    if pkg == "torch":
        # the probe heals the guard, as on a card whose fault was transient
        monkeypatch.setattr(guard_mod, "_default_probe", lambda: None)
    if broad:
        broad_catches(monkeypatch, root)
    c = make_cluster(pkg, tmp_path, pools=POOLS, n_osds=N_OSDS)
    r = srv = None
    try:
        await c.start(30)
        r, _ = await connect(pkg, c)
        gw = rgw.ObjectGateway(await r.open_ioctx("rgw"))
        rbd = rbd_mod.RBD(await r.open_ioctx("rbd"))
        bucket, victim = pick(c)
        await gw.create_bucket(bucket)  # no owner: anyone may write
        for i in range(3):
            await gw.put_object(bucket, f"k{i}", bytes([i]) * 20_000)
        for i in range(2):
            await rbd.create(f"img{i}", 1 << 18, order=16)
        srv = rgw.S3Server(gw)
        addr = await srv.serve()
        await c.stop_osd(victim)
        c.mon.mark_down(victim)
        await settle(c)
        faults.global_injector().inject("codec.launch", 5, hits=1)
        put = await http(addr, "PUT", f"/{bucket}/k3", body=b"\3" * 20_000)
        faults.global_injector().inject("codec.launch", 5, hits=1)
        try:
            await rbd.create("img2", 1 << 18, order=16)
            create = 0
        except rados_mod.RadosError as e:
            create = e.errno
        faults.global_injector().clear()
        guard_mod.device_guard().mark_healthy()
        listed = await gw.list_objects(bucket)
        return {"put": (put[0], put[2]), "create": create,
                "keys": [e["key"] for e in listed["contents"]], "images": await rbd.list()}
    finally:
        importlib.import_module(f"{root}.common.fault_injector").global_injector().clear()
        if srv is not None:
            await srv.shutdown()
        if r is not None:
            await r.shutdown()
        await c.stop()


def test_an_eio_under_the_access_layers_loses_no_entry(tmp_path, monkeypatch):
    ref = asyncio.run(eio_under_the_access_layers("jax", tmp_path, monkeypatch, False))
    assert ref == {"put": ("200 OK", b""), "create": 0,
                   "keys": ["k0", "k1", "k2", "k3"], "images": ["img0", "img1", "img2"]}
    ours = asyncio.run(eio_under_the_access_layers("torch", tmp_path, monkeypatch, False))
    assert ours == {"put": ("500 Internal Server Error",
                            b"<Error><Code>InternalError</Code></Error>"),
                    "create": -5, "keys": ["k0", "k1", "k2"], "images": ["img0", "img1"]}


def test_the_reference_catches_would_lose_the_entries_in_the_port(tmp_path, monkeypatch):
    got = asyncio.run(eio_under_the_access_layers("torch", tmp_path, monkeypatch, True))
    assert got == {"put": ("200 OK", b""), "create": 0, "keys": ["k3"], "images": ["img2"]}


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_an_absent_registry_reads_as_empty_in_both(pkg, tmp_path):
    """What the catches are for: a first use finds the registries,
    directory and journal absent, and an empty or unparsable blob reads
    as empty."""
    root = ROOT[pkg]
    rgw = importlib.import_module(f"{root}.rgw")
    rbd_mod = importlib.import_module(f"{root}.rbd")

    async def run():
        c = make_cluster(pkg, tmp_path, pools=POOLS, n_osds=N_OSDS)
        r = None
        try:
            await c.start(30)
            r, _ = await connect(pkg, c)
            io = await r.open_ioctx("rgw")
            gw, rbd = rgw.ObjectGateway(io), rbd_mod.RBD(io)
            out = [await gw.list_buckets(), await rbd.list()]
            await io.write_full("rgw.buckets", b"not json")
            await io.write_full(rbd_mod.rbd.DIRECTORY_OID, b"\n")
            out += [await gw.list_buckets(), await rbd.list()]
            await rbd.create("i", 1 << 17, order=16)
            out.append(await rbd.list())
            return out
        finally:
            if r is not None:
                await r.shutdown()
            await c.stop()

    assert asyncio.run(run()) == [[], [], [], [], ["i"]]


def test_a_device_error_ends_the_mirror_and_lifecycle_loops():
    """The two periodic loops retry a failed pass (counted), but a device
    error from the process ends the loop and reaches its caller: `run()`
    raises it, and `S3Server.shutdown()` raises the one that ended the
    lifecycle loop."""
    from ceph_tpu_torch.ops.guard import DeviceError
    from ceph_tpu_torch.rbd import MirrorDaemon
    from ceph_tpu_torch.rgw import S3Server

    def failing(*errors, then=lambda: None):
        """Raise each of `errors` in turn, then call `then` and pass."""
        it = iter(errors)

        async def call(*args, **kw):
            for error in it:
                raise error
            then()
            return {}

        return call

    async def run():
        daemon = MirrorDaemon(None, None)
        daemon.sync_once = failing(ValueError("a pool hiccup"), DeviceError("launch failed"),
                                   then=daemon.stop)
        with pytest.raises(DeviceError):
            await daemon.run(interval=0.0)
        gw = type("Gateway", (), {})()
        gw.process_lifecycle = failing(ValueError("a pool hiccup"), DeviceError("launch failed"))
        srv = S3Server(gw, lc_interval=0.01)
        await srv.serve()
        for _ in range(200):
            if srv._lc_task.done():
                break
            await asyncio.sleep(0.01)
        with pytest.raises(DeviceError):
            await srv.shutdown()
        return daemon.sync_errors, srv.lc_errors

    assert asyncio.run(run()) == (1, 1)
