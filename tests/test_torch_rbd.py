"""The port's RBD (`ceph_tpu_torch/rbd/`) against the JAX package's, on
the CPU.

- The reference's RBD cases (`tests/test_access_layers.py`'s TestRbd and
  TestAccessLayersOnEC, and `tests/test_rbd_mirror.py`) run on the port
  through `torch_ported.load`.
- A seeded script of image calls (create, unaligned writes, reads,
  resizes, snapshots and reads at them, protect, clone, the clone's
  copy-up, flatten, rollback, export, the exclusive lock) runs through
  each package's `RBD` against each package's daemons on an RS(4,2)
  overwrites pool: every reply, every store and every MOSDOp sent are
  equal, byte for byte (`torch_access_host` pins the clocks and ids).
- rbd-mirror: a journaled image mirrored by `MirrorDaemon.sync_once` into
  a second pool, a demote, refused writes and a promotion, compared the
  same way.
- ROADMAP C27: the port's zero-length write on an EC pool, which the
  journal's trim makes.
"""

import asyncio
import importlib

import numpy as np
import pytest

from test_torch_ec_backend import _pin_reference  # noqa: F401 (autouse)
from torch_access_host import ROOT, connect, make_cluster, pin, pinned_t0, pinned_wall, settle
from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)
from torch_ported import collect, cpu_daemons, load  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("cpu_daemons")

collect(load("test_access_layers"), ["TestRbd", "TestAccessLayersOnEC"], globals())
collect(load("test_rbd_mirror"), ["TestJournalFormat", "TestMirroring", "TestExclusiveLock",
                                  "TestFencedPromotion"], globals())


# -- the differential ----------------------------------------------------------

POOLS = [dict(name="rbd", kind="ec", k=4, m=2, pg_num=8, stripe_unit=4096, overwrites=True),
         dict(name="rbd_b", kind="ec", k=4, m=2, pg_num=4, stripe_unit=4096, overwrites=True),
         dict(name="rep", kind="rep", size=3, pg_num=4)]
ORDER = 16
IMAGE = 5 * (1 << ORDER) + 12_345  # six objects, the last one partial


def gen_rbd_script(seed: int, n_random: int = 28) -> list:
    """Image calls as plain data, (image, method, args): every kind the
    slice names once in a fixed order (create, snapshot, protect, clone,
    copy-up, flatten, rollback, export, lock), with `n_random` unaligned
    writes, reads, resizes and snapshot reads drawn between them."""
    rng = np.random.default_rng(seed)

    def blob(lo, hi):
        return rng.integers(0, 256, int(rng.integers(lo, hi)), dtype=np.uint8).tobytes()

    def randoms(k, img="a", snaps=()):
        out = []
        for _ in range(k):
            kind = rng.choice(["write", "write", "write", "read", "read", "resize", "read_snap"])
            if kind == "write":
                data = blob(1, 90_000)
                out.append((img, "write", (int(rng.integers(0, IMAGE - len(data))), data)))
            elif kind == "read":
                out.append((img, "read", (int(rng.integers(0, IMAGE)),
                                          int(rng.integers(1, 150_000)))))
            elif kind == "resize":
                out.append((img, "resize", (int(rng.integers(IMAGE // 2, IMAGE + 100_000)),)))
                out.append((img, "resize", (IMAGE,)))
            elif snaps:
                out.append((img, "read", (int(rng.integers(0, IMAGE)),
                                          int(rng.integers(1, 150_000)),
                                          snaps[int(rng.integers(0, len(snaps)))])))
            else:
                out.append((img, "read", (0, IMAGE)))
        return out

    per = n_random // 4
    script = [("", "create", ("a", IMAGE, ORDER)), ("", "list", ())]
    script += randoms(per)
    script += [("a", "snap_create", ("s1",)), ("a", "write", (1000, blob(70_000, 140_000))),
               ("a", "read", (0, IMAGE, "s1")), ("a", "snap_list", ())]
    script += randoms(per, snaps=("s1",))
    script += [("a", "snap_protect", ("s1",)), ("", "clone", ("a", "s1", "c")),
               ("", "children", ("a", "s1")), ("c", "read", (0, IMAGE)),
               ("c", "write", (int(rng.integers(0, IMAGE - 9000)), blob(1, 9000))),
               ("a", "snap_remove", ("s1",))]
    script += randoms(per, img="c")
    script += [("c", "flatten", ()), ("", "children", ("a", "s1")), ("c", "read", (0, IMAGE)),
               ("a", "snap_create", ("s2",))]
    script += randoms(per, snaps=("s1", "s2"))
    script += [("a", "snap_rollback", ("s1",)), ("a", "export", ()),
               ("a", "export", ("s2",)), ("c", "export", ()),
               ("a", "lock_acquire", ()), ("a", "lock_owners", ()),
               ("c", "lock_acquire", ()), ("a", "lock_release", ()),
               ("a", "lock_owners", ()), ("a", "snap_unprotect", ("s1",)),
               ("a", "snap_remove", ("s2",)), ("", "list", ())]
    return script


async def rbd_run(pkg: str, tmp_path, seed: int, monkeypatch, t0: float) -> dict:
    """The script through the package's `RBD` on the package's daemons:
    each call's reply, the MOSDOps sent, and every store."""
    rbd_mod = importlib.import_module(f"{ROOT[pkg]}.rbd")
    pin(pkg, monkeypatch, t0, pinned_wall())
    c = make_cluster(pkg, tmp_path, pools=POOLS)
    r = None
    try:
        await c.start(30)
        r, sent = await connect(pkg, c)
        rbd = rbd_mod.RBD(await r.open_ioctx("rbd"))
        images = {}
        replies = []
        for img, method, args in gen_rbd_script(seed):
            try:
                if not img:
                    got = await getattr(rbd, method)(*args)
                else:
                    if img not in images:
                        images[img] = await rbd.open(img)
                    got = await getattr(images[img], method)(*args)
                replies.append((img, method, got))
            except rbd_mod.RbdError as e:
                replies.append((img, method, e.errno))
        await settle(c)
        return {"replies": replies, "sent": sent, "stores": c.stores(),
                "epoch": r.objecter.osdmap.epoch}
    finally:
        if r is not None:
            await r.shutdown()
        await c.stop()


@pytest.mark.parametrize("seed", [0, 1])
def test_rbd_matches_the_reference(tmp_path, seed, monkeypatch):
    t0 = pinned_t0()
    got = {pkg: asyncio.run(rbd_run(pkg, tmp_path, seed, monkeypatch, t0))
           for pkg in ("jax", "torch")}
    ref, ours = got["jax"], got["torch"]
    assert 40 <= len(gen_rbd_script(seed)) <= 60
    assert ours["epoch"] == ref["epoch"]
    assert len(ours["replies"]) == len(ref["replies"])
    for i, (a, b) in enumerate(zip(ours["replies"], ref["replies"])):
        assert a == b, f"call {i}: {a[:2]}"
    assert len(ours["sent"]) == len(ref["sent"]) > 100
    for i, (a, b) in enumerate(zip(ours["sent"], ref["sent"])):
        assert a == b, f"MOSDOp {i}"
    for i, (a, b) in enumerate(zip(ours["stores"], ref["stores"])):
        assert a == b, f"osd.{i}'s store"
    # the script landed: the clone's copy-up, a snapshot read and the lock
    kinds = {(img, m) for img, m, _ in ref["replies"]}
    assert {("c", "write"), ("c", "flatten"), ("a", "snap_rollback"), ("a", "lock_acquire")} <= kinds
    assert ("a", "snap_remove", -16) in ref["replies"]  # s1 protected
    assert sum(1 for _, m, r in ref["replies"] if m == "read" and r.strip(b"\0")) > 5


# -- the mirror differential ---------------------------------------------------


def gen_mirror_writes(seed: int, n: int, size: int) -> list:
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        data = rng.integers(0, 256, int(rng.integers(1, 40_000)), dtype=np.uint8).tobytes()
        out.append((int(rng.integers(0, size - len(data))), data))
    return out


async def mirror_run(pkg: str, tmp_path, seed: int, monkeypatch, t0: float,
                     src: str = "rep", dst: str = "rbd_b") -> dict:
    """A journaled image in pool `src` mirrored into `dst`: writes, a resize
    and a snapshot, the bootstrap pass and a replay pass, writes refused
    on the replica and on the demoted source, the replica's promotion and
    a write there, a pass that replays nothing.
    The replies (the replay counts among them), the journal blob, both
    images' bytes, the MOSDOps sent and every store."""
    root = ROOT[pkg]
    rbd_mod = importlib.import_module(f"{root}.rbd")
    mirror = importlib.import_module(f"{root}.rbd.mirror")
    pin(pkg, monkeypatch, t0, pinned_wall())
    c = make_cluster(pkg, tmp_path, pools=POOLS)
    r = None
    size = 3 * (1 << ORDER) + 777
    writes = gen_mirror_writes(seed, 12, size)
    try:
        await c.start(30)
        r, sent = await connect(pkg, c)
        io_a, io_b = await r.open_ioctx(src), await r.open_ioctx(dst)
        rbd_a, rbd_b = rbd_mod.RBD(io_a), rbd_mod.RBD(io_b)
        await rbd_a.create("m", size, order=ORDER)
        pre = await rbd_a.open("m")
        await pre.write(*writes[0])  # before journaling: the bootstrap copies it
        await rbd_mod.enable_journaling(rbd_a, "m")
        ji = await rbd_mod.JournaledImage.open(rbd_a, "m")
        daemon = rbd_mod.MirrorDaemon(io_a, io_b)
        replies = []
        for off, data in writes[1:6]:
            await ji.write(off, data)
        await ji.snap_create("m1")
        replies.append(("sync", await daemon.sync_once()))
        await ji.resize(size + 5000)
        for off, data in writes[6:]:
            await ji.write(off, data)
        replies.append(("sync", await daemon.sync_once()))
        journal = await io_a.read(mirror.journal_oid(ji.image.id))
        replies.append(("events", [e[:3] for e in mirror.iter_events(journal)]))
        dst = await rbd_b.open("m")
        src_bytes, dst_bytes = await ji.image.export(), await dst.export()
        replies.append(("snap", await dst.read(0, size, "m1") == await ji.read(0, size, "m1")))
        replica = await rbd_mod.JournaledImage.open(rbd_b, "m")
        for what, img in (("replica write", replica), ("demoted write", ji)):
            if what == "demoted write":
                await ji.demote()
            try:
                await img.write(0, b"refused")
                replies.append((what, 0))
            except rbd_mod.RbdError as e:
                replies.append((what, e.errno))
        await rbd_mod.promote(rbd_b, "m")
        peer = await rbd_b.open("m")
        await peer.write(100, b"after failover")
        replies.append(("sync", await daemon.sync_once()))
        replies.append(("promoted", await peer.read(0, size + 5000)))
        await settle(c)
        return {"replies": replies, "journal": journal, "src": src_bytes, "dst": dst_bytes,
                "sent": sent, "stores": c.stores()}
    finally:
        if r is not None:
            await r.shutdown()
        await c.stop()


@pytest.mark.parametrize("seed", [0, 1])
def test_rbd_mirror_matches_the_reference(tmp_path, seed, monkeypatch):
    """The journal on a replicated pool, as the reference's own mirror
    cases keep it: on an EC pool the reference's journal hangs (C27)."""
    t0 = pinned_t0()
    got = {pkg: asyncio.run(mirror_run(pkg, tmp_path, seed, monkeypatch, t0))
           for pkg in ("jax", "torch")}
    ref, ours = got["jax"], got["torch"]
    assert ours["replies"] == ref["replies"]
    assert ours["journal"] == ref["journal"]
    assert ours["src"] == ref["src"] and ours["dst"] == ref["dst"]
    assert len(ours["sent"]) == len(ref["sent"]) > 100
    for i, (a, b) in enumerate(zip(ours["sent"], ref["sent"])):
        assert a == b, f"MOSDOp {i}"
    for i, (a, b) in enumerate(zip(ours["stores"], ref["stores"])):
        assert a == b, f"osd.{i}'s store"
    # what was mirrored converged, and the roles held
    assert ref["src"] == ref["dst"]
    replies = dict((k, v) for k, v in ref["replies"] if k != "sync")
    assert replies["snap"] is True
    assert replies["replica write"] == replies["demoted write"] == -22
    syncs = [v for k, v in ref["replies"] if k == "sync"]
    assert syncs == [{"m": 0}, {"m": 7}, {"m": 0}]  # bootstrap, replay, promoted


# -- C27: a zero-length write on an EC overwrites pool --------------------------


def test_a_zero_length_write_plans_no_negative_read_in_the_port():
    """ROADMAP C27: the journal's trim (`write_full(oid, b"")`) is a
    zero-length write; the reference's EC write plan reads the stripe
    before it, at -stripe_width on an empty object, and the sub-read can
    be sent to no shard, so the op hangs to its deadline.  The port's
    plans no read and no write for it."""
    plans = {}
    for pkg in ("jax", "torch"):
        et = importlib.import_module(f"{ROOT[pkg]}.osd.ec_transaction")
        si = et.StripeInfo(16384, 4096)
        out = []
        for size, off, n in ((0, 0, 0), (5000, 5000, 0), (0, 0, 100), (20000, 16384, 3)):
            plan = et.get_write_plan(si, et.PGTransaction(oid="j").write(off, b"x" * n),
                                     size, True)
            out.append((plan.to_read, plan.will_write, plan.new_size))
        plans[pkg] = out
    assert plans["jax"][0][0] == [(-16384, 16384)]
    assert plans["torch"][0] == ([], [], 0) and plans["torch"][1] == ([], [], 5000)
    assert plans["torch"][2:] == plans["jax"][2:]  # writes with bytes: the reference's plans


def test_a_journal_on_an_ec_pool_mirrors_in_the_port(tmp_path, monkeypatch):
    """The mirror's script with the journal and the image on the RS(4,2)
    overwrites pool `rbd`, in the port: its journal trims and appends go
    through, and the replica converges."""
    got = asyncio.run(mirror_run("torch", tmp_path, 0, monkeypatch, pinned_t0(), src="rbd"))
    assert got["src"] == got["dst"] and got["journal"]
    assert [v for k, v in got["replies"] if k == "sync"] == [{"m": 0}, {"m": 7}, {"m": 0}]
