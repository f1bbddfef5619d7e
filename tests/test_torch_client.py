"""The port's client (`ceph_tpu_torch/client/`, `striper/`, `cls/client.py`
and `cls/log.py`) against the JAX package's, on the CPU.

- The reference's client cases (`tests/test_rados_model.py`,
  `test_cls.py`, `test_omap.py`) run through the port's `Rados` against
  a cluster of the port's monitors and daemons, on the CPU: the same
  text with its imports pointed at the port (`torch_ported.load`).  The
  reference runs them on itself in their own files; they are not doubled
  here, since some rest on heartbeat deadlines (ROADMAP C2).
- A seeded script of client ops (write, write_full, append, truncate,
  zero, xattrs, omap on the replicated pool, exec, stat, read, remove)
  and a `StripedObject` whose writes and reads straddle its objects run
  through each package's `Rados` against each package's daemons
  (`torch_daemon_host.DaemonCluster`, the map service, cephx): every
  reply, every object's bytes in every store, and every `MOSDOp` the
  Objecter sent (its envelope and payload) are equal, byte for byte.
  The Objecter's reqid nonce and its clock are pinned alike in both
  packages, so the ops' names and deadlines agree.

The Objecter's clock is pinned to one `t0` a test, taken from the real
`time.monotonic()` an hour ahead of it (`torch_access_host.pinned_t0`),
and the same for both packages' runs.  The op's deadline, `t0` plus
its timeout, rides the MOSDOp, and every OSD compares it with its own,
unpinned, monotonic clock at admission: a constant `t0` would hold only
on a host whose clock (time since boot, on Linux) is below it.
`test_the_pin_*` shows the dependence both ways.
"""

import asyncio
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_ec_backend import _pin_reference  # noqa: F401 (autouse)
from test_torch_osd import ROOT, make_cluster, settle
from torch_access_host import pinned_t0
from torch_daemon_host import CLIENT
from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)
from torch_ported import collect, cpu_daemons, load  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("cpu_daemons")

CASES = {
    "test_rados_model": ["TestRadosModel", "TestThrashModel"],
    "test_cls": ["TestRuntime", "TestNumops", "TestLock", "TestVersion", "TestRefcount",
                 "TestClsLog", "TestErrors", "TestReviewRegressions"],
    "test_omap": ["test_omap_roundtrip_and_clear", "test_cmpxattr_guarded_compound_ops",
                  "test_omap_rejected_on_ec_pool", "test_omap_survives_osd_restart_via_recovery",
                  "test_zero_and_writesame_ops", "test_client_blocklist_fencing"],
}
for _name, _cases in CASES.items():
    collect(load(_name), _cases, globals())


# -- the differential --------------------------------------------------------


def gen_script(seed: int, n: int = 48) -> list:
    """Client calls as plain data: (pool, method, args)."""
    rng = np.random.default_rng(seed)
    script = []
    for _ in range(n):
        pool = ["ec", "rep"][int(rng.integers(0, 2))]
        oid = f"o{int(rng.integers(0, 5))}"
        size = int(rng.integers(1, 12)) * 1024 + int(rng.integers(0, 1024))
        data = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        kinds = ["write_full", "write", "append", "truncate", "zero", "setxattr",
                 "read", "stat", "remove", "exec"]
        if pool == "rep":
            kinds += ["omap_set", "omap_get_vals", "omap_rm_keys", "rmxattr"]
        kind = kinds[int(rng.integers(0, len(kinds)))]
        off = int(rng.integers(0, 16)) * 1024
        if kind == "write_full" or kind == "append":
            args = (oid, data)
        elif kind == "write":
            args = (oid, data, off)
        elif kind == "truncate":
            args = (oid, off)
        elif kind == "zero":
            args = (oid, off, size)
        elif kind in ("setxattr", "rmxattr"):
            args = (oid, "user.k", data[:32]) if kind == "setxattr" else (oid, "user.k")
        elif kind == "read":
            args = (oid, size, off)
        elif kind in ("stat", "remove", "omap_get_vals"):
            args = (oid,)
        elif kind == "exec":
            args = (oid, "version", "inc", b"")
        elif kind == "omap_set":
            args = (oid, {f"k{int(rng.integers(0, 4))}": data[:16]})
        else:
            args = (oid, [f"k{int(rng.integers(0, 4))}"])
        script.append((pool, kind, args))
    return script


STRIPED = [(0, 50_000), (12_000, 7_000), (40_000, 30_000), (16_383, 2), (65_536, 1)]


def pin_client(objecter, monkeypatch, t0: float) -> None:
    """The Objecter's clock at `t0` and the reqid nonce at a constant."""
    monkeypatch.setattr(objecter, "time", SimpleNamespace(monotonic=lambda: t0))
    monkeypatch.setattr("secrets.token_hex", lambda n: "c1" * n)


async def client_run(pkg: str, tmp_path, seed: int, monkeypatch, t0: float) -> dict:
    root = ROOT[pkg]
    objecter = importlib.import_module(f"{root}.client.objecter")
    rados_mod = importlib.import_module(f"{root}.client.rados")
    striper = importlib.import_module(f"{root}.striper")
    encode_message = importlib.import_module(f"{root}.msg.message").encode_message
    MOSDOp = importlib.import_module(f"{root}.msg.messages").MOSDOp
    pin_client(objecter, monkeypatch, t0)
    c = make_cluster(pkg, tmp_path)
    r = None
    try:
        await c.start(30)
        r = rados_mod.Rados(c.monmap, name=CLIENT, secret=c.keyring.get(CLIENT), stack="inproc")
        await r.connect()
        sent = []
        send_to = r.objecter.msgr.send_to

        async def recording(addr, msg):
            await send_to(addr, msg)
            if isinstance(msg, MOSDOp):
                sent.append(encode_message(msg))

        r.objecter.msgr.send_to = recording
        io = {p: await r.open_ioctx(p) for p in ("ec", "rep")}
        replies = []
        for pool, kind, args in gen_script(seed):
            try:
                replies.append((kind, await getattr(io[pool], kind)(*args)))
            except rados_mod.RadosError as e:
                replies.append((kind, e.errno))
        for pool in ("ec", "rep"):  # read every object back
            for oid in (f"o{i}" for i in range(5)):
                for kind in ("read", "stat") + (("omap_get_vals",) if pool == "rep" else ()):
                    try:
                        replies.append((kind, await getattr(io[pool], kind)(oid)))
                    except rados_mod.RadosError as e:
                        replies.append((kind, e.errno))
        so = striper.StripedObject(io["ec"], "img", striper.StripePolicy(
            stripe_unit=4096, stripe_count=3, object_size=16_384))
        rng = np.random.default_rng(seed + 7)
        model = bytearray()
        for off, n in STRIPED:
            data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            await so.write(data, off)
            model[len(model):] = bytes(max(0, off + n - len(model)))
            model[off:off + n] = data
            whole = await so.read(0, 0)
            assert whole == bytes(model) and await so.size() == len(model)
            replies.append(("striped", whole, await so.read(n, off),
                            await so.read(5000, max(0, off - 2500))))
        await so.truncate(30_000)
        assert await so.read(0, 0) == bytes(model[:30_000])
        replies.append(("striped", await so.size(), await so.read(0, 0)))
        await settle(c)
        return {"replies": replies, "sent": sent, "stores": c.stores(),
                "epoch": r.objecter.osdmap.epoch}
    finally:
        if r is not None:
            await r.shutdown()
        await c.stop()


@pytest.mark.parametrize("seed", [0, 1])
def test_rados_client_matches_the_reference(tmp_path, seed, monkeypatch):
    t0 = pinned_t0()
    got = {pkg: asyncio.run(client_run(pkg, tmp_path, seed, monkeypatch, t0))
           for pkg in ("jax", "torch")}
    ref, ours = got["jax"], got["torch"]
    assert ours["epoch"] == ref["epoch"]
    assert len(ours["replies"]) == len(ref["replies"])
    for i, (a, b) in enumerate(zip(ours["replies"], ref["replies"])):
        assert a == b, f"call {i}: {a[0]}"
    assert len(ours["sent"]) == len(ref["sent"]) > 60
    for i, (a, b) in enumerate(zip(ours["sent"], ref["sent"])):
        assert a == b, f"MOSDOp {i}"
    for i, (a, b) in enumerate(zip(ours["stores"], ref["stores"])):
        assert a == b, f"osd.{i}'s store"
    # the script landed: calls answered with data, and objects were stored
    assert sum(1 for r in ref["replies"] if r[0] == "read" and r[1] not in (-2, b"")) > 2
    assert any(coll for store in ref["stores"] for coll in store.values())


# -- the pin against the OSD's admission clock --------------------------------


async def pinned_write(pkg: str, tmp_path, monkeypatch, t0: float):
    """One write through a `Rados` whose Objecter's clock is pinned at
    `t0`: its result (0, or the exception's type and text) and the OSDs'
    `op_deadline_shed` count."""
    root = ROOT[pkg]
    objecter = importlib.import_module(f"{root}.client.objecter")
    rados_mod = importlib.import_module(f"{root}.client.rados")
    pin_client(objecter, monkeypatch, t0)
    c = make_cluster(pkg, tmp_path)
    r = None
    try:
        await c.start(30)
        r = rados_mod.Rados(c.monmap, name=CLIENT, secret=c.keyring.get(CLIENT), stack="inproc")
        await r.connect()
        io = await r.open_ioctx("rep")
        try:
            await io.write_full("o", b"x" * 4096)
            result = 0
        except Exception as e:  # the outcome is what is compared
            result = (type(e).__name__, str(e))
        return result, sum(o.perf.get("op_deadline_shed") for o in c.running())
    finally:
        if r is not None:
            await r.shutdown()
        await c.stop()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_the_pin_an_hour_ahead_is_served(pkg, tmp_path, monkeypatch):
    result, shed = asyncio.run(pinned_write(pkg, tmp_path, monkeypatch, pinned_t0()))
    assert result == 0 and shed == 0


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_the_pin_behind_the_osd_clock_is_shed_at_admission(pkg, tmp_path, monkeypatch):
    result, shed = asyncio.run(pinned_write(pkg, tmp_path, monkeypatch, pinned_t0(-100.0)))
    assert result[0] == "TimeoutError" and "shed at osd admission" in result[1]
    assert shed >= 1
