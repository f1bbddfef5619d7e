"""The port's OSD daemon (`ceph_tpu_torch/osd/osd.py`) against the JAX
package's, over the wire, on the CPU.

The same seeded plan runs through a cluster of each package
(`torch_daemon_host.DaemonCluster`: 6 daemons on MemStores over the
`inproc` messenger stack, cephx on, pools RS(4,2) plugin `tpu` with
`stripe_unit` 4096 and `allow_ec_overwrites` and replicated size 3, each
pg_num 8): client ops sent one at a time by the small client (WRITEFULL of
16-64 KiB, offset writes that read-modify-write, reads, xattrs, omap,
self-managed snapshots with clones and reads at a snap), then one daemon
stopped and marked down, reads served degraded, the same daemon marked
out and the cluster left to recover, and a deep scrub of one EC PG.  What
must match: every reply (result, out-data, version, epoch: the ops are
serial, and the map service publishes the first boots as one epoch, so
the epochs do not depend on timing), every object read back at the end,
every shard's bytes, xattrs and omap in every store, the PG states once
quiet, and the scrub's result.  Both packages are pinned alike: the
reference at dispatch width 1, the device chunk cache and the RMW delta
path off, hedged reads and the stalled-push retry off (they run on the
host's clock), and the map service ignores failure reports (no test here
depends on a heartbeat deadline).

Also: `OSD(..., device=None)` needs a GPU."""

import asyncio
import os

import numpy as np
import pytest

from test_torch_ec_backend import _pin_reference  # noqa: F401 (autouse)
from torch_daemon_host import DaemonCluster, wait_until
from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

ROOT = {"jax": "ceph_tpu", "torch": "ceph_tpu_torch"}
DEVICE = {"jax": None, "torch": "cpu"}
N_OSDS = 6
SU = 4096
POOLS = [
    dict(name="ec", kind="ec", k=4, m=2, pg_num=8, stripe_unit=SU, overwrites=True),
    dict(name="rep", kind="rep", size=3, pg_num=8),
]
OBJECTS = [f"obj{i}" for i in range(8)]
VICTIM = 3


def daemon_conf(pkg: str) -> dict:
    conf = {
        "osd_heartbeat_interval": 0.1,
        "osd_heartbeat_grace": 30.0,
        "osd_recovery_push_retry_sec": 0,
        "osd_ec_hedge_quantile": 0,
        # the reference at dispatch width 1; the port accepts the option
        # and stays at width 1 whatever it says
        "ec_tpu_shard_devices": 1,
    }
    return conf


def make_cluster(pkg: str, tmp_path, **kw) -> DaemonCluster:
    d = tmp_path / pkg
    d.mkdir(exist_ok=True)
    kw.setdefault("conf", daemon_conf(pkg))
    return DaemonCluster(ROOT[pkg], kw.pop("n_osds", N_OSDS), kw.pop("pools", POOLS),
                         device=DEVICE[pkg], keyring=True, root_dir=str(d), **kw)


def gen_plan(seed: int, n: int) -> list:
    """Client ops as plain data: (pool, oid, [(code, kwargs)], snap_id) or
    ("snap", pool)."""
    rng = np.random.default_rng(seed)

    def data(lo, hi):
        return rng.integers(0, 256, size=int(rng.integers(lo, hi)), dtype=np.uint8).tobytes()

    plan = []
    for oid in OBJECTS:  # every object exists before anything else
        plan.append((POOLS[int(rng.integers(0, 2))]["name"], oid,
                     [("WRITEFULL", {"data": data(16 << 10, 64 << 10)})], 0))
    snapped = False
    for _ in range(n):
        pool = POOLS[int(rng.integers(0, 2))]["name"]
        oid = OBJECTS[int(rng.integers(0, len(OBJECTS)))]
        kind = rng.choice(["writefull", "write", "read", "read", "xattr", "omap", "omap_get",
                           "stat", "snap", "read_snap"])
        if kind == "writefull":
            ops = [("WRITEFULL", {"data": data(16 << 10, 64 << 10)})]
        elif kind == "write":
            ops = [("WRITE", {"off": int(rng.integers(0, 48 << 10)), "data": data(1, 6000)})]
        elif kind == "read":
            ops = [("READ", {"off": int(rng.integers(0, 32 << 10)),
                             "len": int(rng.integers(0, 40 << 10))})]
        elif kind == "xattr":
            ops = [("SETXATTR", {"name": "color", "data": data(1, 40)}),
                   ("GETXATTR", {"name": "color"})]
        elif kind == "omap":
            ops = [("OMAPSETVALS", {"data": _kv({f"k{int(rng.integers(0, 5))}": data(1, 30)})})]
        elif kind == "omap_get":
            ops = [("OMAPGETVALS", {})]
        elif kind == "stat":
            ops = [("STAT", {})]
        elif kind == "snap":
            plan.append(("snap", pool))
            snapped = True
            continue
        else:
            if not snapped:
                continue
            plan.append((pool, oid, [("READ", {"off": 0, "len": 0})], -1))
            continue
        plan.append((pool, oid, ops, 0))
    return plan


def _kv(d: dict) -> bytes:
    from ceph_tpu_torch.common.encoding import encode_kv_map

    return encode_kv_map(d)


async def run_plan(c: DaemonCluster, plan: list, snapc: dict) -> list:
    cl = c.client
    out = []
    for step in plan:
        if step[0] == "snap":
            seq, snaps = snapc.get(step[1], (0, []))
            snapc[step[1]] = (seq + 1, [seq + 1] + snaps)
            continue
        pool, oid, ops, snap_id = step
        sc = snapc.get(pool, (0, []))
        if snap_id == -1:
            snap_id = sc[0] if sc[0] else 0
        built = [cl.osd_op(code, **kw) for code, kw in ops]
        rep = await cl.op(pool, oid, built, snap_id=snap_id, snapc=sc)
        out.append(rep.tobytes())
    return out


def quiet(c: DaemonCluster) -> bool:
    """Every running daemon on the service's epoch, and each PG's primary
    active, with nothing recovering or backfilling; an EC PG may stay
    degraded where it lacks a member for a slot."""
    om = c.mon.osdmap
    running = c.running()
    if any(o.osdmap.epoch != om.epoch for o in running):
        return False
    seen = set()
    for o in running:
        for key, pg in o.pgs.items():
            if not pg.peering.is_primary():
                continue
            seen.add(key)
            if not pg.peering.is_active() or pg.recovering or pg.peering.backfill_targets:
                return False
            if not pg.is_clean and all(a >= 0 for a in pg.peering.acting):
                return False
    want = {(p.id, ps) for p in om.pools.values() for ps in range(p.pg_num)}
    return seen == want


async def settle(c: DaemonCluster, timeout: float = 20.0) -> None:
    """`quiet` on five polls in a row."""
    streak = [0]

    def steady():
        streak[0] = streak[0] + 1 if quiet(c) else 0
        return streak[0] >= 5

    await wait_until(steady, timeout, "a quiet cluster", step=0.02)


async def scenario(pkg: str, tmp_path, seed: int) -> dict:
    c = make_cluster(pkg, tmp_path)
    try:
        await c.start(30)
        snapc: dict = {}
        res = {"ops": await run_plan(c, gen_plan(seed, 40), snapc)}
        await c.stop_osd(VICTIM)
        c.mon.mark_down(VICTIM)
        await settle(c)
        res["degraded_reads"] = await run_plan(
            c, [(p["name"], o, [("READ", {"off": 0, "len": 0})], 0)
                for p in POOLS for o in OBJECTS[:4]], snapc)
        res["down_states"] = c.pg_states()
        c.mon.mark_out(VICTIM)
        await settle(c)
        res["ops_after_out"] = await run_plan(c, gen_plan(seed + 100, 12)[len(OBJECTS):], snapc)
        await settle(c)
        res["read_back"] = await run_plan(
            c, [(p["name"], o, [("READ", {"off": 0, "len": 0}), ("STAT", {})]
                 + ([("OMAPGETVALS", {})] if p["kind"] == "rep" else []), 0)
                for p in POOLS for o in OBJECTS], snapc)
        res["states"] = c.pg_states()
        # one deep scrub, of the EC pool's PG 0, on its primary
        om = c.mon.osdmap
        ec_id = om.get_pool("ec").id
        primary = next(o for o in c.running() if (ec_id, 0) in o.pgs
                       and o.pgs[(ec_id, 0)].peering.is_primary())
        pg = primary.pgs[(ec_id, 0)]
        assert pg.scrub(deep=True)
        await wait_until(lambda: pg.scrubber.last_result is not None, 20, "the deep scrub")
        r = pg.scrubber.last_result
        res["scrub"] = (r.deep, r.errors, r.repaired, sorted(r.inconsistent), r.aborted)
        res["stores"] = c.stores()
        res["epoch"] = om.epoch
    finally:
        await c.stop()
    return res


@pytest.mark.parametrize("seed", [0, 1])
def test_daemon_cluster_matches_reference(tmp_path, seed):
    got = {pkg: asyncio.run(scenario(pkg, tmp_path, seed)) for pkg in ("jax", "torch")}
    ref, ours = got["jax"], got["torch"]
    assert ref["epoch"] == ours["epoch"] == 4
    for key in ("ops", "degraded_reads", "ops_after_out", "read_back", "down_states",
                "states", "scrub"):
        assert ours[key] == ref[key], key
    assert len(ours["stores"]) == N_OSDS
    for i, (a, b) in enumerate(zip(ours["stores"], ref["stores"])):
        assert a == b, f"osd.{i}'s store"
    # every object reads back from the pools it was written to (-ENOENT
    # from the others), and the degraded reads were served
    from ceph_tpu_torch.msg.messages import MOSDOpReply

    results = [MOSDOpReply.frombytes(r).result for r in ours["read_back"]]
    assert set(results) <= {0, -2} and results.count(0) >= len(OBJECTS)
    assert any(MOSDOpReply.frombytes(r).result == 0 for r in ours["degraded_reads"])
    assert ours["scrub"][1] == 0


def test_osd_without_device_needs_a_gpu(tmp_path):
    """`OSD(..., device=None)` runs every PG's codec on cuda: with no GPU
    the constructor raises instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    from ceph_tpu_torch.mon.monmap import MonMap
    from ceph_tpu_torch.osd.osd import OSD

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        OSD(0, MonMap(addrs={"a": "inproc:1"}))
    assert not os.listdir(tmp_path)
