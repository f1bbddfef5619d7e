"""The PG paths that need the daemon, through the port's OSD daemons and
against the JAX package's, on the CPU: COPY_FROM (the source fetched by
the daemon's `internal_op`), a writeback cache tier (promote on a miss,
dirty writes, flush and evict through `internal_op`), and watch/notify
(a notify acked by a watcher, then the watcher's session reset).

Each test runs the same ops through a cluster of each package
(`torch_daemon_host.DaemonCluster`, 3 daemons on MemStores over `inproc`,
cephx on) and compares every reply and every store."""

import asyncio
import json

import pytest

from test_torch_ec_backend import _pin_reference  # noqa: F401 (autouse)
from test_torch_osd import daemon_conf, make_cluster
from torch_daemon_host import make_client
from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

PKGS = ("jax", "torch")
POOLS = [
    dict(name="ec", kind="ec", k=2, m=1, pg_num=4, stripe_unit=4096),
    dict(name="base", kind="rep", size=2, pg_num=4),
    dict(name="hot", kind="rep", size=2, pg_num=4),
]


def both(tmp_path, body, **kw):
    async def run(pkg):
        c = make_cluster(pkg, tmp_path, pools=POOLS, n_osds=3, **kw)
        try:
            await c.start(30)
            out = await body(c)
            out["stores"] = c.stores()
            return out
        finally:
            await c.stop()

    return {pkg: asyncio.run(run(pkg)) for pkg in PKGS}


def data(n, seed):
    return bytes((i * 131 + seed) % 251 for i in range(n))


async def ops(c, steps):
    cl = c.client
    out = []
    for pool, oid, codes in steps:
        rep = await cl.op(pool, oid, [cl.osd_op(code, **kw) for code, kw in codes])
        out.append((rep.result, [bytes(d) for d in rep.outdata], rep.version))
    return out


def test_copy_from_matches_reference(tmp_path):
    async def body(c):
        steps = []
        for pool in ("ec", "base"):
            steps += [
                (pool, "src", [("WRITEFULL", {"data": data(20000, 1)}),
                               ("SETXATTR", {"name": "color", "data": b"blue"})]),
                (pool, "dst", [("WRITEFULL", {"data": data(3000, 2)}),
                               ("SETXATTR", {"name": "stale", "data": b"x"})]),
                (pool, "dst", [("COPY_FROM", {"name": "src", "off": 0})]),
                (pool, "dst", [("READ", {"off": 0, "len": 0}), ("GETXATTRS", {})]),
                (pool, "dst2", [("COPY_FROM", {"name": "missing", "off": 0})]),
            ]
        return {"replies": await ops(c, steps)}

    got = both(tmp_path, body)
    assert got["torch"] == got["jax"]
    replies = got["torch"]["replies"]
    assert replies[3][0] == 0 and replies[3][1][0] == data(20000, 1)
    assert replies[4][0] == -2


def test_writeback_cache_tier_matches_reference(tmp_path):
    async def body(c):
        first = await ops(c, [("base", f"o{i}", [("WRITEFULL", {"data": data(5000, i)})])
                              for i in range(4)])
        c.mon.set_tier("base", "hot", "writeback", target_max_objects=3)
        await c.wait_clean(20)
        await c.client._wait_map(0.2)
        steps = [
            ("base", "o0", [("READ", {"off": 0, "len": 0})]),      # promote on a miss
            ("base", "o1", [("WRITEFULL", {"data": data(7000, 9)})]),  # dirty in the cache
            ("base", "o1", [("CACHE_FLUSH", {})]),
            ("base", "o1", [("CACHE_EVICT", {})]),
            ("base", "o1", [("READ", {"off": 0, "len": 0})]),      # promoted again
            ("base", "o2", [("APPEND", {"data": b"tail"})]),
            ("base", "o3", [("DELETE", {})]),
            ("base", "o4", [("WRITEFULL", {"data": data(100, 4)})]),
            ("base", "o3", [("STAT", {})]),
        ]
        return {"first": first, "replies": await ops(c, steps)}

    got = both(tmp_path, body)
    assert got["torch"] == got["jax"]
    replies = got["torch"]["replies"]
    assert replies[0][1][0] == data(5000, 0)
    assert replies[4][1][0] == data(7000, 9)


def test_watch_notify_with_ack_and_client_reset_matches_reference(tmp_path):
    async def body(c):
        await ops(c, [("base", "feed", [("WRITEFULL", {"data": b"x"})])])
        watcher = make_client(c.m, c.monmap, name="client.77", stack=c.stack,
                              auth=c.m.cephx.CephxAuth.for_client("client.77",
                                                                  c.keyring.get("client.77")))
        await watcher.connect()
        w = await watcher.watch("base", "feed", 11, cb=lambda nid, payload: b"ack:" + payload)
        n1 = await c.client.op("base", "feed", [c.client.osd_op("NOTIFY", off=5000,
                                                                data=b"hello")])
        lw = await c.client.op("base", "feed", [c.client.osd_op("LIST_WATCHERS")])
        await watcher.shutdown()  # the watcher's session resets
        await asyncio.sleep(0.2)
        n2 = await c.client.op("base", "feed", [c.client.osd_op("NOTIFY", off=5000,
                                                                data=b"again")])
        return {"replies": [(r.result, [bytes(d) for d in r.outdata])
                            for r in (w, n1, lw, n2)],
                "notifies": watcher.notifies}

    got = both(tmp_path, body)
    assert got["torch"] == got["jax"]
    n1 = json.loads(got["torch"]["replies"][1][1][0])
    assert n1["acks"] == {"client.77/11": b"ack:hello".hex()} and not n1["timeouts"]
    n2 = json.loads(got["torch"]["replies"][3][1][0])
    assert n2 == {"acks": {}, "timeouts": []}
