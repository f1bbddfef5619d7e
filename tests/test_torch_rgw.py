"""The port's RGW (`ceph_tpu_torch/rgw/`) against the JAX package's, on
the CPU.

- The reference's gateway cases (`tests/test_access_layers.py`'s TestRgw
  and TestRgwLifecycle, and `tests/test_swift.py`) run on the port
  through `torch_ported.load`.
- A seeded script over HTTP: users, buckets, PUT, GET (with a Range
  header, which neither package's S3 front end serves), HEAD, DELETE,
  versioning and a delete marker, a 3-part multipart upload, listings
  with prefix and delimiter, ACL grants, a lifecycle pass at a pinned
  `now` through each package's `S3Server` with `sign_v2`, then Swift's
  token, container, PUT, GET and ACL through its `SwiftServer`: every
  status, header but `Date`, body, store and MOSDOp equal, byte for byte
  (`torch_access_host` pins the clocks and ids).
- Whether the gateway runs on an append-only EC pool, as real RGW's
  bucket data does.
"""

import asyncio
import importlib
import re

import numpy as np
import pytest

from test_torch_ec_backend import _pin_reference  # noqa: F401 (autouse)
from torch_access_host import (ROOT, connect, http, http_date, make_cluster, pin, pinned_t0,
                               pinned_wall, settle, swift_server)
from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)
from torch_ported import collect, cpu_daemons, load  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("cpu_daemons")

collect(load("test_access_layers"), ["TestRgw", "TestRgwLifecycle"], globals())
collect(load("test_swift"), ["TestSwiftApi", "TestSwiftContainerAcls"], globals())


# -- the differential over HTTP ------------------------------------------------

POOLS = [dict(name="rgw", kind="ec", k=4, m=2, pg_num=8, stripe_unit=4096, overwrites=True)]


def rgw_bodies(seed: int) -> dict:
    rng = np.random.default_rng(seed)

    def blob(lo, hi):
        return rng.integers(0, 256, int(rng.integers(lo, hi)), dtype=np.uint8).tobytes()

    return {"keys": [blob(1, 700_000) for _ in range(5)], "versions": [blob(1, 50_000)
                                                                      for _ in range(2)],
            "parts": [blob(5000, 300_000) for _ in range(3)],
            "swift": [blob(1, 200_000) for _ in range(2)]}


class S3:
    """Requests to an `S3Server`, signed with `sign_v2` for a user (None:
    anonymous), each appended to `log` as ("s3", status, headers but
    `Date`, body)."""

    def __init__(self, addr, sign_v2, date, log):
        self.addr, self.sign_v2, self.date, self.log = addr, sign_v2, date, log

    async def __call__(self, user, method, path, body=b"", headers=None):
        hdrs = dict(headers or {})
        if user is not None:
            resource = path.split("?", 1)[0]
            sig = self.sign_v2(user["secret_key"], method, resource, self.date)
            hdrs.update({"Date": self.date, "Authorization": f"AWS {user['access_key']}:{sig}"})
        status, got, payload = await http(self.addr, method, path, hdrs, body)
        self.log.append(("s3", status, [(k, v) for k, v in got if k != "Date"], payload))
        return status, got, payload


async def rgw_run(pkg: str, tmp_path, seed: int, monkeypatch, t0: float, wall: float) -> dict:
    """Users, buckets, objects, ranges, versioning, multipart, listings,
    ACLs and a lifecycle pass through the package's `S3Server`, then Swift
    calls through its `SwiftServer`, on one gateway: every answer, the
    MOSDOps sent and every store."""
    root = ROOT[pkg]
    rgw = importlib.import_module(f"{root}.rgw")
    sign_v2 = importlib.import_module(f"{root}.rgw.http").sign_v2
    pin(pkg, monkeypatch, t0, wall)
    bodies = rgw_bodies(seed)
    c = make_cluster(pkg, tmp_path, pools=POOLS)
    r = s3srv = swift = None
    try:
        await c.start(30)
        r, sent = await connect(pkg, c)
        gw = rgw.ObjectGateway(await r.open_ioctx("rgw"))
        s3srv = rgw.S3Server(gw, require_auth=False)
        log = []
        s3 = S3(await s3srv.serve(), sign_v2, http_date(wall), log)
        alice, bob = await gw.create_user("alice"), await gw.create_user("bob")
        log.append(("users", alice, bob))
        await s3(alice, "PUT", "/b1")
        keys = ["k0", "dir/k1", "dir/k2", "dir/sub/k3", "k4"]
        for key, body in zip(keys, bodies["keys"]):
            await s3(alice, "PUT", f"/b1/{key}", body, {"x-amz-meta-color": "blue"})
        await s3(alice, "GET", "/b1/k0")
        await s3(alice, "GET", "/b1/dir/k1", headers={"Range": "bytes=100-4095"})
        await s3(alice, "HEAD", "/b1/dir/k2")
        await s3(alice, "DELETE", "/b1/k4")
        await s3(alice, "GET", "/b1/k4")
        await s3(alice, "GET", "/b1?prefix=dir/&delimiter=/")
        await s3(alice, "GET", "/b1?delimiter=/")
        await s3(alice, "PUT", "/b1?versioning",
                 b"<VersioningConfiguration><Status>Enabled</Status></VersioningConfiguration>")
        for body in bodies["versions"]:
            await s3(alice, "PUT", "/b1/v", body)
        await s3(alice, "DELETE", "/b1/v")
        await s3(alice, "GET", "/b1/v")
        await s3(alice, "GET", "/b1?versions")
        _, _, init = await s3(alice, "POST", "/b1/mp?uploads")
        upload = re.search(rb"<UploadId>(\w+)</UploadId>", init).group(1).decode()
        for n, body in enumerate(bodies["parts"], 1):
            await s3(alice, "PUT", f"/b1/mp?partNumber={n}&uploadId={upload}", body)
        await s3(alice, "GET", f"/b1/mp?uploadId={upload}")
        await s3(alice, "POST", f"/b1/mp?uploadId={upload}")
        await s3(alice, "GET", "/b1/mp")
        await s3(bob, "GET", "/b1/k0")
        await s3(alice, "PUT", "/b1?acl", headers={"x-amz-acl": "public-read"})
        await s3(alice, "GET", "/b1?acl")
        await s3(bob, "GET", "/b1/k0")
        await s3(None, "GET", "/b1/dir/k2")
        await s3(None, "PUT", "/b1/anon", b"no")
        await s3(alice, "PUT", "/b1?lifecycle",
                 b"<LifecycleConfiguration><Rule><ID>r</ID><Prefix>dir/</Prefix>"
                 b"<Expiration><Days>1</Days></Expiration></Rule></LifecycleConfiguration>")
        await s3(alice, "GET", "/b1?lifecycle")
        log.append(("lifecycle", await gw.process_lifecycle(now=wall + 2 * 86400)))
        await s3(alice, "GET", "/b1")
        swift = swift_server(pkg, gw, monkeypatch)
        addr = await swift.serve()
        sw = []

        async def call(method, path, token=None, body=b"", headers=None):
            hdrs = dict(headers or {})
            if token:
                hdrs["X-Auth-Token"] = token
            got = await http(addr, method, path, hdrs, body)
            sw.append(got)
            return got

        _, hdrs, _ = await call("GET", "/auth/v1.0", headers={
            "X-Auth-User": "alice:swift", "X-Auth-Key": alice["secret_key"]})
        token = dict(hdrs)["X-Auth-Token"]
        await call("GET", "/auth/v1.0", headers={"X-Auth-User": "bob:swift", "X-Auth-Key": "x"})
        await call("PUT", "/v1/AUTH_alice/c1", token)
        for n, body in enumerate(bodies["swift"]):
            await call("PUT", f"/v1/AUTH_alice/c1/o{n}", token, body, {"X-Object-Meta-N": str(n)})
        await call("GET", "/v1/AUTH_alice/c1/o0", token)
        await call("HEAD", "/v1/AUTH_alice/c1/o1", token)
        await call("GET", "/v1/AUTH_alice/c1?format=json", token)
        await call("GET", "/v1/AUTH_alice/c1/o0")
        await call("POST", "/v1/AUTH_alice/c1", token, headers={"X-Container-Read": ".r:*"})
        await call("GET", "/v1/AUTH_alice/c1/o0")
        await call("GET", "/v1/AUTH_alice?format=json", token)
        log.append(("swift", [(st, [(k, v.replace(addr, "ADDR")) for k, v in h], b)
                              for st, h, b in sw]))
        await settle(c)
        return {"answers": log, "sent": sent, "stores": c.stores(), "bodies": bodies}
    finally:
        for srv in (s3srv, swift):
            if srv is not None:
                await srv.shutdown()
        if r is not None:
            await r.shutdown()
        await c.stop()


@pytest.mark.parametrize("seed", [0, 1])
def test_rgw_over_http_matches_the_reference(tmp_path, seed, monkeypatch):
    t0, wall = pinned_t0(), pinned_wall()
    got = {pkg: asyncio.run(rgw_run(pkg, tmp_path, seed, monkeypatch, t0, wall))
           for pkg in ("jax", "torch")}
    ref, ours = got["jax"], got["torch"]
    assert len(ours["answers"]) == len(ref["answers"])
    for i, (a, b) in enumerate(zip(ours["answers"], ref["answers"])):
        assert a == b, f"answer {i}"
    assert len(ours["sent"]) == len(ref["sent"]) > 100
    for i, (a, b) in enumerate(zip(ours["sent"], ref["sent"])):
        assert a == b, f"MOSDOp {i}"
    for i, (a, b) in enumerate(zip(ours["stores"], ref["stores"])):
        assert a == b, f"osd.{i}'s store"
    # the script did what it says: bodies served, the marker, the anonymous
    # refusal, the expiry of dir/, and Swift's token and public read
    s3 = [a[1:] for a in ref["answers"] if a[0] == "s3"]
    statuses = [st for st, _, _ in s3]
    served = [body for st, _, body in s3 if st == "200 OK"]
    bodies = ref["bodies"]
    assert bodies["keys"][0] in served and b"".join(bodies["parts"]) in served
    assert "403 Forbidden" in statuses and statuses.count("404 Not Found") >= 2
    assert ("lifecycle", 3) in ref["answers"]  # dir/k1, dir/k2, dir/sub/k3
    swift = next(a[1] for a in ref["answers"] if a[0] == "swift")
    assert [st for st, _, _ in swift][:3] == ["200 OK", "401 Unauthorized", "201 Created"]
    assert swift[-4][0] == "403 Forbidden" and swift[-2][0] == "200 OK"  # before, after .r:*
    assert swift[-2][2] == bodies["swift"][0]


# -- the gateway on an append-only EC pool ---------------------------------------

APPEND_ONLY = [dict(name="rgw_data", kind="ec", k=4, m=2, pg_num=8, stripe_unit=4096)]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_the_gateway_runs_on_an_append_only_ec_pool(pkg, tmp_path, monkeypatch):
    """Whether `put_object` needs `allow_ec_overwrites` (real RGW keeps
    bucket data on an EC pool without it): PUTs, an overwrite, a 3-part
    multipart upload whose parts are whole 64 KiB, a delete and the
    index's rewrites, at the reference's layout and at RGW's 4 MiB stripe,
    all land on a pool without overwrites and read back, in both packages.
    Parts that are not whole stripes append at an unaligned offset, which
    such a pool refuses (EINVAL) in both."""
    root = ROOT[pkg]
    rgw = importlib.import_module(f"{root}.rgw")
    striper = importlib.import_module(f"{root}.striper")
    rados_mod = importlib.import_module(f"{root}.client.rados")
    bodies = rgw_bodies(3)
    parts = [(body * 64)[:65536 * n] for n, body in enumerate(bodies["parts"], 1)]

    async def run():
        c = make_cluster(pkg, tmp_path, pools=APPEND_ONLY)
        r = None
        try:
            await c.start(30)
            r, _ = await connect(pkg, c)
            io = await r.open_ioctx("rgw_data")
            out = []
            for policy in (None, striper.StripePolicy(stripe_unit=4 << 20, stripe_count=1,
                                                      object_size=4 << 20)):
                gw = rgw.ObjectGateway(io, policy=policy)
                bucket = "b" if policy is None else "b4m"
                await gw.create_bucket(bucket)
                for key, body in zip(("a", "b", "a"), bodies["keys"]):
                    await gw.put_object(bucket, key, body)
                for key, chunks in (("mp", parts), ("odd", bodies["parts"])):
                    upload = await gw.initiate_multipart(bucket, key)
                    for n, body in enumerate(chunks, 1):
                        await gw.upload_part(upload, n, body)
                    try:
                        await gw.complete_multipart(upload)
                    except rados_mod.RadosError as e:
                        out.append((key, e.errno))
                await gw.delete_object(bucket, "b")
                out.append([await gw.get_object(bucket, key) for key in ("a", "mp")])
                out.append(sorted(e["key"] for e in (await gw.list_objects(bucket))["contents"]))
            return out
        finally:
            if r is not None:
                await r.shutdown()
            await c.stop()

    got = asyncio.run(run())
    want = [("odd", -22), [bodies["keys"][2], b"".join(parts)], ["a", "mp"]]
    assert got == want + want


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_concurrent_puts_into_one_bucket_lose_index_entries_in_both(pkg, tmp_path):
    """ROADMAP C28, the reference's and kept: each PUT reads the bucket
    index object, adds its key and writes it back whole, so of 8 PUTs in
    flight into one bucket some keys are missing from the listing, though
    every object's data landed.  One PUT at a time keeps every key."""
    rgw = importlib.import_module(f"{ROOT[pkg]}.rgw")

    async def run():
        c = make_cluster(pkg, tmp_path, pools=POOLS)
        r = None
        try:
            await c.start(30)
            r, _ = await connect(pkg, c)
            gw = rgw.ObjectGateway(await r.open_ioctx("rgw"))
            for bucket in ("one", "serial"):
                await gw.create_bucket(bucket)
            keys = [f"k{i}" for i in range(8)]
            await asyncio.gather(*(gw.put_object("one", k, k.encode() * 100) for k in keys))
            for k in keys:
                await gw.put_object("serial", k, k.encode() * 100)
            listed = {b: [e["key"] for e in (await gw.list_objects(b))["contents"]]
                      for b in ("one", "serial")}
            data = [await gw._data("one", k).read() for k in keys]
            return keys, listed, data
        finally:
            if r is not None:
                await r.shutdown()
            await c.stop()

    keys, listed, data = asyncio.run(run())
    assert listed["serial"] == keys
    assert set(listed["one"]) < set(keys)
    assert data == [k.encode() * 100 for k in keys]
