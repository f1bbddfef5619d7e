"""The port's ECBackend write pipeline, reconstructing reads and recovery on
the CPU (`device="cpu"`), held against the JAX package's under
JAX_PLATFORMS=cpu.

One in-process cluster harness, built from either package's modules (one
backend per OSD over a MemStore, messages through a pumped queue, as
tests/test_ec_backend.py builds it), runs the reference's write/read,
overwrite and span tests for both packages.  A seeded differential test
then drives the same random operations through a cluster of each package
and compares, after every pump, every store's collections byte for byte
(data and xattrs), every listener's log entries, every message sent (by
`tobytes()`), every commit and failure callback and every read result; a
second one loses shards (the primary's among them) and recovers them, and
compares the same, MOSDPGPush messages included.
Both packages are pinned alike: the device chunk cache and the RMW delta
path off in every case that does not say otherwise, and on, at the
reference's defaults, in the `_with_cache_and_delta` cases; the reference
runs at dispatch width 1 (its tests run on an 8-device CPU mesh).  The
cache changes launches, not messages: stores, logs, messages and reads
agree byte for byte either way, and so do the two caches' counters."""

import asyncio
import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest

import ceph_tpu.osd.ec_backend as j_ecb
from ceph_tpu.common.options import OPTIONS as J_OPTIONS
from ceph_tpu.ops.device_cache import device_chunk_cache as j_device_chunk_cache
from ceph_tpu.parallel import dispatch as jshard

import ceph_tpu_torch.osd.ec_backend as t_ecb
from ceph_tpu_torch.codec.interface import EcError
from ceph_tpu_torch.common.errs import EIO, EOPNOTSUPP
from ceph_tpu_torch.common.fault_injector import global_injector
from ceph_tpu_torch.ops import dispatch
from ceph_tpu_torch.ops.device_cache import device_chunk_cache as t_device_chunk_cache
from ceph_tpu_torch.ops.flight_recorder import flight_recorder
from ceph_tpu_torch.ops.guard import device_guard

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

PKGS = ("jax", "torch")
ROOT = {"jax": "ceph_tpu", "torch": "ceph_tpu_torch"}


def caches():
    return {"jax": j_device_chunk_cache(), "torch": t_device_chunk_cache()}


def set_cache_and_delta(on: bool) -> None:
    """Both packages' device chunk cache and RMW delta path, alike: off, or
    on at the reference's defaults (`ec_tpu_device_cache_bytes`,
    `ec_tpu_rmw_delta`)."""
    size = int(J_OPTIONS["ec_tpu_device_cache_bytes"].default) if on else 0
    delta = bool(J_OPTIONS["ec_tpu_rmw_delta"].default) and on
    for cache in caches().values():
        cache.clear()
        cache.configure(max_bytes=size)
    j_ecb.configure_rmw_delta(delta)
    t_ecb.configure_rmw_delta(delta)


@pytest.fixture(autouse=True)
def _pin_reference():
    saved = {pkg: c.max_bytes for pkg, c in caches().items()}
    deltas = (j_ecb._RMW_DELTA, t_ecb._RMW_DELTA)
    set_cache_and_delta(False)
    settings = jshard.settings()
    jshard.configure(devices=1)
    yield
    for pkg, cache in caches().items():
        cache.clear()
        cache.configure(max_bytes=saved[pkg])
    j_ecb._RMW_DELTA, t_ecb._RMW_DELTA = deltas
    jshard.configure(*settings)
    global_injector().clear()
    g = device_guard()
    g.mark_healthy()
    g.configure(timeout_ms=20000, probe_interval_ms=2000)


_MODS: dict[str, SimpleNamespace] = {}


def mods(pkg: str) -> SimpleNamespace:
    """The modules a cluster of package `pkg` is built from."""
    if pkg not in _MODS:
        root = ROOT[pkg]
        imp = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
        ns = SimpleNamespace(
            messages=imp("msg.messages"),
            memstore=imp("os.memstore"),
            bluestore=imp("os.bluestore"),
            objectstore=imp("os.objectstore"),
            transaction=imp("os.transaction"),
            ec_transaction=imp("osd.ec_transaction"),
            osdmap=imp("osd.osdmap"),
            pg_backend=imp("osd.pg_backend"),
            pg_log=imp("osd.pg_log"),
            stripe=imp("stripe"),
            tracer=imp("common.tracer"),
        )
        ns.Listener = _listener_class(ns)
        _MODS[pkg] = ns
    return _MODS[pkg]


def _listener_class(m):
    class Listener(m.pg_backend.PGListener):
        def __init__(self, cluster, osd, shard, pgid):
            self.cluster = cluster
            self.osd = osd
            self.shard = shard
            self.pgid = pgid
            self.version = 0
            self.log = []
            self.clog = []
            self.hists = []
            self.recovered_local = []
            self.recovered_global = []

        def whoami(self):
            return self.osd

        def whoami_shard(self):
            return self.shard

        def acting(self):
            return self.cluster.acting

        def epoch(self):
            return 1

        def next_version(self):
            self.version += 1
            return m.pg_log.Eversion(1, self.version)

        def send_shard(self, osd, msg):
            self.cluster.sent.append((osd, type(msg).__name__, msg.tobytes()))
            self.cluster.queue.append((osd, msg))

        def append_log(self, entry):
            self.log.append(entry)

        def get_shard_missing(self, oid):
            return self.cluster.missing.get(oid, set())

        def clog_error(self, msg):
            self.clog.append(msg)

        def perf_hist(self, name, value):
            self.hists.append(name)

        def on_local_recover(self, oid):
            self.recovered_local.append(oid)

        def on_global_recover(self, oid):
            self.recovered_global.append(oid)

    return Listener


class Cluster:
    """One backend per OSD over MemStores (or, with `bluestore`, in-memory
    BlueStores made with those keywords), with a pumped message queue."""

    def __init__(self, pkg, k=4, m=2, stripe_unit=4096, overwrites=False, fast_read=False,
                 plugin="tpu", bluestore=None, **profile_extra):
        self.pkg = pkg
        self.m = mods(pkg)
        om = self.m.osdmap
        self.pool = om.PgPool(
            id=1,
            name="ecpool",
            type=om.POOL_TYPE_ERASURE,
            size=k + m,
            pg_num=1,
            erasure_code_profile="prof",
            stripe_width=k * stripe_unit,
            flags=om.FLAG_EC_OVERWRITES if overwrites else 0,
            fast_read=fast_read,
        )
        profiles = {"prof": {"plugin": plugin, "k": str(k), "m": str(m), **profile_extra}}
        self.pgid = self.m.messages.PgId(1, 0, -1)
        self.acting = list(range(k + m))
        self.queue = []
        self.sent = []
        self.missing = {}
        self.stores, self.listeners, self.backends = [], [], []
        kw = {"device": "cpu"} if pkg == "torch" else {}
        for osd in range(k + m):
            if bluestore is None:
                store = self.m.memstore.MemStore()
            else:
                store = self.m.bluestore.BlueStore(None, **bluestore, **kw)
            store.mount()
            listener = self.m.Listener(self, osd, osd, self.pgid)
            backend = self.m.pg_backend.build_pg_backend(
                self.pool, profiles, listener, store, **kw
            )
            coll = self.m.pg_backend.shard_coll(self.pgid, osd)
            store.queue_transaction(self.m.transaction.Transaction().create_collection(coll))
            self.stores.append(store)
            self.listeners.append(listener)
            self.backends.append(backend)

    @property
    def sw(self):
        return self.pool.stripe_width

    @property
    def primary(self):
        return self.backends[next(o for o in self.acting if o != self.m.osdmap.PG_NONE)]

    def coll(self, shard):
        return self.m.pg_backend.shard_coll(self.pgid, shard)

    def deliver(self):
        """Deliver queued messages (no encode barrier)."""
        while self.queue:
            osd, msg = self.queue.pop(0)
            if osd == self.m.osdmap.PG_NONE or not 0 <= osd < len(self.backends):
                continue
            self.backends[osd].handle_message(msg)

    def pump(self):
        steps = 0
        while True:
            for b in self.backends:
                b.flush_encodes()
            if not self.queue:
                return steps
            osd, msg = self.queue.pop(0)
            if osd == self.m.osdmap.PG_NONE or not 0 <= osd < len(self.backends):
                continue
            self.backends[osd].handle_message(msg)
            steps += 1
            assert steps < 100000, "message storm"

    def submit(self, pgt, reqid, events, tag):
        self.primary.submit_transaction(
            pgt,
            self.m.messages.ReqId("client", reqid),
            lambda: events.append((tag, "commit")),
            lambda err: events.append((tag, "fail", err)),
        )

    def pgt(self, oid, **kw):
        return self.m.ec_transaction.PGTransaction(oid, **kw)

    def write(self, oid, off, data, pump=True):
        done = []
        self.primary.submit_transaction(
            self.pgt(oid).write(off, data),
            self.m.messages.ReqId("client", 1),
            lambda: done.append(1),
        )
        if pump:
            self.pump()
            assert done, "write did not commit"
        return done

    def read_raw(self, oid, extents, backend=None):
        out = {}
        (backend or self.primary).objects_read_and_reconstruct(
            {oid: list(extents)}, lambda res: out.update(res)
        )
        self.pump()
        assert oid in out, "read did not complete"
        return out[oid]

    def read(self, oid, off, length):
        err, bufs = self.read_raw(oid, [(off, length)])
        assert err == 0, f"read failed: {err}"
        return bufs[0]

    def hinfo(self, shard, oid):
        blob = self.stores[shard].getattr(
            self.coll(shard), oid, self.m.ec_transaction.HINFO_ATTR
        )
        return self.m.stripe.HashInfo.decode(blob)

    def state(self):
        """Every store's collections (data, xattrs, omap), byte for byte;
        for BlueStores also the block image and the KV records."""
        if isinstance(self.stores[0], self.m.bluestore.BlueStore):
            return [
                (store._block_f.getvalue(), dict(store.db._data), {
                    coll: {oid: (store.read(coll, oid), store.getattrs(coll, oid),
                                 store.omap_get(coll, oid))
                           for oid in store.list_objects(coll)}
                    for coll in store.list_collections()})
                for store in self.stores
            ]
        return [
            {
                coll: {
                    oid: (bytes(o.data), dict(o.xattrs), dict(o.omap))
                    for oid, o in objs.items()
                }
                for coll, objs in store._colls.items()
            }
            for store in self.stores
        ]

    def logs(self):
        return [[e.tobytes() for e in lst.log] for lst in self.listeners]

    def quiescent(self):
        for b in self.backends:
            assert not b.in_flight and not b._encode_pipe
            assert not b.waiting_reads and not b.read_ops
            assert b.extent_cache.empty() and not b._projected
            assert not b.recovery_ops and not b._decode_pipe

    def lose(self, oid, shards):
        """Wipe `shards`' copies of `oid` and mark them missing; returns
        their (bytes, xattrs) before the loss."""
        before = {}
        for s in shards:
            before[s] = (
                self.stores[s].read(self.coll(s), oid, 0, 0),
                self.stores[s].getattrs(self.coll(s), oid),
            )
            self.stores[s]._remove(self.coll(s), oid)
        self.missing[oid] = set(shards)
        return before

    def recover(self, oids, shards, pump=True):
        """recover_object for every oid; returns the callbacks' errnos."""
        res = []
        for oid in oids:
            self.primary.recover_object(oid, set(shards), res.append)
        if pump:
            self.pump()
            for oid in oids:
                self.missing.pop(oid, None)
        return res


def payload(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.uint8).tobytes()


# -- the reference's write/read tests, for both packages ------------------------------


@pytest.mark.parametrize("pkg", PKGS)
class TestEcWriteRead:
    def test_append_and_read(self, pkg):
        c = Cluster(pkg)
        data = payload(3 * c.sw)
        c.write("obj", 0, data)
        assert c.read("obj", 0, len(data)) == data
        assert c.read("obj", 100, 5000) == data[100:5100]
        c.quiescent()

    def test_shard_layout_and_hinfo(self, pkg):
        c = Cluster(pkg)
        data = payload(2 * c.sw)
        c.write("obj", 0, data)
        for s in range(6):
            chunk = c.stores[s].read(c.coll(s), "obj", 0, 0)
            assert len(chunk) == 2 * c.sw // 4
            assert c.hinfo(s, "obj").verify_chunk(s, chunk)

    def test_sequential_appends_chain_hinfo(self, pkg):
        c = Cluster(pkg)
        d1, d2 = payload(c.sw, 1), payload(2 * c.sw, 2)
        c.write("obj", 0, d1)
        c.write("obj", c.sw, d2)
        assert c.read("obj", 0, 3 * c.sw) == d1 + d2
        assert c.hinfo(3, "obj").get_total_chunk_size() == 3 * c.sw // 4

    def test_full_rewrite_restarts_hinfo_chain(self, pkg):
        c = Cluster(pkg)
        d1, d2 = payload(c.sw, 1), payload(c.sw, 2)
        c.write("obj", 0, d1)
        c.write("obj", 0, d2)
        assert c.read("obj", 0, c.sw) == d2
        assert c.hinfo(0, "obj").verify_chunk(0, c.stores[0].read(c.coll(0), "obj", 0, 0))

    def test_unaligned_append_rejected_without_overwrites(self, pkg):
        c = Cluster(pkg)
        err_type = EcError if pkg == "torch" else importlib.import_module(
            "ceph_tpu.codec.interface"
        ).EcError
        with pytest.raises(err_type):
            c.write("obj", 17, b"x" * 100, pump=False)

    def test_degraded_read(self, pkg):
        c = Cluster(pkg)
        data = payload(2 * c.sw)
        c.write("obj", 0, data)
        c.acting[1] = c.acting[5] = c.m.osdmap.PG_NONE
        assert c.read("obj", 0, len(data)) == data
        c.quiescent()

    def test_too_many_failures_is_eio(self, pkg):
        c = Cluster(pkg)
        data = payload(c.sw)
        c.write("obj", 0, data)
        for s in (0, 1, 2):
            c.acting[s] = c.m.osdmap.PG_NONE
        err, bufs = c.read_raw("obj", [(0, len(data))], backend=c.backends[3])
        assert err == -EIO and bufs == []

    def test_corrupt_shard_escalates_to_redundant_read(self, pkg):
        c = Cluster(pkg)
        data = payload(c.sw)
        c.write("obj", 0, data)
        good = c.stores[0].read(c.coll(0), "obj", 0, 0)
        c.stores[0]._write(c.coll(0), "obj", 0, bytes([good[0] ^ 0xFF]) + good[1:])
        assert c.read("obj", 0, len(data)) == data
        assert any("crc mismatch" in e for e in c.listeners[0].clog)


@pytest.mark.parametrize("pkg", PKGS)
class TestEcOverwrites:
    def test_rmw_partial_stripe(self, pkg):
        c = Cluster(pkg, overwrites=True)
        base = payload(2 * c.sw)
        c.write("obj", 0, base)
        patch = payload(300, seed=9)
        c.write("obj", 1000, patch)
        expect = bytearray(base)
        expect[1000:1300] = patch
        assert c.read("obj", 0, len(base)) == bytes(expect)
        with pytest.raises(c.m.objectstore.StoreError):
            c.stores[0].getattr(c.coll(0), "obj", c.m.ec_transaction.HINFO_ATTR)

    def test_overwrite_spanning_stripes(self, pkg):
        c = Cluster(pkg, overwrites=True)
        base = payload(4 * c.sw)
        c.write("obj", 0, base)
        patch = payload(2 * c.sw + 777, seed=3)
        off = c.sw - 123
        c.write("obj", off, patch)
        expect = bytearray(base)
        expect[off : off + len(patch)] = patch
        assert c.read("obj", 0, len(base)) == bytes(expect)

    def test_pipelined_overlapping_writes(self, pkg):
        c = Cluster(pkg, overwrites=True)
        base = payload(c.sw)
        c.write("obj", 0, base)
        events = []
        p1, p2 = payload(200, seed=5), payload(200, seed=6)
        c.submit(c.pgt("obj").write(100, p1), 1, events, 1)
        c.submit(c.pgt("obj").write(200, p2), 2, events, 2)
        c.pump()
        assert events == [(1, "commit"), (2, "commit")]
        expect = bytearray(base)
        expect[100:300] = p1
        expect[200:400] = p2
        assert c.read("obj", 0, len(base)) == bytes(expect)
        c.quiescent()

    def test_encode_pipeline_overlaps_launch_with_commit(self, pkg):
        c = Cluster(pkg, overwrites=True)
        base = payload(c.sw)
        c.write("obj", 0, base)
        events = []
        p1 = payload(c.sw, seed=7)
        c.submit(c.pgt("obj").write(0, p1), 10, events, 1)
        c.submit(c.pgt("obj2").write(0, payload(c.sw, seed=9)), 11, events, 2)
        assert [op.pgt.oid for op in c.primary._encode_pipe] == ["obj", "obj2"]
        assert all(op.encoded for op in c.primary._encode_pipe)
        assert events == []
        assert all(not op.pending_commits for op in c.primary._encode_pipe)
        c.pump()
        assert events == [(1, "commit"), (2, "commit")]
        assert c.read("obj", 0, len(base)) == p1

    def test_truncate_unaligned(self, pkg):
        c = Cluster(pkg, overwrites=True)
        base = payload(2 * c.sw)
        c.write("obj", 0, base)
        t = c.sw + 500
        events = []
        c.submit(c.pgt("obj", truncate=t), 3, events, 1)
        c.pump()
        assert events == [(1, "commit")]
        assert c.read("obj", 0, t) == base[:t]


@pytest.mark.parametrize("pkg", PKGS)
class TestTracing:
    def _traced(self, pkg):
        c = Cluster(pkg, k=2, m=1)
        tracer = c.m.tracer.Tracer("osd.test")
        c.listeners[0].tracer = tracer
        return c, tracer

    def test_degraded_read_span_tree(self, pkg):
        c, tracer = self._traced(pkg)
        data = bytes(range(256)) * 64
        c.write("obj", 0, data)
        tracer.clear()
        c.missing["obj"] = {1}
        err, bufs = c.read_raw("obj", [(0, len(data))])
        assert err == 0 and bufs[0] == data
        spans = {s["span_id"]: s for s in tracer.export()}
        reads = [s for s in spans.values() if s["name"] == "ec:read"]
        assert len(reads) == 1 and reads[0]["end"] is not None
        events = [e["name"] for e in reads[0]["events"]]
        assert any(e.startswith("sub-reads to shards") for e in events)
        assert any(e.startswith("reply from shard") for e in events)
        assert "read complete" in events
        recon = [s for s in spans.values() if s["name"] == "ec:reconstruct"]
        assert len(recon) == 1 and recon[0]["parent_id"] == reads[0]["span_id"]
        assert recon[0]["end"] is not None
        assert "1" not in recon[0]["tags"]["have"].split(",")

    def test_write_span_commits_per_shard(self, pkg):
        c, tracer = self._traced(pkg)
        c.write("w", 0, b"x" * 8192)
        spans = [s for s in tracer.export() if s["name"] == "ec:write"]
        assert len(spans) == 1 and spans[0]["end"] is not None
        events = [e["name"] for e in spans[0]["events"]]
        assert "start ec write" in events and "all shards committed" in events
        assert sum(1 for e in events if e.startswith("commit from shard")) == 3


# -- the differential test ---------------------------------------------------------------


class Model:
    """The logical bytes every committed write leaves, updated at submit
    (same-object writes apply in submit order)."""

    def __init__(self):
        self.objs: dict[str, bytearray] = {}

    def write(self, oid, off, data):
        buf = self.objs.setdefault(oid, bytearray())
        if len(buf) < off:
            buf.extend(b"\x00" * (off - len(buf)))
        buf[off : off + len(data)] = data

    def truncate(self, oid, t):
        buf = self.objs.setdefault(oid, bytearray())
        if len(buf) > t:
            del buf[t:]
        else:
            buf.extend(b"\x00" * (t - len(buf)))


def _random_ops(rng, n, sw, k, m, overwrites):
    """`n` seeded operations, grouped into batches submitted before one
    pump each: appends, WRITEFULLs, overwrites, truncates, deletes,
    reads and degraded reads over four objects.  A read also says whether
    its object grew by a truncate since its last WRITEFULL or delete (the
    reference's defect C10, ROADMAP §C)."""
    model = Model()
    oids = ["a", "b", "c", "d"]
    grown = set()
    batches, batch = [], []
    for _ in range(n):
        oid = oids[int(rng.integers(len(oids)))]
        size = len(model.objs.get(oid, b""))
        padded = -(-size // sw) * sw
        kinds = ["append", "writefull", "read", "delete", "degraded"]
        if overwrites:
            kinds += ["overwrite", "overwrite", "truncate"]
        kind = kinds[int(rng.integers(len(kinds)))]
        if kind in ("read", "degraded") and size == 0:
            kind = "append"
        if kind == "append":
            ln = int(rng.integers(1, 3 * sw)) if overwrites else sw * int(rng.integers(1, 4))
            off = size if overwrites else padded
            data = rng.integers(0, 256, ln, dtype=np.uint8).tobytes()
            model.write(oid, off, data)
            batch.append(("write", oid, off, data, None))
        elif kind == "writefull":
            ln = int(rng.integers(1, 4 * sw)) if overwrites else sw * int(rng.integers(1, 4))
            data = rng.integers(0, 256, ln, dtype=np.uint8).tobytes()
            model.objs[oid] = bytearray(data)
            grown.discard(oid)
            batch.append(("write", oid, 0, data, ln))
        elif kind == "overwrite":
            off = int(rng.integers(0, max(size, 1) + sw))
            ln = int(rng.integers(1, 2 * sw))
            data = rng.integers(0, 256, ln, dtype=np.uint8).tobytes()
            model.write(oid, off, data)
            batch.append(("write", oid, off, data, None))
        elif kind == "truncate":
            t = int(rng.integers(0, size + sw))
            if t > size:
                grown.add(oid)
            model.truncate(oid, t)
            batch.append(("truncate", oid, t))
        elif kind == "delete":
            model.objs.pop(oid, None)
            grown.discard(oid)
            batch.append(("delete", oid))
        else:
            off = int(rng.integers(0, size))
            ln = int(rng.integers(1, size - off + 1))
            holes = []
            if kind == "degraded":
                # up to m shards other than the primary's go dark
                nh = int(rng.integers(1, m + 1))
                holes = sorted(int(s) for s in rng.choice(np.arange(1, k + m), nh, replace=False))
            batch.append(("read", oid, [(0, size), (off, ln)], holes,
                          bytes(model.objs[oid]), oid in grown))
            batches.append(batch)
            batch = []
            continue
        if rng.integers(3) == 0:
            batches.append(batch)
            batch = []
    if batch:
        batches.append(batch)
    return batches


def _run_batch(c, batch, events, results, reqid, defect_c10=False):
    """Submit one batch and pump.  With `defect_c10`, a degraded read of an
    object grown by a truncate may fail with EIO, as the reference's does
    (ROADMAP §C, C10); the differential still holds both packages to the
    same result."""
    for op in batch:
        reqid += 1
        if op[0] == "write":
            _, oid, off, data, truncate = op
            c.submit(c.pgt(oid, truncate=truncate).write(off, data), reqid, events, reqid)
        elif op[0] == "truncate":
            c.submit(c.pgt(op[1], truncate=op[2]), reqid, events, reqid)
        elif op[0] == "delete":
            c.submit(c.pgt(op[1], delete=True), reqid, events, reqid)
        else:
            _, oid, extents, holes, expect, grown = op
            c.pump()
            saved = list(c.acting)
            for h in holes:
                c.acting[h] = c.m.osdmap.PG_NONE
            err, bufs = c.read_raw(oid, extents)
            c.acting[:] = saved
            results.append((err, bufs))
            if defect_c10 and grown and holes and err == -EIO:
                continue
            assert err == 0 and bufs[0] == expect
            assert bufs[1] == expect[extents[1][0] : extents[1][0] + extents[1][1]]
    c.pump()
    return reqid


@pytest.mark.parametrize(
    "k,m,overwrites,fast_read,seed",
    [(4, 2, True, False, 1), (4, 2, False, False, 2), (8, 3, True, False, 3),
     (8, 3, False, False, 4), (4, 2, True, True, 5)],
)
def test_seeded_operations_match_reference(k, m, overwrites, fast_read, seed):
    """40 seeded operations through a cluster of each package: after every
    pump the stores, logs, messages, callbacks and read results agree.
    With `fast_read` every available shard is read and the first k win."""
    _seeded_operations(k, m, overwrites, fast_read, seed)


SEEDED_CASES = [(4, 2, True, False, 1), (4, 2, False, False, 2), (8, 3, True, False, 3),
                (8, 3, False, False, 4), (4, 2, True, True, 5)]


@pytest.mark.parametrize("k,m,overwrites,fast_read,seed", SEEDED_CASES)
def test_seeded_operations_match_reference_with_cache_and_delta(
    k, m, overwrites, fast_read, seed
):
    """The same seeded operations with both packages' device chunk cache
    and RMW delta path on, at the reference's defaults: stores, logs,
    messages, callbacks and reads agree byte for byte, and so do the two
    caches' counters (hits, misses, insertions, invalidations, delta
    updates, served and resident bytes)."""
    set_cache_and_delta(True)
    before = {pkg: c.perf_dump() for pkg, c in caches().items()}
    _seeded_operations(k, m, overwrites, fast_read, seed)
    moved = {
        pkg: {key: val - before[pkg].get(key, 0) for key, val in c.perf_dump().items()}
        for pkg, c in caches().items()
    }
    assert moved["torch"] == moved["jax"]
    assert moved["torch"]["insertions"] > 0


def _c10_tags(batches):
    """Tags of the writes and truncates to an object grown by a truncate
    since its last WRITEFULL or delete: the ops whose RMW read may fail
    with EIO in both packages (ROADMAP §C, C10)."""
    model, grown, tags, tag = Model(), set(), set(), 0
    for batch in batches:
        for op in batch:
            tag += 1
            kind, oid = op[0], op[1]
            if kind in ("write", "truncate") and oid in grown:
                tags.add(tag)
            if kind == "write" and op[4] is not None:
                model.objs[oid] = bytearray(op[3])
                grown.discard(oid)
            elif kind == "write":
                model.write(oid, op[2], op[3])
            elif kind == "truncate":
                if op[2] > len(model.objs.get(oid, b"")):
                    grown.add(oid)
                model.truncate(oid, op[2])
            elif kind == "delete":
                model.objs.pop(oid, None)
                grown.discard(oid)
    return tags


def _seeded_operations(k, m, overwrites, fast_read, seed, bluestore=None, stripe_unit=4096):
    defect_c10 = bluestore is not None
    clusters = {
        pkg: Cluster(pkg, k=k, m=m, stripe_unit=stripe_unit, overwrites=overwrites,
                     fast_read=fast_read, bluestore=bluestore)
        for pkg in PKGS
    }
    batches = _random_ops(
        np.random.default_rng(seed), 40, clusters["jax"].sw, k, m, overwrites
    )
    state = {pkg: ([], [], 0) for pkg in PKGS}
    for batch in batches:
        for pkg, c in clusters.items():
            events, results, reqid = state[pkg]
            state[pkg] = (events, results,
                          _run_batch(c, batch, events, results, reqid, defect_c10))
        j, t = clusters["jax"], clusters["torch"]
        assert t.state() == j.state()
        assert t.logs() == j.logs()
        assert t.sent == j.sent
        assert state["torch"][:2] == state["jax"][:2]
    events = state["torch"][0]
    c10 = _c10_tags(batches) if defect_c10 else set()
    assert all(e[1] == "commit" or (e[0] in c10 and e[2] == -EIO) for e in events)
    assert len(events) > 10
    assert len(state["torch"][1]) >= 5
    for c in clusters.values():
        c.quiescent()


# -- the event-loop drain, and the port's failed-launch contract ---------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_event_loop_drain_reaps_without_flush(pkg):
    """Writes submitted under a running event loop are reaped by
    `_schedule_drain`'s callbacks: no `flush_encodes` is ever called."""
    c = Cluster(pkg, overwrites=True)
    datas = [payload(c.sw + 1000 * i, seed=i) for i in range(4)]
    events = []

    async def main():
        for i, d in enumerate(datas):
            c.submit(c.pgt(f"o{i}").write(0, d), i, events, i)
        deadline = time.monotonic() + 20
        while len(events) < len(datas) and time.monotonic() < deadline:
            await asyncio.sleep(0.002)
            c.deliver()

    asyncio.run(main())
    assert sorted(events) == [(i, "commit") for i in range(4)]
    for i, d in enumerate(datas):
        assert c.read(f"o{i}", 0, len(d)) == d
    c.quiescent()


def test_failed_launch_fails_the_write_and_its_dependants():
    """A failed encode launch raises EIO at the reap (the port has no host
    recompute): the op and every later same-object write that has not fanned
    out get on_failure(-EIO), the pins are released, the projection rolls
    back, no store is written, and once a probe heals the guard the next
    write commits."""
    c = Cluster("torch", overwrites=True)
    base = payload(c.sw)
    c.write("obj", 0, base)
    before = c.state()
    fb0 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
    device_guard().configure(probe_interval_ms=10_000_000)
    global_injector().inject("codec.launch", 5, hits=1)
    events = []
    c.submit(c.pgt("obj").write(0, payload(c.sw, seed=1)), 2, events, 1)
    c.submit(c.pgt("obj").write(100, payload(300, seed=2)), 3, events, 2)
    c.pump()
    assert events == [(1, "fail", -EIO), (2, "fail", -EIO)]
    assert c.state() == before
    assert c.primary.extent_cache.empty() and not c.primary._projected
    assert not c.primary.in_flight and not c.primary._encode_pipe
    assert any("encode launch for obj failed" in e for e in c.listeners[0].clog)
    assert device_guard().degraded
    device_guard().configure(probe_interval_ms=1)
    time.sleep(0.01)
    assert device_guard().maybe_probe(lambda: None) is True
    patch = payload(300, seed=3)
    c.submit(c.pgt("obj").write(100, patch), 4, events, 3)
    c.pump()
    assert events[-1] == (3, "commit")
    expect = bytearray(base)
    expect[100:400] = patch
    assert c.read("obj", 0, c.sw) == bytes(expect)
    assert dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fb0
    c.quiescent()


def test_unported_paths_raise_eopnotsupp():
    """Replicated pools are ported now: building their backend gives the
    ReplicatedBackend.  What stays unported answers -EOPNOTSUPP: COPY_FROM
    on a PG (the daemon's objecter leg), whichever backend it runs on."""
    c = Cluster("torch")
    m = mods("torch")
    pool = m.osdmap.PgPool(id=2, name="rep", type=m.osdmap.POOL_TYPE_REPLICATED, size=3)
    backend = m.pg_backend.build_pg_backend(pool, {}, c.listeners[0], c.stores[0], device="cpu")
    assert isinstance(backend, m.pg_backend.ReplicatedBackend)
    pg_mod = importlib.import_module("ceph_tpu_torch.osd.pg")
    conf = importlib.import_module("ceph_tpu_torch.common.config").Config(env=False)
    host = SimpleNamespace(whoami=0, store=c.stores[0], conf=conf,
                           send_cluster=lambda osd, msg: None)
    for p in (pool, c.pool):
        pg = pg_mod.PG(host, p, 0, {"prof": {"plugin": "tpu", "k": "4", "m": "2"}}, device="cpu")
        pg.on_new_interval(1, [0] + [m.osdmap.PG_NONE] * (p.size - 1))
        replies = []
        op = m.messages.OSDOp(op=m.messages.OSDOp.COPY_FROM, name="src")
        pg.do_op(m.messages.MOSDOp(reqid=m.messages.ReqId("client.1", 1), pgid=pg.pgid,
                                   oid="o", ops=[op]), replies.append)
        assert [r.result for r in replies] == [-EOPNOTSUPP]


def test_partly_pinned_rmw_read_keeps_the_earlier_write():
    """Two pipelined RMWs on one object: the second's read range spans a
    stripe the first has pinned and one it has not.  The pinned stripe
    comes from the pin, the other from the shards, and both writes read
    back.  (The reference reads the whole range from the shards, before
    the first write's sub-writes apply, and loses the first write: the
    one place the two packages differ, ROADMAP.md C5.)"""
    got = {}
    for pkg in PKGS:
        c = Cluster(pkg, overwrites=True)
        base = payload(6 * c.sw)
        c.write("obj", 0, base)
        events = []
        p1, p2 = payload(100, seed=1), payload(c.sw + 200, seed=2)
        c.submit(c.pgt("obj").write(3 * c.sw + 10, p1), 1, events, 1)
        c.submit(c.pgt("obj").write(3 * c.sw + 500, p2), 2, events, 2)
        c.pump()
        assert events == [(1, "commit"), (2, "commit")]
        expect = bytearray(base)
        expect[3 * c.sw + 10 : 3 * c.sw + 110] = p1
        expect[3 * c.sw + 500 : 3 * c.sw + 500 + len(p2)] = p2
        got[pkg] = c.read("obj", 0, len(base)) == bytes(expect)
        c.quiescent()
    assert got == {"torch": True, "jax": False}


# -- recovery ---------------------------------------------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("lost", [[1], [2, 5], [0]], ids=["data", "parity+data", "primary"])
def test_recover_lost_shards(pkg, lost):
    """The reference's recovery tests, for both packages: lost shards (the
    primary's own among them) are rebuilt byte for byte with their attrs;
    the target notes a local recover and the primary a global one."""
    c = Cluster(pkg)
    c.write("obj", 0, payload(3 * c.sw))
    before = c.lose("obj", lost)
    assert c.recover(["obj"], lost) == [0]
    for s, (data, attrs) in before.items():
        assert c.stores[s].read(c.coll(s), "obj", 0, 0) == data
        assert c.stores[s].getattrs(c.coll(s), "obj") == attrs
        assert "obj" in c.listeners[s].recovered_local
    assert c.listeners[0].recovered_global == ["obj"]
    c.quiescent()


def _recovery_scenario(pkg, k, m, seed):
    """Writes, then losses of one shard, two shards and the primary's own,
    each recovered for every object in one pump; returns the cluster."""
    c = Cluster(pkg, k=k, m=m)
    rng = np.random.default_rng(seed)
    oids = [f"obj{i}" for i in range(5)]
    for oid in oids:
        c.write(oid, 0, rng.integers(0, 256, int(rng.integers(1, 4)) * c.sw,
                                     dtype=np.uint8).tobytes())
    losses = [[1], [0], [k, 1], [0, k + m - 1]] + ([[2, 0, k]] if m > 2 else [])
    results, trail = [], []
    for lost in losses:
        before = {oid: c.lose(oid, lost) for oid in oids}
        results.append(c.recover(oids, lost))
        trail.append((c.state(), list(c.sent)))
        for oid, snap in before.items():
            for s, (data, attrs) in snap.items():
                assert c.stores[s].read(c.coll(s), oid, 0, 0) == data
                assert c.stores[s].getattrs(c.coll(s), oid) == attrs
    c.quiescent()
    return results, trail, c


@pytest.mark.parametrize("k,m,seed", [(4, 2, 11), (8, 3, 12)])
def test_seeded_recovery_matches_reference(k, m, seed):
    """Seeded writes, then losses (one shard, the primary's own, two, and
    three on 11 OSDs) recovered through a cluster of each package: every
    callback is 0, and after every recovery the stores, the messages sent
    (MOSDPGPush and MOSDPGPushReply among them, by `tobytes()`) and the
    logs agree byte for byte."""
    got = {pkg: _recovery_scenario(pkg, k, m, seed) for pkg in PKGS}
    (jres, jtrail, jc), (tres, ttrail, tc) = got["jax"], got["torch"]
    assert tres == jres and all(r == [0] * 5 for r in tres)
    assert ttrail == jtrail
    assert tc.logs() == jc.logs()
    kinds = {name for _osd, name, _raw in tc.sent}
    assert {"MOSDPGPush", "MOSDPGPushReply"} <= kinds


@pytest.mark.parametrize("k,m,seed", [(4, 2, 11), (8, 3, 12)])
def test_seeded_recovery_matches_reference_with_cache_and_delta(k, m, seed):
    """The seeded recoveries with both packages' device chunk cache and
    RMW delta path on: the recovery decodes consult the cache and cache
    what they rebuild, and callbacks, stores, messages, logs and the two
    caches' counters agree."""
    set_cache_and_delta(True)
    before = {pkg: c.perf_dump() for pkg, c in caches().items()}
    got = {pkg: _recovery_scenario(pkg, k, m, seed) for pkg in PKGS}
    (jres, jtrail, jc), (tres, ttrail, tc) = got["jax"], got["torch"]
    assert tres == jres and all(r == [0] * 5 for r in tres)
    assert ttrail == jtrail
    assert tc.logs() == jc.logs()
    moved = {
        pkg: {key: val - before[pkg].get(key, 0) for key, val in c.perf_dump().items()}
        for pkg, c in caches().items()
    }
    assert moved["torch"] == moved["jax"] and moved["torch"]["insertions"] > 0


# -- the device chunk cache and the RMW delta path ------------------------------------


def _fr(pkg):
    if pkg == "torch":
        return flight_recorder()
    return importlib.import_module("ceph_tpu.ops.flight_recorder").flight_recorder()


def _dispatch(pkg):
    return dispatch if pkg == "torch" else importlib.import_module("ceph_tpu.ops.dispatch")


def _last_seq(fr) -> int:
    recs = fr.records()
    return recs[-1]["seq"] if recs else -1


@pytest.mark.parametrize("pkg", PKGS)
def test_cache_hit_rmw_takes_the_delta_path(pkg):
    """A WRITEFULL seeds its region's k+m chunks; an RMW inside that region
    then finds every operand resident and updates parity on the device:
    `delta_updates` rises by m, one `#delta` flight record shows h2d_s ==
    d2h_s == 0, the encode aggregator launches nothing, and the stores
    equal those of a cluster with the cache and the delta path off."""
    states = {}
    for on in (True, False):
        set_cache_and_delta(on)
        c = Cluster(pkg, overwrites=True)
        base = payload(2 * c.sw)
        c.write("obj", 0, base)
        cache, fr = caches()[pkg], _fr(pkg)
        d0, seq0 = cache.delta_updates, _last_seq(fr)
        agg0 = int(c.primary.encode_aggregator.perf.get("launches"))
        launches0 = _dispatch(pkg).LAUNCHES.snapshot()["launches"]
        patch = payload(300, seed=9)
        c.write("obj", 1000, patch)
        expect = bytearray(base)
        expect[1000:1300] = patch
        assert c.read("obj", 0, len(base)) == bytes(expect)
        states[on] = c.state()
        if on:
            assert cache.delta_updates - d0 == 2
            recs = [r for r in fr.records() if r["seq"] > seq0 and r["group"] == "#delta"]
            assert len(recs) == 1
            assert recs[0]["h2d_s"] == 0 and recs[0]["d2h_s"] == 0
            assert recs[0]["flags"]["delta"] and recs[0]["flags"]["cache_hit"]
            assert int(c.primary.encode_aggregator.perf.get("launches")) == agg0
            assert _dispatch(pkg).LAUNCHES.snapshot()["launches"] - launches0 == 1
        c.quiescent()
    assert states[True] == states[False]


@pytest.mark.parametrize("pkg", PKGS)
def test_repeated_degraded_read_is_served_from_the_cache(pkg):
    """The first degraded read launches a decode and caches its rebuilt
    chunks; the same read again is served by one D2H from the cache: no
    decode launch, the hits counted, and one `cache_hit` flight record
    with no H2D and no kernel time."""
    set_cache_and_delta(True)
    c = Cluster(pkg)
    data = payload(2 * c.sw)
    c.write("obj", 0, data)
    c.acting[1] = c.m.osdmap.PG_NONE
    counter = _dispatch(pkg).DECODE_LAUNCHES
    cache, fr = caches()[pkg], _fr(pkg)
    dec0 = counter.snapshot()["launches"]
    assert c.read("obj", 0, len(data)) == data
    assert counter.snapshot()["launches"] - dec0 == 1
    hits0, seq0 = cache.hits, _last_seq(fr)
    assert c.read("obj", 0, len(data)) == data
    assert counter.snapshot()["launches"] - dec0 == 1
    assert cache.hits - hits0 == 1
    recs = [r for r in fr.records() if r["seq"] > seq0]
    assert len(recs) == 1 and recs[0]["flags"]["cache_hit"] and recs[0]["group"] == "#cache"
    assert recs[0]["h2d_s"] == 0 and recs[0]["kernel_s"] == 0 and recs[0]["d2h_s"] > 0
    c.quiescent()


def test_failed_delta_launch_is_eio_clears_the_cache_and_is_not_reencoded():
    """A failed delta launch (`codec.launch` armed once) fails the write
    with EIO through `_fail_encoded_op`: no store changes, the backend goes
    DEGRADED, the cache is empty (ledger bytes too), the `#delta` record is
    flagged, and nothing is encoded on the materialize path.  Once a probe
    heals the guard, the next write commits."""
    set_cache_and_delta(True)
    c = Cluster("torch", overwrites=True)
    base = payload(2 * c.sw)
    c.write("obj", 0, base)
    cache = t_device_chunk_cache()
    assert cache.perf_dump()["entries"] == 6
    before = c.state()
    agg0 = int(c.primary.encode_aggregator.perf.get("launches"))
    launches0 = dispatch.LAUNCHES.snapshot()["launches"]
    seq0 = _last_seq(flight_recorder())
    device_guard().configure(probe_interval_ms=10_000_000)
    global_injector().inject("codec.launch", 5, hits=1)
    events = []
    c.submit(c.pgt("obj").write(1000, payload(300, seed=9)), 2, events, 1)
    c.pump()
    assert events == [(1, "fail", -EIO)]
    assert c.state() == before
    assert device_guard().degraded
    dump = cache.perf_dump()
    assert dump["entries"] == 0 and dump["resident_bytes"] == 0
    from ceph_tpu_torch.common.mempool import ledger

    assert ledger().current_bytes("device_cache") == 0
    assert int(c.primary.encode_aggregator.perf.get("launches")) == agg0
    assert dispatch.LAUNCHES.snapshot()["launches"] == launches0
    recs = [r for r in flight_recorder().records() if r["seq"] > seq0]
    assert [(r["group"], r["flags"]["error"]) for r in recs] == [("#delta", True)]
    assert any("encode launch for obj failed" in e for e in c.listeners[0].clog)
    c.quiescent()
    device_guard().configure(probe_interval_ms=1)
    time.sleep(0.01)
    assert device_guard().maybe_probe(lambda: None) is True
    patch = payload(300, seed=3)
    c.submit(c.pgt("obj").write(1000, patch), 3, events, 2)
    c.pump()
    assert events[-1] == (2, "commit")
    assert int(c.primary.encode_aggregator.perf.get("launches")) == agg0 + 1
    expect = bytearray(base)
    expect[1000:1300] = patch
    assert c.read("obj", 0, len(base)) == bytes(expect)
    c.quiescent()


def test_partly_pinned_rmw_read_keeps_the_earlier_write_with_cache_on():
    """ROADMAP.md C5 with the cache and the delta path on: the first RMW
    finds its stripe resident and takes the delta path, and the second
    RMW's read range spans that pinned (and resident) stripe and one that
    is not.  The port takes the pinned stripe from the pin and both writes
    read back; the reference still loses the first write."""
    got = {}
    for pkg in PKGS:
        set_cache_and_delta(True)
        c = Cluster(pkg, overwrites=True)
        base = payload(6 * c.sw)
        c.write("obj", 0, base)
        seed_patch = payload(50, seed=4)
        c.write("obj", 3 * c.sw + 3000, seed_patch)  # seeds stripe 3's region
        cache = caches()[pkg]
        d0 = cache.delta_updates
        events = []
        p1, p2 = payload(100, seed=1), payload(c.sw + 200, seed=2)
        c.submit(c.pgt("obj").write(3 * c.sw + 10, p1), 1, events, 1)
        c.submit(c.pgt("obj").write(3 * c.sw + 500, p2), 2, events, 2)
        c.pump()
        assert events == [(1, "commit"), (2, "commit")]
        assert cache.delta_updates - d0 == 2  # p1 took the delta path
        expect = bytearray(base)
        expect[3 * c.sw + 3000 : 3 * c.sw + 3050] = seed_patch
        expect[3 * c.sw + 10 : 3 * c.sw + 110] = p1
        expect[3 * c.sw + 500 : 3 * c.sw + 500 + len(p2)] = p2
        got[pkg] = c.read("obj", 0, len(base)) == bytes(expect)
        c.quiescent()
    assert got == {"torch": True, "jax": False}


@pytest.mark.parametrize("pkg", PKGS)
def test_clay_repair_reads_fragments(pkg):
    """CLAY k=4, m=2, d=5: one lost shard is repaired from sub-chunk
    fragments (d helpers x 1/q of a chunk each, not k whole chunks), and
    the rebuilt shard is exact."""
    c = Cluster(pkg, plugin="clay", d="5")
    ec = c.primary.ec
    assert ec.get_sub_chunk_count() == 8
    obj = payload(3 * c.sw, seed=4)
    c.write("obj", 0, obj)
    assert c.read("obj", 0, len(obj)) == obj
    before = c.lose("obj", [1])
    sent0 = len(c.sent)
    assert c.recover(["obj"], [1]) == [0]
    assert c.stores[1].read(c.coll(1), "obj", 0, 0) == before[1][0]
    replies = [raw for _osd, name, raw in c.sent[sent0:] if name == "MOSDECSubOpReadReply"]
    chunk = c.sw // 4
    shard_bytes = 3 * chunk
    payload_bytes = sum(len(raw) for raw in replies)
    assert len(replies) == 5
    assert payload_bytes < 4 * shard_bytes  # 5 helpers x half a chunk = 2.5 chunks
    c.quiescent()


def test_clay_repair_matches_reference():
    """The same CLAY repair through both packages: stores and messages
    agree byte for byte."""
    out = {}
    for pkg in PKGS:
        c = Cluster(pkg, plugin="clay", d="5")
        for i in range(3):
            c.write(f"o{i}", 0, payload((i + 1) * c.sw, seed=20 + i))
        for lost in ([1], [5], [0]):
            for i in range(3):
                c.lose(f"o{i}", lost)
            assert c.recover([f"o{i}" for i in range(3)], lost) == [0, 0, 0]
        out[pkg] = (c.state(), c.sent)
    assert out["torch"] == out["jax"]


def test_recovery_inflight_counts_the_decode_pipe():
    """recovery_inflight: objects mid-recovery, and those parked on the
    decode pipeline awaiting their (aggregated) launch's reap."""
    c = Cluster("torch")
    for i in range(3):
        c.write(f"o{i}", 0, payload(c.sw, seed=i))
    for i in range(3):
        c.lose(f"o{i}", [2])
    res = c.recover([f"o{i}" for i in range(3)], [2], pump=False)
    assert c.primary.recovery_inflight() == {"recovering": 3, "decoding": 0}
    c.deliver()  # the reads complete; each decode is launched, not reaped
    assert c.primary.recovery_inflight() == {"recovering": 3, "decoding": 3}
    assert all(r.state == "DECODING" for r in c.primary.recovery_ops.values())
    c.pump()
    assert res == [0, 0, 0]
    assert c.primary.recovery_inflight() == {"recovering": 0, "decoding": 0}


@pytest.mark.parametrize("pkg", PKGS)
def test_dropped_push_self_heals_via_retry(pkg):
    """ec.recover_push drops a PushOp at the target: the recovery parks in
    WRITING until retry_stalled_pushes re-sends it; a grace <= 0 retries
    nothing."""
    c = Cluster(pkg, k=2, m=1)
    c.write("obj", 0, b"x" * 5000 + payload(3192))
    before = c.lose("obj", [2])
    inj = (global_injector() if pkg == "torch" else importlib.import_module(
        "ceph_tpu.common.fault_injector").global_injector())
    inj.inject("ec.recover_push", 5, hits=1)
    done = []
    try:
        c.primary.recover_object("obj", {2}, done.append)
        c.pump()
        assert not done
        rec = c.primary.recovery_ops["obj"]
        assert rec.state == "WRITING" and rec.pending_pushes == {2}
        assert c.primary.retry_stalled_pushes(0) == 0
        time.sleep(0.02)
        assert c.primary.retry_stalled_pushes(0.01) == 1
        c.pump()
    finally:
        inj.clear("ec.recover_push")
    assert done == [0]
    assert c.primary.push_retries == 1
    assert c.stores[2].read(c.coll(2), "obj", 0, 0) == before[2][0]
    c.quiescent()


def test_failed_recovery_decode_is_eio_and_pushes_nothing():
    """A failed recovery decode launch (`codec.launch` armed once) completes
    recover_object with -EIO at the reap: nothing is pushed, nothing is
    recomputed on the host or stripe by stripe, and the next recovery,
    once a probe heals the guard, rebuilds the shard."""
    c = Cluster("torch")
    c.write("obj", 0, payload(2 * c.sw))
    before = c.lose("obj", [1])
    fb0 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
    device_guard().configure(probe_interval_ms=10_000_000)
    global_injector().inject("codec.launch", 5, hits=1)
    sent0 = len(c.sent)
    assert c.recover(["obj"], [1]) == [-EIO]
    assert not any(name == "MOSDPGPush" for _o, name, _r in c.sent[sent0:])
    assert not c.stores[1].exists(c.coll(1), "obj")
    assert dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fb0
    c.quiescent()
    device_guard().configure(probe_interval_ms=1)
    time.sleep(0.01)
    assert device_guard().maybe_probe(lambda: None) is True
    c.missing["obj"] = {1}
    assert c.recover(["obj"], [1]) == [0]
    assert c.stores[1].read(c.coll(1), "obj", 0, 0) == before[1][0]


def test_clay_fragments_without_a_repair_plan_are_eio():
    """Fragment reads that do not form CLAY's repair plan (a helper of the
    lost node's column missing) fail the recovery with EIO: there is no
    per-stripe decode on another path."""
    c = Cluster("torch", plugin="clay", d="5")
    c.write("obj", 0, payload(2 * c.sw, seed=6))
    backend = c.primary
    from ceph_tpu_torch.osd.ec_backend import RecoveryOp

    rec = RecoveryOp(oid="obj", missing_on={1}, on_complete=lambda err: None)
    rec.attrs = c.stores[0].getattrs(c.coll(0), "obj")
    frag = np.zeros(2 * (c.sw // 4) // 2, dtype=np.uint8)
    have = {s: frag for s in (2, 3, 4, 5)}  # shard 0, 1's column partner, absent
    with pytest.raises(EcError) as e:
        backend._decode_fragmented(rec, have, {1})
    assert e.value.errno == -EIO


def test_delta_write_traces_no_h2d_span():
    """A traced cache-hit RMW: its ec:write span notes the delta launch,
    and no `h2d` span fires (the resident operands reach the kernel
    without a copy), where the WRITEFULL that seeded the cache staged its
    bytes through one."""
    set_cache_and_delta(True)
    c = Cluster("torch", k=2, m=1, overwrites=True)
    tracer = c.m.tracer.Tracer("osd.test")
    c.listeners[0].tracer = tracer
    c.write("obj", 0, payload(2 * c.sw))
    assert any(s["name"] == "h2d" for s in tracer.export())
    tracer.clear()
    c.write("obj", 100, payload(300, seed=5))
    spans = tracer.export()
    (write,) = [s for s in spans if s["name"] == "ec:write"]
    assert "delta encode launched (cache hit)" in [e["name"] for e in write["events"]]
    assert not any(s["name"] == "h2d" for s in spans)
    c.quiescent()


# -- BlueStore shards: the checksum service, the device compressor and fault C8 -------


def _offload_perf():
    from ceph_tpu.compressor.device import default_compress_aggregator as j_compress
    from ceph_tpu.ops.checksum_offload import default_csum_aggregator as j_csum

    from ceph_tpu_torch.compressor.device import default_compress_aggregator as t_compress
    from ceph_tpu_torch.ops.checksum_offload import default_csum_aggregator as t_csum

    return {pkg: {name: agg().perf.get("launches") for name, agg in aggs.items()}
            for pkg, aggs in (("jax", {"csum": j_csum, "compress": j_compress}),
                              ("torch", {"csum": t_csum, "compress": t_compress}))}


@pytest.mark.parametrize("k,m,overwrites,seed,su", [(4, 2, True, 21, 16384),
                                                    (8, 3, False, 22, 4096),
                                                    (8, 3, True, 24, 4096)])
@pytest.mark.parametrize("store", [{"csum_offload": True}, {"compression": "device"},
                                   {"csum_offload": True, "compression": "device"}],
                         ids=["csum_offload", "device_compression", "both"])
def test_seeded_operations_on_bluestore_match_reference(monkeypatch, k, m, overwrites, seed,
                                                        su, store):
    """The seeded differential over in-memory BlueStore shards (6 and 11
    OSDs): stores (block images and KV records), logs, messages, callbacks
    and reads agree after every pump, and so do the checksum and compress
    launches, those of the EC-transaction fusion (`_csum_submit`) counted
    apart.  At a 16 KiB stripe unit the shard writes reach the device
    compressor's offload size; at Ceph's 4096 they take its host path."""
    fused = {"jax": 0, "torch": 0}
    for pkg, cls in (("jax", j_ecb.ECBackend), ("torch", t_ecb.ECBackend)):
        orig = cls._csum_submit

        def counting(self, chunk, chunk_off, orig=orig, pkg=pkg):
            ticket = orig(self, chunk, chunk_off)
            fused[pkg] += ticket is not None
            return ticket

        monkeypatch.setattr(cls, "_csum_submit", counting)
    before = _offload_perf()
    _seeded_operations(k, m, overwrites, False, seed, bluestore=store, stripe_unit=su)
    after = _offload_perf()
    moved = {pkg: {n: after[pkg][n] - before[pkg][n] for n in after[pkg]} for pkg in PKGS}
    assert moved["torch"] == moved["jax"]
    assert fused["torch"] == fused["jax"]
    if store.get("csum_offload"):
        assert fused["torch"] > 0 and moved["torch"]["csum"] > 0
    if store.get("compression") == "device" and su == 16384:
        assert moved["torch"]["compress"] > 0


@pytest.mark.parametrize("store", [{"csum_offload": True}, {"compression": "device"}],
                         ids=["csum", "compress"])
def test_failed_store_launch_fails_the_write_with_eio(store):
    """Fault C8 through the backend: `codec.launch` armed once the encode
    is reaped fails every shard store's checksum or compress launch (the
    probe cannot heal without a card), so every sub-write replies
    uncommitted, the write gets on_failure(-EIO), no shard commits or logs
    anything, and once a probe heals the guard the next write commits."""
    c = Cluster("torch", overwrites=True, bluestore=store)
    base = bytes(payload(8 * c.sw)[: 4 * c.sw]) + bytes(4 * c.sw)
    c.write("obj", 0, base)
    before, logs = c.state(), c.logs()
    fb0 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
    for st in c.stores:
        orig = st.queue_transaction

        def armed(txn, on_commit=None, orig=orig):
            global_injector().inject("codec.launch", 5)
            return orig(txn, on_commit)

        st.queue_transaction = armed
    events = []
    c.submit(c.pgt("obj").write(0, payload(8 * c.sw, seed=4)), 2, events, 1)
    c.pump()
    global_injector().clear()
    for st in c.stores:
        del st.queue_transaction
    assert events == [(1, "fail", -EIO)]
    assert device_guard().degraded
    assert c.logs() == logs
    assert any("sub-write on shard" in e for e in c.listeners[0].clog)
    assert dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fb0
    device_guard().configure(probe_interval_ms=1)
    time.sleep(0.01)
    assert device_guard().maybe_probe(lambda: None) is True
    assert c.state() == before
    data = payload(8 * c.sw, seed=5)
    c.submit(c.pgt("obj").write(0, data), 3, events, 2)
    c.pump()
    assert events[-1] == (2, "commit")
    assert c.read("obj", 0, len(data)) == data
    c.quiescent()


def _logical_state(c):
    """Every shard's objects (bytes, xattrs, omap), without the block
    image or the KV records: a store that failed a transaction keeps the
    blocks it allocated while staging until its next mount, so a shard
    that applies a write on its second try lays it out elsewhere."""
    return [
        {coll: {oid: (st.read(coll, oid), st.getattrs(coll, oid), st.omap_get(coll, oid))
                for oid in st.list_objects(coll)}
         for coll in st.list_collections()}
        for st in c.stores
    ]


@pytest.mark.parametrize("heal", ["at_fault", "later"])
@pytest.mark.parametrize("shard", [1, 3, 5])
@pytest.mark.parametrize("store", [{"csum_offload": True}, {"compression": "device"}],
                         ids=["csum", "compress"])
def test_partly_applied_sub_write_rolls_forward(store, shard, heal):
    """Fault C8 after some shards committed: only `shard`'s store fails
    its launch, so the shards before it in the fan-out hold the new
    version.  A second write to the object is already fanned out.  With
    the guard healed at once (`at_fault`), the shards after it commit
    both writes; `shard` is fenced against the second until the primary
    sends it the first again, so both roll forward in order.  Left
    DEGRADED (`later`), every later shard is refused too: nothing
    commits, the first write waits with its failed shards left out of
    reads, so a read returns a whole version or EIO, and once the probe
    heals the guard it commits.  The second write commits too (on the
    shards its data needed no launch, it may hold before the heal), or fails
    with EIO where it applied nowhere.  Either way the shards end equal
    to a cluster that took the committed writes without a fault, and no
    shard is left fenced."""
    c = Cluster("torch", overwrites=True, bluestore=store)
    control = Cluster("torch", overwrites=True, bluestore=store)
    old = payload(8 * c.sw, seed=3)
    writes = {1: (0, payload(8 * c.sw, seed=4)), 2: (c.sw + 100, payload(3 * c.sw, seed=6))}
    for cl in (c, control):
        cl.write("obj", 0, old)
    st = c.stores[shard]

    def armed(txn, on_commit=None, orig=st.queue_transaction):
        if not armed.fired:
            armed.fired = True
            global_injector().inject("codec.launch", EIO, 1)
            try:
                return orig(txn, on_commit)
            finally:
                assert device_guard().degraded
                if heal == "at_fault":
                    device_guard().mark_healthy()
        return orig(txn, on_commit)

    armed.fired = False
    st.queue_transaction = armed
    events = []
    try:
        for tag, (off, data) in writes.items():
            c.submit(c.pgt("obj").write(off, data), tag + 1, events, tag)
        c.pump()
        assert armed.fired
        if heal == "later":
            assert not any(e[1] == "commit" for e in events)
            assert device_guard().degraded
            first = c.primary.in_flight[min(c.primary.in_flight)]
            assert first.torn_shards == set(range(shard, 6))
            assert any("re-sending once the device" in e for e in c.listeners[0].clog)
            both = bytearray(writes[1][1])
            both[writes[2][0]:writes[2][0] + len(writes[2][1])] = writes[2][1]
            err, bufs = c.read_raw("obj", [(0, len(old))])
            assert err == -EIO or bufs[0] in (old, writes[1][1], bytes(both))
            device_guard().mark_healthy()
            c.pump()
    finally:
        global_injector().clear()
        device_guard().mark_healthy()
        del st.queue_transaction
    assert sorted(e[0] for e in events) == [1, 2]
    assert (1, "commit") in events
    if heal == "at_fault":
        assert (2, "commit") in events
    want = bytearray(old)
    ctl_events = []
    for tag, (off, data) in writes.items():
        if (tag, "commit") in events:
            control.submit(control.pgt("obj").write(off, data), tag + 1, ctl_events, tag)
            want[off:off + len(data)] = data
        else:
            assert (tag, "fail", -EIO) in events
    control.pump()
    assert sorted(ctl_events) == sorted(e for e in events if e[1] == "commit")
    assert c.read("obj", 0, len(old)) == bytes(want)
    assert _logical_state(c) == _logical_state(control)
    assert c.logs() == control.logs()
    assert c.primary.sub_write_retries >= 6 - shard if heal == "later" else 2
    assert not any(b._sub_write_fences for b in c.backends)
    c.quiescent()
