"""The port's deep scrub (`ceph_tpu_torch/osd/scrubber.py`) on the CPU
(`device="cpu"`), held against the JAX package's under JAX_PLATFORMS=cpu.

Each package's `PgScrubber` runs over the same PG-shaped host: one host a
shard of the in-process cluster of tests/test_torch_ec_backend.py (one
ECBackend per OSD over a MemStore), whose `send_scrub`/`send_scrub_reply`
ride the cluster's message queue and whose `request_recovery` runs the
backend's `recover_object`.  The same seeded objects and the same damage
go through both packages; the ScrubResults, every message sent (the
MOSDRepScrub requests and the MOSDRepScrubMap maps with their base64
chunk bytes among them, by `tobytes()`), the stores after repair and the
cluster logs agree exactly.  Both packages run with the device chunk
cache and the RMW delta path at the reference's defaults, and the
reference at dispatch width 1.  The last test is the port's own policy: a
verify launch that fails aborts the deep scrub."""

import dataclasses
import importlib
import time
from types import SimpleNamespace

import numpy as np
import pytest

from ceph_tpu_torch.codec import matrix_codec
from ceph_tpu_torch.common.errs import EIO
from ceph_tpu_torch.common.fault_injector import global_injector
from ceph_tpu_torch.ops import dispatch
from ceph_tpu_torch.ops.guard import device_guard
from ceph_tpu_torch.osd import scrubber as t_scrubber

from test_torch_ec_backend import PKGS, ROOT, Cluster, _pin_reference  # noqa: F401 (autouse)
from test_torch_ec_backend import payload, set_cache_and_delta
from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)


def scrubber_module(pkg):
    return t_scrubber if pkg == "torch" else importlib.import_module(f"{ROOT[pkg]}.osd.scrubber")


class ScrubHost:
    """The PG-shaped host of one shard: exactly the attributes PgScrubber
    reads (see the port module's docstring)."""

    def __init__(self, cluster, osd):
        self.cluster = cluster
        self.osd_id = osd
        self.pgid = cluster.pgid
        self.osd = SimpleNamespace(store=cluster.stores[osd])
        self.backend = cluster.backends[osd]
        self.pool = cluster.pool
        self.peering = SimpleNamespace(osds_missing=self._osds_missing)
        self.clog = []
        self.recoveries = []
        self.scrubber = scrubber_module(cluster.pkg).PgScrubber(self)

    def _osds_missing(self, oid):
        return {self.cluster.acting[s] for s in self.cluster.missing.get(oid, set())}

    def whoami(self):
        return self.osd_id

    def whoami_shard(self):
        return self.osd_id

    def epoch(self):
        return 1

    def acting(self):
        return self.cluster.acting

    def _send(self, osd, msg):
        self.cluster.sent.append((osd, type(msg).__name__, msg.tobytes()))
        self.cluster.queue.append((osd, msg))

    send_scrub = _send
    send_scrub_reply = _send

    def clog_error(self, text):
        self.clog.append(text)

    def mark_shard_missing(self, oid, osd):
        self.cluster.missing.setdefault(oid, set()).add(self.cluster.acting.index(osd))

    def request_recovery(self, oid):
        missing = set(self.cluster.missing.get(oid, set()))

        def done(err):
            self.recoveries.append((oid, err))
            if err == 0:
                self.cluster.missing.pop(oid, None)

        self.backend.recover_object(oid, missing, done)


class ScrubCluster:
    """A cluster of one package with a scrub host on every OSD."""

    def __init__(self, pkg, k=4, m=2, **kw):
        set_cache_and_delta(True)
        self.c = Cluster(pkg, k=k, m=m, **kw)
        self.hosts = [ScrubHost(self.c, osd) for osd in range(k + m)]

    @property
    def primary(self):
        return self.hosts[0]

    def pump(self):
        c = self.c
        while True:
            for b in c.backends:
                b.flush_encodes()
            if not c.queue:
                return
            osd, msg = c.queue.pop(0)
            if c.backends[osd].handle_message(msg):
                continue
            name = type(msg).__name__
            if name == "MOSDRepScrub":
                self.hosts[osd].scrubber.handle_rep_scrub(msg)
            elif name == "MOSDRepScrubMap":
                self.hosts[osd].scrubber.handle_scrub_map(msg)
            else:
                raise AssertionError(f"undelivered {name}")

    def scrub(self, deep=True, repair=False, pump=True):
        out = []
        assert self.primary.scrubber.start(deep=deep, repair=repair, on_done=out.append)
        if pump:
            self.pump()
            assert len(out) == 1, "scrub did not finish"
        return out

    def write_objects(self, n, seed, stripes=(1, 3)):
        rng = np.random.default_rng(seed)
        oids = [f"obj.{i:03d}" for i in range(n)]
        for oid in oids:
            size = int(rng.integers(*stripes)) * self.c.sw - int(rng.integers(0, 2)) * 100
            self.c.write(oid, 0, rng.integers(0, 256, size, dtype=np.uint8).tobytes())
        return oids


def as_dict(res):
    return dataclasses.asdict(res)


def verify_launches(pkg):
    agg = (matrix_codec if pkg == "torch" else importlib.import_module(
        f"{ROOT[pkg]}.codec.matrix_codec")).default_verify_aggregator()
    return int(agg.perf.get("launches"))


def _flip(c, shard, oid, at):
    good = c.stores[shard].read(c.coll(shard), oid, 0, 0)
    c.stores[shard]._write(c.coll(shard), oid, at, bytes([good[at] ^ 0x5A]))
    return good


def test_clean_deep_scrub_over_two_chunks_matches_reference():
    """30 objects (more than CHUNK_MAX = 25) scrub in two chunks, each one
    verify launch; both packages report the same clean result over the
    same scrub maps and messages."""
    assert t_scrubber.CHUNK_MAX == scrubber_module("jax").CHUNK_MAX == 25
    got = {}
    for pkg in PKGS:
        sc = ScrubCluster(pkg)
        sc.write_objects(30, seed=1)
        sent0 = len(sc.c.sent)
        v0 = verify_launches(pkg)
        (res,) = sc.scrub()
        assert res.clean and res.objects_scrubbed == 30 and not res.unrepairable
        assert verify_launches(pkg) - v0 == 2
        maps = [raw for _o, name, raw in sc.c.sent[sent0:] if name == "MOSDRepScrubMap"]
        assert len(maps) == 2 * 6
        got[pkg] = (as_dict(res), sc.c.sent[sent0:], sc.primary.clog)
    assert got["torch"] == got["jax"]


def test_flipped_shard_is_caught_repaired_and_rescrubs_clean():
    """Flipped bytes in one shard's chunk fail its digest against hinfo;
    repair marks the shard missing and recover_object rebuilds it byte for
    byte; the rescrub is clean.  Results, messages (pushes included),
    stores and logs agree across the packages."""
    got = {}
    for pkg in PKGS:
        sc = ScrubCluster(pkg)
        oids = sc.write_objects(8, seed=2)
        victim = oids[3]
        good = _flip(sc.c, 2, victim, 17)
        (res,) = sc.scrub()
        assert not res.clean and res.errors == 1
        assert res.inconsistent == {victim: {2: "data digest mismatch vs hinfo"}}
        (fixed,) = sc.scrub(repair=True)
        assert fixed.repaired == 1 and not fixed.unrepairable
        assert sc.primary.recoveries == [(victim, 0)]
        assert sc.c.stores[2].read(sc.c.coll(2), victim, 0, 0) == good
        (again,) = sc.scrub()
        assert again.clean
        sc.c.quiescent()
        got[pkg] = ([as_dict(r) for r in (res, fixed, again)], sc.c.sent, sc.c.state(),
                    sc.primary.clog)
    assert got["torch"] == got["jax"]


def test_hinfo_consistent_corruption_is_caught_only_by_the_parity_verify():
    """A data shard corrupted with its hinfo rewritten to match passes the
    digest check; only the parity verify sees the broken equation.  The
    object is flagged on the parity rows and `unrepairable`, and repair
    refuses it."""
    got = {}
    for pkg in PKGS:
        sc = ScrubCluster(pkg)
        c = sc.c
        oids = sc.write_objects(6, seed=3)
        victim = oids[1]
        _flip(c, 1, victim, 5)
        hinfo_attr = c.m.ec_transaction.HINFO_ATTR
        hinfo = c.m.stripe.HashInfo.decode(c.stores[1].getattr(c.coll(1), victim, hinfo_attr))
        data = c.stores[1].read(c.coll(1), victim, 0, 0)
        crc = importlib.import_module(f"{ROOT[pkg]}.utils.crc32c").crc32c
        hinfo.cumulative_shard_hashes[1] = crc(data, c.m.stripe.HashInfo.SEED)
        c.stores[1]._setattr(c.coll(1), victim, hinfo_attr, hinfo.encode())
        (res,) = sc.scrub(repair=True)
        assert res.unrepairable == {victim} and res.repaired == 0
        assert set(res.inconsistent[victim]) == {4, 5}
        assert all("parity recompute mismatch" in why for why in res.inconsistent[victim].values())
        assert any("refusing auto-repair" in e for e in sc.primary.clog)
        assert sc.primary.recoveries == []
        got[pkg] = (as_dict(res), sc.c.sent, sc.primary.clog)
    assert got["torch"] == got["jax"]


def test_write_blocked_while_its_chunk_is_scrubbed():
    """While the first chunk's maps are gathered, a write to an object of
    that chunk is blocked and one past it is not; the waiting write runs
    when the chunk completes, and then commits."""
    got = {}
    for pkg in PKGS:
        sc = ScrubCluster(pkg)
        oids = sc.write_objects(27, seed=4)
        scrubber = sc.primary.scrubber
        out = sc.scrub(pump=False)
        assert scrubber.write_blocked(oids[0]) and scrubber.write_blocked(oids[24])
        assert not scrubber.write_blocked(oids[25])
        events = []
        patch = payload(sc.c.sw, seed=9)
        scrubber.waiting_writes.append(lambda: sc.c.submit(
            sc.c.pgt(oids[0], truncate=len(patch)).write(0, patch), 99, events, "w"))
        sc.pump()
        assert events == [("w", "commit")] and len(out) == 1 and out[0].clean
        assert not scrubber.active and not scrubber.write_blocked(oids[0])
        assert sc.c.read(oids[0], 0, len(patch)) == patch
        got[pkg] = (as_dict(out[0]), sc.c.sent)
    assert got["torch"] == got["jax"]


@pytest.mark.parametrize("stage", ["reap", "submit"])
def test_failed_verify_launch_aborts_the_deep_scrub(stage):
    """The port's policy: a verify launch that fails (`codec.launch` armed
    once: EIO at the reap) or a submit that raises ends the deep scrub
    `aborted`, with the error on the cluster log; it never reports clean,
    and the next deep scrub, once a probe heals the guard, is clean."""
    sc = ScrubCluster("torch")
    sc.write_objects(6, seed=5)
    fb0 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
    backend = sc.primary.backend
    if stage == "reap":
        device_guard().configure(probe_interval_ms=10_000_000)
        global_injector().inject("codec.launch", 5, hits=1)
    else:
        class Refusing:
            def submit(self, ec, codewords):
                raise RuntimeError("verify submit refused")

        real, backend.verify_aggregator = backend.verify_aggregator, Refusing()
    (res,) = sc.scrub()
    assert res.aborted and not res.clean and not sc.primary.scrubber.active
    assert any(f"parity verify {stage} failed" in e for e in sc.primary.clog)
    assert dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fb0
    if stage == "reap":
        assert device_guard().degraded
        assert any(f"errno {-EIO}" in e for e in sc.primary.clog)
        device_guard().configure(probe_interval_ms=1)
        time.sleep(0.01)
        assert device_guard().maybe_probe(lambda: None) is True
    else:
        backend.verify_aggregator = real
    (again,) = sc.scrub()
    assert again.clean and again.objects_scrubbed == 6
