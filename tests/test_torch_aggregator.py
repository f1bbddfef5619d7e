"""The port's EC aggregators, EncodePipeline and offload engine on the CPU
(`device="cpu"`), held against the JAX package's under JAX_PLATFORMS=cpu:
the same seeded submissions, reaped in the same (shuffled) order, give the
same bytes, launch counts, pad stripes, fused windows, flight-record flags
and perf dumps, and the plan cache the same hit/miss totals.  Then the
cases the reference's own tests name (tests/test_aggregator.py,
test_decode_aggregator.py, test_pipeline.py, test_verify_sched.py,
test_flight_recorder.py, test_mempool.py), each against the host oracles.
Every byte comparison is exact."""

import itertools
import threading
import time

import numpy as np
import pytest

from ceph_tpu.codec import matrix_codec as jmc
from ceph_tpu.codec import registry as jregistry
from ceph_tpu.ops import flight_recorder as jflight
from ceph_tpu.ops.device_cache import device_chunk_cache as j_device_chunk_cache
from ceph_tpu.parallel import dispatch as jshard

from ceph_tpu_torch.codec import matrix_codec as mc
from ceph_tpu_torch.codec import registry
from ceph_tpu_torch.codec.interface import EcError
from ceph_tpu_torch.codec.matrix_codec import (
    DecodeAggregator,
    EncodeAggregator,
    VerifyAggregator,
)
from ceph_tpu_torch.common.fault_injector import global_injector
from ceph_tpu_torch.common.mempool import ledger
from ceph_tpu_torch.ops import dispatch, flight_recorder, offload_runtime, swar_gf
from ceph_tpu_torch.ops import guard as guard_mod
from ceph_tpu_torch.ops.device_cache import device_chunk_cache
from ceph_tpu_torch.ops.guard import device_guard
from ceph_tpu_torch.ops.offload_runtime import DonationPool
from ceph_tpu_torch.ops.launch_scheduler import CLASS_BY_LANE, launch_scheduler

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

# flags the two packages agree on by construction; `overlap` says whether
# the device finished before its reaper arrived, which depends on timing
TIMING_FLAGS = ("overlap",)


@pytest.fixture(autouse=True)
def _clean_state():
    # the port dispatches on one device: hold the reference to width 1 too
    # (its tests run on a virtual 8-device CPU mesh, which would shard)
    settings = jshard.settings()
    jshard.configure(devices=1)
    # both packages' device chunk caches start empty, so no cache-served
    # record or eviction of an earlier test's entries lands in this one's
    caches = (j_device_chunk_cache(), device_chunk_cache())
    for cache in caches:
        cache.clear()
    flight_recorder.flight_recorder().reset()
    jflight.flight_recorder().reset()
    yield
    for cache in caches:
        cache.clear()
    jshard.configure(*settings)
    global_injector().clear()
    g = device_guard()
    g.mark_healthy()
    g.configure(timeout_ms=20000, probe_interval_ms=2000)
    flight_recorder.flight_recorder().reset()


def _pair(k, m, technique="reed_sol_van"):
    profile = {"k": str(k), "m": str(m), "technique": technique}
    ours = registry.instance().factory("tpu", dict(profile), device="cpu")
    ref = jregistry.instance().factory("tpu", dict(profile))
    return ours, ref


def _codec(k=4, m=2):
    return registry.instance().factory("tpu", {"k": str(k), "m": str(m)}, device="cpu")


def _batches(n, shape, seed, stripes=None):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        s = shape[0] if stripes is None else stripes[i % len(stripes)]
        out.append(rng.integers(0, 256, (s, *shape[1:]), dtype=np.uint8))
    return out


def _agg_records(fr):
    return [r for r in fr.records() if r["group"] != "#raw"]


def _record_view(r):
    return (r["kind"], r["tickets"], r["stripes"], r["batch"], r["pad_stripes"],
            r["fused_windows"], r["reason"], r["sched_class"], r["devices"],
            {k: v for k, v in r["flags"].items() if k not in TIMING_FLAGS})


def _codewords(ec, stripes, L, seed):
    data = np.random.default_rng(seed).integers(0, 256, (stripes, ec.k, L), dtype=np.uint8)
    return np.concatenate([data, ec.encode_array_host(data)], axis=1)


# -- the same submissions through both packages --------------------------------------

SCENARIOS = {
    "immediate": dict(window=0),
    "window": dict(window=4),
    "fused": dict(window=2, pipeline_depth=1, fuse_max_windows=4),
    "throttled": dict(window=3, inflight_max_bytes=5 * 4 * 4100),
    "buckets": dict(window=5, pad_buckets=2),
}


def _drive(mod, fr_mod, kind, ec, subs, reap_order, kw):
    """Submit `subs` to a fresh aggregator of `kind`, reap in `reap_order`,
    drain; return the tickets' bytes, the aggregator's perf dump and its
    flight records."""
    fr_mod.flight_recorder().reset()
    agg = getattr(mod, kind)(**kw)
    if kind == "DecodeAggregator":
        tickets = [agg.submit(ec, erasures, surv) for erasures, surv in subs]
    else:
        tickets = [agg.submit(ec, s) for s in subs]
    out = [None] * len(tickets)
    for i in reap_order:
        out[i] = np.asarray(tickets[i])
    agg.drain()
    return out, agg.perf.dump(), [_record_view(r) for r in _agg_records(fr_mod.flight_recorder())]


def _check_same(ours, ref):
    for a, b in zip(ours[0], ref[0]):
        assert a.dtype == np.uint8 and np.array_equal(a, np.asarray(b))
    assert ours[1] == ref[1]  # counters (launches, pad_stripes, fused_*) and histograms
    assert ours[2] == ref[2]


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
@pytest.mark.parametrize("k,m,L", [(4, 2, 4096), (8, 3, 4100)])
def test_encode_matches_reference(scenario, k, m, L):
    ours_ec, ref_ec = _pair(k, m)
    subs = _batches(12, (0, k, L), seed=k * L, stripes=[1, 3, 2, 3])
    order = list(np.random.default_rng(L).permutation(len(subs)))
    kw = dict(SCENARIOS[scenario])
    if "inflight_max_bytes" in kw:
        kw["inflight_max_bytes"] = 5 * k * L
    ours = _drive(mc, flight_recorder, "EncodeAggregator", ours_ec, subs, order, kw)
    ref = _drive(jmc, jflight, "EncodeAggregator", ref_ec, subs, order, kw)
    _check_same(ours, ref)
    for sub, got in zip(subs, ours[0]):
        assert np.array_equal(got, ours_ec.encode_array_host(sub))
    perf = ours[1]
    assert perf["submits"] == len(subs)
    if scenario == "fused":
        assert perf["fused_launches"] > 0
    if scenario == "throttled":
        assert perf["throttle_stalls"] > 0


@pytest.mark.parametrize("k,m,L", [(4, 2, 4100), (8, 3, 4096)])
def test_decode_matches_reference(k, m, L):
    ours_ec, ref_ec = _pair(k, m)
    rng = np.random.default_rng(k + L)
    patterns = [[1], [0, k], list(range(m))]
    subs = []
    for i in range(9):
        erasures = patterns[i % 3]
        cw = _codewords(ours_ec, int(rng.integers(1, 4)), L, seed=i)
        subs.append((erasures, cw[:, ours_ec.decode_index(erasures), :]))
    order = list(rng.permutation(len(subs)))
    kw = dict(window=3)
    ours = _drive(mc, flight_recorder, "DecodeAggregator", ours_ec, subs, order, kw)
    ref = _drive(jmc, jflight, "DecodeAggregator", ref_ec, subs, order, kw)
    _check_same(ours, ref)
    assert ours[1]["launches"] >= 3  # one group per pattern at least


def test_verify_matches_reference():
    ours_ec, ref_ec = _pair(8, 3)
    subs = []
    for i in range(7):
        cw = _codewords(ours_ec, 2, 4096, seed=50 + i)
        cw[i % 2, (3 * i) % 11, 17 * i] ^= 0x5A
        subs.append(cw)
    order = list(range(len(subs)))[::-1]
    kw = dict(window=64)
    ours = _drive(mc, flight_recorder, "VerifyAggregator", ours_ec, subs, order, kw)
    ref = _drive(jmc, jflight, "VerifyAggregator", ref_ec, subs, order, kw)
    _check_same(ours, ref)
    for sub, got in zip(subs, ours[0]):
        assert np.array_equal(got, ours_ec.verify_array_host(sub)) and got.any()
    assert ours[2][0][7] == "background"


def test_plan_cache_stats_match_reference(monkeypatch):
    """The same aggregated sequence on fresh plan caches counts the same
    coder-cache hits and misses in both packages."""
    ours_ec, ref_ec = _pair(4, 2)
    monkeypatch.setattr(mc, "PLAN_CACHE", mc._GlobalPlanCache())
    monkeypatch.setattr(jmc, "PLAN_CACHE", jmc._GlobalPlanCache())
    stats = []
    for mod, ec in ((mc, ours_ec), (jmc, ref_ec)):
        enc = mod.EncodeAggregator(window=2)
        dec = mod.DecodeAggregator(window=2)
        ver = mod.VerifyAggregator(window=2)
        tickets = []
        for i, L in enumerate((4100, 4096, 4100, 512)):
            cw = _codewords(ours_ec, 4, L, seed=i)
            tickets.append(enc.submit(ec, cw[:, :4]))
            tickets.append(dec.submit(ec, [0, 5], cw[:, ours_ec.decode_index([0, 5])]))
            tickets.append(ver.submit(ec, cw))
        for t in tickets:
            np.asarray(t)
        for agg in (enc, dec, ver):
            agg.drain()
        stats.append(mod.PLAN_CACHE.stats())
        mod.PLAN_CACHE.reset_stats()
        assert mod.PLAN_CACHE.stats() == {"hits": 0, "misses": 0}
    assert stats[0] == stats[1]
    assert stats[0]["hits"] > 0 and stats[0]["misses"] > 0


@pytest.mark.parametrize("k,m", [(4, 2), (8, 3)])
def test_encode_pipeline_matches_reference(k, m):
    ours_ec, ref_ec = _pair(k, m)
    obj = np.random.default_rng(k).integers(0, 256, k * 4096 * 3, dtype=np.uint8)
    done, parity = [], []
    for ec in (ours_ec, ref_ec):
        pipe = (mc if ec is ours_ec else jmc).EncodePipeline(ec, depth=2)
        stripes = []
        for s in range(6):
            chunks = ec.encode_prepare(obj[s * 1000 : s * 1000 + k * 2048])
            stripes.append(chunks)
            pipe.submit(chunks)
        reaped = pipe.poll() + pipe.flush()
        done.append(sorted(reaped))
        parity.append([np.concatenate([np.asarray(c[i]) for i in range(k, k + m)])
                       for c in stripes])
    assert done[0] == done[1] == list(range(1, 7))
    for a, b in zip(*parity):
        assert np.array_equal(a, b)


# -- EncodeAggregator semantics ------------------------------------------------------


class TestEncodeAggregator:
    def setup_method(self):
        self.ec = _codec(4, 2)

    def _want(self, data):
        return self.ec.encode_array_host(data)

    def test_window_trigger_and_pending(self):
        agg = EncodeAggregator(window=4)
        data = _batches(4, (1, 4, 4096), seed=1)
        tickets = [agg.submit(self.ec, d) for d in data[:3]]
        assert agg.pending() == 3
        assert not any(t.launched or t.is_ready() for t in tickets)
        tickets.append(agg.submit(self.ec, data[3]))
        assert agg.pending() == 0 and all(t.launched for t in tickets)
        assert agg.perf.get("flush_window") == 1
        for t, d in zip(tickets, data):
            assert t.is_ready() and np.array_equal(t.result(), self._want(d))

    def test_byte_budget_trigger(self):
        agg = EncodeAggregator(window=1000, max_bytes=3 * 4 * 4096)
        agg.submit(self.ec, _batches(1, (1, 4, 4096), seed=2)[0])
        assert agg.pending() == 1
        agg.submit(self.ec, _batches(1, (2, 4, 4096), seed=3)[0])
        assert agg.pending() == 0 and agg.perf.get("flush_bytes") == 1

    def test_reap_forces_launch(self):
        agg = EncodeAggregator(window=100)
        data = _batches(1, (2, 4, 4096), seed=4)[0]
        t = agg.submit(self.ec, data)
        assert not t.launched
        assert np.array_equal(np.asarray(t), self._want(data))
        assert agg.perf.get("flush_reap") == 1

    def test_interleaved_geometries_resolve_in_order(self):
        ec2 = _codec(8, 3)
        agg = EncodeAggregator(window=100)
        subs = []
        for i in range(6):
            ec, shape = (ec2, (1, 8, 4100)) if i % 2 else (self.ec, (2, 4, 4096))
            d = _batches(1, shape, seed=100 + i)[0]
            subs.append((ec, d, agg.submit(ec, d)))
        agg.flush()
        assert agg.perf.get("launches") == 2
        for ec, d, t in subs:
            assert np.array_equal(t.result(), ec.encode_array_host(d))

    def test_padding_to_pow2_sliced_back(self):
        agg = EncodeAggregator(window=100)
        data = _batches(1, (3, 4, 4096), seed=5)[0]
        t = agg.submit(self.ec, data)
        agg.flush()
        got = t.result()
        assert agg.perf.get("pad_stripes") == 1  # 3 -> 4
        assert got.shape == (3, 2, 4096) and np.array_equal(got, self._want(data))
        assert agg._pad_target(65) == 128 and agg._pad_target(260) == 320

    def test_donation_pool_recycled_across_launches(self):
        """At L = 4100 the launch runs the packed tier, which writes into a
        donated buffer: the second round reuses the first round's output,
        and no live buffer is ever handed out."""
        agg = EncodeAggregator(window=2)
        pipe0 = dispatch.PIPELINE.snapshot()
        assert self.ec.encode_donatable((4, 4, 4100))
        assert not self.ec.encode_donatable((4, 4, 4096))  # the SWAR tier ignores out=
        for seed in (10, 20):
            data = _batches(2, (2, 4, 4100), seed=seed)
            tickets = [agg.submit(self.ec, d) for d in data]
            agg.flush()
            for t, d in zip(tickets, data):
                assert np.array_equal(t.result(), self._want(d))
        assert list(agg._donate_pool) == [(4, 2, 4100)]
        pipe1 = dispatch.PIPELINE.snapshot()
        assert pipe1["donation_reuses"] > pipe0["donation_reuses"]
        assert pipe1["donation_recycled_live"] == pipe0["donation_recycled_live"]

    def test_single_ticket_unpadded_group_skips_pool(self):
        agg = EncodeAggregator(window=0)
        data = _batches(1, (4, 4, 4100), seed=7)[0]
        t = agg.submit(self.ec, data)
        assert np.array_equal(t.result(), self._want(data))
        assert not agg._donate_pool
        assert agg.perf.get("flush_immediate") == 1 and agg.perf.get("pad_stripes") == 0

    def test_failed_launch_is_sticky_and_reported_to_coriders(self):
        """A dispatch that raises fails the whole group: both riders' reaps
        raise EIO, nothing is recomputed on the host, and a device-side
        error (RuntimeError, as a CUDA error is) degrades the backend."""
        agg = EncodeAggregator(window=2)
        t1 = agg.submit(self.ec, _batches(1, (1, 4, 4096), seed=8)[0])

        def boom(*args, **kwargs):
            raise RuntimeError("injected device failure")

        self.ec.encode_array = boom
        try:
            t2 = agg.submit(self.ec, _batches(1, (1, 4, 4096), seed=9)[0])
        finally:
            del self.ec.encode_array
        for t in (t1, t2):
            assert t.is_ready()
            with pytest.raises(EcError, match="injected device failure"):
                t.result()
        rec = _agg_records(flight_recorder.flight_recorder())[-1]
        assert rec["flags"]["error"] and rec["flags"]["fallback"] is False
        assert device_guard().degraded and agg.perf.get("host_fallbacks") == 0

    def test_input_error_fails_the_launch_but_not_the_backend(self):
        agg = EncodeAggregator(window=0)

        def bad_geometry(*args, **kwargs):
            raise ValueError("bad geometry")

        self.ec.encode_array = bad_geometry
        try:
            t = agg.submit(self.ec, _batches(1, (1, 4, 4096), seed=8)[0])
        finally:
            del self.ec.encode_array
        with pytest.raises(EcError, match="bad geometry"):
            t.result()
        assert not device_guard().degraded


# -- DecodeAggregator ----------------------------------------------------------------


def _patterns(n, m):
    return [list(p) for r in range(1, m + 1) for p in itertools.combinations(range(n), r)]


@pytest.mark.parametrize("k,m", [(4, 2), (8, 3)])
def test_decode_every_erasure_pattern(k, m):
    """Every RS(4,2) and RS(8,3) erasure pattern through one windowed decode
    aggregator rebuilds the encoded bytes; each pattern is its own group."""
    ec = _codec(k, m)
    cw = _codewords(ec, 2, 4096, seed=k * 10 + m)
    agg = DecodeAggregator(window=10_000)
    pats = _patterns(k + m, m)
    tickets = [(p, agg.submit(ec, p, cw[:, ec.decode_index(p), :])) for p in pats]
    agg.flush()
    assert agg.perf.get("launches") == len(pats)
    for p, t in tickets:
        assert np.array_equal(t.result(), cw[:, p, :]), p


class TestDecodeAggregator:
    def setup_method(self):
        self.ec = _codec(4, 2)
        self.cw = _codewords(self.ec, 8, 4100, seed=11)

    def _submit(self, agg, lost, rows):
        return agg.submit(self.ec, lost, self.cw[rows][:, self.ec.decode_index(lost), :])

    def test_same_pattern_submitters_coalesce_into_one_dispatch(self):
        agg = DecodeAggregator(window=8)
        d0 = dispatch.DECODE_LAUNCHES.snapshot()["launches"]
        tickets = [self._submit(agg, [1], slice(i, i + 1)) for i in range(8)]
        for i, t in enumerate(tickets):
            assert np.array_equal(t.result(), self.cw[i : i + 1, [1], :])
        assert dispatch.DECODE_LAUNCHES.snapshot()["launches"] - d0 == 1

    def test_distinct_patterns_group_separately(self):
        agg = DecodeAggregator(window=100)
        a = self._submit(agg, [0], slice(0, 2))
        b = self._submit(agg, [2, 5], slice(2, 4))
        assert agg.pending() == 2 and len(agg._groups) == 2
        agg.flush()
        assert np.array_equal(a.result(), self.cw[0:2, [0], :])
        assert np.array_equal(b.result(), self.cw[2:4, [2, 5], :])

    def test_donated_output_reused_on_the_packed_tier(self):
        agg = DecodeAggregator(window=2)
        assert self.ec.decode_donatable([1], (4, 4, 4100))
        reuses0 = dispatch.PIPELINE.snapshot()["donation_reuses"]
        for rnd in range(2):
            tickets = [self._submit(agg, [1], slice(4 * rnd + 2 * i, 4 * rnd + 2 * i + 2))
                       for i in range(2)]
            for i, t in enumerate(tickets):
                rows = slice(4 * rnd + 2 * i, 4 * rnd + 2 * i + 2)
                assert np.array_equal(t.result(), self.cw[rows, [1], :])
        assert dispatch.PIPELINE.snapshot()["donation_reuses"] > reuses0


# -- VerifyAggregator ----------------------------------------------------------------


class TestVerifyAggregator:
    def test_scrub_chunk_in_one_launch_exact_at_every_position(self):
        ec = _codec(8, 3)
        agg = VerifyAggregator(window=64)
        cw = _codewords(ec, 4 * 12, 4096, seed=12)
        for j in range(11):
            cw[4 * j + (j % 4), j, 1000 + j] ^= 0x81
        v0 = dispatch.VERIFY_LAUNCHES.snapshot()["launches"]
        tickets = [agg.submit(ec, cw[4 * i : 4 * i + 4]) for i in range(12)]
        bitmaps = np.concatenate([np.asarray(t) for t in tickets])
        assert dispatch.VERIFY_LAUNCHES.snapshot()["launches"] - v0 == 1
        assert np.array_equal(bitmaps, ec.verify_array_host(cw))
        for j in range(11):
            assert bitmaps[4 * j + (j % 4)] != 0, j
        assert not bitmaps[44:].any()

    def test_fault_fails_the_verify_launch_then_heals(self):
        """An injected launch fault fails the scrub launch with EIO (no
        host bitmap stands in for it); once a probe heals the backend the
        same codewords give the exact bitmap."""
        ec = _codec(4, 2)
        agg = VerifyAggregator(window=4)
        cw = _codewords(ec, 3, 512, seed=9)
        cw[1, 2, 5] ^= 0x77
        v0 = dispatch.VERIFY_LAUNCHES.snapshot()["launches"]
        global_injector().inject("codec.launch", 5, hits=1)
        with pytest.raises(EcError, match="InjectedFailure"):
            np.asarray(agg.submit(ec, cw))
        assert device_guard().degraded and agg.perf.get("host_fallbacks") == 0
        assert dispatch.VERIFY_LAUNCHES.snapshot()["launches"] == v0
        assert device_guard().maybe_probe(lambda: None) is True
        got = np.asarray(agg.submit(ec, cw))
        assert np.array_equal(got, ec.verify_array_host(cw))
        assert got[1] and not got[0] and not got[2]
        assert dispatch.VERIFY_LAUNCHES.snapshot()["launches"] == v0 + 1


# -- the pipeline ring and donation pool --------------------------------------------


class TestPipelineRing:
    def test_inflight_bounded_and_depth_witnessed(self):
        ec = _codec()
        agg = EncodeAggregator(window=2, pipeline_depth=2)
        pipe0 = dispatch.PIPELINE.snapshot()
        data = _batches(8, (2, 4, 512), seed=0)
        tickets = [agg.submit(ec, d) for d in data]
        agg.flush()
        for t, d in zip(tickets, data):
            assert np.array_equal(np.asarray(t), ec.encode_array_host(d))
        assert dispatch.PIPELINE.snapshot()["drains"] > pipe0["drains"]
        recs = _agg_records(flight_recorder.flight_recorder())
        assert max(r["inflight_depth"] for r in recs) >= 2
        assert dispatch.PIPELINE.snapshot()["inflight_peak"] >= 2
        assert not agg._live

    def test_depth_zero_disables_ring(self):
        ec = _codec()
        agg = EncodeAggregator(window=2, pipeline_depth=0)
        drains = dispatch.PIPELINE.snapshot()["drains"]
        for t in [agg.submit(ec, d) for d in _batches(8, (2, 4, 512), seed=1)]:
            t.result()
        assert dispatch.PIPELINE.snapshot()["drains"] == drains

    def test_pool_cap_follows_pipeline_depth(self):
        agg = EncodeAggregator(window=2, pipeline_depth=2)
        assert agg._donate_pool.cap == 2
        agg.configure(pipeline_depth=1)
        assert agg._donate_pool.cap == 1 and dispatch.PIPELINE.snapshot()["depth"] == 1
        agg.configure(pipeline_depth=64)
        assert agg._donate_pool.cap == DonationPool.SLOT_CAP

    def test_wedged_launches_at_depth_pay_one_deadline(self, monkeypatch):
        """Every in-flight launch wedges after dispatch (its completion
        event never fires): the first reap pays the deadline, fails its
        launch and marks the backend DEGRADED; every other in-flight group
        sees degraded + not ready and fails at once.  No launch is
        recomputed on the host, and no live buffer is pooled."""
        release = threading.Event()

        class _WedgedEvent:
            def query(self):
                return False

            def synchronize(self):
                release.wait(10)

        monkeypatch.setattr(offload_runtime, "completion_event", lambda out: _WedgedEvent())
        ec = _codec()
        agg = EncodeAggregator(window=1, pipeline_depth=8)
        device_guard().configure(timeout_ms=200, probe_interval_ms=10_000_000)
        data = _batches(4, (2, 4, 512), seed=3)
        live0 = dispatch.PIPELINE.snapshot()["donation_recycled_live"]
        fb0 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
        try:
            tickets = [agg.submit(ec, d) for d in data]
            t0 = time.monotonic()
            for t in tickets:
                with pytest.raises(EcError):
                    t.result()
            elapsed = time.monotonic() - t0
        finally:
            release.set()
        assert elapsed < 2.0, elapsed
        assert device_guard().degraded
        recs = _agg_records(flight_recorder.flight_recorder())
        assert len(recs) == len(data)
        assert sum(r["flags"]["timeout"] for r in recs) == 1
        assert all(r["flags"]["error"] for r in recs)
        assert not any(r["flags"]["fallback"] for r in recs)
        assert dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fb0
        assert dispatch.PIPELINE.snapshot()["donation_recycled_live"] == live0


# -- guard drill, flight records ------------------------------------------------------


def test_guard_drill_eio_then_probe_heals():
    """`codec.launch` armed once: that launch fails with EIO and the
    backend goes DEGRADED; a launch while degraded (probe not due) is
    refused without reaching the device; after a probe heals it (the
    tests' probe_fn: the default probe needs CUDA), the next launch runs
    the device path again.  FALLBACK_LAUNCHES never moves."""
    ec = _codec()
    agg = EncodeAggregator(window=0)
    data = _batches(3, (2, 4, 4096), seed=13)
    fb0 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
    l0 = dispatch.LAUNCHES.snapshot()["launches"]
    device_guard().configure(probe_interval_ms=10_000_000)
    global_injector().inject("codec.launch", 5, hits=1)
    with pytest.raises(EcError, match="InjectedFailure"):
        agg.submit(ec, data[0]).result()
    assert dispatch.LAUNCHES.snapshot()["launches"] == l0
    assert device_guard().degraded and dispatch.perf_dump()["backend_degraded"] == 1
    rec = _agg_records(flight_recorder.flight_recorder())[-1]
    assert rec["flags"]["error"] and not rec["flags"]["fallback"]
    # the first probe of the episode is due at once: spend it on a failure
    assert device_guard().maybe_probe(_failing_probe) is False
    with pytest.raises(EcError, match="DeviceDegraded"):
        agg.submit(ec, data[1]).result()
    assert dispatch.LAUNCHES.snapshot()["launches"] == l0
    device_guard().configure(probe_interval_ms=1)
    time.sleep(0.01)  # the next probe is due
    assert device_guard().maybe_probe(lambda: None) is True
    assert np.array_equal(agg.submit(ec, data[2]).result(), ec.encode_array_host(data[2]))
    assert dispatch.LAUNCHES.snapshot()["launches"] == l0 + 1
    assert dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fb0
    assert agg.perf.get("host_fallbacks") == 0
    assert dispatch.perf_dump()["backend_degraded"] == 0


def _failing_probe():
    raise RuntimeError("probe: device still wedged")


def test_guard_timeout_flags_timeout_then_refuses():
    """A dispatch past its deadline fails with EIO, flags its record
    `timeout` and degrades the backend; the next launch's probe (the
    default one, which needs CUDA) fails, and that launch is refused."""
    ec = _codec()
    release = threading.Event()
    real = ec.encode_array

    def wedge(arr, out=None):
        release.wait(5)
        return real(arr, out=out)

    device_guard().configure(timeout_ms=100, probe_interval_ms=10_000_000)
    probe_failures0 = device_guard().snapshot()["probe_failures"]
    agg = EncodeAggregator(window=0)
    data = _batches(2, (1, 4, 4096), seed=14)
    ec.encode_array = wedge
    try:
        with pytest.raises(EcError, match="DeviceTimeout"):
            agg.submit(ec, data[0]).result()
        wedged = _agg_records(flight_recorder.flight_recorder())[-1]
        assert wedged["flags"]["timeout"] and wedged["flags"]["error"]
        assert device_guard().degraded
        with pytest.raises(EcError, match="DeviceDegraded"):
            agg.submit(ec, data[1]).result()
    finally:
        release.set()
        del ec.encode_array
    refused = _agg_records(flight_recorder.flight_recorder())[-1]
    assert refused["flags"]["error"] and not refused["flags"]["timeout"]
    assert not refused["flags"]["fallback"]
    assert device_guard().snapshot()["probe_failures"] == probe_failures0 + 1


def test_encode_record_has_queue_wait_and_subspans():
    ec = _codec()
    agg = EncodeAggregator(window=4)
    for t in [agg.submit(ec, d) for d in _batches(4, (2, 4, 512), seed=15)]:
        t.result()
    rec = _agg_records(flight_recorder.flight_recorder())[-1]
    assert (rec["tickets"], rec["stripes"], rec["batch"]) == (4, 8, 8)
    assert rec["reason"] == "flush_window" and rec["sched_class"] == "client"
    assert rec["settle_ts"] >= rec["dispatch_ts"] >= rec["submit_ts"]
    assert rec["h2d_s"] > 0.0 and rec["kernel_s"] >= 0.0 and rec["d2h_s"] >= 0.0
    assert not any(v for k, v in rec["flags"].items() if k not in TIMING_FLAGS)
    dump = dispatch.perf_dump()
    assert dump["device_busy_seconds"] > 0.0 and dump["flight_records"] >= 1


def test_sticky_error_settle_releases_hold(monkeypatch):
    led = ledger()
    ec = _codec()
    agg = EncodeAggregator(window=1, pipeline_depth=2)

    def broken_host(self, data):
        raise RuntimeError("host oracle down too")

    monkeypatch.setattr(type(ec), "encode_array_host", broken_host)
    global_injector().inject("codec.launch", 5, hits=1)
    t = agg.submit(ec, np.zeros((2, 4, 512), dtype=np.uint8))
    with pytest.raises(EcError):
        t.result()
    agg.drain()
    assert led.current_bytes("ec_pipeline_inflight") == 0
    assert _agg_records(flight_recorder.flight_recorder())[-1]["flags"]["error"]


# -- concurrency: 8 submitters, reconciliation; QoS order ---------------------------


def test_8_submitters_depth4_with_faults_reconcile(monkeypatch):
    """8 submitters at pipeline depth 4 with four launches faulted: the
    faulted launches' riders get EIO, the probe heals the backend (a no-op
    probe here: the default one needs CUDA), every other result is exact,
    and the ledger reconciles with nothing left in flight."""
    led = ledger()
    ec = _codec(4, 2)
    enc = EncodeAggregator(window=4, pipeline_depth=4)
    dec = DecodeAggregator(window=4, pipeline_depth=4)
    ver = VerifyAggregator(window=4, pipeline_depth=4)
    monkeypatch.setattr(guard_mod, "_default_probe", lambda: None)
    device_guard().configure(probe_interval_ms=1)
    global_injector().inject("codec.launch", 5, hits=4)
    errors, eio, done = [], [], []

    def submitter(tid):
        rng = np.random.default_rng(1000 + tid)
        try:
            for _ in range(3):
                data = rng.integers(0, 256, (4, 4, 4100), dtype=np.uint8)
                erasures = [int(rng.integers(0, 6))]
                try:
                    par = np.asarray(enc.submit(ec, data))
                    assert np.array_equal(par, ec.encode_array_host(data))
                    full = np.concatenate([data, par], axis=1)
                    rec = np.asarray(dec.submit(ec, erasures, full[:, ec.decode_index(erasures)]))
                    assert np.array_equal(rec, full[:, erasures, :])
                    assert not np.asarray(ver.submit(ec, full)).any()
                    done.append(tid)
                except EcError as e:
                    eio.append(e)
        except BaseException as e:  # surfaced after the join
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=60)
        assert not th.is_alive()
    global_injector().clear()
    for agg in (enc, dec, ver):
        agg.drain()
    assert not errors, errors
    assert eio and all(e.errno == -5 for e in eio)
    assert done and len(done) + len(eio) == 24
    assert sum(agg.perf.get("host_fallbacks") for agg in (enc, dec, ver)) == 0
    assert led.current_bytes("ec_pipeline_inflight") == led.current_bytes("verify") == 0
    assert not {k: v["drift"] for k, v in led.reconcile().items() if v["drift"]}


def test_queued_client_encode_leaves_ahead_of_queued_background_verify():
    ec = _codec(4, 2)
    enc = EncodeAggregator(window=0)
    ver = VerifyAggregator(window=0)
    sched = launch_scheduler()
    hold = threading.Event()
    holder = threading.Thread(
        target=sched.submit, args=(CLASS_BY_LANE["client"], lambda: hold.wait(10)))
    holder.start()
    deadline = time.monotonic() + 10
    while not sched._busy and time.monotonic() < deadline:
        time.sleep(0.001)
    cw = _codewords(ec, 2, 4096, seed=16)
    out = {}
    bg = threading.Thread(target=lambda: out.update(v=np.asarray(ver.submit(ec, cw))))
    bg.start()
    while sched.queue_depths()["background"] < 1 and time.monotonic() < deadline:
        time.sleep(0.001)
    fg = threading.Thread(target=lambda: out.update(e=np.asarray(enc.submit(ec, cw[:, :4]))))
    fg.start()
    while sched.queue_depths()["client"] < 1 and time.monotonic() < deadline:
        time.sleep(0.001)
    hold.set()
    for th in (holder, bg, fg):
        th.join(timeout=30)
        assert not th.is_alive()
    assert np.array_equal(out["e"], cw[:, 4:]) and not out["v"].any()
    recs = {r["kind"]: r for r in _agg_records(flight_recorder.flight_recorder())}
    assert recs["encode"]["dispatch_ts"] < recs["verify"]["dispatch_ts"]
    assert recs["verify"]["sched_class"] == "background"


def test_donatable_follows_the_coder_tier():
    """Donation is offered exactly where `_DeviceCoder` writes into `out=`
    (the packed tier); on the CPU no kernel launch is counted."""
    ec = _codec(8, 3)
    launches0 = swar_gf.launches
    for shape, tier in (((16, 8, 4096), "swar"), ((2, 8, 4100), "packed"),
                        ((1, 8, 4100), "xor_matmul")):
        assert mc._DeviceCoder.tier(shape) == tier
        assert ec.encode_donatable(shape) == (tier == "packed")
        assert ec.decode_donatable([0, 1], shape) == (tier == "packed")
        data = _batches(1, shape, seed=17)[0]
        out = np.asarray(EncodeAggregator(window=0).submit(ec, data))
        assert np.array_equal(out, ec.encode_array_host(data))
    assert swar_gf.launches == launches0
