"""The port's stripe module, HashInfo and host crc32c on the CPU
(`device="cpu"`), held against the JAX package under JAX_PLATFORMS=cpu and
against the host oracles: `StripeInfo`'s offset algebra, `encode_launch`,
`encode` and `decode_concat_launch` (direct and through the aggregators),
HashInfo's append, verify and JSON bytes, and the C++ crc32c against the
table version and the reference's.  Every byte comparison is exact."""

import numpy as np
import pytest

from ceph_tpu.codec import registry as jregistry
from ceph_tpu.parallel import dispatch as jshard
from ceph_tpu.stripe import HashInfo as JHashInfo
from ceph_tpu.stripe import stripe as jstripe
from ceph_tpu.utils.crc32c import crc32c as jcrc32c

from ceph_tpu_torch.codec import registry
from ceph_tpu_torch.codec.matrix_codec import DecodeAggregator, EncodeAggregator
from ceph_tpu_torch.ops import dispatch
from ceph_tpu_torch.stripe import HashInfo
from ceph_tpu_torch.stripe import stripe
from ceph_tpu_torch.utils import crc32c as crc_mod

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _width_one():
    settings = jshard.settings()
    jshard.configure(devices=1)
    yield
    jshard.configure(*settings)


def _pair(k, m):
    profile = {"k": str(k), "m": str(m)}
    ours = registry.instance().factory("tpu", dict(profile), device="cpu")
    ref = jregistry.instance().factory("tpu", dict(profile))
    return ours, ref


@pytest.mark.parametrize("sw,cs", [(4 * 4096, 4096), (8 * 4096, 4096), (3 * 128, 128)])
def test_stripe_info_algebra_matches_reference(sw, cs):
    ours, ref = stripe.StripeInfo(sw, cs), jstripe.StripeInfo(sw, cs)
    assert (ours.k, ours.stripe_width, ours.chunk_size) == (ref.k, ref.stripe_width, ref.chunk_size)
    rng = np.random.default_rng(sw)
    for off in [0, 1, cs - 1, cs, sw - 1, sw, sw + 1, *rng.integers(0, 50 * sw, 40).tolist()]:
        for name in ("logical_to_prev_chunk_offset", "logical_to_next_chunk_offset",
                     "logical_to_prev_stripe_offset", "logical_to_next_stripe_offset",
                     "logical_to_chunk_position"):
            assert getattr(ours, name)(off) == getattr(ref, name)(off), (name, off)
        ln = int(rng.integers(0, 3 * sw))
        assert ours.offset_len_to_stripe_bounds(off, ln) == ref.offset_len_to_stripe_bounds(off, ln)
        a = off - off % sw
        assert ours.aligned_logical_offset_to_chunk_offset(a) == ref.aligned_logical_offset_to_chunk_offset(a)
        c = off - off % cs
        assert ours.aligned_chunk_offset_to_logical_offset(c) == ref.aligned_chunk_offset_to_logical_offset(c)


@pytest.mark.parametrize("k,m", [(4, 2), (8, 3)])
@pytest.mark.parametrize("route", ["direct", "aggregated"])
def test_encode_launch_matches_reference_and_oracle(k, m, route):
    ours, ref = _pair(k, m)
    sinfo, jsinfo = stripe.StripeInfo(k * 4096, 4096), jstripe.StripeInfo(k * 4096, 4096)
    data = np.random.default_rng(k).integers(0, 256, 3 * k * 4096, dtype=np.uint8).tobytes()
    agg = EncodeAggregator(window=4) if route == "aggregated" else None
    l0 = dispatch.LAUNCHES.snapshot()["launches"]
    pend = stripe.encode_launch(sinfo, ours, data, aggregator=agg)
    if agg is not None:
        assert not pend.launched() and not pend.ready()
        agg.flush()
    assert pend.launched() and pend.ready()
    got = pend.result()
    assert dispatch.LAUNCHES.snapshot()["launches"] == l0 + 1
    want = jstripe.encode(jsinfo, ref, data)
    assert sorted(got) == sorted(want) == list(range(k + m))
    for s in range(k + m):
        assert np.array_equal(got[s], np.asarray(want[s])), s
    shaped = np.frombuffer(data, np.uint8).reshape(3, k, 4096)
    oracle = ours.encode_array_host(shaped)
    for i in range(m):
        assert np.array_equal(got[k + i], oracle[:, i, :].reshape(-1))
    sub = stripe.encode(sinfo, ours, data, want={0, k})
    assert sorted(sub) == [0, k] and np.array_equal(sub[k], got[k])


@pytest.mark.parametrize("k,m,erasures", [(4, 2, (0,)), (4, 2, (1, 5)), (8, 3, (0, 9)),
                                          (8, 3, (0, 5, 10)), (8, 3, (9,))])
@pytest.mark.parametrize("route", ["direct", "aggregated"])
def test_decode_concat_launch_matches_reference_and_oracle(k, m, erasures, route):
    ours, ref = _pair(k, m)
    sinfo, jsinfo = stripe.StripeInfo(k * 4096, 4096), jstripe.StripeInfo(k * 4096, 4096)
    data = np.random.default_rng(sum(erasures)).integers(
        0, 256, 2 * k * 4096, dtype=np.uint8
    ).tobytes()
    shards = stripe.encode(sinfo, ours, data)
    have = {s: v for s, v in shards.items() if s not in erasures}
    # a read gathers the minimum shard set: drop survivors past k
    have = dict(sorted(have.items())[:k])
    agg = DecodeAggregator(window=4) if route == "aggregated" else None
    d0 = dispatch.DECODE_LAUNCHES.snapshot()["launches"]
    pend = stripe.decode_concat_launch(sinfo, ours, have, aggregator=agg)
    if agg is not None:
        agg.flush()
    got = pend.result()
    assert got.tobytes() == data
    want = jstripe.decode_concat(jsinfo, ref, have)
    assert np.array_equal(got, np.asarray(want))
    missing = [i for i in range(k + m) if i not in have]
    decodes = 1 if any(e < k for e in missing) else 0
    assert dispatch.DECODE_LAUNCHES.snapshot()["launches"] == d0 + decodes
    if decodes:
        idx = ours.decode_index(missing)
        surv = np.stack([np.asarray(have[i]).reshape(2, 4096) for i in idx], axis=1)
        rec = ours.decode_array_host(missing, surv)
        for p, e in enumerate(missing):
            assert np.array_equal(rec[:, p, :].reshape(-1), shards[e])


def test_hashinfo_append_verify_and_bytes_match_reference():
    rng = np.random.default_rng(5)
    ours, ref = HashInfo(6), JHashInfo(6)
    for step in range(3):
        ln = 4096 * (step + 1)
        appends = {s: rng.integers(0, 256, ln, dtype=np.uint8).tobytes() for s in range(6)}
        size = ours.get_total_chunk_size()
        ours.append(size, appends)
        ref.append(size, {s: np.frombuffer(v, np.uint8) for s, v in appends.items()})
        assert ours.encode() == ref.encode()
        assert ours.cumulative_shard_hashes == ref.cumulative_shard_hashes
    back = HashInfo.decode(ref.encode())
    assert back.encode() == ref.encode() and JHashInfo.decode(ours.encode()).encode() == ours.encode()
    chunk = rng.integers(0, 256, 4096, dtype=np.uint8).tobytes()
    h = HashInfo(2)
    h.append(0, {0: chunk, 1: chunk})
    assert h.verify_chunk(0, chunk) and h.verify_chunk(1, np.frombuffer(chunk, np.uint8))
    assert not h.verify_chunk(0, bytes([chunk[0] ^ 1]) + chunk[1:])


@pytest.mark.parametrize("length", [0, 1, 7, 4096, (1 << 20) + 3])
def test_crc32c_host_library_matches_table_and_reference(length):
    data = np.random.default_rng(length).integers(0, 256, length, dtype=np.uint8).tobytes()
    seed = HashInfo.SEED
    want = crc_mod._crc32c_py(seed, data)
    assert crc_mod.crc32c(data, seed) == want == jcrc32c(data, seed)
    assert crc_mod.crc32c(data) == crc_mod._crc32c_py(0, data) == jcrc32c(data)
    # chained: the digest of a split buffer continues from the first part's
    cut = length // 3
    first = crc_mod.crc32c(data[:cut], seed)
    assert crc_mod.crc32c(data[cut:], first) == want
    assert crc_mod.crc32c(np.frombuffer(data, np.uint8), seed) == want


def test_crc32c_library_lands_in_the_build_dir():
    lib = crc_mod.build_library()
    assert crc_mod.BUILD_DIR.name == "_build"
    assert any(p.name.startswith("libcrc32c_host_") for p in crc_mod.BUILD_DIR.iterdir())
    assert not any(p.name.startswith(".libcrc32c_host_") for p in crc_mod.BUILD_DIR.iterdir())
    assert crc_mod.hw_available() in (True, False) and lib is crc_mod.build_library()


# -- the device chunk cache branches and the RMW delta launch ----------------------------


def _cache_pair(max_bytes=1 << 20):
    from ceph_tpu.ops.device_cache import DeviceChunkCache as JCache

    from ceph_tpu_torch.ops.device_cache import DeviceChunkCache

    return DeviceChunkCache(max_bytes=max_bytes), JCache(max_bytes=max_bytes)


@pytest.mark.parametrize("k,m,stripes", [(4, 2, 1), (8, 3, 3)])
def test_encode_delta_launch_matches_reference_and_materialize(k, m, stripes):
    """With every shard of a region resident at the old generation, the
    delta launch's new parity equals the reference's delta, the
    materialize path's encode of the new bytes, and the host oracle; both
    caches end with the same counters (k puts, m replaces), and a miss
    returns None in both."""
    ours, ref = _pair(k, m)
    cs = 4096
    sinfo, jsinfo = stripe.StripeInfo(k * cs, cs), jstripe.StripeInfo(k * cs, cs)
    rng = np.random.default_rng(40 + k)
    old = rng.integers(0, 256, stripes * k * cs, dtype=np.uint8)
    new = rng.integers(0, 256, stripes * k * cs, dtype=np.uint8)
    old_shards = stripe.encode(sinfo, ours, old)
    cache, jcache = _cache_pair()
    for s in range(k + m):
        assert cache.put("o", s, 1, old_shards[s], off=cs, device="cpu")
        assert jcache.put("o", s, 1, old_shards[s], off=cs)
    assert stripe.encode_delta_launch(sinfo, ours, new, cache, "o", 9, 2, cs) is None
    assert jstripe.encode_delta_launch(jsinfo, ref, new, jcache, "o", 9, 2, cs) is None
    launches0 = dispatch.LAUNCHES.snapshot()["launches"]
    got = stripe.encode_delta_launch(sinfo, ours, new, cache, "o", 1, 2, cs).result()
    want = jstripe.encode_delta_launch(jsinfo, ref, new, jcache, "o", 1, 2, cs).result()
    assert dispatch.LAUNCHES.snapshot()["launches"] - launches0 == 1
    materialized = stripe.encode(sinfo, ours, new)
    oracle = ours.encode_array_host(new.reshape(stripes, k, cs))
    for s in range(k + m):
        assert np.array_equal(got[s], np.asarray(want[s])), s
        assert np.array_equal(got[s], materialized[s]), s
        if s >= k:
            assert np.array_equal(got[s], oracle[:, s - k].reshape(-1)), s
    assert cache.perf_dump() == jcache.perf_dump()
    assert cache.perf_dump()["delta_updates"] == m
    for s in range(k + m):
        assert bytes(cache.get("o", s, 2, off=cs).numpy()) == materialized[s].tobytes()


@pytest.mark.parametrize("lost", [[1], [0, 5]])
def test_decode_launches_consult_and_fill_the_cache(lost):
    """decode_concat_launch and decode_shards_launch with a cache: the first
    call misses, launches and caches every rebuilt row; the same call again
    is served from the cache with no launch.  Bytes and both caches'
    counters equal the reference's."""
    ours, ref = _pair(4, 2)
    cs = 4096
    sinfo, jsinfo = stripe.StripeInfo(4 * cs, cs), jstripe.StripeInfo(4 * cs, cs)
    data = np.random.default_rng(7).integers(0, 256, 2 * 4 * cs, dtype=np.uint8)
    shards = stripe.encode(sinfo, ours, data)
    have = {s: v for s, v in shards.items() if s not in lost}
    cache, jcache = _cache_pair()
    for rnd in range(2):
        dec0 = dispatch.DECODE_LAUNCHES.snapshot()["launches"]
        got = stripe.decode_concat_launch(sinfo, ours, have, chunk_cache=cache,
                                          cache_key=("o", 3), cache_off=0).result()
        want = jstripe.decode_concat_launch(jsinfo, ref, have, chunk_cache=jcache,
                                            cache_key=("o", 3), cache_off=0).result()
        assert got.tobytes() == np.asarray(want).tobytes() == data.tobytes()
        rebuilt = stripe.decode_shards_launch(sinfo, ours, have, set(lost), chunk_cache=cache,
                                              cache_key=("o", 3)).result()
        jrebuilt = jstripe.decode_shards_launch(jsinfo, ref, have, set(lost),
                                                chunk_cache=jcache, cache_key=("o", 3)).result()
        for s in lost:
            assert np.array_equal(rebuilt[s], shards[s])
            assert np.array_equal(rebuilt[s], np.asarray(jrebuilt[s]))
        assert cache.perf_dump() == jcache.perf_dump()
        launched = dispatch.DECODE_LAUNCHES.snapshot()["launches"] - dec0
        assert launched == (1 if rnd == 0 else 0)
    assert cache.perf_dump()["hits"] > 0 and cache.perf_dump()["served_bytes"] > 0
