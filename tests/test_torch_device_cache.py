"""The port's device chunk cache (`ceph_tpu_torch/ops/device_cache.py`) on
CPU tensors, held against the JAX package's on JAX CPU arrays.

One seeded sequence of put, get, replace, get_resident_many, fetch_many,
invalidate, LRU eviction, pressure trim, a cap shrink and clear runs on a
cache of each package; after every step the two agree on what each call
returned (hits as bytes, misses as None), on `perf_dump` (hits, misses,
insertions, evictions, invalidations, delta updates, served and resident
bytes, entries) and on the bytes each package's mempool ledger holds in
its `device_cache` pool.  The DEGRADED transition clears the process-wide
cache and refuses puts in both packages, and the mempool pressure layer's
stage 1 trims the same bytes from both.  All byte-exact."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.common import mempool as jmempool
from ceph_tpu.ops import device_cache as jcache
from ceph_tpu.ops import flight_recorder as jflight
from ceph_tpu.ops import guard as jguard

from ceph_tpu_torch.common import mempool
from ceph_tpu_torch.ops import device_cache, flight_recorder, guard

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

CHUNK = 4096


@pytest.fixture(autouse=True)
def _healthy():
    saved = (jcache.device_chunk_cache().max_bytes, device_cache.device_chunk_cache().max_bytes)
    yield
    for g in (guard.device_guard(), jguard.device_guard()):
        g.mark_healthy()
    for cache, max_bytes in zip((jcache.device_chunk_cache(), device_cache.device_chunk_cache()),
                                saved):
        cache.clear()
        cache.configure(max_bytes=max_bytes)


class Pair:
    """One cache of each package; `do` runs a step on both and compares."""

    def __init__(self, max_bytes):
        self.ref = jcache.DeviceChunkCache(max_bytes=max_bytes)
        self.ours = device_cache.DeviceChunkCache(max_bytes=max_bytes)
        self.ledger0 = (jmempool.ledger().current_bytes("device_cache"),
                        mempool.ledger().current_bytes("device_cache"))

    @staticmethod
    def _norm(out):
        """Call results as comparable host values."""
        if isinstance(out, torch.Tensor):
            return bytes(out.numpy().tobytes())
        if hasattr(out, "__array__") and not isinstance(out, np.ndarray):
            return bytes(np.asarray(out).tobytes())
        if isinstance(out, np.ndarray):
            return bytes(out.tobytes())
        if isinstance(out, dict):
            return {k: Pair._norm(v) for k, v in out.items()}
        return out

    def do(self, name, *args, ref_args=None, **kw):
        got_ref = getattr(self.ref, name)(*(ref_args if ref_args is not None else args), **kw)
        got = getattr(self.ours, name)(*args, **({"device": "cpu"} if name == "put" else {}),
                                       **kw)
        assert self._norm(got) == self._norm(got_ref), name
        self.check()
        return got

    def check(self):
        ours, ref = self.ours.perf_dump(), self.ref.perf_dump()
        assert ours == ref
        held = (jmempool.ledger().current_bytes("device_cache") - self.ledger0[0],
                mempool.ledger().current_bytes("device_cache") - self.ledger0[1])
        assert held == (ref["resident_bytes"], ours["resident_bytes"])


GAUGES = ("resident_bytes", "entries")


def _moved(cache, base):
    """The process-wide cache's counters since `base`, and its gauges:
    earlier tests in the process ran it too."""
    return {k: v if k in GAUGES else v - base[k] for k, v in cache.perf_dump().items()}


def _chunks(seed, n, size=CHUNK):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size, dtype=np.uint8) for _ in range(n)]


def test_cache_sequence_matches_reference():
    p = Pair(max_bytes=10 * CHUNK)
    a = _chunks(1, 6)
    for s, c in enumerate(a[:4]):
        assert p.do("put", "A", s, 1, c)
    assert p.do("put", "A", 4, 1, a[4].tobytes(), off=CHUNK)  # bytes, another offset
    # hits and the three kinds of miss: generation, shard, length
    assert p.do("get", "A", 0, 1) is not None
    assert p.do("get", "A", 0, 2) is None
    assert p.do("get", "A", 9, 1) is None
    assert p.do("get", "A", 1, 1, length=CHUNK + 1) is None
    assert p.do("get", "A", 4, 1, off=CHUNK, length=CHUNK) is not None
    # the all-or-nothing consults
    res = p.do("get_resident_many", "A", [0, 1, 2], 1)
    assert sorted(res) == [0, 1, 2]
    assert p.do("get_resident_many", "A", [0, 5], 1) is None
    assert p.do("get_resident_many", "A", [], 1) is None
    # replace: an already-resident buffer under a new generation
    assert p.do("replace", "A", 3, 2, torch.from_numpy(a[5].copy()),
                ref_args=("A", 3, 2, jnp.asarray(a[5])))
    assert p.do("get", "A", 3, 2) is not None
    # fetch: host copies of the first `length` bytes, one cache_hit record
    fr_ours, fr_ref = flight_recorder.flight_recorder(), jflight.flight_recorder()
    fr_ours.reset()
    fr_ref.reset()
    got = p.do("fetch_many", "A", [0, 1], 1, length=CHUNK // 2, stripes=3)
    assert got[0].tobytes() == a[0][: CHUNK // 2].tobytes()
    got[0][:] = 0  # the caller owns its copy
    assert p.do("get", "A", 0, 1) is not None
    assert bytes(p.ours.get("A", 0, 1).numpy()) == a[0].tobytes()
    p.ref.get("A", 0, 1)
    p.check()
    (rec,) = fr_ours.records()
    (jrec,) = fr_ref.records()
    for key in ("kind", "group", "stripes", "batch", "bytes", "h2d_s", "kernel_s"):
        assert rec[key] == jrec[key], key
    assert rec["flags"] == jrec["flags"] and rec["flags"]["cache_hit"]
    assert p.do("fetch_many", "A", [0, 7], 1) is None
    # LRU eviction by bytes: object B pushes A's oldest entries out
    for s, c in enumerate(_chunks(2, 8)):
        assert p.do("put", "B", s, 5, c)
    assert p.ours.evictions > 0
    assert p.do("put", "C", 0, 1, np.zeros(11 * CHUNK, dtype=np.uint8)) is False  # too big
    assert p.do("put", "C", 0, None, a[0]) is False  # no generation
    assert p.do("invalidate_object", "B") > 0
    assert p.do("invalidate_object", "nothing") == 0
    for s, c in enumerate(_chunks(3, 5)):
        assert p.do("put", "D", s, 7, c)
    assert p.do("trim_for_pressure", CHUNK + 1) == 2 * CHUNK
    p.do("configure", max_bytes=2 * CHUNK)
    assert p.ours.perf_dump()["resident_bytes"] <= 2 * CHUNK
    p.do("configure", max_bytes=None)
    p.do("clear")
    assert p.ours.perf_dump()["entries"] == 0
    p.do("configure", max_bytes=0)
    assert p.do("put", "E", 0, 1, a[0]) is False
    assert p.do("fetch_many", "E", [0], 1) is None


def test_put_of_a_device_tensor_keeps_it_in_place():
    """A tensor already on its device is cached as it is (no copy): the
    delta path's new parity never leaves the device."""
    cache = device_cache.DeviceChunkCache(max_bytes=4 * CHUNK)
    t = torch.arange(CHUNK, dtype=torch.int32).to(torch.uint8)
    assert cache.put("X", 0, 1, t)
    assert cache.get("X", 0, 1).data_ptr() == t.data_ptr()
    host = np.arange(CHUNK, dtype=np.uint8)
    assert cache.put("X", 1, 1, host, device="cpu")
    assert cache.get("X", 1, 1).data_ptr() != host.ctypes.data


def test_degraded_clears_the_cache_and_refuses_puts():
    """Entering DEGRADED clears the process-wide cache in both packages
    (its ledger bytes too); puts are refused until the guard is healthy."""
    caches = (jcache.device_chunk_cache(), device_cache.device_chunk_cache())
    guards = (jguard.device_guard(), guard.device_guard())
    a = _chunks(4, 2)
    for cache in caches:
        cache.clear()
        cache.configure(max_bytes=8 * CHUNK)
    base = [cache.perf_dump() for cache in caches]
    led0 = mempool.ledger().current_bytes("device_cache")
    for i, c in enumerate(a):
        assert caches[0].put("P", i, 1, c)
        assert caches[1].put("P", i, 1, c, device="cpu")
    assert mempool.ledger().current_bytes("device_cache") - led0 == 2 * CHUNK
    for g in guards:
        g.mark_degraded("test")
    assert _moved(caches[0], base[0]) == _moved(caches[1], base[1])
    assert caches[1].perf_dump()["entries"] == 0
    assert mempool.ledger().current_bytes("device_cache") == led0
    assert caches[0].put("P", 0, 1, a[0]) is False
    assert caches[1].put("P", 0, 1, a[0], device="cpu") is False
    assert caches[1].replace("P", 0, 1, torch.from_numpy(a[0].copy())) is False
    for g in guards:
        g.mark_healthy()
    assert caches[1].put("P", 0, 1, a[0], device="cpu")
    assert caches[0].put("P", 0, 1, a[0])
    assert _moved(caches[0], base[0]) == _moved(caches[1], base[1])


def test_strict_put_raises_a_fault_and_counts_it():
    """A put whose copy fails counts on `put_failures`; the delta path's
    strict put raises it instead of returning False."""
    cache = device_cache.DeviceChunkCache(max_bytes=4 * CHUNK)
    with pytest.raises(ValueError):
        cache.put("Q", 0, 1, np.zeros(CHUNK, dtype=np.uint8), device="meta:0", strict=True)
    assert cache.put("Q", 0, 1, np.zeros(CHUNK, dtype=np.uint8), device="meta:0") is False
    assert cache.perf_dump()["put_failures"] == 2 and cache.perf_dump()["entries"] == 0


def test_pressure_stage_one_trims_the_cache_as_the_reference_does():
    """The mempool pressure layer's stage 1 trims the process-wide cache
    back toward the raise threshold: the same bytes in both packages, and
    the ledger's device_cache bytes fall."""
    caches = (jcache.device_chunk_cache(), device_cache.device_chunk_cache())
    statuses = []
    for cache, mod in zip(caches, (jmempool, mempool)):
        cache.clear()
        cache.configure(max_bytes=8 * CHUNK)
        base = cache.perf_dump()
        for i, c in enumerate(_chunks(5, 4)):
            if mod is mempool:
                assert cache.put("T", i, 1, c, device="cpu")
            else:
                assert cache.put("T", i, 1, c)
        gc.collect()  # close the books of earlier tests' dead buffers first
        before = mod.ledger().current_bytes("device_cache")
        led = mod.MempoolLedger(target_bytes=1000)
        h = led.alloc("ec_pipeline_inflight", 1100)
        status = led.check_pressure()
        h.free()
        assert mod.ledger().current_bytes("device_cache") == before - CHUNK
        statuses.append((status["actions"]["cache_trimmed_bytes"], _moved(cache, base)))
    assert statuses[0] == statuses[1]
    assert statuses[1][0] == CHUNK
