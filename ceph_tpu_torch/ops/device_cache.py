"""Device-resident chunk cache — keep hot EC chunks in device memory.

The port of `ceph_tpu/ops/device_cache.py`.  A repeated degraded read (and
the read leg of a degraded RMW cycle — both flow through
``ECBackend.objects_read_and_reconstruct``) re-reconstructs the same
missing chunks launch after launch, paying the H2D staging of the whole
survivor batch every time.  This cache holds recently encoded/decoded
chunk buffers ON THE DEVICE, keyed by ``(object, shard, offset)`` with the
object's generation checked on every consult, so the next read of the
same (object, generation) serves the missing chunks with a single D2H
copy — no H2D, no kernel, no launch at all.  The RMW delta path
(stripe.encode_delta_launch) composes its one launch from these buffers.

Coherence model:

- ``generation`` is the object's version at put/get time (the producer
  passes it); a write bumps the version, so stale entries simply miss.
- Overwrites additionally ``invalidate_object`` eagerly at encode
  dispatch — the moment the bytes actually change — so dead bytes free
  immediately.  NOT at submit: the write's own RMW read leg runs between
  the two and reads exactly the committed pre-write bytes, so it may
  serve them from the cache (``ECBackend`` captures the pre-write
  generation at submit and threads it through the read).
- A DEGRADED backend transition (``ops/guard.py mark_degraded``) clears
  the cache and gates ``put``: a wedged runtime cannot be trusted to
  serve buffers.
- Keys are opaque to this module — ``ECBackend`` namespaces them with a
  never-reused per-backend token, so one process hosting many clusters
  (the test harnesses) can never cross-serve bytes.

What changes for CUDA: an entry is a ``torch.uint8`` tensor on the
putting backend's device.  ``put`` is an H2D ``copy_`` into a fresh
device buffer under the device guard's deadline; ``fetch_many`` copies
back with ``.cpu()``.  Every read and write of an entry runs on the
current CUDA stream (the cache adds no side stream), so launch order
orders them; a side stream would need ``record_stream`` on each entry.

Bounded by ``ec_tpu_device_cache_bytes`` (LRU by bytes); hit/miss/evict
counters export through ``ops/dispatch.perf_dump()`` as ``cache.*``.  A
served hit commits a ``cache_hit``-flagged flight record whose only span
is the D2H copy, so "skips H2D" is a visible property of the timeline.
"""

from __future__ import annotations

import time
from collections import OrderedDict

import numpy as np
import torch

from ..common.lockdep import make_lock
from ..common.mempool import ledger as _hbm_ledger


class _Entry:
    __slots__ = ("buf", "nbytes", "generation", "off", "mem")

    def __init__(self, buf, nbytes: int, generation, off: int, mem=None):
        self.buf = buf
        self.nbytes = int(nbytes)
        self.generation = generation
        self.off = int(off)
        # mempool ledger handle: one per resident entry, buffer-finalized
        # so a dropped cache instance cannot leak ledger bytes past its
        # buffers' death
        self.mem = mem


def _host_copy(buf: torch.Tensor) -> np.ndarray:
    """The entry's bytes as a host array the caller owns: `.cpu()` copies a
    device tensor; a CPU entry is cloned, so no caller aliases the cache."""
    host = buf.cpu()
    if host.data_ptr() == buf.data_ptr():
        host = host.clone()
    return host.numpy()


class DeviceChunkCache:
    """Bounded per-backend LRU of device-resident chunk buffers."""

    def __init__(self, max_bytes: int | None = None):
        if max_bytes is None:
            from ..common.options import OPTIONS

            max_bytes = int(OPTIONS["ec_tpu_device_cache_bytes"].default)
        self._lock = make_lock("device_cache")
        # (obj, shard, off) -> _Entry; generation checked on get so a
        # stale-generation entry is replaced in place by the next put
        self._entries: "OrderedDict[tuple, _Entry]" = OrderedDict()
        # obj -> {keys} index so the per-write invalidate_object hook is
        # O(entries-for-that-object), not a scan of the whole cache
        self._by_obj: dict[object, set[tuple]] = {}
        self._bytes = 0
        self.max_bytes = int(max_bytes)
        self.hits = 0
        self.misses = 0
        self.insertions = 0
        self.evictions = 0
        self.invalidations = 0
        self.served_bytes = 0
        self.put_failures = 0
        self.delta_updates = 0

    # -- configuration -------------------------------------------------------

    def configure(self, max_bytes: int | None = None) -> None:
        """Apply live config (`ec_tpu_device_cache_bytes`); shrinking
        evicts LRU-first, 0 disables and drops everything.

        `resident_bytes` is RECOMPUTED from the entry index before the
        eviction loop, not trusted from the decremented counter: a
        stale-low counter would leave the cache over the new cap forever."""
        if max_bytes is None:
            return
        with self._lock:
            self.max_bytes = int(max_bytes)
            self._bytes = sum(e.nbytes for e in self._entries.values())
            self._evict_to_fit_locked(0)

    @property
    def enabled(self) -> bool:
        return self.max_bytes > 0

    # -- producer side -------------------------------------------------------

    def put(self, obj, shard: int, generation, data, off: int = 0,
            device=None, strict: bool = False) -> bool:
        """Commit one chunk's bytes to the device and cache the buffer.
        ``data`` is host bytes/ndarray (flattened), copied into a fresh
        buffer on ``device``, or a uint8 tensor already on its device,
        cached as it is.  Refused (False) while the backend is DEGRADED,
        when the cache is off, or when the item alone exceeds the bound.

        A copy that wedges marks the backend DEGRADED (which clears this
        cache); any other error is counted on `put_failures`.  Either is a
        fault: with ``strict`` it raises, else the put returns False (a
        producer that only seeds the cache never fails for it)."""
        if not self.enabled or generation is None:
            return False
        from .guard import DeviceTimeout, device_guard

        if device_guard().degraded:
            return False
        if isinstance(data, torch.Tensor):
            arr, nbytes = None, int(data.nbytes)
        else:
            if isinstance(data, (bytes, bytearray, memoryview)):
                arr = np.frombuffer(data, dtype=np.uint8)
            else:
                arr = np.asarray(data, dtype=np.uint8).reshape(-1)
            nbytes = arr.nbytes
        if nbytes == 0 or nbytes > self.max_bytes:
            return False

        def _commit() -> torch.Tensor:
            if arr is None:
                return data.reshape(-1)
            from ..codec.base import resolve_device

            src = arr if arr.flags.c_contiguous and arr.flags.writeable else np.array(arr)
            buf = torch.empty(nbytes, dtype=torch.uint8, device=resolve_device(device))
            buf.copy_(torch.from_numpy(src))
            return buf

        try:
            # deadline-guarded like every other device wait: a wedged
            # runtime can hang the copy, and the producer sits on the
            # write or decode path
            buf = device_guard().call(_commit, what="cache put")
        except DeviceTimeout as e:
            device_guard().mark_degraded(f"cache put: {e}")
            if strict:
                raise
            return False
        except Exception:
            self.put_failures += 1
            if strict:
                raise
            return False
        self._insert(obj, shard, generation, buf, nbytes, off)
        return True

    def _insert(self, obj, shard: int, generation, buf, nbytes: int, off: int) -> None:
        with self._lock:
            key = (obj, int(shard), int(off))
            old = self._entries.pop(key, None)
            if old is not None:
                self._bytes -= old.nbytes
                self._by_obj[obj].discard(key)
                if old.mem is not None:
                    old.mem.free()
            self._evict_to_fit_locked(nbytes)
            self._entries[key] = _Entry(
                buf, nbytes, generation, off,
                mem=_hbm_ledger().alloc("device_cache", nbytes, buf=buf),
            )
            self._by_obj.setdefault(obj, set()).add(key)
            self._bytes += nbytes
            self.insertions += 1

    def _evict_lru_one_locked(self) -> int:
        """Evict the single LRU entry (counter + ledger + index
        bookkeeping in ONE place); returns its bytes."""
        key, entry = self._entries.popitem(last=False)
        self._bytes -= entry.nbytes
        if entry.mem is not None:
            entry.mem.free()
        keys = self._by_obj.get(key[0])
        if keys is not None:
            keys.discard(key)
            if not keys:
                del self._by_obj[key[0]]
        self.evictions += 1
        return entry.nbytes

    def _evict_to_fit_locked(self, incoming: int) -> None:
        while self._entries and self._bytes + incoming > self.max_bytes:
            self._evict_lru_one_locked()

    def trim_for_pressure(self, nbytes: int) -> int:
        """Evict LRU-first until at least `nbytes` were released (or the
        cache is empty); returns the bytes freed.  The mempool pressure
        layer's stage-1 action (common/mempool.py): cached chunks are
        rebuildable, the cheapest resident bytes to give back."""
        freed = 0
        with self._lock:
            while self._entries and freed < nbytes:
                freed += self._evict_lru_one_locked()
        return freed

    def replace(self, obj, shard: int, generation, buf, off: int = 0) -> bool:
        """Commit an ALREADY-DEVICE-RESIDENT buffer under a new generation
        — the RMW delta path's parity commit: the delta kernel's output
        never leaves the device, so there is no host array to ``put``;
        the generation bumps in place and only the ledger re-accounts.
        Counts on ``delta_updates``."""
        if not self.enabled or generation is None:
            return False
        from .guard import device_guard

        if device_guard().degraded:
            return False
        nbytes = int(buf.nbytes)
        if nbytes == 0 or nbytes > self.max_bytes:
            return False
        self._insert(obj, shard, generation, buf, nbytes, off)
        with self._lock:
            self.delta_updates += 1
        return True

    # -- consumer side -------------------------------------------------------

    def _lookup_locked(self, obj, shards, generation, off: int, length):
        """Every shard's live entry, or None (counting a miss for each)."""
        entries = []
        for s in shards:
            entry = self._entries.get((obj, int(s), int(off)))
            if (
                entry is None
                or entry.generation != generation
                or (length is not None and entry.nbytes < length)
            ):
                self.misses += len(shards)
                return None
            entries.append(entry)
        for s in shards:
            self._entries.move_to_end((obj, int(s), int(off)))
        return entries

    def get_resident_many(
        self, obj, shards, generation, off: int = 0,
        length: int | None = None,
    ) -> dict | None:
        """All-or-nothing consult returning the DEVICE buffers — no D2H,
        no flight record: the RMW delta read leg.  The caller composes
        these into ONE delta launch whose flight record shows h2d_s ==
        d2h_s == 0; a partial hit returns None (the materialize path
        re-encodes anyway).  The returned tensors stay valid even if a
        later put/replace supersedes their keys (they are refcounted)."""
        shards = list(shards)
        if not shards or not self.enabled:
            return None
        with self._lock:
            entries = self._lookup_locked(obj, shards, generation, off, length)
            if entries is None:
                return None
            self.hits += len(shards)
        return {int(s): e.buf for s, e in zip(shards, entries)}

    def get(self, obj, shard: int, generation, off: int = 0,
            length: int | None = None):
        """The cached device buffer for (obj, shard, generation, off), or
        None.  ``length`` (bytes) must fit inside the stored buffer."""
        with self._lock:
            entries = self._lookup_locked(obj, [shard], generation, off, length)
            if entries is None:
                return None
            self.hits += 1
            return entries[0].buf

    def fetch_many(
        self, obj, shards, generation, off: int = 0,
        length: int | None = None, kind: str = "decode", stripes: int = 0,
    ) -> dict[int, np.ndarray] | None:
        """Serve a whole missing-chunk set from the device, or None when
        ANY chunk misses (all-or-nothing: a partial hit still needs the
        decode launch).

        On a full hit the D2H copies are timed and committed as ONE
        ``cache_hit``-flagged flight record with h2d_s = kernel_s = 0 —
        the timeline proof that this path skipped the H2D leg."""
        shards = list(shards)
        if not shards or not self.enabled:
            return None
        with self._lock:
            entries = self._lookup_locked(obj, shards, generation, off, length)
            if entries is None:
                return None
        from .guard import device_guard

        def _copy_out():
            res: dict[int, np.ndarray] = {}
            n = 0
            for s, entry in zip(shards, entries):
                buf = entry.buf
                if length is not None and int(buf.numel()) > length:
                    buf = buf[:length]
                res[int(s)] = _host_copy(buf)
                n += res[int(s)].nbytes
            return res, n

        t0 = time.monotonic()
        try:
            # deadline-guarded like every other device wait: this consult
            # sits on the degraded-read path the guard exists to protect
            out, nbytes = device_guard().call(_copy_out, what="cache fetch")
        except Exception as e:
            # the D2H hung or failed: degrade (which clears this cache)
            # and report a MISS; the caller's decode launch is then
            # refused by the guard and fails its read with EIO
            device_guard().mark_degraded(f"cache fetch: {e}")
            with self._lock:
                self.misses += len(shards)
            return None
        d2h_s = time.monotonic() - t0
        with self._lock:
            self.hits += len(shards)
            self.served_bytes += nbytes
        self._record_hit(kind, stripes or len(shards), nbytes, d2h_s)
        return out

    @staticmethod
    def _record_hit(kind: str, stripes: int, nbytes: int, d2h_s: float) -> None:
        """Flight record for a cache-served read: no queue wait, no H2D,
        no kernel — only the D2H copy of the resident chunks."""
        from .flight_recorder import flight_recorder, new_record

        rec = new_record(kind, group="#cache", stripes=stripes,
                         batch=stripes, nbytes=nbytes)
        now = time.monotonic()
        rec["dispatch_ts"] = now - d2h_s
        rec["submit_ts"] = rec["dispatch_ts"]
        rec["complete_ts"] = rec["dispatch_ts"]
        rec["d2h_s"] = d2h_s
        rec["flags"]["cache_hit"] = True
        flight_recorder().commit(rec)

    # -- invalidation --------------------------------------------------------

    def invalidate_object(self, obj) -> int:
        """Drop every entry of one object (any shard/offset): the
        overwrite hook.  Returns how many entries died."""
        with self._lock:
            doomed = self._by_obj.pop(obj, None)
            if not doomed:
                return 0
            for key in doomed:
                entry = self._entries.pop(key)
                self._bytes -= entry.nbytes
                if entry.mem is not None:
                    entry.mem.free()
            self.invalidations += len(doomed)
            return len(doomed)

    def clear(self) -> None:
        """Drop everything (the DEGRADED-transition hook): buffers on a
        wedged runtime are unreachable."""
        with self._lock:
            self.invalidations += len(self._entries)
            for entry in self._entries.values():
                if entry.mem is not None:
                    entry.mem.free()
            self._entries.clear()
            self._by_obj.clear()
            self._bytes = 0

    # -- introspection -------------------------------------------------------

    def perf_dump(self) -> dict[str, int]:
        """JSON-safe counters for the `ec_dispatch.cache.*` slice.
        `resident_bytes`/`entries` are gauges (they fall on eviction and
        invalidation); the rest are monotonic counters."""
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "insertions": self.insertions,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "put_failures": self.put_failures,
                "delta_updates": self.delta_updates,
                "served_bytes": self.served_bytes,
                "resident_bytes": self._bytes,
                "entries": len(self._entries),
            }


_CACHE: DeviceChunkCache | None = None


def device_chunk_cache() -> DeviceChunkCache:
    """The process-wide cache (one device runtime per process), built
    lazily from the option default like the device guard and the default
    aggregators."""
    global _CACHE
    if _CACHE is None:
        _CACHE = DeviceChunkCache()
    return _CACHE
