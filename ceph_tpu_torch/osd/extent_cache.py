"""ExtentCache — pins in-flight stripe extents for the EC RMW pipeline.

The port's copy of `ceph_tpu/osd/extent_cache.py`, whole.

Ceph: src/osd/ExtentCache.{h,cc} (invariants documented
at ExtentCache.h:30-90): while a partial-stripe overwrite is in flight, its
read-modify-write extents stay pinned so a subsequent overlapping write reads
the *pending* bytes from cache instead of re-reading stale shards — writes to
the same stripe pipeline instead of stalling.

Extents are per-object byte ranges of the *logical* (stripe-aligned) address
space.  Each write op holds a pin over the segments it inserted; pinned
segments overlay in insertion order (newest write wins), and releasing the
pin drops its segments.
"""

from __future__ import annotations


class _Segment:
    __slots__ = ("oid", "off", "data")

    def __init__(self, oid: str, off: int, data: bytes):
        self.oid = oid
        self.off = off
        self.data = bytes(data)


class Pin:
    """write_pin analog: the handle one in-flight write op holds."""

    def __init__(self) -> None:
        self.segments: list[_Segment] = []


class ExtentCache:
    def __init__(self) -> None:
        # oid -> segments in insertion (pipeline) order; later segments
        # overlay earlier ones where they overlap.
        self._data: dict[str, list[_Segment]] = {}

    def prepare_pin(self) -> Pin:
        return Pin()

    def present(self, oid: str, off: int, length: int) -> bytes | None:
        """Bytes for [off, off+length) if fully covered by pinned pending
        writes (overlaid newest-last), else None."""
        segs = self._data.get(oid)
        if not segs:
            return None
        out = bytearray(length)
        intervals: list[tuple[int, int]] = []
        end = off + length
        for seg in segs:  # insertion order: later writes overwrite earlier
            lo = max(off, seg.off)
            hi = min(end, seg.off + len(seg.data))
            if lo < hi:
                out[lo - off : hi - off] = seg.data[lo - seg.off : hi - seg.off]
                intervals.append((lo, hi))
        intervals.sort()
        cur = off
        for lo, hi in intervals:
            if lo > cur:
                return None  # gap
            cur = max(cur, hi)
        return bytes(out) if cur >= end else None

    def pin_extent(self, pin: Pin, oid: str, off: int, data: bytes) -> None:
        """Insert [off, off+len) pending bytes under this op's pin
        (ExtentCache::reserve_extents_for_rmw)."""
        seg = _Segment(oid, off, data)
        self._data.setdefault(oid, []).append(seg)
        pin.segments.append(seg)

    def release_pin(self, pin: Pin) -> None:
        """Write committed: this op's segments leave the cache
        (ExtentCache::release_write_pin)."""
        for seg in pin.segments:
            segs = self._data.get(seg.oid)
            if segs is None:
                continue
            try:
                segs.remove(seg)
            except ValueError:
                pass
            if not segs:
                del self._data[seg.oid]
        pin.segments.clear()

    def empty(self) -> bool:
        return not self._data
