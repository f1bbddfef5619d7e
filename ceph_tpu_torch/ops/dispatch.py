"""Device-launch accounting for the coding hot path.

The port of the counters of `ceph_tpu/ops/dispatch.py`.  Three counters,
each incremented once per coding dispatch by the lowest-level Python
wrapper of each coding path (`PackedPlan`, `PackedVerifyPlan`, the SWAR
`CodingPlan`, `_DeviceCoder`'s `xor_matmul` tier, `encode_array`'s
`xor_reduce` path, `encode_delta_device`): `LAUNCHES` totals every coding
dispatch, `DECODE_LAUNCHES` additionally the dispatches issued for a
decode, and `VERIFY_LAUNCHES` additionally the compare-only scrub
dispatches.  Tests hold batching invariants against them ("a whole scrub
chunk verified in one launch").

Counting happens when the wrapper is called, on the host: a counter is a
witness of the dispatch shape, not a profiler.  A kernel's own launches
are counted apart, by its wrapper (`ops/swar_gf.py::launches`,
`ops/packed_gf.py::launches`).
"""

from __future__ import annotations

import threading


class LaunchCounter:
    """Monotonic totals: device dispatches, stripes and bytes they carried."""

    __slots__ = ("_lock", "launches", "stripes", "bytes")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self.launches = 0
        self.stripes = 0
        self.bytes = 0

    def record(self, stripes: int, nbytes: int) -> None:
        with self._lock:
            self.launches += 1
            self.stripes += int(stripes)
            self.bytes += int(nbytes)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return {
                "launches": self.launches,
                "stripes": self.stripes,
                "bytes": self.bytes,
            }

    def reset(self) -> None:
        with self._lock:
            self.launches = 0
            self.stripes = 0
            self.bytes = 0


LAUNCHES = LaunchCounter()

# Decode dispatches (recovery, degraded reads): counted here AND in
# LAUNCHES, so LAUNCHES stays the total and this isolates the read half.
DECODE_LAUNCHES = LaunchCounter()

# Compare-only scrub dispatches (`PackedVerifyPlan`): counted here AND in
# LAUNCHES, like the decode counter.
VERIFY_LAUNCHES = LaunchCounter()


def lead_stripes(shape) -> int:
    """Stripes of a (..., rows, L) batch: the product of its lead dims."""
    n = 1
    for d in shape[:-2]:
        n *= int(d)
    return n


def record_launch(
    stripes: int, nbytes: int, decode: bool = False, verify: bool = False
) -> None:
    """Record one device dispatch carrying `stripes` stripes and `nbytes`
    input bytes.  `decode=True` (a decode-kind coder) also lands it on
    DECODE_LAUNCHES, `verify=True` (a verify plan) on VERIFY_LAUNCHES."""
    LAUNCHES.record(stripes, nbytes)
    if decode:
        DECODE_LAUNCHES.record(stripes, nbytes)
    if verify:
        VERIFY_LAUNCHES.record(stripes, nbytes)
