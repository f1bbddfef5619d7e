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

Beside them, the offload runtime's gauges (ops/offload_runtime.py):
`FALLBACK_LAUNCHES` (launches completed on the host oracle, never counted
in `LAUNCHES`), `PIPELINE` (the depth-N in-flight ring and the donation
pool's reuse and recycled-live invariant), `PAD_WASTE` and `FUSED`;
`SHARDED_LAUNCHES` and `DEVICES_PER_LAUNCH` at width 1.  `perf_dump()`
flattens all of them, the device guard's state, the flight recorder's
utilization and the launch scheduler's lanes into the reference's
`ec_dispatch` keys.
"""

from __future__ import annotations

from ..common.lockdep import make_lock


class LaunchCounter:
    """Monotonic totals: device dispatches, stripes and bytes they carried."""

    __slots__ = ("_lock", "launches", "stripes", "bytes")

    def __init__(self) -> None:
        self._lock = make_lock("launch_counter")
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

# Multi-device dispatches, counted in the reference when a dispatch spans
# more than one device.  The port dispatches on one device (the stripe-
# axis split over several is ROADMAP A8), so this stays 0 and every
# launch lands on `devices_per_launch.1`; the counter keeps the
# reference's perf-dump keys.
SHARDED_LAUNCHES = LaunchCounter()


class DeviceOccupancy:
    """Devices-per-launch distribution: how wide each coding dispatch
    ran.  Exact per-count buckets (device counts are tiny integers, a
    log2 histogram would blur 6 vs 8 chips) plus a device-launch total so
    mean occupancy is derivable from two scalars."""

    __slots__ = ("_lock", "counts", "device_launches")

    def __init__(self) -> None:
        self._lock = make_lock("device_occupancy")
        self.counts: dict[int, int] = {}
        self.device_launches = 0  # sum(devices) over every dispatch

    def record(self, devices: int) -> None:
        with self._lock:
            self.counts[devices] = self.counts.get(devices, 0) + 1
            self.device_launches += devices

    def snapshot(self) -> dict[int, int]:
        with self._lock:
            return dict(self.counts)

    def reset(self) -> None:
        with self._lock:
            self.counts.clear()
            self.device_launches = 0


DEVICES_PER_LAUNCH = DeviceOccupancy()


class PipelineGauges:
    """Process-wide pipeline/donation accounting for the depth-N async
    launch ring (ops/offload_runtime.LaunchAggregator):

    - ``depth``: the configured ``ec_tpu_pipeline_depth`` (gauge),
    - ``inflight`` / ``inflight_peak``: launches dispatched but not yet
      settled, now and at peak,
    - ``drains``: ring-full settles (the submitter paid the oldest
      launch's wait so the new one could overlap it),
    - ``donation_reuses``: output buffers recycled from the donation
      pool into a later launch,
    - ``donation_recycled_live``: the INVARIANT counter — a pooled
      buffer handed out while its producing launch was still in flight.
      Must stay 0; the chaos pipelined-wedge phase asserts it.
    """

    __slots__ = ("_lock", "depth", "inflight", "inflight_peak", "drains",
                 "donation_reuses", "donation_recycled_live")

    def __init__(self) -> None:
        self._lock = make_lock("pipeline_gauges")
        self.depth = 0
        self.inflight = 0
        self.inflight_peak = 0
        self.drains = 0
        self.donation_reuses = 0
        self.donation_recycled_live = 0

    def set_depth(self, depth: int) -> None:
        with self._lock:
            self.depth = int(depth)

    def launch(self) -> None:
        with self._lock:
            self.inflight += 1
            self.inflight_peak = max(self.inflight_peak, self.inflight)

    def settle(self) -> None:
        with self._lock:
            self.inflight = max(0, self.inflight - 1)

    def record_drain(self) -> None:
        with self._lock:
            self.drains += 1

    def record_donation(self, reused: bool, live: bool = False) -> None:
        with self._lock:
            if reused:
                self.donation_reuses += 1
            if live:
                self.donation_recycled_live += 1

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return {
                "depth": self.depth,
                "inflight": self.inflight,
                "inflight_peak": self.inflight_peak,
                "drains": self.drains,
                "donation_reuses": self.donation_reuses,
                "donation_recycled_live": self.donation_recycled_live,
            }


PIPELINE = PipelineGauges()


class PaddingWaste:
    """Pad-stripe accounting for aggregated launches: every
    padded launch records its padded batch and how many of those stripes
    were zero padding, globally and per group label, so `perf dump` (and
    the bench) can show WHERE padding bytes go instead of only that the
    `pad_stripes` counter moved.  The per-label map is capped — group
    labels are bounded in practice (one per (matrix, chunk-size) key),
    but a pathological key churn must not grow the perf dump unboundedly."""

    LABEL_CAP = 32

    __slots__ = ("_lock", "padded_stripes", "pad_stripes", "_labels")

    def __init__(self) -> None:
        self._lock = make_lock("padding_waste")
        self.padded_stripes = 0  # stripes dispatched, padding included
        self.pad_stripes = 0  # of those, zero-pad stripes
        self._labels: dict[str, list[int]] = {}  # label -> [padded, pad]

    def record(self, label: str, padded: int, pad: int) -> None:
        with self._lock:
            self.padded_stripes += int(padded)
            self.pad_stripes += int(pad)
            slot = self._labels.get(label)
            if slot is None:
                if len(self._labels) >= self.LABEL_CAP:
                    return  # global totals still track the overflow
                slot = self._labels[label] = [0, 0]
            slot[0] += int(padded)
            slot[1] += int(pad)

    def ratio(self) -> float:
        with self._lock:
            if not self.padded_stripes:
                return 0.0
            return self.pad_stripes / self.padded_stripes

    def per_label(self) -> dict[str, float]:
        with self._lock:
            return {
                label: (pad / padded if padded else 0.0)
                for label, (padded, pad) in self._labels.items()
            }

    def reset(self) -> None:
        with self._lock:
            self.padded_stripes = 0
            self.pad_stripes = 0
            self._labels.clear()


PAD_WASTE = PaddingWaste()


def record_padding(label: str, padded: int, pad: int) -> None:
    """Record one padded aggregated launch: `padded` stripes dispatched
    (padding included) of which `pad` were zero padding, attributed to
    the group `label` (codec/matrix_codec._group_label)."""
    PAD_WASTE.record(label, padded, pad)


class FusedGauges:
    """Super-launch fusion totals: launches that carried more
    than one aggregation window's worth of tickets because the in-flight
    ring was full when their window tripped, and the windows they fused.
    Mirrors of the per-aggregator `fused_launches`/`fused_windows` perf
    counters, totalled process-wide for the dispatch perf dump."""

    __slots__ = ("_lock", "fused_launches", "fused_windows")

    def __init__(self) -> None:
        self._lock = make_lock("fused_gauges")
        self.fused_launches = 0
        self.fused_windows = 0

    def record(self, windows: int) -> None:
        with self._lock:
            self.fused_launches += 1
            self.fused_windows += int(windows)

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return {
                "fused_launches": self.fused_launches,
                "fused_windows": self.fused_windows,
            }

    def reset(self) -> None:
        with self._lock:
            self.fused_launches = 0
            self.fused_windows = 0


FUSED = FusedGauges()


def record_fused(windows: int) -> None:
    """Record one fused multi-window launch spanning `windows` windows."""
    FUSED.record(windows)


# The reference counts here the launches its device guard recomputed on
# the host oracle.  The port recomputes nothing on the host (a failed or
# refused launch raises EIO to its riders, ops/guard.py), so this counter
# stays 0: it is kept so perf_dump has the reference's keys.
FALLBACK_LAUNCHES = LaunchCounter()


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
    DECODE_LAUNCHES, `verify=True` (a verify plan) on VERIFY_LAUNCHES; it
    spans one device (the occupancy distribution's width 1).

    Flight recorder hook: a dispatch running under an aggregator launch
    annotates its kind onto the ACTIVE flight record; a dispatch with no
    active record (eager bulk paths, timing loops) appends a lightweight
    span-less record so the ring still shows it."""
    LAUNCHES.record(stripes, nbytes)
    if decode:
        DECODE_LAUNCHES.record(stripes, nbytes)
    if verify:
        VERIFY_LAUNCHES.record(stripes, nbytes)
    DEVICES_PER_LAUNCH.record(1)
    from .flight_recorder import flight_recorder

    fr = flight_recorder()
    rec = fr.active()
    kind = "verify" if verify else ("decode" if decode else "encode")
    if rec is not None:
        # skip records that already settled: an abandoned watchdog
        # worker whose device unwedges later still holds this record
        # through its contextvars copy, and a post-commit rewrite would
        # corrupt the ring under readers
        if not rec["settle_ts"] and (decode or verify):
            rec["kind"] = kind
    else:
        fr.record_raw(kind, stripes, nbytes)


def perf_dump() -> dict[str, object]:
    """JSON-safe export of every dispatch counter — the `ec_dispatch`
    section of the OSD's asok `perf dump` and (flattened) of the
    MMgrReport payload the mgr Prometheus scrape re-exports.  The
    devices-per-launch distribution rides as `devices_per_launch.<n>`
    scalars so the scrape renders one labeled-by-dot series per width."""
    out: dict[str, object] = {}
    for prefix, counter in (
        ("", LAUNCHES),
        ("decode_", DECODE_LAUNCHES),
        ("verify_", VERIFY_LAUNCHES),
        ("sharded_", SHARDED_LAUNCHES),
        ("fallback_", FALLBACK_LAUNCHES),
    ):
        for name, val in counter.snapshot().items():
            out[f"{prefix}{name}"] = val
    out["device_launches"] = DEVICES_PER_LAUNCH.device_launches
    for devices, launches in sorted(DEVICES_PER_LAUNCH.snapshot().items()):
        out[f"devices_per_launch.{devices}"] = launches
    # degraded-backend state (ops/guard.py): `backend_degraded` is the
    # gauge the prometheus scrape exports next to the fallback counters
    from .guard import device_guard

    snap = device_guard().snapshot()
    out["backend_degraded"] = snap["degraded"]
    out["backend_degraded_total"] = snap["degraded_total"]
    out["backend_probes"] = snap["probes"]
    out["backend_probe_failures"] = snap["probe_failures"]
    # device-utilization accounting derived from the flight recorder:
    # busy-seconds weighted by launch width, occupancy % of
    # the observation window, and the flight-ring health scalars.  The
    # OSD's MMgrReport re-exports the first two under their canonical
    # prometheus names (ceph_tpu_ec_device_busy_seconds /
    # ceph_tpu_ec_device_occupancy).
    from .flight_recorder import flight_recorder

    util = flight_recorder().utilization()
    out["device_busy_seconds"] = round(util["device_busy_seconds"], 6)
    out["device_occupancy"] = round(util["occupancy"], 6)
    out["flight_records"] = int(util["span_records"])
    out["flight_mean_queue_wait_ms"] = round(
        util["mean_queue_wait_s"] * 1e3, 3
    )
    # launch-scheduler QoS counters: per-class enqueue/dequeue
    # totals, accumulated queue wait, and the current queue-depth gauge,
    # as `sched.<class>.<counter>` scalars — the prometheus scrape
    # renders one labeled-by-dot series per class/counter pair
    from .launch_scheduler import launch_scheduler

    for name, val in launch_scheduler().perf_dump().items():
        out[f"sched.{name}"] = val
    # pipelined-dispatch ring + donation-pool invariants:
    # configured depth, current/peak in-flight launches, ring-full
    # drains, and the recycled-live invariant counter (must stay 0)
    for name, val in PIPELINE.snapshot().items():
        out[f"pipeline.{name}"] = val
    # super-launch fusion totals: launches carrying more than
    # one window's worth of tickets because the ring was full, and the
    # windows they fused — launches < submits/window proves amortization
    for name, val in FUSED.snapshot().items():
        out[name] = val
    # padding-waste accounting: the process-wide pad-stripe
    # fraction of everything dispatched padded, plus a per-group-label
    # slice (`pad_waste.<label>`) so asok/Perfetto show WHERE padding
    # bytes go — the bench proves the bucketed targets push the global
    # ratio below the pow2 baseline
    out["padding_waste_ratio"] = round(PAD_WASTE.ratio(), 6)
    for label, ratio in sorted(PAD_WASTE.per_label().items()):
        out[f"pad_waste.{label}"] = round(ratio, 6)
    # device-resident chunk cache: hit/miss/evict counters plus the
    # resident-bytes/entries gauges, as `cache.<counter>` scalars
    from .device_cache import device_chunk_cache

    for name, val in device_chunk_cache().perf_dump().items():
        out[f"cache.{name}"] = val
    return out
