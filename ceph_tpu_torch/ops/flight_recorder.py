"""Launch flight recorder — a bounded, lock-cheap ring of per-launch
records for the coding hot path.

The port's copy of `ceph_tpu/ops/flight_recorder.py`.  The launch
counters (ops/dispatch.py) answer "how many dispatches"; the perf
histograms answer "how were they distributed"; neither can show a
TIMELINE, and whether the next H2D runs under the current kernel is
invisible without per-launch spans.  Each record carries:

- identity: monotone ``seq``, ``kind`` (encode/decode/verify), the
  aggregator ``group`` key, ticket/stripe/batch/byte counts, the device
  count the dispatch spanned (annotated by ops/dispatch.record_launch);
- the timeline: ``submit_ts`` (first submission into the window),
  ``dispatch_ts``, ``settle_ts``, and derived spans — ``queue_wait_s``
  (submit→dispatch: time spent windowed), ``h2d_s`` (the synchronous
  part of the dispatch: the host→device copy of the batch, which blocks
  the host for pageable memory, plus the kernels' enqueue; NOT kernel
  time), ``kernel_s`` (how long the reaper blocked on the launch's CUDA
  event — 0 when the kernel finished under other work, i.e. perfect
  overlap), ``d2h_s`` (the device→host copy of the materialization);
- flags: ``sharded``, ``timeout`` (a DeviceGuard deadline fired),
  ``throttle_stall`` (a submitter hit the inflight-byte bound),
  ``error`` (sticky failure: a failed launch, or one refused while the
  backend is DEGRADED), ``overlap``, ``fused``; ``cache_hit`` and
  ``delta`` (the device chunk cache and the RMW delta path), and
  ``hedged`` (the decode's shard set includes a speculative hedged
  sub-read that beat a straggler, `hedged_hint`).  ``fallback`` and ``degraded_bypass`` mark
  the reference's host recomputes; the port has none (ops/guard.py),
  and they stay False.

Producers hold the record through a contextvar scope
(``active_scope``): ops/dispatch.py annotates devices/kind on the
record its dispatch runs under, and ops/guard.py flags deadline hits —
neither needs aggregator plumbing.  Dispatches with no active record
(eager bulk paths, bench loops) get a lightweight span-less record from
``record_launch`` so the ring still shows them.

The ring is a ``collections.deque(maxlen=...)``; a commit takes one
short lock to bank the utilization accumulators and append (the append
must share the lock with ``configure``'s deque swap), and readers
snapshot without blocking writers.  ``ops/dispatch.perf_dump()`` reads
the utilization scalars (``device_busy_seconds``, ``device_occupancy``),
and the OSD daemon's admin socket serves the records as ``dump_flight``
(osd/osd.py; ``reset: true`` rebases the ring and the utilization
window).
"""

from __future__ import annotations

import contextlib
import itertools
import time
from collections import deque

from ..common.lockdep import make_lock

DEFAULT_CAPACITY = 512

# the record the CURRENT dispatch runs under (a plain mutable dict):
# set by LaunchAggregator._launch around its guarded dispatch, read by
# ops/dispatch.record_launch and ops/guard.DeviceGuard.call.  A
# contextvar (not a thread-local) so the guard's watchdog worker —
# which runs the dispatch under contextvars.copy_context() — sees and
# mutates the SAME dict.
import contextvars

_ACTIVE: contextvars.ContextVar[dict | None] = contextvars.ContextVar(
    "flight_record", default=None
)

# hedge hint: set by ECBackend around a reconstruct whose shard set
# includes a winning hedged sub-read, read by new_record — the decode
# launch is created levels below (aggregator flush inside
# pend.result()), so a contextvar is the only plumbing-free channel.
_HEDGED: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "flight_hedged", default=False
)


@contextlib.contextmanager
def hedged_hint():
    """Mark flight records created inside this scope as ``hedged``."""
    token = _HEDGED.set(True)
    try:
        yield
    finally:
        _HEDGED.reset(token)


def new_record(
    kind: str,
    group: str = "",
    tickets: int = 1,
    stripes: int = 0,
    batch: int = 0,
    nbytes: int = 0,
    submit_ts: float | None = None,
    reason: str = "",
    sched_class: str = "",
) -> dict:
    """A fresh (uncommitted) flight record.  ``submit_ts`` is the FIRST
    submission into the launch's window (queue-wait anchors here);
    ``sched_class`` is the launch scheduler's QoS lane (client /
    recovery / background) — empty for dispatches that never
    passed through the scheduler (raw bench/bulk paths)."""
    now = time.monotonic()
    try:
        from ..common.mempool import ledger as _hbm_ledger

        hbm_bytes = _hbm_ledger().total_device_bytes()
    except ImportError:  # early-boot partial import: no ledger yet
        hbm_bytes = 0
    return {
        "seq": 0,  # assigned at commit
        "kind": kind,
        "group": group,
        "sched_class": sched_class,
        "tickets": int(tickets),
        "stripes": int(stripes),
        "batch": int(batch),
        "bytes": int(nbytes),
        "devices": 1,
        "reason": reason,
        "submit_ts": now if submit_ts is None else float(submit_ts),
        "dispatch_ts": 0.0,
        "settle_ts": 0.0,
        # when the device WORK finished (the blocking wait returned) —
        # the completion-ordered anchor async span attribution needs:
        # under pipelined dispatch wall-clock around the
        # now-nonblocking calls no longer brackets the kernel
        "complete_ts": 0.0,
        # how many launches were in flight (dispatched, unsettled) the
        # moment this one dispatched — the pipeline-depth witness
        "inflight_depth": 0,
        # ledger-tracked device bytes resident when this launch
        # dispatched: the memory level rides the same timeline as the
        # launches
        "hbm_bytes": hbm_bytes,
        "queue_wait_s": 0.0,
        "h2d_s": 0.0,
        "kernel_s": 0.0,
        "d2h_s": 0.0,
        # zero-pad stripes in `batch` (batch - stripes when the launch
        # padded to a bucket target): the per-launch waste the
        # ops/dispatch.py pad_waste slice aggregates
        "pad_stripes": 0,
        # aggregation windows fused into this launch: > 1
        # only on super-launches that stretched past their window while
        # the in-flight ring was full (the `fused` flag mirrors it)
        "fused_windows": 0,
        "flags": {
            "sharded": False,
            "fallback": False,
            "degraded_bypass": False,
            "timeout": False,
            "throttle_stall": False,
            "error": False,
            # the launch's device work had already completed when its
            # reaper arrived (zero blocking wait): the overlap the
            # pipeline exists to create, visible per launch
            "overlap": False,
            # served from the device-resident chunk cache: no H2D, no
            # kernel, only the D2H copy (ops/device_cache.py)
            "cache_hit": False,
            # a winning hedged sub-read fed this decode
            "hedged": _HEDGED.get(),
            # super-launch fusion: this launch carried more
            # than one aggregation window's worth of tickets
            "fused": False,
            # on-device RMW delta encode: parity updated in
            # HBM from cached operands — zero H2D, zero D2H
            "delta": False,
        },
    }


class FlightRecorder:
    """Process-wide bounded ring of completed launch records."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY):
        self._lock = make_lock("flight_recorder")
        self._ring: deque[dict] = deque(maxlen=max(1, int(capacity)))
        self._seq = itertools.count(1)
        # utilization epoch: busy-seconds accumulate from here; reset()
        # rebases it so occupancy is over the observed window, not
        # process lifetime
        self._epoch = time.monotonic()
        self._busy_s = 0.0          # sum of per-launch (h2d+kernel+d2h)
        self._device_busy_s = 0.0   # the same, weighted by device count
        self._queue_wait_s = 0.0    # sum of queue waits (span records)
        self._span_records = 0      # records that carried spans
        self._committed = 0         # records committed since reset
        self._fallbacks = 0         # cumulative, survives ring eviction

    # -- configuration ---------------------------------------------------------

    def configure(self, capacity: int | None = None) -> None:
        """Apply live config (`ec_tpu_flight_records`): resizing keeps
        the newest records, like OpTracker.resize_history."""
        if capacity is None:
            return
        with self._lock:
            self._ring = deque(self._ring, maxlen=max(1, int(capacity)))

    @property
    def capacity(self) -> int:
        return self._ring.maxlen or 0

    # -- producer side ---------------------------------------------------------

    @contextlib.contextmanager
    def active_scope(self, rec: dict | None):
        """Make `rec` the dispatch-context record: ops/dispatch.py and
        ops/guard.py annotate it without aggregator plumbing.  None is a
        no-op scope (callers with nothing to record keep one code path).
        """
        if rec is None:
            yield None
            return
        token = _ACTIVE.set(rec)
        try:
            yield rec
        finally:
            _ACTIVE.reset(token)

    @staticmethod
    def active() -> dict | None:
        return _ACTIVE.get()

    def annotate_active(self, **fields) -> None:
        """Merge scalar fields into the active record (no-op without
        one).  Flags go through `flag_active`."""
        rec = _ACTIVE.get()
        if rec is not None:
            rec.update(fields)

    def flag_active(self, name: str) -> None:
        rec = _ACTIVE.get()
        if rec is not None:
            rec["flags"][name] = True

    def commit(self, rec: dict) -> dict:
        """Finalize + append a record.  Derives the spans that follow
        from the timestamps, accumulates utilization, assigns the seq.
        Safe from any thread (deque append is atomic; the accumulator
        fields take the lock)."""
        now = time.monotonic()
        if not rec["dispatch_ts"]:
            rec["dispatch_ts"] = now
        if not rec["settle_ts"]:
            rec["settle_ts"] = now
        rec["queue_wait_s"] = max(0.0, rec["dispatch_ts"] - rec["submit_ts"])
        rec["seq"] = next(self._seq)
        busy = rec["h2d_s"] + rec["kernel_s"] + rec["d2h_s"]
        with self._lock:
            self._committed += 1
            if rec["flags"]["fallback"]:
                self._fallbacks += 1
            if busy or rec["flags"]["fallback"]:
                self._busy_s += busy
                self._device_busy_s += busy * max(1, rec["devices"])
                self._queue_wait_s += rec["queue_wait_s"]
                self._span_records += 1
            # append under the same lock: a concurrent configure()
            # resize swaps the deque, and an append landing on the
            # abandoned one would silently drop the record
            self._ring.append(rec)
        return rec

    def record_raw(self, kind: str, stripes: int, nbytes: int, devices: int = 1) -> None:
        """Lightweight span-less record for a dispatch that ran OUTSIDE
        an aggregator launch (eager bulk calls, timing loops): the ring
        still shows when it happened and how big it was.  `devices` > 1
        marks a launch sharded over that many cards."""
        rec = new_record(kind, group="#raw", stripes=stripes, batch=stripes,
                         nbytes=nbytes)
        rec["devices"] = max(1, int(devices))
        rec["flags"]["sharded"] = devices > 1
        rec["dispatch_ts"] = rec["submit_ts"]
        self.commit(rec)

    # -- consumer side ---------------------------------------------------------

    def records(self) -> list[dict]:
        """Snapshot, oldest first (deque iteration is atomic enough: a
        concurrent append may or may not be included, never torn)."""
        return list(self._ring)

    def utilization(self) -> dict[str, float]:
        """Busy-seconds and occupancy derived from the span-bearing
        records since the last reset.  `device_busy_seconds` weights
        each launch's busy span by the devices it spanned; `occupancy`
        is single-lane busy time over the observation window (a proxy
        for "was the device queue ever idle"), clamped to [0, 1]."""
        now = time.monotonic()
        with self._lock:
            window = max(1e-9, now - self._epoch)
            occupancy = min(1.0, self._busy_s / window)
            mean_wait = (
                self._queue_wait_s / self._span_records
                if self._span_records
                else 0.0
            )
            return {
                "busy_seconds": self._busy_s,
                "device_busy_seconds": self._device_busy_s,
                "window_seconds": window,
                "occupancy": occupancy,
                "mean_queue_wait_s": mean_wait,
                "span_records": self._span_records,
            }

    def summary(self) -> dict:
        """The compact blob a benchmark folds into its JSON (the
        reference's bench.py and chaos harness do): counts, mean queue
        wait, occupancy."""
        util = self.utilization()
        return {
            "records": len(self._ring),
            # both cumulative since reset: fallbacks counted at commit,
            # NOT by scanning the ring (evicted records would undercount
            # the numerator against the full-run launch denominator)
            "launches": self._committed,
            "fallbacks": self._fallbacks,
            "mean_queue_wait_ms": round(util["mean_queue_wait_s"] * 1e3, 3),
            "occupancy": round(util["occupancy"], 6),
            "device_busy_seconds": round(util["device_busy_seconds"], 6),
        }

    def dump(self) -> dict:
        """The asok `dump_flight` payload."""
        return {
            "capacity": self.capacity,
            "utilization": self.utilization(),
            "records": self.records(),
        }

    def reset(self) -> None:
        """Drop records and rebase the utilization window (tests; bench
        stages that want per-stage occupancy)."""
        with self._lock:
            self._ring.clear()
            self._epoch = time.monotonic()
            self._busy_s = 0.0
            self._device_busy_s = 0.0
            self._queue_wait_s = 0.0
            self._span_records = 0
            self._committed = 0
            self._fallbacks = 0


_RECORDER: FlightRecorder | None = None


def flight_recorder() -> FlightRecorder:
    """The process-wide recorder (lazy, like the device guard and the
    default aggregators; daemons with a live Config re-size it through
    their runtime observers)."""
    global _RECORDER
    if _RECORDER is None:
        _RECORDER = FlightRecorder()
    return _RECORDER
