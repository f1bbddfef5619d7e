"""Service-agnostic device-offload runtime.

The port of `ceph_tpu/ops/offload_runtime.py`, on CUDA events.  A "launch"
is any batched per-byte transform with a device plan (and a byte-identical
host oracle the tests hold it against); the engine aggregates them and fronts them with a small
service registry:

- **LaunchAggregator** (and its moving parts: AggTicket, DonationPool,
  _PadBuckets, _AggGroup) is the generic aggregation engine.  A service
  subclasses it and supplies the device dispatch (`_dispatch`), the
  output geometry (`_out_shape`) and the donation predicate
  (`_donate_ok`); the engine owns windowing, padding, pipelining,
  donation-pool recycling, QoS lane submission (SCHED_CLASS), the device
  guard and mempool accounting.
- **register_service / service_aggregator** is the registry: a service
  registers its aggregator factory, QoS lane and host-oracle
  description once; callers reach the shared process-wide instance by
  name.  The EC encode/decode/verify aggregators (codec/matrix_codec.py)
  are its entries, with the reference's perf names and knobs.
- **offload_perf_dump** flattens every registered service's aggregator
  counters into the `offload.*` slice of the reference's OSD perf
  report.

What changes for CUDA: the reference polls `is_ready()` on a jax array
and waits with `block_until_ready()`.  Here a `torch.cuda.Event` is
recorded right after a launch's dispatch, on the current stream of the
thread that enqueued its kernels (the guard runs the dispatch on a
watchdog thread, and torch's current stream belongs to the thread), and
the group keeps it: readiness is `event.query()`, the wait
`event.synchronize()`, and the materialization a `.cpu()` copy.  A CPU
tensor (the tests' `device="cpu"`) has no event: its dispatch computed
it synchronously.

Nothing here imports the codec package at module scope (the codec
imports THIS module); the one EC-flavored seam left is that a failed
launch surfaces as `EcError(EIO, ...)` at the reap, imported lazily —
every reap path catches exactly that type.
"""

from __future__ import annotations

import threading
import time
import weakref
from collections import OrderedDict

import numpy as np
import torch

from ..common.lockdep import make_lock as _lockdep_make_lock
from ..common.lockdep import make_rlock as _lockdep_make_rlock
from ..common.mempool import ledger as _hbm_ledger


def _next_pow2(n: int) -> int:
    return 1 << (max(1, n) - 1).bit_length()


def completion_event(out) -> "torch.cuda.Event | None":
    """A CUDA event recorded on the current stream of the calling thread,
    which must be the thread that just enqueued the kernels producing
    `out`: it fires when they are done.  None for anything that is not a
    CUDA tensor (a CPU tensor was computed when its dispatch returned)."""
    if not (isinstance(out, torch.Tensor) and out.is_cuda):
        return None
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(out.device))
    return event


class AggTicket:
    """One submitted stripe-batch coding launch awaiting aggregation.

    Resolves to this submission's (stripes, rows, L) output — parity for
    an encode submission, reconstructed chunks for a decode submission —
    as host numpy bytes: `is_ready()` for non-blocking polls (the group's
    CUDA event), `result()` / `__array__` for materialization
    (np.asarray on a ticket forces its group's launch and blocks until it
    finishes)."""

    __slots__ = ("_agg", "_group", "_start", "_stripes", "_value")

    def __init__(self, agg: "LaunchAggregator", group: "_AggGroup", start: int, stripes: int):
        self._agg = agg
        self._group = group
        self._start = start
        self._stripes = stripes
        self._value: np.ndarray | None = None

    @property
    def launched(self) -> bool:
        if self._value is not None:
            return True
        g = self._group
        return g.host is not None or g.parity is not None or g.error is not None

    def is_ready(self) -> bool:
        if self._value is not None:
            return True
        g = self._group
        if g.host is not None or g.error is not None:
            return True  # a failed launch is "ready": the reap reports it
        if g.parity is None:
            return False  # still windowed; a flush will launch it
        return True if g.event is None else bool(g.event.query())

    def result(self) -> np.ndarray:
        if self._value is None:
            self._agg._materialize(self)
        return self._value

    def __array__(self, dtype=None, copy=None):
        out = self.result()
        return out if dtype is None else out.astype(dtype)


class DonationPool:
    """Per-shape pool of dead device output buffers with per-buffer LIVE
    refcounts.  At pipeline depth > 1 several launches'
    outputs are in flight at once; a buffer becomes donatable only after
    ITS producing launch settles — `hold` marks an output live at
    dispatch, `release` at settle, and `take`/`put` refuse live buffers,
    counting any violation on the process-wide invariant gauge
    (`ec_dispatch.pipeline.donation_recycled_live`, asserted 0 by the
    chaos pipelined-wedge phase).  Callers serialize access under the
    aggregator-wide lock; the pool itself is not thread-safe."""

    # ceiling on settled buffers retained per shape: pipeline-depth
    # launches can settle close together, and one slot (the old
    # dict-per-shape pool) would drop all but the last.  The aggregator
    # syncs the effective `cap` to its ring depth — retaining more dead
    # buffers than launches that can be in flight would just pin HBM
    # (each pooled RS(8,3) output of a large launch is tens of MiB).
    SLOT_CAP = 4

    __slots__ = ("_free", "_live", "cap", "_mem")

    def __init__(self, cap: int | None = None) -> None:
        self._free: dict[tuple, list] = {}
        self._live: dict[int, int] = {}  # id(buf) -> refcount
        self.cap = self.SLOT_CAP if cap is None else max(1, int(cap))
        # HBM ledger handles per pooled FREE buffer: pooled
        # dead buffers are resident device memory nothing else accounts
        # for.  Handles are buffer-finalized too, so a pool dropped with
        # buffers still slotted cannot leak ledger bytes.
        self._mem: dict[int, object] = {}

    def hold(self, buf) -> None:
        self._live[id(buf)] = self._live.get(id(buf), 0) + 1

    def release(self, buf) -> None:
        key = id(buf)
        refs = self._live.get(key, 0) - 1
        if refs <= 0:
            self._live.pop(key, None)
        else:
            self._live[key] = refs

    def _mem_release(self, buf) -> int:
        """Close a pooled buffer's ledger handle; returns its bytes."""
        h = self._mem.pop(id(buf), None)
        if h is None:
            return 0
        nbytes = h.nbytes
        h.free()
        return nbytes

    def take(self, shape):
        from .dispatch import PIPELINE

        slot = self._free.get(tuple(shape))
        if not slot:
            return None
        buf = slot.pop()
        self._mem_release(buf)  # leaving the free list either way
        if id(buf) in self._live:
            PIPELINE.record_donation(reused=False, live=True)
            return None  # never hand out a live buffer
        PIPELINE.record_donation(reused=True)
        return buf

    def put(self, shape, buf) -> None:
        from .dispatch import PIPELINE

        if id(buf) in self._live:
            # pooling an unsettled launch's output would let a later
            # launch overwrite bytes a reaper still needs — refuse and
            # count the invariant violation
            PIPELINE.record_donation(reused=False, live=True)
            return
        led = _hbm_ledger()
        if led.donation_capped:
            # HBM pressure stage 2: retention capped — dead buffers go
            # back to the allocator instead of pinning device memory
            return
        slot = self._free.setdefault(tuple(shape), [])
        slot.append(buf)
        self._mem[id(buf)] = led.alloc(
            "ec_donation", int(getattr(buf, "nbytes", 0) or 0), buf=buf
        )
        while len(slot) > self.cap:
            # oldest out — also trims promptly after a runtime cap
            # shrink (a pipeline-depth config drop)
            self._mem_release(slot.pop(0))

    def drop_free(self) -> int:
        """Drop every FREE pooled buffer (HBM pressure stage 2);
        returns the bytes released.  Live refcounts are untouched —
        in-flight launches still settle normally."""
        freed = 0
        for slot in self._free.values():
            for buf in slot:
                freed += self._mem_release(buf)
        self._free.clear()
        return freed

    def drop_batch(self, batch: int) -> int:
        """Drop the FREE pooled buffers whose leading (batch) dimension
        is `batch` — shapes a retired pad bucket can no longer produce:
        when the bucket learner evicts a target, every
        pooled output at that geometry is dead weight, and bucket churn
        must not pin HBM in the mempool ledger.  Returns bytes freed;
        live refcounts are untouched."""
        freed = 0
        for shape in [s for s in self._free if s and s[0] == batch]:
            for buf in self._free.pop(shape):
                freed += self._mem_release(buf)
        return freed

    # mapping-ish view (tests and introspection): the shapes with at
    # least one FREE buffer pooled
    def __iter__(self):
        return iter([s for s, slot in self._free.items() if slot])

    def __len__(self) -> int:
        return sum(1 for slot in self._free.values() if slot)


class _PadBuckets:
    """Learned launch-size buckets for one (matrix, chunk-size) group
    key: replaces the static pow2/64-multiple `_pad_target`
    with a small set of batch sizes the key's workload actually
    produces.  A batch size seen `PROMOTE_AFTER` times becomes a bucket
    (padding a recurring 23-stripe launch to 32 wastes 28% of every
    launch forever; padding it to 23 wastes nothing and still recurs
    for the donation pool); the slot set is bounded
    and LRU-evicted so the geometry count stays capped, and
    the caller drops the evicted target's pooled output buffers
    (DonationPool.drop_batch).  A padding-waste EWMA per key feeds the
    `padding_waste_ratio` export.  Callers serialize access under the
    aggregator-wide lock."""

    PROMOTE_AFTER = 3
    EWMA_ALPHA = 0.2
    # candidate-count map bound: recurring sizes promote out of it long
    # before this; a never-repeating workload must not grow it unboundedly
    CANDIDATE_CAP = 64

    __slots__ = ("buckets", "_counts", "_lru", "_seq", "waste_ewma")

    def __init__(self) -> None:
        self.buckets: list[int] = []  # sorted learned batch targets
        self._counts: "OrderedDict[int, int]" = OrderedDict()
        self._lru: dict[int, int] = {}  # bucket -> last-use seq
        self._seq = 0
        self.waste_ewma = 0.0

    def target(self, stripes: int, static: int, cap: int) -> tuple[int, int | None]:
        """(pad target for `stripes`, evicted bucket or None).

        The smallest learned bucket >= `stripes` wins when it beats the
        static bucket; otherwise the static target stands.  Learning:
        `stripes` itself is promoted to a bucket once seen
        PROMOTE_AFTER times (exact fit = zero waste for the recurring
        size); past `cap` buckets the least-recently-used target is
        evicted and returned so the caller can drop its pooled buffers."""
        self._seq += 1
        evicted: int | None = None
        target = static
        for b in self.buckets:  # sorted: first fit is smallest
            if b >= stripes:
                if b < static:
                    target = b
                break
        if target in self._lru:
            self._lru[target] = self._seq
        if target != stripes and stripes not in self.buckets:
            # static padding is wasting stripes on this size: count it
            # toward promotion
            seen = self._counts.get(stripes, 0) + 1
            if seen >= self.PROMOTE_AFTER:
                self._counts.pop(stripes, None)
                self.buckets.append(stripes)
                self.buckets.sort()
                self._lru[stripes] = self._seq
                target = stripes
                if len(self.buckets) > max(1, cap):
                    evicted = min(self.buckets, key=lambda b: self._lru[b])
                    self.buckets.remove(evicted)
                    self._lru.pop(evicted, None)
                    if evicted == target:  # evicted ourselves: static stands
                        target = static
            else:
                self._counts[stripes] = seen
                self._counts.move_to_end(stripes)
                while len(self._counts) > self.CANDIDATE_CAP:
                    self._counts.popitem(last=False)
        waste = (target - stripes) / target if target else 0.0
        self.waste_ewma += self.EWMA_ALPHA * (waste - self.waste_ewma)
        return target, evicted


class _AggGroup:
    """Pending submissions sharing one (matrix, chunk-length) geometry —
    the unit that concatenates into a single padded device launch."""

    __slots__ = (
        "key", "ec", "ctx", "arrays", "tickets", "stripes", "nbytes",
        "parity", "host", "pad", "error", "donatable", "lock",
        "credit", "flight", "submit_ts", "stalled", "held",
        "mem", "fused_windows", "event",
    )

    def __init__(self, key, ec, ctx=None):
        self.key = key
        self.ec = ec
        self.ctx = ctx  # per-kind dispatch context (decode: erasure tuple)
        self.arrays: list[np.ndarray] = []
        self.tickets: list[AggTicket] = []
        self.stripes = 0
        self.nbytes = 0
        self.parity = None  # live device tensor once launched
        # CUDA event recorded right after the launch's dispatch, in the
        # thread that enqueued its kernels (None: a CPU tensor)
        self.event = None
        self.host: np.ndarray | None = None  # materialized parity
        self.pad = 0
        self.error: BaseException | None = None  # a failed launch, sticky
        self.donatable = False  # launch path can reuse a donated buffer
        # the in-flight launch's device output, refcounted in the
        # donation pool from dispatch until settle (pipeline depth > 1)
        self.held = None
        # HBM ledger handle for that in-flight output:
        # alloc'd at dispatch, freed at settle on every outcome —
        # sticky-error settles included
        self.mem = None
        self.credit = 0  # inflight-byte throttle credit held by this group
        # flight-recorder state: the launch's record, the
        # window-open timestamp queue-wait anchors on, and whether any
        # submitter hit the backpressure bound getting in
        self.flight: dict | None = None
        self.submit_ts = time.monotonic()
        self.stalled = False
        # super-launch fusion: > 0 once this group's window
        # trip was deferred because the in-flight ring was full — the
        # group keeps accumulating whole windows behind the backlog and
        # launches them fused (one dispatch, per-ticket settle slices)
        self.fused_windows = 0
        # serializes THIS group's launch/materialization (the encode
        # dispatch + blocking device wait) without stalling the
        # aggregator-wide lock; RLock because a reap-forced launch runs
        # inside the reap's own hold
        self.lock = threading.RLock()


class LaunchAggregator:
    """Cross-op launch aggregation: coalesce concurrent small stripe-batch
    coding calls (different ops, PGs, objects) into one padded device
    launch.  Shared machinery of the encode and decode aggregators; the
    subclasses supply the group key and the device dispatch.

    The storage-side analog of a training stack's bucketed all-reduce:
    per-op launches under ~1 MiB are dominated by dispatch overhead, so
    submissions queue in per-geometry groups and launch together when the
    window fills, the byte budget trips, or a barrier drains the window
    (ECBackend.flush_encodes / flush_decodes — or any ticket reap).
    window <= 1 launches every submission immediately (aggregation off,
    metrics still recorded).

    In aggregating mode, stripe counts are padded to a bounded bucket set
    (power of two up to 64, then multiples of 64 — capped waste, unlike
    pure pow2) so launches see few geometries and the donation pool
    can recycle output buffers across launches (see docs/PERFORMANCE.md
    for the donation caveats).  Tickets slice their own stripes back out,
    in submission order.

    Occupancy and launch-size distributions are PerfHistograms on
    `self.perf`, exportable through the prometheus layer
    (PerfCountersCollection.add(agg.perf))."""

    PERF_NAME = "ec_aggregator"
    WHAT = "encode"  # used in error reports
    # QoS lane every launch of this aggregator dispatches under (the
    # launch scheduler): client encodes preempt queued background work;
    # the decode/verify subclasses override with their own lane.
    SCHED_CLASS = "client"
    # mempool ledger pool this aggregator's in-flight launch outputs
    # charge; the verify subclass charges its own pool so the leak
    # gate can drain-check the EC data path and scrub independently.
    MEM_POOL = "ec_pipeline_inflight"

    def __init__(self, window: int = 0, max_bytes: int = 64 << 20,
                 pad_pow2: bool = True, inflight_max_bytes: int | None = None,
                 pipeline_depth: int | None = None,
                 fuse_max_windows: int | None = None,
                 pad_buckets: int | None = None):
        from ..common.perf_counters import PerfCountersBuilder
        from ..common.throttle import Throttle

        self.window = int(window)
        self.max_bytes = int(max_bytes)
        self.pad_pow2 = pad_pow2
        # depth-N asynchronous launch pipeline: how many
        # launched-but-unsettled groups may be in flight before a new
        # launch first settles the oldest — the settle happens AFTER the
        # new dispatch, so window N+1's H2D overlaps window N's kernel.
        # <= 0 disables the ring (in-flight bounded only by the byte
        # throttle, the behavior without a ring).
        if pipeline_depth is None:
            from ..common.options import OPTIONS

            pipeline_depth = int(OPTIONS["ec_tpu_pipeline_depth"].default)
        self.pipeline_depth = int(pipeline_depth)
        # super-launch fusion bound: with the in-flight ring
        # full, a group whose window trips may keep accumulating up to
        # this many windows and launch them as ONE fused dispatch —
        # amortizing dispatch overhead exactly when the backlog proves
        # demand.  <= 1 disables fusion (every window trip launches).
        if fuse_max_windows is None:
            from ..common.options import OPTIONS

            fuse_max_windows = int(OPTIONS["ec_tpu_fuse_max_windows"].default)
        self.fuse_max_windows = int(fuse_max_windows)
        # learned pad-bucket slots per group key: recurring
        # batch sizes promote to exact-fit launch targets, bounded and
        # LRU-evicted so the geometry count stays capped.  <= 0 keeps the
        # static pow2/64-multiple targets only.
        if pad_buckets is None:
            from ..common.options import OPTIONS

            pad_buckets = int(OPTIONS["ec_tpu_pad_buckets"].default)
        self.pad_buckets = int(pad_buckets)
        self._pad_state: dict[tuple, _PadBuckets] = {}
        from .dispatch import PIPELINE

        PIPELINE.set_depth(self.pipeline_depth)
        # RLock: a reap (`_materialize`) forces its group's launch from
        # inside the lock (make_rlock: per-instance reentrant, ordering
        # still validated on the outermost acquire)
        self._lock = _lockdep_make_rlock(self.PERF_NAME)
        self._groups: "OrderedDict[tuple, _AggGroup]" = OrderedDict()
        # per-shape retention follows the ring depth: more dead buffers
        # than launches that can be in flight would only pin HBM
        self._donate_pool = DonationPool(
            cap=min(DonationPool.SLOT_CAP, max(1, self.pipeline_depth))
        )
        # end-to-end backpressure (ec_tpu_inflight_max_bytes): byte credit
        # over everything admitted but not yet settled — windowed groups
        # AND launched-but-unreaped ones.  Over the bound, _admit makes
        # the SUBMITTER settle older launches first.
        if inflight_max_bytes is None:
            from ..common.options import OPTIONS

            inflight_max_bytes = int(OPTIONS["ec_tpu_inflight_max_bytes"].default)
        self.inflight = Throttle(
            f"{self.PERF_NAME}.inflight", int(inflight_max_bytes)
        )
        self._live: list[_AggGroup] = []  # launched, not yet settled (FIFO)
        b = PerfCountersBuilder(self.PERF_NAME)
        for c in ("submits", "launches", "flush_window", "flush_bytes",
                  "flush_explicit", "flush_immediate", "flush_reap",
                  # host_fallbacks: the reference's host recomputes;
                  # the port has none (ops/guard.py), so it reads 0
                  "flush_backpressure", "pad_stripes", "host_fallbacks",
                  "throttle_stalls", "fused_launches", "fused_windows"):
            b.add_u64_counter(c)
        b.add_histogram("stripes_per_launch",
                        "stripe-batch occupancy of each device launch",
                        lowest=1, buckets=14)
        b.add_histogram("tickets_per_launch",
                        "submissions coalesced into each device launch",
                        lowest=1, buckets=8)
        b.add_histogram("launch_bytes",
                        "input bytes per device launch",
                        lowest=4096, buckets=18)
        self.perf = b.create_perf_counters()
        # live-aggregator registry: HBM pressure's stage-2
        # trim and the leak-gate drain reach every instance through it
        _AGGREGATORS.add(self)

    def configure(self, window: int | None = None, max_bytes: int | None = None,
                  inflight_max_bytes: int | None = None,
                  pipeline_depth: int | None = None,
                  fuse_max_windows: int | None = None,
                  pad_buckets: int | None = None) -> None:
        """Apply live config (the OSD wires its Config + runtime observers
        here, so the aggregate_* settings reach the shared instance)."""
        if window is not None:
            self.window = int(window)
        if max_bytes is not None:
            self.max_bytes = int(max_bytes)
        if inflight_max_bytes is not None:
            self.inflight.limit = int(inflight_max_bytes)
        if fuse_max_windows is not None:
            self.fuse_max_windows = int(fuse_max_windows)
        if pad_buckets is not None:
            self.pad_buckets = int(pad_buckets)
            with self._lock:
                # shrinking the bucket bound must trim now-dead shapes:
                # retired targets' pooled outputs would pin HBM forever
                for state in self._pad_state.values():
                    while len(state.buckets) > max(1, self.pad_buckets):
                        gone = min(
                            state.buckets, key=lambda b: state._lru[b]
                        )
                        state.buckets.remove(gone)
                        state._lru.pop(gone, None)
                        self._donate_pool.drop_batch(gone)
                if self.pad_buckets <= 0:
                    for state in self._pad_state.values():
                        for b in state.buckets:
                            self._donate_pool.drop_batch(b)
                    self._pad_state.clear()
        if pipeline_depth is not None:
            self.pipeline_depth = int(pipeline_depth)
            with self._lock:
                self._donate_pool.cap = min(
                    DonationPool.SLOT_CAP, max(1, self.pipeline_depth)
                )
            from .dispatch import PIPELINE

            PIPELINE.set_depth(self.pipeline_depth)

    # -- subclass hooks ------------------------------------------------------

    def _dispatch(self, g: _AggGroup, data: np.ndarray, donate):
        raise NotImplementedError

    def _out_shape(self, g: _AggGroup, data_shape) -> tuple:
        raise NotImplementedError

    def _donate_ok(self, g: _AggGroup, data_shape) -> bool:
        raise NotImplementedError

    # -- submission ----------------------------------------------------------

    def _submit(self, key, ec, ctx, shaped: np.ndarray) -> AggTicket:
        """Queue one (stripes, k, L) uint8 batch under `key`; returns its
        ticket.  May launch (this or earlier submissions) when a threshold
        trips.  Admission is throttled: past ec_tpu_inflight_max_bytes of
        unsettled work, this call settles older launches first."""
        stripes = shaped.shape[0]
        # HBM pressure hook: time-throttled, no locks held —
        # under a target, sustained submission pressure trims the cache
        # / caps donation retention / clamps depth without waiting for
        # the next status beacon
        _hbm_ledger().maybe_check_pressure()
        stalled = self._admit(shaped.nbytes)
        reason = None
        with self._lock:
            self.perf.inc("submits")
            g = self._groups.get(key)
            if g is None:
                g = self._groups[key] = _AggGroup(key, ec, ctx)
            if stalled:
                g.stalled = True  # flight record flags the stall
            ticket = AggTicket(self, g, g.stripes, stripes)
            g.arrays.append(shaped)
            g.tickets.append(ticket)
            g.stripes += stripes
            g.nbytes += shaped.nbytes
            g.credit += shaped.nbytes
            if self.window <= 1:
                reason = "flush_immediate"
            elif g.nbytes >= self.max_bytes:
                reason = "flush_bytes"
            elif len(g.tickets) >= self.window:
                reason = "flush_window"
                # super-launch fusion: the window tripped but
                # the in-flight ring is full — launching now would only
                # queue a dispatch behind the backlog.  Defer the trip
                # (the group stays windowed, accumulating whole windows)
                # until the ring drains, the fuse bound or byte budget
                # trips, or a barrier/reap flushes: the deferred windows
                # then ride ONE fused dispatch, amortizing its overhead
                # exactly when demand is proven.  Per-ticket settle
                # slices, QoS arbitration, and the device guard
                # are untouched — a fused group is just a bigger group.
                if (
                    self.fuse_max_windows > 1
                    and self.pipeline_depth > 0
                    and len(self._live) >= self.pipeline_depth
                    and len(g.tickets) < self.window * self.fuse_max_windows
                    and g.nbytes < self.max_bytes
                ):
                    g.fused_windows = len(g.tickets) // self.window
                    reason = None
            if reason is not None:
                self._groups.pop(key, None)  # detach under the lock...
        if reason is not None:
            try:
                self._launch(g, reason)  # ...dispatch/compile outside it
            except Exception:
                # sticky on the group: every co-rider's reap reports it
                # (raising here would blame an arbitrary submitter and
                # tear down its unrelated write)
                pass
            # pipeline ring: AFTER the new launch dispatched,
            # settle down to the depth bound — the new window's H2D ran
            # before the oldest's blocking wait, which is the overlap
            self._drain_pipeline()
        return ticket

    def _drain_pipeline(self) -> None:
        """Bound the in-flight launch set at `ec_tpu_pipeline_depth` by
        settling the oldest launches.  Runs with NO locks held (a settle
        takes the victim group's lock; holding another group's lock here
        would deadlock two submitters draining each other)."""
        depth = self.pipeline_depth
        if depth <= 0:
            return
        if _hbm_ledger().depth_clamped:
            # HBM pressure stage 3: one launch's output in flight at a
            # time — overlap traded for bounded residency until relief
            depth = 1
        from .dispatch import PIPELINE

        while True:
            with self._lock:
                if len(self._live) <= depth:
                    return
                g = self._live[0]
            PIPELINE.record_drain()
            self._settle(g)
            with self._lock:
                if g in self._live:  # defensive: settle always removes
                    return

    def _admit(self, nbytes: int) -> bool:
        """Backpressure admission (the byte Throttle): take credit for a
        submission; over the bound, the SUBMITTER settles the oldest
        outstanding launches — paying the drain latency itself — until
        credit frees.  Pushing back on the producer is the point: a
        degraded/slow backend must stall its writers, not queue device
        work unboundedly.  A single submission larger than the whole
        bound is admitted once nothing older remains (the reference
        Throttle's oversized-request semantics: the dispatch path must
        not wedge).  Returns True when the submitter stalled (the flight
        record of the launch it rides flags `throttle_stall`)."""
        if self.inflight.get_or_fail(nbytes):
            return False
        self.perf.inc("throttle_stalls")
        while not self.inflight.get_or_fail(nbytes):
            if not self._settle_oldest():
                self.inflight.take(nbytes)  # oversized: admit anyway
                break
        return True

    def _settle_oldest(self) -> bool:
        """Settle one outstanding group, oldest first — launched groups
        before windowed ones (their credit frees on a blocking wait;
        windowed groups must be launched first).  False when nothing is
        outstanding."""
        with self._lock:
            if self._live:
                g = self._live[0]
            elif self._groups:
                g = next(iter(self._groups.values()))
            else:
                return False
        if g.parity is None and g.host is None and g.error is None:
            with self._lock:
                if self._groups.get(g.key) is g:
                    del self._groups[g.key]
            try:
                self._launch(g, "flush_backpressure")
            except Exception:
                pass  # sticky on the group; settle releases its credit
        self._settle(g)
        return True

    def pending(self) -> int:
        """Submissions queued but not yet launched."""
        with self._lock:
            return sum(len(g.tickets) for g in self._groups.values())

    def drain(self) -> None:
        """Settle EVERYTHING: flush the windowed groups, then settle
        every launched group oldest-first.  The HBM leak gate's
        teardown hook — after a drain the in-flight ledger pool must
        read zero (sticky errors settle too; they just stay sticky for
        their tickets' reaps)."""
        self.flush()
        while True:
            with self._lock:
                g = self._live[0] if self._live else None
            if g is None:
                return
            self._settle(g)

    def flush(self) -> None:
        """Launch every windowed group, FIFO (the commit barrier)."""
        with self._lock:
            detached = list(self._groups.values())
            self._groups.clear()
        for g in detached:
            try:
                self._launch(g, "flush_explicit")
            except Exception:
                continue  # sticky on the group; other groups still launch
        if detached:
            # a fused group deferred past a full ring launches
            # here — re-bound the in-flight set at the depth budget
            self._drain_pipeline()

    # -- launch + reap -------------------------------------------------------

    def _pad_target(self, stripes: int) -> int:
        """Launch-size bucket: pow2 up to 64 stripes, then multiples of 64.
        Bounds both the launch-geometry count AND the padding waste
        (pure pow2 would pad up to 2x on exactly the biggest launches the
        byte budget exists to bound)."""
        if stripes <= 64:
            return _next_pow2(stripes)
        return -(-stripes // 64) * 64

    def _pad_target_for(self, key, stripes: int) -> int:
        """Bucketed pad specialization: the static bucket,
        improved by the per-key learner when this key's workload keeps
        producing a batch size the static rounding wastes stripes on.
        Updates the key's waste EWMA and the process-wide pad_waste
        slice inputs; evicted bucket targets drop their pooled output
        buffers so bucket churn cannot pin HBM."""
        static = self._pad_target(stripes)
        if self.pad_buckets <= 0:
            return static
        with self._lock:
            state = self._pad_state.get(key)
            if state is None:
                state = self._pad_state[key] = _PadBuckets()
            target, evicted = state.target(stripes, static, self.pad_buckets)
            if evicted is not None:
                self._donate_pool.drop_batch(evicted)
        return target

    def padding_waste(self) -> dict[str, float]:
        """Per-key padding-waste EWMA snapshot (introspection/tests),
        keyed by the group label `_group_label` would give the key."""
        import zlib

        with self._lock:
            out = {}
            for key, state in self._pad_state.items():
                chunk = key[-1] if key and isinstance(key[-1], int) else 0
                digest = zlib.crc32(repr(key).encode())
                label = f"{self.PERF_NAME}/{digest:08x}/L{chunk}"
                out[label] = state.waste_ewma
            return out

    def _launch(self, g: _AggGroup, reason: str) -> None:
        """Concatenate a (detached) group's submissions into one padded
        device launch.  Runs OUTSIDE the aggregator-wide lock: the encode
        dispatch — including the synchronous H2D copy of the batch — must
        not stall other geometries' submits.  The group lock serializes against same-group reaps."""
        with g.lock:
            if g.parity is not None or g.host is not None or g.error is not None:
                return
            data = g.arrays[0] if len(g.arrays) == 1 else np.concatenate(g.arrays)
            # pad only in aggregating mode: with the window off, every
            # write would pay a concatenate copy + dead-stripe encode the
            # direct path never did
            pad = 0
            if self.pad_pow2 and self.window > 1:
                pad = self._pad_target_for(g.key, g.stripes) - g.stripes
            if pad:
                data = np.concatenate(
                    [data, np.zeros((pad, *data.shape[1:]), dtype=np.uint8)]
                )
            out_shape = self._out_shape(g, data.shape)
            # the donation pool only pays off when the coder's dispatch
            # will actually consume the donated buffer (the packed tier);
            # on the SWAR tier pooling would just hold dead device memory
            # an extra launch
            g.donatable = self._donate_ok(g, data.shape)
            donate = None
            if g.donatable:
                with self._lock:
                    donate = self._donate_pool.take(out_shape)
            # flight record: the launch's timeline entry.
            # queue_wait anchors on the group's window-open timestamp;
            # the guarded dispatch runs inside the record's scope so
            # ops/dispatch.py annotates devices and ops/guard.py flags
            # deadline hits on THIS record.
            from .flight_recorder import flight_recorder, new_record

            fr = flight_recorder()
            rec = g.flight = new_record(
                self.WHAT,
                group=self._group_label(g),
                tickets=len(g.tickets),
                stripes=g.stripes,
                batch=data.shape[0],
                nbytes=data.nbytes,
                submit_ts=g.submit_ts,
                reason=reason,
                sched_class=self.SCHED_CLASS,
            )
            rec["pad_stripes"] = pad
            # fused verdict: the deferral armed AND the group
            # actually accumulated more than one window before launching
            # (a reap right after the deferral is a plain launch)
            fused_windows = 0
            if g.fused_windows and self.window > 1:
                fused_windows = len(g.tickets) // self.window
            if fused_windows > 1:
                rec["flags"]["fused"] = True
                rec["fused_windows"] = fused_windows
            if g.stalled:
                rec["flags"]["throttle_stall"] = True
            # QoS arbitration: the ready launch enters the
            # shared device queue tagged with this aggregator's lane and
            # leaves it in dmClock tag order — a queued client encode
            # dequeues ahead of a queued background verify.  The
            # scheduler runs the dispatch under THIS context (captured
            # at submit), so the active flight record and tracer scope
            # survive even when another submitter's drain executes it.
            # Timing anchors live INSIDE the scheduled callable: time
            # spent queued behind other classes' launches (or spent
            # cooperatively executing them) is queue wait, not h2d —
            # banking it as busy would double-count wall clock across
            # concurrent records and overstate occupancy under exactly
            # the contention the scheduler creates.
            from .launch_scheduler import (
                CLASS_BY_LANE,
                launch_scheduler,
            )

            t_enqueue = time.monotonic()
            timing: dict[str, float] = {}

            def _dispatch_scheduled():
                timing["t_dispatch"] = time.monotonic()
                out = self._guarded_dispatch(g, data, donate)
                timing["t_done"] = time.monotonic()
                return out

            from .guard import DeviceDegraded, device_guard

            try:
                with fr.active_scope(rec):
                    # DEGRADED: at most a rate-limited probe, on the
                    # submitter's thread and outside the device turn;
                    # unhealed, the launch is refused without touching
                    # the device
                    guard = device_guard()
                    if not guard.maybe_probe():
                        raise DeviceDegraded(
                            f"device backend degraded: {guard.reason}"
                        )
                    parity = launch_scheduler().submit(
                        CLASS_BY_LANE[self.SCHED_CLASS],
                        _dispatch_scheduled,
                        cost=data.nbytes,
                    )
            except BaseException as e:
                # sticky: every co-rider's reap reports the launch failure
                # instead of crashing on a half-torn group.  The group
                # still enters the live list so its backpressure credit
                # releases at settle.
                # same dead-time rule as the success path, stricter: a
                # launch that RAISED (deadline wait, device error, a
                # refusal while DEGRADED, bad geometry) produced nothing
                # — none of its elapsed time banks as busy
                rec["dispatch_ts"] = timing.get("t_dispatch", t_enqueue)
                g.error = e
                g.pad = pad
                with self._lock:
                    self._live.append(g)
                    rec["inflight_depth"] = len(self._live)
                from .dispatch import PIPELINE

                PIPELINE.launch()
                raise
            # dispatch_ts anchors where the launch LEFT the queue and
            # actually began dispatching (queue-wait — window AND
            # scheduler — ends here); h2d_s is the synchronous slice of
            # the dispatch — the H2D copy of the batch (pageable memory:
            # it blocks the host) + the kernels' enqueue; kernel time
            # shows up at settle.
            t_dispatch = timing.get("t_dispatch", t_enqueue)
            rec["dispatch_ts"] = t_dispatch
            rec["h2d_s"] = max(
                0.0,
                timing.get("t_done", t_dispatch) - t_dispatch - rec["kernel_s"],
            )
            g.arrays = []
            g.pad = pad
            g.parity = parity
            # HBM ledger: the in-flight device output is
            # resident from this dispatch until settle.  The handle is
            # buffer-finalized too, so even an abandoned group cannot
            # leak ledger bytes past the output's death.
            if not isinstance(parity, np.ndarray):
                out_nbytes = int(getattr(parity, "nbytes", 0) or 0)
                if out_nbytes:
                    g.mem = _hbm_ledger().alloc(
                        self.MEM_POOL, out_nbytes, buf=parity
                    )
            rec["hbm_bytes"] = _hbm_ledger().total_device_bytes()
            # donation-pool refcount: the device output is
            # LIVE until this launch settles — at pipeline depth > 1 a
            # same-shape co-launch settling first must not recycle it
            if g.donatable and not isinstance(parity, np.ndarray):
                with self._lock:
                    self._donate_pool.hold(parity)
                    g.held = parity
            # inside g.lock, like the error path above: appending after
            # release races a reaper that settles (and _live-removes) the
            # group first, which would pin a settled group in _live
            with self._lock:
                self._live.append(g)
                rec["inflight_depth"] = len(self._live)
            from .dispatch import PIPELINE

            PIPELINE.launch()
        self.perf.inc("launches")
        self.perf.inc(reason)
        self.perf.inc("pad_stripes", pad)
        self.perf.hinc("stripes_per_launch", g.stripes)
        self.perf.hinc("tickets_per_launch", len(g.tickets))
        self.perf.hinc("launch_bytes", data.nbytes)
        if fused_windows > 1:
            self.perf.inc("fused_launches")
            self.perf.inc("fused_windows", fused_windows)
            from .dispatch import record_fused

            record_fused(fused_windows)
        if pad or (self.pad_pow2 and self.window > 1):
            # padding-waste slice: every padded-mode launch
            # reports its batch and pad so perf_dump's pad_waste.<label>
            # and padding_waste_ratio show where padding bytes go
            from .dispatch import record_padding

            record_padding(self._group_label(g), g.stripes + pad, pad)

    def _group_label(self, g: _AggGroup) -> str:
        """Stable human-readable lane name for a group's flight records
        and trace-export lanes: aggregator kind + a short key digest +
        the chunk length (the key's raw bytes are not JSON-safe).
        crc32 over the key's repr, NOT hash(): the built-in is salted
        per process, which would break cross-run lane correlation."""
        import zlib

        chunk = g.key[-1] if g.key and isinstance(g.key[-1], int) else 0
        digest = zlib.crc32(repr(g.key).encode())
        return f"{self.PERF_NAME}/{digest:08x}/L{chunk}"

    # -- device guard -------------------------------------------------------

    def _guarded_dispatch(self, g: _AggGroup, data: np.ndarray, donate):
        """Dispatch one launch under the device guard: the `codec.launch`
        faultpoint and the per-launch deadline apply here.  A failure
        raises (every rider's reap reports it as EIO); one that is the
        device's marks the backend DEGRADED.  Nothing is recomputed on
        the host (ops/guard.py says why)."""
        from ..common.fault_injector import faultpoint
        from .guard import device_guard

        def dispatch():
            # the event is recorded HERE, in the thread that enqueued the
            # kernels: the guard runs this on its watchdog thread, and
            # torch's current stream belongs to the thread
            out = self._dispatch(g, data, donate)
            return out, completion_event(out)

        try:
            faultpoint("codec.launch")
            out, g.event = device_guard().call(
                dispatch, what=f"{self.WHAT} dispatch"
            )
        except Exception as e:
            self._device_failed(e)
            raise
        return out

    def _device_failed(self, cause: Exception) -> None:
        """Mark the backend DEGRADED for a launch that failed on the
        device (a deadline, a CUDA error, an injected fault); one that
        failed on its inputs (bad geometry, a singular decode matrix)
        leaves the backend healthy."""
        from ..codec.interface import EcError
        from .guard import device_guard

        if not isinstance(cause, (ValueError, TypeError, EcError)):
            device_guard().mark_degraded(
                f"{self.WHAT} launch failed: {cause!r}"
            )

    # -- settle / reap -------------------------------------------------------

    def _settle(self, g: _AggGroup) -> None:
        """Resolve a group to host bytes (or a sticky error), releasing
        its backpressure credit exactly once.  Lock order: group lock ->
        aggregator lock (nothing acquires the other way); the blocking
        device wait runs outside the aggregator-wide lock so other
        geometries never stall behind a kernel.  The wait itself is
        deadline-guarded: a device that wedges AFTER dispatch fails the
        launch and degrades the backend as a failed dispatch does."""
        from .guard import DeviceDegraded, device_guard

        with g.lock:
            if g.host is None and g.error is None and g.parity is None:
                # still windowed: detach and launch it ourselves (a reap
                # must never deadlock behind its own window).  Identity
                # check: a newer group may have reused our key after we
                # were detached by a concurrent flush — popping IT would
                # orphan its window.
                with self._lock:
                    if self._groups.get(g.key) is g:
                        del self._groups[g.key]
                try:
                    self._launch(g, "flush_reap")
                except Exception:
                    pass  # reported as EcError via g.error at the reap
            if g.host is None and g.error is None:
                parity = g.parity
                device_side = not isinstance(parity, np.ndarray)
                single = len(g.tickets) == 1 and not g.pad
                host = parity
                if device_side:
                    # completion-ordered readiness probe: at
                    # pipeline depth > 1 a launch often finished under a
                    # LATER launch's dispatch — was_ready marks perfect
                    # overlap on the record, and a DEGRADED backend with
                    # an UNREADY buffer fails the launch at once, so one
                    # wedged launch costs one deadline, not one per
                    # in-flight group
                    event = g.event
                    try:
                        was_ready = event is None or bool(event.query())
                    except RuntimeError:  # a CUDA error surfaced here
                        was_ready = False
                    if device_guard().degraded and not was_ready:
                        g.error = DeviceDegraded(
                            "device backend degraded with the launch "
                            "still in flight"
                        )
                        device_side = False  # suspect buffer: never pool it
                if device_side:
                    # when the buffer is headed for the donation pool the
                    # copy MUST be forced: `.numpy()` of a CPU tensor is a
                    # view, and a view into a later-donated buffer would
                    # corrupt silently (`.cpu()` of a CUDA tensor already
                    # is a fresh host copy).  Single-ticket unpadded groups
                    # (the window<=1 default path) hand the result
                    # straight through — no forced copy, no pooling.
                    force_copy = g.donatable and not single
                    rec = g.flight
                    # the worker writes spans into a side dict, folded
                    # into the record only on SUCCESS: a materialize
                    # that times out leaves an abandoned worker holding
                    # this closure, and if the device later unwedges it
                    # would otherwise rewrite an already-committed
                    # record with a minutes-long bogus kernel span
                    spans: dict[str, float] = {}

                    def _materialize():
                        # flight sub-spans: kernel_s is how long THIS
                        # reap blocked waiting for the device (0 = the
                        # kernel finished under other work — perfect
                        # overlap); d2h_s is the device->host copy.
                        # complete_ts anchors the record's spans in
                        # completion order: under async dispatch the
                        # wall clock around the (non-blocking) dispatch
                        # no longer brackets the kernel.
                        t0 = time.monotonic()
                        if event is not None:
                            event.synchronize()
                        t1 = time.monotonic()
                        out = parity.cpu().numpy()
                        if force_copy and not parity.is_cuda:
                            out = out.copy()
                        t2 = time.monotonic()
                        spans["kernel_s"] = t1 - t0
                        spans["complete_ts"] = t1
                        spans["d2h_s"] = t2 - t1
                        return out

                    from .flight_recorder import flight_recorder

                    try:
                        with flight_recorder().active_scope(rec):
                            host = device_guard().call(
                                _materialize,
                                what=f"{self.WHAT} materialize",
                            )
                        if rec is not None:
                            rec["kernel_s"] += spans.get("kernel_s", 0.0)
                            rec["d2h_s"] += spans.get("d2h_s", 0.0)
                            rec["complete_ts"] = spans.get(
                                "complete_ts", 0.0
                            )
                            if was_ready:
                                rec["flags"]["overlap"] = True
                    except Exception as e:
                        self._device_failed(e)
                        g.error = e
                        device_side = False  # suspect buffer: never pool it
                # the launch's output stops being LIVE at settle whatever
                # happened to it — leaving a stale refcount would poison
                # a later buffer that reuses the id
                if g.held is not None:
                    with self._lock:
                        self._donate_pool.release(g.held)
                    g.held = None
                if g.error is None:
                    if single:
                        g.host = host
                    else:
                        g.host = host[: g.stripes] if g.pad else host
                        if g.donatable and device_side:
                            # release the in-flight ledger hold BEFORE
                            # the donation pool re-accounts the same
                            # buffer under ec_donation — the two charges
                            # overlapping would double-count the bytes
                            # and permanently inflate the peak gauges
                            if g.mem is not None:
                                g.mem.free()
                                g.mem = None
                            with self._lock:
                                self._donate_pool.put(
                                    tuple(parity.shape), parity
                                )
                g.parity = None
            # settled (host bytes or sticky error): release the
            # backpressure credit and the HBM ledger hold — the release is unconditional, so the
            # sticky-error path (the historical leak shape) cannot keep
            # the in-flight pool charged
            if g.mem is not None:
                g.mem.free()
                g.mem = None
            if g.credit:
                self.inflight.put(g.credit)
                g.credit = 0
            # commit the flight record exactly once (g.flight nulls out;
            # later reaps of the same group skip this)
            if g.flight is not None:
                rec, g.flight = g.flight, None
                rec["flags"]["error"] = g.error is not None
                rec["settle_ts"] = time.monotonic()
                from .flight_recorder import flight_recorder

                flight_recorder().commit(rec)
        with self._lock:
            removed = g in self._live
            if removed:
                self._live.remove(g)
        if removed:
            from .dispatch import PIPELINE

            PIPELINE.settle()

    def _materialize(self, ticket: AggTicket) -> None:
        g = ticket._group
        self._settle(g)
        if g.error is not None:
            # lazy: the codec imports this module, not the reverse; every
            # reap path (EC and non-EC riders alike) catches EcError
            from ..codec.interface import EcError
            from ..common.errs import EIO

            raise EcError(
                EIO, f"aggregated {self.WHAT} launch failed: {g.error!r}"
            )
        ticket._value = g.host[ticket._start : ticket._start + ticket._stripes]
# every live aggregator, weakly held: the HBM pressure
# layer's stage-2 trim and the tier-1 leak gate's teardown drain reach
# all instances — the process-wide defaults AND test-local ones
_AGGREGATORS: "weakref.WeakSet[LaunchAggregator]" = weakref.WeakSet()


def drop_donation_retention() -> int:
    """Drop every live aggregator's FREE pooled buffers (HBM pressure
    stage 2); returns the bytes released."""
    freed = 0
    for agg in list(_AGGREGATORS):
        with agg._lock:
            freed += agg._donate_pool.drop_free()
    return freed


def drain_all_aggregators() -> None:
    """Flush + settle every live aggregator (the tier-1 leak gate and
    the chaos harness's end-of-run drain)."""
    for agg in list(_AGGREGATORS):
        agg.drain()


class OffloadService:
    """One registered device-offload service: a name, the aggregator
    factory that builds (or returns) its process-wide instance, the QoS
    lane its launches ride (ops/launch_scheduler lanes: client /
    recovery / background) and a one-line description of its
    byte-identical host oracle.  The aggregator subclass IS the plan
    builder + oracle pair; the registry names them so generic code
    (perf export, drains, tools) can reach every service uniformly."""

    __slots__ = ("name", "factory", "lane", "oracle", "doc", "_instance")

    def __init__(self, name, factory, lane, oracle, doc):
        self.name = name
        self.factory = factory
        self.lane = lane
        self.oracle = oracle
        self.doc = doc
        self._instance: LaunchAggregator | None = None

    def aggregator(self) -> "LaunchAggregator":
        if self._instance is None:
            self._instance = self.factory()
        return self._instance


_SERVICES: "OrderedDict[str, OffloadService]" = OrderedDict()
_SERVICES_LOCK = _lockdep_make_lock("offload_services")


def register_service(
    name: str,
    factory,
    *,
    lane: str = "client",
    oracle: str = "",
    doc: str = "",
) -> OffloadService:
    """Register (or re-register, idempotently) an offload service.
    `factory` returns the service's process-wide LaunchAggregator;
    factories managing their own singleton (the EC default_*_aggregator
    trio) are called at most once per registry entry anyway."""
    with _SERVICES_LOCK:
        svc = _SERVICES.get(name)
        if svc is None:
            svc = _SERVICES[name] = OffloadService(
                name, factory, lane, oracle, doc
            )
        return svc


def service(name: str) -> OffloadService:
    """The registered service record, importing the module that
    registers it on first miss (the registry is populated by the
    service modules' import side effects)."""
    with _SERVICES_LOCK:
        svc = _SERVICES.get(name)
    if svc is None:
        _import_builtin_services()
        with _SERVICES_LOCK:
            svc = _SERVICES.get(name)
    if svc is None:
        raise KeyError(f"no offload service {name!r}")
    return svc


def service_aggregator(name: str) -> "LaunchAggregator":
    """The named service's shared process-wide aggregator."""
    return service(name).aggregator()


def offload_services() -> tuple[str, ...]:
    """Names of every registered service, registration-ordered."""
    _import_builtin_services()
    with _SERVICES_LOCK:
        return tuple(_SERVICES)


def _import_builtin_services() -> None:
    """Import the modules whose import side effects register the
    built-in services: the EC trio, then compress and csum, registered in
    the reference's order."""
    from ..codec import matrix_codec  # noqa: F401  (encode/decode/verify)
    from ..compressor import device  # noqa: F401  (compress)
    from . import checksum_offload  # noqa: F401  (csum)


def offload_perf_dump() -> dict[str, object]:
    """Flat JSON-safe per-service counter export — the `offload.*`
    slice of the OSD perf report, re-exported by the mgr Prometheus
    scrape as the ceph_tpu_offload_* families.  Services whose
    aggregator was never built contribute zeros (a family that appears
    only after first traffic would flap the metrics lint)."""
    _import_builtin_services()
    out: dict[str, object] = {}
    with _SERVICES_LOCK:
        entries = list(_SERVICES.items())
    for name, svc in entries:
        agg = svc.aggregator()
        for counter, val in agg.perf.dump().items():
            out[f"{name}.{counter}"] = val
        out[f"{name}.pending"] = agg.pending()
    out["services"] = len(entries)
    return out
