"""ECBackend — the erasure-coded PG I/O engine.

The port of `ceph_tpu/osd/ec_backend.py`'s write pipeline, its
reconstructing reads and its recovery (Ceph's src/osd/ECBackend.{h,cc}):

- Write pipeline: `submit_transaction` -> `_start_rmw` builds a WritePlan
  (ECBackend.cc:1882-1906); ops needing partial-stripe reads go through the
  ExtentCache + remote reads (`try_state_to_reads`, :1908-1980); encode fans
  out per-shard ECSubWrite transactions (`try_reads_to_commit`, :1982-2037);
  replies gather in `handle_sub_write_reply` -> commit ack (:1158).
- Reads: `objects_read_and_reconstruct` (:2389) computes the minimum shard
  set via `minimum_to_decode` (:1634-1651), sends ECSubRead to each source
  shard (the primary messages itself, ECBackend.h:336-338), verifies and
  gathers replies (`handle_sub_read_reply`, :1191-1328) with redundant-read
  escalation on error, then decodes.
- `handle_sub_read` reads chunks from the ObjectStore and verifies the
  cumulative crc32c against hinfo (:1023-1156); CLAY's sub-chunk runs
  select planes inside each stripe's chunk (:1047-1068).
- Recovery (`recover_object`, continue_recovery_op :591-746): READING
  gathers the surviving shards through the read path, DECODING launches
  the rebuild of the missing shards through the DecodeAggregator (a
  codec with no matrix fast path decodes stripe by stripe; CLAY's repair
  plan reads only fragments and rebuilds in one batched launch), WRITING
  fans out one MOSDPGPush per rebuilt shard, and the last MOSDPGPushReply
  completes it.  A stalled push is re-sent by `retry_stalled_pushes`.

Encodes and decodes are batched whole-extent device launches through the
port's EncodeAggregator and DecodeAggregator (stripe.encode_launch,
stripe.decode_concat_launch) onto the hand kernels, and the transport is a
listener-provided `send_shard(osd, msg)` hook, so the same engine runs
under an event loop or an in-process test harness.  A failed launch fails
its write with EIO (no host recompute): `_fail_encoded_op` aborts it and
every later write to the object that has not fanned out; a failed
recovery decode completes `recover_object` with -EIO and pushes nothing.
A shard store's failed checksum or compressor launch (fault C8) fails a
sub-write that no shard committed with EIO; one that some shard did
commit rolls forward (`retry_failed_sub_writes`).

The device chunk cache (ops/device_cache.py): a materialize-path write on
an overwrites pool seeds its regions' k+m chunks; a reconstruct or a
recovery decode consults it first and caches what it rebuilds; a cache-hit
RMW updates parity on the device in one `packed_delta` launch (the RMW
delta path, `ec_tpu_rmw_delta`).  A failed delta launch fails its write
with EIO through `_fail_encoded_op` — the reference re-encodes it on the
materialize path.  Deep scrub (osd/scrubber.py) verifies parity through
`verify_aggregator`.

Not ported yet, each with the module that needs it: adaptive hedged
reads, laggy-peer planning and the sub-read deadline shed.
"""

from __future__ import annotations

import asyncio
import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Mapping

import numpy as np

from ..codec.interface import EcError, ErasureCodeInterface
from ..common import tracer as tracer_mod
from ..common.errs import EIO
from ..common.fault_injector import InjectedFailure, faultpoint
from ..common.log import dout
from ..common.tracer import null_span
from ..msg.messages import (
    MOSDECSubOpRead,
    MOSDECSubOpReadReply,
    MOSDECSubOpWrite,
    MOSDECSubOpWriteReply,
    MOSDPGPush,
    MOSDPGPushReply,
    PushOp,
    ReqId,
)
from ..os.objectstore import ObjectStore, StoreError
from ..os.transaction import Transaction
from ..osd.osdmap import PG_NONE
from ..stripe import HashInfo, StripeInfo
from ..stripe import stripe as stripe_mod
from ..utils import crc32c
from .extent_cache import ExtentCache
from .pg_backend import PGBackend, PGListener, shard_coll
from .ec_transaction import (
    HINFO_ATTR,
    OI_ATTR,
    ObjectInfo,
    PGTransaction,
    WritePlan,
    _merge_ranges,
    finish_transactions,
    get_write_plan,
    launch_encode,
    launch_encode_delta,
)
from .pg_log import Eversion, LogEntry, LOG_DELETE, LOG_MODIFY

# on-device RMW delta path arm bit (`ec_tpu_rmw_delta`): process-wide like
# the device cache it composes with.  None = not configured yet — read the
# option default lazily.
_RMW_DELTA: bool | None = None


def configure_rmw_delta(enabled: bool) -> None:
    """Arm/disarm the on-device RMW delta-encode path (the
    `ec_tpu_rmw_delta` observer hook)."""
    global _RMW_DELTA
    _RMW_DELTA = bool(enabled)


def rmw_delta_enabled() -> bool:
    global _RMW_DELTA
    if _RMW_DELTA is None:
        from ..common.options import OPTIONS

        _RMW_DELTA = bool(OPTIONS["ec_tpu_rmw_delta"].default)
    return _RMW_DELTA


@dataclass
class Op:
    """An in-flight write (ECBackend::Op)."""

    tid: int
    pgt: PGTransaction
    reqid: ReqId
    plan: WritePlan
    version: Eversion
    on_commit: Callable[[], None]
    on_failure: Callable[[int], None] | None = None
    obj_size: int = 0
    read_results: dict[int, bytes] = field(default_factory=dict)  # off -> bytes
    pending_commits: set[int] = field(default_factory=set)  # shard ids
    pin: object | None = None
    encoded: bool = False
    # LAUNCHED device encode awaiting dispatch (EncodeStage); the encode
    # pipeline reaps these FIFO so sub-writes fan out in tid order
    encode_stage: object | None = None
    drain_polls: int = 0
    encode_t0: float = 0.0  # launch time; reap samples ec_encode_latency
    # ec:write span (ECBackend::Op::trace); null span unless a tracer is on
    trace: object = field(default_factory=lambda: null_span())
    # pre-write device-cache generation, captured at submit BEFORE this op
    # projects: the RMW read leg reads exactly the committed pre-write
    # bytes (later same-object writes are tid-ordered behind us), so it may
    # serve them from the device cache at this generation.  None when an
    # earlier in-flight write makes the on-disk bytes ambiguous.
    cache_read_gen: object = None
    # this op's encode took the on-device delta path: its launch already
    # committed data + parity into the device cache at the write's
    # generation, so the reap must not re-seed the cache
    delta: bool = False
    # the fanned-out sub-writes, shard -> (osd, message): kept until the
    # op commits, so a shard whose store failed it can be sent it again
    sub_writes: dict = field(default_factory=dict)
    committed_shards: set[int] = field(default_factory=set)
    # shards whose store failed the sub-write: `failed_shards` wait to be
    # sent it again (retry_failed_sub_writes), `torn_shards` hold the
    # object's previous version until they commit this one
    failed_shards: set[int] = field(default_factory=set)
    torn_shards: set[int] = field(default_factory=set)


@dataclass
class ReadRequest:
    """One object's read spec inside a ReadOp."""

    to_read: list[tuple[int, int]]  # logical (off, len) as requested
    stripe_ranges: list[tuple[int, int]]  # stripe-aligned covers
    want_attrs: bool = False


@dataclass
class ReadOp:
    """In-flight reconstruct read (ECBackend::ReadOp)."""

    tid: int
    requests: dict[str, ReadRequest]
    want: set[int]  # shard indices we must reconstruct
    sources: dict[int, int]  # shard -> osd we asked
    subchunks: dict[int, list[tuple[int, int]]]
    on_complete: Callable[[dict], None]
    # shard -> {oid -> list[(off, bytes)]}
    replies: dict[int, dict[str, list[tuple[int, bytes]]]] = field(default_factory=dict)
    attrs: dict[str, dict[str, bytes]] = field(default_factory=dict)
    errors: dict[int, set[str]] = field(default_factory=dict)  # shard -> oids
    tried: set[int] = field(default_factory=set)  # shards already asked
    # recovery consumes the raw gathered shard streams instead of the
    # decoded extents; set by recover_object
    on_complete_raw: Callable[["ReadOp", set[int]], None] | None = None
    trace: object = field(default_factory=lambda: null_span())  # ec:read span
    # per-oid device-cache generation overrides: the RMW read leg captures
    # the committed pre-write generation at submit, before its own
    # projection would make `_cache_generation` return None
    cache_generations: dict = field(default_factory=dict)


# never-reused namespace tokens for the device chunk cache: one per
# ECBackend instance, so entries from a torn-down cluster / failed-over
# primary in the same process can never serve another backend's reads
_CACHE_NS = itertools.count(1)


RECOVERY_IDLE = "IDLE"
RECOVERY_READING = "READING"
RECOVERY_DECODING = "DECODING"
RECOVERY_WRITING = "WRITING"
RECOVERY_COMPLETE = "COMPLETE"


@dataclass
class RecoveryOp:
    """ECBackend::RecoveryOp (ECBackend.h:249-289), extended with a
    DECODING stage: the device decode is LAUNCHED (or aggregator-windowed)
    when the reads complete, and the pushes fan out when the decode
    pipeline reaps it — so several in-flight objects' decodes share one
    aggregated launch during recovery/backfill."""

    oid: str
    missing_on: set[int]  # shard indices to rebuild
    on_complete: Callable[[int], None]  # errno
    state: str = RECOVERY_IDLE
    shard_data: dict[int, bytes] = field(default_factory=dict)
    attrs: dict[str, bytes] = field(default_factory=dict)
    pending_pushes: set[int] = field(default_factory=set)
    # LAUNCHED device decode awaiting reap (stripe.PendingDecode)
    pending_decode: object | None = None
    decode_polls: int = 0
    decode_t0: float = 0.0  # launch time; reap samples ec_decode_latency
    # when the WRITING-stage pushes last fanned out: the stalled-push
    # retry re-sends pending shards past the grace, so a dropped PushOp
    # cannot park the op in WRITING forever
    push_ts: float = 0.0
    push_retries: int = 0
    trace: object = field(default_factory=lambda: null_span())  # ec:recover


class ECBackend(PGBackend):
    """Per-PG EC engine; one instance per OSD hosting a shard of the PG."""

    def __init__(
        self,
        listener: PGListener,
        store: ObjectStore,
        ec: ErasureCodeInterface,
        sinfo: StripeInfo,
        allows_overwrites: bool = False,
        fast_read: bool = False,
        aggregator=None,
        decode_aggregator=None,
        verify_aggregator=None,
    ):
        super().__init__(listener, store)
        self.ec = ec
        self.sinfo = sinfo
        self.allows_overwrites = allows_overwrites
        self.fast_read = fast_read
        # Cross-write launch aggregation: the default instance is shared
        # process-wide, so concurrent small writes from DIFFERENT PGs on
        # this OSD coalesce into one padded device launch (the bucketed
        # all-reduce analog; window knobs in common/options.py).  The
        # commit barrier (flush_encodes) and the pipe drain flush it.
        from ..codec.matrix_codec import (
            default_decode_aggregator,
            default_encode_aggregator,
            default_verify_aggregator,
        )

        self.encode_aggregator = (
            aggregator if aggregator is not None else default_encode_aggregator()
        )
        # Decode twin: recovery / degraded-read decodes from different
        # PGs coalesce per erasure-pattern signature (the backfill case —
        # one pattern, many objects; ec_tpu_decode_aggregate_* knobs).
        self.decode_aggregator = (
            decode_aggregator
            if decode_aggregator is not None
            else default_decode_aggregator()
        )
        # Verify triplet: deep-scrub parity recomputes ride compare-only
        # launches under the background QoS lane (osd/scrubber.py submits)
        self.verify_aggregator = (
            verify_aggregator
            if verify_aggregator is not None
            else default_verify_aggregator()
        )
        # the hinfo digests' host library is built (once per source) when
        # a backend is made, as a CUDA codec builds its kernels, so no
        # write or read pays for the compile; a failed build raises here
        crc32c.build_library()
        # device-resident chunk cache namespace: reads of this PG consult
        # and fill the process-wide cache under a never-reused token,
        # keyed further by (oid, shard, offset) and checked by generation
        self._cache_ns = (next(_CACHE_NS), str(listener.pgid))
        self.extent_cache = ExtentCache()
        self._tid = 0
        self.in_flight: dict[int, Op] = {}  # write tid -> Op
        self.waiting_reads: list[Op] = []
        self.read_ops: dict[int, ReadOp] = {}
        self.recovery_ops: dict[str, RecoveryOp] = {}
        # Projected object state while writes are in flight (the reference's
        # unstable_hashinfo_registry + projected object contexts): later ops
        # submitted before earlier ones commit must see pending size/hinfo.
        self._projected: dict[str, dict] = {}  # oid -> {size, hinfo, refs}
        # Encode pipeline: ops whose device encode is LAUNCHED but whose
        # sub-writes have not fanned out yet.  Reaped strictly FIFO so
        # log entries reach replicas in version order; bounded by
        # encode_depth (the AIO queue-depth analog).
        self._encode_pipe: list[Op] = []
        self.encode_depth = 8
        # Decode pipeline: RecoveryOps whose device decode is LAUNCHED (or
        # windowed in the decode aggregator) but whose pushes have not
        # fanned out yet.  _continue_recovery reaps FIFO; bounded by
        # decode_depth — the small window of in-flight RecoveryOps whose
        # decodes share an aggregated launch.
        self._decode_pipe: list[RecoveryOp] = []
        self.decode_depth = 8
        # lifetime stalled-push retries (retry_stalled_pushes)
        self.push_retries = 0
        # shard side of fault C8: oid -> tid of a sub-write this shard's
        # store failed; later sub-writes for the object are refused until
        # that one is sent again and commits, or is abandoned
        self._sub_write_fences: dict[str, int] = {}
        # lifetime re-sent sub-writes (retry_failed_sub_writes)
        self.sub_write_retries = 0

    # -- helpers -------------------------------------------------------------

    def _span(self, name: str, parent=None):
        """Start a span on the daemon tracer (the ZTracer::Trace threaded
        through every handle_sub_* in the reference, ECBackend.h:64-87);
        harnesses without a tracer get no-op spans.  With no explicit
        parent, the active span (the OSD's osd:op, set by dispatch) is
        adopted so the EC stages join the client's trace instead of
        starting a disconnected root."""
        from ..common.tracer import NULL_TRACER

        if parent is None:
            parent = tracer_mod.current_span()
        if parent is not None:
            return parent.child(name)
        return (getattr(self.listener, "tracer", None) or NULL_TRACER).start_span(name)

    def _perf_hist(self, name: str, value: float) -> None:
        """Sample a daemon latency histogram through the listener (PGs
        forward to the OSD's PerfCounters; harnesses without one drop it)."""
        hook = getattr(self.listener, "perf_hist", None)
        if hook is not None:
            hook(name, value)

    def _next_tid(self) -> int:
        self._tid += 1
        return self._tid

    @property
    def k(self) -> int:
        return self.ec.get_data_chunk_count()

    @property
    def n(self) -> int:
        return self.ec.get_chunk_count()

    # -- device-resident chunk cache -------------------------------------------

    def _chunk_cache(self):
        """The process-wide device chunk cache when enabled, else None."""
        from ..ops.device_cache import device_chunk_cache

        cache = device_chunk_cache()
        return cache if cache.enabled else None

    def _cache_obj(self, oid: str):
        return (*self._cache_ns, oid)

    def _cache_generation(self, oid: str):
        """Cache generation for an object's chunks: the committed object
        version.  None while writes are in flight (projected state) —
        mid-RMW bytes must never be cached — or when the primary has no
        local object info to version against.  The RMW read leg is the one
        exception: `submit_transaction` captures this BEFORE its own
        projection and threads it through `ReadOp.cache_generations`, so
        the leg that reads exactly the committed pre-write bytes can still
        consult the cache."""
        if oid in self._projected:
            return None
        oi = self.get_object_info(oid)
        return oi.version if oi is not None else None

    def _shard_colls(self) -> dict[int, str]:
        return {s: shard_coll(self.listener.pgid, s) for s in range(self.n)}

    def _local_coll(self) -> str:
        return shard_coll(self.listener.pgid, self.listener.whoami_shard())

    def get_object_info(self, oid: str) -> ObjectInfo | None:
        try:
            return ObjectInfo.decode(self.store.getattr(self._local_coll(), oid, OI_ATTR))
        except StoreError:
            return None

    def get_hash_info(self, oid: str) -> HashInfo | None:
        """ECBackend::get_hash_info — hinfo from the local shard xattr."""
        try:
            return HashInfo.decode(self.store.getattr(self._local_coll(), oid, HINFO_ATTR))
        except StoreError:
            return None

    def object_size(self, oid: str) -> int:
        oi = self.get_object_info(oid)
        return oi.size if oi else 0

    def _available_shards(self, oid: str) -> set[int]:
        """Shards with a live data source for `oid`: the acting member
        when up and not missing it, else a stray holder the listener's
        `shard_data_source` redirection names — a CRUSH
        reshuffle moves a survivor's chunks to the wrong slot, but its
        old coll still serves reconstruction reads.  A shard whose store
        failed an in-flight write to the object (fault C8) is left out
        until it commits it."""
        src = getattr(self.listener, "shard_data_source", None)
        acting = self.listener.acting()
        missing = self.listener.get_shard_missing(oid)
        out: set[int] = set()
        for s in range(min(self.n, len(acting))):
            if acting[s] != PG_NONE and s not in missing:
                out.add(s)
            elif src is not None and src(s, oid) != PG_NONE:
                out.add(s)
        for op in self.in_flight.values():
            if op.torn_shards and op.pgt.oid == oid:
                out -= op.torn_shards  # still an earlier version (fault C8)
        return out

    def _shard_source(self, s: int, oids) -> int:
        """The osd a shard-`s` sub-read goes to: the listener's
        stray-aware redirection when available, else the acting member.
        One ReadOp sends ONE sub-read per shard, so a mixed multi-object
        request whose oids resolve to DIFFERENT sources falls back to the
        acting member — the per-object failure then rides the normal
        redundant-read escalation.  (In practice every caller batches one
        object per ReadOp, so the sources agree.)"""
        acting = self.listener.acting()
        osd = acting[s] if s < len(acting) else PG_NONE
        src = getattr(self.listener, "shard_data_source", None)
        if src is None:
            return osd
        chosen = PG_NONE
        for oid in oids:
            alt = src(s, oid)
            if alt == PG_NONE:
                continue
            if chosen == PG_NONE:
                chosen = alt
            elif alt != chosen:
                return osd  # sources disagree: keep the acting member
        return chosen if chosen != PG_NONE else osd

    def _logical_range_to_chunk_extent(self, off: int, length: int) -> tuple[int, int]:
        """Stripe-aligned logical (off, len) -> per-shard chunk (off, len)."""
        assert off % self.sinfo.stripe_width == 0
        assert length % self.sinfo.stripe_width == 0
        return (
            self.sinfo.aligned_logical_offset_to_chunk_offset(off),
            (length // self.sinfo.stripe_width) * self.sinfo.chunk_size,
        )

    # -- message entry point --------------------------------------------------

    def handle_message(self, msg) -> bool:
        if isinstance(msg, MOSDECSubOpWrite):
            self.handle_sub_write(msg)
        elif isinstance(msg, MOSDECSubOpWriteReply):
            self.handle_sub_write_reply(msg)
        elif isinstance(msg, MOSDECSubOpRead):
            self.handle_sub_read(msg)
        elif isinstance(msg, MOSDECSubOpReadReply):
            self.handle_sub_read_reply(msg)
        elif isinstance(msg, MOSDPGPush):
            self.handle_recovery_push(msg)
        elif isinstance(msg, MOSDPGPushReply):
            self.handle_recovery_push_reply(msg)
        else:
            return False
        return True

    # -- write pipeline (§3.1) -----------------------------------------------

    def submit_transaction(
        self,
        pgt: PGTransaction,
        reqid: ReqId,
        on_commit: Callable[[], None],
        on_failure: Callable[[int], None] | None = None,
    ) -> int:
        """Primary-only: start the RMW pipeline (ECBackend.cc:1523,1882).
        on_commit fires when all shards committed; on_failure(errno) fires
        if the RMW read phase fails (the reference asserts here)."""
        tid = self._next_tid()
        proj = self._projected.get(pgt.oid)
        obj_size = proj["size"] if proj else self.object_size(pgt.oid)
        plan = get_write_plan(self.sinfo, pgt, obj_size, self.allows_overwrites)
        version = self.listener.next_version()
        op = Op(
            tid=tid,
            pgt=pgt,
            reqid=reqid,
            plan=plan,
            version=version,
            on_commit=on_commit,
            on_failure=on_failure,
            obj_size=obj_size,
            trace=self._span("ec:write"),
        )
        op.trace.keyval("oid", pgt.oid)
        op.trace.keyval("tid", tid)
        op.trace.event("start ec write")
        # device-cache generation for the RMW read leg, captured BEFORE
        # this op projects: with no earlier in-flight write the read leg
        # reads exactly the committed pre-write bytes, so it may serve them
        # from the cache at this generation.  Invalidation happens at
        # encode dispatch (the moment the bytes change), not here —
        # invalidating now would destroy the entries the read leg consults.
        op.cache_read_gen = self._cache_generation(pgt.oid)
        if proj is None:
            proj = self._projected[pgt.oid] = {
                "size": obj_size,
                "hinfo": None,
                "hinfo_known": False,
                "refs": 0,
            }
        proj["size"] = plan.new_size
        proj["refs"] += 1
        self.in_flight[tid] = op
        self._start_rmw(op)
        return tid

    def _unref_projected(self, oid: str) -> None:
        proj = self._projected.get(oid)
        if proj is not None:
            proj["refs"] -= 1
            if proj["refs"] <= 0:
                del self._projected[oid]

    def _fail_op_chain(self, op: Op, err: int) -> None:
        """Abort a failed un-encoded op and every LATER un-encoded op on the
        same object: their plans were computed against this op's projected
        state, which was never written.  Projected state resets to disk."""
        oid = op.pgt.oid
        doomed = [op] + [
            o
            for o in list(self.in_flight.values()) + self.waiting_reads
            if o.pgt.oid == oid and o.tid > op.tid and not o.encoded
        ]
        for o in doomed:
            self.in_flight.pop(o.tid, None)
        self.waiting_reads = [o for o in self.waiting_reads if o not in doomed]
        self._projected.pop(oid, None)
        self.listener.clog_error(
            f"{self.listener.pgid}: RMW read for {oid} failed ({err}); "
            f"aborting {len(doomed)} queued write(s)"
        )
        self._kick_waiting_reads()
        for o in doomed:
            o.trace.event(f"aborted: rmw read failed ({err})")
            o.trace.finish()
            if o.on_failure is not None:
                o.on_failure(err)

    def _start_rmw(self, op: Op) -> None:
        # try_state_to_reads: ops on the same object encode strictly in tid
        # order — an earlier un-encoded op may still change the bytes (and
        # hinfo chain) this op depends on.
        if self._blocked_by_earlier(op):
            op.trace.event("waiting on earlier write to same object")
            self.waiting_reads.append(op)
            return
        if not op.plan.to_read:
            self._encode_and_dispatch(op)
            return
        self._issue_rmw_reads(op)

    def _blocked_by_earlier(self, op: Op) -> bool:
        return any(
            other.tid < op.tid and not other.encoded and other.pgt.oid == op.pgt.oid
            for other in self.in_flight.values()
        )

    def _unpinned_runs(self, op: Op, off: int, ln: int) -> list[tuple[int, int]]:
        """The runs of a stripe-aligned RMW read range that must come
        from the shards.  A stripe an earlier in-flight write touched is
        pinned whole (its merged bytes are stripe-aligned) until that
        write commits, and the shards may not hold its bytes yet: such
        stripes are served from the pins into `op.read_results`.  A range
        no pin touches is read whole, as before.  The reference reads a
        partly pinned range whole from the shards and so loses the
        earlier write's bytes (ROADMAP.md C5); this is the one place the
        port's messages differ from its."""
        sw = self.sinfo.stripe_width
        pinned = {
            s: self.extent_cache.present(op.pgt.oid, s, sw)
            for s in range(off, off + ln, sw)
        }
        if all(data is None for data in pinned.values()):
            return [(off, ln)]
        runs: list[tuple[int, int]] = []
        for s, data in pinned.items():
            if data is not None:
                op.read_results[s] = data
            elif runs and runs[-1][0] + runs[-1][1] == s:
                runs[-1] = (runs[-1][0], runs[-1][1] + sw)
            else:
                runs.append((s, sw))
        return runs

    def _issue_rmw_reads(self, op: Op) -> None:
        need: dict[str, list[tuple[int, int]]] = {}
        for off, ln in op.plan.to_read:
            cached = self.extent_cache.present(op.pgt.oid, off, ln)
            if cached is not None:
                op.read_results[off] = cached
            else:
                for ext in self._unpinned_runs(op, off, ln):
                    need.setdefault(op.pgt.oid, []).append(ext)
        if not need:
            op.trace.event("rmw inputs served from extent cache")
            self._encode_and_dispatch(op)
            return
        op.trace.event("issue rmw reads")

        def _on_read(results: dict) -> None:
            if self.in_flight.get(op.tid) is not op:
                # the op was aborted while its reads were in flight (an
                # earlier same-object encode failure doomed it): a stale
                # completion must not resurrect it — encoding it now
                # would persist a write whose client already saw EIO,
                # and the error branch would double-fire on_failure
                return
            err, extents = results[op.pgt.oid]
            if err:
                # The reference asserts here (a decodable PG cannot fail its
                # own RMW read); we fail the op without killing the dispatch
                # loop.  Later ops on the object planned against this op's
                # projected size/bytes, so they abort with it.
                self._fail_op_chain(op, err)
                return
            for (off, _ln), data in zip(need[op.pgt.oid], extents):
                op.read_results[off] = data
            self._encode_and_dispatch(op)

        self.objects_read_and_reconstruct(
            need,
            _on_read,
            parent_span=op.trace,
            cache_generations={op.pgt.oid: op.cache_read_gen},
        )

    def _encode_and_dispatch(self, op: Op) -> None:
        """try_reads_to_commit (ECBackend.cc:1982): LAUNCH the device
        encode, pin the merged bytes, and queue the op on the encode
        pipeline.  The launch returns while the chip works; sub-writes fan
        out when the pipeline reaps the op (FIFO), so the next op's RMW
        reads overlap this op's device encode — the overlap Ceph gets from
        queued AIO in front of ec_encode_data."""
        cache = self._chunk_cache()
        op.encode_t0 = time.monotonic()
        stage = None
        # on-device RMW delta: when the cache holds EVERY shard of the
        # written regions at the op's pre-write generation, parity updates
        # on the device (one launch, zero H2D/D2H on its flight record) and
        # the cache generation bumps in place — no invalidation, no
        # materialize launch.  Preconditions: armed, overwrites pool, an
        # actual RMW (to_read non-empty), an unambiguous pre-write
        # generation, and no truncate (a size change re-shapes regions).
        if (
            cache is not None
            and rmw_delta_enabled()
            and self.allows_overwrites
            and op.plan.to_read
            and op.cache_read_gen is not None
            and op.pgt.truncate is None
        ):
            try:
                with tracer_mod.span_scope(op.trace):
                    stage = launch_encode_delta(
                        op.pgt,
                        op.plan,
                        self.sinfo,
                        self.ec,
                        op.obj_size,
                        op.read_results,
                        cache,
                        self._cache_obj(op.pgt.oid),
                        op.cache_read_gen,
                        op.version.version,
                    )
            except EcError as e:
                # the delta launch failed: the write fails with EIO and is
                # not encoded again on the materialize path (the reference
                # falls back to it).  Its half-committed entries die here;
                # a device fault has marked the backend DEGRADED, which
                # cleared the cache already.
                cache.invalidate_object(self._cache_obj(op.pgt.oid))
                self._fail_encoded_op(op, e)
                return
            if stage is not None:
                op.delta = True
                op.trace.event("delta encode launched (cache hit)")
        if stage is None:
            # overwrite invalidation: from here on the object's bytes are
            # changing — this op's RMW read leg (which could still serve
            # the committed pre-write bytes) is complete, so drop the
            # now-stale device-resident chunks (the generation bump would
            # make them miss anyway; this frees device memory eagerly).
            # Also drops any half-committed new-generation entries of a
            # delta attempt that missed.
            if cache is not None:
                cache.invalidate_object(self._cache_obj(op.pgt.oid))
            # scope the launch under ec:write so codec h2d/kernel_launch
            # sub-spans (codec/tracing.py) and the PendingEncode's reap
            # span attach to this op's trace
            with tracer_mod.span_scope(op.trace):
                stage = launch_encode(
                    op.pgt,
                    op.plan,
                    self.sinfo,
                    self.ec,
                    op.obj_size,
                    op.read_results,
                    aggregator=self.encode_aggregator,
                )
        op.encode_stage = stage
        op.encoded = True
        op.trace.event("encode launched")
        # Pin exactly the bytes that were encoded (host-side, available at
        # launch) so overlapping writes pipeline (ExtentCache
        # reserve_extents_for_rmw): a later same-object op's RMW reads see
        # THESE bytes, not the not-yet-applied shard stores.
        pin = self.extent_cache.prepare_pin()
        for off, buf in op.encode_stage.merged.items():
            self.extent_cache.pin_extent(pin, op.pgt.oid, off, buf)
        op.pin = pin
        self._encode_pipe.append(op)
        # Backpressure: past the queue depth, reap the head now (blocking).
        while len(self._encode_pipe) > self.encode_depth:
            self._dispatch_encoded(self._encode_pipe.pop(0))
        self._schedule_drain()
        # Unblock same-object writers that were waiting on our encode; their
        # RMW inputs come from the pin.
        self._kick_waiting_reads()

    def _schedule_drain(self) -> None:
        """Reap finished encodes from a running event loop; without one
        (synchronous harnesses) the caller drains via flush_encodes()."""
        if not self._encode_pipe:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        loop.call_soon(self._drain_encode_pipe)

    def _drain_encode_pipe(self) -> None:
        """Dispatch every op whose launch finished, strictly FIFO.  A head
        still computing is re-polled a few times, then reaped blocking —
        bounded staleness beats an unbounded poll loop."""
        while self._encode_pipe:
            op = self._encode_pipe[0]
            # A head still sitting in the aggregation window gets the same
            # re-poll grace as a computing one (~100 ms for co-riders to
            # arrive and fill the window) — flushing on first sight would
            # defeat ec_tpu_aggregate_window on the event-loop path, where
            # this drain runs before the next write is even dispatched.
            # After the grace, drain the window: no amount of polling
            # launches a windowed encode.
            if not op.encode_stage.launched() and op.drain_polls >= 50:
                self.encode_aggregator.flush()
            if not op.encode_stage.ready() and op.drain_polls < 50:
                op.drain_polls += 1
                try:
                    asyncio.get_running_loop().call_later(
                        0.002, self._drain_encode_pipe
                    )
                except RuntimeError:
                    pass
                return
            self._dispatch_encoded(self._encode_pipe.pop(0))

    def flush_encodes(self) -> None:
        """Drain the whole encode pipeline (the barrier before commit
        checks in synchronous harnesses; EncodePipeline.flush analog).
        Drains the aggregation window first: a commit barrier must launch
        everything still waiting for co-riders.  A failed aggregated
        launch is sticky on its group — each affected op fails cleanly at
        its own reap below — so the barrier itself never throws.

        Also drains the recovery DECODE pipeline: synchronous harnesses
        (the test clusters' pump loops) use this as their only barrier,
        and a windowed recovery decode must never outlive it.  Last, it
        sends partly applied writes' failed sub-writes again
        (`retry_failed_sub_writes`)."""
        self.encode_aggregator.flush()
        while self._encode_pipe:
            self._dispatch_encoded(self._encode_pipe.pop(0))
        self.flush_decodes()
        self.retry_failed_sub_writes()

    def flush_decodes(self) -> None:
        """Drain the recovery decode pipeline: launch every windowed
        decode group and reap every in-flight RecoveryOp decode, fanning
        out its pushes (or failing it cleanly — a failed aggregated
        decode is sticky on its group and surfaces at each op's reap)."""
        self.decode_aggregator.flush()
        while self._decode_pipe:
            self._finish_recovery_decode(self._decode_pipe[0])


    def _csum_submit(self, chunk: bytes, chunk_off: int):
        """EC-transaction fusion: a freshly materialized shard chunk's
        per-BLOCK crc32c is submitted into the shared checksum offload
        window right at encode-reap time, on the codec's device; the
        returned ticket lands on the shard Transaction's write as its
        ``csums`` hint.  Misaligned chunks return None.  As in the
        reference, the hint does not survive the sub-write's
        serialization, so no store consumes these digests (ROADMAP §C,
        "Recorded, not the port's"): ported as is, so the launches
        match."""
        from ..os.bluestore import BLOCK

        if not chunk or chunk_off % BLOCK or len(chunk) % BLOCK:
            return None
        from ..ops.checksum_offload import default_csum_aggregator

        blocks = np.frombuffer(chunk, dtype=np.uint8).reshape(-1, BLOCK)
        return default_csum_aggregator().submit_blocks(blocks, self.ec.device)

    def _dispatch_encoded(self, op: Op) -> None:
        """Reap one launched encode and fan out its sub-writes
        (the completion half of try_reads_to_commit)."""
        proj = self._projected.get(op.pgt.oid)
        # hinfo resolves at completion time, in tid order: the projected
        # (pending) chain if an earlier op already produced one, else the
        # on-disk xattr.  None is ambiguous in proj["hinfo"], hence the
        # separate known flag.
        if proj is not None and proj["hinfo_known"]:
            hinfo = proj["hinfo"]
        else:
            hinfo = self.get_hash_info(op.pgt.oid)
        # cache seeding: a materialize-path write on an overwrites pool
        # seeds every region's k+m shard chunks into the device cache at
        # its generation — the residency the NEXT RMW's delta path hits.
        # A delta-path op skips it (its launch already committed data and
        # parity in place, with no host round-trip).
        cache = self._chunk_cache()
        seed = (
            cache is not None
            and rmw_delta_enabled()
            and self.allows_overwrites
            and not op.delta
            and not op.pgt.delete
        )
        # the reap may run from a bare event-loop callback (_drain_encode_pipe):
        # re-enter the op's span scope so materialization sub-spans attach
        with tracer_mod.span_scope(op.trace):
            try:
                txns, new_hinfo, merged = finish_transactions(
                    op.encode_stage,
                    op.pgt,
                    op.plan,
                    self.sinfo,
                    self.ec,
                    self._shard_colls(),
                    op.obj_size,
                    hinfo,
                    op.version.version,
                    chunk_cache=cache if seed else None,
                    cache_obj=self._cache_obj(op.pgt.oid) if seed else None,
                    cache_generation=op.version.version if seed else None,
                    csum_submit=(
                        self._csum_submit
                        if getattr(self.store, "_csum_offload", False)
                        else None
                    ),
                )
            except EcError as e:
                # a failed (aggregated) encode launch surfaces here, at
                # the op that owns the ticket: fail the op cleanly —
                # release its pin, reset projected state, abort dependent
                # writes — instead of leaking it from a drain callback
                self._fail_encoded_op(op, e)
                return
        op.encode_stage = None
        op.trace.event("encoded")
        if op.encode_t0:
            # launch -> reap: what the OSD's ec_encode_latency histogram
            # attributes to the encode stage
            self._perf_hist("ec_encode_latency", time.monotonic() - op.encode_t0)
        if proj is not None:
            proj["hinfo"] = new_hinfo
            proj["hinfo_known"] = True

        entry = LogEntry(
            op=LOG_DELETE if op.pgt.delete else LOG_MODIFY,
            oid=op.pgt.oid,
            version=op.version,
            reqid=op.reqid.key(),
        )
        acting = self.listener.acting()
        from .pg_backend import side_effect_log_entries

        log_bytes = [entry.tobytes()] + [
            e.tobytes()
            for e in side_effect_log_entries(self.listener, op.pgt)
        ]
        # Register EVERY pending shard before dispatching ANY sub-write:
        # the self-send applies synchronously, and its reply must not see a
        # half-filled pending set (it would commit after the local apply
        # alone, racing the remote shards).
        sends: list[tuple[int, MOSDECSubOpWrite]] = []
        for s in range(self.n):
            osd = acting[s] if s < len(acting) else PG_NONE
            if osd == PG_NONE:
                continue
            op.pending_commits.add(s)
            sends.append(
                (
                    osd,
                    MOSDECSubOpWrite(
                        pgid=self.listener.pgid.with_shard(s),
                        from_osd=self.listener.whoami(),
                        tid=op.tid,
                        reqid=op.reqid,
                        txn=txns[s].tobytes(),
                        at_version=op.version.version,
                        log_entries=log_bytes,
                    ),
                )
            )
            op.sub_writes[s] = sends[-1]
        op.trace.event(f"sub-writes dispatched to {len(sends)} shards")
        for osd, msg in sends:
            self.listener.send_shard(osd, msg)
        # Unblock readers that were waiting on our pin.
        self._kick_waiting_reads()

    def _fail_encoded_op(self, op: Op, err: EcError, what: str = "encode launch") -> None:
        """Fail an op whose LAUNCHED encode could not be materialized.

        Unlike the RMW-read failure path (where later same-object ops are
        necessarily still un-encoded), by reap time later ops may have
        ALREADY encoded — against projected state embedding this op's
        bytes (their merges read our pin).  Letting one of those commit
        would persist a write the client was told failed, so the abort
        dooms every later same-object op that has not yet dispatched its
        sub-writes, encoded or not.  Negative errno, matching the
        read-failure convention."""
        oid = op.pgt.oid
        errno = -abs(err.errno or EIO)
        doomed = [op] + [
            o
            for o in list(self.in_flight.values()) + self.waiting_reads
            if o.pgt.oid == oid and o.tid > op.tid and not o.sub_writes
        ]
        for o in doomed:
            self.in_flight.pop(o.tid, None)
        self.waiting_reads = [o for o in self.waiting_reads if o not in doomed]
        self._encode_pipe = [o for o in self._encode_pipe if o not in doomed]
        # Projected state: earlier same-object ops may be DISPATCHED but
        # uncommitted — dropping the projection entirely would let the
        # next write plan against the stale on-disk size while their
        # commits are still landing.  Roll the projection back to the
        # newest survivor's planned state (its reap already set the hinfo
        # chain); only a survivor-free object resets to disk.
        proj = self._projected.get(oid)
        if proj is not None:
            proj["refs"] -= len(doomed)
            survivors = [
                o for o in self.in_flight.values() if o.pgt.oid == oid
            ]
            if proj["refs"] <= 0 or not survivors:
                self._projected.pop(oid, None)
            else:
                proj["size"] = max(survivors, key=lambda o: o.tid).plan.new_size
        self.listener.clog_error(
            f"{self.listener.pgid}: {what} for {oid} failed ({errno}); "
            f"aborting {len(doomed)} queued write(s)"
        )
        for o in doomed:
            if o.pin is not None:
                self.extent_cache.release_pin(o.pin)
                o.pin = None
            o.encode_stage = None
            o.trace.event(f"aborted: {what} failed ({errno})")
            o.trace.finish()
            if o.on_failure is not None:
                o.on_failure(errno)
        # a delta-path op already committed data + parity into the device
        # cache at its (now never-to-commit) generation: drop them — stale
        # generations would miss anyway, but the bytes are dead
        if any(o.delta for o in doomed):
            cache = self._chunk_cache()
            if cache is not None:
                cache.invalidate_object(self._cache_obj(oid))
        self._kick_waiting_reads()

    def _kick_waiting_reads(self) -> None:
        ready = [op for op in self.waiting_reads if not self._blocked_by_earlier(op)]
        self.waiting_reads = [op for op in self.waiting_reads if op not in ready]
        for op in ready:
            if op.plan.to_read:
                self._issue_rmw_reads(op)
            else:
                self._encode_and_dispatch(op)

    def handle_sub_write(self, msg: MOSDECSubOpWrite) -> None:
        """Shard-side apply (ECBackend.cc:945): transaction + log append.

        A store whose checksum or compressor launch failed (or was
        refused while DEGRADED) raises EcError(EIO) and has committed
        nothing (ROADMAP fault C8): the shard appends no log entry,
        replies committed=False and fences the object.  A fenced shard
        refuses every later sub-write for the object until the failed one
        comes again and commits, or the primary abandons it (an empty
        transaction under its tid), so it never applies a later write
        beneath an earlier one.  The reference recomputes on the host and
        never gets here."""
        txn = Transaction.frombytes(msg.txn)
        if msg.log_entries:
            oid = LogEntry.frombytes(msg.log_entries[0]).oid
        else:
            oid = next(
                (o for o, t in self._sub_write_fences.items() if t == msg.tid), None
            )
        fence = self._sub_write_fences.get(oid)
        committed = False
        if fence is not None and fence != msg.tid:
            self.listener.clog_error(
                f"{msg.pgid}: sub-write tid {msg.tid} for {oid} refused: "
                f"tid {fence} failed before it"
            )
        else:
            try:
                self.store.queue_transaction(txn)
            except EcError as e:
                self.listener.clog_error(
                    f"{msg.pgid}: sub-write tid {msg.tid} failed: {e}"
                )
                if oid is not None:
                    self._sub_write_fences[oid] = msg.tid
            else:
                for raw in msg.log_entries:
                    self.listener.append_log(LogEntry.frombytes(raw))
                committed = True
                if fence is not None:
                    del self._sub_write_fences[oid]
        reply = MOSDECSubOpWriteReply(
            pgid=msg.pgid,
            from_osd=self.listener.whoami(),
            tid=msg.tid,
            committed=committed,
        )
        self.listener.send_shard(msg.from_osd, reply)

    def handle_sub_write_reply(self, msg: MOSDECSubOpWriteReply) -> None:
        op = self.in_flight.get(msg.tid)
        if op is None:
            return
        s = msg.pgid.shard
        op.pending_commits.discard(s)
        if msg.committed:
            op.committed_shards.add(s)
            op.torn_shards.discard(s)
            op.trace.event(f"commit from shard {s}")
        else:
            # fault C8: the shard's store failed the sub-write with EIO
            op.failed_shards.add(s)
            op.torn_shards.add(s)
            op.trace.event(f"sub-write failed on shard {s}")
        if op.pending_commits:
            return
        if op.failed_shards:
            failed = ",".join(map(str, sorted(op.failed_shards)))
            if op.committed_shards:
                # partly applied: it rolls forward (retry_failed_sub_writes)
                self.listener.clog_error(
                    f"{self.listener.pgid}: sub-write for {op.pgt.oid} tid "
                    f"{op.tid} failed on shards {failed}; re-sending once the "
                    "device is healthy"
                )
                return
            # applied nowhere: abandon it with EIO and lift the fences
            for f in sorted(op.failed_shards):
                osd, sent = op.sub_writes[f]
                self.listener.send_shard(
                    osd,
                    MOSDECSubOpWrite(
                        pgid=sent.pgid,
                        from_osd=sent.from_osd,
                        tid=sent.tid,
                        reqid=sent.reqid,
                        txn=Transaction().tobytes(),
                        at_version=sent.at_version,
                        log_entries=[],
                    ),
                )
            self._fail_encoded_op(
                op, EcError(EIO, f"shards {failed} failed the sub-write"),
                what=f"sub-write on shards {failed}",
            )
            return
        del self.in_flight[op.tid]
        if op.pin is not None:
            self.extent_cache.release_pin(op.pin)
        self._unref_projected(op.pgt.oid)
        self._kick_waiting_reads()
        op.trace.event("all shards committed")
        op.trace.finish()
        op.on_commit()

    def retry_failed_sub_writes(self) -> int:
        """Send a partly applied write's failed sub-writes again (fault C8).

        A write that one shard's store failed after another shard
        committed it cannot fail cleanly: the PG log's rollback is not
        ported (ROADMAP A9), and the committed shards hold its bytes.  So
        it rolls forward.  Once all its replies are in and the device
        guard is healthy (a rate-limited probe heals it), each failed
        shard is sent its sub-write again, oldest write first; the write
        commits when every shard has.  Until then reads skip the failed
        shards (`_available_shards`), so no read decodes two versions
        together.  Runs at every `flush_encodes`; returns the number of
        sub-writes sent again."""
        ops = sorted(
            (o for o in self.in_flight.values()
             if o.failed_shards and not o.pending_commits),
            key=lambda o: o.tid,
        )
        if not ops:
            return 0
        from ..ops.guard import device_guard

        if not device_guard().maybe_probe():
            return 0
        sends = []
        for op in ops:
            shards = sorted(op.failed_shards)
            op.trace.event(f"re-sending sub-writes to shards {shards}")
            op.pending_commits.update(shards)
            op.failed_shards.clear()
            sends += [op.sub_writes[s] for s in shards]
        self.sub_write_retries += len(sends)
        for osd, msg in sends:
            self.listener.send_shard(osd, msg)
        return len(sends)

    # -- read path (§3.1 reads / §3.2 gather) --------------------------------

    def objects_read_and_reconstruct(
        self,
        reads: Mapping[str, list[tuple[int, int]]],
        on_complete: Callable[[dict], None],
        fast_read: bool | None = None,
        want_attrs: bool = False,
        on_complete_raw: Callable[[ReadOp, set[int]], None] | None = None,
        want_shards: set[int] | None = None,
        parent_span=None,
        cache_generations: Mapping | None = None,
    ) -> None:
        """Client/RMW/recovery reads with reconstruction
        (ECBackend.cc:2389).  on_complete receives
        {oid: (errno, [bytes per requested extent])}; recovery passes
        on_complete_raw to consume the gathered shard streams directly.
        `cache_generations` overrides the device-cache generation of an
        object (the RMW read leg's pre-write generation)."""
        fast = self.fast_read if fast_read is None else fast_read
        tid = self._next_tid()
        requests: dict[str, ReadRequest] = {}
        for oid, extents in reads.items():
            ranges = [
                self.sinfo.offset_len_to_stripe_bounds(off, ln) for off, ln in extents
            ]
            requests[oid] = ReadRequest(
                to_read=list(extents),
                stripe_ranges=_merge_ranges(ranges),
                want_attrs=want_attrs,
            )
        # minimum shard set over all objects (get_min_avail_to_read_shards)
        avail = set.intersection(*(self._available_shards(o) for o in reads))
        chunk_index = getattr(self.ec, "chunk_index", lambda i: i)
        want = (
            want_shards
            if want_shards is not None
            else {chunk_index(i) for i in range(self.k)}
        )
        trace = self._span("ec:read", parent=parent_span)
        trace.keyval("oids", lambda: ",".join(sorted(reads)))
        trace.keyval("tid", tid)
        try:
            minimum = self.ec.minimum_to_decode(want, avail)
        except EcError:
            trace.event("not decodable from available shards")
            trace.finish()
            on_complete({oid: (-EIO, []) for oid in reads})
            return
        sub_count = self.ec.get_sub_chunk_count()
        sources = set(minimum)
        if fast:
            sources = set(avail)  # redundant reads, first k win (ECBackend.h:371)
        rop = ReadOp(
            tid=tid,
            requests=requests,
            want=want,
            sources={},
            subchunks={s: list(minimum.get(s, [(0, sub_count)])) for s in sources},
            on_complete=on_complete,
            on_complete_raw=on_complete_raw,
            trace=trace,
            cache_generations=dict(cache_generations or {}),
        )
        self.read_ops[tid] = rop
        self._send_reads(rop, sources)

    def _send_reads(self, rop: ReadOp, shards: set[int]) -> None:
        sub_count = self.ec.get_sub_chunk_count()
        # Register every source before sending: the self-send replies
        # synchronously and must see the complete source set, or the
        # completion check runs against a partial plan.
        sends: list[tuple[int, MOSDECSubOpRead]] = []
        oids = list(rop.requests)
        for s in shards:
            osd = self._shard_source(s, oids)
            rop.sources[s] = osd
            rop.tried.add(s)
            to_read: dict[str, list[list[int]]] = {}
            for oid, req in rop.requests.items():
                exts = []
                for off, ln in req.stripe_ranges:
                    c_off, c_len = self._logical_range_to_chunk_extent(off, ln)
                    exts.append([c_off, c_len])
                to_read[oid] = exts
            runs = rop.subchunks.get(s, [(0, sub_count)])
            sends.append(
                (
                    osd,
                    MOSDECSubOpRead(
                        pgid=self.listener.pgid.with_shard(s),
                        from_osd=self.listener.whoami(),
                        tid=rop.tid,
                        to_read=to_read,
                        subchunks={
                            oid: [[o, c] for o, c in runs] for oid in rop.requests
                        },
                        attrs_to_read=(
                            list(rop.requests)
                            if any(r.want_attrs for r in rop.requests.values())
                            else []
                        ),
                    ),
                )
            )
        rop.trace.event(lambda: f"sub-reads to shards {sorted(shards)}")
        for osd, msg in sends:
            self.listener.send_shard(osd, msg)

    def _retire_rop(self, rop: ReadOp) -> None:
        """Drop a ReadOp from the in-flight table; late replies now hit
        an unknown tid and are dropped."""
        self.read_ops.pop(rop.tid, None)

    def handle_sub_read(self, msg: MOSDECSubOpRead) -> None:
        """Shard-side read (ECBackend.cc:1023-1156): extents (with CLAY
        subchunk runs) + cumulative crc verification on whole-shard reads."""
        coll = shard_coll(self.listener.pgid, msg.pgid.shard)
        buffers: dict[str, list[list[bytes]]] = {}
        attrs: dict[str, dict[str, bytes]] = {}
        errors: dict[str, int] = {}
        sub_count = self.ec.get_sub_chunk_count()
        for oid, extents in msg.to_read.items():
            runs = [tuple(r) for r in msg.subchunks.get(oid, [[0, sub_count]])]
            out: list[list[bytes]] = []
            try:
                # shard-side EIO injection (ec.sub_read): answers this
                # object with an error, driving the primary's redundant-
                # read escalation + reconstruct path
                try:
                    faultpoint("ec.sub_read")
                except Exception as e:
                    raise EcError(EIO, f"injected sub-read fault: {e}")
                shard_size = self.store.stat(coll, oid)
                for off, ln in extents:
                    ln = min(ln, max(shard_size - off, 0))
                    if runs == [(0, sub_count)]:
                        data = self.store.read(coll, oid, off, ln)
                        if off == 0 and ln == shard_size:
                            self._verify_hinfo(coll, oid, msg.pgid.shard, data)
                    else:
                        # CLAY fragmented read (ECBackend.cc:1047-1068): the
                        # subchunk runs select planes within EACH stripe's
                        # chunk of the extent
                        cs = self.sinfo.chunk_size
                        sub_sz = cs // sub_count
                        parts = []
                        for block in range(off, off + ln, cs):
                            parts.extend(
                                self.store.read(
                                    coll, oid, block + o * sub_sz, c * sub_sz
                                )
                                for o, c in runs
                            )
                        data = b"".join(parts)
                    out.append([_u64b(off), data])
                buffers[oid] = out
                if oid in msg.attrs_to_read:
                    attrs[oid] = self.store.getattrs(coll, oid)
            except (StoreError, EcError) as e:
                errors[oid] = getattr(e, "errno", -EIO)
        reply = MOSDECSubOpReadReply(
            pgid=msg.pgid,
            from_osd=self.listener.whoami(),
            tid=msg.tid,
            buffers=buffers,
            attrs=attrs,
            errors=errors,
        )
        self.listener.send_shard(msg.from_osd, reply)

    def _verify_hinfo(self, coll: str, oid: str, shard: int, data: bytes) -> None:
        try:
            hinfo = HashInfo.decode(self.store.getattr(coll, oid, HINFO_ATTR))
        except StoreError:
            return  # overwrite pool / no hinfo: crc lives off-path
        if hinfo.get_total_chunk_size() == len(data) and not hinfo.verify_chunk(shard, data):
            self.listener.clog_error(
                f"{self.listener.pgid}: shard {shard} crc mismatch on {oid}"
            )
            raise EcError(EIO, f"chunk crc mismatch on {oid} shard {shard}")

    def handle_sub_read_reply(self, msg: MOSDECSubOpReadReply) -> None:
        """Gather + decodability check + redundant-read escalation
        (ECBackend.cc:1191-1328)."""
        rop = self.read_ops.get(msg.tid)
        if rop is None:
            return  # a late reply for a completed op: reaped unread
        shard = msg.pgid.shard
        rop.trace.event(
            lambda: f"reply from shard {shard}"
            + (f" with errors {sorted(msg.errors)}" if msg.errors else "")
        )
        if msg.errors:
            rop.errors.setdefault(shard, set()).update(msg.errors)
        if msg.buffers:
            rop.replies[shard] = {
                oid: [(int.from_bytes(off, "little"), data) for off, data in exts]
                for oid, exts in msg.buffers.items()
            }
        for oid, att in msg.attrs.items():
            rop.attrs.setdefault(oid, {}).update(att)
        self._check_read_op(rop)

    def _check_read_op(self, rop: ReadOp) -> None:
        good = {
            s
            for s in rop.replies
            if not rop.errors.get(s)
        }
        sub_count = self.ec.get_sub_chunk_count()
        fragmented = any(
            [tuple(r) for r in runs] != [(0, sub_count)]
            for runs in rop.subchunks.values()
        )
        if fragmented:
            # The fragment plan (CLAY's repair planes) is fixed at issue
            # time: ALL planned helpers must answer; a failed helper voids
            # the plan and the read falls back to full-chunk reads.
            planned = set(rop.subchunks)
            if planned <= good:
                self._retire_rop(rop)
                self._complete_read_op(rop, good)
                return
            if planned - set(rop.replies) - set(rop.errors):
                return  # still outstanding
            avail = (
                set.intersection(*(self._available_shards(o) for o in rop.requests))
                - set(rop.errors)
            )
            rop.trace.event("fragment plan voided; full-chunk fallback")
            rop.replies.clear()
            rop.subchunks = {s: [(0, sub_count)] for s in avail}
            self._send_reads(rop, avail)
            return
        needed = set(self.ec.minimum_to_decode(rop.want, good)) if self._decodable(rop.want, good) else None
        if needed is not None and needed <= good:
            self._retire_rop(rop)
            self._complete_read_op(rop, good)
            return
        # not yet decodable: have all asked shards answered?
        outstanding = set(rop.sources) - set(rop.replies) - set(rop.errors)
        if outstanding:
            return
        # escalate: ask shards not yet tried (send_all_remaining_reads)
        remaining = (
            set.intersection(*(self._available_shards(o) for o in rop.requests))
            - rop.tried
        )
        if remaining:
            rop.trace.event(
                f"redundant-read escalation to shards {sorted(remaining)}"
            )
            for s in remaining:
                rop.subchunks[s] = [(0, sub_count)]
            self._send_reads(rop, remaining)
            return
        self._retire_rop(rop)
        rop.trace.event("read failed: no decodable shard set")
        rop.trace.finish()
        rop.on_complete({oid: (-EIO, []) for oid in rop.requests})

    def _decodable(self, want: set[int], have: set[int]) -> bool:
        try:
            self.ec.minimum_to_decode(want, have)
            return True
        except EcError:
            return False

    def _complete_read_op(self, rop: ReadOp, good: set[int]) -> None:
        if rop.on_complete_raw is not None:
            rop.trace.event("raw shard streams handed to recovery")
            rop.trace.finish()
            rop.on_complete_raw(rop, good)
            return
        results: dict[str, tuple[int, list[bytes]]] = {}

        def reconstruct_all() -> None:
            # Two-phase: SUBMIT every object's decode as a ticket first,
            # then materialize.  With the decode window open (window > 1)
            # same-pattern objects in this ReadOp land in one aggregation
            # group and the first materialization reaps it as one padded
            # launch; at the default window (<= 1, immediate mode) each
            # submission dispatches on its own, exactly like the direct
            # path always did.
            launched: dict[str, list] = {}
            for oid, req in rop.requests.items():
                try:
                    launched[oid] = self._launch_reconstruct(rop, oid, req, good)
                except EcError as e:
                    results[oid] = (e.errno, [])
            for oid, pends in launched.items():
                try:
                    results[oid] = (0, self._finish_reconstruct(pends))
                except EcError as e:
                    results[oid] = (e.errno, [])

        if not rop.want <= good:
            t0 = time.monotonic()
            # decode path: spans make the degraded read visible end to end
            with rop.trace.child("ec:reconstruct") as sp:
                sp.keyval("have", ",".join(map(str, sorted(good))))
                sp.keyval("want", ",".join(map(str, sorted(rop.want))))
                with tracer_mod.span_scope(sp):
                    reconstruct_all()
            self._perf_hist("ec_decode_latency", time.monotonic() - t0)
        else:
            with tracer_mod.span_scope(rop.trace):
                reconstruct_all()
        rop.trace.event("read complete")
        rop.trace.finish()
        rop.on_complete(results)

    def _launch_reconstruct(
        self, rop: ReadOp, oid: str, req: ReadRequest, good: set[int]
    ) -> list[tuple[int, int, int, "stripe_mod.PendingDecode"]]:
        """SUBMIT one object's extent decodes (tickets via the shared
        DecodeAggregator) without materializing — phase one of the
        reconstruct, so concurrent objects coalesce into one launch.

        Device-cache consult: the decode launcher checks the chunk cache
        for the missing chunks FIRST — a repeated degraded read (or the
        read leg of a degraded RMW cycle, which flows through the same
        path) of an unchanged object serves from the device with one D2H
        copy, skipping the survivor H2D and the kernel entirely; a miss
        caches its reconstruction for next time."""
        cache = self._chunk_cache()
        if cache is None:
            gen = None
        elif oid in rop.cache_generations:
            # RMW read leg: the submit-time pre-write generation (our own
            # projection would make _cache_generation return None)
            gen = rop.cache_generations[oid]
        else:
            gen = self._cache_generation(oid)
        out = []
        for off, ln in req.to_read:
            s_off, s_len = self.sinfo.offset_len_to_stripe_bounds(off, ln)
            c_off, c_len = self._logical_range_to_chunk_extent(s_off, s_len)
            shards: dict[int, np.ndarray] = {}
            for s in good:
                per_oid = rop.replies.get(s, {}).get(oid)
                if per_oid is None:
                    continue
                buf = self._extract(per_oid, c_off, c_len)
                if buf is not None:
                    shards[s] = np.frombuffer(buf, dtype=np.uint8)
            if not self._decodable(set(range(self.k)), set(shards)):
                # drain this object's already-submitted extents: an
                # abandoned ticket would otherwise ride its group to the
                # next flush as device work nobody materializes
                for *_rest, pend in out:
                    try:
                        pend.result()
                    except EcError:
                        pass
                raise EcError(EIO, f"cannot reconstruct {oid}")
            pend = stripe_mod.decode_concat_launch(
                self.sinfo, self.ec, shards, aggregator=self.decode_aggregator,
                chunk_cache=cache,
                cache_key=(self._cache_obj(oid), gen),
                cache_off=c_off,
            )
            out.append((off, ln, s_off, pend))
        return out

    def _finish_reconstruct(self, launched) -> list[bytes]:
        """Materialize phase-one tickets into the requested extents."""
        out: list[bytes] = []
        for off, ln, s_off, pend in launched:
            logical = pend.result()
            lo = off - s_off
            out.append(logical[lo : lo + ln].tobytes())
        return out

    @staticmethod
    def _extract(extents: list[tuple[int, bytes]], off: int, length: int) -> bytes | None:
        for e_off, data in extents:
            if e_off <= off and off + length <= e_off + len(data):
                return bytes(data[off - e_off : off - e_off + length])
            if e_off == off:  # short read at EOF
                return bytes(data)
        return None

    # -- recovery --------------------------------------------------------------

    def recovery_inflight(self) -> dict[str, int]:
        """Recovery-pipeline depth for the PG's progress event: how many
        objects are mid-recovery and how many of those are parked on the
        decode pipeline awaiting an (aggregated) launch reap, so a stall
        inside the DECODING stage is distinguishable from an idle PG."""
        return {
            "recovering": len(self.recovery_ops),
            "decoding": len(self._decode_pipe),
        }

    def recover_object(
        self, oid: str, missing_on: set[int], on_complete: Callable[[int], None]
    ) -> None:
        """Primary-only: rebuild `missing_on` shards (run_recovery_op)."""
        rec = RecoveryOp(
            oid=oid,
            missing_on=set(missing_on),
            on_complete=on_complete,
            trace=self._span("ec:recover"),
        )
        rec.trace.keyval("oid", oid)
        rec.trace.keyval("missing_on", ",".join(map(str, sorted(missing_on))))
        self.recovery_ops[oid] = rec
        self._continue_recovery(rec)

    def _continue_recovery(self, rec: RecoveryOp) -> None:
        """continue_recovery_op (ECBackend.cc:591-746), plus the DECODING
        stage: reaping a launched (possibly aggregated) device decode and
        fanning out the pushes."""
        if rec.state == RECOVERY_DECODING:
            self._finish_recovery_decode(rec)
            return
        if rec.state == RECOVERY_IDLE:
            rec.state = RECOVERY_READING
            avail = self._available_shards(rec.oid)
            want = set(rec.missing_on)

            rec.trace.event("gather surviving shards")

            def _on_fail(results: dict) -> None:
                err, _ = results[rec.oid]
                del self.recovery_ops[rec.oid]
                rec.trace.event(f"recovery read failed ({err})")
                rec.trace.finish()
                rec.on_complete(err or -EIO)

            self.objects_read_and_reconstruct(
                {rec.oid: [(0, self._recovery_extent(rec.oid, avail))]},
                _on_fail,
                want_attrs=True,
                on_complete_raw=lambda rop, good: self._handle_recovery_read_complete(
                    rec, rop
                ),
                want_shards=want,
                fast_read=False,
                parent_span=rec.trace,
            )

    def _recovery_extent(self, oid: str, avail: set[int]) -> int:
        """Logical length covering the whole object (stripe-aligned)."""
        oi = self.get_object_info(oid)
        if oi is not None:
            return self.sinfo.logical_to_next_stripe_offset(oi.size)
        # primary itself missing: size discovered from survivor attrs later.
        # A survivor shard hosted locally (co-located collections) gives the
        # exact extent...
        for s in sorted(avail):
            coll = shard_coll(self.listener.pgid, s)
            try:
                return self.sinfo.aligned_chunk_offset_to_logical_offset(
                    self.store.stat(coll, oid)
                )
            except StoreError:
                continue
        # ...otherwise over-ask: shard-side reads clamp to the actual
        # shard size (handle_sub_read), so a generous stripe-aligned cover
        # recovers the WHOLE object instead of truncating it to one stripe
        # (multi-stripe objects whose primary lost its shard).
        return self.sinfo.logical_to_next_stripe_offset(1 << 30)

    def _handle_recovery_read_complete(self, rec: RecoveryOp, rop: ReadOp) -> None:
        """LAUNCH the decode of the missing shards (ECBackend.cc:435-501).

        The bulk matrix path submits the decode to the shared
        DecodeAggregator as a ticket and parks the RecoveryOp on the decode
        pipeline (state DECODING) instead of blocking: concurrent objects
        with the same erasure pattern share one padded launch, and the
        pushes fan out at the reap (_finish_recovery_decode).  A failed
        launch fails the recovery with -EIO there, with nothing pushed.
        CLAY's fragmented path is one batched (stripes, ...) launch
        already and completes inline."""
        sub_count = self.ec.get_sub_chunk_count()
        have: dict[int, np.ndarray] = {}
        fragmented = False
        for s, per_oid in rop.replies.items():
            exts = per_oid.get(rec.oid)
            if not exts or rop.errors.get(s):
                continue
            if len(exts) == 1:
                # common whole-shard single-extent reply: wrap the payload
                # zero-copy (np.stack in the decode gather pays the one
                # unavoidable copy)
                have[s] = np.frombuffer(exts[0][1], dtype=np.uint8)
            else:
                buf = b"".join(data for _off, data in exts)
                have[s] = np.frombuffer(buf, dtype=np.uint8)
            runs = [tuple(r) for r in rop.subchunks.get(s, [(0, sub_count)])]
            if runs != [(0, sub_count)]:
                fragmented = True
        rec.attrs = rop.attrs.get(rec.oid, {})
        want = set(rec.missing_on)
        t0 = time.monotonic()
        try:
            if fragmented:
                rebuilt = self._decode_fragmented(rec, have, want)
            else:
                cache = self._chunk_cache()
                gen = (
                    self._cache_generation(rec.oid)
                    if cache is not None else None
                )
                with tracer_mod.span_scope(rec.trace):
                    rec.pending_decode = stripe_mod.decode_shards_launch(
                        self.sinfo, self.ec, have, want,
                        aggregator=self.decode_aggregator,
                        chunk_cache=cache,
                        cache_key=(self._cache_obj(rec.oid), gen),
                    )
                rec.decode_t0 = t0
                rec.state = RECOVERY_DECODING
                rec.trace.event("decode launched")
                self._decode_pipe.append(rec)
                # Backpressure: past the window, reap the head (blocking).
                while len(self._decode_pipe) > self.decode_depth:
                    self._finish_recovery_decode(self._decode_pipe[0])
                self._schedule_decode_drain()
                return
            self._perf_hist("ec_decode_latency", time.monotonic() - t0)
        except (EcError, KeyError) as e:
            del self.recovery_ops[rec.oid]
            rec.trace.event(f"decode failed ({e})")
            rec.trace.finish()
            rec.on_complete(getattr(e, "errno", -EIO))
            return
        rec.shard_data = rebuilt
        self._push_recovered(rec)

    def _decode_fragmented(
        self, rec: RecoveryOp, have: dict[int, np.ndarray], want: set[int]
    ) -> dict[int, bytes]:
        """CLAY repair: helpers supplied, per stripe's chunk, the
        concatenated repair-plane fragments; rebuild with the true chunk
        size in ONE batched (stripes, helpers, fragment) launch a score
        round (`decode_fragments_batch`).  The read plan came from the
        codec's repair plan, so `is_repair` holds for the helpers that
        answered; it is tested first all the same, and fragments that do
        not form a repair plan fail the recovery with EIO.  An error
        inside the batch — a failed launch raises EIO — fails it too: there
        is no second attempt on another path (the JAX package falls back
        to a per-stripe loop on any EcError)."""
        cs = self.sinfo.chunk_size
        stripes = self._full_shard_len(rec) // cs
        if not (
            stripes > 0
            and all(arr.size % stripes == 0 for arr in have.values())
            and self.ec.is_repair(want, set(have))
        ):
            raise EcError(EIO, f"fragment reads of {rec.oid} do not form a repair plan")
        frags = {s: arr.reshape(stripes, arr.size // stripes) for s, arr in have.items()}
        with tracer_mod.span_scope(rec.trace):
            decoded = self.ec.decode_fragments_batch(want, frags, cs)
        return {s: np.ascontiguousarray(decoded[s]).tobytes() for s in want}

    def _finish_recovery_decode(self, rec: RecoveryOp) -> None:
        """Reap one launched recovery decode and fan out its pushes (the
        completion half of the DECODING stage).  A failed (aggregated)
        launch surfaces here, at the op that owns the ticket: the recovery
        completes with its errno (-EIO) and nothing is pushed."""
        if rec in self._decode_pipe:
            self._decode_pipe.remove(rec)
        want = set(rec.missing_on)
        try:
            with tracer_mod.span_scope(rec.trace):
                decoded = rec.pending_decode.result()
            rebuilt = {s: np.asarray(decoded[s]).tobytes() for s in want}
        except (EcError, KeyError) as e:
            del self.recovery_ops[rec.oid]
            rec.pending_decode = None
            rec.trace.event(f"decode failed ({e})")
            rec.trace.finish()
            rec.on_complete(getattr(e, "errno", -EIO))
            return
        rec.pending_decode = None
        if rec.decode_t0:
            self._perf_hist("ec_decode_latency", time.monotonic() - rec.decode_t0)
        rec.shard_data = rebuilt
        self._push_recovered(rec)

    def _schedule_decode_drain(self) -> None:
        """Reap finished recovery decodes from a running event loop;
        without one (synchronous harnesses) the barrier drains via
        flush_decodes()."""
        if not self._decode_pipe:
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return
        loop.call_soon(self._drain_decode_pipe)

    def _drain_decode_pipe(self) -> None:
        """Push out every RecoveryOp whose decode finished, strictly FIFO.
        A head still windowed/computing gets the same re-poll grace as the
        encode pipe (~100 ms for same-pattern co-riders to arrive), then
        the window is drained — no amount of polling launches a windowed
        decode."""
        while self._decode_pipe:
            rec = self._decode_pipe[0]
            pend = rec.pending_decode
            if not pend.launched() and rec.decode_polls >= 50:
                self.decode_aggregator.flush()
            if not pend.ready() and rec.decode_polls < 50:
                rec.decode_polls += 1
                try:
                    asyncio.get_running_loop().call_later(
                        0.002, self._drain_decode_pipe
                    )
                except RuntimeError:
                    pass
                return
            self._finish_recovery_decode(rec)

    def _push_msg(self, rec: RecoveryOp, s: int, version: int) -> MOSDPGPush:
        return MOSDPGPush(
            pgid=self.listener.pgid.with_shard(s),
            pushes=[PushOp(
                oid=rec.oid,
                data=rec.shard_data[s],
                attrs=dict(rec.attrs),
                version=version,
            )],
            epoch=self.listener.epoch(),
            from_osd=self.listener.whoami(),
        )

    def _recovered_version(self, rec: RecoveryOp) -> int:
        if OI_ATTR in rec.attrs:
            return ObjectInfo.decode(rec.attrs[OI_ATTR]).version
        return 0

    def _push_recovered(self, rec: RecoveryOp) -> None:
        """Fan out PushOps for the rebuilt shards (the WRITING stage)."""
        want = set(rec.missing_on)
        rebuilt = rec.shard_data
        rec.state = RECOVERY_WRITING
        rec.trace.event(f"decoded; pushing to shards {sorted(want)}")
        # progress accounting: the reconstructed bytes are the honest
        # "bytes done" figure the PG folds into its progress event
        note = getattr(self.listener, "note_recovery_bytes", None)
        if note is not None:
            note(rec.oid, sum(len(v) for v in rebuilt.values()))
        acting = self.listener.acting()
        version = self._recovered_version(rec)
        # Register all pending pushes before sending any: a push to our own
        # shard replies synchronously and must not observe a partial set.
        sends: list[tuple[int, MOSDPGPush]] = []
        for s in sorted(want):
            osd = acting[s] if s < len(acting) else PG_NONE
            if osd == PG_NONE:
                continue
            rec.pending_pushes.add(s)
            sends.append((osd, self._push_msg(rec, s, version)))
        if not sends:
            self._finish_recovery(rec)
            return
        rec.push_ts = time.monotonic()
        for osd, msg in sends:
            self.listener.send_shard(osd, msg)

    def retry_stalled_pushes(self, grace: float) -> int:
        """Re-send pending PushOps older than `grace` seconds (tick-driven
        from the PG).  A push the target dropped — a dying daemon, the
        `ec.recover_push` fault point — would otherwise park its RecoveryOp
        in WRITING forever.  Re-applying a push the target DID land is
        idempotent (same rebuilt bytes, same attrs), and a late first
        reply just empties pending_pushes before the duplicate's reply is
        ignored.  Returns the number of ops retried."""
        if grace <= 0:
            return 0
        now = time.monotonic()
        retried = 0
        acting = self.listener.acting()
        for rec in list(self.recovery_ops.values()):
            if (
                rec.state != RECOVERY_WRITING
                or not rec.pending_pushes
                or not rec.push_ts
                or now - rec.push_ts < grace
            ):
                continue
            version = self._recovered_version(rec)
            rec.push_ts = now
            rec.push_retries += 1
            self.push_retries += 1
            retried += 1
            rec.trace.event(
                lambda rec=rec: "retrying stalled pushes to shards "
                f"{sorted(rec.pending_pushes)}"
            )
            for s in sorted(rec.pending_pushes):
                osd = acting[s] if s < len(acting) else PG_NONE
                if osd == PG_NONE:
                    continue
                self.listener.send_shard(osd, self._push_msg(rec, s, version))
        return retried

    def _full_shard_len(self, rec: RecoveryOp) -> int:
        """True (unfragmented) shard length for CLAY repair decode."""
        oi_blob = rec.attrs.get(OI_ATTR)
        if oi_blob is not None:
            size = ObjectInfo.decode(oi_blob).size
            return self.sinfo.logical_to_next_chunk_offset(size)
        raise EcError(EIO, f"no object info for {rec.oid}")

    def handle_recovery_push(self, msg: MOSDPGPush) -> None:
        """Target shard writes the pushed chunk (the WRITING stage).  The
        `ec.recover_push` fault point drops the push on the floor — no
        apply, no reply — as a target dying mid-delivery would; the
        primary's retry_stalled_pushes re-sends it."""
        try:
            faultpoint("ec.recover_push")
        except InjectedFailure as e:
            dout("ec", 1, f"{self.listener.pgid}: dropping injected-fault "
                          f"recovery push for {msg.pgid} ({e})")
            return
        coll = shard_coll(self.listener.pgid, msg.pgid.shard)
        oids = self._apply_pushes(coll, msg.pushes)
        reply = MOSDPGPushReply(
            pgid=msg.pgid,
            oids=oids,
            epoch=self.listener.epoch(),
            from_osd=self.listener.whoami(),
        )
        self.listener.send_shard(msg.from_osd, reply)

    def handle_recovery_push_reply(self, msg: MOSDPGPushReply) -> None:
        for oid in msg.oids:
            rec = self.recovery_ops.get(oid)
            if rec is None:
                continue
            rec.pending_pushes.discard(msg.pgid.shard)
            if not rec.pending_pushes:
                self._finish_recovery(rec)

    def _finish_recovery(self, rec: RecoveryOp) -> None:
        rec.state = RECOVERY_COMPLETE
        del self.recovery_ops[rec.oid]
        rec.trace.event("all pushes acked; recovered")
        rec.trace.finish()
        self.listener.on_global_recover(rec.oid)
        rec.on_complete(0)

    # -- scrub support ---------------------------------------------------------

    def scan_shard(self, shard: int) -> dict[str, dict]:
        """Deep-scrub scan: per-object size + crc32c of the local chunk
        (be_deep_scrub analog, ECBackend.cc:2518)."""
        coll = shard_coll(self.listener.pgid, shard)
        out: dict[str, dict] = {}
        try:
            oids = self.store.list_objects(coll)
        except StoreError:
            return out
        for oid in oids:
            data = self.store.read(coll, oid, 0, 0)
            hinfo = None
            try:
                hinfo = HashInfo.decode(self.store.getattr(coll, oid, HINFO_ATTR))
            except StoreError:
                pass
            digest = crc32c.crc32c(data, HashInfo.SEED)
            entry = {"size": len(data), "digest": digest}
            if hinfo is not None:
                entry["hinfo_digest"] = hinfo.get_chunk_hash(shard)
                entry["hinfo_size"] = hinfo.get_total_chunk_size()
            out[oid] = entry
        return out


def _u64b(v: int) -> bytes:
    return int(v).to_bytes(8, "little")

