"""PG — the placement-group execution context.

The port of `ceph_tpu/osd/pg.py`: the same op semantics, messages, log
entries and store contents, over the port's backends (`ECBackend`, whose
encode, decode, verify and delta run on the device, and
`ReplicatedBackend`).  `PG(osd, pool, ps, profiles, device=None)` makes
an EC pool's codec on `device` (None: `cuda`, which raises with no GPU).
Three paths of the JAX package's PG are not ported, and `do_op` answers
-EOPNOTSUPP for them: cache tiering (an op on a cache-tier pool) and
COPY_FROM, which need the daemon's internal objecter leg, and
watch/notify (WATCH, NOTIFY, LIST_WATCHERS), which needs the messenger's
client sessions.  What only the daemon calls comes with it: the mgr's
progress and blocked-op reports, `list_unfound` / `mark_unfound_lost`,
the stat helpers, the recovery-storm hooks and the listener hooks of
the hedged reads (`perf_inc`, `conf_get`, `note_peer_rtt`,
`laggy_peers`).  One policy differs from the JAX package's: an EC
rebuild that fails for want of sources takes the members that moved slot
this interval as holders of their old slots, and runs again (ROADMAP
C13).  The host `osd` gives `whoami`, `store`, `conf`, `osdmap`,
`send_cluster`, `local_reserver`, `perf` and `clog_error`.

Mirrors the slice of src/osd/PG.{h,cc} + PrimaryLogPG.cc that executes
client ops and drives recovery:

- `do_op` is PrimaryLogPG::do_op → execute_ctx → do_osd_ops
  (src/osd/PrimaryLogPG.cc:1978,4134,5960): the op-code
  switch over an MOSDOp's OSDOp vector, reads completing asynchronously
  through the backend's reconstructing read path, writes becoming one
  PGTransaction submitted to the PGBackend (issue_repop,
  PrimaryLogPG.cc:11387).
- Degraded-object gating is PrimaryLogPG::wait_for_degraded_object: ops
  touching an object that is missing anywhere queue until recovery
  completes, and that object's recovery is prioritized.
- The recovery driver is the OSD's recovery work-queue scaled down:
  up to `osd_recovery_max_active` objects in flight, each via
  PGBackend::recover_object.
- The PG implements PGListener — the boundary the backends (EC and
  replicated) call back through, src/osd/PGBackend.h Listener.
"""

from __future__ import annotations

import asyncio
import bisect
import time
from typing import Callable

from ..common.errs import (
    EAGAIN,
    ECANCELED,
    EDQUOT,
    EINVAL,
    ENODATA,
    ENOENT,
    EOPNOTSUPP,
)
from ..common.log import dout
from ..msg.messages import (
    MBackfillReserve,
    MOSDOp,
    MOSDOpReply,
    MOSDPGLog,
    MOSDPGNotify,
    MOSDPGQuery,
    OSDOp,
    PgId,
    ReqId,
)
from ..os.transaction import Transaction
from .ec_transaction import PGTransaction
from .osdmap import FLAG_FULL_QUOTA, PG_NONE, POOL_TYPE_ERASURE, PgPool
from .peering import PeeringState
from .pg_backend import PGListener, build_pg_backend, shard_coll
from .pg_log import Eversion, LogEntry, Missing, PGLog, PgInfo
from .snaps import SS_ATTR, WHITEOUT_ATTR, SnapSet, clone_oid
from ..cls.objclass import WR as CLS_WR, ClsError, HCtx as ClsHCtx, get_method as cls_get_method

WRITE_OPS = {
    OSDOp.WRITE,
    OSDOp.WRITEFULL,
    OSDOp.DELETE,
    OSDOp.TRUNCATE,
    OSDOp.APPEND,
    OSDOp.SETXATTR,
    OSDOp.RMXATTR,
    OSDOp.ROLLBACK,
    OSDOp.COPY_FROM,
    OSDOp.OMAPSETVALS,
    OSDOp.OMAPRMKEYS,
    OSDOp.OMAPCLEAR,
    OSDOp.ZERO,
    OSDOp.WRITESAME,
}

# Wire blobs for GETXATTRS dumps and omap ops (the copy-get attrs map,
# src/osd/PrimaryLogPG.cc do_copy_get).
from ..common.encoding import (  # noqa: E402 (module-level re-export)
    decode_kv_map as decode_attrs,
    encode_kv_map as encode_attrs,
)


def cmpxattr_ok(cur: bytes | None, want: bytes, mode: int) -> bool:
    """CEPH_OSD_CMPXATTR_OP_* byte-string comparison; a missing xattr
    compares as empty (the reference's cmpxattr on absent attrs)."""
    cur = cur if cur is not None else b""
    if mode == 1:
        return cur == want
    if mode == 2:
        return cur != want
    if mode == 3:
        return cur > want
    if mode == 4:
        return cur >= want
    if mode == 5:
        return cur < want
    if mode == 6:
        return cur <= want
    return False


def op_is_write(op: OSDOp) -> bool:
    """Write-class test honoring CALL's per-method RD/WR flags
    (PrimaryLogPG classifies CALL by the resolved method's flags)."""
    if op.op == OSDOp.CALL:
        try:
            cls_name, method = op.name.split(".", 1)
            flags, _fn = cls_get_method(cls_name, method)
        except Exception:
            # unresolvable: route through the read path, which reports
            # the precise error (-EOPNOTSUPP)
            return False
        return bool(flags & CLS_WR)
    return op.op in WRITE_OPS


def op_class_of(ops) -> str:
    """Attribution class for a whole MOSDOp: write if ANY
    sub-op writes, else read — the single source for the QoS/accounting
    classification."""
    return "write" if any(op_is_write(op) for op in ops) else "read"


class PG(PGListener):
    """One placement group hosted by an OSD (possibly one shard of it)."""

    def __init__(self, osd, pool: PgPool, ps: int, profiles: dict, device=None):
        self.osd = osd
        self.pool = pool
        self.ps = ps
        self.pgid = PgId(pool.id, ps, -1)
        self.pg_log = PGLog()
        self.info = PgInfo()
        self._acting: list[int] = []
        self._epoch = 0
        self._version = 0
        self.peering = PeeringState(
            self.pgid,
            osd.whoami,
            self.pg_log,
            self.info,
            send=self._send_peering,
            on_active=self._on_active,
            list_local_objects=self._list_local,
            drop_local_object=self._drop_local_object,
        )
        self.backend = build_pg_backend(pool, profiles, self, osd.store, device=device)
        from .scrubber import PgScrubber

        self.scrubber = PgScrubber(self)
        self.recovering: set[str] = set()
        self.waiting_for_degraded: dict[str, list[Callable[[], None]]] = {}
        # stray shard sources: EC shard identity is
        # POSITIONAL (acting index -> shard coll), and CRUSH slot-fill
        # after an out can reshuffle survivors' slots.  `_shard_holders`
        # remembers, per slot, who held its data at the last CLEAN tick
        # — the stray whose old coll still has valid chunks while the
        # new member rebuilds; `_moved_members` records, per interval,
        # members whose slot changed (their local chunks sit under the
        # wrong coll, so activation marks their objects missing).
        self._shard_holders: dict[int, int] = {}
        self._moved_members: dict[int, int] = {}  # osd -> old shard
        self._move_holders: dict[int, int] = {}  # old shard -> moved osd
        # backfill driver state (PeeringState Backfilling/WaitRemote states)
        self._bf_granted: set[int] = set()  # targets that granted a slot
        self._bf_inflight: set[str] = set()  # oids being pushed this chunk
        self._bf_failed: set[str] = set()  # pushes that errored this chunk
        self._bf_chunk_targets: dict[int, list[str]] = {}
        self._bf_local_reserved = False
        self._bf_gen = 0  # bumped on interval change; stales out callbacks
        self._colls_made: set[str] = set()
        # Completed write results by reqid (PrimaryLogPG's dup-op check
        # against the pg log's reqid index): a client resend after a lost
        # reply must get the original result, not a second execution.
        self._reqid_results: dict[tuple[str, int], MOSDOpReply] = {}
        self._inflight_reqids: dict[tuple[str, int], list] = {}

    # -- interval / peering ----------------------------------------------------

    def on_new_interval(self, epoch: int, acting: list[int]) -> None:
        """OSDMap advance (PG::handle_advance_map).  Re-peering only
        happens when the *interval* changed — i.e. the acting set moved
        (PastIntervals::is_new_interval); unrelated epoch bumps (another
        pool created, another OSD booting) must not bounce an active PG
        back through GetInfo."""
        interval_changed = acting != self._acting or self._epoch == 0
        self._epoch = epoch
        if not interval_changed:
            return
        # positional shard moves: a surviving member placed
        # at a DIFFERENT slot holds its chunks under the old shard coll
        # — wrong bytes for the new slot.  Remember the moves; every
        # activation of this interval marks those members' objects
        # missing (rebuild at the new slot), while _shard_holders keeps
        # redirecting reconstruction reads at the old slot-holder's
        # still-valid stray chunks.
        self._moved_members = {}
        self._move_holders = {}
        if self.pool.type == POOL_TYPE_ERASURE and self._acting:
            for s, osd in enumerate(acting):
                if osd == PG_NONE or osd not in self._acting:
                    continue
                old = self._acting.index(osd)
                if old != s:
                    self._moved_members[osd] = old
        self._acting = list(acting)
        self._ensure_local_coll()
        self.scrubber.reset()  # an interval change aborts in-flight scrubs
        self._reset_backfill()  # reservations do not survive an interval
        # in-flight recoveries die with the interval (the reference's
        # on_change cancels them): a push sent to a member that went
        # down mid-interval would otherwise pin its oid in `recovering`
        # forever — re-peering recomputes the missing sets and the next
        # tick re-admits whatever still needs rebuilding
        self.recovering.clear()
        self.peering.start_peering_interval(epoch, acting)

    def tick(self) -> None:
        """Periodic liveness: retry stuck peering, keep recovery moving,
        abort scrubs whose shard died."""
        self.peering.tick()
        self.scrubber.tick(time.monotonic())
        if (
            self.pool.type == POOL_TYPE_ERASURE
            and self.peering.is_active()
            and self.is_clean
        ):
            # last-clean shard-holder snapshot: while the PG
            # is clean every slot's data is exactly where acting says;
            # this map is what stray-shard redirection falls back to
            # after the next reshuffle
            self._shard_holders = {
                s: o for s, o in enumerate(self._acting) if o != PG_NONE
            }
        if self.peering.is_active():
            self._kick_recovery()
            self._kick_backfill()
            # stalled-push retry: a recovery push the target
            # dropped must not park its op in WRITING forever
            retry = getattr(self.backend, "retry_stalled_pushes", None)
            if retry is not None and self.peering.is_primary():
                retry(float(self.osd.conf.get("osd_recovery_push_retry_sec")))

    def _ensure_local_coll(self) -> None:
        coll = shard_coll(self.pgid, self.whoami_shard())
        if coll in self._colls_made:
            return
        if not self.osd.store.collection_exists(coll):
            self.osd.store.queue_transaction(Transaction().create_collection(coll))
        self._colls_made.add(coll)

    def _send_peering(self, osd: int, msg) -> None:
        self.osd.send_cluster(osd, msg)

    def _list_local(self) -> list[str]:
        coll = shard_coll(self.pgid, self.whoami_shard())
        try:
            return self.osd.store.list_objects(coll)
        except Exception:
            return []

    def list_heads(self) -> list[str]:
        """Client-visible head objects (snap clones carry the reserved
        "@" separator and are internal)."""
        return [o for o in self._list_local() if "@" not in o]

    def _drop_local_object(self, oid: str) -> None:
        """Divergent-rewind hook: a stale-but-present local copy must be
        dropped so recovery PULLS the authoritative version instead of
        treating the local bytes as good (recover_object's exists() check
        would otherwise push the divergent copy back out as 'repair')."""
        coll = shard_coll(self.pgid, self.whoami_shard())
        try:
            if self.osd.store.exists(coll, oid):
                self.osd.store.queue_transaction(Transaction().remove(coll, oid))
        except Exception:
            pass

    def _on_active(self) -> None:
        self._version = max(self._version, self.pg_log.head.version)
        self._rebuild_dup_window()
        self._apply_shard_moves()
        self._kick_recovery()

    def _apply_shard_moves(self) -> None:
        """Primary activation hook: members whose shard slot
        moved this interval have every pre-interval object's chunk under
        the WRONG coll — mark those objects missing (for self and for
        peers) so recovery rebuilds them at the new slot.  The census is
        the primary's own shard coll (its OLD one if it moved itself):
        a full member's coll lists every object in the PG.

        It also notes, for each moved member whose log shows nothing
        missing and that is no backfill target, that its old coll holds
        every object's chunk of its old slot at the current version
        (`_move_holders`, adopted by `_adopt_move_holders`)."""
        if not self._moved_members or self.pool.type != POOL_TYPE_ERASURE:
            return
        p = self.peering
        for osd, old_shard in sorted(self._moved_members.items()):
            missing = p.missing if osd == self.osd.whoami else p.peer_missing.get(osd)
            if missing is not None and not missing.items and osd not in p.backfill_targets:
                self._move_holders[old_shard] = osd
        census_shard = self._moved_members.get(
            self.osd.whoami, self.whoami_shard()
        )
        if census_shard < 0:
            return
        coll = shard_coll(self.pgid, census_shard)
        try:
            oids = self.osd.store.list_objects(coll)
        except Exception as e:
            dout("osd", 2, f"pg {self.pgid}: shard-move census of {coll} "
                           f"unavailable ({e!r})")
            oids = []
        if not oids:
            # a primary with an empty coll (fresh member pulled into the
            # set) still knows the object population from the merged
            # authoritative log — walk it in order so deletes cancel
            live: set[str] = set()
            for e in self.pg_log.entries:
                if e.is_delete():
                    live.discard(e.oid)
                else:
                    live.add(e.oid)
            oids = sorted(live)
        if not oids:
            return
        v = self.pg_log.head
        for osd, old_shard in self._moved_members.items():
            dout(
                "osd", 1,
                f"pg {self.pgid}: osd.{osd} moved shard {old_shard} -> "
                f"{self._acting.index(osd)}; marking {len(oids)} objects "
                "for rebuild at the new slot",
            )
            if osd == self.osd.whoami:
                for oid in oids:
                    self.peering.missing.add(oid, v)
            else:
                m = self.peering.peer_missing.setdefault(osd, Missing())
                for oid in oids:
                    m.add(oid, v)

    def _adopt_move_holders(self) -> bool:
        """After a rebuild failed for want of sources, take the moved
        members noted at activation as the holders of their old slots
        where no last-clean holder is known; True if any was taken.

        The port's policy (ROADMAP C13): a primary that was not the last
        interval's primary has no holder table, so after an out that moves
        more members than m the reference's rebuild fails with EIO on
        every tick.  Adopting only after a failure keeps every rebuild the
        reference can do as it does it."""
        adopted = False
        for shard, osd in sorted(self._move_holders.items()):
            if shard not in self._shard_holders:
                self._shard_holders[shard] = osd
                adopted = True
        self._move_holders = {}
        return adopted

    def shard_data_source(self, shard: int, oid: str) -> int:
        """Stray-shard read sourcing (overrides the PGListener
        default): the acting member serves when placed and not missing
        the object; otherwise the slot's last-clean HOLDER — whose old
        coll still has valid chunks, because writes to missing objects
        are degraded-blocked until recovery lands — serves the
        reconstruction read."""
        if self.pool.type != POOL_TYPE_ERASURE:
            return super().shard_data_source(shard, oid)
        acting_osd = (
            self._acting[shard] if shard < len(self._acting) else PG_NONE
        )
        if acting_osd != PG_NONE and shard not in self.get_shard_missing(oid):
            return acting_osd
        holder = self._shard_holders.get(shard, PG_NONE)
        if (
            holder != PG_NONE
            and holder != acting_osd
            and self.osd.osdmap.is_up(holder)
        ):
            return holder
        return PG_NONE

    def _rebuild_dup_window(self) -> None:
        """Replay reqid dup detection from the PG log on activation.

        The in-memory dup maps die with the old primary; the Objecter's
        resend loop reuses the same tid, so without replay a non-idempotent
        op (APPEND, offset WRITE) that already committed would re-execute on
        the new primary.  The reference rebuilds dups from the pg log
        (PGLog::dups / PrimaryLogPG already-complete checks); here every
        logged write's reqid is reinstated as a completed-op reply."""
        self._reqid_results.clear()
        self._inflight_reqids.clear()
        for e in self.pg_log.entries[-1000:]:  # same bound as the live window
            if e.reqid == ("", 0):
                continue
            self._reqid_results[e.reqid] = MOSDOpReply(
                reqid=ReqId(*e.reqid),
                result=0,
                outdata=[],
                version=e.version.version,
                epoch=self._epoch,
            )

    def handle_peering_message(self, msg) -> bool:
        # peering wedge seam (peering.msg): the message is dropped
        # before the state machine sees it — a lost query/notify/log
        # mid-storm.  Self-heal is tick-driven: PeeringState.tick
        # restarts a primary stuck in GetInfo/GetLog, which re-queries.
        from ..common.fault_injector import InjectedFailure, faultpoint

        try:
            faultpoint("peering.msg")
        except InjectedFailure as e:
            dout("osd", 1, f"pg {self.pgid}: dropping injected-fault "
                           f"peering message {type(msg).__name__} ({e})")
            return True
        if isinstance(msg, MOSDPGQuery):
            self._ensure_local_coll()
            self.peering.handle_query(msg)
        elif isinstance(msg, MOSDPGNotify):
            self.peering.handle_notify(msg)
        elif isinstance(msg, MOSDPGLog):
            was_active = self.peering.is_active()
            self.peering.handle_log(msg)
            if not was_active and self.peering.is_active():
                self._version = max(self._version, self.pg_log.head.version)
        else:
            return False
        return True

    # -- PGListener ------------------------------------------------------------

    def whoami(self) -> int:
        return self.osd.whoami

    @property
    def tracer(self):
        """The daemon tracer the EC backend threads spans through
        (ECBackend.h:64-87 ZTracer::Trace parameters)."""
        t = getattr(self.osd, "tracer", None)
        if t is None:
            from ..common.tracer import NULL_TRACER

            t = NULL_TRACER
        return t

    def perf_hist(self, name: str, value: float) -> None:
        """EC stage latency -> the OSD's PerfHistogram counters
        (ec_encode_latency / ec_decode_latency)."""
        perf = getattr(self.osd, "perf", None)
        if perf is None:
            return
        try:
            perf.hinc(name, value)
        except (KeyError, AttributeError):
            pass  # harness OSD without the histogram declared

    def whoami_shard(self) -> int:
        if self.pool.type != POOL_TYPE_ERASURE:
            return -1
        if self.osd.whoami in self._acting:
            return self._acting.index(self.osd.whoami)
        return -1

    def acting(self) -> list[int]:
        return self._acting

    def epoch(self) -> int:
        return self._epoch

    def next_version(self) -> Eversion:
        self._version += 1
        return Eversion(self._epoch, self._version)

    def send_shard(self, osd: int, msg) -> None:
        if osd == self.osd.whoami:
            # the primary "sends to itself" (ECBackend.h:336-338)
            self.backend.handle_message(msg)
        else:
            self.osd.send_cluster(osd, msg)

    def append_log(self, entry: LogEntry) -> None:
        if entry.version > self.pg_log.head:
            self.pg_log.append(entry)
        self.info.last_update = self.pg_log.head
        self._version = max(self._version, entry.version.version)
        # A sub-write for an object voids any stale missing record: the
        # write pipeline only runs on recovered objects.
        self.peering.missing.rm(entry.oid)
        # Bounded log (PGLog::trim, osd_min/max_pg_log_entries): every
        # shard trims identically since all apply the same entries.  A
        # down OSD whose head falls behind the trimmed tail can no longer
        # log-recover — that is what makes it a backfill target.
        max_entries = self.osd.conf.get("osd_max_pg_log_entries")
        if len(self.pg_log.entries) > max_entries:
            keep = self.osd.conf.get("osd_min_pg_log_entries")
            self.pg_log.trim(self.pg_log.entries[-keep - 1].version)

    def get_shard_missing(self, oid: str) -> set[int]:
        # Backfill targets behind the cursor count as missing for READ
        # availability (their shard is stale or absent), even though they
        # do not block writes as degraded.
        osds = self.peering.osds_missing(oid) | self.peering.backfill_pending_osds(
            oid
        )
        if self.pool.type != POOL_TYPE_ERASURE:
            return osds
        return {
            self._acting.index(o)
            for o in osds
            if o in self._acting
        }

    def on_local_recover(self, oid: str) -> None:
        self.peering.mark_recovered(oid, self.osd.whoami)

    def on_global_recover(self, oid: str) -> None:
        for osd in list(self.peering.peer_missing):
            self.peering.mark_recovered(oid, osd)
        self.peering.mark_recovered(oid, self.osd.whoami)
        self.recovering.discard(oid)
        for cb in self.waiting_for_degraded.pop(oid, []):
            cb()
        self._kick_recovery()

    def clog_error(self, msg: str) -> None:
        self.osd.clog_error(msg)

    # -- client op execution ---------------------------------------------------

    def do_op(
        self, msg: MOSDOp, reply: Callable[[MOSDOpReply], None], conn=None
    ) -> None:
        """PrimaryLogPG::do_op.  `reply` delivers the MOSDOpReply; `conn`
        is the client session (kept for the signature; watch/notify is
        not ported)."""
        if not self.peering.is_primary() or not self.peering.is_active():
            # Misdirected or not-yet-peered: tell the client to refresh its
            # map and resend (the reference drops + relies on the map sub;
            # an explicit EAGAIN keeps the same retry loop without a race).
            reply(
                MOSDOpReply(
                    reqid=msg.reqid,
                    result=-EAGAIN,
                    outdata=[],
                    version=0,
                    epoch=self._epoch,
                )
            )
            return
        oid = msg.oid
        if self.peering.object_missing_anywhere(oid):
            # wait_for_degraded_object: queue + prioritize its recovery
            self.waiting_for_degraded.setdefault(oid, []).append(
                lambda: self.do_op(msg, reply, conn)
            )
            self._recover_one(oid)
            return
        if "@" in oid and msg.reqid.client and not msg.reqid.client.startswith(
            "osd."
        ):
            # "@" separates snap clones in the flat store namespace
            # (snaps.clone_oid); a client object named like a clone could
            # be shadowed or destroyed by the snap machinery.  The
            # reference carries snap ids in hobject_t instead of the name;
            # here the character is reserved.
            reply(self._errored(msg, -EINVAL))
            return
        # Classify once: op_is_write resolves CALL methods (possibly an
        # import on first use), so the result is shared by the tier gate
        # and the dispatch decision below.
        writing = any(op_is_write(op) for op in msg.ops)
        if (
            writing
            and (self.pool.flags & FLAG_FULL_QUOTA)
            and msg.reqid.client
            and not msg.reqid.client.startswith("osd.")
        ):
            # pool over quota: client mutations bounce with -EDQUOT
            # (librados surfaces exactly this on quota-full pools);
            # OSD-internal traffic (flush/promote) still flows
            reply(self._errored(msg, -EDQUOT))
            return
        # Cache tiering (PrimaryLogPG::maybe_handle_cache) promotes and
        # flushes through the daemon's internal objecter, and watch/notify
        # pushes to client sessions: neither is ported, so both answer
        # -EOPNOTSUPP.
        first = msg.ops[0].op if msg.ops else 0
        if self.pool.is_cache_tier() or first in (OSDOp.WATCH, OSDOp.NOTIFY):
            reply(self._errored(msg, -EOPNOTSUPP))
            return
        if writing:
            if self.scrubber.write_blocked(oid):
                # write_blocked_by_scrub: hold until the chunk completes
                self.scrubber.waiting_writes.append(
                    lambda: self.do_op(msg, reply, conn)
                )
                return
            key = msg.reqid.key()
            done = self._reqid_results.get(key)
            if done is not None:
                reply(done)  # duplicate of a completed write
                return
            waiters = self._inflight_reqids.get(key)
            if waiters is not None:
                waiters.append(reply)  # duplicate of an in-flight write
                return
            self._inflight_reqids[key] = []
            self._do_write(msg, reply)
        else:
            self._do_read(msg, reply)

    def _do_write(self, msg: MOSDOp, reply) -> None:
        pgt = PGTransaction(oid=msg.oid)
        outdata: list[bytes] = [b""] * len(msg.ops)
        size = self._object_size(msg.oid)
        exists = self._object_exists(msg.oid)
        hctx = None  # object-class context, shared across this op's CALLs
        for i, op in enumerate(msg.ops):
            if op.op == OSDOp.WRITE:
                pgt.write(op.off, op.data)
                size = max(size, op.off + len(op.data))
                pgt.attrs.setdefault(WHITEOUT_ATTR, None)  # resurrect
            elif op.op == OSDOp.WRITEFULL:
                pgt.write(0, op.data)
                pgt.truncate = len(op.data)
                size = len(op.data)
                pgt.attrs.setdefault(WHITEOUT_ATTR, None)
            elif op.op == OSDOp.APPEND:
                pgt.write(size, op.data)
                size += len(op.data)
                pgt.attrs.setdefault(WHITEOUT_ATTR, None)
            elif op.op == OSDOp.ZERO:
                # CEPH_OSD_OP_ZERO: the extent reads back as zeros; does
                # not extend the object (the reference zeroes within
                # bounds and ignores wholly-past-end extents)
                ln = min(int(op.len), max(size - int(op.off), 0))
                if ln > 0:
                    pgt.write(int(op.off), b"\x00" * ln)
            elif op.op == OSDOp.WRITESAME:
                # CEPH_OSD_OP_WRITESAME: tile data across [off, off+len)
                if (
                    not op.data
                    or int(op.len) % len(op.data)
                    or int(op.len) <= 0
                ):
                    self._inflight_reqids.pop(msg.reqid.key(), None)
                    reply(self._errored(msg, -EINVAL))
                    return
                tiled = bytes(op.data) * (int(op.len) // len(op.data))
                pgt.write(int(op.off), tiled)
                size = max(size, int(op.off) + len(tiled))
                pgt.attrs.setdefault(WHITEOUT_ATTR, None)
            elif op.op == OSDOp.TRUNCATE:
                pgt.truncate = op.off
                size = op.off
            elif op.op == OSDOp.DELETE:
                if msg.snap_id:
                    # snap trim, not a head delete (PrimaryLogPG::trim_object)
                    if not exists:
                        # nothing to trim; a txn would materialize a
                        # phantom head via touch+setattr
                        self._finish_write(
                            msg,
                            reply,
                            MOSDOpReply(
                                reqid=msg.reqid,
                                result=0,
                                outdata=[b""] * len(msg.ops),
                                version=self._version,
                                epoch=self._epoch,
                            ),
                            remember=True,
                        )
                        return
                    self._apply_snap_trim(msg, pgt)
                elif self._get_snapset(msg.oid).clones or (
                    exists and msg.snaps
                ):
                    # Snapshots reference (or are about to clone) this head:
                    # deletion becomes a WHITEOUT — zero bytes + marker,
                    # SnapSet preserved so clones stay reachable
                    # (object_info_t FLAG_WHITEOUT; PrimaryLogPG _delete_oid)
                    pgt.truncate = 0
                    pgt.attrs[WHITEOUT_ATTR] = b"1"
                    size = 0
                else:
                    pgt.delete = True
                    size = 0
            elif op.op == OSDOp.SETXATTR:
                pgt.attrs[f"_{op.name}"] = op.data
                pgt.attrs.setdefault(WHITEOUT_ATTR, None)
            elif op.op == OSDOp.RMXATTR:
                pgt.attrs[f"_{op.name}"] = None  # staged removal
            elif op.op == OSDOp.CMPXATTR:
                # guard op: a failed compare aborts the WHOLE transaction
                # (nothing staged lands) with -ECANCELED, the atomic
                # check-and-mutate librbd/rgw build on
                key = f"_{op.name}"
                cur = (
                    pgt.attrs[key]
                    if key in pgt.attrs
                    else self._getxattr(msg.oid, key)
                )
                if not cmpxattr_ok(cur, op.data, int(op.off)):
                    self._inflight_reqids.pop(msg.reqid.key(), None)
                    reply(self._errored(msg, -ECANCELED))
                    return
            elif op.op in (
                OSDOp.OMAPSETVALS, OSDOp.OMAPRMKEYS, OSDOp.OMAPCLEAR
            ):
                # omap rides replicated pools only (the reference's
                # pool_requires_alignment / MODE check answers the same)
                if self.pool.type == POOL_TYPE_ERASURE:
                    self._inflight_reqids.pop(msg.reqid.key(), None)
                    reply(self._errored(msg, -EOPNOTSUPP))
                    return
                if op.op == OSDOp.OMAPSETVALS:
                    pgt.omap_set.update(decode_attrs(op.data))
                elif op.op == OSDOp.OMAPRMKEYS:
                    from ..common.encoding import decode_str_list

                    for k in decode_str_list(op.data):
                        # keep op order: a later rm wins over an earlier
                        # set in this compound op (backends apply rm
                        # before set)
                        pgt.omap_set.pop(k, None)
                        pgt.omap_rm.append(k)
                else:
                    pgt.omap_clear = True
                    pgt.omap_set.clear()
                    pgt.omap_rm.clear()
                pgt.attrs.setdefault(WHITEOUT_ATTR, None)
            elif op.op == OSDOp.ROLLBACK:
                self._start_rollback(msg, reply, int(op.off))
                return
            elif op.op == OSDOp.COPY_FROM:
                # the source fetch is an internal objecter op of the
                # daemon, which is not ported
                self._inflight_reqids.pop(msg.reqid.key(), None)
                reply(self._errored(msg, -EOPNOTSUPP))
                return
            elif op.op == OSDOp.CALL:
                # WR-class object-class method: runs against the pre-op
                # state overlaid with everything staged EARLIER in this
                # op (pgt.attrs), and its mutations fold into the SAME
                # PGTransaction immediately — so a later plain op
                # overrides a class write and vice versa, honoring the
                # client's op ordering (PrimaryLogPG do_osd_ops CALL).
                if hctx is None:
                    hctx = self._make_hctx(
                        msg.oid, msg, writable=True, pgt=pgt
                    )
                try:
                    cls_name, method = op.name.split(".", 1)
                    _flags, fn = cls_get_method(cls_name, method)
                    # enforce CLS_METHOD_WR per method, not per message:
                    # an RD method riding a compound write op must still
                    # be denied mutations
                    hctx.writable = bool(_flags & CLS_WR)
                    outdata[i] = fn(hctx, op.data) or b""
                except ClsError as e:
                    # a failing method aborts the WHOLE transaction
                    # (nothing staged so far may land)
                    self._inflight_reqids.pop(msg.reqid.key(), None)
                    reply(self._errored(msg, e.errno))
                    return
                except Exception as e:
                    # a buggy/malformed-input method must not leak the
                    # exception past the reply (the client would hang on
                    # its registered reqid); the reference maps method
                    # faults to an errno the same way
                    dout("osd", 1, f"cls {op.name} raised {e!r}")
                    self._inflight_reqids.pop(msg.reqid.key(), None)
                    reply(self._errored(msg, -EINVAL))
                    return
                # fold this method's staged mutations NOW (in op order)
                staged = hctx.dirty()
                for k, v in hctx.attrs.items():
                    pgt.attrs[f"_{k}"] = v
                hctx.attrs.clear()
                if hctx.omap_cleared:
                    pgt.omap_clear = True
                    pgt.omap_set.clear()
                    pgt.omap_rm.clear()
                    hctx.omap_cleared = False
                for k, v in hctx.omap.items():
                    if v is None:
                        pgt.omap_set.pop(k, None)
                        pgt.omap_rm.append(k)
                    else:
                        pgt.omap_set[k] = v
                hctx.omap.clear()
                if hctx.data is not None:
                    pgt.write(0, hctx.data)
                    pgt.truncate = len(hctx.data)
                    size = len(hctx.data)
                    hctx.folded_data = hctx.data  # later methods' read()
                    hctx.data = None
                if staged:
                    pgt.attrs.setdefault(WHITEOUT_ATTR, None)
            else:
                self._inflight_reqids.pop(msg.reqid.key(), None)
                reply(self._errored(msg, -EINVAL))
                return
        # `size` tracked the ops SEQUENTIALLY (write-then-truncate caps,
        # truncate-then-write extends); make it authoritative for the
        # backends, which cannot recover op order from the PGTransaction.
        if pgt.truncate is not None:
            pgt.truncate = size
        # make_writeable (PrimaryLogPG): first mutation after a new snap
        # clones the current head — atomically with this transaction.
        if msg.snaps and not msg.snap_id:
            ss = self._get_snapset(msg.oid)
            if exists:
                new_snaps = ss.needs_clone(msg.snap_seq, list(msg.snaps))
                if new_snaps:
                    cid = ss.add_clone(new_snaps, self._object_size(msg.oid))
                    pgt.pre_clone = clone_oid(msg.oid, cid)
                    pgt.attrs[SS_ATTR] = ss.encode()
            elif not pgt.delete:
                # Created after those snaps existed: they must not cover
                # it, and reads at them must answer ENOENT.
                newest = max(msg.snaps)
                if newest > ss.seq:
                    ss.seq = newest
                    ss.born = newest
                    pgt.attrs[SS_ATTR] = ss.encode()
        def finish(rep: MOSDOpReply, remember: bool) -> None:
            self._finish_write(msg, reply, rep, remember)

        def on_commit() -> None:
            finish(
                MOSDOpReply(
                    reqid=msg.reqid,
                    result=0,
                    outdata=outdata,
                    version=self._version,
                    epoch=self._epoch,
                ),
                remember=True,
            )

        def on_failure(err: int) -> None:
            finish(self._errored(msg, -abs(err)), remember=False)

        kwargs = {}
        if self.pool.type == POOL_TYPE_ERASURE:
            kwargs["on_failure"] = on_failure
        try:
            self.backend.submit_transaction(pgt, msg.reqid, on_commit, **kwargs)
        except Exception as e:  # EcError on an invalid write plan
            err = getattr(e, "errno", EINVAL)
            finish(self._errored(msg, -abs(err)), remember=False)

    def _do_read(self, msg: MOSDOp, reply) -> None:
        outdata: list[bytes] = [b""] * len(msg.ops)
        read_extents: list[tuple[int, tuple[int, int]]] = []  # (op idx, extent)
        # Snapshot reads resolve to the covering clone (find_object_context):
        # the head serves when no clone is newer than the requested snap.
        target = msg.oid
        if msg.snap_id:
            ss = self._get_snapset(msg.oid)
            if msg.snap_id <= ss.born:
                reply(self._errored(msg, -ENOENT))  # created after the snap
                return
            cid = ss.resolve(msg.snap_id)
            if cid is not None:
                target = clone_oid(msg.oid, cid)
        size = self._object_size(target)
        exists = self._object_exists(target)
        if exists and self._getxattr(target, WHITEOUT_ATTR):
            exists, size = False, 0  # deleted head kept only for its clones
        result = 0
        for i, op in enumerate(msg.ops):
            if op.op == OSDOp.READ:
                if not exists:
                    result = -ENOENT
                    break
                ln = op.len or max(size - op.off, 0)
                ln = min(ln, max(size - op.off, 0))
                if ln > 0:
                    read_extents.append((i, (op.off, ln)))
            elif op.op == OSDOp.LIST_SNAPS:
                outdata[i] = self._get_snapset(msg.oid).encode()
            elif op.op == OSDOp.STAT:
                if not exists:
                    result = -ENOENT
                    break
                outdata[i] = size.to_bytes(8, "little")
            elif op.op == OSDOp.GETXATTR:
                val = self._getxattr(target, f"_{op.name}")
                if val is None:
                    result = -ENODATA
                    break
                outdata[i] = val
            elif op.op == OSDOp.CMPXATTR:
                cur = self._getxattr(target, f"_{op.name}")
                if not cmpxattr_ok(cur, op.data, int(op.off)):
                    result = -ECANCELED
                    break
            elif op.op == OSDOp.LIST_WATCHERS:
                # the watch table belongs to watch/notify (not ported)
                result = -EOPNOTSUPP
                break
            elif op.op == OSDOp.GETXATTRS:
                # Bulk client-xattr dump — the attrs leg of copy-get
                # (PrimaryLogPG::do_copy_get), consumed by COPY_FROM and
                # cache-tier promotion so metadata survives the trip.
                outdata[i] = encode_attrs(self._client_attrs(target))
            elif op.op in (OSDOp.OMAPGETKEYS, OSDOp.OMAPGETVALS):
                if self.pool.type == POOL_TYPE_ERASURE:
                    result = -EOPNOTSUPP
                    break
                coll = shard_coll(self.pgid, -1)
                try:
                    omap = self.osd.store.omap_get(coll, target)
                except Exception:
                    omap = {}
                if op.op == OSDOp.OMAPGETVALS:
                    outdata[i] = encode_attrs(omap)
                else:
                    from ..common.encoding import encode_str_list

                    outdata[i] = encode_str_list(sorted(omap))
            elif op.op == OSDOp.CALL:
                # RD-class object-class method (PrimaryLogPG do_osd_ops
                # CALL case; WR methods classify as writes in do_op)
                hctx = self._make_hctx(target, msg, writable=False)
                try:
                    cls_name, method = op.name.split(".", 1)
                    _flags, fn = cls_get_method(cls_name, method)
                    outdata[i] = fn(hctx, op.data) or b""
                except ClsError as e:
                    result = e.errno
                    break
                except Exception as e:
                    # a buggy/malformed-input method must not leak past
                    # the reply (the client would hang on its reqid)
                    dout("osd", 1, f"cls {op.name} raised {e!r}")
                    result = -EINVAL
                    break
            elif op.op == OSDOp.PGLS:
                # PrimaryLogPG::do_pgnls — enumerate this PG's heads
                # (snap clones are internal, filtered like the reference
                # filters non-head snapids from nls listings)
                import json as _json

                outdata[i] = _json.dumps(
                    sorted(
                        o
                        for o in self._list_local()
                        if "@" not in o
                        and not self._getxattr(o, WHITEOUT_ATTR)
                    )
                ).encode()
            else:
                result = -EINVAL
                break
        if result != 0 or not read_extents:
            reply(
                MOSDOpReply(
                    reqid=msg.reqid,
                    result=result,
                    outdata=outdata,
                    version=self._version,
                    epoch=self._epoch,
                )
            )
            return

        def on_read(results: dict) -> None:
            err, bufs = results[target]
            if err:
                reply(self._errored(msg, err))
                return
            for (i, _ext), buf in zip(read_extents, bufs):
                outdata[i] = buf
            reply(
                MOSDOpReply(
                    reqid=msg.reqid,
                    result=0,
                    outdata=outdata,
                    version=self._version,
                    epoch=self._epoch,
                )
            )

        self.backend.objects_read_and_reconstruct(
            {target: [ext for _i, ext in read_extents]}, on_read
        )

    def _finish_write(
        self, msg: MOSDOp, reply, rep: MOSDOpReply, remember: bool
    ) -> None:
        """Complete a write-class op: record in the dup window and release
        queued duplicate repliers."""
        key = msg.reqid.key()
        if remember:
            self._reqid_results[key] = rep
            if len(self._reqid_results) > 1000:  # bounded dup window
                self._reqid_results.pop(next(iter(self._reqid_results)))
        reply(rep)
        for dup_reply in self._inflight_reqids.pop(key, []):
            dup_reply(rep)

    # -- snapshots (PrimaryLogPG snap machinery) -------------------------------

    def _get_snapset(self, oid: str) -> SnapSet:
        return SnapSet.decode(self._getxattr(oid, SS_ATTR))

    def _apply_snap_trim(self, msg: MOSDOp, pgt: PGTransaction) -> None:
        """DELETE with a snap id = trim that snap from the object
        (PrimaryLogPG::trim_object): drop it from its clone's coverage and
        delete the clone once nothing references it."""
        ss = self._get_snapset(msg.oid)
        gone = ss.drop_snap(msg.snap_id)
        pgt.attrs[SS_ATTR] = ss.encode()
        if gone is not None:
            pgt.also_delete.append(clone_oid(msg.oid, gone))
        if not ss.clones and self._getxattr(msg.oid, WHITEOUT_ATTR):
            # last clone gone and the head was only a whiteout: reclaim it
            # (the snap-trimmer's whiteout garbage collection)
            pgt.delete = True
            pgt.attrs.clear()

    def _start_rollback(self, msg: MOSDOp, reply, snap_id: int) -> None:
        """ROLLBACK: make the head identical to the object's state at
        `snap_id` (PrimaryLogPG::_rollback_to).  Resolved clone content is
        read back and applied through the normal write pipeline, so EC
        hinfo/extent-cache stay coherent and replicas converge via the
        same repop path as any write."""
        oid = msg.oid
        ss = self._get_snapset(oid)
        if snap_id <= ss.born:
            # The object did not exist at that snap: rollback = delete
            # (the reference's _rollback_to ENOENT → _delete_oid path).
            msg.ops[:] = [OSDOp(op=OSDOp.DELETE)]
            self._do_write(msg, reply)
            return
        cid = ss.resolve(snap_id)
        if cid is None:
            # no clone newer than the snap: the head IS that state
            self._finish_write(
                msg,
                reply,
                MOSDOpReply(
                    reqid=msg.reqid,
                    result=0,
                    outdata=[b""] * len(msg.ops),
                    version=self._version,
                    epoch=self._epoch,
                ),
                remember=True,
            )
            return
        src = clone_oid(oid, cid)
        src_size = self._object_size(src)

        def proceed(data: bytes) -> None:
            msg.ops[:] = [OSDOp(op=OSDOp.WRITEFULL, data=data)]
            self._do_write(msg, reply)

        if src_size == 0:
            proceed(b"")
            return

        def on_read(results: dict) -> None:
            err, bufs = results[src]
            if err:
                self._finish_write(
                    msg, reply, self._errored(msg, err), remember=False
                )
                return
            proceed(bufs[0] if bufs else b"")

        self.backend.objects_read_and_reconstruct(
            {src: [(0, src_size)]}, on_read
        )

    # -- object classes (src/objclass; PrimaryLogPG CALL) ----------------------

    def _make_hctx(self, oid: str, msg: MOSDOp, writable: bool, pgt=None):
        """cls_method_context_t for `oid`: pre-op state reads + staged
        overlay.  With `pgt`, attr reads consult the transaction first so
        a method observes plain SETXATTRs (and earlier folded CALLs) from
        the same compound op, in order.  Sync DATA reads are unavailable
        on EC pools (the reference's objects_read_sync answers
        -EOPNOTSUPP there too) and reflect pre-op bytes plus whole-object
        class writes — byte-range plain writes earlier in the same
        compound op are not visible to a later method's read().  Xattr
        state — what lock/version/refcount/numops key on — is fully
        ordered on every pool type."""
        from ..common.errs import EOPNOTSUPP

        exists = self._object_exists(oid) and not self._getxattr(
            oid, WHITEOUT_ATTR
        )

        def read_fn() -> bytes:
            if self.pool.type == POOL_TYPE_ERASURE:
                raise ClsError(
                    EOPNOTSUPP, "sync object read on an EC pool"
                )
            coll = shard_coll(self.pgid, -1)
            return bytes(
                self.osd.store.read(coll, oid, 0, self._object_size(oid))
            )

        def getattr_fn(name: str):
            if pgt is not None and f"_{name}" in pgt.attrs:
                return pgt.attrs[f"_{name}"]  # None == removed
            return self._getxattr(oid, f"_{name}")

        def omap_fn() -> dict:
            # on-store omap overlaid with what THIS op already staged
            # (clear -> rm -> set, the backends' apply order)
            coll = shard_coll(self.pgid, -1)
            try:
                base = dict(self.osd.store.omap_get(coll, oid))
            except Exception:
                base = {}
            if pgt is not None:
                if pgt.omap_clear:
                    base = {}
                for k in pgt.omap_rm:
                    base.pop(k, None)
                base.update(pgt.omap_set)
            return base

        return ClsHCtx(
            exists=exists,
            read_fn=read_fn,
            getattr_fn=getattr_fn,
            entity=msg.reqid.client,
            writable=writable,
            omap_fn=None if self.pool.type == POOL_TYPE_ERASURE else omap_fn,
        )

    def _errored(self, msg: MOSDOp, err: int) -> MOSDOpReply:
        return MOSDOpReply(
            reqid=msg.reqid,
            result=err,
            outdata=[],
            version=0,
            epoch=self._epoch,
        )

    # -- object metadata helpers ----------------------------------------------

    def _object_size(self, oid: str) -> int:
        if self.pool.type == POOL_TYPE_ERASURE:
            return self.backend.object_size(oid)
        coll = shard_coll(self.pgid, -1)
        try:
            return self.osd.store.stat(coll, oid)
        except Exception:
            return 0

    def _object_exists(self, oid: str) -> bool:
        if self.pool.type == POOL_TYPE_ERASURE:
            return self.backend.get_object_info(oid) is not None
        coll = shard_coll(self.pgid, -1)
        return self.osd.store.exists(coll, oid)

    def _getxattr(self, oid: str, name: str) -> bytes | None:
        coll = shard_coll(self.pgid, self.whoami_shard())
        try:
            return self.osd.store.getattr(coll, oid, name)
        except Exception:
            return None

    def _client_attrs(self, oid: str) -> dict[str, bytes]:
        """All client-visible xattrs (the `_`-prefixed store attrs: plain
        SETXATTRs plus object-class state — cls_lock holders, cls_version,
        refcounts), keyed by their client names."""
        coll = shard_coll(self.pgid, self.whoami_shard())
        try:
            raw = self.osd.store.getattrs(coll, oid)
        except Exception:
            return {}
        return {k[1:]: v for k, v in raw.items() if k.startswith("_")}

    # -- recovery driver -------------------------------------------------------

    def _kick_recovery(self) -> None:
        """Start recoveries up to osd_recovery_max_active
        (the OSD recovery wq, scaled to this PG)."""
        if not self.peering.is_primary() or not self.peering.is_active():
            return
        max_active = self.osd.conf.get("osd_recovery_max_active")
        for oid in self.peering.all_missing_oids():
            if len(self.recovering) >= max_active:
                break
            self._recover_one(oid)

    def _recover_one(self, oid: str) -> None:
        if oid in self.recovering or not self.peering.is_active():
            return
        osds = self.peering.osds_missing(oid)
        if not osds:
            return
        self.recovering.add(oid)
        if self.pool.type == POOL_TYPE_ERASURE:
            missing_on = {
                self._acting.index(o) for o in osds if o in self._acting
            }
        else:
            missing_on = osds

        def on_complete(err: int) -> None:
            if err:
                self.recovering.discard(oid)
                if self._adopt_move_holders():
                    self._recover_one(oid)  # again, with the moved members' old slots
                    return
                self.clog_error(f"pg {self.pgid} recovery of {oid} failed: {err}")
                return
            self.on_global_recover(oid)

        self.backend.recover_object(oid, missing_on, on_complete)

    # -- backfill driver -------------------------------------------------------
    #
    # PeeringState's WaitLocalBackfillReserved → WaitRemoteBackfillReserved
    # → Backfilling chain (PeeringState.cc), tick-driven: the primary takes
    # a local slot, reserves a remote slot on every target, then walks its
    # sorted object namespace in osd_backfill_scan_max chunks, pushing each
    # object and advancing the per-target last_backfill cursor.

    def _backfill_key(self) -> tuple:
        return ("bf", self.pool.id, self.ps)

    def _kick_backfill(self) -> None:
        p = self.peering
        if (
            not p.is_primary()
            or not p.is_active()
            or not p.backfill_targets
            or self._bf_inflight
        ):
            return
        if not self._bf_local_reserved:
            # backfill rides the base priority so a storm's recovery
            # reservation (osd_recovery_op_priority, strictly higher)
            # can preempt it mid-chunk; the preempt callback surrenders
            # every slot and the tick loop re-grants deterministically
            # once the storm releases
            if not self.osd.local_reserver.try_reserve(
                self._backfill_key(),
                priority=0,
                on_preempt=self._on_backfill_preempted,
            ):
                return  # all local slots busy; retry next tick
            self._bf_local_reserved = True
        missing_grants = p.backfill_targets - self._bf_granted
        if missing_grants:
            # Reservation messages carry the INTERVAL epoch (peering.epoch,
            # set only when the acting set changes) so unrelated map bumps
            # cannot invalidate an in-flight grant.
            for osd in sorted(missing_grants):
                self.osd.send_cluster(
                    osd,
                    MBackfillReserve(
                        pgid=self.pgid,
                        op=MBackfillReserve.REQUEST,
                        epoch=self.peering.epoch,
                        from_osd=self.osd.whoami,
                    ),
                )
            return  # chunk starts when the grants arrive
        self._backfill_chunk()

    def on_backfill_reserve(self, msg: MBackfillReserve) -> None:
        """GRANT/REJECT from a target (primary side)."""
        stale = (
            msg.epoch != self.peering.epoch
            or msg.from_osd not in self.peering.backfill_targets
        )
        if stale:
            if msg.op == MBackfillReserve.GRANT:
                # The grantor holds a remote slot for a session we no
                # longer run: hand it back or it leaks forever.
                self.osd.send_cluster(
                    msg.from_osd,
                    MBackfillReserve(
                        pgid=self.pgid,
                        op=MBackfillReserve.RELEASE,
                        epoch=msg.epoch,
                        from_osd=self.osd.whoami,
                    ),
                )
            return
        if msg.op == MBackfillReserve.GRANT:
            self._bf_granted.add(msg.from_osd)
            if self.peering.backfill_targets <= self._bf_granted:
                self._backfill_chunk()
        elif msg.op == MBackfillReserve.REJECT:
            # Target full (RemoteReservationRejectedTooFull): give up every
            # reservation we hold so other PGs on this OSD can run, and
            # retry the whole handshake on a later tick.
            self._surrender_reservations()

    def _backfill_chunk(self) -> None:
        p = self.peering
        if not p.backfill_targets or self._bf_inflight:
            return
        if not self._bf_local_reserved:
            # preempted (or never reserved): the walk stops at the next
            # chunk boundary; the tick loop re-reserves and resumes from
            # the cursors once a slot frees
            return
        scan_max = self.osd.conf.get("osd_backfill_scan_max")
        objects = self._list_local()  # store returns them sorted
        self._bf_chunk_targets = {}
        self._bf_failed = set()
        chunk: dict[str, set[int]] = {}
        for osd in sorted(p.backfill_targets):
            lo = bisect.bisect_right(objects, p.last_backfill[osd])
            pending = objects[lo : lo + scan_max]
            self._bf_chunk_targets[osd] = pending
            for oid in pending:
                chunk.setdefault(oid, set()).add(osd)
        if not chunk:
            self._backfill_complete(list(p.backfill_targets))
            return
        self._bf_inflight = set(chunk)
        self.osd.perf.inc("backfill_pushes", len(chunk))
        gen = self._bf_gen
        for oid, osds in chunk.items():
            if self.pool.type == POOL_TYPE_ERASURE:
                missing_on = {
                    self._acting.index(o) for o in osds if o in self._acting
                }
            else:
                missing_on = osds

            def on_done(err: int, oid=oid) -> None:
                if gen != self._bf_gen:
                    return  # interval changed mid-push; session is dead
                self._bf_inflight.discard(oid)
                if err:
                    self._adopt_move_holders()  # the retry from the barrier reads them
                    self._bf_failed.add(oid)
                    self.clog_error(
                        f"pg {self.pgid} backfill push of {oid} failed: {err}"
                    )
                if not self._bf_inflight:
                    self._backfill_chunk_done()

            self.backend.recover_object(oid, missing_on, on_done)

    def _backfill_chunk_done(self) -> None:
        p = self.peering
        scan_max = self.osd.conf.get("osd_backfill_scan_max")
        # A failed push caps cursor advance below the failed object, so it
        # is re-scanned (and re-pushed) by a later chunk — the cursor must
        # never skip an untransferred object.
        barrier = min(self._bf_failed) if self._bf_failed else None
        had_failures = bool(self._bf_failed)
        finished: list[int] = []
        for osd, pending in self._bf_chunk_targets.items():
            if osd not in p.backfill_targets:
                continue
            done = (
                pending
                if barrier is None
                else [o for o in pending if o < barrier]
            )
            if done:
                p.last_backfill[osd] = max(p.last_backfill[osd], done[-1])
            if not had_failures and len(pending) < scan_max:
                finished.append(osd)  # scan exhausted: target is complete
        self._bf_chunk_targets = {}
        self._bf_failed = set()
        if finished:
            self._backfill_complete(finished)
        if p.backfill_targets:
            if had_failures:
                return  # retry from the barrier on the next tick, not hot
            self._backfill_chunk()  # keep walking; chunk size throttles

    def _backfill_complete(self, targets: list[int]) -> None:
        p = self.peering
        for osd in targets:
            dout("osd", 5, f"pg {self.pgid} backfill to osd.{osd} complete")
            p.backfill_targets.discard(osd)
            p.last_backfill.pop(osd, None)
            self._bf_granted.discard(osd)
            self.osd.send_cluster(
                osd,
                MBackfillReserve(
                    pgid=self.pgid,
                    op=MBackfillReserve.RELEASE,
                    epoch=self.peering.epoch,
                    from_osd=self.osd.whoami,
                ),
            )
        if not p.backfill_targets:
            self._release_local_backfill()

    def _release_local_backfill(self) -> None:
        if self._bf_local_reserved:
            self.osd.local_reserver.release(self._backfill_key())
            self._bf_local_reserved = False

    def _on_backfill_preempted(self) -> None:
        """A higher-priority reservation (recovery-storm rebuild) took
        our local slot: surrender the remote grants too — holding them
        while unable to push would starve the targets' other primaries
        — and let the tick loop re-run the whole handshake once a slot
        frees.  The local slot is already gone (the reserver popped it
        before firing this callback), so only the flag resets here;
        `_surrender_reservations`'s release of the un-held key is the
        exactly-once no-op the reserver guarantees."""
        self._bf_local_reserved = False
        self._surrender_reservations()

    def _surrender_reservations(self) -> None:
        """Give back every slot (local + granted remotes) without touching
        cursors — used on REJECT so one full target cannot starve other
        PGs; the next tick restarts the handshake from scratch."""
        for osd in self._bf_granted:
            self.osd.send_cluster(
                osd,
                MBackfillReserve(
                    pgid=self.pgid,
                    op=MBackfillReserve.RELEASE,
                    epoch=self.peering.epoch,
                    from_osd=self.osd.whoami,
                ),
            )
        self._bf_granted = set()
        self._release_local_backfill()

    def _reset_backfill(self) -> None:
        """Interval change: reservations and cursors die with the interval
        (PeeringState::clear_backfill_state)."""
        self._bf_gen += 1  # stale out in-flight push callbacks
        self._surrender_reservations()
        self._bf_inflight = set()
        self._bf_failed = set()
        self._bf_chunk_targets = {}

    # -- scrub -----------------------------------------------------------------

    def scrub(self, deep: bool = False, repair: bool = False, on_done=None) -> bool:
        """Primary-only scrub kick (PgScrubber)."""
        if not self.peering.is_primary() or not self.peering.is_active():
            return False
        return self.scrubber.start(deep=deep, repair=repair, on_done=on_done)

    def handle_scrub_message(self, msg) -> bool:
        from ..msg.messages import MOSDRepScrub, MOSDRepScrubMap

        if isinstance(msg, MOSDRepScrub):
            self.scrubber.handle_rep_scrub(msg)
        elif isinstance(msg, MOSDRepScrubMap):
            self.scrubber.handle_scrub_map(msg)
        else:
            return False
        return True

    def send_scrub(self, osd: int, msg) -> None:
        # Loopback via the event loop, not direct call: a synchronous
        # self-delivery chain would recurse one stack frame per chunk
        # (chunk -> map -> compare -> next chunk) and overflow on big PGs.
        if osd == self.osd.whoami:
            asyncio.get_event_loop().call_soon(self.scrubber.handle_rep_scrub, msg)
        else:
            self.osd.send_cluster(osd, msg)

    def send_scrub_reply(self, osd: int, msg) -> None:
        if osd == self.osd.whoami:
            asyncio.get_event_loop().call_soon(self.scrubber.handle_scrub_map, msg)
        else:
            self.osd.send_cluster(osd, msg)

    def mark_shard_missing(self, oid: str, osd: int) -> None:
        """Repair path: treat a corrupt shard as missing so recovery
        rebuilds it (the reference's repair → recovery handoff)."""
        v = self.pg_log.head
        if osd == self.osd.whoami:
            self.peering.missing.add(oid, v)
            if self.pool.type != POOL_TYPE_ERASURE:
                # Replicated recovery pulls from a replica only when the
                # primary's copy is ABSENT (recover_object's exists()
                # check) — a corrupt-but-present copy would be pushed back
                # out as "repair".  Drop it so the pull path engages.
                coll = shard_coll(self.pgid, -1)
                self.osd.store.queue_transaction(Transaction().remove(coll, oid))
        else:
            self.peering.peer_missing.setdefault(osd, Missing()).add(oid, v)

    def request_recovery(self, oid: str) -> None:
        self._recover_one(oid)

    @property
    def is_clean(self) -> bool:
        return (
            self.peering.is_active()
            and not self.peering.missing.items
            and all(not m.items for m in self.peering.peer_missing.values())
            and not self.peering.backfill_targets
        )
