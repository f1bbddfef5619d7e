"""PG — the placement-group execution context.

The port of `ceph_tpu/osd/pg.py`: the same op semantics, messages, log
entries and store contents, over the port's backends (`ECBackend`, whose
encode, decode, verify and delta run on the device, and
`ReplicatedBackend`).  `PG(osd, pool, ps, profiles, device=None)` makes
an EC pool's codec on `device` (None: `cuda`, which raises with no GPU).
Cache tiering and COPY_FROM fetch through the daemon's internal objecter
leg (`osd.internal_op`), and watch/notify pushes to the client sessions
of the daemon's messenger.  One policy differs from the JAX package's:
an EC rebuild that fails for want of sources takes the members that
moved slot this interval as holders of their old slots, and runs again
(ROADMAP C13).  A device error (`ops.guard.is_device_error`) that meets
a broad handler of an op (an object-class method, a write's submit) is
answered -EIO, where the reference answers such a failure -EINVAL, the
client's fault (ROADMAP C36).  The host `osd` gives `whoami`, `store`, `conf`,
`osdmap`, `send_cluster`, `local_reserver`, `perf` and `clog_error`;
the daemon (osd/osd.py) gives the rest (`internal_op`, `recovery_storm`,
`note_subread_rtt`, `laggy_peers`, `io_accountant`).

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
from collections import OrderedDict
from typing import TYPE_CHECKING, Callable

from ..common.errs import (
    EAGAIN,
    EBUSY,
    ECANCELED,
    EDQUOT,
    EINVAL,
    EIO,
    ENODATA,
    ENOENT,
    EOPNOTSUPP,
    EPERM,
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
from ..ops.guard import is_device_error
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

# Cache-tier dirty marker (object_info_t FLAG_DIRTY analog): set by client
# writes on a writeback cache PG, cleared by flush; rides the write
# transaction so replicas agree.
DIRTY_ATTR = "cache_dirty"


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
        # watch/notify (PrimaryLogPG watchers / Notify in Watch.cc):
        # oid -> (entity, cookie) -> connection; cookies are only unique
        # per watcher entity, exactly like the reference's watch key
        # (pair<uint64_t, entity_name_t>, PrimaryLogPG.h).
        # Simplification vs the reference: watches are primary-memory only
        # (the reference persists them in object_info and clients re-watch
        # after ENOTCONN) — a primary failover drops them, so watchers
        # must re-register after cluster topology changes.
        self.watchers: dict[str, dict[tuple[str, int], object]] = {}
        self._notify_id = 0
        # notify_id -> {"pending": set[(entity, cookie)], "acks", "finish"}
        self._notifies: dict[int, dict] = {}
        # cache tiering (PrimaryLogPG promote_object / TierAgent):
        self._promoting: dict[str, list] = {}  # oid -> queued (msg,reply,conn)
        self._tier_pass: set[tuple[str, int]] = set()  # reqids past the gate
        self._tier_lru: "OrderedDict[str, None]" = OrderedDict()
        self._tier_tid = 0
        self._tier_agent_busy = False
        # oids mid-flush: writes are blocked (queued) until the write-back
        # and dirty-clear land, else a racing write could be marked clean
        # and lost on evict (the reference's wait_for_blocked_object).
        self._flushing: dict[str, list] = {}
        # recovery-progress accounting: the high-water total of
        # missing objects this recovery episode and the done counters —
        # progress_status() folds them into the OSD status blob the mgr
        # progress module aggregates.  Reset when the episode completes.
        self._recovery_total = 0
        self._recovery_done = 0
        self._recovery_done_bytes = 0
        # completion-report repeats remaining: the final done==total
        # event is re-emitted on a few status reports, because the mgr
        # samples a last-write-wins status blob and a one-shot report
        # can be overwritten before the module's next tick sees it
        self._recovery_final_reports = 0

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
        # the port's (ROADMAP C25): a client's resend of a write still in
        # flight waits on that write, which may never commit now that its
        # interval ended (a member it waits on is gone).  Ceph's on_change
        # requeues such ops; here they are answered -EAGAIN, so the client
        # resends once the PG is active again, where the write runs anew
        for key, waiters in self._inflight_reqids.items():
            self._inflight_reqids[key] = []
            for w in waiters:
                w(MOSDOpReply(reqid=ReqId(*key), result=-EAGAIN, outdata=[],
                              version=0, epoch=epoch))
        self.scrubber.reset()  # an interval change aborts in-flight scrubs
        self._reset_backfill()  # reservations do not survive an interval
        # in-flight recoveries die with the interval (the reference's
        # on_change cancels them): a push sent to a member that went
        # down mid-interval would otherwise pin its oid in `recovering`
        # forever — re-peering recomputes the missing sets and the next
        # tick re-admits whatever still needs rebuilding
        self.recovering.clear()
        # recovery-progress episode dies with the interval: a demoted
        # primary's progress_status goes silent BEFORE its reset branch
        # can run, and stale done counts would otherwise pre-fill the
        # bar when this OSD becomes primary again
        self._recovery_total = 0
        self._recovery_done = 0
        self._recovery_done_bytes = 0
        self._recovery_final_reports = 0
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

    def logical_object_size(self, oid: str) -> int:
        return self._object_size(oid)

    def local_object_count(self) -> int:
        """O(1)/one-readdir count for stat reporting (no enumeration)."""
        coll = shard_coll(self.pgid, self.whoami_shard())
        try:
            return self.osd.store.count_objects(coll)
        except Exception:
            return 0

    def local_bytes_used(self) -> int:
        """Raw bytes this OSD stores for the PG (every local object incl.
        snap clones and EC shard chunks) — the pg_stats slice `ceph df`'s
        USED column aggregates."""
        coll = shard_coll(self.pgid, self.whoami_shard())
        total = 0
        try:
            for oid in self.osd.store.list_objects(coll):
                try:
                    total += self.osd.store.stat(coll, oid)
                except Exception:
                    pass
        except Exception:
            return 0
        return total

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
        # kick the storm controller AT the flood: activation
        # is the moment a whole-OSD failure's missing sets appear, and
        # waiting for the next heartbeat tick would let the per-PG
        # trickle race the first wave
        storm = getattr(self.osd, "recovery_storm", None)
        if storm is not None:
            storm.tick()
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

    def perf_inc(self, name: str, n: int = 1) -> None:
        """EC hedge/shed accounting -> the OSD's counters."""
        perf = getattr(self.osd, "perf", None)
        if perf is None:
            return
        try:
            perf.inc(name, n)
        except (KeyError, AttributeError):
            pass  # harness OSD without the counter declared

    def conf_get(self, name: str):
        """Runtime-mutable knob lookup for the EC backend (hedge
        quantile/floor/budget ride the OSD's live Config)."""
        conf = getattr(self.osd, "conf", None)
        return conf.get(name) if conf is not None else None

    def note_peer_rtt(self, peer: int, rtt: float) -> None:
        """Sub-read service-time sample -> the OSD's laggy detector."""
        hook = getattr(self.osd, "note_subread_rtt", None)
        if hook is not None:
            hook(peer, rtt)

    def laggy_peers(self) -> set[int]:
        """OSDs the heartbeat subsystem flags as slow-but-alive; the EC
        backend deprioritizes them as sub-read sources."""
        hook = getattr(self.osd, "laggy_peers", None)
        return set(hook()) if hook is not None else set()

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
        # progress accounting gates on the recovery driver's in-flight
        # set: backfill pushes reuse backend.recover_object (and thus
        # land here) without ever entering `recovering`, and the
        # backend + _recover_one's completion BOTH call this hook for a
        # real recovery — counting on the membership test keeps done at
        # exactly one per recovered object and zero for backfill
        if oid in self.recovering:
            self._recovery_done += 1
        for osd in list(self.peering.peer_missing):
            self.peering.mark_recovered(oid, osd)
        self.peering.mark_recovered(oid, self.osd.whoami)
        self.recovering.discard(oid)
        for cb in self.waiting_for_degraded.pop(oid, []):
            cb()
        # completion-driven waves: while a storm is engaged,
        # each landed recovery frees in-flight budget — admit the next
        # wave NOW instead of waiting out the heartbeat tick
        storm = getattr(self.osd, "recovery_storm", None)
        if storm is not None and storm.engaged:
            storm.tick()
        self._kick_recovery()

    def clog_error(self, msg: str) -> None:
        self.osd.clog_error(msg)

    # -- client op execution ---------------------------------------------------

    def do_op(
        self, msg: MOSDOp, reply: Callable[[MOSDOpReply], None], conn=None
    ) -> None:
        """PrimaryLogPG::do_op.  `reply` delivers the MOSDOpReply; `conn`
        is the client session (needed to push watch notifies)."""
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
        # Cache-tier gate (PrimaryLogPG::maybe_handle_cache): promote on
        # miss, forward deletes to the base, reject writes on readonly.
        # OSD-internal traffic ("osd." clients: promote writes, flush acks)
        # bypasses it.
        if (
            self.pool.is_cache_tier()
            and msg.reqid.client
            and not msg.reqid.client.startswith("osd.")
            and not self._tier_gate(msg, reply, conn, writing)
        ):
            return
        first = msg.ops[0].op if msg.ops else 0
        if first == OSDOp.WATCH:
            self._do_watch(conn, msg, reply)
            return
        if first == OSDOp.NOTIFY:
            self._do_notify(msg, reply)
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
                self._start_copy_from(msg, reply, op)
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
                    # a device error is EIO, not the client's EINVAL (C36)
                    reply(self._errored(msg, -(EIO if is_device_error(e) else EINVAL)))
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
        # Cache-tier dirty marking (object_info_t FLAG_DIRTY): client
        # mutations on a writeback cache are flush candidates; internal
        # writes (promotes, flush bookkeeping) stay clean.
        if (
            self.pool.cache_mode == "writeback"
            and self.pool.tier_of >= 0
            and not pgt.delete
            and msg.reqid.client
            and not msg.reqid.client.startswith("osd.")
        ):
            pgt.attrs[DIRTY_ATTR] = b"1"

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
            err = EIO if is_device_error(e) else getattr(e, "errno", EINVAL)
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
                # PrimaryLogPG do_osd_ops CEPH_OSD_OP_LIST_WATCHERS:
                # (entity, cookie) pairs currently registered on the head
                import json as _json

                outdata[i] = _json.dumps(
                    [
                        {"watcher": e, "cookie": c}
                        for e, c in sorted(self.watchers.get(msg.oid, {}))
                    ]
                ).encode()
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
                    # a device error is EIO, not the client's EINVAL (C36)
                    result = -(EIO if is_device_error(e) else EINVAL)
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
            {target: [ext for _i, ext in read_extents]},
            on_read,
            # end-to-end budget: sub-reads inherit the op's
            # remaining deadline so shards shed a doomed read's work
            deadline=getattr(msg, "deadline", 0.0),
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
        # Cache-tier residency bookkeeping: every completed mutation is the
        # authoritative place to learn an object now exists (first writes
        # arrive via the promotion pass-through, which skips the gate's
        # touch) or is gone (deletes).
        if self.pool.is_cache_tier() and rep.result == 0:
            if self._object_exists(msg.oid):
                self._tier_touch(msg.oid)
                self._tier_maybe_agent()
            else:
                self._tier_lru.pop(msg.oid, None)
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

    def _start_copy_from(self, msg: MOSDOp, reply, op: OSDOp) -> None:
        """COPY_FROM: fetch the source object's bytes (this OSD acting as a
        client toward the source's primary — the objecter leg of
        PrimaryLogPG::do_copy_from) and apply them through the write
        pipeline as a full write."""
        src, src_snap = op.name, int(op.off)

        def on_fetched(err: int, outs: list[bytes]) -> None:
            if err:
                self._finish_write(
                    msg, reply, self._errored(msg, -abs(err)), remember=False
                )
                return
            data = outs[0] if outs else b""
            attrs = decode_attrs(outs[1]) if len(outs) > 1 else {}
            # copy-get carries the attr map too (PrimaryLogPG do_copy_get):
            # the copy REPLACES the destination — its old client xattrs
            # go, the source's come
            stale = set(self._client_attrs(msg.oid)) - set(attrs)
            msg.ops[:] = (
                [OSDOp(op=OSDOp.WRITEFULL, data=data)]
                + [OSDOp(op=OSDOp.RMXATTR, name=k) for k in sorted(stale)]
                + [
                    OSDOp(op=OSDOp.SETXATTR, name=k, data=v)
                    for k, v in sorted(attrs.items())
                ]
            )
            self._do_write(msg, reply)

        self.osd.internal_op(
            self.pool.id,
            src,
            [OSDOp(op=OSDOp.READ), OSDOp(op=OSDOp.GETXATTRS)],
            on_fetched,
            snap_id=src_snap,
            multi=True,
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

    # -- cache tiering (PrimaryLogPG maybe_handle_cache / TierAgentState) ------

    def _tier_gate(self, msg: MOSDOp, reply, conn, writing: bool) -> bool:
        """Returns True to continue normal dispatch, False when the op was
        consumed (promotion in flight, forwarded, or rejected).
        `writing` is do_op's once-computed write classification.

        Scope mirrors the reference's writeback/readonly modes with one
        documented simplification: cache pools don't combine with pool
        snapshots.  Promotion and flush carry client xattrs (cls state)
        alongside bytes, as the reference's copy-get does.
        """
        first = msg.ops[0].op if msg.ops else 0
        if msg.oid in self._flushing and (
            writing or first in (OSDOp.CACHE_FLUSH, OSDOp.CACHE_EVICT)
        ):
            # Mid-flush: a write racing the write-back could get its dirty
            # mark cleared and then be evicted — queue until the flush
            # completes (PrimaryLogPG wait_for_blocked_object).
            self._flushing[msg.oid].append((msg, reply, conn))
            return False
        if first == OSDOp.CACHE_FLUSH:
            self._do_cache_flush(msg, reply)
            return False
        if first == OSDOp.CACHE_EVICT:
            self._do_cache_evict(msg, reply)
            return False
        if first in (OSDOp.PGLS, OSDOp.NOTIFY):
            return True
        key = msg.reqid.key()
        if key in self._tier_pass:
            return True
        if writing and self.pool.cache_mode == "readonly":
            reply(self._errored(msg, -EPERM))
            return False
        pure_delete = (
            writing
            and all(op.op == OSDOp.DELETE for op in msg.ops)
            and not msg.snap_id
        )
        if pure_delete and self.pool.cache_mode == "writeback":
            # Forward the delete to the base pool FIRST: a cache-only
            # delete would resurrect from the base on the next miss.
            def on_base(err: int, _data: bytes) -> None:
                if err and err != -ENOENT:
                    reply(self._errored(msg, err))
                    return
                self._tier_lru.pop(msg.oid, None)
                self._tier_pass.add(key)
                try:
                    self.do_op(msg, reply, conn)
                finally:
                    self._tier_pass.discard(key)

            self.osd.internal_op(
                self.pool.tier_of, msg.oid, [OSDOp(op=OSDOp.DELETE)], on_base
            )
            return False
        # COPY_FROM reads its SOURCE locally via an internal fetch that
        # bypasses this gate, so a cold (base-resident) source must be
        # promoted before the copy can run.
        for op in msg.ops:
            if op.op == OSDOp.COPY_FROM and not self._object_exists(op.name):
                self._tier_promote(op.name, (msg, reply, conn))
                return False
        if self._object_exists(msg.oid):
            self._tier_touch(msg.oid)
            if writing:
                self._tier_maybe_agent()
            return True
        # Miss: promote from the base pool, queue the op behind the fetch
        # (PrimaryLogPG::promote_object + wait_for_blocked_object).
        self._tier_promote(msg.oid, (msg, reply, conn))
        if writing:
            self._tier_maybe_agent()
        return False

    def _tier_promote(self, oid: str, entry) -> None:
        """Queue an op behind promotion of `oid`; start the base fetch if
        this is the first waiter."""
        waiters = self._promoting.get(oid)
        if waiters is not None:
            waiters.append(entry)
            return
        self._promoting[oid] = [entry]

        def on_fetched(err: int, outs: list[bytes]) -> None:
            data = outs[0] if outs else b""
            attrs = decode_attrs(outs[1]) if len(outs) > 1 else {}
            self._tier_promoted(oid, err, data, attrs)

        # copy-get: data + the client-xattr map in one fetch, so cls
        # state (locks, versions, refcounts) survives promotion
        self.osd.internal_op(
            self.pool.tier_of,
            oid,
            [OSDOp(op=OSDOp.READ), OSDOp(op=OSDOp.GETXATTRS)],
            on_fetched,
            multi=True,
        )

    def _tier_drain(self, oid: str) -> None:
        """Re-dispatch ops queued behind a promotion; each gets a one-shot
        gate pass so a base-absent object can't loop through promotion."""
        for m, r, c in self._promoting.pop(oid, []):
            k = m.reqid.key()
            self._tier_pass.add(k)
            try:
                self.do_op(m, r, c)
            finally:
                self._tier_pass.discard(k)

    def _tier_promoted(
        self, oid: str, err: int, data: bytes, attrs: dict[str, bytes] | None = None
    ) -> None:
        if err == -ENOENT:
            # Base has nothing: reads answer ENOENT, writes create fresh.
            self._tier_drain(oid)
            return
        if err:
            for m, r, _c in self._promoting.pop(oid, []):
                r(self._errored(m, -EAGAIN if err == -EAGAIN else err))
            return
        # Write the promoted copy through the replicated pipeline as an
        # internal (clean, non-dirty) object — bytes AND client xattrs,
        # so flush→evict→promote round-trips cls state — then release
        # the waiters.
        self._tier_tid += 1
        pm = MOSDOp(
            reqid=ReqId(client=f"osd.{self.osd.whoami}.promote", tid=self._tier_tid),
            pgid=PgId(self.pool.id, self.pgid.ps, -1),
            oid=oid,
            ops=[OSDOp(op=OSDOp.WRITEFULL, data=data)]
            + [
                OSDOp(op=OSDOp.SETXATTR, name=k, data=v)
                for k, v in sorted((attrs or {}).items())
            ],
            epoch=self._epoch,
        )

        def on_written(rep: MOSDOpReply) -> None:
            if rep.result:
                for m, r, _c in self._promoting.pop(oid, []):
                    r(self._errored(m, rep.result))
                return
            self._tier_touch(oid)
            self._tier_drain(oid)

        self.do_op(pm, on_written)

    def _tier_touch(self, oid: str) -> None:
        self._tier_lru[oid] = None
        self._tier_lru.move_to_end(oid)

    def _is_dirty(self, oid: str) -> bool:
        return bool(self._getxattr(oid, DIRTY_ATTR))

    def _tier_flush(self, oid: str, done) -> None:
        """Write a dirty object's bytes back to the base pool, then clear
        the dirty marker through the replicated pipeline.  done(err).
        Writes on `oid` are blocked (queued in _flushing) for the duration,
        so the clear cannot race a fresh mutation."""
        if not self._object_exists(oid):
            done(-ENOENT)
            return
        if oid in self._flushing:
            done(-EBUSY)  # a flush is already running; writes are queued
            return
        if not self._is_dirty(oid):
            # Clean normally means base-backed — but an object written into
            # the pool BEFORE `osd tier add` is clean with no base copy
            # (and would be unevictable, see _tier_evict).  Verify, and
            # write it back if the base lacks it.
            def on_stat(err: int, _data: bytes) -> None:
                if err == -ENOENT:
                    self._tier_writeback(oid, done)
                else:
                    done(0 if not err else err)

            self.osd.internal_op(
                self.pool.tier_of, oid, [OSDOp(op=OSDOp.STAT)], on_stat
            )
            return
        self._tier_writeback(oid, done)

    def _tier_writeback(self, oid: str, done) -> None:
        """The write-back leg of a flush: copy bytes AND client xattrs
        (cls locks/versions/refcounts included — the reference's copy-get
        carries the attr map) to the base pool, then clear the dirty
        marker.  Writers on `oid` queue in _flushing."""
        self._flushing[oid] = []
        coll = shard_coll(self.pgid, -1)
        data = self.osd.store.read(coll, oid, 0, self._object_size(oid))
        attrs = self._client_attrs(oid)

        def finish(err: int) -> None:
            waiters = self._flushing.pop(oid, [])
            done(err)
            for m, r, c in waiters:
                self.do_op(m, r, c)

        def on_ack(err: int, _data: bytes) -> None:
            if err:
                finish(err)
                return
            pgt = PGTransaction(oid=oid)
            pgt.attrs[DIRTY_ATTR] = None  # rm
            self._tier_tid += 1
            self.backend.submit_transaction(
                pgt,
                ReqId(client=f"osd.{self.osd.whoami}.flush", tid=self._tier_tid),
                lambda: finish(0),
            )

        self.osd.internal_op(
            self.pool.tier_of,
            oid,
            [OSDOp(op=OSDOp.WRITEFULL, data=bytes(data))]
            + [
                OSDOp(op=OSDOp.SETXATTR, name=k, data=v)
                for k, v in sorted(attrs.items())
            ],
            on_ack,
        )

    def _tier_evict(self, oid: str, done) -> None:
        """Drop a CLEAN object from the cache (local delete only — the base
        copy is authoritative; the next miss re-promotes).  done(err).

        Before deleting, the base copy's existence is verified: an object
        that predates the tier relationship (written into the pool before
        `osd tier add`) carries no dirty mark yet exists nowhere else —
        deleting it would be permanent loss.  Such objects answer -EBUSY
        (flush them first), which also covers the reference's reason for
        refusing non-empty tier pools without --force-nonempty."""
        if not self._object_exists(oid):
            done(-ENOENT)
            return
        if self._is_dirty(oid):
            done(-EBUSY)
            return
        if oid in self._flushing:
            done(-EBUSY)  # a flush (or another evict) holds the object
            return
        # Block writes on the oid for the whole evict (the reference's
        # object-context write lock): a write acked while the base STAT
        # is in flight must not be deleted out from under the client.
        self._flushing[oid] = []

        def finish(err: int) -> None:
            waiters = self._flushing.pop(oid, [])
            done(err)
            for m, r, c in waiters:
                self.do_op(m, r, c)

        def on_base_stat(err: int, _data: bytes) -> None:
            if err:
                # base copy unverifiable (absent or unreachable): refuse
                finish(-EBUSY)
                return
            if self._is_dirty(oid):  # re-dirtied while we checked
                finish(-EBUSY)
                return
            pgt = PGTransaction(oid=oid, delete=True)
            self._tier_tid += 1
            self._tier_lru.pop(oid, None)
            self.backend.submit_transaction(
                pgt,
                ReqId(client=f"osd.{self.osd.whoami}.evict", tid=self._tier_tid),
                lambda: finish(0),
            )

        self.osd.internal_op(
            self.pool.tier_of, oid, [OSDOp(op=OSDOp.STAT)], on_base_stat
        )

    def _tier_op_done(self, msg: MOSDOp, reply):
        """done(err) closure answering a CACHE_FLUSH/CACHE_EVICT client op."""

        def done(err: int) -> None:
            if err:
                reply(self._errored(msg, err))
            else:
                reply(
                    MOSDOpReply(
                        reqid=msg.reqid,
                        result=0,
                        outdata=[b""] * len(msg.ops),
                        version=self._version,
                        epoch=self._epoch,
                    )
                )

        return done

    def _do_cache_flush(self, msg: MOSDOp, reply) -> None:
        self._tier_flush(msg.oid, self._tier_op_done(msg, reply))

    def _do_cache_evict(self, msg: MOSDOp, reply) -> None:
        self._tier_evict(msg.oid, self._tier_op_done(msg, reply))

    def _tier_share(self) -> int:
        """This PG's slice of the pool-wide object target (ceil split;
        the reference agent works from per-PG dirty/full ratios)."""
        return -(-self.pool.target_max_objects // max(1, self.pool.pg_num))

    def _tier_maybe_agent(self) -> None:
        """Cheap trigger: only schedule the agent's full store scan when
        the in-memory LRU (an approximate local head count — rebuilt
        lazily after a primary restart) crosses the PG's share.  Runs for
        readonly caches too: promotions accumulate there and must still
        honor target_max_objects (evict-only; nothing is ever dirty)."""
        if (
            self.pool.target_max_objects
            and self.pool.cache_mode in ("writeback", "readonly")
            and len(self._tier_lru) > self._tier_share()
        ):
            asyncio.get_event_loop().call_soon(self._tier_agent)

    def _tier_agent(self) -> None:
        """Flush-and-evict down to target_max_objects, coldest first
        (TierAgentState evict_mode; utilization-driven in the reference,
        object-count-driven here).  One store scan computes the whole
        victim batch; victims are processed sequentially, then the scan
        repeats only if still over target."""
        target = self.pool.target_max_objects
        if (
            not target
            or self.pool.cache_mode == "none"
            or self._tier_agent_busy
            or not self.peering.is_primary()
        ):
            return
        share = self._tier_share()
        heads = [o for o in self._list_local() if "@" not in o]
        excess = len(heads) - share
        if excess <= 0:
            return
        # coldest = LRU order, with never-touched objects (e.g. after a
        # primary restart, the in-memory LRU is empty) treated as coldest
        in_lru = {o: i for i, o in enumerate(self._tier_lru)}
        victims = sorted(heads, key=lambda o: in_lru.get(o, -1))[:excess]
        self._tier_agent_busy = True
        loop = asyncio.get_event_loop()

        def next_victim(err: int) -> None:
            if err:
                # e.g. base pool unplaceable (-EAGAIN): stop this batch and
                # back off instead of spinning against a stuck victim
                self._tier_agent_busy = False
                loop.call_later(0.5, self._tier_agent)
                return
            if not victims:
                self._tier_agent_busy = False
                loop.call_soon(self._tier_agent)  # rescan; exits when under
                return
            victim = victims.pop(0)

            def flushed(e: int) -> None:
                if e:
                    next_victim(e)
                else:
                    self._tier_evict(victim, next_victim)

            self._tier_flush(victim, flushed)

        next_victim(0)

    # -- watch / notify (PrimaryLogPG watchers, Watch.cc) ----------------------

    def _do_watch(self, conn, msg: MOSDOp, reply) -> None:
        op = msg.ops[0]
        cookie = int(op.off)
        if not self._object_exists(msg.oid):
            reply(self._errored(msg, -ENOENT))
            return
        table = self.watchers.setdefault(msg.oid, {})
        wkey = (msg.reqid.client, cookie)
        if op.len:
            table[wkey] = conn
        else:
            table.pop(wkey, None)
            if not table:
                self.watchers.pop(msg.oid, None)
        reply(
            MOSDOpReply(
                reqid=msg.reqid,
                result=0,
                outdata=[b""],
                version=self._version,
                epoch=self._epoch,
            )
        )

    def _do_notify(self, msg: MOSDOp, reply) -> None:
        import json as _json

        from ..msg.messages import MWatchNotify

        op = msg.ops[0]
        timeout_s = (int(op.off) or 3000) / 1000.0
        watchers = dict(self.watchers.get(msg.oid, {}))
        self._notify_id += 1
        nid = self._notify_id
        state = {
            "pending": set(watchers),
            "acks": {},
            "conns": dict(watchers),
            "done": False,
        }

        def finish() -> None:
            if state["done"]:
                return
            state["done"] = True
            self._notifies.pop(nid, None)
            out = _json.dumps(
                {
                    "acks": {
                        f"{ent}/{ck}": p.hex()
                        for (ent, ck), p in state["acks"].items()
                    },
                    "timeouts": sorted(
                        f"{ent}/{ck}" for ent, ck in state["pending"]
                    ),
                }
            ).encode()
            reply(
                MOSDOpReply(
                    reqid=msg.reqid,
                    result=0,
                    outdata=[out],
                    version=self._version,
                    epoch=self._epoch,
                )
            )

        state["finish"] = finish
        if not watchers:
            finish()
            return
        self._notifies[nid] = state
        for (entity, cookie), conn in watchers.items():
            push = MWatchNotify(
                oid=msg.oid,
                pgid=self.pgid,
                notify_id=nid,
                cookie=cookie,
                payload=op.data,
                is_ack=0,
                watcher=entity,
            )

            async def _send(conn=conn, push=push, wkey=(entity, cookie)) -> None:
                try:
                    await conn.send_message(push)
                except ConnectionError:
                    state["pending"].discard(wkey)
                    if not state["pending"]:
                        finish()

            asyncio.get_event_loop().create_task(_send())
        asyncio.get_event_loop().call_later(timeout_s, finish)

    def handle_watch_ack(self, msg) -> None:
        state = self._notifies.get(msg.notify_id)
        wkey = (msg.watcher, msg.cookie)
        if state is None or wkey not in state["pending"]:
            return
        state["pending"].discard(wkey)
        state["acks"][wkey] = msg.payload
        if not state["pending"]:
            state["finish"]()

    def on_client_reset(self, conn) -> None:
        """A client session died: its watches evaporate (watch timeout via
        connection teardown) and pending notifies stop waiting for it."""
        for oid in list(self.watchers):
            table = self.watchers[oid]
            for wkey in [k for k, wc in table.items() if wc is conn]:
                del table[wkey]
            if not table:
                del self.watchers[oid]
        for state in list(self._notifies.values()):
            stale = {
                k for k, wc in state["conns"].items() if wc is conn
            } & state["pending"]
            if stale:
                state["pending"] -= stale
                if not state["pending"]:
                    state["finish"]()

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
        (the OSD recovery wq, scaled to this PG).  While the OSD's
        recovery-storm controller is ENGAGED, admission belongs to its
        cross-PG waves — the per-PG trickle yields so wave
        pacing (and its SLO shedding) actually governs; degraded-op
        prioritization still admits directly via _recover_one."""
        if not self.peering.is_primary() or not self.peering.is_active():
            return
        storm = getattr(self.osd, "recovery_storm", None)
        if storm is not None and storm.engaged:
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

    def progress_active(self) -> bool:
        """READ-ONLY: does this PG currently have progress-worthy
        activity on this primary?  The pure predicate monitoring polls
        (tools/chaos.py) use instead of progress_status(), whose
        episode bookkeeping belongs to the OSD's own status reports."""
        p = self.peering
        return (
            p.is_primary()
            and p.is_active()
            and bool(
                p.all_missing_oids()
                or self.recovering
                or p.backfill_targets
                or self.scrubber.active
            )
        )

    def note_recovery_bytes(self, oid: str, nbytes: int) -> None:
        """Backend hook (ECBackend._push_recovered): reconstructed bytes
        fold into this PG's recovery-progress event.  Gated like the
        done counter — backfill pushes ride the same backend path but
        are not recovery."""
        if oid in self.recovering:
            self._recovery_done_bytes += int(nbytes)
            # workload attribution: recovery traffic counts
            # against its pool under the `recovery` op class, so the
            # iostat view separates tenant load from the cluster's own
            accountant = getattr(self.osd, "io_accountant", None)
            if accountant is not None:
                accountant.account(
                    self.pool.id, "recovery", "recovery", nbytes
                )

    def progress_status(self) -> list[dict]:
        """Progress events for the OSD status blob: one entry
        per active recovery / backfill / scrub on this PRIMARY, each
        with objects/bytes done vs total.  The mgr's progress module
        (mgr/progress.py) aggregates these into per-PG bars with rate +
        ETA and raises PG_RECOVERY_STALLED when one stops advancing.

        Episode bookkeeping note: this renderer maintains the recovery
        high-water total (a monotone max) and zeroes the counters once
        an episode drains — both IDEMPOTENT, so extra callers beyond
        the status heartbeat are safe; they just cannot observe a
        final done==total event (absence is the completion signal)."""
        p = self.peering
        if not p.is_primary() or not p.is_active():
            return []
        events: list[dict] = []
        outstanding = p.all_missing_oids()
        if outstanding or self.recovering:
            self._recovery_final_reports = 0  # episode (re)opened
            # high-water total: newly discovered missing objects grow
            # the denominator, they never shrink `done`
            self._recovery_total = max(
                self._recovery_total, self._recovery_done + len(outstanding)
            )
            ev = {
                "kind": "recovery",
                "objects_done": self._recovery_done,
                "objects_total": self._recovery_total,
                "bytes_done": self._recovery_done_bytes,
                "bytes_total": 0,  # unknown until rebuilt (best-effort)
            }
            inflight = getattr(self.backend, "recovery_inflight", None)
            if inflight is not None:
                ev["inflight"] = inflight()
            events.append(ev)
        elif (
            self._recovery_total
            or self._recovery_done
            or self._recovery_done_bytes
        ):
            # episode complete: emit a final done==total report so the
            # mgr can classify the event as completed (without it the
            # event simply vanishes at done<total and counts as
            # expired/lost).  Repeated on a few reports — the mgr
            # samples a last-write-wins status blob, so a one-shot
            # report can be overwritten before a module tick sees it —
            # then the counters reset so the next episode starts at
            # zero.  The done counters are checked too: an episode that
            # starts AND finishes entirely between two status reports
            # never set _recovery_total here, and its leftover done
            # count would pre-fill the next episode's bar.
            if self._recovery_done:
                if not self._recovery_final_reports:
                    self._recovery_final_reports = 3
                events.append({
                    "kind": "recovery",
                    "objects_done": self._recovery_done,
                    # everything still outstanding drained some other
                    # way (overwrites); the recovered count IS the
                    # episode's completed total
                    "objects_total": self._recovery_done,
                    "bytes_done": self._recovery_done_bytes,
                    "bytes_total": 0,
                })
                self._recovery_final_reports -= 1
            if not self._recovery_final_reports:
                self._recovery_total = 0
                self._recovery_done = 0
                self._recovery_done_bytes = 0
        if p.backfill_targets:
            heads = sorted(self._list_local())
            total = len(heads) * len(p.backfill_targets)
            done = 0
            for osd in p.backfill_targets:
                cursor = p.last_backfill.get(osd, "")
                done += bisect.bisect_right(heads, cursor)
            events.append({
                "kind": "backfill",
                "objects_done": done,
                "objects_total": max(total, done),
                "bytes_done": 0,
                "bytes_total": 0,
            })
        scrub = self.scrubber.progress()
        if scrub is not None:
            events.append(scrub)
        return events

    def blocked_ops_summary(self) -> dict:
        """What's queued and why (OpTracker's dump_blocked_ops view):
        degraded-wait, promotion-wait, and flush-wait queues by object."""
        out = {}
        if self.waiting_for_degraded:
            out["waiting_for_degraded"] = {
                oid: len(cbs) for oid, cbs in self.waiting_for_degraded.items()
            }
        if self._promoting:
            out["waiting_for_promote"] = {
                oid: len(w) for oid, w in self._promoting.items()
            }
        if self._flushing:
            out["waiting_for_flush"] = {
                oid: len(w) for oid, w in self._flushing.items()
            }
        return out

    # -- lost/unfound (PrimaryLogPG mark_all_unfound_lost; MissingLoc) ---------

    def list_unfound(self) -> list[str]:
        """Missing objects with NO live source (MissingLoc's unfound set):
        replicated — no up acting member holds a copy; EC — fewer than k
        up shards hold theirs.  Recovery of these can never complete and
        ops touching them wait forever until the operator intervenes
        (qa/tasks/ec_lost_unfound.py is the reference's coverage)."""
        p = self.peering
        if not p.is_primary() or not p.is_active():
            # conflating "wrong daemon" with "nothing unfound" would
            # mislead the operator running this against a replica
            raise ValueError(
                f"pg {self.pgid}: not the active primary here"
            )
        up_acting = [
            o
            for o in self._acting
            if o != PG_NONE and self.osd.osdmap.is_up(o)
        ]
        need = self.backend.k if self.pool.type == POOL_TYPE_ERASURE else 1
        out = []
        for oid in p.all_missing_oids():
            # a backfill target whose cursor hasn't passed `oid` holds at
            # best a STALE copy — it is not a source (same union
            # get_shard_missing applies on the read path)
            missing_on = p.osds_missing(oid) | p.backfill_pending_osds(oid)
            holders = [o for o in up_acting if o not in missing_on]
            if len(holders) < need:
                out.append(oid)
        return out

    def mark_unfound_lost(self, mode: str = "delete") -> list[str]:
        """`ceph pg <pgid> mark_unfound_lost delete` — give up on unfound
        objects: drop them from every missing set, delete surviving
        remnant shards through the normal transaction fan-out, and
        release ops queued behind their recovery (they re-run and answer
        ENOENT).  Only the reference's `delete` mode is offered: `revert`
        requires prior-version data this framework's log doesn't retain.
        """
        if mode != "delete":
            raise ValueError(
                "only mode='delete' is supported (revert needs rollback data)"
            )
        lost = self.list_unfound()
        for oid in lost:
            self.peering.missing.rm(oid)
            for m in self.peering.peer_missing.values():
                m.rm(oid)
            self.recovering.discard(oid)
            self._tier_tid += 1
            pgt = PGTransaction(oid=oid, delete=True)
            try:
                self.backend.submit_transaction(
                    pgt,
                    ReqId(
                        client=f"osd.{self.osd.whoami}.lost",
                        tid=self._tier_tid,
                    ),
                    lambda: None,
                )
            except Exception as e:
                # remnant cleanup is best-effort: the object is already
                # struck from the missing sets either way
                dout("osd", 5, f"pg {self.pgid}: lost-delete of {oid}: {e!r}")
            self.clog_error(
                f"pg {self.pgid} marking unfound object {oid} lost (deleted)"
            )
            for cb in self.waiting_for_degraded.pop(oid, []):
                cb()
        return lost

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
        import bisect

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
