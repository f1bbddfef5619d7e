"""Peering state machine — mirror of src/osd/PeeringState.{h,cc}.

The port of `ceph_tpu/osd/peering.py`, with its messages and order of
sends.  The reference drives peering with a boost::statechart machine
(src/osd/PeeringState.h:460 lists the event set); the
states that matter for correctness are the primary's
GetInfo → GetLog → GetMissing → Activating → Active chain and the
replica's Stray → ReplicaActive.  This module keeps those states and the
same information flow, as plain explicit-state code:

- **GetInfo**: the primary queries every acting shard for its `pg_info_t`
  (MOSDPGQuery(INFO) → MOSDPGNotify), the reference's
  PeeringState::proc_replica_info.
- **GetLog**: if some shard's `last_update` beats ours, fetch its log
  delta (MOSDPGQuery(LOG) → MOSDPGLog) and merge it, computing our own
  missing set from the entries we had never applied
  (PGLog::merge_log / proc_master_log).
- **GetMissing** is folded into activation: the primary holds the
  authoritative log, so each lagging peer's missing set is computed
  locally from the log delta past that peer's `last_update`
  (PGLog::proc_replica_log), and the delta is pushed to the peer in
  MOSDPGLog so it reaches the same conclusion (activate_map path).
- Shards whose logs fell behind the tail cannot log-recover and become
  **backfill targets** (PeeringState's backfill machinery): instead of
  enumerating every object into a missing set up front, the primary
  walks its object namespace in sorted chunks with a `last_backfill`
  cursor per target (osd_types.h BackfillInterval), pushing each chunk
  and advancing the cursor — writes keep flowing while backfill runs,
  since repops reach the target regardless and the eventual full-object
  push includes any bytes written meanwhile.  The PG drives the scan
  (PG._kick_backfill) under local+remote reservations.
- **Active**: `missing` + `peer_missing` feed the recovery machinery
  (PGBackend::recover_object, §3.2) and degraded-object write blocking.

Epochs guard everything: a new osdmap interval restarts peering
(PeeringState::start_peering_interval), and stale messages from an older
epoch are dropped on receipt.
"""

from __future__ import annotations

import enum
from typing import TYPE_CHECKING, Callable

from ..common.log import dout
from ..msg.messages import MOSDPGLog, MOSDPGNotify, MOSDPGQuery, PgId
from .osdmap import PG_NONE
from .pg_log import Eversion, LogEntry, Missing, PGLog, PgInfo


class PeerState(enum.Enum):
    """The state names the reference's statechart uses
    (PeeringState.h Initial/Reset/Started/GetInfo/GetLog/Active/...)."""

    RESET = "Reset"
    GETINFO = "GetInfo"
    GETLOG = "GetLog"
    ACTIVE = "Active"
    REPLICA_ACTIVE = "ReplicaActive"
    STRAY = "Stray"


class PeeringState:
    """Per-PG peering driver.  Owned by the PG; sends through callbacks so
    it stays transport-agnostic (unit tests pump a queue)."""

    def __init__(
        self,
        pgid: PgId,
        whoami: int,
        log: PGLog,
        info: PgInfo,
        send: Callable[[int, object], None],
        on_active: Callable[[], None],
        list_local_objects: Callable[[], list[str]],
        drop_local_object: Callable[[str], None] | None = None,
    ):
        self.pgid = pgid
        self.whoami = whoami
        self.log = log
        self.info = info
        self.send = send
        self.on_active = on_active
        self.list_local_objects = list_local_objects
        self.drop_local_object = drop_local_object

        self.state = PeerState.RESET
        self.epoch = 0
        self.acting: list[int] = []
        self.primary: int = PG_NONE
        self.peer_info: dict[int, PgInfo] = {}
        self.missing = Missing()  # our own missing objects
        self.peer_missing: dict[int, Missing] = {}  # primary-only
        self.backfill_targets: set[int] = set()
        # lifetime count of backfills STARTED (pg stats' backfill state
        # counter): survives completion, so tests/operators can tell a
        # finished backfill from one that never happened
        self.backfill_started_total = 0
        # per-target sorted-namespace cursor: objects <= cursor are
        # backfilled ("" = none yet; advanced by PG._kick_backfill)
        self.last_backfill: dict[int, str] = {}

    # -- interval handling ----------------------------------------------------

    def start_peering_interval(self, epoch: int, acting: list[int]) -> None:
        """New map interval (PeeringState::start_peering_interval):
        drop in-flight peering state and restart from GetInfo/Stray."""
        self.epoch = epoch
        self.acting = list(acting)
        self.primary = next((o for o in acting if o != PG_NONE), PG_NONE)
        self.peer_info = {}
        self.peer_missing = {}
        self.backfill_targets = set()
        self.last_backfill = {}
        if self.primary != self.whoami:
            self.state = PeerState.STRAY
            return
        self.state = PeerState.GETINFO
        peers = self._up_peers()
        if not peers:
            self._activate()
            return
        for osd in peers:
            self.send(
                osd,
                MOSDPGQuery(
                    pgid=self.pgid,
                    op=MOSDPGQuery.INFO,
                    epoch=self.epoch,
                    from_osd=self.whoami,
                    since_epoch=0,
                    since_ver=0,
                ),
            )

    def _up_peers(self) -> list[int]:
        return [o for o in self.acting if o not in (self.whoami, PG_NONE)]

    def tick(self) -> None:
        """Liveness re-kick (the reference gets this from statechart
        timeouts + map-advance requeues): a primary stuck in GetInfo or
        GetLog re-sends its one-shot queries — a dropped message (peer's
        map behind, connection reset) must not wedge the PG forever."""
        if self.state in (PeerState.GETINFO, PeerState.GETLOG):
            self.start_peering_interval(self.epoch, self.acting)

    def is_primary(self) -> bool:
        return self.primary == self.whoami

    def is_active(self) -> bool:
        return self.state in (PeerState.ACTIVE, PeerState.REPLICA_ACTIVE)

    # -- message handling ------------------------------------------------------

    def handle_query(self, msg: MOSDPGQuery) -> None:
        """A primary asks for our info or log (replica side)."""
        if msg.epoch < self.epoch:
            return  # stale interval
        if msg.op == MOSDPGQuery.INFO:
            self.send(
                msg.from_osd,
                MOSDPGNotify(
                    pgid=self.pgid,
                    info=self.info.tobytes(),
                    epoch=msg.epoch,
                    from_osd=self.whoami,
                ),
            )
        elif msg.op == MOSDPGQuery.LOG:
            since = self._common_point(Eversion(msg.since_epoch, msg.since_ver))
            if self.log.can_catch_up(since):
                entries = self.log.entries_after(since)
            else:
                entries = list(self.log.entries)  # best effort full log
                since = self.log.tail
            blob = _pack_entries(entries)
            self.send(
                msg.from_osd,
                MOSDPGLog(
                    pgid=self.pgid,
                    info=self.info.tobytes(),
                    log=blob,
                    epoch=msg.epoch,
                    from_osd=self.whoami,
                    since_epoch=since.epoch,
                    since_ver=since.version,
                ),
            )

    def _common_point(self, v: Eversion) -> Eversion:
        """Newest point of agreement with a peer claiming head `v`.

        If `v` is not an entry of our log (and is inside our log window),
        the peer's head is DIVERGENT — it logged writes the surviving
        acting set never saw (e.g. an old primary that crashed before
        replicating).  The delta must then start from our newest entry
        below `v`, so the peer can detect and rewind everything past it
        (PeeringState::proc_replica_log / PGLog::rewind_divergent_log)."""
        if (
            not v
            or v <= self.log.tail
            or any(e.version == v for e in self.log.entries)
        ):
            return v
        older = [e.version for e in self.log.entries if e.version < v]
        return max(older) if older else self.log.tail

    def handle_notify(self, msg: MOSDPGNotify) -> None:
        """proc_replica_info: gather infos during GetInfo."""
        if msg.epoch != self.epoch or self.state != PeerState.GETINFO:
            return
        self.peer_info[msg.from_osd] = PgInfo.frombytes(msg.info)
        if set(self.peer_info) >= set(self._up_peers()):
            self._choose_auth_log()

    def _choose_auth_log(self) -> None:
        """find_best_info (PeeringState.cc): highest last_update wins;
        ties break toward ourselves to avoid a needless log fetch."""
        best_osd, best = self.whoami, self.info
        for osd, info in self.peer_info.items():
            if info.last_update > best.last_update:
                best_osd, best = osd, info
        if best_osd == self.whoami:
            self._activate()
            return
        self.state = PeerState.GETLOG
        self.auth_osd = best_osd
        self.send(
            best_osd,
            MOSDPGQuery(
                pgid=self.pgid,
                op=MOSDPGQuery.LOG,
                epoch=self.epoch,
                from_osd=self.whoami,
                since_epoch=self.log.head.epoch,
                since_ver=self.log.head.version,
            ),
        )

    def handle_log(self, msg: MOSDPGLog) -> None:
        """Either the auth shard's reply to our GetLog (primary) or the
        primary's activation delta (replica)."""
        if msg.epoch != self.epoch:
            return
        entries = _unpack_entries(msg.log)
        since = Eversion(msg.since_epoch, msg.since_ver)
        if self.state == PeerState.GETLOG and msg.from_osd == getattr(
            self, "auth_osd", None
        ):
            auth_info = PgInfo.frombytes(msg.info)
            self._merge_log(entries, auth_last=auth_info.last_update, since=since)
            self.info.last_update = auth_info.last_update
            self._activate()
        elif self.state in (PeerState.STRAY, PeerState.REPLICA_ACTIVE):
            auth_info = PgInfo.frombytes(msg.info)
            self._merge_log(entries, auth_last=auth_info.last_update, since=since)
            self.info.last_update = self.log.head
            self.info.last_epoch_started = msg.epoch
            self.state = PeerState.REPLICA_ACTIVE
            dout("osd", 10, f"pg {self.pgid} replica active @ {self.log.head}")

    def _merge_log(
        self,
        entries: list[LogEntry],
        auth_last: Eversion | None = None,
        since: Eversion | None = None,
    ) -> None:
        """PGLog::merge_log: adopt the authoritative delta.

        `since` is the point the sender computed the delta from (its newest
        entry at/below our claimed head).  Local entries past `since` that
        are absent from the delta are DIVERGENT — writes the rest of the
        acting set never saw, including the canonical failover case where a
        dead primary's unreplicated write sits at an *older* epoch than the
        new auth head.  The reference rewinds them to prior_version
        (PGLog::_merge_divergent_entries); here the entry is dropped from
        the log, the divergent on-disk copy is dropped (so recovery PULLS
        the authoritative version instead of pushing the stale copy back
        out), and the object is marked missing at prior_version."""
        if auth_last is not None:
            start = since if since is not None else auth_last
            delta_versions = {
                (e.version.epoch, e.version.version) for e in entries
            }
            divergent = [
                e
                for e in self.log.entries
                if e.version > start
                and (e.version.epoch, e.version.version) not in delta_versions
            ]
            if divergent:
                keep = {id(e) for e in divergent}
                self.log.entries = [
                    e for e in self.log.entries if id(e) not in keep
                ]
                rewound: set[str] = set()
                for e in divergent:
                    if e.oid in rewound:
                        continue
                    rewound.add(e.oid)
                    dout(
                        "osd",
                        5,
                        f"pg {self.pgid} rewinding divergent {e.oid} "
                        f"{e.version} -> {e.prior_version}",
                    )
                    if self.drop_local_object is not None:
                        self.drop_local_object(e.oid)
                    if e.prior_version:
                        self.missing.add(e.oid, e.prior_version)
                    else:
                        # created by the divergent write: it simply should
                        # not exist; nothing to recover
                        self.missing.rm(e.oid)
        for entry in entries:
            if entry.version > self.log.head:
                self.log.append(entry)
                self.missing.add_next_event(entry)

    # -- activation ------------------------------------------------------------

    def _activate(self) -> None:
        """PeeringState::activate: compute peer missing sets, ship log
        deltas, open for business."""
        self.state = PeerState.ACTIVE
        self.info.last_epoch_started = self.epoch
        head = self.log.head
        for osd in self._up_peers():
            pinfo = self.peer_info.get(osd, PgInfo())
            # A peer whose claimed head is not in our (authoritative) log
            # holds divergent entries: rewind its effective head to the
            # newest agreed point so the delta spans the divergent region
            # and the peer can detect + rewind it (proc_replica_log).
            peer_head = self._common_point(pinfo.last_update)
            if pinfo.last_update >= head and peer_head == pinfo.last_update:
                self.peer_missing[osd] = Missing()
                continue
            if self.log.can_catch_up(peer_head):
                # proc_replica_log: delta past the peer's head = its missing
                self.peer_missing[osd] = self.log.missing_from(peer_head)
                delta = self.log.entries_after(peer_head)
                delta_since = peer_head
            else:
                # Log trimmed past the peer: chunked backfill, not an
                # up-front mark-all-missing.  peer_missing stays empty so
                # client writes are not blocked as degraded; the PG's
                # backfill driver copies the namespace behind a cursor.
                self.backfill_targets.add(osd)
                self.backfill_started_total += 1
                self.last_backfill[osd] = ""
                self.peer_missing[osd] = Missing()
                delta = list(self.log.entries)
                delta_since = self.log.tail
            blob = _pack_entries(delta)
            self.send(
                osd,
                MOSDPGLog(
                    pgid=self.pgid,
                    info=self.info.tobytes(),
                    log=blob,
                    epoch=self.epoch,
                    from_osd=self.whoami,
                    since_epoch=delta_since.epoch,
                    since_ver=delta_since.version,
                ),
            )
        dout(
            "osd",
            10,
            f"pg {self.pgid} active @ e{self.epoch}: "
            f"{len(self.missing)} missing here, "
            f"{sum(len(m) for m in self.peer_missing.values())} on peers",
        )
        self.on_active()

    # -- recovery bookkeeping --------------------------------------------------

    def object_missing_anywhere(self, oid: str) -> bool:
        return oid in self.missing or any(
            oid in m for m in self.peer_missing.values()
        )

    def osds_missing(self, oid: str) -> set[int]:
        """OSDs (not shards) that lack oid."""
        out = {o for o, m in self.peer_missing.items() if oid in m}
        if oid in self.missing:
            out.add(self.whoami)
        return out

    def backfill_pending_osds(self, oid: str) -> set[int]:
        """Backfill targets whose cursor has not passed `oid`: their copy
        (if any) is STALE and must never serve reads — the availability
        gate mark-all-missing used to provide, without the write blocking
        (is_backfill_target + last_backfill comparison in the reference's
        missing_loc)."""
        return {
            o
            for o in self.backfill_targets
            if oid > self.last_backfill.get(o, "")
        }

    def mark_recovered(self, oid: str, osd: int) -> None:
        if osd == self.whoami:
            self.missing.rm(oid)
        elif osd in self.peer_missing:
            self.peer_missing[osd].rm(oid)

    def all_missing_oids(self) -> list[str]:
        oids: set[str] = set(self.missing.items)
        for m in self.peer_missing.values():
            oids.update(m.items)
        return sorted(oids)


def _pack_entries(entries: list[LogEntry]) -> bytes:
    return b"".join(
        len(e := entry.tobytes()).to_bytes(4, "little") + e for entry in entries
    )


def _unpack_entries(blob: bytes) -> list[LogEntry]:
    entries: list[LogEntry] = []
    off = 0
    while off < len(blob):
        ln = int.from_bytes(blob[off : off + 4], "little")
        off += 4
        entries.append(LogEntry.frombytes(blob[off : off + ln]))
        off += ln
    return entries
