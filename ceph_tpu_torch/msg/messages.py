"""The typed message catalog of the port — what the PGs and the OSD daemon send.

The port of the part of `ceph_tpu/msg/messages.py` that the PGs and their
backends send: the wire structs `Struct`, `PgId`, `OSDOp`, `ReqId` and
`PushOp`; the client op and its reply (MOSDOp, MOSDOpReply); the map
publication MOSDMap; the four EC sub-op messages mirroring Ceph's
ECMsgTypes (src/osd/ECMsgTypes.h): ECSubWrite carries a serialized
per-shard transaction (:23-89); ECSubRead carries per-object
(off,len,flags) plus per-shard subchunk vectors (:105-116); ECSubReadReply
returns buffers/attrs/errors (:118-129); the peering messages MOSDPGQuery,
MOSDPGNotify and MOSDPGLog; the recovery pushes MOSDPGPush / MOSDPGPushReply
(src/messages/MOSDPGPush.h) and the replicated backend's MOSDRepOp,
MOSDRepOpReply and MOSDPGPull; the chunky scrub's MOSDRepScrub /
MOSDRepScrubMap; the backfill reservation MBackfillReserve; and the OSD
daemon's: heartbeats (MPing, MOSDPing), boot and failure reports
(MOSDBoot, MOSDFailure), the monitor client's (MMonCommand,
MMonCommandAck, MMonSubscribe), the mgr's (MMgrMap, MMgrReport), config
and cluster log (MConfig, MLog) and watch/notify (MWatchNotify); and the
monitors' and the mgr's own: Paxos and elections (MMonPaxos,
MMonElection), the mgr's beacon and digest (MMgrBeacon, MMonMgrReport),
the MDS map service's (MMDSBeacon, MMDSMap); and CephFS's client
protocol (MClientRequest, MClientReply, MClientCaps).  The type
numbers and field orders are the JAX package's, so a message encodes to its
bytes.
"""

from __future__ import annotations

from .message import Message, message_type, PRIO_HIGH


class Struct(Message):
    """A nested wire struct using the same FIELDS machinery as Message
    (WRITE_CLASS_ENCODER on plain types); never sent standalone."""


class PgId(Struct):
    """spg_t analog: pool + placement seed + shard (-1 = whole PG /
    replicated)."""

    FIELDS = [("pool", "u64"), ("ps", "u32"), ("shard", "i64")]

    def __init__(self, pool=0, ps=0, shard=-1):
        super().__init__(pool=pool, ps=ps, shard=shard)

    def key(self) -> tuple[int, int]:
        return (self.pool, self.ps)

    def with_shard(self, shard: int) -> "PgId":
        return PgId(self.pool, self.ps, shard)

    def __repr__(self):
        return f"{self.pool}.{self.ps}s{self.shard}"

    def __eq__(self, other):
        return (
            isinstance(other, PgId)
            and (self.pool, self.ps, self.shard)
            == (other.pool, other.ps, other.shard)
        )

    def __hash__(self):
        return hash((self.pool, self.ps, self.shard))


class OSDOp(Struct):
    """One client sub-operation (osd_types.h OSDOp / do_osd_ops codes)."""

    # op codes (CEPH_OSD_OP_* analog)
    READ = 1
    WRITE = 2
    WRITEFULL = 3
    DELETE = 4
    STAT = 5
    TRUNCATE = 6
    APPEND = 7
    GETXATTR = 8
    SETXATTR = 9
    PGLS = 10  # list objects in the PG (rados ls; PrimaryLogPG do_pgnls)
    ROLLBACK = 11     # roll head back to a snap's clone (off = snap id)
    LIST_SNAPS = 12   # dump the object's SnapSet
    WATCH = 13        # register/unregister a watch (off = cookie, len = 1/0)
    NOTIFY = 14       # notify watchers (data = payload, off = timeout ms)
    COPY_FROM = 15    # copy another object's content (name = src oid)
    CACHE_FLUSH = 16  # write a dirty cache-tier object back to the base pool
    CACHE_EVICT = 17  # drop a clean object from the cache tier
    CALL = 18         # object-class method (name = "cls.method", data = input)
    GETXATTRS = 19    # bulk-dump all client xattrs (copy-get attr leg)
    RMXATTR = 20      # remove one client xattr (CEPH_OSD_OP_RMXATTR)
    # omap (CEPH_OSD_OP_OMAP*): str->bytes KV attached to the object,
    # replicated pools only (the reference rejects omap on EC pools too)
    OMAPGETKEYS = 21  # -> encoded str list
    OMAPGETVALS = 22  # -> encoded kv map (whole omap)
    OMAPSETVALS = 23  # data = encoded kv map to merge
    OMAPRMKEYS = 24   # data = encoded str list
    OMAPCLEAR = 25
    CMPXATTR = 26     # guard: xattr vs data per `off` mode; -ECANCELED on miss
    LIST_WATCHERS = 27  # dump the object's watch table (rados listwatchers)
    ZERO = 28         # zero an extent (CEPH_OSD_OP_ZERO)
    WRITESAME = 29    # tile `data` across [off, off+len) (CEPH_OSD_OP_WRITESAME)

    FIELDS = [
        ("op", "u8"),
        ("off", "u64"),
        ("len", "u64"),
        ("data", "bytes"),
        ("name", "str"),  # xattr name for *XATTR ops
    ]

    def __init__(self, op=0, off=0, len=0, data=b"", name=""):
        super().__init__(op=op, off=off, len=len, data=data, name=name)


class ReqId(Struct):
    """osd_reqid_t: originating entity + client-unique tid."""

    FIELDS = [("client", "str"), ("tid", "u64")]

    def __init__(self, client="", tid=0):
        super().__init__(client=client, tid=tid)

    def key(self) -> tuple[str, int]:
        return (self.client, self.tid)


class PushOp(Struct):
    """Recovery push payload (osd_types.h PushOp, carried by MOSDPGPush)."""

    FIELDS = [
        ("oid", "str"),
        ("data", "bytes"),
        ("attrs", ("map", "str", "bytes")),
        ("version", "u64"),
        ("omap", ("map", "str", "bytes")),
    ]

    def __init__(self, oid="", data=b"", attrs=None, version=0, omap=None):
        super().__init__(
            oid=oid, data=data, attrs=attrs or {}, version=version,
            omap=omap or {},
        )


# --- client I/O --------------------------------------------------------------


@message_type(4)
class MOSDOp(Message):
    """Client op to the primary (src/messages/MOSDOp.h).

    Snapshot plumbing rides the op like the reference's: writes carry the
    client's SnapContext (`snap_seq` + descending `snaps`, the
    self-managed-snap model) so the PG can clone-on-first-write; reads
    carry `snap_id` (0 = head, CEPH_NOSNAP analog inverted for
    compactness) to address a snapshot's clone."""

    FIELDS = [
        ("reqid", ReqId),
        ("pgid", PgId),
        ("oid", "str"),
        ("ops", ("list", OSDOp)),
        ("epoch", "u32"),
        ("snap_seq", "u64"),
        ("snaps", ("list", "u64")),
        ("snap_id", "u64"),
    ]

    def __init__(
        self,
        reqid=None,
        pgid=None,
        oid="",
        ops=None,
        epoch=0,
        snap_seq=0,
        snaps=None,
        snap_id=0,
    ):
        super().__init__(
            reqid=reqid,
            pgid=pgid,
            oid=oid,
            ops=ops or [],
            epoch=epoch,
            snap_seq=snap_seq,
            snaps=snaps or [],
            snap_id=snap_id,
        )


@message_type(5)
class MOSDOpReply(Message):
    """src/messages/MOSDOpReply.h."""

    FIELDS = [
        ("reqid", ReqId),
        ("result", "i64"),
        ("outdata", ("list", "bytes")),  # per-op output
        ("version", "u64"),
        ("epoch", "u32"),
    ]


@message_type(13)
class MOSDMap(Message):
    """Map publication (src/messages/MOSDMap.h): full maps and/or
    incrementals keyed by epoch."""

    FIELDS = [
        ("fsid", "str"),
        ("maps", ("map", "u32", "bytes")),
        ("incrementals", ("map", "u32", "bytes")),
    ]


# --- EC sub-ops (ECMsgTypes.h) ----------------------------------------------


@message_type(6)
class MOSDECSubOpWrite(Message):
    """Primary -> shard write (MOSDECSubOpWrite.h; ECSubWrite at
    ECMsgTypes.h:23-89).  `txn` is the encoded per-shard ObjectStore
    transaction; log_entries roll the PG log forward on the shard."""

    FIELDS = [
        ("pgid", PgId),
        ("from_osd", "u32"),
        ("tid", "u64"),
        ("reqid", ReqId),
        ("txn", "bytes"),
        ("at_version", "u64"),
        ("log_entries", ("list", "bytes")),
    ]
    priority = PRIO_HIGH


@message_type(7)
class MOSDECSubOpWriteReply(Message):
    FIELDS = [
        ("pgid", PgId),
        ("from_osd", "u32"),
        ("tid", "u64"),
        ("committed", "bool"),
    ]
    priority = PRIO_HIGH


@message_type(8)
class MOSDECSubOpRead(Message):
    """Primary -> shard read (ECSubRead, ECMsgTypes.h:105-116):
    per-object extent lists plus CLAY subchunk (offset,count) runs."""

    FIELDS = [
        ("pgid", PgId),
        ("from_osd", "u32"),
        ("tid", "u64"),
        # oid -> list of (off, len) extents
        ("to_read", ("map", "str", ("list", ("list", "u64")))),
        # oid -> subchunk (offset, count) runs within each chunk
        ("subchunks", ("map", "str", ("list", ("list", "u64")))),
        ("attrs_to_read", ("list", "str")),
    ]
    priority = PRIO_HIGH


@message_type(9)
class MOSDECSubOpReadReply(Message):
    """ECSubReadReply (ECMsgTypes.h:118-129): buffers + attrs + errors."""

    FIELDS = [
        ("pgid", PgId),
        ("from_osd", "u32"),
        ("tid", "u64"),
        # oid -> list of (off, data) returned extents
        ("buffers", ("map", "str", ("list", ("list", "bytes")))),
        ("attrs", ("map", "str", ("map", "str", "bytes"))),
        ("errors", ("map", "str", "i64")),
    ]
    priority = PRIO_HIGH


# --- peering -----------------------------------------------------------------


@message_type(19)
class MOSDPGQuery(Message):
    """Primary asks a shard for its pg_info or log tail
    (src/messages/MOSDPGQuery.h; pg_query_t INFO/LOG types in
    osd_types.h)."""

    INFO = 1
    LOG = 2

    FIELDS = [
        ("pgid", PgId),
        ("op", "u8"),
        ("epoch", "u32"),
        ("from_osd", "u32"),
        # LOG queries: send entries after (since_epoch, since_ver)
        ("since_epoch", "u32"),
        ("since_ver", "u64"),
    ]


@message_type(20)
class MOSDPGNotify(Message):
    """Shard replies with pg_info (src/messages/MOSDPGNotify.h)."""

    FIELDS = [("pgid", PgId), ("info", "bytes"), ("epoch", "u32"), ("from_osd", "u32")]


@message_type(21)
class MOSDPGLog(Message):
    FIELDS = [
        ("pgid", PgId),
        ("info", "bytes"),
        ("log", "bytes"),
        ("epoch", "u32"),
        ("from_osd", "u32"),
        # the version the delta starts after — lets the receiver detect
        # local entries in (since, head] absent from the delta as divergent
        ("since_epoch", "u32"),
        ("since_ver", "u64"),
    ]


# --- recovery pushes --------------------------------------------------------


@message_type(22)
class MOSDPGPush(Message):
    """Recovery pushes (src/messages/MOSDPGPush.h; the WRITING stage)."""

    FIELDS = [
        ("pgid", PgId),
        ("pushes", ("list", PushOp)),
        ("epoch", "u32"),
        ("from_osd", "u32"),
    ]


@message_type(23)
class MOSDPGPushReply(Message):
    FIELDS = [
        ("pgid", PgId),
        ("oids", ("list", "str")),
        ("epoch", "u32"),
        ("from_osd", "u32"),
    ]


@message_type(24)
class MOSDRepOp(Message):
    """Primary -> replica transaction for replicated pools
    (src/messages/MOSDRepOp.h; fanned out by
    ReplicatedBackend::submit_transaction)."""

    FIELDS = [
        ("pgid", PgId),
        ("from_osd", "u32"),
        ("tid", "u64"),
        ("reqid", ReqId),
        ("txn", "bytes"),
        ("log_entries", ("list", "bytes")),
    ]
    priority = PRIO_HIGH


@message_type(25)
class MOSDRepOpReply(Message):
    FIELDS = [("pgid", PgId), ("from_osd", "u32"), ("tid", "u64")]
    priority = PRIO_HIGH


@message_type(26)
class MOSDPGPull(Message):
    """Primary asks a replica to push an object it is itself missing
    (src/messages/MOSDPGPull.h)."""

    FIELDS = [("pgid", PgId), ("oid", "str"), ("epoch", "u32"), ("from_osd", "u32")]


# --- scrub ------------------------------------------------------------------


@message_type(27)
class MOSDRepScrub(Message):
    """Primary asks a shard for its scrub map over an object chunk
    (src/messages/MOSDRepScrub.h; chunky scrub in
    src/osd/scrubber/pg_scrubber.cc)."""

    FIELDS = [
        ("pgid", PgId),
        ("epoch", "u32"),
        ("from_osd", "u32"),
        ("deep", "bool"),
        ("scrub_tid", "u64"),
        # chunk boundaries: scrub objects with start <= name < end
        # ("" end = unbounded)
        ("chunk_start", "str"),
        ("chunk_end", "str"),
    ]


@message_type(28)
class MOSDRepScrubMap(Message):
    """Shard's scrub map reply (src/messages/MOSDRepScrubMap.h);
    `scrub_map` is a JSON blob of oid -> {size, digest, ...}."""

    FIELDS = [
        ("pgid", PgId),
        ("epoch", "u32"),
        ("from_osd", "u32"),
        ("scrub_tid", "u64"),
        ("scrub_map", "bytes"),
    ]


# --- backfill reservation ----------------------------------------------------


@message_type(34)
class MBackfillReserve(Message):
    """Backfill reservation protocol (src/messages/MBackfillReserve.h):
    the primary reserves a remote slot on each backfill target before
    scanning (AsyncReserver handshake), releasing it on completion or
    interval change."""

    REQUEST, GRANT, REJECT, RELEASE = 0, 1, 2, 3

    FIELDS = [
        ("pgid", PgId),
        ("op", "u8"),
        ("epoch", "u32"),
        ("from_osd", "u32"),
    ]


# --- the daemon's liveness, boot and failure reports ------------------------


@message_type(1)
class MPing(Message):
    FIELDS = [("stamp", "f64")]


@message_type(10)
class MOSDPing(Message):
    """OSD<->OSD heartbeat (src/messages/MOSDPing.h; handled at
    OSD.cc:5463 handle_osd_ping)."""

    PING = 1
    PING_REPLY = 2

    FIELDS = [("op", "u8"), ("stamp", "f64"), ("epoch", "u32"), ("from_osd", "u32")]
    priority = PRIO_HIGH


@message_type(11)
class MOSDBoot(Message):
    """OSD -> mon boot announcement (src/messages/MOSDBoot.h)."""

    FIELDS = [("osd", "u32"), ("addr", "str"), ("epoch", "u32")]


@message_type(12)
class MOSDFailure(Message):
    """OSD -> mon failure report (src/messages/MOSDFailure.h; quorum
    checked at OSDMonitor.cc:2791 prepare_failure)."""

    FIELDS = [
        ("target", "u32"),
        ("target_addr", "str"),
        ("failed_for", "f64"),
        ("epoch", "u32"),
        # 0 = dead (unresponsive, the classic report); 1 =
        # laggy (heartbeats answered but slow — the gray-failure state:
        # mon surfaces OSD_SLOW_PEER, never marks down); 2 = laggy
        # cleared (the reporter's peer recovered)
        ("laggy", "u8"),
    ]

    def __init__(self, target=0, target_addr="", failed_for=0.0,
                 epoch=0, laggy=0, **kw):
        super().__init__(
            target=target, target_addr=target_addr,
            failed_for=failed_for, epoch=epoch, laggy=laggy, **kw,
        )

# --- the monitor client's messages -------------------------------------------


@message_type(14)
class MMonCommand(Message):
    """CLI/admin command (src/messages/MMonCommand.h); cmd is the JSON
    command blob like the reference's cmdmap."""

    FIELDS = [("tid", "u64"), ("cmd", "str")]


@message_type(15)
class MMonCommandAck(Message):
    FIELDS = [("tid", "u64"), ("retval", "i64"), ("rs", "str"), ("outbl", "bytes")]


@message_type(16)
class MMonSubscribe(Message):
    """Subscriptions (src/messages/MMonSubscribe.h): what -> start epoch;
    the mon pushes updates (osdmap) as they commit."""

    FIELDS = [("what", ("map", "str", "u32"))]


# --- the monitors' own: Paxos and elections ----------------------------------


@message_type(17)
class MMonPaxos(Message):
    """Paxos protocol (src/messages/MMonPaxos.h)."""

    OP_COLLECT = 1
    OP_LAST = 2
    OP_BEGIN = 3
    OP_ACCEPT = 4
    OP_COMMIT = 5
    OP_LEASE = 6
    # the peon's answer to a lease (Ceph's OP_LEASE_ACK); the port's
    # monitors send both, the JAX package's ignore them (ROADMAP C16)
    OP_LEASE_ACK = 7

    FIELDS = [
        ("op", "u8"),
        ("pn", "u64"),
        ("last_committed", "u64"),
        ("values", ("map", "u64", "bytes")),
        # pn under which an accepted-but-uncommitted value (at slot
        # last_committed+1 in `values`) was accepted; 0 = none
        ("uncommitted_pn", "u64"),
    ]
    priority = PRIO_HIGH

    def __init__(self, uncommitted_pn: int = 0, **kwargs):
        super().__init__(uncommitted_pn=uncommitted_pn, **kwargs)


@message_type(18)
class MMonElection(Message):
    """Mon elections (src/messages/MMonElection.h / ElectionLogic)."""

    OP_PROPOSE = 1
    OP_ACK = 2
    OP_VICTORY = 3

    # `quorum` rides OP_VICTORY so every member (peons included) learns
    # the full quorum set, as the reference's victory message does.
    FIELDS = [("op", "u8"), ("epoch", "u64"), ("rank", "u32"),
              ("quorum", ("list", "u32"))]
    priority = PRIO_HIGH

    def __init__(self, op=0, epoch=0, rank=0, quorum=None):
        super().__init__(op=op, epoch=epoch, rank=rank, quorum=quorum or [])


# --- mgr, config and cluster-log services ------------------------------------


@message_type(29)
class MMgrBeacon(Message):
    """Mgr -> mon availability beacon (src/messages/MMgrBeacon.h);
    drives MgrMonitor's active/standby election."""

    FIELDS = [("name", "str"), ("addr", "str")]


@message_type(30)
class MMgrMap(Message):
    """Mon -> subscribers: who the active mgr is
    (src/messages/MMgrMap.h / MgrMap)."""

    FIELDS = [
        ("epoch", "u32"),
        ("active_name", "str"),
        ("active_addr", "str"),
        ("standbys", ("list", "str")),
    ]


@message_type(31)
class MMgrReport(Message):
    """Daemon -> mgr perf/status report (src/messages/MMgrReport.h;
    consumed by DaemonServer).  perf/status are JSON blobs."""

    FIELDS = [("daemon", "str"), ("perf", "bytes"), ("status", "bytes")]


@message_type(32)
class MConfig(Message):
    """Mon -> subscriber: centrally-managed config relevant to that entity
    (src/messages/MConfig.h; built by ConfigMonitor::check_sub from the
    global < type-section < entity layering).  `changes` is a JSON object
    {option: raw value}."""

    FIELDS = [("version", "u32"), ("changes", "bytes")]


@message_type(33)
class MLog(Message):
    """Cluster-log entries (src/messages/MLog.h), both directions: daemons
    send new entries to the mons (LogClient -> LogMonitor), the mons push
    committed entries to "log" subscribers.  `entries` is a JSON list of
    {"prio", "who", "stamp", "msg"}; `version` is the committed log version
    (0 on the daemon->mon leg)."""

    FIELDS = [("version", "u64"), ("entries", "bytes")]


@message_type(35)
class MWatchNotify(Message):
    """Watch/notify push + ack (src/messages/MWatchNotify.h): the primary
    pushes a notify to every watcher's session; watchers ack with the same
    type (`is_ack`=1) carrying their optional reply payload."""

    FIELDS = [
        ("oid", "str"),
        ("pgid", PgId),
        ("notify_id", "u64"),
        ("cookie", "u64"),
        ("payload", "bytes"),
        ("is_ack", "u8"),
        ("watcher", "str"),  # acking entity name
    ]


# --- MDS / CephFS ------------------------------------------------------------


@message_type(36)
class MClientRequest(Message):
    """Client -> MDS metadata op (src/messages/MClientRequest.h).  `op` is
    the request name (mkdir, create, lookup, readdir, unlink, rmdir,
    rename, setattr, open, release); `args` is a JSON blob — the dynamic
    shape of the reference's filepath+args union.  `client` (v2) is the
    sender's per-instance identity: with a STABLE tid across retries it
    forms the (client, tid) reqid the MDS's completed-request table
    dedups on, so a retried non-idempotent op (mkdir/create/unlink/
    rename) replays its recorded reply instead of re-executing ('' = a
    v1 sender; no dedup)."""

    VERSION = 2
    COMPAT = 1
    FIELDS = [
        ("tid", "u64"), ("op", "str"), ("args", "bytes"), ("client", "str")
    ]

    @classmethod
    def decode(cls, dec):
        # struct_v-gated tail (encoding.h WRITE_CLASS_ENCODER shape): a
        # v1 frame simply lacks `client` and decodes as a no-dedup
        # sender, instead of overrunning the versioned frame
        struct_v = dec.start(cls.VERSION)
        msg = cls.__new__(cls)
        msg.src = ""
        msg.seq = 0
        msg.tid = dec.u64()
        msg.op = dec.string()
        msg.args = dec.bytes_()
        msg.client = dec.string() if struct_v >= 2 else ""
        dec.finish()
        return msg


@message_type(37)
class MClientReply(Message):
    """MDS -> client reply (src/messages/MClientReply.h): result errno +
    JSON payload (inode records, dentry lists, cap grants)."""

    FIELDS = [("tid", "u64"), ("result", "i64"), ("payload", "bytes")]


@message_type(38)
class MClientCaps(Message):
    """Capability traffic both ways (src/messages/MClientCaps.h): the MDS
    REVOKEs caps it granted; clients ACK revokes and RELEASE caps they
    drop.  `caps` is the wanted/held mask ("r", "w", "rw")."""

    REVOKE, ACK, RELEASE = 0, 1, 2

    FIELDS = [("op", "u8"), ("ino", "u64"), ("caps", "str"), ("tid", "u64")]


# --- the MDS map and the mgr's digest ----------------------------------------


@message_type(39)
class MMDSBeacon(Message):
    """MDS -> mon availability beacon (src/messages/MMDSBeacon.h): drives
    MDSMonitor's rank assignment and failover.  `state` is the daemon's
    self-reported state (boot / standby / active).  `client` is the
    daemon's RADOS client instance id (objecter reqid name, '' when the
    daemon runs embedded without one): what the MDSMonitor blocklists
    through the OSDMonitor when it fails this daemon over — the
    reference's MDSMonitor::fail_mds_gid blocklisting the gid's addrs."""

    FIELDS = [
        ("name", "str"), ("addr", "str"), ("state", "str"), ("client", "str")
    ]


@message_type(41)
class MMonMgrReport(Message):
    """Active mgr -> mons: the PGMap digest (src/messages/
    MMonMgrReport.h).  `digest` is a JSON pool-stats summary the mon
    serves through `ceph df` / health; volatile (re-sent each beacon
    interval), not paxos state — the freshest report wins."""

    FIELDS = [("digest", "bytes")]


@message_type(40)
class MMDSMap(Message):
    """Mon -> subscribers: the FSMap (src/messages/MMDSMap.h + FSMap):
    per-filesystem rank-0 holders plus the shared standby pool, as a
    JSON envelope {"filesystems": {name: {meta_pool, data_pool,
    active_name, active_addr}}, "standbys": {daemon: addr}}.  Clients
    resolve their filesystem's active MDS from this; standby daemons
    learn here which filesystem they were promoted to."""

    FIELDS = [("epoch", "u32"), ("fsmap", "bytes")]

    def filesystems(self) -> dict:
        import json as _json

        return _json.loads(self.fsmap.decode() or "{}").get("filesystems", {})
