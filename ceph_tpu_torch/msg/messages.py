"""The typed message catalog of the port — what the placement-group layer sends.

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
MOSDRepScrubMap; and the backfill reservation MBackfillReserve.  The type
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
