"""The typed message catalog of the port — the EC sub-ops and recovery pushes.

The port of the part of `ceph_tpu/msg/messages.py` that the EC backend
sends: the wire structs `Struct`, `PgId`, `ReqId` and `PushOp`, the four EC
sub-op messages mirroring Ceph's ECMsgTypes (src/osd/ECMsgTypes.h):
ECSubWrite carries a serialized per-shard transaction (:23-89); ECSubRead
carries per-object (off,len,flags) plus per-shard subchunk vectors
(:105-116); ECSubReadReply returns buffers/attrs/errors (:118-129) — and
the recovery pushes MOSDPGPush / MOSDPGPushReply (src/messages/
MOSDPGPush.h) and the chunky scrub's MOSDRepScrub / MOSDRepScrubMap.  The
type numbers and field orders are the JAX package's, so a message encodes
to its bytes.
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
