"""PG log, info, and missing set — mirror of src/osd/PGLog / osd_types.

The port of `ceph_tpu/osd/pg_log.py`, with its encodings, so a log entry
or an info a shard sends is byte-identical across the two packages.
Ceph: src/osd/PGLog.{h,cc} and osd_types.h
(`pg_log_entry_t`, `pg_info_t`, `pg_missing_t`).  The log is the
authoritative per-PG mutation history: every write appends an entry at a
monotonically increasing `eversion_t` (epoch, version); peering compares
shard logs to find the authoritative history, and divergent shards compute
their missing set by walking the delta (PGLog::proc_replica_log /
pg_missing_t::add_next_event analog in `Missing.add_next_event`).
Shards whose logs fell too far behind recover by backfill instead.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..common.encoding import Decoder, Encodable, Encoder


@dataclass(frozen=True, order=True)
class Eversion:
    """eversion_t: (epoch, version), totally ordered."""

    epoch: int = 0
    version: int = 0

    def __bool__(self) -> bool:
        return self.epoch != 0 or self.version != 0

    def encode(self, enc: Encoder) -> None:
        enc.u32(self.epoch)
        enc.u64(self.version)

    @classmethod
    def decode(cls, dec: Decoder) -> "Eversion":
        return cls(dec.u32(), dec.u64())


# Log entry op kinds (pg_log_entry_t::MODIFY/DELETE/...).
LOG_MODIFY = 1
LOG_DELETE = 2
LOG_ERROR = 4


@dataclass
class LogEntry(Encodable):
    """pg_log_entry_t: one mutation in the PG's history."""

    op: int = LOG_MODIFY
    oid: str = ""
    version: Eversion = field(default_factory=Eversion)
    prior_version: Eversion = field(default_factory=Eversion)
    reqid: tuple[str, int] = ("", 0)

    def is_delete(self) -> bool:
        return self.op == LOG_DELETE

    def encode(self, enc: Encoder) -> None:
        enc.start(1, 1)
        enc.u8(self.op)
        enc.string(self.oid)
        self.version.encode(enc)
        self.prior_version.encode(enc)
        enc.string(self.reqid[0])
        enc.u64(self.reqid[1])
        enc.finish()

    @classmethod
    def decode(cls, dec: Decoder) -> "LogEntry":
        dec.start(1)
        e = cls(
            op=dec.u8(),
            oid=dec.string(),
            version=Eversion.decode(dec),
            prior_version=Eversion.decode(dec),
        )
        e.reqid = (dec.string(), dec.u64())
        dec.finish()
        return e


@dataclass
class PgInfo(Encodable):
    """pg_info_t: summary a shard reports during peering."""

    last_update: Eversion = field(default_factory=Eversion)
    last_complete: Eversion = field(default_factory=Eversion)
    log_tail: Eversion = field(default_factory=Eversion)
    last_epoch_started: int = 0

    def encode(self, enc: Encoder) -> None:
        enc.start(1, 1)
        self.last_update.encode(enc)
        self.last_complete.encode(enc)
        self.log_tail.encode(enc)
        enc.u32(self.last_epoch_started)
        enc.finish()

    @classmethod
    def decode(cls, dec: Decoder) -> "PgInfo":
        dec.start(1)
        info = cls(
            last_update=Eversion.decode(dec),
            last_complete=Eversion.decode(dec),
            log_tail=Eversion.decode(dec),
            last_epoch_started=dec.u32(),
        )
        dec.finish()
        return info


class Missing:
    """pg_missing_t: oid -> (need, have) versions."""

    def __init__(self) -> None:
        self.items: dict[str, tuple[Eversion, Eversion]] = {}

    def __len__(self) -> int:
        return len(self.items)

    def __contains__(self, oid: str) -> bool:
        return oid in self.items

    def add(self, oid: str, need: Eversion, have: Eversion = Eversion()) -> None:
        self.items[oid] = (need, have)

    def rm(self, oid: str) -> None:
        self.items.pop(oid, None)

    def add_next_event(self, entry: LogEntry) -> None:
        """Walking a log delta we don't have: each entry makes its object
        missing at that version (pg_missing_t::add_next_event)."""
        if entry.is_delete():
            self.items.pop(entry.oid, None)
        else:
            have = self.items.get(entry.oid, (None, entry.prior_version))[1]
            self.items[entry.oid] = (entry.version, have)


class PGLog:
    """In-memory ordered log with trim (PGLog.h IndexedLog analog)."""

    def __init__(self) -> None:
        self.entries: list[LogEntry] = []
        self.tail = Eversion()

    @property
    def head(self) -> Eversion:
        return self.entries[-1].version if self.entries else self.tail

    def append(self, entry: LogEntry) -> None:
        assert entry.version > self.head, (entry.version, self.head)
        self.entries.append(entry)

    def trim(self, to: Eversion) -> None:
        """Drop entries <= to (PGLog::trim); tail advances."""
        keep = [e for e in self.entries if e.version > to]
        if len(keep) != len(self.entries):
            self.tail = max(self.tail, to)
            self.entries = keep

    def entries_after(self, v: Eversion) -> list[LogEntry]:
        """The delta a lagging shard needs; valid only if v >= tail."""
        assert v >= self.tail, (v, self.tail)
        return [e for e in self.entries if e.version > v]

    def can_catch_up(self, v: Eversion) -> bool:
        """Whether a shard at version v can log-recover (else backfill)."""
        return v >= self.tail

    def missing_from(self, v: Eversion) -> Missing:
        """Missing set for a shard whose last_update is v."""
        missing = Missing()
        for e in self.entries_after(v):
            missing.add_next_event(e)
        return missing

    def encode_entries(self) -> list[bytes]:
        return [e.tobytes() for e in self.entries]
