"""PG log entries — the port of part of `ceph_tpu/osd/pg_log.py`.

`Eversion` (eversion_t), `LogEntry` (pg_log_entry_t) and the op kinds
`LOG_MODIFY`/`LOG_DELETE`, with the reference's encodings, so a log entry
a shard appends is byte-identical across the two packages.  Mirrors
src/osd/osd_types.h; the log, info and missing set of src/osd/PGLog come
with the PG daemons.
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
