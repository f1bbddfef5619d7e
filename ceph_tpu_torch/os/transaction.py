"""ObjectStore transactions — mirror of src/os/Transaction.{h,cc}.

The port's copy of `ceph_tpu/os/transaction.py`, whole.

In Ceph a Transaction is a serialized op list applied atomically
(src/os/ObjectStore.h:232 queue_transactions; op codes in
Transaction.h OP_*).  ECTransaction encodes one of these per shard and
ships it inside ECSubWrite (src/osd/ECTransaction.cc:37-95 writing each
shard's chunk with alloc hints).

Ops are (code, coll, oid, args...) tuples; the encodable form rides
MOSDECSubOpWrite.txn.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..common.encoding import Decoder, Encodable, Encoder

# op codes (Transaction.h OP_* analog)
OP_TOUCH = 1
OP_WRITE = 2
OP_ZERO = 3
OP_TRUNCATE = 4
OP_REMOVE = 5
OP_SETATTR = 6
OP_RMATTR = 7
OP_OMAP_SETKEYS = 8
OP_OMAP_RMKEYS = 9
OP_MKCOLL = 10
OP_RMCOLL = 11
OP_CLONE = 12
OP_WRITE_APPEND = 13  # append-only fast path (EC shard writes)
OP_OMAP_CLEAR = 14

# alloc hints (ObjectStore.h CEPH_OSD_ALLOC_HINT_FLAG_*)
ALLOC_HINT_SEQUENTIAL_WRITE = 1
ALLOC_HINT_APPEND_ONLY = 2


@dataclass
class Op:
    code: int
    coll: str = ""
    oid: str = ""
    off: int = 0
    length: int = 0
    data: bytes = b""
    name: str = ""  # attr name / clone target
    keys: dict[str, bytes] = field(default_factory=dict)
    hints: int = 0
    # EC-transaction fusion: per-BLOCK crc32c of `data`
    # precomputed in the same offload launch window the chunk was
    # encoded in — an AggTicket (or array) resolving to uint32 digests,
    # consumed by BlueStore for block-aligned raw-stored writes.  A
    # process-local optimization hint only: NOT encoded (a decoded
    # transaction recomputes), never trusted for non-aligned or
    # compressed stores.
    csums: object = None


class Transaction(Encodable):
    """An atomic batch of mutations (Transaction-as-value)."""

    def __init__(self) -> None:
        self.ops: list[Op] = []

    def __len__(self) -> int:
        return len(self.ops)

    def empty(self) -> bool:
        return not self.ops

    # -- builders (Transaction.h API analog) ---------------------------------

    def touch(self, coll: str, oid: str) -> "Transaction":
        self.ops.append(Op(OP_TOUCH, coll, oid))
        return self

    def write(
        self,
        coll: str,
        oid: str,
        off: int,
        data: bytes,
        hints: int = 0,
        csums: object = None,
    ) -> "Transaction":
        self.ops.append(
            Op(
                OP_WRITE,
                coll,
                oid,
                off=off,
                length=len(data),
                data=bytes(data),
                hints=hints,
                csums=csums,
            )
        )
        return self

    def append(self, coll: str, oid: str, data: bytes) -> "Transaction":
        """EC shard chunk append (ECTransaction writes at
        logical_to_prev_chunk_offset with APPEND_ONLY hints)."""
        self.ops.append(
            Op(
                OP_WRITE_APPEND,
                coll,
                oid,
                length=len(data),
                data=bytes(data),
                hints=ALLOC_HINT_SEQUENTIAL_WRITE | ALLOC_HINT_APPEND_ONLY,
            )
        )
        return self

    def zero(self, coll: str, oid: str, off: int, length: int) -> "Transaction":
        self.ops.append(Op(OP_ZERO, coll, oid, off=off, length=length))
        return self

    def truncate(self, coll: str, oid: str, size: int) -> "Transaction":
        self.ops.append(Op(OP_TRUNCATE, coll, oid, off=size))
        return self

    def remove(self, coll: str, oid: str) -> "Transaction":
        self.ops.append(Op(OP_REMOVE, coll, oid))
        return self

    def setattr(self, coll: str, oid: str, name: str, value: bytes) -> "Transaction":
        self.ops.append(Op(OP_SETATTR, coll, oid, name=name, data=bytes(value)))
        return self

    def rmattr(self, coll: str, oid: str, name: str) -> "Transaction":
        self.ops.append(Op(OP_RMATTR, coll, oid, name=name))
        return self

    def omap_setkeys(self, coll: str, oid: str, keys: dict[str, bytes]) -> "Transaction":
        self.ops.append(Op(OP_OMAP_SETKEYS, coll, oid, keys=dict(keys)))
        return self

    def omap_rmkeys(self, coll: str, oid: str, keys: list[str]) -> "Transaction":
        self.ops.append(
            Op(OP_OMAP_RMKEYS, coll, oid, keys={k: b"" for k in keys})
        )
        return self

    def omap_clear(self, coll: str, oid: str) -> "Transaction":
        self.ops.append(Op(OP_OMAP_CLEAR, coll, oid))
        return self

    def create_collection(self, coll: str) -> "Transaction":
        self.ops.append(Op(OP_MKCOLL, coll))
        return self

    def remove_collection(self, coll: str) -> "Transaction":
        self.ops.append(Op(OP_RMCOLL, coll))
        return self

    def clone(self, coll: str, oid: str, target: str) -> "Transaction":
        self.ops.append(Op(OP_CLONE, coll, oid, name=target))
        return self

    def append_txn(self, other: "Transaction") -> "Transaction":
        """Transaction::append — merge another transaction's ops."""
        self.ops.extend(other.ops)
        return self

    # -- encoding ------------------------------------------------------------

    def encode(self, enc: Encoder) -> None:
        enc.start(1, 1)
        enc.list_(
            self.ops,
            lambda e, op: (
                e.u8(op.code),
                e.string(op.coll),
                e.string(op.oid),
                e.u64(op.off),
                e.u64(op.length),
                e.bytes_(op.data),
                e.string(op.name),
                e.map_(op.keys, lambda e2, k: e2.string(k), lambda e2, v: e2.bytes_(v)),
                e.u8(op.hints),
            ),
        )
        enc.finish()

    @classmethod
    def decode(cls, dec: Decoder) -> "Transaction":
        dec.start(1)
        t = cls()
        t.ops = dec.list_(
            lambda d: Op(
                code=d.u8(),
                coll=d.string(),
                oid=d.string(),
                off=d.u64(),
                length=d.u64(),
                data=d.bytes_(),
                name=d.string(),
                keys=d.map_(lambda d2: d2.string(), lambda d2: d2.bytes_()),
                hints=d.u8(),
            )
        )
        dec.finish()
        return t
