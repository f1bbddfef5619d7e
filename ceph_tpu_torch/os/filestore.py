"""FileStore — a minimal persistent ObjectStore.

The port's copy of `ceph_tpu/os/filestore.py`, whole: host code.  The same
directory layout, journal and KV records, so a store written by either
package mounts in the other.

The FileStore-era design at this framework's scale:
object data in flat files, xattrs/omap/collection metadata in a
log-structured FileKV, and a write-ahead journal giving transactions the
atomicity BlueStore gets from its WAL+RocksDB commit point
(Ceph's src/os/bluestore/: deferred writes + kv commit).

Crash model: a transaction is journaled (fsync) before any file mutation;
on mount, journaled-but-unapplied transactions are replayed.  Appends are
resolved to absolute offsets *before* journaling so replay is idempotent
(every journaled op overwrites a range or is a remove/truncate).  A
transaction whose apply raises is treated as aborted: its journal entry
is dropped and the error propagates (Ceph treats transaction
application failure as a fatal bug — ObjectStore.h "failure is not an
option").
"""

from __future__ import annotations

import os
from dataclasses import replace

from . import transaction as tx
from .kv import FileKV
from .objectstore import ObjectStore, StoreError
from .transaction import Transaction


def _enc(name: str) -> str:
    return name.encode("utf-8").hex()


class FileStore(ObjectStore):
    def __init__(self, path: str):
        self.path = path
        os.makedirs(path, exist_ok=True)
        self._kv = FileKV(os.path.join(path, "meta.kv"))
        self._journal = FileKV(os.path.join(path, "journal.kv"))
        self._journal_seq = 0
        self._replaying = False

    # -- lifecycle -----------------------------------------------------------

    def mount(self) -> None:
        """Replay unapplied journal entries (BlueStore deferred replay).
        A replay failure drops the entry rather than poisoning the mount —
        the entry was already applied or belongs to an aborted txn."""
        self._replaying = True
        try:
            for seq_key, txn_bytes in list(self._journal.iterate("txn")):
                txn = Transaction.frombytes(txn_bytes)
                try:
                    for op in txn.ops:
                        self._apply_op(op)
                except StoreError:
                    pass
                self._journal.rm("txn", seq_key)
        finally:
            self._replaying = False

    def umount(self) -> None:
        self._kv.close()
        self._journal.close()

    # -- transaction durability ----------------------------------------------

    def queue_transaction(self, txn: Transaction, on_commit=None) -> None:
        if txn.ops:
            # pre-journal write-fault seam, matching the other backends
            self._faultpoint("os.write", txn.ops[0].coll, txn.ops[0].oid)
        txn = self._resolve_appends(txn)
        self._journal_seq += 1
        key = f"{self._journal_seq:016d}"
        self._journal.set("txn", key, txn.tobytes())
        try:
            for op in txn.ops:
                self._apply_op(op)
        except StoreError:
            self._journal.rm("txn", key)  # aborted, not committed
            raise
        self._journal.rm("txn", key)
        if on_commit is not None:
            on_commit()

    def _resolve_appends(self, txn: Transaction) -> Transaction:
        """Rewrite OP_WRITE_APPEND to absolute-offset OP_WRITE so journal
        replay after a crash cannot double-append."""
        if not any(op.code == tx.OP_WRITE_APPEND for op in txn.ops):
            return txn
        sizes: dict[tuple[str, str], int] = {}
        out = Transaction()
        for op in txn.ops:
            if op.code == tx.OP_WRITE_APPEND:
                key = (op.coll, op.oid)
                if key not in sizes:
                    sizes[key] = self._size(op.coll, op.oid)
                op = replace(op, code=tx.OP_WRITE, off=sizes[key])
                sizes[key] += op.length
            elif op.code == tx.OP_TRUNCATE:
                sizes[(op.coll, op.oid)] = op.off
            elif op.code in (tx.OP_WRITE, tx.OP_ZERO):
                key = (op.coll, op.oid)
                if key in sizes:
                    sizes[key] = max(sizes[key], op.off + op.length)
            elif op.code == tx.OP_REMOVE:
                sizes[(op.coll, op.oid)] = 0
            out.ops.append(op)
        return out

    # -- paths ---------------------------------------------------------------

    def _cdir(self, coll: str) -> str:
        return os.path.join(self.path, "c_" + _enc(coll))

    def _opath(self, coll: str, oid: str) -> str:
        return os.path.join(self._cdir(coll), _enc(oid))

    def _require_coll(self, coll: str) -> str:
        d = self._cdir(coll)
        if not os.path.isdir(d):
            raise StoreError(2, f"collection {coll} does not exist")
        return d

    def _require_obj(self, coll: str, oid: str) -> str:
        self._require_coll(coll)
        p = self._opath(coll, oid)
        if not os.path.exists(p):
            raise StoreError(2, f"object {coll}/{oid} does not exist")
        return p

    # -- primitives ----------------------------------------------------------

    def _touch(self, coll: str, oid: str) -> None:
        self._require_coll(coll)
        open(self._opath(coll, oid), "ab").close()

    def _write(self, coll: str, oid: str, off: int, data: bytes) -> None:
        self._require_coll(coll)
        p = self._opath(coll, oid)
        with open(p, "r+b" if os.path.exists(p) else "w+b") as f:
            f.seek(0, 2)
            size = f.tell()
            if size < off:
                f.write(b"\x00" * (off - size))
            f.seek(off)
            f.write(data)
            f.flush()
            os.fsync(f.fileno())

    def _truncate(self, coll: str, oid: str, size: int) -> None:
        self._require_coll(coll)
        p = self._opath(coll, oid)
        with open(p, "r+b" if os.path.exists(p) else "w+b") as f:
            f.truncate(size)

    def _remove(self, coll: str, oid: str) -> None:
        p = self._opath(coll, oid)
        if os.path.exists(p):
            os.unlink(p)
        self._kv.rm("xattr", f"{coll}\x01{oid}")
        self._kv.rm("omap", f"{coll}\x01{oid}")

    def _attrs_key(self, coll: str, oid: str) -> str:
        return f"{coll}\x01{oid}"

    def _load_attrmap(self, prefix: str, coll: str, oid: str) -> dict[str, bytes]:
        raw = self._kv.get(prefix, self._attrs_key(coll, oid))
        if not raw:
            return {}
        from ..common.encoding import Decoder

        return Decoder(raw).map_(lambda d: d.string(), lambda d: d.bytes_())

    def _store_attrmap(
        self, prefix: str, coll: str, oid: str, attrs: dict[str, bytes]
    ) -> None:
        from ..common.encoding import Encoder

        enc = Encoder()
        enc.map_(attrs, lambda e, k: e.string(k), lambda e, v: e.bytes_(v))
        self._kv.set(prefix, self._attrs_key(coll, oid), enc.tobytes())

    def _setattr(self, coll: str, oid: str, name: str, value: bytes) -> None:
        self._touch(coll, oid)  # MemStore parity: create-on-setattr
        attrs = self._load_attrmap("xattr", coll, oid)
        attrs[name] = bytes(value)
        self._store_attrmap("xattr", coll, oid, attrs)

    def _rmattr(self, coll: str, oid: str, name: str) -> None:
        self._require_obj(coll, oid)
        attrs = self._load_attrmap("xattr", coll, oid)
        attrs.pop(name, None)
        self._store_attrmap("xattr", coll, oid, attrs)

    def _omap_set(self, coll: str, oid: str, keys: dict[str, bytes]) -> None:
        self._touch(coll, oid)
        omap = self._load_attrmap("omap", coll, oid)
        omap.update(keys)
        self._store_attrmap("omap", coll, oid, omap)

    def _omap_rm(self, coll: str, oid: str, keys) -> None:
        self._require_obj(coll, oid)
        omap = self._load_attrmap("omap", coll, oid)
        for k in keys:
            omap.pop(k, None)
        self._store_attrmap("omap", coll, oid, omap)

    def _mkcoll(self, coll: str) -> None:
        d = self._cdir(coll)
        if os.path.isdir(d):
            if not self._replaying:
                raise StoreError(17, f"collection {coll} exists")
            return
        os.makedirs(d)

    def _rmcoll(self, coll: str) -> None:
        d = self._cdir(coll)
        if os.path.isdir(d):
            for f in os.listdir(d):
                oid = bytes.fromhex(f).decode()
                self._kv.rm("xattr", self._attrs_key(coll, oid))
                self._kv.rm("omap", self._attrs_key(coll, oid))
                os.unlink(os.path.join(d, f))
            os.rmdir(d)

    def _clone(self, coll: str, oid: str, target: str) -> None:
        data = self.read(coll, oid)
        self._truncate(coll, target, 0)  # target becomes an exact copy
        self._write(coll, target, 0, data)
        self._store_attrmap(
            "xattr", coll, target, self._load_attrmap("xattr", coll, oid)
        )
        self._store_attrmap(
            "omap", coll, target, self._load_attrmap("omap", coll, oid)
        )

    # -- reads ---------------------------------------------------------------

    def read(self, coll: str, oid: str, off: int = 0, length: int = 0) -> bytes:
        p = self._require_obj(coll, oid)
        with open(p, "rb") as f:
            f.seek(off)
            return f.read() if length == 0 else f.read(length)

    def stat(self, coll: str, oid: str) -> int:
        return os.path.getsize(self._require_obj(coll, oid))

    def getattr(self, coll: str, oid: str, name: str) -> bytes:
        self._require_obj(coll, oid)
        attrs = self._load_attrmap("xattr", coll, oid)
        if name not in attrs:
            raise StoreError(61, f"no attr {name} on {coll}/{oid}")
        return attrs[name]

    def getattrs(self, coll: str, oid: str) -> dict[str, bytes]:
        self._require_obj(coll, oid)
        return self._load_attrmap("xattr", coll, oid)

    def omap_get(self, coll: str, oid: str) -> dict[str, bytes]:
        self._require_obj(coll, oid)
        return self._load_attrmap("omap", coll, oid)

    def list_objects(self, coll: str) -> list[str]:
        d = self._require_coll(coll)
        return sorted(bytes.fromhex(f).decode() for f in os.listdir(d))

    def count_objects(self, coll: str) -> int:
        # no decode/sort — one readdir, for stat polling
        return len(os.listdir(self._require_coll(coll)))

    def list_collections(self) -> list[str]:
        out = []
        for d in os.listdir(self.path):
            if d.startswith("c_"):
                out.append(bytes.fromhex(d[2:]).decode())
        return sorted(out)
