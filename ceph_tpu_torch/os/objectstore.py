"""ObjectStore contract + transaction application engine.

The port's copy of `ceph_tpu/os/objectstore.py`, whole.

Ceph: src/os/ObjectStore.h:63 — the abstract
storage backend: `queue_transactions` (:232), `read` (:473), `getattr`
(:581), collection management, omap.  Errors are negative errnos
surfaced here as StoreError.

The op-application loop is shared by all backends; each backend supplies
the primitive object/collection storage.
"""

from __future__ import annotations

import errno as _errno
from typing import Callable, Iterable

from . import transaction as tx
from .transaction import Op, Transaction


class StoreError(Exception):
    def __init__(self, err: int, msg: str = ""):
        self.errno = -abs(err)
        super().__init__(
            f"{msg} (errno {self.errno}, {_errno.errorcode.get(abs(err), '?')})"
        )


class ObjectStore:
    """Abstract store.  Backends implement the _-prefixed primitives;
    the public surface mirrors ObjectStore.h."""

    @staticmethod
    def _faultpoint(point: str, coll: str, oid: str) -> None:
        """Media-error injection seam (os.read / os.write): an armed
        fault surfaces as StoreError, exactly the errno a dying disk
        would hand the objectstore (test-erasure-eio.sh semantics)."""
        from ..common.fault_injector import InjectedFailure, faultpoint

        try:
            faultpoint(point)
        except InjectedFailure as e:
            raise StoreError(
                abs(e.errno), f"injected {point} fault on {coll}/{oid}"
            ) from e

    def mount(self) -> None:
        pass

    def umount(self) -> None:
        pass

    # -- mutations -----------------------------------------------------------

    def queue_transaction(
        self, txn: Transaction, on_commit: Callable[[], None] | None = None
    ) -> None:
        """Apply ops in order, then fire on_commit (ObjectStore.h:232
        queue_transactions; callbacks are the on_commit contexts).

        Contract note (matches the reference's "failure is not an
        option", ObjectStore.h): a mid-transaction error indicates a
        caller bug; ops already applied are NOT rolled back and
        on_commit does not fire.  Durable backends additionally drop the
        journal entry so the aborted txn never replays."""
        if txn.ops:
            # write-fault seam, checked BEFORE any op lands: an injected
            # media error fails the whole transaction atomically (per-op
            # injection would tear it, since apply does not roll back)
            self._faultpoint("os.write", txn.ops[0].coll, txn.ops[0].oid)
        for op in txn.ops:
            self._apply_op(op)
        self._persist(txn)
        if on_commit is not None:
            on_commit()

    def _apply_op(self, op: Op) -> None:
        if op.code == tx.OP_TOUCH:
            self._touch(op.coll, op.oid)
        elif op.code == tx.OP_WRITE:
            self._write(op.coll, op.oid, op.off, op.data)
        elif op.code == tx.OP_WRITE_APPEND:
            self._write(op.coll, op.oid, self._size(op.coll, op.oid), op.data)
        elif op.code == tx.OP_ZERO:
            self._write(op.coll, op.oid, op.off, b"\x00" * op.length)
        elif op.code == tx.OP_TRUNCATE:
            self._truncate(op.coll, op.oid, op.off)
        elif op.code == tx.OP_REMOVE:
            self._remove(op.coll, op.oid)
        elif op.code == tx.OP_SETATTR:
            self._setattr(op.coll, op.oid, op.name, op.data)
        elif op.code == tx.OP_RMATTR:
            self._rmattr(op.coll, op.oid, op.name)
        elif op.code == tx.OP_OMAP_SETKEYS:
            self._omap_set(op.coll, op.oid, op.keys)
        elif op.code == tx.OP_OMAP_RMKEYS:
            self._omap_rm(op.coll, op.oid, list(op.keys))
        elif op.code == tx.OP_OMAP_CLEAR:
            self._omap_rm(op.coll, op.oid, list(self.omap_get(op.coll, op.oid)))
        elif op.code == tx.OP_MKCOLL:
            self._mkcoll(op.coll)
        elif op.code == tx.OP_RMCOLL:
            self._rmcoll(op.coll)
        elif op.code == tx.OP_CLONE:
            self._clone(op.coll, op.oid, op.name)
        else:
            raise StoreError(22, f"unknown op code {op.code}")

    def _persist(self, txn: Transaction) -> None:
        """Hook for durable backends (WAL/commit point)."""

    # -- reads (ObjectStore.h read-side surface) -----------------------------

    def read(self, coll: str, oid: str, off: int = 0, length: int = 0) -> bytes:
        """ObjectStore.h:473; length 0 = to EOF; returns ENOENT for
        missing objects."""
        raise NotImplementedError

    def stat(self, coll: str, oid: str) -> int:
        """Object size, or raise ENOENT."""
        raise NotImplementedError

    def exists(self, coll: str, oid: str) -> bool:
        try:
            self.stat(coll, oid)
            return True
        except StoreError:
            return False

    def getattr(self, coll: str, oid: str, name: str) -> bytes:
        raise NotImplementedError

    def getattrs(self, coll: str, oid: str) -> dict[str, bytes]:
        raise NotImplementedError

    def omap_get(self, coll: str, oid: str) -> dict[str, bytes]:
        raise NotImplementedError

    def list_objects(self, coll: str) -> list[str]:
        raise NotImplementedError

    def count_objects(self, coll: str) -> int:
        """Object count for a collection.  Backends override with an O(1)
        path where they can (stat polling must not enumerate the store)."""
        return len(self.list_objects(coll))

    def list_collections(self) -> list[str]:
        raise NotImplementedError

    def collection_exists(self, coll: str) -> bool:
        return coll in self.list_collections()

    # -- backend primitives --------------------------------------------------

    def _touch(self, coll: str, oid: str) -> None:
        raise NotImplementedError

    def _write(self, coll: str, oid: str, off: int, data: bytes) -> None:
        raise NotImplementedError

    def _size(self, coll: str, oid: str) -> int:
        """Size for append; 0 when the object doesn't exist yet."""
        try:
            return self.stat(coll, oid)
        except StoreError:
            return 0

    def _truncate(self, coll: str, oid: str, size: int) -> None:
        raise NotImplementedError

    def _remove(self, coll: str, oid: str) -> None:
        raise NotImplementedError

    def _setattr(self, coll: str, oid: str, name: str, value: bytes) -> None:
        raise NotImplementedError

    def _rmattr(self, coll: str, oid: str, name: str) -> None:
        raise NotImplementedError

    def _omap_set(self, coll: str, oid: str, keys: dict[str, bytes]) -> None:
        raise NotImplementedError

    def _omap_rm(self, coll: str, oid: str, keys: Iterable[str]) -> None:
        raise NotImplementedError

    def _mkcoll(self, coll: str) -> None:
        raise NotImplementedError

    def _rmcoll(self, coll: str) -> None:
        raise NotImplementedError

    def _clone(self, coll: str, oid: str, target: str) -> None:
        raise NotImplementedError
