"""KeyValueDB — mirror of src/kv/KeyValueDB.h.

The port's copy of `ceph_tpu/os/kv.py`, whole: host code, on the port's
`utils/crc32c`.  A FileKV log written by either package replays in the
other.

In Ceph this is the abstraction BlueStore and the mon store sit on (RocksDB via
src/kv/RocksDBStore.h).  Two backends here: `MemKV` (sorted dict) and
`FileKV`, a log-structured persistent store — an append-only record log
replayed at open and compacted when garbage dominates, standing in for
RocksDB's WAL+SST mechanics at the scale this framework needs (mon
state, PG metadata, store metadata).
"""

from __future__ import annotations

import os
import struct
from typing import Iterator

from ..utils.crc32c import crc32c


class KeyValueDB:
    """get/set/rm over (prefix, key) pairs with ordered iteration
    (KeyValueDB.h Transaction/Iterator surface, flattened)."""

    def get(self, prefix: str, key: str) -> bytes | None:
        raise NotImplementedError

    def set(self, prefix: str, key: str, value: bytes) -> None:
        raise NotImplementedError

    def rm(self, prefix: str, key: str) -> None:
        raise NotImplementedError

    def iterate(self, prefix: str) -> Iterator[tuple[str, bytes]]:
        """Sorted (key, value) pairs under a prefix."""
        raise NotImplementedError

    def set_batch(self, prefix: str, kv: dict[str, bytes]) -> None:
        for k, v in kv.items():
            self.set(prefix, k, v)

    def apply_batch(self, ops: list[tuple[int, str, str, bytes]]) -> None:
        """Apply a batch of (op, prefix, key, value) with op 1=set, 2=rm.
        Durable backends make the whole batch atomic (a torn batch applies
        none of it) — the KeyValueDB::Transaction commit contract BlueStore
        relies on for its metadata commit point."""
        for op, prefix, key, value in ops:
            if op == 1:
                self.set(prefix, key, value)
            else:
                self.rm(prefix, key)

    def close(self) -> None:
        pass


class _DictKV(KeyValueDB):
    """Shared dict-backed read side for both backends."""

    def __init__(self) -> None:
        self._data: dict[tuple[str, str], bytes] = {}

    def get(self, prefix: str, key: str) -> bytes | None:
        return self._data.get((prefix, key))

    def iterate(self, prefix: str) -> Iterator[tuple[str, bytes]]:
        for (p, k) in sorted(self._data):
            if p == prefix:
                yield k, self._data[(p, k)]


class MemKV(_DictKV):
    def set(self, prefix: str, key: str, value: bytes) -> None:
        self._data[(prefix, key)] = bytes(value)

    def rm(self, prefix: str, key: str) -> None:
        self._data.pop((prefix, key), None)


# FileKV record: u8 op (1=set, 2=rm) | u32 klen | u32 vlen | key | value | crc32c
# op 3 = atomic batch: payload (in `value`) is a sequence of embedded
# records (same head layout, no per-record crc); one crc guards the whole
# batch, so a torn batch is discarded in full — never applied partially.
_HEAD = struct.Struct("<BII")


class FileKV(_DictKV):
    """Append-only log KV with replay-on-open and threshold compaction.

    Torn tails (a crash mid-append) are detected by the per-record crc
    and truncated away on open — the WAL property BlueFS/RocksDB give
    Ceph's BlueStore.
    """

    COMPACT_RATIO = 4  # compact when log records > live keys * ratio

    def __init__(self, path: str):
        super().__init__()
        self.path = path
        self._records = 0
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._replay()
        self._f = open(self.path, "ab")

    def _replay(self) -> None:
        if not os.path.exists(self.path):
            return
        good_end = 0
        with open(self.path, "rb") as f:
            buf = f.read()
        off = 0
        while off + _HEAD.size <= len(buf):
            op, klen, vlen = _HEAD.unpack_from(buf, off)
            end = off + _HEAD.size + klen + vlen + 4
            if op not in (1, 2, 3) or end > len(buf):
                break
            rec = buf[off : end - 4]
            (crc,) = struct.unpack_from("<I", buf, end - 4)
            if crc32c(rec) != crc:
                break  # torn tail
            if op == 3:
                payload = buf[off + _HEAD.size + klen : end - 4]
                for sop, sprefix, sk, sval in self._iter_batch(payload):
                    if sop == 1:
                        self._data[(sprefix, sk)] = sval
                    else:
                        self._data.pop((sprefix, sk), None)
            else:
                key = buf[off + _HEAD.size : off + _HEAD.size + klen].decode()
                prefix, _, k = key.partition("\x00")
                if op == 1:
                    self._data[(prefix, k)] = buf[off + _HEAD.size + klen : end - 4]
                else:
                    self._data.pop((prefix, k), None)
            self._records += 1
            good_end = end
            off = end
        if good_end < len(buf):
            with open(self.path, "r+b") as f:
                f.truncate(good_end)

    def _append(self, op: int, prefix: str, key: str, value: bytes) -> None:
        kb = f"{prefix}\x00{key}".encode()
        rec = _HEAD.pack(op, len(kb), len(value)) + kb + value
        self._f.write(rec + struct.pack("<I", crc32c(rec)))
        self._f.flush()
        os.fsync(self._f.fileno())
        self._records += 1
        if self._records > max(len(self._data), 16) * self.COMPACT_RATIO:
            self._compact()

    def _compact(self) -> None:
        tmp = self.path + ".compact"
        with open(tmp, "wb") as f:
            for (prefix, k), v in sorted(self._data.items()):
                kb = f"{prefix}\x00{k}".encode()
                rec = _HEAD.pack(1, len(kb), len(v)) + kb + v
                f.write(rec + struct.pack("<I", crc32c(rec)))
            f.flush()
            os.fsync(f.fileno())
        self._f.close()
        os.replace(tmp, self.path)
        self._f = open(self.path, "ab")
        self._records = len(self._data)

    def set(self, prefix: str, key: str, value: bytes) -> None:
        self._data[(prefix, key)] = bytes(value)
        self._append(1, prefix, key, bytes(value))

    def rm(self, prefix: str, key: str) -> None:
        if (prefix, key) in self._data:
            del self._data[(prefix, key)]
            self._append(2, prefix, key, b"")

    @staticmethod
    def _iter_batch(payload: bytes):
        off = 0
        while off + _HEAD.size <= len(payload):
            op, klen, vlen = _HEAD.unpack_from(payload, off)
            end = off + _HEAD.size + klen + vlen
            if op not in (1, 2) or end > len(payload):
                break  # malformed embed; crc already vouched, be defensive
            key = payload[off + _HEAD.size : off + _HEAD.size + klen].decode()
            prefix, _, k = key.partition("\x00")
            yield op, prefix, k, payload[off + _HEAD.size + klen : end]
            off = end

    def apply_batch(self, ops: list[tuple[int, str, str, bytes]]) -> None:
        """Atomic multi-op commit: one op-3 record, one crc — a crash mid-
        append discards the entire batch on replay (the commit point for
        BlueStore metadata transactions)."""
        if not ops:
            return
        parts = []
        for op, prefix, key, value in ops:
            kb = f"{prefix}\x00{key}".encode()
            parts.append(_HEAD.pack(op, len(kb), len(value)) + kb + value)
            if op == 1:
                self._data[(prefix, key)] = bytes(value)
            else:
                self._data.pop((prefix, key), None)
        self._append(3, "", "", b"".join(parts))

    def close(self) -> None:
        self._f.close()
