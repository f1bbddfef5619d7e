"""Versioned binary encoding — mirror of src/include/encoding.h.

The port's copy of `ceph_tpu/common/encoding.py`, whole.

Ceph: src/include/encoding.h:188: every wire/disk
struct encodes as ENCODE_START(version, compat_version, bl) — a header of
(struct_v u8, struct_compat u8, length u32) — followed by little-endian
fields, closed by ENCODE_FINISH which backfills the length.  Decoders
check `struct_compat <= understood version` and can skip trailing bytes of
newer versions, which is how Ceph does rolling upgrades.  The
WRITE_CLASS_ENCODER macro family hangs encode/decode off each type; here
`Encodable` plays that role.

All integers little-endian, strings length-prefixed (u32), containers
count-prefixed (u32) — same conventions as the reference.
"""

from __future__ import annotations

import struct
from typing import Callable, TypeVar

T = TypeVar("T")


class DecodeError(Exception):
    pass


class Encoder:
    """Append-only byte builder (the bufferlist encode side)."""

    def __init__(self) -> None:
        self._parts: list[bytes] = []
        # stack of (index in _parts of the length placeholder) for nested
        # ENCODE_START frames
        self._frames: list[int] = []

    # -- primitives ----------------------------------------------------------

    def u8(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<B", v))
        return self

    def u16(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<H", v))
        return self

    def u32(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<I", v))
        return self

    def u64(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<Q", v))
        return self

    def i64(self, v: int) -> "Encoder":
        self._parts.append(struct.pack("<q", v))
        return self

    def f64(self, v: float) -> "Encoder":
        self._parts.append(struct.pack("<d", v))
        return self

    def boolean(self, v: bool) -> "Encoder":
        return self.u8(1 if v else 0)

    def bytes_(self, v: bytes) -> "Encoder":
        self.u32(len(v))
        self._parts.append(bytes(v))
        return self

    def string(self, v: str) -> "Encoder":
        return self.bytes_(v.encode("utf-8"))

    def raw(self, v: bytes) -> "Encoder":
        self._parts.append(bytes(v))
        return self

    # -- containers ----------------------------------------------------------

    def list_(self, items, item_fn: Callable[["Encoder", object], None]) -> "Encoder":
        items = list(items)
        self.u32(len(items))
        for it in items:
            item_fn(self, it)
        return self

    def map_(
        self,
        d: dict,
        key_fn: Callable[["Encoder", object], None],
        val_fn: Callable[["Encoder", object], None],
    ) -> "Encoder":
        self.u32(len(d))
        for k in sorted(d):
            key_fn(self, k)
            val_fn(self, d[k])
        return self

    # -- versioned frames (ENCODE_START / ENCODE_FINISH) ---------------------

    def start(self, version: int, compat: int) -> "Encoder":
        self.u8(version)
        self.u8(compat)
        self._parts.append(b"\x00\x00\x00\x00")  # length backfilled by finish
        self._frames.append(len(self._parts) - 1)
        return self

    def finish(self) -> "Encoder":
        idx = self._frames.pop()
        length = sum(len(p) for p in self._parts[idx + 1 :])
        self._parts[idx] = struct.pack("<I", length)
        return self

    def encodable(self, obj: "Encodable") -> "Encoder":
        obj.encode(self)
        return self

    def tobytes(self) -> bytes:
        assert not self._frames, "unbalanced start/finish"
        return b"".join(self._parts)


class Decoder:
    """Cursor over bytes (the bufferlist::const_iterator decode side)."""

    def __init__(self, data: bytes, offset: int = 0):
        self._data = data
        self._off = offset
        # stack of end-offsets for versioned frames, enabling skip of
        # unknown trailing fields (DECODE_FINISH)
        self._frames: list[int] = []

    def _take(self, n: int) -> bytes:
        if self._off + n > len(self._data):
            raise DecodeError(f"buffer underrun: need {n} at {self._off}")
        v = self._data[self._off : self._off + n]
        self._off += n
        return v

    @property
    def offset(self) -> int:
        return self._off

    def remaining(self) -> int:
        return len(self._data) - self._off

    # -- primitives ----------------------------------------------------------

    def u8(self) -> int:
        return struct.unpack("<B", self._take(1))[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def f64(self) -> float:
        return struct.unpack("<d", self._take(8))[0]

    def boolean(self) -> bool:
        return self.u8() != 0

    def bytes_(self) -> bytes:
        return self._take(self.u32())

    def string(self) -> str:
        return self.bytes_().decode("utf-8")

    def raw(self, n: int) -> bytes:
        return self._take(n)

    # -- containers ----------------------------------------------------------

    def list_(self, item_fn: Callable[["Decoder"], T]) -> list[T]:
        return [item_fn(self) for _ in range(self.u32())]

    def map_(self, key_fn, val_fn) -> dict:
        return {key_fn(self): val_fn(self) for _ in range(self.u32())}

    # -- versioned frames (DECODE_START / DECODE_FINISH) ---------------------

    def start(self, understood_version: int) -> int:
        """Returns struct_v; raises if struct_compat > understood."""
        struct_v = self.u8()
        struct_compat = self.u8()
        length = self.u32()
        if struct_compat > understood_version:
            raise DecodeError(
                f"struct_compat {struct_compat} > understood {understood_version}"
            )
        if self._off + length > len(self._data):
            raise DecodeError(
                f"versioned frame length {length} overruns buffer "
                f"({self.remaining()} bytes left)"
            )
        self._frames.append(self._off + length)
        return struct_v

    def finish(self) -> None:
        """Skip any trailing bytes of a newer encoding."""
        end = self._frames.pop()
        if self._off > end:
            raise DecodeError("overran versioned frame")
        self._off = end


def encode_kv_map(kv: dict[str, bytes]) -> bytes:
    """Wire blob for a str->bytes map (xattr dumps, omap key/value sets)."""
    e = Encoder()
    e.map_(kv, lambda enc, k: enc.string(k), lambda enc, v: enc.bytes_(v))
    return e.tobytes()


def decode_kv_map(blob: bytes) -> dict[str, bytes]:
    if not blob:
        return {}
    d = Decoder(blob)
    return d.map_(lambda dec: dec.string(), lambda dec: dec.bytes_())


def encode_str_list(items) -> bytes:
    e = Encoder()
    e.list_(items, lambda enc, s: enc.string(s))
    return e.tobytes()


def decode_str_list(blob: bytes) -> list[str]:
    if not blob:
        return []
    return Decoder(blob).list_(lambda dec: dec.string())


class Encodable:
    """Types with versioned encode/decode (WRITE_CLASS_ENCODER analog).

    Subclasses implement encode(Encoder) and classmethod decode(Decoder).
    """

    def encode(self, enc: Encoder) -> None:
        raise NotImplementedError

    @classmethod
    def decode(cls, dec: Decoder):
        raise NotImplementedError

    def tobytes(self) -> bytes:
        e = Encoder()
        self.encode(e)
        return e.tobytes()

    @classmethod
    def frombytes(cls, data: bytes):
        return cls.decode(Decoder(data))
