"""MemStore — mirror of src/os/memstore/MemStore.{h,cc}.

The port's copy of `ceph_tpu/os/memstore.py`, whole.

The in-RAM backend the reference's ObjectStore unit tests run against
(SURVEY.md §2.6); same role here: fast, deterministic storage for OSD
and EC-backend tests.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .objectstore import ObjectStore, StoreError


@dataclass
class _Object:
    data: bytearray = field(default_factory=bytearray)
    xattrs: dict[str, bytes] = field(default_factory=dict)
    omap: dict[str, bytes] = field(default_factory=dict)


class MemStore(ObjectStore):
    def __init__(self) -> None:
        self._colls: dict[str, dict[str, _Object]] = {}

    # -- primitives ----------------------------------------------------------

    def _coll(self, coll: str) -> dict[str, _Object]:
        c = self._colls.get(coll)
        if c is None:
            raise StoreError(2, f"collection {coll} does not exist")
        return c

    def _obj(self, coll: str, oid: str, create: bool = False) -> _Object:
        c = self._coll(coll)
        o = c.get(oid)
        if o is None:
            if not create:
                raise StoreError(2, f"object {coll}/{oid} does not exist")
            o = c[oid] = _Object()
        return o

    def _touch(self, coll: str, oid: str) -> None:
        self._obj(coll, oid, create=True)

    def _write(self, coll: str, oid: str, off: int, data: bytes) -> None:
        o = self._obj(coll, oid, create=True)
        end = off + len(data)
        if len(o.data) < end:
            o.data.extend(b"\x00" * (end - len(o.data)))
        o.data[off:end] = data

    def _truncate(self, coll: str, oid: str, size: int) -> None:
        o = self._obj(coll, oid, create=True)
        if len(o.data) > size:
            del o.data[size:]
        else:
            o.data.extend(b"\x00" * (size - len(o.data)))

    def _remove(self, coll: str, oid: str) -> None:
        self._coll(coll).pop(oid, None)

    def _setattr(self, coll: str, oid: str, name: str, value: bytes) -> None:
        self._obj(coll, oid, create=True).xattrs[name] = bytes(value)

    def _rmattr(self, coll: str, oid: str, name: str) -> None:
        self._obj(coll, oid).xattrs.pop(name, None)

    def _omap_set(self, coll: str, oid: str, keys: dict[str, bytes]) -> None:
        self._obj(coll, oid, create=True).omap.update(keys)

    def _omap_rm(self, coll: str, oid: str, keys) -> None:
        omap = self._obj(coll, oid).omap
        for k in keys:
            omap.pop(k, None)

    def _mkcoll(self, coll: str) -> None:
        if coll in self._colls:
            raise StoreError(17, f"collection {coll} exists")
        self._colls[coll] = {}

    def _rmcoll(self, coll: str) -> None:
        self._colls.pop(coll, None)

    def _clone(self, coll: str, oid: str, target: str) -> None:
        src = self._obj(coll, oid)
        c = self._coll(coll)
        c[target] = _Object(
            bytearray(src.data), dict(src.xattrs), dict(src.omap)
        )

    # -- reads ---------------------------------------------------------------

    def read(self, coll: str, oid: str, off: int = 0, length: int = 0) -> bytes:
        self._faultpoint("os.read", coll, oid)
        o = self._obj(coll, oid)
        if length == 0:
            return bytes(o.data[off:])
        return bytes(o.data[off : off + length])

    def stat(self, coll: str, oid: str) -> int:
        return len(self._obj(coll, oid).data)

    def getattr(self, coll: str, oid: str, name: str) -> bytes:
        attrs = self._obj(coll, oid).xattrs
        if name not in attrs:
            raise StoreError(61, f"no attr {name} on {coll}/{oid}")  # ENODATA
        return attrs[name]

    def getattrs(self, coll: str, oid: str) -> dict[str, bytes]:
        return dict(self._obj(coll, oid).xattrs)

    def omap_get(self, coll: str, oid: str) -> dict[str, bytes]:
        return dict(self._obj(coll, oid).omap)

    def list_objects(self, coll: str) -> list[str]:
        return sorted(self._coll(coll))

    def count_objects(self, coll: str) -> int:
        return len(self._coll(coll))

    def list_collections(self) -> list[str]:
        return sorted(self._colls)
