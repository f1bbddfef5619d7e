"""Object-class runtime: registry, method decorator, handler context.

The port of `ceph_tpu/cls/objclass.py`.  `get_method` imports
`ceph_tpu_torch.cls.<name>` on a class's first CALL; a class with no such
module raises MethodNotFound, so the CALL answers -EOPNOTSUPP, as the JAX
package's PG does for a class it cannot load.

Mirrors src/objclass/objclass.h: `cls_register` / `cls_register_cxx_method`
with CLS_METHOD_RD / CLS_METHOD_WR flags, and the `cls_method_context_t`
handle through which a method reads and mutates ITS object (never other
objects — the reference's isolation rule).  Methods return non-negative
on success (becomes the op result) or raise ClsError(errno).

Mutations accumulate into the enclosing op's PGTransaction — the same
replication/journaling path as plain writes — with a read-your-writes
overlay so a later method in the same op observes earlier staged state.
"""

from __future__ import annotations

import importlib
from typing import Callable

from ..common.errs import ENOENT, EOPNOTSUPP

RD = 1  # method reads the object (CLS_METHOD_RD)
WR = 2  # method mutates the object (CLS_METHOD_WR)


class ClsError(Exception):
    """Negative-errno failure from a class method (CLS_... error return)."""

    def __init__(self, err: int, msg: str = ""):
        self.errno = -abs(err)
        super().__init__(msg or f"cls error {self.errno}")


class MethodNotFound(ClsError):
    def __init__(self, what: str):
        super().__init__(EOPNOTSUPP, f"no such class method {what}")


# cls name -> method name -> (flags, fn(ctx, indata) -> bytes | (rc, bytes))
registry: dict[str, dict[str, tuple[int, Callable]]] = {}

_BUILTIN_PKG = __name__.rsplit(".", 1)[0]  # ceph_tpu_torch.cls


def cls_method(cls_name: str, method: str, flags: int):
    """Register a method (objclass.h cls_register_cxx_method)."""

    def deco(fn):
        registry.setdefault(cls_name, {})[method] = (flags, fn)
        return fn

    return deco


def load_class(name: str) -> None:
    """The dlopen analog: import ceph_tpu_torch.cls.<name>, whose module body
    registers its methods (a `libcls_<name>.so` __cls_init)."""
    if name in registry:
        return
    importlib.import_module(f"{_BUILTIN_PKG}.{name}")
    if name not in registry:
        raise MethodNotFound(f"{name} (module registered no methods)")


def get_method(cls_name: str, method: str) -> tuple[int, Callable]:
    """Resolve, loading the class on first use (PrimaryLogPG CALL path:
    osd->class_handler->open_class)."""
    methods = registry.get(cls_name)
    if methods is None:
        try:
            load_class(cls_name)
        except (ImportError, MethodNotFound):
            raise MethodNotFound(f"{cls_name}.{method}") from None
        methods = registry.get(cls_name, {})
    entry = methods.get(method)
    if entry is None:
        raise MethodNotFound(f"{cls_name}.{method}")
    return entry


class HCtx:
    """cls_method_context_t: the method's window onto its object.

    Reads see the object's pre-op state overlaid with writes staged
    earlier in the same op; writes stage into `attrs` / `data` and are
    folded into the PGTransaction by the PG after the method returns.
    `entity` is the calling client (reqid), the identity cls_lock keys on.
    """

    def __init__(
        self,
        *,
        exists: bool,
        read_fn: Callable[[], bytes],
        getattr_fn: Callable[[str], bytes | None],
        entity: str = "",
        writable: bool = False,
        omap_fn: Callable[[], dict] | None = None,
    ):
        self._exists = exists
        self._read_fn = read_fn
        self._getattr_fn = getattr_fn
        self._omap_fn = omap_fn  # None: pool has no omap (EC)
        self.entity = entity
        self.writable = writable
        # staged state (read-your-writes overlay; None value = removed)
        self.attrs: dict[str, bytes | None] = {}
        self.omap: dict[str, bytes | None] = {}
        self.omap_cleared = False
        self.data: bytes | None = None
        # whole-object view already folded into the enclosing transaction
        # by an earlier method in the same op (set by the PG)
        self.folded_data: bytes | None = None
        self.created = False

    # -- reads ----------------------------------------------------------------

    def exists(self) -> bool:
        return self._exists or self.created

    def read(self) -> bytes:
        """cls_cxx_read (whole object)."""
        if self.data is not None:
            return self.data
        if self.folded_data is not None:
            return self.folded_data
        if not self._exists:
            raise ClsError(ENOENT, "object does not exist")
        return self._read_fn()

    def getxattr(self, name: str) -> bytes | None:
        """cls_cxx_getxattr; None when absent."""
        if name in self.attrs:
            return self.attrs[name]
        return self._getattr_fn(name)

    # -- omap (cls_cxx_map_* family; cls_rgw's bucket-index substrate) ---------

    def _omap_view(self) -> dict[str, bytes]:
        if self._omap_fn is None:
            raise ClsError(EOPNOTSUPP, "omap on an EC pool")
        base = {} if self.omap_cleared else dict(self._omap_fn())
        for k, v in self.omap.items():
            if v is None:
                base.pop(k, None)
            else:
                base[k] = v
        return base

    def map_get_val(self, key: str) -> bytes:
        """cls_cxx_map_get_val; raises ENOENT when absent."""
        view = self._omap_view()
        if key not in view:
            raise ClsError(ENOENT, f"omap key {key!r}")
        return view[key]

    def map_get_keys(self) -> list[str]:
        return sorted(self._omap_view())

    def map_get_all(self) -> dict[str, bytes]:
        return self._omap_view()

    # -- writes (WR methods only) ---------------------------------------------

    def _need_wr(self) -> None:
        if not self.writable:
            raise ClsError(EOPNOTSUPP, "RD method attempted a write")

    def create(self) -> None:
        """cls_cxx_create: materialize the object (touch)."""
        self._need_wr()
        self.created = True

    def write_full(self, data: bytes) -> None:
        self._need_wr()
        self.data = bytes(data)
        self.created = True

    def setxattr(self, name: str, value: bytes) -> None:
        self._need_wr()
        self.attrs[name] = bytes(value)
        self.created = True

    def rmxattr(self, name: str) -> None:
        self._need_wr()
        self.attrs[name] = None

    def map_set_val(self, key: str, value: bytes) -> None:
        """cls_cxx_map_set_val."""
        self._need_wr()
        if self._omap_fn is None:
            raise ClsError(EOPNOTSUPP, "omap on an EC pool")
        self.omap[key] = bytes(value)
        self.created = True

    def map_set_vals(self, kv: dict[str, bytes]) -> None:
        for k, v in kv.items():
            self.map_set_val(k, v)

    def map_remove_key(self, key: str) -> None:
        self._need_wr()
        if self._omap_fn is None:
            raise ClsError(EOPNOTSUPP, "omap on an EC pool")
        self.omap[key] = None

    def map_clear(self) -> None:
        self._need_wr()
        if self._omap_fn is None:
            raise ClsError(EOPNOTSUPP, "omap on an EC pool")
        self.omap_cleared = True
        self.omap.clear()

    def dirty(self) -> bool:
        return (
            bool(self.attrs)
            or bool(self.omap)
            or self.omap_cleared
            or self.data is not None
            or self.created
        )
