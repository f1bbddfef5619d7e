"""RADOS object classes — the port of `ceph_tpu/cls` (Ceph's src/objclass).

Only the runtime is ported: the registry, the method decorator and the
handler context `HCtx` that `osd/pg.py` builds for a CALL op.  Classes
are modules under this package that register their methods through
`cls_method`; none ships yet.
"""

from .objclass import (
    ClsError,
    HCtx,
    MethodNotFound,
    cls_method,
    get_method,
    load_class,
    registry,
)

__all__ = [
    "ClsError",
    "HCtx",
    "MethodNotFound",
    "cls_method",
    "get_method",
    "load_class",
    "registry",
]
