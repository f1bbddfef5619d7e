"""RADOS object classes — the port of `ceph_tpu/cls` (Ceph's src/objclass).

The runtime (`objclass.py`: the registry, the method decorator and the
handler context `HCtx` that `osd/pg.py` builds for a CALL op) and the
reference's classes: `lock`, `version`, `numops` and `refcount`, preloaded
by `osd_op_class_load_list`, and `log`, loaded on its first CALL.
`client.py` holds the typed helpers over `IoCtx.exec`.
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
