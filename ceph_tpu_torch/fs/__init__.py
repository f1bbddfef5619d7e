"""POSIX-style filesystem over RADOS (src/mds + src/client).

The port's copy of `ceph_tpu/fs/__init__.py`, with the same exports: a
library over RADOS and the striper that needs no MDS.
"""

from .fs import FileSystem, FsError

__all__ = ["FileSystem", "FsError"]
