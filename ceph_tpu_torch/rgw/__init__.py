"""Object gateway — S3 + Swift semantics over RADOS (src/rgw).

The port's copy of `ceph_tpu/rgw/__init__.py`, with the same exports.
"""

from .rgw import RgwError, ObjectGateway
from .http import S3Server
from .swift import SwiftServer

__all__ = ["ObjectGateway", "RgwError", "S3Server", "SwiftServer"]
