"""MDS — the CephFS metadata server (mirror of src/mds); the port's copy
of `ceph_tpu/mds/`."""

from .mds import MDS
from .client import CephFSClient, FsClientError

__all__ = ["MDS", "CephFSClient", "FsClientError"]
