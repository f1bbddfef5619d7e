"""RBD block layer (src/librbd + src/journal + rbd_mirror).

The port's copy of `ceph_tpu/rbd/__init__.py`, with the same exports.
"""

from .mirror import (
    JournaledImage,
    MirrorDaemon,
    enable_journaling,
    promote,
)
from .rbd import RBD, Image, RbdError

__all__ = [
    "RBD",
    "Image",
    "JournaledImage",
    "MirrorDaemon",
    "RbdError",
    "enable_journaling",
    "promote",
]
