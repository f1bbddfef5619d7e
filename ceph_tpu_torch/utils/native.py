"""ctypes loader for the port's native runtime library.

The port of `ceph_tpu/utils/native.py`, with its symbol surface: the
crc32c pair (`ceph_tpu_crc32c`, `ceph_tpu_crc32c_hw_available`) and the
CRUSH core (`ceph_tpu_crush_hash32`, `_2`, `_3`,
`ceph_tpu_crush_set_ln_table`, `ceph_tpu_crush_ln_table_set`,
`ceph_tpu_straw2_choose`).  One library is built from
`csrc/crc32c_host.cc` and `csrc/crush.cc` at first use into the
git-ignored `ceph_tpu_torch/_build/` (`utils/host_build.py`).

Where the reference runs `make` in `native/` and returns None when no
library can be had, so its callers fall back to Python, the port keeps
`utils/crc32c.py`'s policy: a failed build raises RuntimeError.
"""

from __future__ import annotations

import ctypes

from ..common.lockdep import make_lock
from . import host_build

SOURCES = [host_build.CSRC / "crc32c_host.cc", host_build.CSRC / "crush.cc"]

_lock = make_lock("native_host_library")
_lib: ctypes.CDLL | None = None


def load() -> ctypes.CDLL:
    """The native library, built on demand; raises when it cannot be built."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(host_build.build("ceph_tpu_native", SOURCES)))
        lib.ceph_tpu_crc32c.restype = ctypes.c_uint32
        lib.ceph_tpu_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t]
        lib.ceph_tpu_crc32c_hw_available.restype = ctypes.c_int
        lib.ceph_tpu_crc32c_hw_available.argtypes = []
        lib.ceph_tpu_crush_hash32.restype = ctypes.c_uint32
        lib.ceph_tpu_crush_hash32.argtypes = [ctypes.c_uint32]
        lib.ceph_tpu_crush_hash32_2.restype = ctypes.c_uint32
        lib.ceph_tpu_crush_hash32_2.argtypes = [ctypes.c_uint32] * 2
        lib.ceph_tpu_crush_hash32_3.restype = ctypes.c_uint32
        lib.ceph_tpu_crush_hash32_3.argtypes = [ctypes.c_uint32] * 3
        lib.ceph_tpu_crush_set_ln_table.restype = None
        lib.ceph_tpu_crush_set_ln_table.argtypes = [ctypes.POINTER(ctypes.c_int32)]
        lib.ceph_tpu_crush_ln_table_set.restype = ctypes.c_int
        lib.ceph_tpu_crush_ln_table_set.argtypes = []
        lib.ceph_tpu_straw2_choose.restype = ctypes.c_int32
        lib.ceph_tpu_straw2_choose.argtypes = [
            ctypes.c_uint32,
            ctypes.c_uint32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        _lib = lib
        return lib
