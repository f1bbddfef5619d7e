"""crc32c (Castagnoli) — chunk integrity digests, on the host.

The port of `ceph_tpu/utils/crc32c.py`.  Ceph tracks per-shard cumulative
crc32c in the `hinfo` xattr (src/osd/ECUtil.h:101-160) and verifies it on
every whole-shard sub-read (ECBackend.cc:1023-1156).  The hot path is
`csrc/crc32c_host.cc` (SSE4.2), a copy of the reference's native/crc32c.cc,
built at first use with `g++ -O3 -msse4.2 -shared -fPIC` into the
git-ignored `ceph_tpu_torch/_build/` and loaded with ctypes, the way
`ops/_nvcc.py` builds the kernels: the library is named by the sha256 of
its source, written under a per-process temporary name and renamed into
place, and a failed build raises.  `_crc32c_py`, the table version, is the
plain version the tests hold the library against; nothing falls back to
it, since it runs at about 1 MB/s.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "crc32c_host.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_POLY = 0x82F63B78  # reflected Castagnoli


def _build_table() -> np.ndarray:
    table = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ _POLY if c & 1 else c >> 1
        table[i] = c
    return table


_TABLE = _build_table()


def _crc32c_py(crc: int, data: bytes) -> int:
    c = crc ^ 0xFFFFFFFF
    for b in data:
        c = int(_TABLE[(c ^ b) & 0xFF]) ^ (c >> 8)
    return c ^ 0xFFFFFFFF


_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def build_library() -> ctypes.CDLL:
    """Build (once per source text) and load `csrc/crc32c_host.cc`.
    Raises RuntimeError when g++ fails or is missing."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        text = SOURCE.read_text()
        tag = hashlib.sha256(text.encode()).hexdigest()[:16]
        so = BUILD_DIR / f"libcrc32c_host_{tag}.so"
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = BUILD_DIR / f".libcrc32c_host_{tag}.{os.getpid()}.so"
            cmd = ["g++", "-O3", "-msse4.2", "-shared", "-fPIC",
                   "-o", str(tmp), str(SOURCE)]
            try:
                proc = subprocess.run(cmd, capture_output=True, text=True)
            except FileNotFoundError as e:
                raise RuntimeError(f"crc32c_host: g++ not found: {e}") from e
            if proc.returncode != 0:
                raise RuntimeError(
                    f"crc32c_host: g++ failed ({proc.returncode}):\n{proc.stderr}"
                )
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        lib.ceph_tpu_crc32c.restype = ctypes.c_uint32
        lib.ceph_tpu_crc32c.argtypes = [ctypes.c_uint32, ctypes.c_char_p, ctypes.c_size_t]
        lib.ceph_tpu_crc32c_hw_available.restype = ctypes.c_int
        lib.ceph_tpu_crc32c_hw_available.argtypes = []
        _lib = lib
        return lib


def crc32c(data: bytes | np.ndarray, crc: int = 0) -> int:
    """Cumulative crc32c; pass the previous digest to chain appends."""
    if isinstance(data, np.ndarray):
        data = np.ascontiguousarray(data, dtype=np.uint8).tobytes()
    elif not isinstance(data, bytes):
        data = bytes(data)
    return int(build_library().ceph_tpu_crc32c(crc, data, len(data)))


def hw_available() -> bool:
    return bool(build_library().ceph_tpu_crc32c_hw_available())
