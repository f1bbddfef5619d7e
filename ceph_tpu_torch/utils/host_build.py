"""Build the port's host C++ sources with g++ into shared libraries.

The host libraries (`csrc/crc32c_host.cc`, `csrc/crush.cc`,
`csrc/ec_native.cc`) are built at first use into the git-ignored
`ceph_tpu_torch/_build/`, the way `ops/_nvcc.py` builds the kernels: a
library is named by the sha256 of its sources and flags, written under a
per-process temporary name and `os.replace`d into place (two processes
building the same sources do not collide), and a failed build raises.
The port never builds into, or loads from, the JAX package's `native/`.
"""

from __future__ import annotations

import hashlib
import os
import platform
import subprocess
from pathlib import Path

from ..common.lockdep import make_lock

PKG = Path(__file__).resolve().parents[1]
CSRC = PKG / "csrc"
BUILD_DIR = PKG / "_build"

# native/Makefile's flags: SSE4.2 (crc32) and SSSE3 (pshufb) on x86-64
FLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra"]
if platform.machine() == "x86_64":
    FLAGS += ["-msse4.2", "-mssse3"]

_LOCK = make_lock("host_build")


def build(stem: str, sources: list[Path], flags: list[str] = FLAGS,
          name: str | None = None) -> Path:
    """Compile `sources` into one shared library and return its path.

    With `name` None the library is BUILD_DIR/lib<stem>_<tag>.so; else it
    is BUILD_DIR/<stem>_<tag>/<name>, a directory of its own (a plugin
    directory that `codec/registry.load_dynamic` searches for
    `libec_<plugin>.so`).  Raises RuntimeError when g++ fails or is
    missing."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for src in sources:
        digest.update(src.name.encode() + b"\0" + src.read_bytes())
    tag = digest.hexdigest()[:16]
    if name is None:
        so = BUILD_DIR / f"lib{stem}_{tag}.so"
    else:
        so = BUILD_DIR / f"{stem}_{tag}" / name
    with _LOCK:
        if so.exists():
            return so
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.parent / f".{so.stem}.{os.getpid()}.so"
        cmd = ["g++", *flags, "-shared", "-o", str(tmp), *map(str, sources)]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True)
        except FileNotFoundError as e:
            raise RuntimeError(f"{stem}: g++ not found: {e}") from e
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"{stem}: g++ failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)
    return so
