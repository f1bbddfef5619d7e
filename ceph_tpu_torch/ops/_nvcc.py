"""Build CUDA sources with nvcc into shared libraries with a plain C
interface, and load them with ctypes.

Every hand kernel of the port is built this way, for sm_90a, at its first
use, into the git-ignored `ceph_tpu_torch/_build/`.  A library is named by
the sha256 of its source text, so a changed source builds anew, the same
source is built once per process (and found on disk afterwards), and a
generated source (one per coding matrix for the baked SWAR kernels) gets a
library of its own.  Builds write to a per-process temporary name and
`os.replace` it into place, so two processes building the same source do
not collide.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass, field
from pathlib import Path

from ..common.lockdep import DebugLock, make_lock
from .guard import DeviceError

BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

_BUILT: dict[str, "Built"] = {}
_TAG_LOCKS: dict[str, DebugLock] = {}
_LOCK = make_lock("nvcc_registry")


@dataclass
class Built:
    """A loaded library and how it was built.

    `info` keys: `library` (path of the .so), `source_sha256` (first 16 hex
    digits of the source text's sha256), `seconds` (build and load time in
    this process), and `ptxas` (nvcc's `-Xptxas -v` report; present only
    when this process compiled the library)."""

    lib: ctypes.CDLL
    info: dict = field(default_factory=dict)


def nvcc_path() -> str:
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(nvcc):
        return nvcc
    found = shutil.which("nvcc")
    if found is None:
        raise DeviceError("nvcc not found (set CUDA_HOME)")
    return found


def build(name: str, source: Path | str, symbols: dict[str, list]) -> Built:
    """Compile `source` for sm_90a into BUILD_DIR/lib<name>_<tag>.so and load it.

    `source` is a path to a .cu file, or (a str) the source text itself,
    which is first written to BUILD_DIR/<name>_<tag>.cu.  `symbols` maps
    each exported C function to its ctypes argtypes; every one returns an
    int (a cudaError_t).  Raises DeviceError (a RuntimeError) if nvcc fails."""
    text = source.read_text() if isinstance(source, Path) else source
    tag = hashlib.sha256(text.encode()).hexdigest()[:16]
    key = f"{name}_{tag}"
    with _LOCK:
        tag_lock = _TAG_LOCKS.setdefault(key, make_lock("nvcc_build"))
    with tag_lock:
        if key in _BUILT:
            return _BUILT[key]
        t0 = time.perf_counter()
        so = BUILD_DIR / f"lib{key}.so"
        info = {}
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            src = source
            if not isinstance(source, Path):
                src = BUILD_DIR / f"{key}.cu"
                tmp_src = BUILD_DIR / f".{key}.{os.getpid()}.cu"
                tmp_src.write_text(text)
                os.replace(tmp_src, src)
            tmp = BUILD_DIR / f".lib{key}.{os.getpid()}.so"
            cmd = [
                nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
                "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                "-Xptxas", "-v", "-o", str(tmp), str(src),
            ]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise DeviceError(
                    f"{name}: nvcc failed ({proc.returncode}):\n{proc.stderr}"
                )
            os.replace(tmp, so)
            info["ptxas"] = proc.stderr
        lib = ctypes.CDLL(str(so))
        for sym, argtypes in symbols.items():
            fn = getattr(lib, sym)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        info.update(library=str(so), source_sha256=tag,
                    seconds=time.perf_counter() - t0)
        built = Built(lib, info)
        _BUILT[key] = built
        return built
