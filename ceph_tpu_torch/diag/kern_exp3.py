"""Kernel experiment round 3, ported: the baked SWAR schedule on words
formed inside the kernel from a staged (rows, cols) byte tile.

`make_swar3(gfm, rows, cols)` is the port of
benchmarks/diag/kern_exp3.py::make_swar3: (S, k, L) uint8 -> (S, m, L)
uint8 GF(2^8) coding, one block per (stripe, rows x cols tile).  The TPU
kernel bitcasts each uint8 tile to int32 along the sublane axis, so word
(r, c) holds rows 4r..4r+3 of column c; the CUDA kernel
(csrc/swar3_baked.cu, the schedule baked per matrix by swar_program.py)
stages the tiles in shared memory with cp.async and forms the same words
with a byte transpose.  `swar3_reference` is its plain version, which the
wrapper takes only for a CPU tensor.

    python -m ceph_tpu_torch.diag.kern_exp3 [filter ...]   # on the card only
"""

from __future__ import annotations

import ctypes
import sys

import numpy as np
import torch

from ..gf import isa_rs_vandermonde_matrix
from ..ops import _nvcc
from ..ops.swar_gf import CodingPlan, schedule_from_matrix, swar_code_reference
from . import Calls, check_oracle, check_uint8_3d, launch, measure, random_data, require_cuda
from .swar_program import BYTE_PERM, CSRC, build_baked

K, M = 8, 3
CHUNK = 128 * 1024
BATCH = 64
ITERS = 30
PROBE_L = 32768
# The script's (rows, cols) tiles (kern_exp3.py:128).
GEOMETRIES = ((8, 512), (16, 256), (16, 512), (32, 128), (32, 256), (32, 512),
              (64, 512), (128, 256))
SOURCE = CSRC / "swar3_baked.cu"
# A block stages slabs of each chunk's tile in a ring of two, in static
# shared memory (at most 48 KiB), at most 2048 bytes of each chunk a slab
# (128 threads x 16 bytes).
_SHARED_BYTES = 48 * 1024
_MAX_SLAB = 2048

launches = 0  # kernel launches made by Swar3 (plain-version calls excluded)


def slab_bytes(k: int) -> int:
    """Bytes of each chunk in one shared-memory slab, for k chunks."""
    cap = _MAX_SLAB
    while 2 * k * cap > _SHARED_BYTES:
        cap //= 2
    return cap


def slab_rows(rows: int, cols: int, k: int) -> int:
    """Rows of the tile one slab holds: the largest multiple of 4 that
    divides rows and fits slab_bytes(k)."""
    best = 0
    for r in range(4, rows + 1, 4):
        if rows % r == 0 and r * cols <= slab_bytes(k):
            best = r
    if not best:
        raise ValueError(
            f"make_swar3: 4 rows of cols={cols} exceed the {slab_bytes(k)}-byte slab"
        )
    return best


def swar3_reference(sched, data: torch.Tensor, rows: int, cols: int) -> torch.Tensor:
    """Plain version: (S, k, L) uint8 -> (S, m, L), computed on the TPU
    kernel's words.  Word (r, c) of a (rows, cols) tile holds rows
    4r..4r+3 of column c, row 4r+p in byte p (what pltpu.bitcast of a uint8
    tile to int32 gives); the reshape and permute below form those words,
    run `swar_code_reference` on them, and put the bytes back.  The function
    is bytewise, so a different grouping would give the same bytes: this
    models the kernel's grouping, it cannot prove it."""
    S, k, L = data.shape
    nt = L // (rows * cols)
    words = (data.reshape(S, k, nt, rows // 4, 4, cols)
             .permute(0, 2, 3, 1, 5, 4).reshape(S, nt, rows // 4, k, 4 * cols))
    coded = swar_code_reference(sched, words)
    m = coded.shape[-2]
    return (coded.reshape(S, nt, rows // 4, m, cols, 4)
            .permute(0, 3, 1, 2, 5, 4).reshape(S, m, L))


class Swar3:
    """Wrapper of the staged, baked SWAR kernel for one (m, k) matrix and
    one (rows, cols) tile."""

    def __init__(self, gf_matrix: np.ndarray, rows: int, cols: int):
        if rows < 4 or rows % 4:
            raise ValueError(f"make_swar3: rows={rows} is not a positive multiple of 4")
        if cols < 4 or cols % 4:
            raise ValueError(f"make_swar3: cols={cols} is not a positive multiple of 4")
        self.gf_matrix = np.asarray(gf_matrix, dtype=np.uint8)
        self.m, self.k = self.gf_matrix.shape
        self.rows, self.cols = rows, cols
        self.slab_rows = slab_rows(rows, cols, self.k)
        self.sched = schedule_from_matrix(self.gf_matrix)
        self._built: _nvcc.Built | None = None

    def build(self) -> _nvcc.Built:
        if self._built is None:
            self._built = build_baked("swar3_baked", SOURCE, self.gf_matrix, {
                "swar3_baked_launch": [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                    ctypes.c_void_p,
                ],
            }, {"kSlabBytes": slab_bytes(self.k), **BYTE_PERM})
        return self._built

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        global launches
        check_uint8_3d("swar3_baked", data)
        S, k, L = data.shape
        if k != self.k:
            raise ValueError(f"swar3_baked: k={k} but the matrix has k={self.k}")
        if L % (self.rows * self.cols):
            raise ValueError(
                f"swar3_baked: L={L} is not a multiple of the {self.rows}x{self.cols} tile"
            )
        if data.device.type == "cpu":
            return swar3_reference(self.sched, data, self.rows, self.cols)
        out = torch.empty((S, self.m, L), dtype=torch.uint8, device=data.device)
        launch("swar3_baked", self.build().lib.swar3_baked_launch, data, out,
               S, L, self.rows, self.cols, self.slab_rows)
        launches += 1
        return out


def make_swar3(gf_matrix: np.ndarray, rows: int, cols: int) -> Swar3:
    return Swar3(gf_matrix, rows, cols)


def main(argv: list[str] | None = None) -> Calls:
    want = argv or None
    dev = require_cuda()
    print(f"backend: cuda ({torch.cuda.get_device_name(dev)})", flush=True)
    gfm = isa_rs_vandermonde_matrix(K, M)[K:]
    data = random_data((BATCH, K, CHUNK), 0, dev)
    in_bytes = BATCH * K * CHUNK
    probe = data[:4, :, :PROBE_L].contiguous()

    calls = Calls()
    variants = {"cur_plan": calls.counted("swar_gf", CodingPlan(gfm, device=dev))}
    for rows, cols in GEOMETRIES:
        variants[f"swar3_r{rows}_c{cols}"] = calls.counted(
            "swar3_baked", make_swar3(gfm, rows, cols))
    for name, fn in variants.items():
        if want and not any(w in name for w in want):
            continue
        check_oracle(name, fn, probe, gfm)
        measure(name, lambda: fn(data), in_bytes, ITERS)
    return calls


if __name__ == "__main__":
    main(sys.argv[1:])
