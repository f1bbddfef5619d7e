"""Fused SWAR bitsliced GF(2^8) coding: the hand CUDA kernel and its plain twin.

The port of `ceph_tpu/ops/pallas_gf.py::_swar_kernel` (launched there by
`_gf_code_swar` through `pl.pallas_call`).  It computes the same function:
(S, k, L) uint8 data -> (S, m, L) uint8, where bit r of output byte i is the
XOR, over the set entries of row 8i+r of `expand_matrix(gf_matrix)`, of bit
b of the matching byte of chunk j.

- `swar_code_reference` is the plain PyTorch version, written the way the
  TPU kernel computes: view 4 bytes as an int32 word, plane b of a word is
  `(w >> b) & 0x01010101`, XOR the scheduled planes of each output bit-row,
  OR `plane << r` back into bytes.
- `swar_gf` is the wrapper of the hand kernel `csrc/swar_gf.cu` (CUDA C++
  for sm_90a, built with nvcc at first use and loaded with ctypes).  It
  takes the plain version only for a tensor on the CPU; for a CUDA tensor it
  launches the kernel or raises.  `launches` counts its kernel launches.
- `CodingPlan` is built once per (matrix, device): the XOR schedule and the
  kernel's schedule operand.  Unlike the TPU kernel, which bakes the
  schedule in at trace time (one compile per matrix), the CUDA kernel takes
  it as a runtime operand, so one library serves every encode matrix and
  every decode matrix of the coder LRU.
- `pick_geometry` and `schedule_from_matrix` are copies of the TPU module's
  helpers.  The CUDA kernel has no tile geometry; `pick_geometry(L)` is kept
  as the L % 128 gate `_DeviceCoder` uses.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from ..gf.bitslice import expand_matrix
from . import _nvcc

# One bit per packed byte field: plane words hold bit b of 4 bytes at bit
# positions {0, 8, 16, 24}.
_FIELD_MASK = 0x01010101

# TPU tile geometry (rows x cols bytes), copied from pallas_gf.py.
_GEOMETRY_COLS = (256, 128, 64, 32)
_MAX_ROWS = 128

# Output byte-rows one kernel pass keeps in registers (csrc/swar_gf.cu).
_ROWS_PER_PASS = 4

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "swar_gf.cu"


def pick_geometry(L: int) -> tuple[int, int] | None:
    """(rows, cols) byte tile for chunk length L, or None if unsupported.

    cols is the lane axis (prefer full 128/256-lane tiles), rows the sublane
    axis (must be a multiple of 4 for the uint8->int32 register bitcast).
    Any L that is a multiple of 128 has a geometry (worst case (4, 32)).
    """
    for cols in _GEOMETRY_COLS:
        if L % cols:
            continue
        rows_total = L // cols
        # scan only multiples of 4 (start rounded down, else e.g.
        # rows_total=66 never lands on one and skips this cols entirely)
        r = min(_MAX_ROWS, rows_total - rows_total % 4)
        while r >= 4:
            if rows_total % r == 0:
                return r, cols
            r -= 4
    return None


def schedule_from_matrix(gf_matrix: np.ndarray) -> tuple[tuple[tuple[int, int], ...], ...]:
    """(m, k) GF matrix -> per-output-bit-row tuple of (chunk, bit) terms.

    Row o = 8*i + r of the bit-expanded matrix lists which input planes
    (chunk j, bit b) XOR into bit r of output byte i.
    """
    plain = expand_matrix(np.asarray(gf_matrix, dtype=np.uint8))  # (8m, 8k)
    m8, k8 = plain.shape
    return tuple(
        tuple((c // 8, c % 8) for c in range(k8) if plain[o, c])
        for o in range(m8)
    )


def schedule_masks_rows(m: int) -> int:
    """Rows of the kernel's schedule operand for m outputs: 8 per output
    byte-row, m rounded up to whole passes of min(m, 4) rows."""
    rows = min(m, _ROWS_PER_PASS)
    return 8 * (-(-m // rows) * rows)


def schedule_masks(gf_matrix: np.ndarray) -> np.ndarray:
    """The kernel's schedule operand: (8m', k) uint32, m' = m rounded up to
    whole kernel passes, zero rows past 8m.

    Entry [o, j] is the 8-bit mask of the planes of chunk j that XOR into
    output bit-row o, repeated in all 4 bytes of the word."""
    plain = expand_matrix(np.asarray(gf_matrix, dtype=np.uint8))
    m8, k8 = plain.shape
    weights = (1 << np.arange(8, dtype=np.uint32))
    masks = (plain.reshape(m8, k8 // 8, 8).astype(np.uint32) * weights).sum(axis=-1)
    out = np.zeros((schedule_masks_rows(m8 // 8), k8 // 8), dtype=np.uint32)
    out[:m8] = masks * np.uint32(0x01010101)
    return out


def swar_code_reference(sched, data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel: (..., k, L) uint8 -> (..., m, L).

    `sched` is `schedule_from_matrix(gf_matrix)`; L must be a multiple of 4.
    """
    *lead, k, L = data.shape
    m = len(sched) // 8
    if L % 4:
        raise ValueError(f"swar_code_reference: L={L} is not a multiple of 4")
    words = data.contiguous().view(torch.int32)  # (..., k, L/4)
    planes: dict[tuple[int, int], torch.Tensor] = {}
    for j, b in sorted({t for row in sched for t in row}):
        w = words[..., j, :]
        planes[(j, b)] = ((w >> b) if b else w) & _FIELD_MASK
    out = torch.zeros((*lead, m, L // 4), dtype=torch.int32, device=data.device)
    for o, row in enumerate(sched):
        if not row:
            continue
        acc = planes[row[0]].clone()
        for t in row[1:]:
            acc ^= planes[t]
        out[..., o // 8, :] |= acc << (o % 8)
    return out.view(torch.uint8)


class CodingPlan:
    """Host-built plan for one (m, k) coding matrix on one device: the XOR
    schedule for the plain version and, on CUDA, the kernel's schedule
    operand.  The analog of ISA-L's `ec_init_tables` product
    (ErasureCodeIsa.cc:83-91), built once and applied to any number of
    stripe batches."""

    def __init__(self, gf_matrix: np.ndarray, *, device: torch.device):
        gf_matrix = np.asarray(gf_matrix, dtype=np.uint8)
        self.m, self.k = gf_matrix.shape
        self.device = torch.device(device)
        self.sched = schedule_from_matrix(gf_matrix)
        self.masks = None
        if self.device.type == "cuda":
            self.masks = torch.from_numpy(
                schedule_masks(gf_matrix).view(np.int32)
            ).to(self.device)
            self.device = self.masks.device  # "cuda" -> "cuda:<index>"

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        """(..., k, L) uint8 -> (..., m, L) uint8 coded output."""
        return swar_gf(self, data)


# -- the hand kernel ----------------------------------------------------------

launches = 0  # kernel launches made by swar_gf (plain-version calls excluded)
_LAUNCH_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
build_info: dict = {}


def build_library() -> ctypes.CDLL:
    """Compile csrc/swar_gf.cu for sm_90a into the build directory (once per
    source content) and load it.  A failed build raises."""
    global _LIB
    if _LIB is None:
        built = _nvcc.build("swar_gf", SOURCE, {"swar_gf_launch": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_void_p,
        ]})
        build_info.update(built.info)
        _LIB = built.lib
    return _LIB


def swar_gf(plan: CodingPlan, data: torch.Tensor) -> torch.Tensor:
    """Wrapper of the hand kernel: (..., k, L) uint8 -> (..., m, L) uint8.

    A CPU tensor takes `swar_code_reference`; a CUDA tensor launches
    csrc/swar_gf.cu on the current stream or raises."""
    global launches
    *lead, k, L = data.shape
    if data.dtype != torch.uint8:
        raise TypeError(f"swar_gf: dtype {data.dtype}, want torch.uint8")
    if k != plan.k:
        raise ValueError(f"swar_gf: k={k} but the plan has k={plan.k}")
    if data.device.type == "cpu":
        return swar_code_reference(plan.sched, data)
    if data.device.type != "cuda" or data.device != plan.device:
        raise ValueError(f"swar_gf: data on {data.device}, plan on {plan.device}")
    if not data.is_contiguous():
        raise ValueError("swar_gf: data must be contiguous")
    if L % 16 or data.data_ptr() % 16:
        raise ValueError("swar_gf: chunk length and base address must be 16-byte aligned")
    stripes = int(np.prod(lead)) if lead else 1
    out = torch.empty((*lead, plan.m, L), dtype=torch.uint8, device=data.device)
    if stripes == 0 or L == 0:
        return out
    lib = build_library()
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.swar_gf_launch(
            data.data_ptr(), out.data_ptr(), plan.masks.data_ptr(),
            stripes, k, plan.m, L, stream,
        )
    if err != 0:
        raise RuntimeError(f"swar_gf: kernel launch failed (cudaError {err})")
    with _LAUNCH_LOCK:
        launches += 1
    return out
