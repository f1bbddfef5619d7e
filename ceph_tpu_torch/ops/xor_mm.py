"""GF(2^8) coding as a bitsliced XOR-matmul, the XOR fold, and the GF(2)
plane product of jerasure's bit-matrix codes.

The port of `ceph_tpu/ops/xor_mm.py`.  The JAX package computes
`xor_matmul` and `encode_full` in plain jnp outside any Pallas kernel, so
plain torch is their port; `gf2_plane_matmul`, an XLA-jitted program that
carries every byte of a liberation, blaum_roth or liber8tion pool, and
`xor_reduce`, the jitted XOR fold that carries the m = 1 parities and the
single-erasure decodes, are hand kernels here (csrc/gf2_plane.cu,
csrc/xor_reduce.cu).

- `xor_matmul` applies an (8m, 8k) GF(2) bit-matrix (gf.bitslice.expand_matrix
  of the (m, k) coding matrix, a runtime operand) to (..., k, L) uint8
  chunks: bit-expand, matmul, keep the parity bit, fold back to bytes.  It is
  `_DeviceCoder`'s tier for chunk lengths that are not a multiple of 128.
  The product runs in float32 on 0/1 planes; it is exact because every sum
  is at most 8k <= 2^24.  TF32 is switched off here all the same, so the
  product is plain float32 whatever the process had set.
- `xor_reduce` is the XOR fold over the chunk axis: the m == 1 parity and
  the single-erasure decode path of codecs whose first parity row is all
  ones (Ceph's `region_xor`, isa/xor_op.cc).  A CPU tensor takes
  `xor_reduce_plain`; a CUDA tensor launches csrc/xor_reduce.cu (one
  launch, any lead shape, a strided view read in place by its strides) or
  raises.  `xor_reduce.launches` counts the kernel's launches; the callers
  record the dispatch (`record_launch`) where the reference's do.
- `gf2_plane_matmul` applies an (R, Q) 0/1 matrix to (..., Q, P) uint8
  planes: output packet r is the XOR of the input packets row r selects
  (jerasure_schedule_encode's packet loop, with the stripes as a batch
  axis).  A CPU tensor takes `gf2_plane_matmul_reference`, the JAX
  package's formulation (bit-expand, float32 product on 0/1 planes, keep
  the parity bit, fold); a CUDA tensor launches csrc/gf2_plane.cu or
  raises.  The kernel reads a strided view in place by its strides (the
  last axis dense, every stride and the base a multiple of 4); any other
  view is first made dense.  `gf2_plane_matmul.launches` counts the
  kernel's launches.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from pathlib import Path

import numpy as np
import torch

from ..common.lockdep import make_lock
from ..common.mempool import track_placement
from . import _nvcc
from .guard import DeviceError

torch.backends.cuda.matmul.allow_tf32 = False

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "gf2_plane.cu"
XOR_REDUCE_SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "xor_reduce.cu"


def _bit_shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device).view(8, 1)


def xor_matmul(bit_matrix: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Apply an (8m, 8k) 0/1 bit-matrix to (..., k, L) uint8 chunks.

    Returns (..., m, L) uint8 on data's device."""
    *lead, k, L = data.shape
    m8, k8 = bit_matrix.shape
    if k8 != 8 * k:
        raise ValueError(f"bit-matrix {tuple(bit_matrix.shape)} does not fit k={k}")
    shifts = _bit_shifts(data.device)
    planes = ((data[..., :, None, :] >> shifts) & 1).reshape(*lead, 8 * k, L)
    acc = torch.matmul(bit_matrix.to(torch.float32), planes.to(torch.float32))
    bits = (acc.to(torch.int32) & 1).reshape(*lead, m8 // 8, 8, L)
    return (bits << shifts.to(torch.int32)).sum(dim=-2).to(torch.uint8)


def xor_reduce_plain(data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the XOR fold: (..., k, L) uint8 -> (..., L)."""
    acc = data[..., 0, :].clone()
    for j in range(1, data.shape[-2]):
        acc ^= data[..., j, :]
    return acc


_XOR_LIB: ctypes.CDLL | None = None
xor_reduce_build_info: dict = {}


def build_xor_reduce_library() -> ctypes.CDLL:
    """Compile csrc/xor_reduce.cu for sm_90a into the build directory (once
    per source content) and load it.  A failed build raises."""
    global _XOR_LIB
    if _XOR_LIB is None:
        built = _nvcc.build("xor_reduce", XOR_REDUCE_SOURCE, {"xor_reduce_launch": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p,
        ]})
        xor_reduce_build_info.update(built.info)
        _XOR_LIB = built.lib
    return _XOR_LIB


def xor_reduce(data: torch.Tensor) -> torch.Tensor:
    """XOR-fold chunks: (..., k, L) uint8 -> (..., L) uint8 on data's device.

    A CPU tensor takes `xor_reduce_plain`; a CUDA tensor launches
    csrc/xor_reduce.cu on the current stream or raises (1 <= k <= 255)."""
    if data.dtype != torch.uint8 or data.dim() < 2:
        raise TypeError(f"xor_reduce: want (..., k, L) uint8, got {data.dtype} "
                        f"{tuple(data.shape)}")
    if data.device.type == "cpu":
        return xor_reduce_plain(data)
    if data.device.type != "cuda":
        raise ValueError(f"xor_reduce: unsupported device {data.device}")
    *lead, k, L = data.shape
    if not 1 <= k <= 255:
        raise ValueError(f"xor_reduce: k = {k} chunks, the kernel takes 1 to 255")
    if data.stride(-1) != 1 and L > 1:
        data = data.contiguous()
    flat = data.reshape(-1, k, L)  # a view where the lead axes merge
    S = flat.shape[0]
    stride_s = flat.stride(0) if S > 1 else 0
    stride_k = flat.stride(1) if k > 1 else 0
    out = torch.empty((S, L), dtype=torch.uint8, device=data.device)
    if S and L:
        align = L | stride_s | stride_k | flat.data_ptr()
        vec = 16 if align % 16 == 0 else (4 if align % 4 == 0 else 1)
        lib = build_xor_reduce_library()
        with torch.cuda.device(data.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.xor_reduce_launch(flat.data_ptr(), out.data_ptr(), S, k, L,
                                        stride_s, stride_k, vec, stream)
        if err != 0:
            raise DeviceError(f"xor_reduce: kernel launch failed (cudaError {err})")
        with _LAUNCH_LOCK:
            xor_reduce.launches += 1
    return out.view(*lead, L)


def encode_full(bit_matrix: torch.Tensor, data: torch.Tensor, *, k: int, m: int) -> torch.Tensor:
    """Encode: (..., k, L) data -> (..., k+m, L) all chunks (systematic)."""
    parity = xor_matmul(bit_matrix, data)
    if parity.shape[-2] != m or data.shape[-2] != k:
        raise ValueError(f"encode_full: k={k} m={m} do not fit {tuple(data.shape)}")
    return torch.cat([data, parity], dim=-2)


# -- the GF(2) plane product ----------------------------------------------------


def _as_bits(bit_matrix) -> np.ndarray:
    if isinstance(bit_matrix, torch.Tensor):
        bit_matrix = bit_matrix.cpu().numpy()
    bm = np.asarray(bit_matrix)
    if bm.ndim != 2:
        raise ValueError(f"gf2_plane_matmul: matrix of shape {bm.shape}, want (R, Q)")
    return (bm & 1).astype(np.uint8)


def gf2_plane_matmul_reference(bit_matrix, planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version, the JAX package's formulation: B (R, Q) 0/1
    applied to (..., Q, P) uint8 planes -> (..., R, P).  The product runs
    in float32 on 0/1 bit-planes; it is exact, since every sum is at most
    Q <= 2^24."""
    bm = torch.from_numpy(_as_bits(bit_matrix)).to(planes.device, torch.float32)
    shifts = _bit_shifts(planes.device)
    bits = (planes[..., :, None, :] >> shifts) & 1  # (..., Q, 8, P)
    acc = torch.einsum("rq,...qbp->...rbp", bm, bits.to(torch.float32))
    parity = (acc.to(torch.int32) & 1) << shifts.to(torch.int32)
    return parity.sum(dim=-2).to(torch.uint8)


_LIB: ctypes.CDLL | None = None
_LAUNCH_LOCK = make_lock("xor_reduce_launch")
build_info: dict = {}
# Device row lists by (device, matrix, plane stride): a decode pattern's
# list is uploaded once, like the coder LRU's operands.
_ROW_LISTS: "OrderedDict[tuple, tuple[torch.Tensor, torch.Tensor, int]]" = OrderedDict()
_ROW_LIST_CAPACITY = 256
# The row list lives in 48 KiB of shared memory: int64 offsets, int32 starts.
_SMEM_BYTES = 48 * 1024


def build_library() -> ctypes.CDLL:
    """Compile csrc/gf2_plane.cu for sm_90a into the build directory (once
    per source content) and load it.  A failed build raises."""
    global _LIB
    if _LIB is None:
        built = _nvcc.build("gf2_plane", SOURCE, {"gf2_plane_launch": [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
        ]})
        build_info.update(built.info)
        _LIB = built.lib
    return _LIB


def _row_list(bm: np.ndarray, stride_q: int, device: torch.device):
    """The kernel's operand for B: (row_start (R + 1,) int32, byte offsets
    (nnz,) int64, nnz) on `device`, plane q at byte offset q * stride_q."""
    key = (str(device), bm.shape, bm.tobytes(), stride_q)
    with _LAUNCH_LOCK:
        hit = _ROW_LISTS.get(key)
        if hit is not None:
            _ROW_LISTS.move_to_end(key)
            return hit
    rows, cols = np.nonzero(bm)
    starts = np.zeros(bm.shape[0] + 1, dtype=np.int32)
    np.cumsum(np.bincount(rows, minlength=bm.shape[0]), out=starts[1:])
    offs = cols.astype(np.int64) * stride_q
    nnz = int(offs.size)
    if nnz * 8 + starts.size * 4 > _SMEM_BYTES:
        raise ValueError(f"gf2_plane_matmul: a {bm.shape} matrix with {nnz} entries does "
                         f"not fit the kernel's {_SMEM_BYTES} bytes of row list")
    entry = (track_placement(torch.from_numpy(starts).to(device), "scratch",
                          site="gf2_plane row starts"),
             track_placement(torch.from_numpy(offs if nnz else np.zeros(1, np.int64)).to(device),
                          "scratch", site="gf2_plane row offsets"), nnz)
    with _LAUNCH_LOCK:
        _ROW_LISTS[key] = entry
        while len(_ROW_LISTS) > _ROW_LIST_CAPACITY:
            _ROW_LISTS.popitem(last=False)
    return entry


def gf2_plane_matmul(bit_matrix, planes: torch.Tensor) -> torch.Tensor:
    """XOR-accumulate product at plane granularity: B (R, Q) 0/1 (numpy or
    tensor) applied to (..., Q, P) uint8 planes -> (..., R, P) uint8 on the
    planes' device, out[r] = XOR of planes[q] where B[r, q] = 1.

    A CPU tensor takes `gf2_plane_matmul_reference`; a CUDA tensor launches
    csrc/gf2_plane.cu on the current stream or raises.  P must be a
    multiple of 4."""
    bm = _as_bits(bit_matrix)
    if planes.dtype != torch.uint8:
        raise TypeError(f"gf2_plane_matmul: dtype {planes.dtype}, want torch.uint8")
    *lead, Q, P = planes.shape
    R = bm.shape[0]
    if bm.shape[1] != Q:
        raise ValueError(f"gf2_plane_matmul: matrix {bm.shape} does not fit Q={Q}")
    if planes.device.type == "cpu":
        return gf2_plane_matmul_reference(bm, planes)
    if planes.device.type != "cuda":
        raise ValueError(f"gf2_plane_matmul: unsupported device {planes.device}")
    if P % 4:
        raise ValueError(f"gf2_plane_matmul: packet of {P} bytes is not a multiple of 4")
    flat = planes.reshape(-1, Q, P)  # a view where the lead axes merge
    S = flat.shape[0]
    stride_s = flat.stride(0) if S > 1 else 0
    stride_q = flat.stride(1) if Q > 1 else 0
    if (flat.stride(2) != 1 and P > 1) or (stride_s | stride_q | flat.data_ptr()) % 4:
        flat = flat.contiguous()
        stride_s, stride_q = Q * P, P
    out = torch.empty((S, R, P), dtype=torch.uint8, device=planes.device)
    if S and R and P:
        starts, offs, nnz = _row_list(bm, stride_q, planes.device)
        vec = 16 if (P | stride_s | stride_q | flat.data_ptr()) % 16 == 0 else 4
        lib = build_library()
        with torch.cuda.device(planes.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.gf2_plane_launch(
                flat.data_ptr(), out.data_ptr(), starts.data_ptr(), offs.data_ptr(),
                S, R, nnz, stride_s, P, vec, stream,
            )
        if err != 0:
            raise DeviceError(f"gf2_plane_matmul: kernel launch failed (cudaError {err})")
        with _LAUNCH_LOCK:
            gf2_plane_matmul.launches += 1
    return out.view(*lead, R, P)


gf2_plane_matmul.launches = 0  # kernel launches (plain-version calls excluded)
xor_reduce.launches = 0  # kernel launches (plain-version calls excluded)
