"""Device crc32c — the checksum service of the offload runtime.

The port of `ceph_tpu/ops/checksum_offload.py`.  BlueStore's per-block
crc32c (its write-side stored-form checksums and its batched read verify)
and the EC-transaction fusion hook submit same-length block batches to one
process-wide `ChecksumAggregator` (background lane), and each aggregated
group is ONE launch of `crc32c_device`.

- `crc32c_device` is the kernel wrapper: (S, L) uint8 rows -> (S,) int64
  digests (the unsigned crc32c of each row).  A CUDA tensor launches
  csrc/crc32c.cu (one warp a row; `crc32c_device.launches` counts) or
  raises; a CPU tensor takes `crc32c_plain`.
- `crc32c_plain` is the JAX package's method in plain torch: crc32c is
  GF(2)-affine in the message at a fixed length L, so the (32, 8L)
  contribution matrix (`_contribution_matrix`) applied through the port's
  plain `xor_matmul` to the transposed batch, folded little-endian into
  32-bit words and XORed with crc32c(0^L) (`_zero_const`), is the digest.
- `crc32c_host_rows` is the host oracle: `utils/crc32c.crc32c` on each row.

Where the reference recomputes a failed or refused launch on the host
oracle, the port does not (ops/guard.py says why): the launch's riders get
EIO at the reap and the backend goes DEGRADED; the store transaction or
read that needed the digests fails whole (ROADMAP fault C8).

Contribution matrix: the byte-step of the reflected-table update
``c' = T[(c ^ b) & 0xFF] ^ (c >> 8)`` is linear in (c, b), so injecting
bit t at byte i contributes T[1 << t] propagated through the remaining
L-1-i zero-input steps A(c) = T[c & 0xFF] ^ (c >> 8).  One backward sweep
builds all L rows; the init/final 0xFFFFFFFF XORs land in the crc32c(0^L)
constant.  Matrices are cached per L.
"""

from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np
import torch

from ..common.lockdep import make_lock as _lockdep_make_lock
from ..utils.crc32c import _TABLE, crc32c
from . import _nvcc
from .dispatch import record_launch
from .offload_runtime import (
    AggTicket,
    LaunchAggregator,
    _AggGroup,
    register_service,
)

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "crc32c.cu"

# Below this many total bytes a batch skips the runtime entirely: the
# host table loop beats dispatch + window latency on small metadata
# writes (the packed_gf.PACKED_MIN_BYTES reasoning, applied to csum).
CSUM_OFFLOAD_MIN_BYTES = 16 * 1024

_MATRIX_LOCK = _lockdep_make_lock("csum_matrix_cache")
_HOST_MATRICES: dict[int, np.ndarray] = {}  # L -> (32, 8L) uint8
_CONSTS: dict[int, int] = {}                # L -> crc32c(b"\x00" * L)
# distinct Ls are bounded in practice (BLOCK plus the compressed-length
# tail population); a pathological length churn must not pin memory
_MATRIX_CACHE_CAP = 64


def _contribution_matrix(L: int) -> np.ndarray:
    """(32, 8L) GF(2) matrix in xor_matmul's LSB-first convention:
    row 8r+s = bit s of output LE byte r, column 8i+t = bit t of input
    byte i."""
    with _MATRIX_LOCK:
        bm = _HOST_MATRICES.get(L)
        if bm is not None:
            return bm
    rows = np.empty((L, 8), dtype=np.uint32)
    c = _TABLE[np.left_shift(1, np.arange(8))].astype(np.uint32)
    rows[L - 1] = c
    for i in range(L - 1, 0, -1):
        c = _TABLE[c & 0xFF] ^ (c >> np.uint32(8))
        rows[i - 1] = c
    bits = (rows[:, :, None] >> np.arange(32, dtype=np.uint32)) & 1
    bm = np.ascontiguousarray(bits.reshape(L * 8, 32).T.astype(np.uint8))
    with _MATRIX_LOCK:
        if len(_HOST_MATRICES) >= _MATRIX_CACHE_CAP:
            _HOST_MATRICES.clear()
        _HOST_MATRICES[L] = bm
    return bm


def _zero_const(L: int) -> int:
    with _MATRIX_LOCK:
        const = _CONSTS.get(L)
    if const is None:
        const = crc32c(b"\x00" * L)
        with _MATRIX_LOCK:
            if len(_CONSTS) >= _MATRIX_CACHE_CAP:
                _CONSTS.clear()
            _CONSTS[L] = const
    return const


def crc32c_plain(blocks: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: (S, L) uint8 -> (S,) int64 digests, by the
    JAX package's method (one (32, 8L) x (8L, S) GF(2) product)."""
    from .xor_mm import xor_matmul

    S, L = blocks.shape
    bm = torch.from_numpy(_contribution_matrix(L)).to(blocks.device)
    out = xor_matmul(bm, blocks.T).to(torch.int64)  # (4, S) LE crc bytes
    crcs = out[0] | (out[1] << 8) | (out[2] << 16) | (out[3] << 24)
    return crcs ^ _zero_const(L)


def crc32c_host_rows(blocks: np.ndarray) -> np.ndarray:
    """Byte-identical host oracle: `utils/crc32c.crc32c` per row."""
    blocks = np.ascontiguousarray(blocks, dtype=np.uint8)
    return np.fromiter(
        (crc32c(row.tobytes()) for row in blocks),
        dtype=np.uint32,
        count=blocks.shape[0],
    )


# -- the kernel's operand ---------------------------------------------------------
#
# csrc/crc32c.cu applies 32x32 GF(2) operators on the 32-bit linear CRC
# register as the XOR of tables indexed by fields of the operator's input:
# 5-bit fields for the hot loop's two operators (a table of 32 words sits
# in the 32 banks of shared memory, so any 32 reads of one are one
# wavefront), 4-bit nibbles for the two the loop does not run.  The
# operand is one flat uint32 array, in the order the kernel reads it:
#   (word 0)    52 tables x 32: L32, field f (bits 5f .. 5f + 4) of a lane's
#               32-byte piece (two 16-byte vectors), from the zero state
#   OP_S        7 tables x 32: S1024, 1024 zero bytes, by 5-bit field
#   OP_FOLD     32 lanes x 8 nibble tables x 16: F_i, the 32 (31 - i) zero
#               bytes that follow lane i's last piece in its row
#   OP_UNSHIFT  16 x 8 nibble tables x 16: U_z for z = 0..15, the inverse of
#               z zero bytes (a row's tail)
# Each block copies the L32, S1024 and U_z tables into shared memory as they
# are and lays OP_FOLD out once per lane, entry e of table t for lane l at
# word (t * 16 + e) * 32 + l (`kernel_image` builds the same image on the
# host for the tests).
FIELD_BITS = 5
PIECE_BYTES = 32                                   # a lane's bytes a step
L_TABLES = -(-8 * PIECE_BYTES // FIELD_BITS)       # 52
S_TABLES = -(-32 // FIELD_BITS)                    # 7
OP_S = L_TABLES << FIELD_BITS
OP_FOLD = OP_S + (S_TABLES << FIELD_BITS)
OP_UNSHIFT = OP_FOLD + 32 * 8 * 16
KERNEL_WORDS = OP_UNSHIFT + 16 * 8 * 16            # 8032
# the image's regions, in words from its 2048-byte aligned base
IMG_FOLD, IMG_L = 0, 8 * 512
IMG_S = IMG_L + OP_S
IMG_UNSHIFT = IMG_S + (S_TABLES << FIELD_BITS)
_TABLES_LOCK = threading.Lock()
_HOST_TABLES: np.ndarray | None = None
_DEVICE_TABLES: dict[str, torch.Tensor] = {}


def _zero_steps(c: np.ndarray, n: int) -> np.ndarray:
    """The linear CRC register after n zero bytes from state(s) c."""
    c = c.astype(np.uint32)
    for _ in range(n):
        c = _TABLE[c & 0xFF] ^ (c >> np.uint32(8))
    return c


def _field_tables(columns: np.ndarray, bits: int) -> np.ndarray:
    """(ceil(n / bits), 2**bits) tables of the operator whose image of input
    bit b is columns[b] (n = len(columns)): table f, entry e = the image of
    e << (bits f), the bits past the input's end left out."""
    n = len(columns)
    nt = -(-n // bits)
    cols = np.zeros(nt * bits, dtype=np.uint32)
    cols[:n] = columns
    sel = ((np.arange(1 << bits, dtype=np.uint32)[:, None] >> np.arange(bits, dtype=np.uint32))
           & 1).astype(bool)
    out = np.zeros((nt, 1 << bits), dtype=np.uint32)
    for f in range(nt):
        out[f] = np.bitwise_xor.reduce(np.where(sel, cols[None, bits * f: bits * f + bits], 0),
                                       axis=1)
    return out


def _gf2_inverse(columns: np.ndarray) -> np.ndarray:
    """Columns of the inverse of the 32x32 GF(2) matrix with these columns."""
    a = ((columns[None, :] >> np.arange(32, dtype=np.uint32)[:, None]) & 1).astype(np.uint8)
    aug = np.concatenate([a, np.eye(32, dtype=np.uint8)], axis=1)
    for col in range(32):
        pivot = col + int(np.flatnonzero(aug[col:, col])[0])
        aug[[col, pivot]] = aug[[pivot, col]]
        for r in np.flatnonzero(aug[:, col]):
            if r != col:
                aug[r] ^= aug[col]
    inv = aug[:, 32:]
    return (inv.astype(np.uint32) << np.arange(32, dtype=np.uint32)[:, None]).sum(
        axis=0, dtype=np.uint64).astype(np.uint32)


def kernel_tables() -> np.ndarray:
    """The kernel's operand, (KERNEL_WORDS,) uint32, built once: the tables
    of L32 (a lane's PIECE_BYTES-byte piece, by FIELD_BITS-bit field) and of
    S1024 (32 PIECE_BYTES zero bytes, by field), then F (per lane) and U_z,
    by nibble."""
    global _HOST_TABLES
    with _TABLES_LOCK:
        if _HOST_TABLES is not None:
            return _HOST_TABLES
    basis = np.left_shift(np.uint32(1), np.arange(32, dtype=np.uint32))
    # bit j of the piece is bit j % 8 of byte j // 8, followed by the piece's
    # PIECE_BYTES - 1 - j // 8 other bytes
    piece = np.concatenate([_zero_steps(_TABLE, PIECE_BYTES - 1 - p)[1 << np.arange(8)]
                            for p in range(PIECE_BYTES)])
    fold = np.empty((32, 8, 16), dtype=np.uint32)
    cols = basis
    for lane in range(31, -1, -1):
        fold[lane] = _field_tables(cols, 4)
        cols = _zero_steps(cols, PIECE_BYTES)
    unshift = np.stack([_field_tables(_gf2_inverse(_zero_steps(basis, z)), 4)
                        for z in range(16)])
    tables = np.concatenate([
        _field_tables(piece, FIELD_BITS).ravel(),
        _field_tables(_zero_steps(basis, 32 * PIECE_BYTES), FIELD_BITS).ravel(),
        fold.ravel(), unshift.ravel()]).astype(np.uint32)
    assert tables.shape == (KERNEL_WORDS,)
    with _TABLES_LOCK:
        _HOST_TABLES = tables
    return tables


def kernel_image(op: np.ndarray) -> np.ndarray:
    """The shared-memory image csrc/crc32c.cu builds from its operand, in
    words: F laid out once per lane (entry e of table t for lane l at word
    (t * 16 + e) * 32 + l), then L32, S1024 and U_z as they are."""
    i = np.arange(8 * 512)
    t, e, lane = i >> 9, (i >> 5) & 15, i & 31
    fold = op[OP_FOLD + (lane * 8 + t) * 16 + e]
    return np.concatenate([fold, op[:OP_FOLD], op[OP_UNSHIFT:]]).astype(np.uint32)


def _device_tables(device: torch.device) -> torch.Tensor:
    key = str(device)
    with _TABLES_LOCK:
        dev = _DEVICE_TABLES.get(key)
    if dev is None:
        dev = torch.from_numpy(kernel_tables().view(np.int32)).to(device)
        with _TABLES_LOCK:
            _DEVICE_TABLES[key] = dev
    return dev


_LIB: ctypes.CDLL | None = None
_LAUNCH_LOCK = threading.Lock()
build_info: dict = {}


def build_library() -> ctypes.CDLL:
    """Compile csrc/crc32c.cu for sm_90a into the build directory (once per
    source content) and load it.  A failed build raises."""
    global _LIB
    if _LIB is None:
        built = _nvcc.build("crc32c", SOURCE, {"crc32c_launch": [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p, ctypes.c_void_p,
        ]})
        build_info.update(built.info)
        _LIB = built.lib
    return _LIB


def crc32c_device(blocks: torch.Tensor) -> torch.Tensor:
    """One batched launch: (S, L) uint8 rows -> (S,) int64 crc32c digests
    on the rows' device.  A CPU tensor takes `crc32c_plain`; a CUDA tensor
    launches csrc/crc32c.cu on the current stream or raises.  Rows are
    read in place by their stride, at any alignment; L = 0 gives zeros."""
    if blocks.dtype != torch.uint8 or blocks.dim() != 2:
        raise TypeError(f"crc32c_device: want (S, L) uint8, got {blocks.dtype} "
                        f"{tuple(blocks.shape)}")
    S, L = blocks.shape
    record_launch(S, S * L)
    if blocks.device.type == "cpu":
        return crc32c_plain(blocks)
    if blocks.device.type != "cuda":
        raise ValueError(f"crc32c_device: unsupported device {blocks.device}")
    if S == 0 or L == 0:
        return torch.zeros(S, dtype=torch.int64, device=blocks.device)
    out = torch.empty(S, dtype=torch.int64, device=blocks.device)  # the kernel writes every row
    if blocks.stride(1) != 1:
        blocks = blocks.contiguous()
    tables = _device_tables(blocks.device)
    lib = build_library()
    with torch.cuda.device(blocks.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.crc32c_launch(blocks.data_ptr(), S, L, blocks.stride(0) if S > 1 else L,
                                tables.data_ptr(), _zero_const(L), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"crc32c_device: kernel launch failed (cudaError {err})")
    with _LAUNCH_LOCK:
        crc32c_device.launches += 1
    return out


crc32c_device.launches = 0  # kernel launches (plain-version calls excluded)


class ChecksumAggregator(LaunchAggregator):
    """Cross-block / cross-object crc32c launch aggregation: every
    same-length csum block submitted inside one window rides ONE kernel
    launch (background lane — checksums must never head-of-line-block
    client encodes).  Tickets resolve to (stripes,) digests.  Groups are
    keyed by device too: a submission names the device its launch runs
    on."""

    PERF_NAME = "csum_aggregator"
    WHAT = "csum"
    SCHED_CLASS = "background"
    MEM_POOL = "offload_inflight"

    def submit_blocks(self, blocks: np.ndarray, device=None) -> AggTicket:
        """Queue one (S, L) uint8 block batch for `device` (None: cuda);
        returns its ticket."""
        from ..codec.base import resolve_device  # lazily: the codec package imports ops

        shaped = np.ascontiguousarray(blocks, dtype=np.uint8)
        if shaped.ndim != 2:
            raise ValueError(f"expected (S, L) blocks, got {shaped.shape}")
        dev = resolve_device(device)
        return self._submit(
            ("#csum", str(dev), shaped.shape[1]), dev, None, shaped[:, None, :]
        )

    def _dispatch(self, g: _AggGroup, data: np.ndarray, donate):
        S = data.shape[0]
        return crc32c_device(torch.from_numpy(data.reshape(S, -1)).to(g.ec))

    def _out_shape(self, g: _AggGroup, data_shape) -> tuple:
        return (data_shape[0],)

    def _donate_ok(self, g: _AggGroup, data_shape) -> bool:
        return False  # a few output bytes per block; pooling buys nothing


_DEFAULT_CSUM_AGGREGATOR: ChecksumAggregator | None = None


def default_csum_aggregator() -> ChecksumAggregator:
    """Process-wide checksum aggregator shared by every BlueStore (and
    the EC-transaction fusion hook) in the process, so concurrent
    writers' csum blocks coalesce exactly like their encodes do."""
    global _DEFAULT_CSUM_AGGREGATOR
    if _DEFAULT_CSUM_AGGREGATOR is None:
        from ..common.options import OPTIONS

        _DEFAULT_CSUM_AGGREGATOR = ChecksumAggregator(
            window=int(OPTIONS["bluestore_csum_offload_window"].default),
            max_bytes=int(
                OPTIONS["bluestore_csum_offload_max_bytes"].default
            ),
        )
    return _DEFAULT_CSUM_AGGREGATOR


register_service(
    "csum", default_csum_aggregator, lane="background",
    oracle="utils/crc32c.crc32c",
    doc="BlueStore per-block crc32c, one kernel launch a window",
)


def checksum_blocks(
    chunks: list[bytes], offload: bool = True, device=None
) -> list[int]:
    """crc32c for each chunk, batched through the offload runtime when
    armed and profitable (chunks grouped by length — each length group
    is one submission riding the shared window), else the host loop.
    Returns digests in input order.  A failed or refused launch raises
    EcError(EIO) at the reap; nothing is recomputed on the host."""
    if not chunks:
        return []
    if not offload or sum(len(c) for c in chunks) < CSUM_OFFLOAD_MIN_BYTES:
        return [crc32c(c) for c in chunks]
    agg = default_csum_aggregator()
    by_len: dict[int, list[int]] = {}
    for i, c in enumerate(chunks):
        by_len.setdefault(len(c), []).append(i)
    out: list[int] = [0] * len(chunks)
    tickets = []
    for L, idxs in by_len.items():
        if L == 0:
            for i in idxs:
                out[i] = 0
            continue
        batch = np.frombuffer(
            b"".join(chunks[i] for i in idxs), dtype=np.uint8
        ).reshape(len(idxs), L)
        tickets.append((idxs, agg.submit_blocks(batch, device)))
    for idxs, ticket in tickets:
        crcs = ticket.result()
        for row, i in enumerate(idxs):
            out[i] = int(crcs[row])
    return out
