"""Kernel experiment round 1, ported: GF(2^8) coding as a 0/1 bit-matrix
product, and the two halves of it alone.

The ports of benchmarks/diag/kern_exp.py's three Pallas kernels, all in
csrc/bitmatrix.cu (one library, the matrix and g runtime operands):

- `make_grouped(gfm, g, dtype, tile)`: (S, k, L) uint8 -> (S, m, L) uint8
  GF(2^8) coding.  g stripes a block; their g·k chunks expand into 8kg 0/1
  planes, bit-major (row s·8k + b·k + j is bit b of chunk j of stripe s),
  multiplied by the block-diagonal (8mg, 8kg) operand of `dtype`
  (torch.bfloat16 or torch.int8), `& 1`, packed LSB-first into bytes.
  Both operand types run on the tensor cores (wgmma, N = 32: passes of 4
  output chunks) and multiply only the diagonal (8m, 8k) block: int8
  permuted by `imma_operand`, bf16 permuted and scaled by `hgmma_operand`.
  Each operand type
  counts its own launches (`bitmatrix_grouped_int8`, `bitmatrix_grouped_bf16`).
- `make_mm_only(gfm, tile)`: the (8m, 8k) bf16 operand times pre-expanded
  bf16 planes (S, 8k, L) -> (S, 8m, L) uint8 counts (not parity), on the
  tensor cores; the kernel takes the operand with its columns padded with
  zeros to a multiple of 16 (`pad_depth`), and `tile` a multiple of
  `MM_STAGE_COLS`.
- `make_expand_only(tile)`: (S, k, L) uint8 -> (S, 1, L) uint8, the set
  bits over the k bytes of each column.

Each wrapper counts its launches in `launches[name]`, takes its plain
PyTorch version (`grouped_reference`, `mm_only_reference`,
`expand_only_reference`) only for a CPU tensor, and launches the kernel or
raises for a CUDA tensor.  A shape that leaves the TPU grid (S/g, L/tile)
empty or short of the output (S % g, L % tile, L < tile) raises ValueError.

Domain: planes and the GF(2) bit-matrix are 0/1 and every sum has at most
8kg terms (g·k <= 96), so the float32 sums are exact and equal the TPU's
int32 and float32 accumulations byte for byte.

`main()` mirrors the script: `cur_plan` (the port's CodingPlan, the
`swar_gf` kernel), the 13 grouped variants, `mm_only` on bf16 planes and
`expand_only`, at the script's sizes (64 stripes of 8 x 128 KiB, 30
iterations):

    python -m ceph_tpu_torch.diag.kern_exp [filter ...]   # on the card only
"""

from __future__ import annotations

import ctypes
import functools
import sys

import numpy as np
import torch

from ..gf import expand_matrix, isa_rs_vandermonde_matrix
from ..ops import _nvcc
from ..ops.swar_gf import CodingPlan
from . import Calls, check_oracle, check_uint8_3d, launch, measure, random_data, require_cuda
from .swar_program import CSRC

K, M = 8, 3
CHUNK = 128 * 1024
BATCH = 64
ITERS = 30
OPERANDS = {"bf16": torch.bfloat16, "int8": torch.int8}
# The script's grouped variants (kern_exp.py:188-194): (g, operand, tile).
GROUPED_VARIANTS = tuple(
    (g, dn, tile) for g in (2, 4, 8) for dn in OPERANDS for tile in (2048, 4096)
) + ((1, "int8", 4096),)
MM_TILE = 2048
EXPAND_TILE = 4096
# The script probes data[:2, :, :1024], which no grouped variant divides:
# its Pallas grid (S // g, L // tile) is empty and the output all zeros.
# This probe is divided by every variant's g and tile.
PROBE_S, PROBE_L = 8, 8192
# csrc/bitmatrix.cu's limits: the chunks of a grouped block (g·k), the
# chunks of one k-step of the int8 grouped kernel (wgmma m64n32k32: K = 4
# chunks x 8 bits) and its k-steps a chunk group, the words (4 chunks, two
# k16 steps) of a chunk group of the bf16 grouped kernel, the columns of the
# mm_only operand, its rows, the columns of one mm_only ring stage (a tile
# is a whole number of them), the K step of mma.sync m16n8k16, and the
# chunks whose popcounts fit a byte.
MAX_GROUPED_WORDS = 96
IMMA_CHUNKS = 4
IMMA_MAX_STEPS = 8
HGMMA_MAX_WORDS = 4
MAX_MM_COLS = 128
MM_ROWS = (8, 16, 24, 32)
MM_STAGE_COLS = 128
MMA_K = 16
MAX_EXPAND_K = 31
SOURCE = CSRC / "bitmatrix.cu"

# kernel launches made by each wrapper (plain-version calls excluded)
launches = {"bitmatrix_grouped_int8": 0, "bitmatrix_grouped_bf16": 0,
            "bitmatrix_mm_only": 0, "bitmatrix_expand_only": 0}


def arrange_dense_matrix(gfm) -> np.ndarray:
    """(m, k) GF(2^8) matrix -> its (8m, 8k) 0/1 bit-matrix as float32, the
    columns permuted to the bit-major plane order (column b·k + j)."""
    gfm = np.asarray(gfm, dtype=np.uint8)
    m, k = gfm.shape
    perm = np.array([j * 8 + b for b in range(8) for j in range(k)])
    return expand_matrix(gfm)[:, perm].astype(np.float32)


def block_diag(bm: np.ndarray, g: int) -> np.ndarray:
    """g copies of bm on the diagonal of a (g·r, g·c) matrix."""
    r, c = bm.shape
    out = np.zeros((r * g, c * g), dtype=bm.dtype)
    for i in range(g):
        out[i * r:(i + 1) * r, i * c:(i + 1) * c] = bm
    return out


def bit_planes(data: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(S, k, L) uint8 -> (S, 8k, L) 0/1 planes of `dtype`, bit-major: row
    b·k + j is bit b of chunk j (kern_exp.py:58-60 and :209-211)."""
    S, k, L = data.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device).view(1, 8, 1, 1)
    return ((data.unsqueeze(1) >> shifts) & 1).reshape(S, 8 * k, L).to(dtype)


def pad_depth(bm: np.ndarray) -> np.ndarray:
    """(8m, 8k) operand -> (8m, 16·ceil(8k/16)): the columns the mm_only
    kernel's K steps cover, those past 8k zero."""
    rows, cols = bm.shape
    out = np.zeros((rows, -(-cols // MMA_K) * MMA_K), dtype=bm.dtype)
    out[:, :cols] = bm
    return out


def imma_steps(k: int) -> int:
    """The k-steps of 4 chunks the int8 grouped kernel runs for k chunks:
    ceil(k / 4), rounded up to whole chunk groups of equal size, at most
    IMMA_MAX_STEPS each (as bitmatrix_grouped_imma_launch splits them)."""
    kt = -(-k // IMMA_CHUNKS)
    groups = -(-kt // IMMA_MAX_STEPS)
    return -(-kt // groups) * groups


def imma_operand(bm: np.ndarray, k: int) -> np.ndarray:
    """(8m, 8k) bit-matrix in bit-major columns (b·k + j) -> the int8 B
    operand of the tensor-core grouped kernel, (8m, 32·imma_steps(k)):
    column 32t + 4b + i holds column b·k + 4t + i, zero where 4t + i >= k,
    so K index 4b + i of k-step t is bit b of chunk 4t + i."""
    rows = bm.shape[0]
    steps = imma_steps(k)
    padded = np.zeros((rows, 8, steps * IMMA_CHUNKS), dtype=np.int8)
    padded[:, :, :k] = bm.reshape(rows, 8, k)
    return padded.reshape(rows, 8, steps, IMMA_CHUNKS).transpose(0, 2, 1, 3).reshape(
        rows, 32 * steps)


def hgmma_words(k: int) -> int:
    """The words of 4 chunks the bf16 grouped kernel runs for k chunks:
    ceil(k / 4), rounded up to whole chunk groups of equal size, at most
    HGMMA_MAX_WORDS each (as bitmatrix_grouped_hgmma_launch splits them)."""
    kt = -(-k // IMMA_CHUNKS)
    groups = -(-kt // HGMMA_MAX_WORDS)
    return -(-kt // groups) * groups


def hgmma_operand(bm: np.ndarray, k: int) -> np.ndarray:
    """(8m, 8k) bit-matrix in bit-major columns (b·k + j) -> the B operand of
    the bf16 grouped kernel, (8m, 32·hgmma_words(k)) float32 (exact in
    bf16): k16 step j = 2w + o takes chunks 4w + o and 4w + o + 2 of word w;
    its column 16j + q is bit b = (q % 8) // 2 + 4·(q // 8) of chunk
    4w + o + 2·(q % 2), scaled by 2^-b, zero where the chunk is >= k."""
    rows = bm.shape[0]
    words = hgmma_words(k)
    q = np.arange(16)
    bits = (q % 8) // 2 + 4 * (q // 8)
    out = np.zeros((rows, 2 * words, 16), dtype=np.float32)
    for j in range(2 * words):
        chunks = 4 * (j // 2) + j % 2 + 2 * (q % 2)
        live = chunks < k
        out[:, j, live] = bm[:, bits[live] * k + chunks[live]] * 2.0 ** -bits[live]
    return out.reshape(rows, 32 * words)


def grouped_reference(operand: torch.Tensor, data: torch.Tensor, g: int) -> torch.Tensor:
    """Plain version of the grouped kernel: the planes of each g stripes
    times the (8mg, 8kg) operand, summed in float32 (exact in the domain of
    the module doc, for bf16 and int8 operands alike), `& 1`, packed."""
    S, k, L = data.shape
    planes = bit_planes(data, torch.float32).reshape(S // g, g * 8 * k, L)
    acc = torch.matmul(operand.to(torch.float32), planes)
    del planes
    bits = (acc.to(torch.int32) & 1).reshape(S, -1, 8, L)
    del acc
    weights = (1 << torch.arange(8, dtype=torch.int32, device=data.device)).view(1, 1, 8, 1)
    return (bits * weights).sum(2).to(torch.uint8)


def mm_only_reference(operand: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """Plain version of the mm_only kernel: float32 product, cut to int32,
    then to uint8 (counts)."""
    acc = torch.matmul(operand.to(torch.float32), planes.to(torch.float32))
    return acc.to(torch.int32).to(torch.uint8)


def expand_only_reference(data: torch.Tensor) -> torch.Tensor:
    """Plain version of the expand_only kernel: set bits of each column."""
    return bit_planes(data, torch.uint8).sum(1, keepdim=True, dtype=torch.int32).to(torch.uint8)


@functools.cache
def build() -> _nvcc.Built:
    """Build and load csrc/bitmatrix.cu, once per process."""
    ll, i, p = ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p
    return _nvcc.build("bitmatrix", SOURCE, {
        "bitmatrix_grouped_hgmma_launch": [p, p, p, ll, i, i, ll, i, i, p],
        "bitmatrix_grouped_imma_launch": [p, p, p, ll, i, i, ll, i, i, p],
        "bitmatrix_mm_only_launch": [p, p, p, ll, i, i, ll, i, p],
        "bitmatrix_expand_only_launch": [p, p, ll, i, ll, i, p],
    })


def check_grid(name: str, S: int, L: int, g: int, tile: int) -> None:
    """Raise where the TPU grid (S // g, L // tile) would be empty or leave
    output unwritten."""
    if S == 0 or S % g:
        raise ValueError(f"{name}: S={S} is not a positive multiple of g={g}")
    if L < tile or L % tile:
        raise ValueError(f"{name}: L={L} is not a positive multiple of tile={tile}")


class Operand:
    """A matrix operand, copied once to each device it is used on."""

    def __init__(self, matrix: torch.Tensor):
        self.matrix = matrix.contiguous()
        self._on: dict[torch.device, torch.Tensor] = {}

    def on(self, device: torch.device) -> torch.Tensor:
        if device not in self._on:
            self._on[device] = self.matrix.to(device)
        return self._on[device]


class Grouped:
    """Wrapper of the grouped bit-matrix kernels for one (m, k) matrix, g
    stripes a block, operand type `dtype` and `tile` columns a block, both on
    the tensor cores: `bitmatrix_grouped_int8` and `bitmatrix_grouped_bf16`.
    `operand` is the (8mg, 8kg) block-diagonal operand the plain version
    multiplies; `imma` (int8) or `hgmma` (bf16) the one the kernel takes."""

    def __init__(self, gf_matrix: np.ndarray, g: int, dtype: torch.dtype, tile: int):
        if dtype not in OPERANDS.values():
            raise ValueError(f"make_grouped: dtype {dtype}, want torch.bfloat16 or torch.int8")
        if g < 1 or tile < 4 or tile % 4:
            raise ValueError(f"make_grouped: g={g}, tile={tile}; want g >= 1, tile % 4 == 0")
        gfm = np.asarray(gf_matrix, dtype=np.uint8)
        self.m, self.k = gfm.shape
        if g * self.k > MAX_GROUPED_WORDS:
            raise ValueError(f"make_grouped: g·k = {g * self.k} > {MAX_GROUPED_WORDS}")
        self.g, self.dtype, self.tile = g, dtype, tile
        self.kernel = f"bitmatrix_grouped_{'int8' if dtype == torch.int8 else 'bf16'}"
        bm = arrange_dense_matrix(gfm)
        self.operand = Operand(torch.from_numpy(block_diag(bm, g)).to(dtype))
        if dtype == torch.int8:
            self.imma = Operand(torch.from_numpy(imma_operand(bm, self.k)))
        else:
            self.hgmma = Operand(torch.from_numpy(hgmma_operand(bm, self.k)).to(dtype))

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        check_uint8_3d(self.kernel, data)
        S, k, L = data.shape
        if k != self.k:
            raise ValueError(f"{self.kernel}: k={k} but the matrix has k={self.k}")
        check_grid(self.kernel, S, L, self.g, self.tile)
        if data.device.type == "cpu":
            return grouped_reference(self.operand.matrix, data, self.g)
        out = torch.empty((S, self.m, L), dtype=torch.uint8, device=data.device)
        lib = build().lib
        if self.dtype == torch.int8:
            fn, operand = lib.bitmatrix_grouped_imma_launch, self.imma
        else:
            fn, operand = lib.bitmatrix_grouped_hgmma_launch, self.hgmma
        launch(self.kernel, fn, data, out, operand.on(data.device).data_ptr(), S, k, self.m, L,
               self.g, self.tile)
        launches[self.kernel] += 1
        return out


def make_grouped(gf_matrix: np.ndarray, g: int, dtype: torch.dtype, tile: int) -> Grouped:
    return Grouped(gf_matrix, g, dtype, tile)


class MmOnly:
    """Wrapper of the mm_only kernel: the bf16 bit-matrix of one (m, k)
    matrix times bf16 planes, `tile` columns a block.  `operand` is the
    (8m, 8k) bit-matrix the plain version multiplies; `padded` is the same
    with zero columns up to the kernel's K steps."""

    def __init__(self, gf_matrix: np.ndarray, tile: int):
        if tile < MM_STAGE_COLS or tile % MM_STAGE_COLS:
            raise ValueError(f"make_mm_only: tile={tile} is not a positive multiple of "
                             f"{MM_STAGE_COLS}")
        bm = arrange_dense_matrix(gf_matrix)
        if bm.shape[0] not in MM_ROWS or bm.shape[1] > MAX_MM_COLS:
            raise ValueError(f"make_mm_only: operand {bm.shape}, want 8m in {MM_ROWS}, "
                             f"8k <= {MAX_MM_COLS}")
        self.tile = tile
        self.operand = Operand(torch.from_numpy(bm).to(torch.bfloat16))
        self.padded = Operand(torch.from_numpy(pad_depth(bm)).to(torch.bfloat16))

    def __call__(self, planes: torch.Tensor) -> torch.Tensor:
        rows, cols = self.operand.matrix.shape
        if planes.dtype != torch.bfloat16 or planes.dim() != 3 or planes.shape[1] != cols:
            raise ValueError(f"bitmatrix_mm_only: planes {planes.dtype} "
                             f"{tuple(planes.shape)}, want bf16 (S, {cols}, L)")
        S, _, L = planes.shape
        check_grid("bitmatrix_mm_only", S, L, 1, self.tile)
        if planes.device.type == "cpu":
            return mm_only_reference(self.operand.matrix, planes)
        out = torch.empty((S, rows, L), dtype=torch.uint8, device=planes.device)
        launch("bitmatrix_mm_only", build().lib.bitmatrix_mm_only_launch, planes, out,
               self.padded.on(planes.device).data_ptr(), S, cols, rows, L, self.tile)
        launches["bitmatrix_mm_only"] += 1
        return out


def make_mm_only(gf_matrix: np.ndarray, tile: int) -> MmOnly:
    return MmOnly(gf_matrix, tile)


class ExpandOnly:
    """Wrapper of the expand_only kernel, `tile` columns a block."""

    def __init__(self, tile: int):
        if tile < 16 or tile % 16:
            raise ValueError(f"make_expand_only: tile={tile} is not a positive multiple of 16")
        self.tile = tile

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        check_uint8_3d("bitmatrix_expand_only", data)
        S, k, L = data.shape
        if not 1 <= k <= MAX_EXPAND_K:
            raise ValueError(f"bitmatrix_expand_only: k={k}, want 1 <= k <= {MAX_EXPAND_K}")
        check_grid("bitmatrix_expand_only", S, L, 1, self.tile)
        if data.device.type == "cpu":
            return expand_only_reference(data)
        out = torch.empty((S, 1, L), dtype=torch.uint8, device=data.device)
        launch("bitmatrix_expand_only", build().lib.bitmatrix_expand_only_launch, data, out,
               S, k, L, self.tile)
        launches["bitmatrix_expand_only"] += 1
        return out


def make_expand_only(tile: int) -> ExpandOnly:
    return ExpandOnly(tile)


def variant_name(g: int, dn: str, tile: int) -> str:
    return f"g{g}_{dn}_t{tile}"


def main(argv: list[str] | None = None) -> Calls:
    want = argv or None
    dev = require_cuda()
    print(f"backend: cuda ({torch.cuda.get_device_name(dev)})", flush=True)
    gfm = isa_rs_vandermonde_matrix(K, M)[K:]
    data = random_data((BATCH, K, CHUNK), 0, dev)
    in_bytes = BATCH * K * CHUNK
    probe = data[:PROBE_S, :, :PROBE_L].contiguous()

    calls = Calls()
    variants = {"cur_plan": calls.counted("swar_gf", CodingPlan(gfm, device=dev))}
    for g, dn, tile in GROUPED_VARIANTS:
        variants[variant_name(g, dn, tile)] = calls.counted(
            f"bitmatrix_grouped_{dn}", make_grouped(gfm, g, OPERANDS[dn], tile))
    for name, fn in variants.items():
        if want and not any(w in name for w in want):
            continue
        check_oracle(name, fn, probe, gfm)
        measure(name, lambda: fn(data), in_bytes, ITERS)

    def held(name, fn, plain, x):
        if not torch.equal(fn(x), plain(x)):
            raise RuntimeError(f"{name}: kernel != plain version on the probe")

    if not want or any("mm" in w for w in want):
        # planes pre-expanded in bf16: 16x the input bytes read
        planes = bit_planes(data, torch.bfloat16)
        mm = make_mm_only(gfm, MM_TILE)
        fn = calls.counted("bitmatrix_mm_only", mm)
        held("mm_only", fn, lambda x: mm_only_reference(mm.operand.on(dev), x),
             planes[:PROBE_S, :, :PROBE_L].contiguous())
        measure("mm_only(bf16 planes)", lambda: fn(planes), in_bytes, ITERS)
        del planes
    if not want or any("expand" in w for w in want):
        fn = calls.counted("bitmatrix_expand_only", make_expand_only(EXPAND_TILE))
        held("expand_only", fn, expand_only_reference, probe)
        measure("expand_only", lambda: fn(data), in_bytes, ITERS)
    return calls


if __name__ == "__main__":
    main(sys.argv[1:])
