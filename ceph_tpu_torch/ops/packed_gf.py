"""Packed-plane GF(2^8) coding: plane programs, their plain versions and the
wrappers of the hand kernels of `csrc/packed_gf.cu`.

The port of `ceph_tpu/ops/packed_gf.py`.  Byte j of a chunk already holds its
own 8 bit planes, packed; multiplying by a coefficient c is the XOR, over the
set bits b of c, of x * 2^b, and multiplying by 2 (`xtime`) is
`(x << 1) ^ ((x >> 7) * 0x1d)` on each byte.  So coding (…, k, L) chunks by an
(m, k) matrix is a straight-line *plane program* over uint8 registers:
registers 0..k-1 are the input chunks, each op appends one register, either
("x", a, b) = regs[a] ^ regs[b] or ("t", a) = xtime(regs[a]), and `outputs`
names one register per output row (-1: an all-zero row).  `best_program`
picks the cheapest of three constructions (naive towers, CSE, the polynomial
ring's Horner form); all three compute the same bytes.

- Copies of the reference's generators and host oracles, pinned equal to it
  by tests/test_torch_packed.py: `plane_schedule`, `naive_program`,
  `cse_program`, `ring_program`, `best_program`, `run_program_host`,
  `packed_code_host`, `packed_verify_host`, `packed_delta_host`.
- Plain PyTorch versions of the three device programs of the reference
  (`_packed_code_impl`, `_packed_verify_impl`, `_packed_delta`), on tensors
  of any device: `packed_code_reference`, `packed_verify_reference`,
  `packed_delta_reference`.
- `lower_program`: the host form of a program that the kernels take as a
  runtime operand, so one library serves every matrix (an nvcc build per
  decode pattern of the 2516-entry coder LRU would cost seconds each).  Ops
  become (kind, dst slot, a slot, b slot) rows; a register gets a slot only
  if something reads it from memory, and slots are reused once dead.  An op
  whose first operand is the previous op's result reads it from the
  kernel's accumulator register (slot -1), and a result that only the next
  op reads that way is not stored (dst -1).  A program may have any number
  of ops: the kernels stage its rows in tiles of TILE_OPS.  They keep 16
  bytes a slot a thread in shared memory, so a program's slots set the
  threads of its block (`block_threads`).  `kernel_program` gives a plan's
  matrix the construction that fits the most threads, then the fewest ops,
  memoized; it never builds a tower-based construction whose leaves alone
  cannot fit where the ring program does.
- What bounds the kernels is bytes: a thread's input rows go into their
  slots by cp.async, all in flight; a launch takes twice the resident blocks
  and each walks its work items; the verify's blocks own whole stripes (no
  zeroing, no atomic).  The row table is given as group descriptors
  (address, stripe stride, row stride, rows), up to MAX_ROWS = 512 rows,
  read by strides in place.  csrc/packed_gf.cu's note has the design.
- Wrappers `packed_code`, `packed_verify`, `packed_delta`,
  `packed_delta_flat`: a CPU tensor takes the plain version; a CUDA tensor
  launches the kernel or raises.  `launches` counts the kernel launches of
  each of the three kernels.
- `PackedPlan` and `PackedVerifyPlan`: one per matrix, counted on
  `ops/dispatch.py`'s launch counters as the reference counts them.
"""

from __future__ import annotations

import ctypes
import itertools
import struct
from pathlib import Path

import numpy as np
import torch

from ..common.lockdep import make_lock
from ..common.mempool import track_placement
from ..gf.tables import GF_MUL_TABLE
from . import _nvcc
from .guard import DeviceError
from .dispatch import lead_stripes, record_launch

# xtime reduction byte: 2 * 0x80 in GF(2^8) == generator poly & 0xFF.
_XTIME_RED = int(GF_MUL_TABLE[2, 0x80])

# Inputs of at least this many bytes whose chunk length misses the SWAR
# tier (L % 128) take the packed tier of `_DeviceCoder`; smaller ones
# `xor_matmul` (the reference's threshold, packed_gf.py:63).
PACKED_MIN_BYTES = 64 * 1024

# Kernel limits (csrc/packed_gf.cu): row pointers one launch may pass (2k +
# 2m for the delta, k + m <= 256), op rows staged at once (16 bytes each),
# and the shared memory a block may take.  A block has BLOCK_THREADS threads,
# halved down to MIN_THREADS where the program's slots (16 bytes a thread
# each) would not fit; so a program may need at most MAX_SLOTS live slots,
# fewer by its op rows.
MAX_ROWS = 512
TILE_OPS = 1024
SMEM_LIMIT = 232448
BLOCK_THREADS, MIN_THREADS = 128, 32
MAX_SLOTS = SMEM_LIMIT // (16 * MIN_THREADS)

OP_XOR, OP_XTIME = 0, 1
MODE_CODE, MODE_VERIFY, MODE_DELTA = 0, 1, 2

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "packed_gf.cu"

_PROG_TAG = "prog"


# -- plane programs (copies of the reference's generators) --------------------


def plane_schedule(gf_matrix: np.ndarray) -> tuple[tuple[tuple[int, int], ...], ...]:
    """(m, k) GF matrix -> per-output-row tuple of (chunk j, power b) terms.

    Output byte i is the XOR of packed planes data[j] * 2^b for every set
    bit b of coefficient gf_matrix[i, j]."""
    gfm = np.asarray(gf_matrix, dtype=np.uint8)
    m, k = gfm.shape
    return tuple(
        tuple(
            (j, b)
            for j in range(k)
            for b in range(8)
            if (int(gfm[i, j]) >> b) & 1
        )
        for i in range(m)
    )


def naive_program(gf_matrix: np.ndarray) -> tuple:
    """The tower schedule as a plane program: xtime power towers per chunk,
    then one XOR chain per output row over the selected tower planes."""
    gfm = np.asarray(gf_matrix, dtype=np.uint8)
    return program_from_rows(plane_schedule(gfm), gfm.shape[1])


def program_from_rows(rows, k: int) -> tuple:
    """A (chunk, power) row schedule as the tower program `naive_program`
    builds: the same bytes as the reference's legacy row-schedule branch
    (towers up to each chunk's highest power, one XOR chain per row)."""
    ops, leaf = _tower_ops(rows, k)
    outputs = [_xor_chain(ops, k, [leaf[t] for t in row]) for row in rows]
    return (_PROG_TAG, k, len(rows), tuple(ops), tuple(outputs))


def cse_program(gf_matrix: np.ndarray) -> tuple:
    """Greedy pairwise CSE over the tower leaves (arXiv:2108.02692):
    repeatedly factor the plane pair shared by the most output rows into
    one intermediate register.  Deterministic (ties break on the lowest
    register pair)."""
    gfm = np.asarray(gf_matrix, dtype=np.uint8)
    m, k = gfm.shape
    rows_terms = plane_schedule(gfm)
    ops, leaf = _tower_ops(rows_terms, k)
    rows = [set(leaf[t] for t in row) for row in rows_terms]
    while True:
        counts: dict[tuple[int, int], int] = {}
        for row in rows:
            srow = sorted(row)
            for i, a in enumerate(srow):
                for b in srow[i + 1 :]:
                    counts[(a, b)] = counts.get((a, b), 0) + 1
        best = None
        for pair, f in counts.items():
            if f < 2:
                continue
            rank = (f, -pair[0], -pair[1])
            if best is None or rank > best[0]:
                best = (rank, pair)
        if best is None:
            break
        a, b = best[1]
        ops.append(("x", a, b))
        node = k + len(ops) - 1
        for row in rows:
            if a in row and b in row:
                row.discard(a)
                row.discard(b)
                row.add(node)
    outputs = [_xor_chain(ops, k, sorted(row)) for row in rows]
    return (_PROG_TAG, k, m, tuple(ops), tuple(outputs))


def ring_program(gf_matrix: np.ndarray) -> tuple:
    """Horner evaluation over the polynomial ring (arXiv:1701.07731): per
    output row, XOR the bit-level sums and chain multiply-by-x; tower-free,
    at most 7 xtimes per output row."""
    gfm = np.asarray(gf_matrix, dtype=np.uint8)
    m, k = gfm.shape
    ops: list[tuple] = []
    outputs = []
    for i in range(m):
        levels = [
            [j for j in range(k) if (int(gfm[i, j]) >> b) & 1]
            for b in range(8)
        ]
        nonzero = [b for b in range(8) if levels[b]]
        if not nonzero:
            outputs.append(-1)
            continue
        top = nonzero[-1]
        acc = _xor_chain(ops, k, levels[top])
        for b in range(top - 1, -1, -1):
            ops.append(("t", acc))
            acc = k + len(ops) - 1
            if levels[b]:
                lvl = _xor_chain(ops, k, levels[b])
                ops.append(("x", acc, lvl))
                acc = k + len(ops) - 1
        outputs.append(acc)
    return (_PROG_TAG, k, m, tuple(ops), tuple(outputs))


def _tower_ops(rows, k: int):
    """xtime power towers for every (chunk, power) leaf the rows use.
    Returns (ops list, {(j, b): register})."""
    ops: list[tuple] = []
    leaf: dict[tuple[int, int], int] = {}
    max_pow = [0] * k
    for row in rows:
        for j, b in row:
            max_pow[j] = max(max_pow[j], b)
    for j in range(k):
        leaf[(j, 0)] = j
        prev = j
        for b in range(1, max_pow[j] + 1):
            ops.append(("t", prev))
            prev = k + len(ops) - 1
            leaf[(j, b)] = prev
    return ops, leaf


def _xor_chain(ops: list, k: int, regs: list[int]) -> int:
    """Left-to-right XOR chain over registers; returns the result register
    (-1 for an empty row: an all-zero output)."""
    if not regs:
        return -1
    acc = regs[0]
    for r in regs[1:]:
        ops.append(("x", acc, r))
        acc = k + len(ops) - 1
    return acc


def is_program(sched) -> bool:
    return bool(sched) and sched[0] == _PROG_TAG


def program_cost(prog) -> int:
    """Vector-op count of a plane program (XORs + xtimes)."""
    if not is_program(prog):
        raise ValueError(f"not a plane program: {prog!r:.80}")
    return len(prog[3])


# best_program memo: decode matrices churn (one per erasure pattern).
_PROGRAM_MEMO_CAPACITY = 512
_PROGRAM_MEMO: dict[tuple, tuple] = {}
_PROGRAM_LOCK = make_lock("packed_program_memo")


def best_program(gf_matrix: np.ndarray) -> tuple:
    """The cheapest of the naive tower, CSE-reduced and ring constructions
    for this matrix (memoized); all compute the same bytes."""
    gfm = np.asarray(gf_matrix, dtype=np.uint8)
    key = (gfm.shape, gfm.tobytes())
    with _PROGRAM_LOCK:
        cached = _PROGRAM_MEMO.get(key)
    if cached is not None:
        return cached
    candidates = [cse_program(gfm), ring_program(gfm), naive_program(gfm)]
    prog = min(candidates, key=program_cost)
    with _PROGRAM_LOCK:
        if len(_PROGRAM_MEMO) >= _PROGRAM_MEMO_CAPACITY:
            _PROGRAM_MEMO.clear()  # tiny entries; wholesale reset is fine
        _PROGRAM_MEMO.setdefault(key, prog)
        return _PROGRAM_MEMO[key]


# -- host oracles ---------------------------------------------------------------


def _xtime_host(x: np.ndarray) -> np.ndarray:
    """Host xtime (uint8 shift wraps mod 256)."""
    return ((x << 1) ^ ((x >> 7) * np.uint8(_XTIME_RED))).astype(np.uint8)


def run_program_host(prog: tuple, data: np.ndarray) -> np.ndarray:
    """Execute a plane program in numpy: (..., k, L) -> (..., m, L)."""
    tag, k, m, ops, outputs = prog
    if tag != _PROG_TAG:
        raise ValueError("not a plane program")
    data = np.asarray(data, dtype=np.uint8)
    *lead, kk, L = data.shape
    if kk != k:
        raise ValueError(f"data has {kk} chunks, the program {k}")
    regs: list[np.ndarray] = [data[..., j, :] for j in range(k)]
    for op in ops:
        if op[0] == "x":
            regs.append(regs[op[1]] ^ regs[op[2]])
        else:
            regs.append(_xtime_host(regs[op[1]]))
    outs = [
        np.zeros((*lead, L), np.uint8) if o < 0 else regs[o]
        for o in outputs
    ]
    return np.stack(outs, axis=-2)


def packed_code_host(gf_matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Host oracle of the packed encode, through `best_program`:
    (..., k, L) uint8 -> (..., m, L)."""
    return run_program_host(best_program(gf_matrix), data)


def packed_delta_host(
    gf_matrix: np.ndarray,
    old_data: np.ndarray,
    new_data: np.ndarray,
    old_parity: np.ndarray,
) -> np.ndarray:
    """Host oracle of the RMW delta: old_parity ^ Encode(old ^ new)."""
    delta = run_program_host(
        best_program(gf_matrix),
        np.asarray(old_data, np.uint8) ^ np.asarray(new_data, np.uint8),
    )
    return np.asarray(old_parity, np.uint8) ^ delta


def packed_verify_host(gf_matrix: np.ndarray, codeword: np.ndarray) -> np.ndarray:
    """Host oracle of the verify: (..., k+m, L) codewords -> (...,) uint8,
    bit j set iff the recomputed parity row j differs from stored row j."""
    gfm = np.asarray(gf_matrix, dtype=np.uint8)
    m, k = gfm.shape
    if m > 8:
        raise ValueError(f"mismatch bitmap is uint8; m={m} > 8")
    cw = np.asarray(codeword, dtype=np.uint8)
    data, stored = cw[..., :k, :], cw[..., k:, :]
    recomputed = packed_code_host(gfm, data)
    row_bad = np.any(recomputed ^ stored, axis=-1)  # (..., m) bool
    weights = (np.uint8(1) << np.arange(m, dtype=np.uint8))
    return np.sum(row_bad.astype(np.uint8) * weights, axis=-1, dtype=np.uint8)


# -- plain PyTorch versions of the device programs -------------------------------


def _xtime(x: torch.Tensor) -> torch.Tensor:
    """Packed multiply-by-2 on uint8: the left shift wraps mod 256, and
    (x >> 7) * 0x1d stays uint8 (a Python scalar does not promote)."""
    return (x << 1) ^ ((x >> 7) * _XTIME_RED)


def packed_code_reference(prog: tuple, data: torch.Tensor) -> torch.Tensor:
    """Plain version of the packed encode: (..., k, L) uint8 -> (..., m, L),
    the reference's `_packed_code_impl` program branch."""
    _tag, k, m, ops, outputs = prog
    *lead, kk, L = data.shape
    if kk != k:
        raise ValueError(f"data has {kk} chunks, the program {k}")
    regs: list[torch.Tensor] = [data[..., j, :] for j in range(k)]
    for op in ops:
        if op[0] == "x":
            regs.append(regs[op[1]] ^ regs[op[2]])
        else:
            regs.append(_xtime(regs[op[1]]))
    outs = [
        torch.zeros((*lead, L), dtype=torch.uint8, device=data.device) if o < 0 else regs[o]
        for o in outputs
    ]
    return torch.stack(outs, dim=-2)


def packed_verify_reference(prog: tuple, codeword: torch.Tensor) -> torch.Tensor:
    """Plain version of the verify: (..., k+m, L) -> (...,) uint8 bitmap."""
    k, m = prog[1], prog[2]
    recomputed = packed_code_reference(prog, codeword[..., :k, :])
    row_bad = (recomputed ^ codeword[..., k:, :]).ne(0).any(dim=-1)  # (..., m)
    weights = 1 << torch.arange(m, dtype=torch.int32, device=codeword.device)
    return (row_bad.to(torch.int32) * weights).sum(dim=-1).to(torch.uint8)


def packed_delta_reference(
    prog: tuple, old: torch.Tensor, new: torch.Tensor, parity: torch.Tensor
) -> torch.Tensor:
    """Plain version of the RMW delta: parity ^ P(old ^ new)."""
    return parity ^ packed_code_reference(prog, old ^ new)


# -- the kernels' operand ------------------------------------------------------------


class LoweredProgram:
    """A plane program in the form the kernels take: `ops` (n, 4) int32 rows
    (kind, dst slot, a slot, b slot), `in_slots` (k,) and `out_slots` (m,)
    int32 (-1: an unused input, an all-zero output row), `nslots` slots,
    `threads` a block (`block_threads`).  `operand(device)` is the flat
    int32 tensor ops ++ in_slots ++ out_slots, cached per device index."""

    __slots__ = ("prog", "k", "m", "ops", "in_slots", "out_slots", "nslots", "threads",
                 "_host", "_dev", "_lock")

    def __init__(self, prog: tuple):
        if not is_program(prog):
            raise ValueError("not a plane program")
        self.prog = prog
        self.k, self.m = prog[1], prog[2]
        self.ops, self.in_slots, self.out_slots, self.nslots = _lower(prog)
        self.threads = block_threads(len(self.ops), self.nslots, self.k, self.m)
        if not self.threads:
            raise ValueError(
                f"plane program needs {self.nslots} live slots over {len(self.ops)} ops: more "
                f"than {SMEM_LIMIT} bytes of shared memory at {MIN_THREADS} threads a block")
        self._host = np.concatenate(
            [self.ops.ravel(), self.in_slots, self.out_slots]).astype(np.int32)
        self._dev: dict[int | None, torch.Tensor] = {}
        self._lock = make_lock("packed_program_operand")

    def operand(self, device: torch.device) -> torch.Tensor:
        t = self._dev.get(device.index)
        if t is None:
            t = track_placement(torch.from_numpy(self._host).to(device), "scratch",
                             site="packed program operand")
            with self._lock:
                t = self._dev.setdefault(device.index, t)
        return t


def shared_bytes(nops: int, k: int, m: int, slots: int, threads: int) -> int:
    """Shared memory of a block of csrc/packed_gf.cu: one tile of op rows (16
    bytes each), the k + m slot maps and 8 reduction words, rounded up to 16
    bytes, then 16 bytes a slot a thread."""
    head = -(-(16 * min(nops, TILE_OPS) + 4 * (k + m) + 32) // 16) * 16
    return head + 16 * slots * threads


def block_threads(nops: int, nslots: int, k: int, m: int) -> int:
    """Threads a block of csrc/packed_gf.cu takes for a program of `nops`
    ops and `nslots` slots: BLOCK_THREADS, halved while its shared memory
    (`shared_bytes`) would pass SMEM_LIMIT; 0 if it does not fit at
    MIN_THREADS."""
    threads = BLOCK_THREADS
    while threads >= MIN_THREADS:
        if shared_bytes(nops, k, m, nslots, threads) <= SMEM_LIMIT:
            return threads
        threads //= 2
    return 0


def _lower(prog: tuple):
    """(ops, in_slots, out_slots, nslots) of a plane program; see
    `LoweredProgram`."""
    _tag, k, m, ops, outputs = prog
    n = len(ops)
    # `a` is the accumulator when it is the previous op's result (an XOR
    # whose second operand is that result swaps its operands)
    operands = []
    for i, op in enumerate(ops):
        prev = k + i - 1 if i else None
        a = op[1]
        b = op[2] if op[0] == "x" else None
        if b is not None and a != prev and b == prev:
            a, b = b, a
        operands.append((a == prev, a, b))
    last = {}  # register -> index of its last read from a slot (n: an output)
    for i, (acc, a, b) in enumerate(operands):
        if not acc:
            last[a] = i
        if b is not None:
            last[b] = i
    for o in outputs:
        if o >= 0:
            last[o] = n
    free: list[int] = []
    slot: dict[int, int] = {}
    nslots = 0

    def take() -> int:
        nonlocal nslots
        if free:
            return free.pop(free.index(min(free)))
        nslots += 1
        return nslots - 1

    in_slots = np.full(k, -1, np.int32)
    for j in range(k):
        if j in last:
            slot[j] = in_slots[j] = take()
    rows = np.zeros((n, 4), np.int32)
    for i, (acc, a, b) in enumerate(operands):
        rows[i, 0] = OP_XOR if ops[i][0] == "x" else OP_XTIME
        rows[i, 2] = -1 if acc else slot[a]
        rows[i, 3] = 0 if b is None else slot[b]
        for r in {a, b} - {None}:  # a slot last read here is free for dst
            if last.get(r) == i:
                free.append(slot[r])
        dst = k + i
        rows[i, 1] = -1
        if dst in last:
            slot[dst] = rows[i, 1] = take()
    out_slots = np.array([-1 if o < 0 else slot[o] for o in outputs], np.int32).reshape(m)
    return rows, in_slots, out_slots, nslots


def _program(sched) -> tuple:
    """The plane program of `sched` (a program or a LoweredProgram): what
    the plain versions run."""
    if isinstance(sched, LoweredProgram):
        return sched.prog
    if not is_program(sched):
        raise ValueError(f"not a plane program: {sched!r:.80}")
    return sched


def lower_program(sched, k: int | None = None) -> LoweredProgram:
    """The kernels' form of `sched`: a plane program, or a legacy
    (chunk, power) row schedule of `k` chunks, which is lowered to the tower
    program `naive_program` builds (the same bytes).  Plans keep theirs."""
    if isinstance(sched, LoweredProgram):
        return sched
    if not is_program(sched):
        if k is None:
            raise ValueError("a row schedule needs k")
        sched = program_from_rows(sched, k)
    return LoweredProgram(sched)


# kernel_program memo, bounded as best_program's.
_KERNEL_MEMO: dict[tuple, LoweredProgram] = {}


def _fitting(prog: tuple) -> LoweredProgram | None:
    """The lowered program, or None where it fits no block."""
    try:
        return LoweredProgram(prog)
    except ValueError:
        return None


def tower_leaves(gf_matrix: np.ndarray) -> int:
    """Distinct (chunk, power) planes the matrix's rows use: all are live at
    once in a tower-based program (naive, CSE) once its towers are built, so
    such a program needs at least this many slots."""
    return len({term for row in plane_schedule(gf_matrix) for term in row})


def kernel_program(gf_matrix: np.ndarray) -> LoweredProgram:
    """The construction the kernels run for a matrix (all give the same
    bytes), memoized: of those that fit a block, the one with the most
    threads a block, then the fewest ops, ties in `best_program`'s order.
    The CSE and tower programs keep every tower leaf live, about 7.5 slots a
    data chunk in a dense decode, so from RS(21,4)'s decode on they fit a
    block only of 64 threads or fewer, or none; the ring program needs about
    k + m + 3 slots (its outputs stay live to the end) and takes 128 up to
    k + m of about 110.  So where the leaves alone do not fit a block of the
    ring program's threads, the tower-based ones are not built (Cauchy(128,
    16)'s CSE would take minutes of host time)."""
    gfm = np.asarray(gf_matrix, dtype=np.uint8)
    key = (gfm.shape, gfm.tobytes())
    cached = _KERNEL_MEMO.get(key)
    if cached is not None:
        return cached
    ring = _fitting(ring_program(gfm))
    if ring is not None and tower_leaves(gfm) > (
            SMEM_LIMIT - shared_bytes(0, gfm.shape[1], gfm.shape[0], 0, 0)) // (16 * ring.threads):
        candidates = [ring]  # a tower program would fit only fewer threads
    else:
        candidates = [_fitting(cse_program(gfm)), ring, _fitting(naive_program(gfm))]
    fitting = [lp for lp in candidates if lp is not None]
    if not fitting:
        raise ValueError(f"no plane program of the {gfm.shape} matrix fits the kernels")
    best = min(fitting, key=lambda lp: (-lp.threads, len(lp.ops)))
    with _PROGRAM_LOCK:
        if len(_KERNEL_MEMO) >= _PROGRAM_MEMO_CAPACITY:
            _KERNEL_MEMO.clear()
        return _KERNEL_MEMO.setdefault(key, best)


# -- the hand kernels ----------------------------------------------------------------

launches = {"packed_code": 0, "packed_verify": 0, "packed_delta": 0}
_LAUNCH_LOCK = make_lock("packed_gf_launch")
_LAUNCH = None  # the bound C entry packed_gf_launch
_RAW_STREAM = None  # torch's current raw stream of a device index
build_info: dict = {}


def build_library() -> ctypes.CDLL:
    """Compile csrc/packed_gf.cu for sm_90a into the build directory (once
    per source content) and load it; binds `packed_gf_launch`.  A failed
    build raises."""
    global _LAUNCH, _RAW_STREAM
    from torch._C import _cuda_getCurrentRawStream

    built = _nvcc.build("packed_gf", SOURCE, {"packed_gf_launch": [
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
    ]})
    build_info.update(built.info)
    _RAW_STREAM = _cuda_getCurrentRawStream
    _LAUNCH = built.lib.packed_gf_launch
    return built.lib


def _check(name: str, *tensors: torch.Tensor) -> torch.device:
    dev = tensors[0].device
    for t in tensors:
        if t.dtype != torch.uint8:
            raise TypeError(f"{name}: dtype {t.dtype}, want torch.uint8")
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _stripes(t: torch.Tensor, rows: int) -> torch.Tensor:
    """(..., rows, L) as an (S, rows, L) tensor whose last axis is dense: a
    view where the strides allow it (a slice of codewords stays a view),
    else a copy."""
    if t.stride(-1) != 1:
        t = t.contiguous()
    return t if t.dim() == 3 else t.reshape(-1, rows, t.shape[-1])


def group(t: torch.Tensor) -> tuple[int, int, int, int]:
    """The group descriptor of an (S, n, L) tensor whose last axis is dense:
    (base address, stripe stride, row stride, rows), strides in bytes.  The
    kernel's row table is the groups' rows in order, row i of a group at
    base + i * row stride."""
    s0, s1, _ = t.stride()
    return (t.data_ptr(), s0, s1, t.shape[1])


_DESCRIPTORS: dict[int, struct.Struct] = {}  # groups -> their packed int64 form


def _launch(mode: int, kernel: str, lowered: LoweredProgram, groups, stripes: int,
            L: int, device: torch.device, flags: torch.Tensor | None = None) -> None:
    rows = sum(g[3] for g in groups)
    if rows > MAX_ROWS:
        raise ValueError(f"{kernel}: {rows} rows; the kernel takes at most {MAX_ROWS}")
    packer = _DESCRIPTORS.get(len(groups))
    if packer is None:
        packer = _DESCRIPTORS.setdefault(len(groups), struct.Struct(f"{4 * len(groups)}q"))
    desc = packer.pack(*itertools.chain.from_iterable(groups))
    operand = lowered.operand(device)
    if _LAUNCH is None:
        build_library()
    args = (mode, desc, len(groups), operand.data_ptr(), len(lowered.ops), lowered.nslots,
            lowered.threads, lowered.k, lowered.m, stripes, L, _XTIME_RED,
            None if flags is None else flags.data_ptr(), _RAW_STREAM(device.index), None)
    if device.index == torch.cuda.current_device():
        err = _LAUNCH(*args)
    else:
        with torch.cuda.device(device):
            err = _LAUNCH(*args)
    if err != 0:
        raise DeviceError(f"{kernel}: kernel launch failed (cudaError {err})")
    with _LAUNCH_LOCK:
        launches[kernel] += 1


def packed_code(sched, data: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """Wrapper of the packed_code kernel: (..., k, L) uint8 -> (..., m, L).

    `sched` is a plane program, a legacy row schedule or a LoweredProgram.
    `out` is written and returned when its shape, dtype and device are the
    result's and it is contiguous; otherwise it is ignored.  A CPU tensor
    takes `packed_code_reference`; a CUDA tensor launches
    csrc/packed_gf.cu on the current stream or raises."""
    dev = _check("packed_code", data)
    *lead, k, L = data.shape
    if not isinstance(sched, LoweredProgram) and not is_program(sched):
        sched = program_from_rows(sched, k)  # a legacy row schedule: its tower program
    prog = _program(sched)
    if k != prog[1]:
        raise ValueError(f"packed_code: k={k} but the program has k={prog[1]}")
    want = (*lead, prog[2], L)
    if not (out is not None and tuple(out.shape) == want and out.dtype == torch.uint8
            and out.device == dev and out.is_contiguous()):
        out = None
    if dev.type == "cpu":
        got = packed_code_reference(prog, data)
        return got if out is None else out.copy_(got)
    lowered = lower_program(sched)
    if out is None:
        out = torch.empty(want, dtype=torch.uint8, device=dev)
    src = _stripes(data, k)
    if src.shape[0] == 0 or L == 0:
        return out
    _launch(MODE_CODE, "packed_code", lowered, (group(src), group(out.view(-1, lowered.m, L))),
            src.shape[0], L, dev)
    return out


def packed_verify(sched, codeword: torch.Tensor) -> torch.Tensor:
    """Wrapper of the packed_verify kernel: (..., k+m, L) codewords ->
    (...,) uint8, bit j set iff the recomputed parity row j differs from the
    stored row j.  The kernel reads the data and stored rows of the one
    codeword tensor by their strides.  A CPU tensor takes
    `packed_verify_reference`; a CUDA tensor launches the kernel or raises."""
    dev = _check("packed_verify", codeword)
    *lead, rows, L = codeword.shape
    prog = _program(sched)
    if rows != prog[1] + prog[2]:
        raise ValueError(f"packed_verify: {rows} rows, want k+m={prog[1] + prog[2]}")
    if prog[2] > 8:
        raise ValueError(f"packed_verify: mismatch bitmap is uint8; m={prog[2]} > 8")
    if dev.type == "cpu":
        return packed_verify_reference(prog, codeword)
    lowered = lower_program(sched)
    src = _stripes(codeword, rows)
    S = src.shape[0]
    flags = torch.empty(S, dtype=torch.uint8, device=dev)  # the kernel writes every byte
    if S and L:
        _launch(MODE_VERIFY, "packed_verify", lowered, (group(src),), S, L, dev, flags)
    elif S:
        flags.zero_()  # L == 0: nothing differs
    return flags.reshape(lead)


def packed_delta(sched, old: torch.Tensor, new: torch.Tensor,
                 parity: torch.Tensor) -> torch.Tensor:
    """Wrapper of the packed_delta kernel: (..., k, L) old and new data and
    (..., m, L) old parity -> (..., m, L) new parity, parity ^ P(old ^ new),
    in one launch.  A CPU tensor takes `packed_delta_reference`; a CUDA
    tensor launches the kernel or raises."""
    dev = _check("packed_delta", old, new, parity)
    *lead, k, L = old.shape
    prog = _program(sched)
    if (tuple(new.shape) != tuple(old.shape) or k != prog[1]
            or tuple(parity.shape) != (*lead, prog[2], L)):
        raise ValueError(f"packed_delta: shapes {tuple(old.shape)}, {tuple(new.shape)}, "
                         f"{tuple(parity.shape)} for k={prog[1]}, m={prog[2]}")
    if dev.type == "cpu":
        return packed_delta_reference(prog, old, new, parity)
    lowered = lower_program(sched)
    out = torch.empty((*lead, lowered.m, L), dtype=torch.uint8, device=dev)
    groups = [_stripes(old, k), _stripes(new, k), _stripes(parity, lowered.m)]
    if groups[0].shape[0] and L:
        _launch(MODE_DELTA, "packed_delta", lowered,
                [group(g) for g in (*groups, out.view(-1, lowered.m, L))], groups[0].shape[0],
                L, dev)
    return out


def packed_delta_flat(sched, old_bufs, new_bufs, parity_bufs, chunk: int) -> torch.Tensor:
    """`packed_delta` over k + k + m flat per-shard buffers (each a shard's
    (stripes * chunk,) bytes, allocated apart): (stripes, m, chunk) new
    parity in one launch of the packed_delta kernel, each buffer read in
    place through its own row pointer (stripe stride `chunk`)."""
    bufs = [*old_bufs, *new_bufs, *parity_bufs]
    dev = _check("packed_delta_flat", *bufs)
    k = len(old_bufs)
    _tag, pk, m, _ops, _outs = _program(sched)
    chunk = int(chunk)
    if len(new_bufs) != k or k != pk or len(parity_bufs) != m:
        raise ValueError(f"packed_delta_flat: {k}, {len(new_bufs)}, {len(parity_bufs)} "
                         f"buffers for k={pk}, m={m}")
    n = bufs[0].numel()
    if chunk <= 0 or n % chunk or any(b.numel() != n for b in bufs):
        raise ValueError(f"packed_delta_flat: buffers of {[b.numel() for b in bufs]} "
                         f"bytes, chunk {chunk}")
    bufs = [b if b.is_contiguous() else b.contiguous() for b in bufs]
    if dev.type == "cpu":
        od, nd, op_ = (torch.cat([b.view(-1, 1, chunk) for b in bufs[a:b]], dim=1)
                       for a, b in ((0, k), (k, 2 * k), (2 * k, 2 * k + m)))
        return packed_delta_reference(_program(sched), od, nd, op_)
    out = torch.empty((n // chunk, m, chunk), dtype=torch.uint8, device=dev)
    if n:  # a buffer is one row, its stripes `chunk` bytes apart
        _launch(MODE_DELTA, "packed_delta", lower_program(sched),
                [*((b.data_ptr(), chunk, chunk, 1) for b in bufs), group(out)], n // chunk,
                chunk, dev)
    return out


# -- plans ---------------------------------------------------------------------------


class _Plan:
    """One matrix: `sched`, `best_program` for the plain version, and for
    the kernels `lowered`, `kernel_program`; each built at its first use, so
    a CUDA plan never builds `best_program` (a wide Cauchy code's CSE takes
    minutes) and a matrix no construction of which fits the kernels raises
    only when a CUDA tensor needs it."""

    __slots__ = ("k", "m", "_gfm", "_sched", "_lowered")

    def __init__(self, gf_matrix: np.ndarray):
        self._gfm = np.asarray(gf_matrix, dtype=np.uint8)
        self.m, self.k = self._gfm.shape
        self._sched = None
        self._lowered = None

    @property
    def sched(self) -> tuple:
        if self._sched is None:
            self._sched = best_program(self._gfm)
        return self._sched

    @property
    def lowered(self) -> LoweredProgram:
        if self._lowered is None:
            self._lowered = kernel_program(self._gfm)
        return self._lowered

    def operand_for(self, t: torch.Tensor):
        """What the wrappers take for tensor `t`: the program for the plain
        version on the CPU, its lowered form for a kernel."""
        return self.sched if t.device.type == "cpu" else self.lowered


class PackedPlan(_Plan):
    """One packed-plane plan per matrix: the packed tier of `_DeviceCoder`,
    any chunk length, counted on the launch counters (and DECODE_LAUNCHES
    for a decode-kind plan)."""

    __slots__ = ("decode",)

    def __init__(self, gf_matrix: np.ndarray, decode: bool = False):
        super().__init__(gf_matrix)
        self.decode = decode

    def __call__(self, data: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        """(..., k, L) uint8 -> (..., m, L) uint8; `out` as in `packed_code`."""
        record_launch(lead_stripes(data.shape), data.numel(), decode=self.decode)
        return packed_code(self.operand_for(data), data, out=out)


class PackedVerifyPlan(_Plan):
    """Compare-only plan for one parity matrix (the deep-scrub kernel):
    recomputes parity of (..., k+m, L) codewords with the encode's program
    and returns the per-stripe mismatch bitmap; counted on VERIFY_LAUNCHES
    (and LAUNCHES)."""

    __slots__ = ()

    def __init__(self, gf_matrix: np.ndarray):
        super().__init__(gf_matrix)
        if self.m > 8:
            raise ValueError(f"mismatch bitmap is uint8; m={self.m} > 8")

    def __call__(self, codeword: torch.Tensor) -> torch.Tensor:
        """(..., k+m, L) uint8 -> (...,) uint8 mismatch bitmap."""
        record_launch(lead_stripes(codeword.shape), codeword.numel(), verify=True)
        return packed_verify(self.operand_for(codeword), codeword)
