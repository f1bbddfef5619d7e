"""Straight-line SWAR programs baked from one GF(2^8) coding matrix.

The TPU kernel experiments `make_swar` (benchmarks/diag/kern_exp2.py) and
`make_swar3` (kern_exp3.py) bake the XOR schedule of their matrix into the
kernel at trace time: one compile per matrix.  The port does the same with
nvcc, one library per matrix:

- `program_from_schedule` turns `schedule_from_matrix(gf_matrix)` into a
  list of ops over 32-bit words, written the way the TPU kernels compute:
  cut each needed plane `(x_j >> b) & 0x01010101`, then per output bit-row
  an XOR chain of its planes, then shift-and-OR placement into the output
  word.
- `run_program` runs that list in numpy; the tests hold it against the
  GF(2^8) table product.
- `build_baked` emits the list as the `swar_program` device function,
  prepends it to a kernel template of `csrc/` and builds the result with
  `ops._nvcc.build`, cached by the hash of the generated text.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..ops import _nvcc
from ..ops.swar_gf import schedule_from_matrix

FIELD_MASK = 0x01010101
CSRC = Path(__file__).resolve().parents[1] / "csrc"

# __byte_perm selectors of the 4x4 byte transpose in csrc/swar3_baked.cu,
# which kern_exp3 emits into its prelude: LO/HI interleave bytes 0-1 / 2-3
# of two rows, EVEN/ODD then take halves 0-1 / 2-3 of two interleaved words.
BYTE_PERM = {"kPermLo": 0x5140, "kPermHi": 0x7362, "kPermEven": 0x5410, "kPermOdd": 0x7632}


def program_from_schedule(sched) -> list[tuple]:
    """The straight-line program of one schedule, as a list of ops.

    Values are numbered in order of definition (SSA).  Ops:
      ("cut", d, j, b)  v[d] = (x[j] >> b) & 0x01010101
      ("xor", d, a, c)  v[d] = v[a] ^ v[c]
      ("shl", d, a, r)  v[d] = v[a] << r
      ("or",  d, a, c)  v[d] = v[a] | v[c]
      ("zero", d)       v[d] = 0          (an output byte with no terms)
      ("out", i, a)     y[i] = v[a]
    """
    ops: list[tuple] = []
    plane: dict[tuple[int, int], int] = {}
    count = 0

    def new() -> int:
        nonlocal count
        count += 1
        return count - 1

    for j, b in sorted({t for row in sched for t in row}):
        plane[(j, b)] = new()
        ops.append(("cut", plane[(j, b)], j, b))
    for i in range(len(sched) // 8):
        word = None
        for r in range(8):
            row = sched[8 * i + r]
            if not row:
                continue
            acc = plane[row[0]]
            for t in row[1:]:
                d = new()
                ops.append(("xor", d, acc, plane[t]))
                acc = d
            if r:
                d = new()
                ops.append(("shl", d, acc, r))
                acc = d
            if word is None:
                word = acc
            else:
                d = new()
                ops.append(("or", d, word, acc))
                word = d
        if word is None:
            word = new()
            ops.append(("zero", word))
        ops.append(("out", i, word))
    return ops


def op_counts(ops) -> dict[str, int]:
    """32-bit ops of the program as the TPU kernel issues them: a cut is a
    shift and an AND (an AND alone for b = 0), a placement a shift and an
    OR."""
    cuts = sum(2 if op[3] else 1 for op in ops if op[0] == "cut")
    xors = sum(op[0] == "xor" for op in ops)
    place = sum(op[0] in ("shl", "or") for op in ops)
    return {"cuts": cuts, "xors": xors, "placements": place, "total": cuts + xors + place}


def run_program(ops, x: np.ndarray) -> np.ndarray:
    """numpy interpreter: x (..., k, W) uint32 words -> (..., m, W) uint32."""
    x = np.asarray(x, dtype=np.uint32)
    m = sum(op[0] == "out" for op in ops)
    v: dict[int, np.ndarray] = {}
    y = np.zeros((*x.shape[:-2], m, x.shape[-1]), dtype=np.uint32)
    for op in ops:
        kind = op[0]
        if kind == "cut":
            v[op[1]] = (x[..., op[2], :] >> np.uint32(op[3])) & np.uint32(FIELD_MASK)
        elif kind == "xor":
            v[op[1]] = v[op[2]] ^ v[op[3]]
        elif kind == "shl":
            v[op[1]] = v[op[2]] << np.uint32(op[3])
        elif kind == "or":
            v[op[1]] = v[op[2]] | v[op[3]]
        elif kind == "zero":
            v[op[1]] = np.zeros(x.shape[:-2] + x.shape[-1:], dtype=np.uint32)
        else:  # out
            y[..., op[1], :] = v[op[2]]
    return y


def _cuda_function(ops) -> str:
    lines = [
        "__device__ __forceinline__ void swar_program(const uint32_t (&x)[kK], uint32_t (&y)[kM]) {"
    ]
    for op in ops:
        kind = op[0]
        if kind == "cut":
            shifted = f"(x[{op[2]}] >> {op[3]})" if op[3] else f"x[{op[2]}]"
            lines.append(f"  const uint32_t v{op[1]} = {shifted} & 0x{FIELD_MASK:08x}u;")
        elif kind == "xor":
            lines.append(f"  const uint32_t v{op[1]} = v{op[2]} ^ v{op[3]};")
        elif kind == "shl":
            lines.append(f"  const uint32_t v{op[1]} = v{op[2]} << {op[3]};")
        elif kind == "or":
            lines.append(f"  const uint32_t v{op[1]} = v{op[2]} | v{op[3]};")
        elif kind == "zero":
            lines.append(f"  const uint32_t v{op[1]} = 0u;")
        else:
            lines.append(f"  y[{op[1]}] = v{op[2]};")
    lines.append("}")
    return "\n".join(lines)


def generated_source(template: Path, gf_matrix: np.ndarray, constants: dict[str, int]) -> str:
    """The prelude (kK, kM, `constants` and the program of `gf_matrix`)
    followed by the template's text."""
    gf_matrix = np.asarray(gf_matrix, dtype=np.uint8)
    m, k = gf_matrix.shape
    ops = program_from_schedule(schedule_from_matrix(gf_matrix))
    counts = op_counts(ops)
    rel = template.relative_to(CSRC.parents[1])
    head = [
        "// Generated by ceph_tpu_torch/diag/swar_program.py: the XOR schedule of the",
        f"// ({m}, {k}) GF(2^8) matrix {gf_matrix.tolist()}",
        f"// as a straight-line program of {counts['total']} ops per 32-bit word "
        f"({counts['cuts']} plane cuts, {counts['xors']} XORs, "
        f"{counts['placements']} placements), prepended to {rel}.",
        "#include <cuda_runtime.h>",
        "#include <stdint.h>",
        f"constexpr int kK = {k};",
        f"constexpr int kM = {m};",
    ]
    head += [f"constexpr int {name} = 0x{value:x};" for name, value in constants.items()]
    return "\n".join(head + [_cuda_function(ops), f'#line 1 "{rel}"', template.read_text()])


def build_baked(name: str, template: Path, gf_matrix: np.ndarray,
                symbols: dict[str, list], constants: dict[str, int] | None = None) -> _nvcc.Built:
    """Build `template` with the program of `gf_matrix` baked in (once per
    generated text) and load it.  A failed build raises."""
    return _nvcc.build(name, generated_source(template, gf_matrix, constants or {}), symbols)
