"""Kernel experiment round 2, ported: the SWAR XOR schedule baked into the
kernel, on words of 4 consecutive bytes.

`make_swar(gfm, wt)` is the port of benchmarks/diag/kern_exp2.py::make_swar:
(S, k, L) uint8 -> (S, m, L) uint8 GF(2^8) coding, with the schedule of
`gfm` baked into a CUDA library (csrc/swar_baked.cu behind the program
that swar_program.py generates), built once per matrix.  `wt` means what it
means on the TPU: one block covers 8 segments of wt 32-bit words of each
chunk.  The plain version is `swar_code_reference` of ops/swar_gf.py,
which computes on the same words; the wrapper takes it only for a CPU
tensor.  `make_bitcast_only` is the script's uint8 <-> int32 round trip:
`view` is free here, so only its 3-chunk slice copy is left.

    python -m ceph_tpu_torch.diag.kern_exp2 [filter ...]   # on the card only
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
from .swar_program import CSRC, build_baked

K, M = 8, 3
CHUNK = 128 * 1024
BATCH = 64
ITERS = 30
WTS = (128, 256, 512, 1024)
# The script probes L = 16384, where wt = 1024 gets no block at all
# ((L/32) // wt == 0); 32768 is the shortest probe every wt divides.
PROBE_L = 32768
SOURCE = CSRC / "swar_baked.cu"

launches = 0  # kernel launches made by Swar (plain-version calls excluded)


class Swar:
    """Wrapper of the baked SWAR kernel for one (m, k) matrix and block
    width `wt` (32-bit words of each of the block's 8 segments)."""

    def __init__(self, gf_matrix: np.ndarray, wt: int):
        if wt < 4 or wt % 4:
            raise ValueError(f"make_swar: wt={wt} is not a positive multiple of 4")
        self.gf_matrix = np.asarray(gf_matrix, dtype=np.uint8)
        self.m, self.k = self.gf_matrix.shape
        self.wt = wt
        self.sched = schedule_from_matrix(self.gf_matrix)
        self._built: _nvcc.Built | None = None

    def build(self) -> _nvcc.Built:
        if self._built is None:
            self._built = build_baked("swar_baked", SOURCE, self.gf_matrix, {
                "swar_baked_launch": [
                    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                    ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p,
                ],
            })
        return self._built

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        global launches
        check_uint8_3d("swar_baked", data)
        S, k, L = data.shape
        if k != self.k:
            raise ValueError(f"swar_baked: k={k} but the matrix has k={self.k}")
        if L % 32 or (L // 32) % self.wt:
            raise ValueError(f"swar_baked: L={L} is not a multiple of 32 * wt={32 * self.wt}")
        if data.device.type == "cpu":
            return swar_code_reference(self.sched, data)
        out = torch.empty((S, self.m, L), dtype=torch.uint8, device=data.device)
        launch("swar_baked", self.build().lib.swar_baked_launch, data, out, S, L, self.wt)
        launches += 1
        return out


def make_swar(gf_matrix: np.ndarray, wt: int) -> Swar:
    return Swar(gf_matrix, wt)


def make_bitcast_only():
    """The script's bitcast round trip: the int32 view costs nothing here,
    so what is left is the copy of the first 3 chunks."""

    def run(data: torch.Tensor) -> torch.Tensor:
        return data.view(torch.int32).view(torch.uint8)[:, :3].clone()

    return run


def main(argv: list[str] | None = None) -> Calls:
    want = argv or None
    dev = require_cuda()
    print(f"backend: cuda ({torch.cuda.get_device_name(dev)})", flush=True)
    gfm = isa_rs_vandermonde_matrix(K, M)[K:]
    data = random_data((BATCH, K, CHUNK), 0, dev)
    in_bytes = BATCH * K * CHUNK
    probe = data[:8, :, :PROBE_L].contiguous()

    calls = Calls()
    variants = {"cur_plan": calls.counted("swar_gf", CodingPlan(gfm, device=dev))}
    for wt in WTS:
        variants[f"swar_wt{wt}"] = calls.counted("swar_baked", make_swar(gfm, wt))
    for name, fn in variants.items():
        if want and not any(w in name for w in want):
            continue
        check_oracle(name, fn, probe, gfm)
        measure(name, lambda: fn(data), in_bytes, ITERS)
    if not want or any("bitcast" in w for w in want):
        bitcast = make_bitcast_only()
        measure("bitcast_roundtrip_only", lambda: bitcast(data), in_bytes, ITERS)
    return calls


if __name__ == "__main__":
    main(sys.argv[1:])
