"""Kernel experiment round 4, ported: the copy floor, and launch cost
against batch size.

`make_copy(tile)` is the port of benchmarks/diag/kern_exp4.py::make_copy:
(S, k, L) uint8 -> data[:, :3], reading every byte of all k chunks as the
TPU block does, so it moves (k + 3)·S·L bytes, exactly what RS(k, 3)
encode moves.  Its time is the floor a coding kernel of that shape can
reach.  The hand kernel is csrc/copy_floor.cu; `copy_reference` is its
plain version, which the wrapper takes only for a CPU tensor.

`main()` times copy, `swar_gf` (the port's CodingPlan, the script's `cur`)
and `make_swar3(gfm, 128, 256)` at batches 16, 64 and 256 of 8 x 128 KiB:

    python -m ceph_tpu_torch.diag.kern_exp4     # on the card only
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..gf import isa_rs_vandermonde_matrix
from ..ops import _nvcc
from ..ops.swar_gf import CodingPlan
from . import Calls, check_oracle, check_uint8_3d, launch, measure, random_data, require_cuda
from .kern_exp3 import make_swar3
from .swar_program import CSRC

K, M = 8, 3
CHUNK = 128 * 1024
ITERS = 30
MAX_K = 16  # csrc/copy_floor.cu instantiates k = 3..16
SOURCE = CSRC / "copy_floor.cu"

launches = 0  # kernel launches made by Copy (plain-version calls excluded)


def copy_reference(data: torch.Tensor) -> torch.Tensor:
    """Plain version: the first 3 chunks of every stripe."""
    return data[:, :3].clone()


@functools.cache
def build() -> _nvcc.Built:
    """Build and load csrc/copy_floor.cu, once per process (the wrapper
    calls this on every launch, and `_nvcc.build` hashes the source text)."""
    return _nvcc.build("copy_floor", SOURCE, {"copy_floor_launch": [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_int, ctypes.c_uint, ctypes.c_void_p,
    ]})


class Copy:
    """Wrapper of the copy-floor kernel for one tile size (bytes of each
    chunk one block covers)."""

    def __init__(self, tile: int):
        if tile < 16 or tile % 16:
            raise ValueError(f"make_copy: tile={tile} is not a positive multiple of 16")
        self.tile = tile

    def __call__(self, data: torch.Tensor) -> torch.Tensor:
        global launches
        check_uint8_3d("copy_floor", data)
        S, k, L = data.shape
        if not 3 <= k <= MAX_K:
            raise ValueError(f"copy_floor: k={k}, want 3 <= k <= {MAX_K}")
        if L % self.tile:
            raise ValueError(f"copy_floor: L={L} is not a multiple of tile={self.tile}")
        if data.device.type == "cpu":
            return copy_reference(data)
        out = torch.empty((S, 3, L), dtype=torch.uint8, device=data.device)
        launch("copy_floor", build().lib.copy_floor_launch, data, out,
               S, k, L, self.tile, 0)
        launches += 1
        return out


def make_copy(tile: int) -> Copy:
    return Copy(tile)


def main() -> Calls:
    dev = require_cuda()
    print(f"backend: cuda ({torch.cuda.get_device_name(dev)})", flush=True)
    gfm = isa_rs_vandermonde_matrix(K, M)[K:]
    calls = Calls()
    variants = {
        "copy": calls.counted("copy_floor", make_copy(4096)),
        "cur": calls.counted("swar_gf", CodingPlan(gfm, device=dev)),
        "swar3_r128_c256": calls.counted("swar3_baked", make_swar3(gfm, 128, 256)),
    }
    probe = random_data((4, K, 32768), 1, dev)
    if not torch.equal(variants["copy"](probe), probe[:, :3]):
        raise RuntimeError("copy: output != data[:, :3] on the probe")
    for name in ("cur", "swar3_r128_c256"):
        check_oracle(name, variants[name], probe, gfm)
    for batch in (16, 64, 256):
        data = random_data((batch, K, CHUNK), batch, dev)
        in_bytes = batch * K * CHUNK
        print(f"--- batch={batch} ({in_bytes // 2**20} MiB/launch)", flush=True)
        for name, fn in variants.items():
            measure(f"{name} b{batch}", lambda: fn(data), in_bytes, ITERS, reps=3)
        del data
    return calls


if __name__ == "__main__":
    main()
