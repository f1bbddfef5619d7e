"""Kernel experiment round 5, ported: serial-chain timing of the copy floor,
`swar_gf` and `make_swar3`.

Each step patches the first 128 bytes of the input from the previous
output and launches again, so launch n+1 depends on launch n (the TPU
script's `step`, benchmarks/diag/kern_exp5.py:33-37).  On one CUDA stream
the order is serial already and nothing needs donating; the dependence is
kept so the chain measures what the script measures.  Times come from CUDA
events around the chain.

    python -m ceph_tpu_torch.diag.kern_exp5     # on the card only
"""

from __future__ import annotations

import torch

from ..gf import isa_rs_vandermonde_matrix
from ..ops.swar_gf import CodingPlan
from . import Calls, check_oracle, measure, random_data, require_cuda
from .kern_exp3 import make_swar3
from .kern_exp4 import make_copy

K, M = 8, 3
CHUNK = 128 * 1024
ITERS = 30
# The script's make_swar3 tiles (kern_exp5.py:67-69); (512, 256) is a whole
# 128 KiB chunk, so the probe is one chunk long.
SWAR3_GEOMETRIES = ((128, 256), (32, 128), (512, 256))
PROBE_L = CHUNK


def measure_chained(label: str, fn, data: torch.Tensor, reps: int = 3) -> float:
    """GB/s of input of fn over a chain of steps, each patching data's first
    128 bytes from the previous output, then calling fn(data)."""
    p = fn(data)

    def step():
        nonlocal p
        data[0, 0, :128] = p[0, 0, :128] ^ 1
        p = fn(data)

    return measure(label, step, data.numel(), ITERS, reps)


def main() -> Calls:
    dev = require_cuda()
    print(f"backend: cuda ({torch.cuda.get_device_name(dev)})", flush=True)
    gfm = isa_rs_vandermonde_matrix(K, M)[K:]
    calls = Calls()
    variants = {
        "copy_t4096": calls.counted("copy_floor", make_copy(4096)),
        "cur_plan": calls.counted("swar_gf", CodingPlan(gfm, device=dev)),
    }
    for rows, cols in SWAR3_GEOMETRIES:
        variants[f"swar3_r{rows}_c{cols}"] = calls.counted(
            "swar3_baked", make_swar3(gfm, rows, cols))
    probe = random_data((2, K, PROBE_L), 1, dev)
    for name, fn in variants.items():
        if name == "copy_t4096":
            if not torch.equal(fn(probe), probe[:, :3]):
                raise RuntimeError("copy_t4096: output != data[:, :3] on the probe")
        else:
            check_oracle(name, fn, probe, gfm)
    for batch in (64, 256):
        print(f"--- batch={batch} ({batch * K * CHUNK // 2**20} MiB/launch)", flush=True)
        for n, (name, fn) in enumerate(variants.items()):
            data = random_data((batch, K, CHUNK), 100 * batch + n, dev)
            measure_chained(f"{name} b{batch}", fn, data)
            del data
    return calls


if __name__ == "__main__":
    main()
