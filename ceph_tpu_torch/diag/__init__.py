"""Ports of the TPU kernel experiments of `benchmarks/diag/` (kern_exp2-5).

Each module keeps its script's experiment: kernel variants for RS(8,3)
encode, each checked against the GF(2^8) table product on a probe slice,
then timed.  The Pallas kernels are hand CUDA kernels here, each beside its
plain PyTorch version and a `launches` count:

- kern_exp4: `make_copy`, the copy floor (csrc/copy_floor.cu);
- kern_exp2: `make_swar`, the schedule baked per matrix, words of 4
  consecutive bytes (csrc/swar_baked.cu);
- kern_exp3: `make_swar3`, the same on words of 4 bytes strided by the tile
  width, tiles staged in shared memory (csrc/swar3_baked.cu);
- kern_exp5: the serial-chain timing of copy, `swar_gf` and `make_swar3`.

A `main()` runs on the card only (it raises without CUDA), times with CUDA
events, and returns how many calls it made to each kernel's wrapper:

    python -m ceph_tpu_torch.diag.kern_exp2 [filter ...]
"""

from __future__ import annotations

import collections

import numpy as np
import torch

from ..gf import gf_matmul


def require_cuda() -> torch.device:
    """The card, or RuntimeError: the experiments have no CPU branch."""
    if not torch.cuda.is_available():
        raise RuntimeError("the kernel experiments run only on a CUDA device")
    return torch.device("cuda")


def check_uint8_3d(name: str, data: torch.Tensor) -> None:
    if data.dtype != torch.uint8:
        raise TypeError(f"{name}: dtype {data.dtype}, want torch.uint8")
    if data.dim() != 3:
        raise ValueError(f"{name}: shape {tuple(data.shape)}, want (S, k, L)")


def launch(name: str, fn, data: torch.Tensor, out: torch.Tensor, *args) -> None:
    """Call the C launcher `fn(data, out, *args, stream)` on the current
    stream of data's device; raise if the data is not contiguous and 16-byte
    aligned or the launch is refused."""
    if data.device.type != "cuda":
        raise ValueError(f"{name}: data on {data.device}, want a CUDA device")
    if not data.is_contiguous() or data.data_ptr() % 16:
        raise ValueError(f"{name}: data must be contiguous and 16-byte aligned")
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(data.data_ptr(), out.data_ptr(), *args, stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed (cudaError {err})")


def random_data(shape, seed: int, device: torch.device) -> torch.Tensor:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=device, generator=gen)


def check_oracle(label: str, fn, probe: torch.Tensor, gf_matrix) -> None:
    """fn(probe) must equal the GF(2^8) table product, stripe by stripe."""
    got = fn(probe).cpu().numpy()
    host = probe.cpu().numpy()
    for s in range(host.shape[0]):
        if not np.array_equal(got[s], gf_matmul(gf_matrix, host[s])):
            raise RuntimeError(f"{label}: parity mismatch in probe stripe {s}")


class Calls(collections.Counter):
    """Calls a main() made into each kernel's wrapper, by kernel name."""

    def counted(self, kernel: str | None, fn):
        if kernel is None:
            return fn

        def run(data):
            self[kernel] += 1
            return fn(data)

        return run


def measure(label: str, fn, in_bytes: int, iters: int, reps: int = 1) -> float:
    """Time fn() on the card: one warm-up call, then `reps` runs of `iters`
    calls, each between two CUDA events.  Print GB/s of input for each run,
    as the TPU scripts do, and return the best."""
    fn()
    rates = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        rates.append(in_bytes * iters / start.elapsed_time(end) / 1e6)
    best = max(rates)
    print(f"{label:28s} " + " ".join(f"{r:8.2f}" for r in rates)
          + f" GB/s (best {best:.2f}, {in_bytes / best / 1e6:.4f} ms/iter)", flush=True)
    return best
