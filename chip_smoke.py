#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ceph_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. Environment: the card's name and power limit; build the hand kernel
   (ceph_tpu_torch/csrc/swar_gf.cu) with nvcc and print the build time.
2. Kernel vs plain on the card: the kernel against its plain PyTorch
   version (`swar_code_reference`) and against the numpy oracle
   (`xor_matmul_host_batch` on the first stripe, the GF(2^8) table product
   `gf_matmul` on the last), byte for byte, over RS(8,3) encode matrices of
   both techniques, RS(8,3) decode matrices, RS(4,2) and RS(5,2), at chunk
   lengths {128, 256, 512, 131072} and {1, 2, 256} stripes, and at the main
   path's own shape (1, k, 524288).
3. The main path at a real size: plugin `tpu` RS(8,3) built through the
   registry with no device argument (so on the card), 32 objects of 4 MiB
   (RBD's default object size) encoded and decoded for every erasure class
   (1 data, 1 parity, 2 mixed, 3 mixed), both techniques, parity held
   against the GF(2^8) table product `gf_matmul` and every erasure rebuilt
   to the encoded bytes.  Kernel launch counts are reset just before and read
   just after, and must equal the kernel-tier calls made.
4. Bulk timing: `encode_array` on (256, 8, 131072) uint8 on the card, CUDA
   events, median of 20 runs, beside the bound (the larger of the bytes
   moved at the HBM rate and the ops of the packed ring program at the
   INT32 rate), the plain version and a device copy of the same input as
   the memory yardstick; then
   `decode_array` at the same shape for one pattern of each erasure class.

The last line of standard output is one JSON object,
{"ok": true, "device": {...}}; the line before it lists each kernel.
There is no CPU branch: without CUDA the script exits non-zero.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

SEED = 20261016
# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data
# sheet): HBM3 bandwidth, and INT32 issue rate = 64 lanes/SM x 132 SMs x
# 1.98 GHz (half the fp32 lanes behind the 67 TFLOP/s float32 figure).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# 32-bit ops of one SWAR multiply-by-x of 4 packed GF(2^8) bytes,
# ((w << 1) & 0xfefefefe) ^ (((w >> 7) & 0x01010101) * 0x1d):
# shl, shr, and, imul, and one LOP3 for the closing and-xor.
XTIME_OPS = 5


# Phase 2's (chunk length, stripes): the TPU on-chip test geometries, and
# the main path's own shape (one 4 MiB RS(8,3) object: 512 KiB chunks).
SHAPES = [(L, S) for L in (128, 256, 512, 131072) for S in (1, 2, 256)] + [(524288, 1)]


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def ring_word_ops(mat) -> int:
    """Integer ops per 32-bit word position of the k chunks that the coding
    function needs, counted on Horner's ring program over the packed bytes
    as stored (the construction ops/packed_gf.py picks for RS(8,3), 47
    program ops): per output row, XOR the chunks of each coefficient bit and
    chain multiply-by-x from the top bit down.  The ALU side of bound_ms."""
    ops = 0
    for row in np.asarray(mat, dtype=np.uint8):
        levels = [sum((int(c) >> b) & 1 for c in row) for b in range(8)]
        nonzero = [b for b in range(8) if levels[b]]
        if not nonzero:
            continue
        top = nonzero[-1]
        ops += levels[top] - 1 + XTIME_OPS * top
        # a lower level: its XOR chain (n - 1) and one XOR into the sum
        ops += sum(levels[b] for b in range(top))
    return ops


def kernel_word_ops(plan, swar) -> int:
    """Integer ops per 32-bit word position of the k chunks that
    csrc/swar_gf.cu itself does (a diagnostic, not the bound): one LOP3 (acc ^= w & mask) per schedule row and
    chunk, over the rows padded to whole passes, then per output bit-row a
    bytewise parity fold (3 shifts + 3 XORs) and its placement (shift+OR)."""
    rows = swar.schedule_masks_rows(plan.m)
    return rows * plan.k + 8 * 8 * plan.m


def time_ms(torch, fn, warmup: int = 3, reps: int = 20) -> float:
    """Median of `reps` CUDA-event timings of fn(), after `warmup` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_env(torch, swar):
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {name}  count={torch.cuda.device_count()}")
    print(f"[1] nvidia-smi: {card}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}")
    t0 = time.perf_counter()
    swar.build_library()
    print(f"[1] built {swar.build_info['library']} in "
          f"{time.perf_counter() - t0:.2f} s")
    for line in swar.build_info.get("ptxas", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"[1] ptxas: {line.replace('ptxas info    :', '').strip()}")
    return name, card


def phase_kernel_checks(torch, swar, gf) -> int:
    """Kernel vs plain and vs oracle; returns the max abs byte error."""
    dev = torch.device("cuda")
    mats = []
    for tech, build in (("van", gf.isa_rs_vandermonde_matrix),
                        ("cauchy", gf.isa_cauchy_matrix)):
        full = build(8, 3)
        mats.append((f"rs83-{tech}-encode", full[8:]))
        for erasures in ([0, 1], [0, 9], [9, 10], [0, 5, 10]):
            c, _ = gf.isa_decode_matrix(full, erasures, 8)
            mats.append((f"rs83-{tech}-decode{erasures}", c))
        mats.append((f"rs42-{tech}-encode", build(4, 2)[4:]))
        mats.append((f"rs52-{tech}-encode", build(5, 2)[5:]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    max_err = 0
    cases = 0
    for label, mat in mats:
        plan = swar.CodingPlan(mat, device=dev)
        bm = gf.expand_matrix(mat)
        for L, S in SHAPES:
            data = torch.randint(0, 256, (S, plan.k, L), dtype=torch.uint8,
                                 device=dev, generator=gen)
            got = swar.swar_gf(plan, data)
            ref = swar.swar_code_reference(plan.sched, data)
            torch.cuda.synchronize()
            err = int((got.to(torch.int16) - ref.to(torch.int16)).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"{label} L={L} S={S}: kernel != plain (max err {err})")
            # the bitslice oracle costs seconds per MiB on the host: it
            # takes the first stripe up to 128 KiB, the table product
            # the last stripe at every length
            if L <= 131072:
                oracle = gf.xor_matmul_host_batch(bm, data[:1].cpu().numpy())
                check(np.array_equal(got[:1].cpu().numpy(), oracle),
                      f"{label} L={L} S={S}: kernel != bitslice oracle")
            table = gf.gf_matmul(mat, data[S - 1].cpu().numpy())
            check(np.array_equal(got[S - 1].cpu().numpy(), table),
                  f"{label} L={L} S={S}: kernel != table oracle")
            cases += 1
            del data, got, ref
    print(f"[2] kernel == plain == oracle on {cases} cases "
          f"({len(mats)} matrices), max_abs_err={max_err}")
    return max_err


def phase_main_path(torch, swar, registry, gf):
    """RS(8,3) encode + decode of 32 x 4 MiB objects through plugin `tpu`."""
    rng = np.random.default_rng(SEED)
    n_obj, obj_size = 32, 4 << 20
    objects = [rng.integers(0, 256, obj_size, dtype=np.uint8).tobytes()
               for _ in range(n_obj)]
    swar.launches = 0
    expected = 0
    t0 = time.perf_counter()
    for tech in ("reed_sol_van", "cauchy"):
        ec = registry.instance().factory("tpu", {"k": "8", "m": "3", "technique": tech})
        check(ec.device.type == "cuda", f"codec on {ec.device}, want cuda")
        km = ec.get_chunk_count()
        for n, obj in enumerate(objects):
            enc = ec.encode(set(range(km)), obj)
            expected += 1
            chunk = len(enc[0])
            check(chunk == 512 << 10, f"chunk size {chunk}")
            data = np.stack([enc[i] for i in range(8)])
            want = gf.gf_matmul(ec.distribution_matrix()[8:], data)
            for i in range(3):
                check(np.array_equal(enc[8 + i], want[i]),
                      f"{tech} object {n}: parity {i} != oracle")
            d = n % 8
            patterns = ([d], [8 + n % 3], [d, 8 + (n + 1) % 3],
                        [d, (d + 3) % 8, 8 + (n + 2) % 3])
            for erasures in patterns:
                avail = {i: enc[i] for i in range(km) if i not in erasures}
                dec = ec.decode(set(erasures), avail)
                for e in erasures:
                    check(np.array_equal(dec[e], enc[e]),
                          f"{tech} object {n}: decode {erasures} chunk {e}")
                if not ec._use_xor_decode(sorted(erasures)):
                    expected += 1
            avail = {i: enc[i] for i in range(km) if i not in patterns[3]}
            whole = ec.decode_concat(avail)
            expected += 1
            check(whole[: len(obj)].tobytes() == obj,
                  f"{tech} object {n}: decode_concat != object")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = swar.launches
    print(f"[3] main path: 2 techniques x {n_obj} objects x 4 MiB, "
          f"encode + 4 erasure classes + decode_concat, exact; {seconds:.2f} s host clock")
    print(f"[3] swar_gf launches {launches}, kernel-tier calls {expected}")
    check(launches == expected, f"launches {launches} != kernel-tier calls {expected}")
    return launches


def phase_bulk(torch, swar, registry, gf, card):
    dev = torch.device("cuda")
    ec = registry.instance().factory("tpu", {"k": "8", "m": "3"})
    S, k, L = 256, 8, 131072
    m = ec.m
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    data = torch.randint(0, 256, (S, k, L), dtype=torch.uint8, device=dev, generator=gen)
    mat = ec.distribution_matrix()[k:]
    plan = swar.CodingPlan(mat, device=dev)
    out = ec.encode_array(data)
    ref = swar.swar_code_reference(plan.sched, data)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), "bulk encode != plain version")
    del out, ref
    entry_ms = time_ms(torch, lambda: ec.encode_array(data))
    kernel_ms = time_ms(torch, lambda: swar.swar_gf(plan, data))
    plain_ms = time_ms(torch, lambda: swar.swar_code_reference(plan.sched, data),
                       warmup=2, reps=10)
    dst = torch.empty_like(data)
    copy_ms = time_ms(torch, lambda: dst.copy_(data))
    in_bytes = S * k * L
    moved = (k + m) * S * L
    words = S * (L // 4)
    mem_ms = moved / HBM_BYTES_PER_S * 1e3
    need_ops = ring_word_ops(mat) * words
    alu_ms = need_ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(mem_ms, alu_ms)
    bound_by = "bytes" if mem_ms >= alu_ms else "operations"
    own_ops = kernel_word_ops(plan, swar) * words
    print(f"[4] card: {card}")
    print(f"[4] encode_array (256, 8, 131072) uint8: {entry_ms:.4f} ms, "
          f"{in_bytes / entry_ms / 1e6:.2f} GB/s input")
    print(f"[4] swar_gf kernel: {kernel_ms:.4f} ms, "
          f"{in_bytes / kernel_ms / 1e6:.2f} GB/s input")
    print(f"[4] memory bound: {moved} B / 3.35 TB/s = {mem_ms:.4f} ms")
    print(f"[4] int ALU bound (ring program, xtime = {XTIME_OPS} ops): "
          f"{ring_word_ops(mat)} ops/word x {words} words = {need_ops} ops "
          f"/ {INT32_OPS_PER_S:.4g} ops/s = {alu_ms:.4f} ms")
    print(f"[4] bound {bound_ms:.4f} ms by {bound_by}; kernel at "
          f"{bound_ms / kernel_ms:.3f} of it")
    print(f"[4] (diagnostic) the kernel's own ops: {kernel_word_ops(plan, swar)} ops/word "
          f"= {own_ops / INT32_OPS_PER_S * 1e3:.4f} ms at the INT32 peak")
    print(f"[4] plain swar_code_reference: {plain_ms:.4f} ms")
    print(f"[4] copy yardstick (read {in_bytes} B + write {in_bytes} B): "
          f"{copy_ms:.4f} ms, {2 * in_bytes / copy_ms / 1e6:.2f} GB/s moved")
    print("[4] library_ms: none (no single PyTorch call computes GF(2^8) coding)")
    full = ec.distribution_matrix()
    for erasures in ([0], [9], [0, 9], [0, 5, 10]):
        c, _ = gf.isa_decode_matrix(full, erasures, k)
        dec_ms = time_ms(torch, lambda: ec.decode_array(erasures, data))
        dec_bytes = (k + len(erasures)) * S * L
        dec_ops = ring_word_ops(c) * words
        dec_bound = max(dec_bytes / HBM_BYTES_PER_S, dec_ops / INT32_OPS_PER_S) * 1e3
        print(f"[4] decode_array {erasures}: {dec_ms:.4f} ms, "
              f"{in_bytes / dec_ms / 1e6:.2f} GB/s input, bound {dec_bound:.4f} ms")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on the card",
              file=sys.stderr)
        return 2
    try:
        from ceph_tpu_torch import gf
        from ceph_tpu_torch.codec import registry
        from ceph_tpu_torch.ops import swar_gf as swar
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2

    name, card = phase_env(torch, swar)
    max_err = phase_kernel_checks(torch, swar, gf)
    launches = phase_main_path(torch, swar, registry, gf)
    bulk = phase_bulk(torch, swar, registry, gf, card)
    kernels = [{
        "name": "swar_gf",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/swar_gf.cu",
        "replaces": "ceph_tpu/ops/pallas_gf.py:103",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": bulk["ms"],
        "plain_ms": bulk["plain_ms"],
        "bound_ms": bulk["bound_ms"],
        "bound_by": bulk["bound_by"],
        "library_ms": None,
        "source_sha256": swar.build_info["source_sha256"],
    }]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
