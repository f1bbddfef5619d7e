#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ceph_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) if it fails:

1. Environment: the card's name and power limit; build every hand kernel
   with nvcc, all at once (one nvcc per source): csrc/swar_gf.cu,
   csrc/copy_floor.cu, and the generated swar_baked/swar3_baked sources for
   the RS(8,3) Vandermonde and Cauchy encode matrices and one decode matrix
   (erasures [0, 5, 10]); print each build's time and ptxas registers and
   spills, and count the 16-byte loads and stores of copy_floor_kernel<8>
   in its SASS.
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
   events around 5 back-to-back calls, median of 20 runs, beside the bound (the larger of the bytes
   moved at the HBM rate and the ops of the packed ring program at the
   INT32 rate), the plain version, the hand copy floor (which moves the
   same bytes) and a device copy of the whole input as the memory
   yardstick; then `decode_array` at the same shape for one pattern of each
   erasure class.
5. The kernel experiments (ceph_tpu_torch/diag): copy_floor, swar_baked and
   swar3_baked against their plain versions and the oracle, byte for byte,
   on (1, 8, L) for L in {4096, 131072, 524288}, (8, 8, 16384) and
   (64, 8, 131072), for the three matrices of phase 1, at every block width
   and tile of the scripts; then each experiment's main() once at its
   script's own sizes, with launch counts reset before and held against
   the calls it made; then each kernel timed at (256, 8, 131072), median
   of 20, beside its bound, its plain version and (copy only) the library
   call `dst.copy_(data[:, :3])`.

The last line of standard output is one JSON object,
{"ok": true, "device": {...}}; the line before it lists each kernel.
There is no CPU branch: without CUDA the script exits non-zero.
"""

from __future__ import annotations

import collections
import json
import os
import re
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

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
# Phase 5's (S, k, L): one chunk of 4 KiB, 128 KiB (the scripts' CHUNK) and
# 512 KiB (the main path's), and two batches.
DIAG_SHAPES = [(1, 8, 4096), (1, 8, 131072), (1, 8, 524288), (8, 8, 16384), (64, 8, 131072)]
# The bulk shape every kernel is timed at, and the calls timed per run.
BULK = (256, 8, 131072)
CALLS_PER_RUN = 5


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
    """Median over `reps` runs of the CUDA-event time of CALLS_PER_RUN
    back-to-back calls of fn(), per call, after `warmup` calls.  Back-to-back
    calls let the host enqueue a launch while the card runs the previous
    one, so the host's per-call cost stays out of a kernel's time unless it
    is the larger."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS_PER_RUN):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS_PER_RUN)
    return statistics.median(times)


def baked_matrices(gf):
    """The matrices the baked kernels are built for (phase 1) and checked on
    (phase 5): RS(8,3) encode of both techniques, and one decode matrix."""
    van = gf.isa_rs_vandermonde_matrix(8, 3)
    dec, _ = gf.isa_decode_matrix(van, [0, 5, 10], 8)
    return [("rs83-van-encode", van[8:]),
            ("rs83-cauchy-encode", gf.isa_cauchy_matrix(8, 3)[8:]),
            ("rs83-van-decode[0,5,10]", dec)]


def ptxas_lines(info: dict) -> list[str]:
    return [line.replace("ptxas info    :", "").strip()
            for line in info.get("ptxas", "").splitlines()
            if "registers" in line or "spill" in line]


def sass_opcodes(nvcc: str, library: str, kernel: str):
    """Counter of the SASS opcodes (e.g. "LOP3.LUT", "LDG.E.128.CONSTANT")
    of the function of `library` whose name contains `kernel`; None if the
    toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    proc = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          timeout=120)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr.strip()}")
    for section in proc.stdout.split("Function : ")[1:]:
        if kernel in section.splitlines()[0]:
            return collections.Counter(
                m.group(1) for m in re.finditer(
                    r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", section))
    check(False, f"no function {kernel} in the SASS of {library}")


def count_prefix(ops, prefix: str) -> int:
    return sum(n for op, n in ops.items() if op.startswith(prefix))


def phase_env(torch, swar, gf, diag, nvcc):
    kern_exp2, kern_exp3, kern_exp4 = diag[:3]
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {name}  count={torch.cuda.device_count()}")
    print(f"[1] nvidia-smi: {card}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}")

    def swar_gf_info():
        swar.build_library()
        return swar.build_info

    jobs = {"swar_gf": swar_gf_info, "copy_floor": lambda: kern_exp4.build().info}
    for label, mat in baked_matrices(gf):
        jobs[f"swar_baked {label}"] = lambda mat=mat: kern_exp2.make_swar(mat, 128).build().info
        jobs[f"swar3_baked {label}"] = (
            lambda mat=mat: kern_exp3.make_swar3(mat, 128, 256).build().info)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {label: pool.submit(job) for label, job in jobs.items()}
        infos = {label: future.result() for label, future in futures.items()}
    print(f"[1] built {len(jobs)} libraries in {time.perf_counter() - t0:.2f} s "
          "(one nvcc each, all started together)")
    for label, info in infos.items():
        print(f"[1] {label}: {info['seconds']:.2f} s, sha256 {info['source_sha256']}")
        for line in ptxas_lines(info):
            print(f"[1]   ptxas: {line}")
    copy_ops = sass_opcodes(nvcc, infos["copy_floor"]["library"], "copy_floor_kernelILi8E")
    if copy_ops is None:
        print("[1] SASS: no cuobjdump in the toolkit, not counted")
    else:
        loads, stores = count_prefix(copy_ops, "LDG.E.128"), count_prefix(copy_ops, "STG.E.128")
        print(f"[1] copy_floor_kernel<8> SASS: {loads} LDG.E.128, {stores} STG.E.128 "
              "(every path of the loop reads all 8 chunks)")
        check(loads > 0 and loads % 8 == 0 and stores >= 3,
              f"copy_floor_kernel<8> SASS has {loads} 16-byte loads, {stores} stores")
        # the loop body codes one 16-byte vector (4 words) of each chunk
        ops = sass_opcodes(nvcc, infos["swar_baked rs83-van-encode"]["library"],
                           "swar_baked_kernel")
        total = sum(ops.values())
        mix = ", ".join(f"{op} {n}" for op, n in ops.most_common(8))
        print(f"[1] swar_baked_kernel (rs83-van-encode) SASS: {total} instructions, "
              f"{total / 4:.1f} per word (TPU program as written: 539); {mix}")
    return name, card, infos


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


def phase_bulk(torch, swar, registry, gf, card, kern_exp4):
    dev = torch.device("cuda")
    ec = registry.instance().factory("tpu", {"k": "8", "m": "3"})
    S, k, L = BULK
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
                       warmup=2, reps=5)
    dst = torch.empty_like(data)
    copy_ms = time_ms(torch, lambda: dst.copy_(data))
    floor = kern_exp4.make_copy(4096)
    check(torch.equal(floor(data), data[:, :3]), "copy floor != data[:, :3]")
    floor_ms = time_ms(torch, lambda: floor(data))
    floor_bytes = (k + 3) * S * L
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
    print(f"[4] hand copy floor (copy_floor, tile 4096: reads all {k} chunks, writes 3, "
          f"{floor_bytes} B, what encode moves): {floor_ms:.4f} ms, "
          f"{floor_bytes / floor_ms / 1e6:.2f} GB/s moved")
    print(f"[4] swar_gf takes {kernel_ms / floor_ms:.3f}x the hand copy floor's time "
          f"(share {floor_ms / kernel_ms:.3f}); {kernel_ms / copy_ms:.3f}x the torch copy's")
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
            "bound_by": bound_by, "floor_ms": floor_ms}


def coding_bound(mat, S: int, k: int, L: int) -> tuple[float, str]:
    """The least time the card could take for (S, k, L) -> (S, m, L) coding
    by `mat`: the larger of the bytes moved at the HBM rate and the ring
    program's ops at the INT32 rate (as phase 4 prints it)."""
    mem_ms = (k + len(mat)) * S * L / HBM_BYTES_PER_S * 1e3
    alu_ms = ring_word_ops(mat) * S * (L // 4) / INT32_OPS_PER_S * 1e3
    return max(mem_ms, alu_ms), ("bytes" if mem_ms >= alu_ms else "operations")


def unported_bounds(S: int, k: int, L: int, m: int = 3) -> dict:
    """Bounds (ms, by) at (S, k, L) of the TPU kernels of
    benchmarks/diag/kern_exp.py that are still to port, from their shapes:
    each input byte read once, each output byte written once, at the HBM
    rate; the (8m, 8k) 0/1 bit-matrix product over S·L columns (2 ops per
    multiply-add) at the dense bf16 tensor rate (989e12/s); the bytewise
    popcount of k chunks as SWAR on 32-bit words (10 ops per word of each
    chunk, k - 1 adds) at the INT32 rate."""
    mm_ms = 2 * (8 * m) * (8 * k) * S * L / 989e12 * 1e3
    popc_ms = (10 * k + k - 1) * S * (L // 4) / INT32_OPS_PER_S * 1e3
    rows = {
        "make_grouped": ((k + m) * S * L, mm_ms),       # (S,k,L) u8 -> (S,m,L) u8
        "make_mm_only": ((2 * 8 * k + 8 * m) * S * L, mm_ms),  # bf16 planes -> u8 counts
        "make_expand_only": ((k + 1) * S * L, popc_ms),  # (S,k,L) u8 -> (S,1,L) u8
    }
    out = {}
    for name, (moved, ops_ms) in rows.items():
        mem_ms = moved / HBM_BYTES_PER_S * 1e3
        out[name] = (max(mem_ms, ops_ms), "bytes" if mem_ms >= ops_ms else "operations")
    return out


def byte_err(torch, got, want) -> int:
    return int((got.to(torch.int16) - want.to(torch.int16)).abs().max())


def phase_diag_checks(torch, swar, gf, diag) -> dict:
    """copy_floor, swar_baked and swar3_baked against their plain versions
    and the oracle, byte for byte; returns each kernel's max abs error."""
    kern_exp2, kern_exp3, kern_exp4, kern_exp5 = diag
    dev = torch.device("cuda")
    geometries = list(dict.fromkeys(kern_exp3.GEOMETRIES + kern_exp5.SWAR3_GEOMETRIES))
    mats = baked_matrices(gf)
    errs = dict.fromkeys(("copy_floor", "swar_baked", "swar3_baked"), 0)
    cases = dict.fromkeys(errs, 0)
    copy = kern_exp4.make_copy(4096)

    def record(kernel, label, got, plain, oracle):
        err = byte_err(torch, got, plain)
        errs[kernel] = max(errs[kernel], err)
        check(err == 0, f"{kernel} {label}: kernel != plain (max err {err})")
        for s, want in oracle.items():
            check(np.array_equal(got[s].cpu().numpy(), want),
                  f"{kernel} {label}: stripe {s} != oracle")
        cases[kernel] += 1

    for n, shape in enumerate(DIAG_SHAPES):
        S, k, L = shape
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 10 + n)
        data = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
        ends = sorted({0, S - 1})  # the oracle costs host time: first and last stripe
        record("copy_floor", f"{shape}", copy(data), kern_exp4.copy_reference(data),
               {s: data[s, :3].cpu().numpy() for s in ends})
        for label, mat in mats:
            sched = swar.schedule_from_matrix(mat)
            plain = swar.swar_code_reference(sched, data)
            oracle = {s: gf.gf_matmul(mat, data[s].cpu().numpy()) for s in ends}
            for wt in kern_exp2.WTS:
                if (L // 32) % wt == 0:
                    record("swar_baked", f"{label} {shape} wt={wt}",
                           kern_exp2.make_swar(mat, wt)(data), plain, oracle)
            for rows, cols in geometries:
                if L % (rows * cols) == 0:
                    record("swar3_baked", f"{label} {shape} {rows}x{cols}",
                           kern_exp3.make_swar3(mat, rows, cols)(data),
                           kern_exp3.swar3_reference(sched, data, rows, cols), oracle)
        del data
    for kernel, err in errs.items():
        print(f"[5] {kernel} == plain == oracle on {cases[kernel]} cases, max_abs_err={err}")
    return errs


def phase_diag_mains(torch, swar, diag) -> dict:
    """Each experiment's main() at its script's own sizes; launch counts
    reset just before and held against the calls made."""
    kern_exp2, kern_exp3, kern_exp4, kern_exp5 = diag
    counters = {"swar_baked": kern_exp2, "swar3_baked": kern_exp3,
                "copy_floor": kern_exp4, "swar_gf": swar}
    for module in counters.values():
        module.launches = 0
    calls = {}
    for script, run in (("kern_exp2", lambda: kern_exp2.main([])),
                        ("kern_exp3", lambda: kern_exp3.main([])),
                        ("kern_exp4", kern_exp4.main), ("kern_exp5", kern_exp5.main)):
        print(f"[5] --- ceph_tpu_torch.diag.{script}.main()", flush=True)
        for kernel, n in run().items():
            calls[kernel] = calls.get(kernel, 0) + n
    torch.cuda.synchronize()
    launches = {kernel: module.launches for kernel, module in counters.items()}
    for kernel, n in launches.items():
        print(f"[5] {kernel}: launches {n}, wrapper calls {calls.get(kernel, 0)}")
        check(n > 0 and n == calls.get(kernel, 0),
              f"{kernel}: launches {n} != wrapper calls {calls.get(kernel, 0)}")
    return launches


def phase_diag_timing(torch, swar, gf, diag, floor_ms) -> dict:
    """Each kernel at the bulk shape, median of 20, beside its bound, its
    plain version and (copy only) the library call."""
    kern_exp2, kern_exp3, kern_exp4, kern_exp5 = diag
    dev = torch.device("cuda")
    S, k, L = BULK
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    data = torch.randint(0, 256, BULK, dtype=torch.uint8, device=dev, generator=gen)
    mat = gf.isa_rs_vandermonde_matrix(k, 3)[k:]
    sched = swar.schedule_from_matrix(mat)
    plain = swar.swar_code_reference(sched, data)
    bound_ms, bound_by = coding_bound(mat, S, k, L)
    in_bytes = S * k * L

    def best(kernel, variants):
        times = {}
        for label, fn in variants.items():
            check(torch.equal(fn(data), plain), f"{kernel} {label} != plain at {BULK}")
            times[label] = time_ms(torch, lambda: fn(data))
            print(f"[5] {kernel} {label}: {times[label]:.4f} ms, "
                  f"{in_bytes / times[label] / 1e6:.2f} GB/s input, "
                  f"{bound_ms / times[label]:.3f} of the bound")
        label = min(times, key=times.get)
        return label, times[label]

    wt_label, swar_ms = best("swar_baked", {
        f"wt={wt}": kern_exp2.make_swar(mat, wt) for wt in kern_exp2.WTS})
    geometries = list(dict.fromkeys(kern_exp3.GEOMETRIES + kern_exp5.SWAR3_GEOMETRIES))
    geo_label, swar3_ms = best("swar3_baked", {
        f"{rows}x{cols}": kern_exp3.make_swar3(mat, rows, cols) for rows, cols in geometries})
    rows, cols = (int(x) for x in geo_label.split("x"))
    plain_ms = time_ms(torch, lambda: swar.swar_code_reference(sched, data), warmup=2, reps=5)
    plain3_ms = time_ms(torch, lambda: kern_exp3.swar3_reference(sched, data, rows, cols),
                        warmup=2, reps=5)
    copy_plain_ms = time_ms(torch, lambda: kern_exp4.copy_reference(data))
    dst = torch.empty((S, 3, L), dtype=torch.uint8, device=dev)
    library_ms = time_ms(torch, lambda: dst.copy_(data[:, :3]))
    copy_bound_ms = (k + 3) * S * L / HBM_BYTES_PER_S * 1e3
    print(f"[5] bound of coding at {BULK}: {bound_ms:.4f} ms by {bound_by}; "
          f"of the copy floor: {copy_bound_ms:.4f} ms by bytes")
    print(f"[5] swar_baked best {wt_label}: {swar_ms:.4f} ms; plain swar_code_reference "
          f"{plain_ms:.4f} ms")
    print(f"[5] swar3_baked best {geo_label}: {swar3_ms:.4f} ms; plain swar3_reference "
          f"{plain3_ms:.4f} ms")
    for name, (ms, by) in unported_bounds(S, k, L).items():
        print(f"[5] bound of kern_exp.py {name} (still to port) at {BULK}: {ms:.4f} ms by {by}")
    print(f"[5] copy_floor (phase 4): {floor_ms:.4f} ms, {copy_bound_ms / floor_ms:.3f} of "
          f"its bound; plain copy_reference {copy_plain_ms:.4f} ms; library "
          f"dst.copy_(data[:, :3]) {library_ms:.4f} ms")
    return {
        "copy_floor": {"ms": floor_ms, "plain_ms": copy_plain_ms, "bound_ms": copy_bound_ms,
                       "bound_by": "bytes", "library_ms": library_ms, "variant": "tile=4096",
                       "source_sha256": kern_exp4.build().info["source_sha256"]},
        "swar_baked": {"ms": swar_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": None, "variant": wt_label,
                       "source_sha256": kern_exp2.make_swar(mat, 128).build().info["source_sha256"]},
        "swar3_baked": {"ms": swar3_ms, "plain_ms": plain3_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None, "variant": geo_label,
                        "source_sha256": kern_exp3.make_swar3(mat, 128, 256).build().info["source_sha256"]},
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on the card",
              file=sys.stderr)
        return 2
    try:
        from ceph_tpu_torch import gf
        from ceph_tpu_torch.codec import registry
        from ceph_tpu_torch.diag import kern_exp2, kern_exp3, kern_exp4, kern_exp5
        from ceph_tpu_torch.ops import swar_gf as swar
        from ceph_tpu_torch.ops._nvcc import nvcc_path
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    diag = (kern_exp2, kern_exp3, kern_exp4, kern_exp5)

    def phase(n, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        print(f"[{n}] phase {n}: {time.perf_counter() - t0:.2f} s", flush=True)
        return result

    name, card, infos = phase(1, phase_env, torch, swar, gf, diag, nvcc_path())
    max_err = phase(2, phase_kernel_checks, torch, swar, gf)
    launches = phase(3, phase_main_path, torch, swar, registry, gf)
    bulk = phase(4, phase_bulk, torch, swar, registry, gf, card, kern_exp4)
    errs = phase("5a", phase_diag_checks, torch, swar, gf, diag)
    diag_launches = phase("5b", phase_diag_mains, torch, swar, diag)
    diag_times = phase("5c", phase_diag_timing, torch, swar, gf, diag, bulk["floor_ms"])
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
        "source_sha256": infos["swar_gf"]["source_sha256"],
    }]
    for kernel, source, replaces in (
        ("copy_floor", "copy_floor.cu", "benchmarks/diag/kern_exp4.py:34"),
        ("swar_baked", "swar_baked.cu", "benchmarks/diag/kern_exp2.py:48"),
        ("swar3_baked", "swar3_baked.cu", "benchmarks/diag/kern_exp3.py:41"),
    ):
        kernels.append({
            "name": kernel,
            "route": "cuda",
            "source": f"ceph_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": diag_launches[kernel],
            "max_abs_err": errs[kernel],
            **diag_times[kernel],
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
