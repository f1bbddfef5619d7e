"""bench.sh equivalent — sweep plugins x techniques x k/m grid.

The port of `ceph_tpu/tools/bench_sweep.py`, the mirror of Ceph's
qa/workunits/erasure-code/bench.sh:40-57: runs the benchmark harness over a
parameter grid and emits one JSON line per run (instead of flot JS) so
results are machine-readable.

  python -m ceph_tpu_torch.tools.bench_sweep --size 4096 --total-size 1048576
  python -m ceph_tpu_torch.tools.bench_sweep --baseline --iterations 8
  python -m ceph_tpu_torch.tools.bench_sweep --baseline --iterations 1 --device cpu

The codecs run on `--device`, `cuda` unless `--device cpu` is asked for.
A record's `platform` is that device's type (`cuda` or `cpu`).  Codec
errors and content mismatches are recorded as `error` rows and the sweep
goes on, as in the reference; a device error (`ops.guard.is_device_error`)
is never a row: it ends the sweep with DEVICE_ERROR_EXIT
(`tools/guarded.py`).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from ..codec import base
from ..ops.guard import is_device_error
from . import ec_benchmark
from .guarded import exits_on_device_error

# The five BASELINE.md configs (LRC shape adjusted per the reference's own
# parse_kml constraints, see ec_corpus.py).
BASELINE_CONFIGS = [
    {
        "name": "jerasure_reed_sol_van_k4m2_4KiB",
        "plugin": "jerasure",
        "profile": {"k": "4", "m": "2", "technique": "reed_sol_van"},
        "size": 4 * 4096,
        "workloads": ("encode", "decode"),
    },
    {
        "name": "rs_8_3_cauchy_1MiB",
        "plugin": "tpu",
        "profile": {"k": "8", "m": "3", "technique": "cauchy"},
        "size": 1 << 20,
        # headline config: encode + decode at EVERY erasure count
        # (reference invocation: isa/README:36-47, decode e=1,2,3)
        "workloads": ("encode", "decode"),
        "erasure_counts": (1, 2, 3),
    },
    {
        # "64K stripes in flight" (BASELINE.md config 3): batching depth,
        # so the chunk is small (4 KiB) and the batch is what's measured
        "name": "rs_10_4_bulk_stripes",
        "plugin": "tpu",
        "profile": {"k": "10", "m": "4"},
        "size": 10 * 4096,  # 4 KiB chunks (chunk = size / k)
        "workloads": ("bulk",),
    },
    {
        "name": "clay_8_4_d11_subchunk_repair",
        "plugin": "clay",
        "profile": {"k": "8", "m": "4", "d": "11"},
        "size": 1 << 18,
        "workloads": ("repair",),
    },
    {
        "name": "lrc_12_3_l5_multi_failure",
        "plugin": "lrc",
        "profile": {"k": "12", "m": "3", "l": "5"},
        "size": 1 << 18,
        "workloads": ("encode", "decode"),
    },
]


def run_bulk(ec, size: int, batch: int, iters: int) -> tuple[float, int]:
    """BASELINE config 3: many stripes in flight through the codec's
    device path (`encode_array` on a resident (S, k, L) batch) — the
    batched bulk-rebuild path, not per-object calls.

    Serial-chain methodology: before each launch the first 128 bytes of
    the batch are patched in place with bytes of the previous launch's
    parity, so no launch repeats another's input, and one
    `torch.cuda.synchronize()` plus a tiny device-to-host read close the
    timing window.

    `batch` stripes stay in flight as a QUEUE of chained launches of at
    most 4096 stripes (160 MiB at 4 KiB chunks and k = 10): the OSD's
    pipeline submits bounded launches back to back, it does not build one
    2.5 GB batch.  The `rounds` launches of an iteration queue without a
    sync.
    """
    import numpy as np
    import torch

    k = ec.get_data_chunk_count()
    chunk = ec.get_chunk_size(size)
    sub = min(batch, 4096)
    rounds = -(-batch // sub)  # ceil: never measure fewer stripes than asked
    data = torch.from_numpy(
        np.random.default_rng(0).integers(0, 256, (sub, k, chunk), dtype=np.uint8)
    ).to(ec.device)
    n = min(128, chunk)

    def step(p):
        data[0, 0, :n] = p[0, 0, :n] ^ 1
        return ec.encode_array(data)

    def sync():
        if ec.device.type == "cuda":
            torch.cuda.synchronize(ec.device)

    p = step(ec.encode_array(data))  # warm
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        for _ in range(rounds):  # `rounds` launches queue without a sync
            p = step(p)
    sync()
    _ = p[0, 0, :8].cpu()
    return time.perf_counter() - t0, sub * rounds * k * chunk * iters


def run_baseline(iterations: int, out=None, device=None) -> int:
    platform = base.resolve_device(device).type
    # "64K stripes in flight" on the card; scaled down on the CPU so the
    # sweep stays tractable
    bulk_batch = 65536 if platform == "cuda" else 64

    def emit(rec: dict) -> None:
        line = json.dumps(rec)
        print(line, flush=True)
        if out is not None:
            out.write(line + "\n")
            out.flush()

    for cfg in BASELINE_CONFIGS:
        for workload in cfg["workloads"]:
            erasure_counts = (
                cfg.get("erasure_counts", (cfg.get("erasures", 2),))
                if workload == "decode"
                else (None,)
            )
            argv = ["-p", cfg["plugin"], "-S", str(cfg["size"]),
                    "-i", str(iterations)]
            if device is not None:
                argv += ["--device", str(device)]
            for kv in cfg["profile"].items():
                argv += ["-P", f"{kv[0]}={kv[1]}"]
            opts = ec_benchmark.build_parser().parse_args(argv)
            try:
                ec = ec_benchmark.make_codec(opts)
            except (Exception, SystemExit) as e:
                if is_device_error(e):
                    raise
                emit({"config": cfg["name"], "workload": workload,
                      "platform": platform, "error": str(e)})
                continue
            for nerr in erasure_counts:
                rec = {
                    "config": cfg["name"],
                    "plugin": cfg["plugin"],
                    "profile": cfg["profile"],
                    "workload": workload,
                    "platform": platform,
                }
                try:
                    if workload == "encode":
                        elapsed = ec_benchmark.run_encode(ec, opts)
                        total = iterations * cfg["size"]
                    elif workload == "decode":
                        opts.erasures = min(
                            nerr, ec.get_coding_chunk_count()
                        )
                        rec["erasures"] = opts.erasures
                        elapsed = ec_benchmark.run_decode(ec, opts)
                        total = iterations * cfg["size"]
                    elif workload == "repair":
                        elapsed, bytes_read, bytes_repaired = (
                            ec_benchmark.run_repair(ec, opts)
                        )
                        total = iterations * cfg["size"]
                        rec["bytes_read"] = bytes_read
                        rec["bytes_repaired"] = bytes_repaired
                        rec["read_amplification"] = round(
                            bytes_read / max(1, bytes_repaired), 3
                        )
                    else:  # bulk
                        elapsed, total = run_bulk(
                            ec, cfg["size"], bulk_batch, max(2, iterations // 4)
                        )
                        rec["stripes_in_flight"] = bulk_batch
                    rec["seconds"] = round(elapsed, 6)
                    rec["MBps"] = round(total / max(elapsed, 1e-9) / 1e6, 1)
                except (Exception, SystemExit) as e:
                    # record failures, keep sweeping (run_decode/run_repair
                    # signal content mismatch via SystemExit); a device
                    # error ends the sweep
                    if is_device_error(e):
                        raise
                    rec["error"] = str(e)
                emit(rec)
    return 0


@exits_on_device_error("bench_sweep")
def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="bench_sweep", description=__doc__)
    p.add_argument("--size", type=int, default=4096, help="object size per op")
    p.add_argument(
        "--total-size", type=int, default=1 << 20, help="total bytes per config"
    )
    p.add_argument(
        "--plugins", default="tpu,jerasure", help="comma-separated plugin list"
    )
    p.add_argument("--ks", default="2,3,4,6,8,10")
    p.add_argument("--ms", default="1,2,3")
    p.add_argument("--workloads", default="encode,decode")
    p.add_argument(
        "--baseline",
        action="store_true",
        help="run the five BASELINE.md configs instead of the grid",
    )
    p.add_argument("--iterations", type=int, default=8)
    p.add_argument(
        "--out", default="",
        help="also append JSONL to this file (baseline mode only)",
    )
    p.add_argument("--device", default=None,
                   help="the codecs' device: cuda (default) or cpu")
    args = p.parse_args(argv)

    if args.baseline:
        out = open(args.out, "a") if args.out else None
        try:
            return run_baseline(args.iterations, out=out, device=args.device)
        finally:
            if out is not None:
                out.close()

    techniques = {
        "tpu": ["reed_sol_van", "cauchy"],
        "jerasure": ["reed_sol_van", "cauchy_good"],
    }
    iterations = max(1, args.total_size // args.size)
    for plugin in args.plugins.split(","):
        for technique in techniques.get(plugin, [None]):
            for k in (int(x) for x in args.ks.split(",")):
                for m in (int(x) for x in args.ms.split(",")):
                    if m > k:
                        continue
                    for workload in args.workloads.split(","):
                        bench_args = [
                            "-p", plugin,
                            "-P", f"k={k}",
                            "-P", f"m={m}",
                            "-S", str(args.size),
                            "-i", str(iterations),
                            "-w", workload,
                            "-e", str(min(m, 2)),
                        ]
                        if technique:
                            bench_args += ["-P", f"technique={technique}"]
                        if args.device is not None:
                            bench_args += ["--device", args.device]
                        parser = ec_benchmark.build_parser()
                        opts = parser.parse_args(bench_args)
                        try:
                            ec = ec_benchmark.make_codec(opts)
                            if workload == "encode":
                                elapsed = ec_benchmark.run_encode(ec, opts)
                            else:
                                elapsed = ec_benchmark.run_decode(ec, opts)
                        except (Exception, SystemExit) as e:  # record, keep sweeping
                            if is_device_error(e):
                                raise
                            print(
                                json.dumps(
                                    {
                                        "plugin": plugin,
                                        "technique": technique,
                                        "k": k,
                                        "m": m,
                                        "workload": workload,
                                        "error": str(e),
                                    }
                                )
                            )
                            continue
                        total = iterations * args.size
                        print(
                            json.dumps(
                                {
                                    "plugin": plugin,
                                    "technique": technique,
                                    "k": k,
                                    "m": m,
                                    "workload": workload,
                                    "seconds": round(elapsed, 6),
                                    "KiB": total / 1024,
                                    "MBps": round(total / max(elapsed, 1e-9) / 1e6, 1),
                                }
                            )
                        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
