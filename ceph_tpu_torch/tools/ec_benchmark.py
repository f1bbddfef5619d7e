"""ceph_erasure_code_benchmark equivalent — the reference metric harness.

The port of `ceph_tpu/tools/ec_benchmark.py`, the mirror of Ceph's
src/test/erasure-code/ceph_erasure_code_benchmark.cc (CLI :49-153, encode
loop :165-194, decode loop with random / fixed / exhaustive erasure
generation and content verification :211-326).  Output format is the reference's: "<elapsed seconds>\\t<iterations * size / 1024>"
(seconds TAB KiB).

  python -m ceph_tpu_torch.tools.ec_benchmark -p tpu -P k=8 -P m=3 -S 1048576 -i 100
  python -m ceph_tpu_torch.tools.ec_benchmark -w decode -e 2 --erasures-generation \\
      exhaustive -p tpu -P k=8 -P m=3 -S 1048576 -i 100
  python -m ceph_tpu_torch.tools.ec_benchmark --device cpu -p tpu -P k=4 -P m=2 -S 4096

One deviation, kept from the JAX package's tool: each encode iteration
XORs a counter into the first byte of the input, so no runtime that
memoizes identical launches can elide repeated iterations.

The codec runs on `--device`, `cuda` unless `--device cpu` is asked for,
under the device guard (`tools/guarded.py`); a device error exits with
DEVICE_ERROR_EXIT.  Every timed call returns host bytes (the chunk
interface copies parity back), so the wall clock closes on finished work.
"""

from __future__ import annotations

import argparse
import itertools
import random
import sys
import time

import numpy as np

from ..codec import registry as registry_mod
from ..codec.interface import EcError
from .guarded import exits_on_device_error, guard_codec


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ec_benchmark", description=__doc__)
    p.add_argument("-p", "--plugin", default="tpu")
    p.add_argument(
        "-P",
        "--parameter",
        action="append",
        default=[],
        help="profile k=v pairs (repeatable)",
    )
    p.add_argument("-S", "--size", type=int, default=1 << 20)
    p.add_argument("-i", "--iterations", type=int, default=1)
    p.add_argument(
        "-w",
        "--workload",
        choices=("encode", "encode-pipelined", "decode", "repair"),
        default="encode",
    )
    p.add_argument("-e", "--erasures", type=int, default=1)
    p.add_argument("--depth", type=int, default=4,
                   help="encode-pipelined in-flight launch depth")
    p.add_argument(
        "--erased",
        action="append",
        type=int,
        default=None,
        help="fixed chunk ids to erase (repeatable)",
    )
    p.add_argument(
        "--erasures-generation",
        choices=("random", "exhaustive"),
        default="random",
    )
    p.add_argument("-v", "--verbose", action="store_true")
    p.add_argument("--device", default=None,
                   help="the codec's device: cuda (default) or cpu")
    return p


def make_codec(args):
    profile = {}
    for token in args.parameter:
        key, val = token.split("=", 1)
        profile[key] = val
    return guard_codec(
        registry_mod.instance().factory(args.plugin, profile, device=args.device)
    )


def run_encode(ec, args) -> float:
    n = ec.get_chunk_count()
    want = set(range(n))
    buf = np.random.default_rng(0).integers(0, 256, args.size, dtype=np.uint8)
    start = time.perf_counter()
    for i in range(args.iterations):
        buf[0] ^= np.uint8(i + 1)  # defeat identical-launch caching
        ec.encode(want, buf)
    return time.perf_counter() - start


def run_encode_pipelined(ec, args, depth: int | None = None) -> float:
    """Pipelined chunk encodes through the EncodePipeline completion
    queue: device launches overlap the host-side stripe preparation (the
    AIO-queue shape in front of ec_encode_data).  Stripes are generated
    INSIDE the timed loop — that host work is exactly what the pipeline
    overlaps, and pre-materializing every iteration would OOM large
    sweeps."""
    from ..codec.matrix_codec import EncodePipeline

    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    chunk = ec.get_chunk_size(args.size)
    rng = np.random.default_rng(0)
    pipe = EncodePipeline(
        ec, depth=depth if depth is not None else getattr(args, "depth", 4)
    )
    start = time.perf_counter()
    for i in range(args.iterations):
        chunks = {
            ec.chunk_index(j): rng.integers(0, 256, chunk, dtype=np.uint8)
            if j < k
            else np.zeros(chunk, dtype=np.uint8)
            for j in range(n)
        }
        pipe.submit(chunks)
        pipe.poll()  # reap whatever already finished, without blocking
    pipe.flush()
    return time.perf_counter() - start


def run_decode(ec, args) -> float:
    n = ec.get_chunk_count()
    buf = np.random.default_rng(0).integers(0, 256, args.size, dtype=np.uint8)
    encoded = ec.encode(set(range(n)), buf)
    rng = random.Random(0)

    if args.erased:
        patterns = itertools.repeat(tuple(args.erased))
    elif args.erasures_generation == "exhaustive":
        patterns = itertools.cycle(
            itertools.combinations(range(n), args.erasures)
        )
    else:
        patterns = (
            tuple(rng.sample(range(n), args.erasures)) for _ in itertools.count()
        )

    elapsed = 0.0
    for _, erasures in zip(range(args.iterations), patterns):
        avail = {i: encoded[i] for i in range(n) if i not in erasures}
        t0 = time.perf_counter()
        decoded = ec.decode(set(erasures), avail)
        elapsed += time.perf_counter() - t0
        # content verification (reference decode_erasures :211-258)
        for e in erasures:
            if not np.array_equal(decoded[e], encoded[e]):
                raise SystemExit(f"decode mismatch for erasures {erasures}")
    return elapsed


def run_repair(ec, args) -> tuple[float, int, int]:
    """Single-chunk repair via minimum_to_decode's sub-chunk read plan.

    The regenerating-code metric (BASELINE config 4): a CLAY codec's plan
    reads d helpers x sub_chunk_no/q sub-chunks — d/(d-k+1) chunks' worth —
    where an MDS code reads k full chunks.  Returns (elapsed, bytes_read,
    bytes_repaired); the read plan mirrors ECBackend's fragmented sub-chunk
    reads (Ceph src/osd/ECBackend.cc:1047-1068; repair plan
    clay/ErasureCodeClay.cc:363-377).
    """
    n = ec.get_chunk_count()
    buf = np.random.default_rng(0).integers(0, 256, args.size, dtype=np.uint8)
    encoded = ec.encode(set(range(n)), buf)
    chunk_size = len(encoded[0])
    sub = chunk_size // ec.get_sub_chunk_count()
    rng = random.Random(0)

    elapsed, bytes_read, bytes_repaired = 0.0, 0, 0
    for i in range(args.iterations):
        lost = args.erased[0] if args.erased else rng.randrange(n)
        avail = set(range(n)) - {lost}
        minimum = ec.minimum_to_decode({lost}, avail)
        helpers: dict[int, np.ndarray] = {}
        for node, runs in minimum.items():
            frags = [
                encoded[node][off * sub : (off + count) * sub]
                for off, count in runs
            ]
            helpers[node] = np.concatenate(frags)
            bytes_read += len(helpers[node])
        t0 = time.perf_counter()
        decoded = ec.decode({lost}, helpers, chunk_size)
        elapsed += time.perf_counter() - t0
        if not np.array_equal(decoded[lost], encoded[lost]):
            raise SystemExit(f"repair mismatch for lost chunk {lost}")
        bytes_repaired += chunk_size
    return elapsed, bytes_read, bytes_repaired


@exits_on_device_error("ec_benchmark")
def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        ec = make_codec(args)
    except EcError as e:
        print(e, file=sys.stderr)
        return 1
    if args.workload == "encode":
        elapsed = run_encode(ec, args)
    elif args.workload == "encode-pipelined":
        elapsed = run_encode_pipelined(ec, args)
    elif args.workload == "decode":
        elapsed = run_decode(ec, args)
    else:
        elapsed, bytes_read, bytes_repaired = run_repair(ec, args)
        # repair emits an extra TAB field pair: read/repaired byte ratio —
        # the regenerating-code repair-bandwidth saving
        print(
            f"{elapsed:.6f}\t{args.iterations * args.size / 1024:.0f}"
            f"\t{bytes_read}\t{bytes_repaired}"
        )
        return 0
    print(f"{elapsed:.6f}\t{args.iterations * args.size / 1024:.0f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
