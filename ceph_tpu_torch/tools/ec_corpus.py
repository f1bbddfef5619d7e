"""Encode/decode non-regression corpus tool.

The port of `ceph_tpu/tools/ec_corpus.py`, the mirror of Ceph's
src/test/erasure-code/ceph_erasure_code_non_regression.cc (run by
qa/workunits/erasure-code/encode-decode-non-regression.sh): `--create`
writes a content file plus the per-chunk encodings of it into a directory
named after the profile; `--check` re-encodes the stored content and fails if
any chunk byte differs, then decodes one- and two-erasure cases and fails if
any chunk is incorrectly recovered.  A checked-in corpus therefore pins
today's chunk bytes: any future change to matrix math, padding, or kernel
layout that alters even one byte fails the suite.

Unlike the reference (rand()-seeded payload), the payload is deterministic so
`--create` is reproducible byte-for-byte from a clean checkout.

The codecs run on `--device`, `cuda` unless `--device cpu` is asked for,
under the device guard (`tools/guarded.py`).  A device error is never
read as a failed config: it ends the tool with DEVICE_ERROR_EXIT (the
reference's `run_standard` reads an OSError as one; no device error is an
EcError or an OSError, so it passes that catch).

Usage:
  python -m ceph_tpu_torch.tools.ec_corpus --create --base DIR --plugin tpu \
      --stripe-width 4096 -P k=8 -P m=3
  python -m ceph_tpu_torch.tools.ec_corpus --check  --base DIR --plugin tpu \
      --stripe-width 4096 -P k=8 -P m=3
  python -m ceph_tpu_torch.tools.ec_corpus --check --standard --base tests/corpus --device cpu
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..codec import registry as registry_mod
from ..codec.interface import EcError, Profile
from .guarded import exits_on_device_error, guard_codec

PAYLOAD_CHUNK = 37  # reference payload repeat unit


def payload_bytes(stripe_width: int) -> bytes:
    """Deterministic 'a'..'z' pattern (the reference fills 37-byte units
    with rand() letters; determinism matters more than randomness here)."""
    unit = bytes(ord("a") + (11 * j + 5) % 26 for j in range(PAYLOAD_CHUNK))
    reps = stripe_width // PAYLOAD_CHUNK + 1
    return (unit * reps)[:stripe_width]


def corpus_dir(base: str, plugin: str, stripe_width: int, profile: Profile) -> str:
    name = f"plugin={plugin} stripe-width={stripe_width}"
    for key in sorted(profile):
        name += f" {key}={profile[key]}"
    return os.path.join(base, name)


def _factory(plugin: str, profile: Profile, device=None):
    return guard_codec(registry_mod.instance().factory(plugin, dict(profile), device=device))


def create(base: str, plugin: str, stripe_width: int, profile: Profile,
           device=None) -> int:
    ec = _factory(plugin, profile, device)
    directory = corpus_dir(base, plugin, stripe_width, profile)
    os.makedirs(directory, exist_ok=True)
    content = payload_bytes(stripe_width)
    with open(os.path.join(directory, "content"), "wb") as f:
        f.write(content)
    n = ec.get_chunk_count()
    encoded = ec.encode(set(range(n)), content)
    for i, chunk in encoded.items():
        with open(os.path.join(directory, f"chunk.{i}"), "wb") as f:
            f.write(np.asarray(chunk, dtype=np.uint8).tobytes())
    print(f"created {directory}")
    return 0


def _decode_erasures(ec, erasures: set[int], encoded: dict[int, np.ndarray]) -> int:
    available = {i: c for i, c in encoded.items() if i not in erasures}
    chunk_size = len(next(iter(available.values())))
    decoded = ec.decode(set(erasures), available, chunk_size)
    for e in erasures:
        if not np.array_equal(decoded[e], encoded[e]):
            print(f"chunk {e} incorrectly recovered", file=sys.stderr)
            return 1
    return 0


def check(base: str, plugin: str, stripe_width: int, profile: Profile,
          device=None) -> int:
    ec = _factory(plugin, profile, device)
    directory = corpus_dir(base, plugin, stripe_width, profile)
    with open(os.path.join(directory, "content"), "rb") as f:
        content = f.read()
    n = ec.get_chunk_count()
    encoded = ec.encode(set(range(n)), content)
    for i in range(n):
        with open(os.path.join(directory, f"chunk.{i}"), "rb") as f:
            existing = f.read()
        now = np.asarray(encoded[i], dtype=np.uint8).tobytes()
        if existing != now:
            print(f"chunk {i} encodes differently", file=sys.stderr)
            return 1
    # single erasure: the fast/special path in most plugins
    if rc := _decode_erasures(ec, {0}, encoded):
        return rc
    if n - ec.get_data_chunk_count() > 1:
        # two erasures: the general decode path
        if rc := _decode_erasures(ec, {0, n - 1}, encoded):
            return rc
    return 0


# The standing corpus configurations: the five BASELINE.md configs plus one
# per additional implemented technique family.
STANDARD_CONFIGS: list[tuple[str, int, dict[str, str]]] = [
    ("jerasure", 4096, {"k": "4", "m": "2", "technique": "reed_sol_van"}),
    ("tpu", 4096, {"k": "8", "m": "3", "technique": "cauchy"}),
    ("tpu", 4096, {"k": "10", "m": "4", "technique": "reed_sol_van"}),
    ("clay", 8192, {"k": "8", "m": "4", "d": "11"}),
    # BASELINE.md names LRC(10,4,l=5), but the reference's own parse_kml
    # constraints ((k+m) % l == 0 and k % ((k+m)/l) == 0, ErasureCodeLrc.cc)
    # rule that shape out; the nearest valid shape keeping l=5 is (12,3,5).
    ("lrc", 4096, {"k": "12", "m": "3", "l": "5"}),
    ("jerasure", 4096, {"k": "5", "m": "2", "technique": "liberation",
                        "w": "5", "packetsize": "32"}),
    ("jerasure", 4096, {"k": "4", "m": "2", "technique": "blaum_roth",
                        "w": "6", "packetsize": "32"}),
    ("jerasure", 4096, {"k": "6", "m": "2", "technique": "liber8tion",
                        "packetsize": "32"}),
    ("shec", 4096, {"k": "4", "m": "3", "c": "2"}),
    ("xor", 4096, {"k": "4"}),
]


def run_standard(base: str, mode: str, device=None) -> int:
    rc = 0
    for plugin, stripe_width, profile in STANDARD_CONFIGS:
        fn = create if mode == "create" else check
        try:
            code = fn(base, plugin, stripe_width, dict(profile), device)
        except (EcError, OSError) as e:  # a device error passes: it ends the tool
            print(f"{plugin} {profile}: {e}", file=sys.stderr)
            code = 1
        if code:
            print(f"FAIL: {plugin} {profile}", file=sys.stderr)
            rc = 1
    return rc


@exits_on_device_error("ec_corpus")
def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--create", action="store_true")
    ap.add_argument("--check", action="store_true")
    ap.add_argument("--base", default=".")
    ap.add_argument("--plugin", "-p", default="jerasure")
    ap.add_argument("--stripe-width", "-s", type=int, default=4096)
    ap.add_argument(
        "--parameter", "-P", action="append", default=[], metavar="K=V"
    )
    ap.add_argument(
        "--standard",
        action="store_true",
        help="run the standing corpus configuration list instead of one profile",
    )
    ap.add_argument("--device", default=None,
                    help="the codecs' device: cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not (args.create or args.check):
        ap.error("must specify either --check or --create")
    if args.standard:
        if args.parameter or args.plugin != "jerasure" or args.stripe_width != 4096:
            ap.error(
                "--standard runs the fixed STANDARD_CONFIGS list; it cannot "
                "be combined with --plugin/--stripe-width/-P"
            )
        rc = 0
        if args.create:
            rc |= run_standard(args.base, "create", args.device)
        if args.check:
            rc |= run_standard(args.base, "check", args.device)
        return rc
    profile: Profile = {}
    for p in args.parameter:
        if "=" not in p:
            ap.error(f"--parameter {p} needs K=V")
        key, val = p.split("=", 1)
        profile[key] = val
    rc = 0
    if args.create:
        rc |= create(args.base, args.plugin, args.stripe_width, profile, args.device)
    if args.check:
        rc |= check(args.base, args.plugin, args.stripe_width, profile, args.device)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
