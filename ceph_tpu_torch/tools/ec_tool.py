"""ceph-erasure-code-tool equivalent — file-level encode/decode CLI.

The port of `ceph_tpu/tools/ec_tool.py`, the mirror of Ceph's
src/tools/erasure-code/ceph-erasure-code-tool.cc, whose command surface (and
the byte-identity test harness built on it,
src/test/ceph-erasure-code-tool/test_ceph-erasure-code-tool.sh) is the model
for the parity checks:

  test-plugin-exists <plugin>
  validate-profile   <profile> [chunk_count|data_chunk_count|coding_chunk_count]
  calc-chunk-size    <profile> <object_size>
  encode             <profile> <stripe_unit> <want_to_encode> <file>
  decode             <profile> <stripe_unit> <want_to_read>   <file>

Profiles are comma-separated k=v lists (e.g. "plugin=tpu,technique=cauchy,
k=4,m=2").  encode reads <file> and writes <file>.<chunk> per requested
chunk; decode reads <file>.<chunk> fragments and writes <file>.decoded.

The codecs run on `--device` (given before the command), `cuda` unless
`--device cpu` is asked for, under the device guard
(`tools/guarded.py`); a device error exits with DEVICE_ERROR_EXIT.

  python -m ceph_tpu_torch.tools.ec_tool encode plugin=tpu,k=8,m=3 4096 "" obj
  python -m ceph_tpu_torch.tools.ec_tool --device cpu decode plugin=tpu,k=8,m=3 4096 "" obj
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from ..codec import registry as registry_mod
from ..codec.interface import EcError, Profile
from .guarded import exits_on_device_error, guard_codec


def parse_profile(text: str) -> tuple[str, Profile]:
    profile: Profile = {}
    for token in text.split(","):
        token = token.strip()
        if not token:
            continue
        if "=" not in token:
            raise SystemExit(f"invalid profile token {token!r} (need k=v)")
        key, val = token.split("=", 1)
        profile[key] = val
    plugin = profile.pop("plugin", "tpu")
    return plugin, profile


def make_codec(text: str, device=None):
    """The profile's codec on `device` (None: cuda), under the guard."""
    plugin, profile = parse_profile(text)
    return guard_codec(registry_mod.instance().factory(plugin, profile, device=device))


def cmd_test_plugin_exists(args) -> int:
    try:
        registry_mod.instance().load(args.plugin)
        return 0
    except EcError as e:
        print(e, file=sys.stderr)
        return 1


def cmd_validate_profile(args) -> int:
    try:
        ec = make_codec(args.profile, args.device)
    except EcError as e:
        print(e, file=sys.stderr)
        return 1
    if args.quantity:
        values = {
            "chunk_count": ec.get_chunk_count(),
            "data_chunk_count": ec.get_data_chunk_count(),
            "coding_chunk_count": ec.get_coding_chunk_count(),
        }
        if args.quantity not in values:
            print(f"unknown quantity {args.quantity}", file=sys.stderr)
            return 1
        print(values[args.quantity])
    return 0


def cmd_calc_chunk_size(args) -> int:
    ec = make_codec(args.profile, args.device)
    print(ec.get_chunk_size(args.object_size))
    return 0


def _parse_want(text: str) -> set[int]:
    return {int(x) for x in text.split(",") if x.strip() != ""}


def cmd_encode(args) -> int:
    ec = make_codec(args.profile, args.device)
    try:
        with open(args.file, "rb") as f:
            data = f.read()
    except OSError as e:
        print(e, file=sys.stderr)
        return 1
    # stripe_unit semantics: the reference aligns the object to
    # stripe_unit * k before encoding (tool stripe handling).
    k = ec.get_data_chunk_count()
    stripe_width = args.stripe_unit * k
    padded_len = -(-len(data) // stripe_width) * stripe_width
    padded = data + b"\0" * (padded_len - len(data))
    want = _parse_want(args.want) if args.want else set(range(ec.get_chunk_count()))
    chunks = ec.encode(want, padded)
    for i, chunk in sorted(chunks.items()):
        with open(f"{args.file}.{i}", "wb") as f:
            f.write(np.asarray(chunk, dtype=np.uint8).tobytes())
    return 0


def cmd_decode(args) -> int:
    ec = make_codec(args.profile, args.device)
    chunks = {}
    for i in range(ec.get_chunk_count()):
        path = f"{args.file}.{i}"
        if os.path.exists(path):
            with open(path, "rb") as f:
                chunks[i] = np.frombuffer(f.read(), dtype=np.uint8)
    want = _parse_want(args.want) if args.want else None
    try:
        if want is None:
            out = ec.decode_concat(chunks)
            with open(f"{args.file}.decoded", "wb") as f:
                f.write(out.tobytes())
        else:
            decoded = ec.decode(want, chunks)
            for i in sorted(want):
                with open(f"{args.file}.{i}.decoded", "wb") as f:
                    f.write(np.asarray(decoded[i]).tobytes())
    except EcError as e:
        print(e, file=sys.stderr)
        return 1
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="ec_tool", description=__doc__)
    p.add_argument("--device", default=None,
                   help="the codec's device: cuda (default) or cpu")
    sub = p.add_subparsers(dest="command", required=True)

    sp = sub.add_parser("test-plugin-exists")
    sp.add_argument("plugin")
    sp.set_defaults(func=cmd_test_plugin_exists)

    sp = sub.add_parser("validate-profile")
    sp.add_argument("profile")
    sp.add_argument("quantity", nargs="?")
    sp.set_defaults(func=cmd_validate_profile)

    sp = sub.add_parser("calc-chunk-size")
    sp.add_argument("profile")
    sp.add_argument("object_size", type=int)
    sp.set_defaults(func=cmd_calc_chunk_size)

    sp = sub.add_parser("encode")
    sp.add_argument("profile")
    sp.add_argument("stripe_unit", type=int)
    sp.add_argument("want")
    sp.add_argument("file")
    sp.set_defaults(func=cmd_encode)

    sp = sub.add_parser("decode")
    sp.add_argument("profile")
    sp.add_argument("stripe_unit", type=int)
    sp.add_argument("want")
    sp.add_argument("file")
    sp.set_defaults(func=cmd_decode)

    return p


@exits_on_device_error("ec_tool")
def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
