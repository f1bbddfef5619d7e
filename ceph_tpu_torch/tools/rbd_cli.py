"""rbd CLI — mirror of src/tools/rbd (image admin commands).

Targets a running cluster via the vstart cluster file:

    python -m ceph_tpu_torch.tools.rbd_cli -p rbdpool create vol1 --size 4194304
    python -m ceph_tpu_torch.tools.rbd_cli -p rbdpool snap create vol1@s1
    python -m ceph_tpu_torch.tools.rbd_cli -p rbdpool clone vol1@s1 vol2
    python -m ceph_tpu_torch.tools.rbd_cli -p rbdpool info vol2

Image@snap arguments use the reference's `image@snap` spelling.

The port's copy of `ceph_tpu/tools/rbd_cli.py`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ..client import Rados
from ..client.rados import RadosError
from ..rbd import RBD, RbdError
from .vstart import CLUSTER_FILE, load_monmap


def _split_spec(spec: str) -> tuple[str, str]:
    image, _, snap = spec.partition("@")
    return image, snap


async def _run(args) -> int:
    client = Rados(load_monmap(args.cluster_file), name="client.rbd-cli")
    await client.connect()
    try:
        words = args.words
        op = words[0]

        def need(n: int, usage: str) -> None:
            if len(words) < n:
                raise RbdError(22, f"usage: {usage}")

        try:
            ioctx = await client.open_ioctx(args.pool)
            rbd = RBD(ioctx)
            if op in ("create", "resize") and args.size is None:
                # an implicit default here could silently SHRINK an image
                print(f"rbd: {op} requires an explicit --size", file=sys.stderr)
                return 1
            if op == "create":
                need(2, "create <image> --size N")
                await rbd.create(words[1], args.size, order=args.order)
                print(f"created {words[1]} ({args.size} bytes)")
            elif op in ("ls", "list"):
                for name in await rbd.list():
                    print(name)
            elif op in ("rm", "remove"):
                need(2, "rm <image>")
                await rbd.remove(words[1])
            elif op == "info":
                need(2, "info <image>")
                img = await rbd.open(words[1])
                info = {
                    "name": img.name,
                    "id": img.id,
                    "size": img.size,
                    "order": img.order,
                    "snapshots": await img.snap_list(),
                }
                if img.header.get("parent"):
                    p = img.header["parent"]
                    info["parent"] = f"{p['image_name']}@{p['snap_name']}"
                    info["overlap"] = p["overlap"]
                print(json.dumps(info, indent=2))
            elif op == "resize":
                need(2, "resize <image> --size N")
                img = await rbd.open(words[1])
                await img.resize(args.size)
            elif op == "export":
                need(3, "export <image[@snap]> <file>")
                image, snap = _split_spec(words[1])
                img = await rbd.open(image)
                data = await img.export(snap_name=snap or None)
                with open(words[2], "wb") as f:
                    f.write(data)
                print(f"exported {len(data)} bytes to {words[2]}")
            elif op == "import":
                need(3, "import <file> <image>")
                with open(words[1], "rb") as f:
                    data = f.read()
                await rbd.create(
                    words[2], len(data),
                    order=args.order,
                )
                img = await rbd.open(words[2])
                await img.import_bytes(data)
                print(f"imported {len(data)} bytes as {words[2]}")
            elif op == "cp":
                need(3, "cp <src[@snap]> <dst>")
                src_name, snap = _split_spec(words[1])
                src = await rbd.open(src_name)
                data = await src.export(snap_name=snap or None)
                await rbd.create(words[2], len(data), order=src.order)
                dst = await rbd.open(words[2])
                await dst.import_bytes(data)
            elif op == "clone":
                need(3, "clone <parent@snap> <child>")
                parent, snap = _split_spec(words[1])
                await rbd.clone(parent, snap, words[2])
                print(f"cloned {words[1]} -> {words[2]}")
            elif op == "flatten":
                need(2, "flatten <image>")
                img = await rbd.open(words[1])
                await img.flatten()
            elif op == "children":
                need(2, "children <parent@snap>")
                parent, snap = _split_spec(words[1])
                for child in await rbd.children(parent, snap):
                    print(child)
            elif op == "snap":
                need(3, "snap <create|rm|ls|rollback|protect|unprotect> <image[@snap]>")
                sub = words[1]
                image, snap = _split_spec(words[2])
                img = await rbd.open(image)
                if sub == "create":
                    await img.snap_create(snap)
                elif sub in ("rm", "remove"):
                    await img.snap_remove(snap)
                elif sub == "ls":
                    for name in await img.snap_list():
                        print(name)
                elif sub == "rollback":
                    await img.snap_rollback(snap)
                elif sub == "protect":
                    await img.snap_protect(snap)
                elif sub == "unprotect":
                    await img.snap_unprotect(snap)
                else:
                    print(f"unknown snap op {sub!r}", file=sys.stderr)
                    return 1
            elif op == "lock":
                need(3, "lock <ls|rm> <image> [entity cookie]")
                sub, image = words[1], words[2]
                img = await rbd.open(image)
                if sub == "ls":
                    for holder in await img.lock_owners():
                        print(json.dumps(holder))
                elif sub == "rm":
                    need(5, "lock rm <image> <entity> <cookie>")
                    await img.break_lock(words[3], words[4])
                else:
                    print(f"unknown lock op {sub!r}", file=sys.stderr)
                    return 1
            else:
                print(f"unknown op {op!r}", file=sys.stderr)
                return 1
        except RbdError as e:
            print(f"rbd: {e}", file=sys.stderr)
            return 1
        except RadosError as e:
            print(f"rbd: {e}", file=sys.stderr)
            return 1
        return 0
    finally:
        await client.shutdown()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-p", "--pool", required=True)
    p.add_argument("--cluster-file", default=CLUSTER_FILE)
    p.add_argument(
        "--size", type=int, default=None,
        help="bytes; REQUIRED for create/resize",
    )
    p.add_argument("--order", type=int, default=22)
    p.add_argument(
        "words", nargs="+",
        help="create|ls|rm|info|resize|clone|flatten|children|snap <op> "
        "<image[@snap]>|lock <op> <image>",
    )
    sys.exit(asyncio.run(_run(p.parse_args())))


if __name__ == "__main__":
    main()
