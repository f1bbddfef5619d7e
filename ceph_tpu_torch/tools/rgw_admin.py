"""radosgw-admin CLI — mirror of src/rgw/rgw_admin.cc (the admin tool).

Operates directly on the gateway's RADOS state (users, buckets, index,
lifecycle), like the reference tool does through RGWRados:

    python -m ceph_tpu_torch.tools.rgw_admin -p rgwpool user create --uid alice
    python -m ceph_tpu_torch.tools.rgw_admin -p rgwpool user info --uid alice
    python -m ceph_tpu_torch.tools.rgw_admin -p rgwpool bucket list
    python -m ceph_tpu_torch.tools.rgw_admin -p rgwpool bucket stats --bucket b1
    python -m ceph_tpu_torch.tools.rgw_admin -p rgwpool lc process

The port's copy of `ceph_tpu/tools/rgw_admin.py`.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

from ..client import Rados
from ..rgw import ObjectGateway, RgwError
from .vstart import CLUSTER_FILE, load_monmap


async def _run(args) -> int:
    client = Rados(load_monmap(args.cluster_file), name="client.rgw-admin")
    await client.connect()
    try:
        ioctx = await client.open_ioctx(args.pool)
        gw = ObjectGateway(ioctx)
        words = args.words
        area = words[0]
        op = words[1] if len(words) > 1 else ""
        try:
            if area == "user":
                if op == "create":
                    user = await gw.create_user(
                        args.uid, display_name=args.display_name
                    )
                    print(json.dumps(user, indent=2))
                elif op == "info":
                    print(json.dumps(await gw.get_user(args.uid), indent=2))
                elif op == "list":
                    users = await gw._load("rgw.users")
                    for uid in sorted(users):
                        print(uid)
                else:
                    print(f"unknown user op {op!r}", file=sys.stderr)
                    return 1
            elif area == "bucket":
                if op == "list":
                    for b in await gw.list_buckets(
                        owner=args.uid if args.uid else None
                    ):
                        print(b)
                elif op == "stats":
                    listing = await gw.list_objects(
                        args.bucket, actor=args.uid or None, max_keys=1 << 30
                    )
                    print(
                        json.dumps(
                            {
                                "bucket": args.bucket,
                                "num_objects": len(listing["contents"]),
                                "size": sum(
                                    c["size"] for c in listing["contents"]
                                ),
                            },
                            indent=2,
                        )
                    )
                elif op == "rm":
                    await gw.delete_bucket(args.bucket)
                else:
                    print(f"unknown bucket op {op!r}", file=sys.stderr)
                    return 1
            elif area == "lc":
                if op == "process":
                    n = await gw.process_lifecycle()
                    print(f"expired {n} objects")
                elif op == "list":
                    buckets = await gw._load("rgw.buckets")
                    for b, info in sorted(buckets.items()):
                        for rule in info.get("lifecycle", []):
                            print(json.dumps({"bucket": b, **rule}))
                else:
                    print(f"unknown lc op {op!r}", file=sys.stderr)
                    return 1
            else:
                print(f"unknown area {area!r}", file=sys.stderr)
                return 1
        except RgwError as e:
            print(f"radosgw-admin: {e}", file=sys.stderr)
            return 1
        return 0
    finally:
        await client.shutdown()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-p", "--pool", required=True)
    p.add_argument("--cluster-file", default=CLUSTER_FILE)
    p.add_argument("--uid", default="")
    p.add_argument("--display-name", default="")
    p.add_argument("--bucket", default="")
    p.add_argument(
        "words", nargs="+",
        help="user <create|info|list> | bucket <list|stats|rm> | "
        "lc <process|list>",
    )
    sys.exit(asyncio.run(_run(p.parse_args())))


if __name__ == "__main__":
    main()
