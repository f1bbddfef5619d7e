"""rados CLI — mirror of src/tools/rados (put/get/rm/stat/ls/df/bench).

Targets a running cluster via the vstart cluster file:

    python -m ceph_tpu_torch.tools.rados_cli -p mypool put obj1 ./file
    python -m ceph_tpu_torch.tools.rados_cli -p mypool ls
    python -m ceph_tpu_torch.tools.rados_cli -p mypool bench 5 write

`bench` mirrors `rados bench` output shape: total writes, bandwidth,
average latency (src/tools/rados/rados.cc bench command → ObjBencher).

The port's copy of `ceph_tpu/tools/rados_cli.py`.
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time

from ..client import Rados
from .vstart import CLUSTER_FILE, load_monmap


async def _run(args) -> int:
    client = Rados(load_monmap(args.cluster_file), name=f"client.rados-cli")
    await client.connect()
    try:
        if args.op == "lspools":
            for name in await client.pool_list():
                print(name)
            return 0
        if args.op == "mkpool":
            await client.pool_create(args.pool, "replicated", size=args.size)
            print(f"pool {args.pool!r} created")
            return 0
        if args.op == "df":
            # rados df: the mon-served PGMap digest (ceph df shape)
            import json as _json

            rv, rs, out = await client.mon_command({"prefix": "df"})
            if rv:
                print(rs, file=sys.stderr)
                return 1
            digest = _json.loads(out.decode() or "{}")
            print(f"{'POOL':<20}{'STORED':>12}{'OBJECTS':>10}{'USED':>12}")
            for name, st in sorted(digest.get("pools", {}).items()):
                print(
                    f"{name:<20}{st['stored']:>12}{st['objects']:>10}"
                    f"{st['used_raw']:>12}"
                )
            print(f"total_used_raw {digest.get('total_used_raw', 0)}")
            return 0
        ioctx = await client.open_ioctx(args.pool)
        if args.op == "put":
            with open(args.args[1], "rb") as f:
                data = f.read()
            await ioctx.write_full(args.args[0], data)
            print(f"wrote {len(data)} bytes to {args.args[0]}")
        elif args.op == "get":
            data = await ioctx.read(args.args[0])
            if len(args.args) > 1:
                with open(args.args[1], "wb") as f:
                    f.write(data)
            else:
                sys.stdout.buffer.write(data)
        elif args.op == "rm":
            await ioctx.remove(args.args[0])
        elif args.op == "stat":
            size = await ioctx.stat(args.args[0])
            print(f"{args.pool}/{args.args[0]} size {size}")
        elif args.op == "ls":
            for oid in await ioctx.list_objects():
                print(oid)
        elif args.op == "listwatchers":
            for w in await ioctx.list_watchers(args.args[0]):
                print(f"watcher={w['watcher']} cookie={w['cookie']}")
        elif args.op == "listomapkeys":
            for k in await ioctx.omap_get_keys(args.args[0]):
                print(k)
        elif args.op == "listomapvals":
            for k, v in sorted((await ioctx.omap_get_vals(args.args[0])).items()):
                print(f"{k}\n       value ({len(v)} bytes) :")
                sys.stdout.buffer.write(v + b"\n")
        elif args.op == "setomapval":
            await ioctx.omap_set(
                args.args[0], {args.args[1]: args.args[2].encode()}
            )
        elif args.op == "rmomapkey":
            await ioctx.omap_rm_keys(args.args[0], [args.args[1]])
        elif args.op == "clearomap":
            await ioctx.omap_clear(args.args[0])
        elif args.op == "cache-flush":
            # rados cache-flush: write a dirty cache-tier object back
            await ioctx.cache_flush(args.args[0])
            print(f"flushed {args.args[0]}")
        elif args.op == "cache-evict":
            await ioctx.cache_evict(args.args[0])
            print(f"evicted {args.args[0]}")
        elif args.op == "bench":
            await _bench(ioctx, int(args.args[0]), args.args[1] if len(args.args) > 1 else "write")
        else:
            print(f"unknown op {args.op!r}", file=sys.stderr)
            return 1
        return 0
    finally:
        await client.shutdown()


async def _bench(ioctx, seconds: int, mode: str, obj_size: int = 4 << 20) -> None:
    """rados bench (ObjBencher::aio_bench, sequential here)."""
    deadline = time.monotonic() + seconds
    payload = b"\xab" * obj_size
    count = 0
    latencies = []
    if mode == "write":
        while time.monotonic() < deadline:
            t0 = time.monotonic()
            await ioctx.write_full(f"benchmark_data_{count}", payload)
            latencies.append(time.monotonic() - t0)
            count += 1
    else:  # read back what a prior write bench left, cycling over them
        existing = [
            o for o in await ioctx.list_objects() if o.startswith("benchmark_data_")
        ]
        if not existing:
            print("no benchmark objects; run a write bench first")
            return
        while time.monotonic() < deadline:
            t0 = time.monotonic()
            await ioctx.read(existing[count % len(existing)])
            latencies.append(time.monotonic() - t0)
            count += 1
    elapsed = sum(latencies) or 1e-9
    mb = count * obj_size / (1 << 20)
    print(f"Total {mode}s made:     {count}")
    print(f"{mode.capitalize()} size:            {obj_size}")
    print(f"Bandwidth (MB/sec):    {mb / elapsed:.3f}")
    print(f"Average Latency(s):    {elapsed / max(count, 1):.4f}")


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-p", "--pool", default="")
    p.add_argument("--cluster-file", default=CLUSTER_FILE)
    p.add_argument("--size", type=int, default=3, help="pool size for mkpool")
    p.add_argument(
        "op",
        help="put|get|rm|stat|ls|bench|lspools|mkpool|cache-flush|cache-evict"
        "|listomapkeys|listomapvals|setomapval|rmomapkey|clearomap",
    )
    p.add_argument("args", nargs="*")
    sys.exit(asyncio.run(_run(p.parse_args())))


if __name__ == "__main__":
    main()
