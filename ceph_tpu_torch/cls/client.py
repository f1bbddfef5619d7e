"""Client-side class wrappers (src/cls/lock/cls_lock_client.h and
siblings): typed helpers over IoCtx.exec for the in-tree classes.

The port's copy of `ceph_tpu/cls/client.py`.
"""

from __future__ import annotations

import json


async def lock(ioctx, oid: str, name: str, *, cookie: str = "",
               lock_type: str = "exclusive", description: str = "") -> None:
    await ioctx.exec(oid, "lock", "lock", json.dumps({
        "name": name, "type": lock_type, "cookie": cookie,
        "description": description,
    }).encode())


async def unlock(ioctx, oid: str, name: str, *, cookie: str = "") -> None:
    await ioctx.exec(oid, "lock", "unlock", json.dumps(
        {"name": name, "cookie": cookie}
    ).encode())


async def break_lock(ioctx, oid: str, name: str, entity: str,
                     *, cookie: str = "") -> None:
    await ioctx.exec(oid, "lock", "break_lock", json.dumps(
        {"name": name, "entity": entity, "cookie": cookie}
    ).encode())


async def get_lock_info(ioctx, oid: str, name: str) -> dict:
    out = await ioctx.exec(oid, "lock", "get_info",
                           json.dumps({"name": name}).encode())
    return json.loads(out.decode())


async def version_inc(ioctx, oid: str) -> int:
    out = await ioctx.exec(oid, "version", "inc", b"{}")
    return int(json.loads(out.decode())["ver"])


async def version_read(ioctx, oid: str) -> int:
    out = await ioctx.exec(oid, "version", "read", b"{}")
    return int(json.loads(out.decode())["ver"])


async def version_check(ioctx, oid: str, ver: int, cond: str = "eq") -> None:
    await ioctx.exec(oid, "version", "check", json.dumps(
        {"ver": ver, "cond": cond}
    ).encode())


async def numops_add(ioctx, oid: str, key: str, value: float) -> float:
    out = await ioctx.exec(oid, "numops", "add", json.dumps(
        {"key": key, "value": value}
    ).encode())
    return float(out.decode())


async def refcount_get(ioctx, oid: str, tag: str) -> None:
    await ioctx.exec(oid, "refcount", "get", json.dumps({"tag": tag}).encode())


async def refcount_put(ioctx, oid: str, tag: str) -> bool:
    """Drop a reference; True when it was the LAST one (caller reaps)."""
    out = await ioctx.exec(oid, "refcount", "put",
                           json.dumps({"tag": tag}).encode())
    return bool(json.loads(out.decode())["last"])
