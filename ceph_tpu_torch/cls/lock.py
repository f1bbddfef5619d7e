"""cls_lock — advisory object locks (src/cls/lock/cls_lock.cc).

Lock state lives in the object xattr "lock.<name>": a JSON record of
type (exclusive | shared) and holders [(entity, cookie, description)].
Semantics mirrored from the reference:

- `lock`: acquire; -EBUSY when held incompatibly; re-acquiring YOUR OWN
  (entity, cookie) succeeds (renewal, cls_lock.cc lock_obj).
- `unlock`: release (entity, cookie); -ENOENT when not held by you.
- `break_lock`: forcibly drop ANOTHER entity's hold (the recovery path
  rbd mirroring uses when a holder dies).
- `get_info`: dump holders.

RBD image exclusive ownership and mirroring fencing build on exactly
this class in the reference (librbd ManagedLock).
"""

from __future__ import annotations

import json

from ..common.errs import EBUSY, ENOENT
from .objclass import RD, WR, ClsError, HCtx, cls_method

LOCK_PREFIX = "lock."

EXCLUSIVE = "exclusive"
SHARED = "shared"


def _state(ctx: HCtx, name: str) -> dict:
    raw = ctx.getxattr(LOCK_PREFIX + name)
    if not raw:
        return {"type": "", "holders": []}
    return json.loads(raw.decode())


def _store(ctx: HCtx, name: str, st: dict) -> None:
    if st["holders"]:
        ctx.setxattr(LOCK_PREFIX + name, json.dumps(st).encode())
    else:
        ctx.rmxattr(LOCK_PREFIX + name)


@cls_method("lock", "lock", RD | WR)
def lock(ctx: HCtx, indata: bytes) -> bytes:
    req = json.loads(indata.decode())
    name, ltype = req["name"], req.get("type", EXCLUSIVE)
    cookie, desc = req.get("cookie", ""), req.get("description", "")
    st = _state(ctx, name)
    me = [ctx.entity, cookie]
    holders = st["holders"]
    if holders:
        if me in [h[:2] for h in holders]:
            # renewal of our own hold; escalation (shared -> exclusive)
            # only when we are the SOLE holder, else the
            # exclusive-implies-single-holder invariant would break
            if ltype != st["type"] and len(holders) > 1:
                raise ClsError(EBUSY, f"lock {name} held shared by others")
        elif st["type"] == SHARED and ltype == SHARED:
            pass  # compatible share
        else:
            raise ClsError(EBUSY, f"lock {name} held")
    if me not in [h[:2] for h in holders]:
        holders.append([ctx.entity, cookie, desc])
    st["type"] = ltype
    _store(ctx, name, st)
    return b""


@cls_method("lock", "unlock", RD | WR)
def unlock(ctx: HCtx, indata: bytes) -> bytes:
    req = json.loads(indata.decode())
    name, cookie = req["name"], req.get("cookie", "")
    st = _state(ctx, name)
    before = len(st["holders"])
    st["holders"] = [
        h for h in st["holders"] if h[:2] != [ctx.entity, cookie]
    ]
    if len(st["holders"]) == before:
        raise ClsError(ENOENT, f"lock {name} not held by caller")
    _store(ctx, name, st)
    return b""


@cls_method("lock", "break_lock", RD | WR)
def break_lock(ctx: HCtx, indata: bytes) -> bytes:
    req = json.loads(indata.decode())
    name = req["name"]
    victim = [req["entity"], req.get("cookie", "")]
    st = _state(ctx, name)
    before = len(st["holders"])
    st["holders"] = [h for h in st["holders"] if h[:2] != victim]
    if len(st["holders"]) == before:
        raise ClsError(ENOENT, f"no such holder on {name}")
    _store(ctx, name, st)
    return b""


@cls_method("lock", "get_info", RD)
def get_info(ctx: HCtx, indata: bytes) -> bytes:
    name = json.loads(indata.decode())["name"]
    return json.dumps(_state(ctx, name)).encode()
