"""cls_version — object version counters with guards
(src/cls/version/cls_version.cc; RGW builds bucket-index consistency on
it).  Version = (ver: u64, tag: str) in xattr "ver"."""

from __future__ import annotations

import json

from ..common.errs import ECANCELED, EINVAL
from .objclass import RD, WR, ClsError, HCtx, cls_method

ATTR = "ver"


def _read(ctx: HCtx) -> dict:
    raw = ctx.getxattr(ATTR)
    return json.loads(raw.decode()) if raw else {"ver": 0, "tag": ""}


@cls_method("version", "set", RD | WR)
def set_(ctx: HCtx, indata: bytes) -> bytes:
    req = json.loads(indata.decode())
    ctx.setxattr(ATTR, json.dumps(
        {"ver": int(req["ver"]), "tag": req.get("tag", "")}
    ).encode())
    return b""


@cls_method("version", "inc", RD | WR)
def inc(ctx: HCtx, indata: bytes) -> bytes:
    v = _read(ctx)
    v["ver"] += 1
    ctx.setxattr(ATTR, json.dumps(v).encode())
    return json.dumps(v).encode()


@cls_method("version", "read", RD)
def read(ctx: HCtx, indata: bytes) -> bytes:
    return json.dumps(_read(ctx)).encode()


@cls_method("version", "check", RD)
def check(ctx: HCtx, indata: bytes) -> bytes:
    """Guard (cls_version check_conds): -ECANCELED unless the stored
    version satisfies every condition (eq | gt | ge vs `ver`)."""
    req = json.loads(indata.decode())
    have = _read(ctx)["ver"]
    want = int(req["ver"])
    op = req.get("cond", "eq")
    ok = {"eq": have == want, "gt": have > want, "ge": have >= want}.get(op)
    if ok is None:
        # malformed input, NOT a guard mismatch: retry loops keyed on
        # -ECANCELED must be able to tell the two apart
        raise ClsError(EINVAL, f"unknown cond {op!r}")
    if not ok:
        raise ClsError(ECANCELED, f"version {have} fails {op} {want}")
    return b""
