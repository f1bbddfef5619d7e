"""cls_refcount — reference counting for shared objects
(src/cls/refcount/cls_refcount.cc; RGW dedupes tail objects with it):
put/get tags; when the last tag drops, the object deletes itself."""

from __future__ import annotations

import json

from ..common.errs import EINVAL, ENOENT
from .objclass import RD, WR, ClsError, HCtx, cls_method

ATTR = "refcount"


def _refs(ctx: HCtx) -> list[str]:
    raw = ctx.getxattr(ATTR)
    return json.loads(raw.decode()) if raw else []


@cls_method("refcount", "get", RD | WR)
def get(ctx: HCtx, indata: bytes) -> bytes:
    """Take a reference (tag must be unique per referrer)."""
    tag = json.loads(indata.decode())["tag"]
    if not tag:
        raise ClsError(EINVAL, "empty tag")
    refs = _refs(ctx)
    if tag not in refs:
        refs.append(tag)
    ctx.setxattr(ATTR, json.dumps(refs).encode())
    return b""


@cls_method("refcount", "put", RD | WR)
def put(ctx: HCtx, indata: bytes) -> bytes:
    """Drop a reference; reports whether the object should be reaped
    (the reference class deletes it server-side; here the caller issues
    the delete on {"last": true} — same two-phase shape RGW gc uses)."""
    tag = json.loads(indata.decode())["tag"]
    refs = _refs(ctx)
    if tag not in refs:
        raise ClsError(ENOENT, f"tag {tag!r} holds no reference")
    refs.remove(tag)
    if refs:
        ctx.setxattr(ATTR, json.dumps(refs).encode())
        return json.dumps({"last": False}).encode()
    ctx.rmxattr(ATTR)
    return json.dumps({"last": True}).encode()


@cls_method("refcount", "read", RD)
def read(ctx: HCtx, indata: bytes) -> bytes:
    return json.dumps(_refs(ctx)).encode()
