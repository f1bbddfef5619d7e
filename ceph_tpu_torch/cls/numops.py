"""cls_numops — server-side arithmetic on xattr-stored numbers
(src/cls/numops/cls_numops.cc): read-modify-write WITHOUT a client
round trip, the class-family's canonical example."""

from __future__ import annotations

import json

from ..common.errs import EINVAL
from .objclass import RD, WR, ClsError, HCtx, cls_method


def _apply(ctx: HCtx, indata: bytes, op) -> bytes:
    req = json.loads(indata.decode())
    key, operand = req["key"], float(req["value"])
    raw = ctx.getxattr(key)
    try:
        current = float(raw.decode()) if raw else 0.0
    except ValueError:
        raise ClsError(EINVAL, f"xattr {key!r} is not numeric") from None
    result = op(current, operand)
    # integers stay integers (the reference stores decimal strings too)
    if result == int(result):
        result = int(result)
    out = repr(result).encode()
    ctx.setxattr(key, out)
    return out


@cls_method("numops", "add", RD | WR)
def add(ctx: HCtx, indata: bytes) -> bytes:
    return _apply(ctx, indata, lambda a, b: a + b)


@cls_method("numops", "sub", RD | WR)
def sub(ctx: HCtx, indata: bytes) -> bytes:
    return _apply(ctx, indata, lambda a, b: a - b)


@cls_method("numops", "mul", RD | WR)
def mul(ctx: HCtx, indata: bytes) -> bytes:
    return _apply(ctx, indata, lambda a, b: a * b)


@cls_method("numops", "div", RD | WR)
def div(ctx: HCtx, indata: bytes) -> bytes:
    def _div(a: float, b: float) -> float:
        if b == 0:
            raise ClsError(EINVAL, "division by zero")
        return a / b

    return _apply(ctx, indata, _div)
