"""cls_log — timestamped log entries in an object's omap.

Mirror of src/cls/log/cls_log.cc: RGW's metadata/data logs append
entries keyed `1_<sec>.<usec>_<counter>` into omap; readers page with a
from/to window + marker, and trim deletes a prefix window.  This is also
the first omap-backed class in the tree, exercising the cls_cxx_map_*
surface end to end (the reference's bucket index lives on the same
substrate).

Input/output are JSON blobs (the dynamic shape of the reference's
cls_log_ops.h structs).

The port's copy of `ceph_tpu/cls/log.py`.
"""

from __future__ import annotations

import json

from .objclass import RD, WR, ClsError, HCtx, cls_method
from ..common.errs import EINVAL

MAX_TRIM = 1000  # cls_log trims in bounded chunks, as the reference does


def _ts_prefix(ts: float) -> str:
    sec = int(ts)
    usec = round((ts - sec) * 1e6)
    return f"1_{sec:011d}.{usec:06d}"


def _key(ts: float, counter: int) -> str:
    return f"{_ts_prefix(ts)}_{counter:010d}"


@cls_method("log", "add", WR)
def add(ctx: HCtx, indata: bytes) -> bytes:
    """{"entries": [{"ts": float, "section": str, "name": str,
    "data": str}]} — each entry lands under its timestamp key."""
    req = json.loads(indata.decode())
    entries = req.get("entries")
    if not isinstance(entries, list) or not entries:
        raise ClsError(EINVAL, "no entries")
    # counter disambiguates same-timestamp appends; continue from the
    # current key population so replayed adds keep monotonic keys
    counter = len(ctx.map_get_keys()) if ctx.exists() else 0
    for e in entries:
        key = _key(float(e["ts"]), counter)
        counter += 1
        ctx.map_set_val(key, json.dumps(e).encode())
    return b""


@cls_method("log", "list", RD)
def list_(ctx: HCtx, indata: bytes) -> bytes:
    """{"from": ts, "to": ts, "marker": str, "max": n} ->
    {"entries": [...], "marker": str, "truncated": bool}"""
    req = json.loads(indata.decode() or "{}")
    lo = _key(float(req.get("from", 0)), 0)
    to = req.get("to", 0)
    hi = _key(float(to), 0) if to else "2"  # "2" > every "1_..." key
    marker = req.get("marker", "")
    limit = int(req.get("max", 100))
    omap = ctx.map_get_all()
    keys = sorted(k for k in omap if lo <= k < hi)
    if marker:
        keys = [k for k in keys if k > marker]
    page = keys[:limit]
    out = [json.loads(omap[k].decode()) for k in page]
    return json.dumps(
        {
            "entries": out,
            "marker": page[-1] if page else marker,
            "truncated": len(keys) > limit,
        }
    ).encode()


@cls_method("log", "trim", WR)
def trim(ctx: HCtx, indata: bytes) -> bytes:
    """{"to": ts} — drop entries at or before the timestamp (bounded per
    call; callers loop, as RGW's log trimmer does)."""
    req = json.loads(indata.decode() or "{}")
    pfx = _ts_prefix(float(req.get("to", 0)))
    # "at or before `to`": timestamp-prefix comparison sidesteps float
    # rounding at the boundary (the counter suffix never participates)
    doomed = [
        k for k in ctx.map_get_keys() if k[: len(pfx)] <= pfx
    ][:MAX_TRIM]
    if not doomed:
        from ..common.errs import ENODATA

        raise ClsError(ENODATA, "nothing to trim")
    for k in doomed:
        ctx.map_remove_key(k)
    return b""
