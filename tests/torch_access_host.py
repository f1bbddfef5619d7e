"""What the access layers' differentials share: a cluster of either
package's daemons, a `Rados` on it with its clocks and ids pinned and
its `MOSDOp`s recorded, and a small HTTP client.

Pinned alike in both packages, so that what the two runs send and store
can be compared byte for byte:

- the Objecter's `time.monotonic` at `t0`, taken once a test from the
  real clock an hour ahead of it (`pinned_t0`): the op's deadline rides
  the MOSDOp, and each OSD compares it with its own clock at admission;
- the Objecter's reqid nonce (`secrets.token_hex`, a constant), and the
  `secrets` of `rbd.rbd` and `rgw.rgw` (a counter), so RBD image ids,
  lock cookies, RGW keys, version and upload ids are the same in both
  runs and distinct within one; `swift_server` pins Swift's token key;
- `time.time` in the modules that stamp records (`rgw.rgw`,
  `rgw.swift`): a wall time taken once a test (`pinned_wall`),
  whole minutes, so a request's `Date` made from it is the same in both
  runs and within the S3 front end's 15 minutes of the real clock.
"""

from __future__ import annotations

import asyncio
import importlib
import itertools
import time
from email.utils import formatdate
from types import SimpleNamespace

from test_torch_osd import ROOT, make_cluster, settle  # noqa: F401 (re-exported)
from torch_daemon_host import CLIENT

PIN_AHEAD_S = 3600.0


def pinned_t0(ahead: float = PIN_AHEAD_S) -> float:
    """The Objecter's pinned clock: the real monotonic clock, `ahead`
    seconds on."""
    return time.monotonic() + ahead


def pinned_wall() -> float:
    """The stamping modules' pinned wall clock: now, in whole minutes."""
    return float(int(time.time()) // 60 * 60)


def http_date(wall: float) -> str:
    return formatdate(wall, usegmt=True)


def pin(pkg: str, monkeypatch, t0: float, wall: float) -> None:
    """Pin the clocks and ids named in the module docstring, afresh for
    one package's run."""
    root = ROOT[pkg]
    monkeypatch.setattr(importlib.import_module(f"{root}.client.objecter"), "time",
                        SimpleNamespace(monotonic=lambda: t0))
    for mod in ("rgw.rgw", "rgw.swift"):
        monkeypatch.setattr(importlib.import_module(f"{root}.{mod}"), "time",
                            SimpleNamespace(time=lambda: wall))
    monkeypatch.setattr("secrets.token_hex", lambda n=32: "c1" * n)
    count = itertools.count(1)
    ids = SimpleNamespace(token_hex=lambda n=32: f"{next(count):0{2 * n}x}")
    for mod in ("rbd.rbd", "rgw.rgw"):
        monkeypatch.setattr(importlib.import_module(f"{root}.{mod}"), "secrets", ids)


def swift_server(pkg: str, gw, monkeypatch):
    """The package's `SwiftServer` over `gw`, its token key pinned (it
    draws `secrets.token_bytes` when made; cephx draws it too, so the pin
    lasts only while the server is made)."""
    swift = importlib.import_module(f"{ROOT[pkg]}.rgw.swift")
    with monkeypatch.context() as mp:
        mp.setattr("secrets.token_bytes", lambda n=32: bytes(range(n)))
        return swift.SwiftServer(gw)


async def connect(pkg: str, c) -> tuple:
    """A `Rados` of the package as `client.admin` on cluster `c`, and the
    list its Objecter's `MOSDOp`s are appended to as sent (encoded)."""
    root = ROOT[pkg]
    rados_mod = importlib.import_module(f"{root}.client.rados")
    encode_message = importlib.import_module(f"{root}.msg.message").encode_message
    MOSDOp = importlib.import_module(f"{root}.msg.messages").MOSDOp
    r = rados_mod.Rados(c.monmap, name=CLIENT, secret=c.keyring.get(CLIENT), stack="inproc")
    await r.connect()
    sent = []
    send_to = r.objecter.msgr.send_to

    async def recording(addr, msg):
        await send_to(addr, msg)
        if isinstance(msg, MOSDOp):
            sent.append(encode_message(msg))

    r.objecter.msgr.send_to = recording
    return r, sent


async def http(addr: str, method: str, path: str, headers: dict | None = None,
               body: bytes = b"") -> tuple:
    """One HTTP/1.1 request: (status line, headers in order, body)."""
    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        head = [f"{method} {path} HTTP/1.1", f"Host: {addr}"]
        head += [f"{k}: {v}" for k, v in (headers or {}).items()]
        if body or method in ("PUT", "POST"):
            head.append(f"Content-Length: {len(body)}")
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
        await writer.wait_closed()
    top, _, payload = raw.partition(b"\r\n\r\n")
    lines = top.decode().split("\r\n")
    status = lines[0].split(" ", 1)[1]
    hdrs = [tuple(x.strip() for x in line.split(":", 1)) for line in lines[1:]]
    return status, hdrs, payload
