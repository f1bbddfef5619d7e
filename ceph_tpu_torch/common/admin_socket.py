"""Admin socket — mirror of src/common/admin_socket.h.

Reference: src/common/admin_socket.h:106: every daemon
listens on a unix socket; hooks register commands (`perf dump`,
`config show`, `config set`, `dump_ops_in_flight`, ...) and the `ceph
daemon <sock> <cmd>` CLI sends a JSON request `{"prefix": ...}` and reads
a JSON reply.  Implemented on asyncio; a synchronous client helper is
provided for tools/tests.
"""

from __future__ import annotations

import asyncio
import json
import os
import socket
from typing import Awaitable, Callable

from .log import dout

# A hook receives the parsed command dict and returns a JSON-serializable
# payload (AdminSocketHook::call).
Hook = Callable[[dict], object]


class AdminSocket:
    def __init__(self, path: str):
        self.path = path
        self._hooks: dict[str, tuple[Hook, str, bool]] = {}
        self._server: asyncio.AbstractServer | None = None
        # audit sink: the owning daemon wires this to its
        # cluster-log client so every MUTATING asok command lands on the
        # `audit` channel; called as audit_cb(prefix, cmd)
        self.audit_cb: Callable[[str, dict], None] | None = None
        self.register("help", lambda cmd: {
            prefix: desc for prefix, (_, desc, _m) in sorted(self._hooks.items())
        }, "list available commands")

    def register(
        self, prefix: str, hook: Hook, desc: str = "", mutating: bool = False
    ) -> None:
        """AdminSocket::register_command.  `mutating` marks commands
        that change daemon/cluster state (injectargs, fault arming,
        mark_unfound_lost, ...): they are audited through audit_cb, and
        the metrics lint's audit-discipline check enumerates them."""
        self._hooks[prefix] = (hook, desc, mutating)

    def mutating_prefixes(self) -> list[str]:
        """Commands registered as mutating (the audit-discipline lint's
        enumeration surface)."""
        return sorted(p for p, (_, _, m) in self._hooks.items() if m)

    async def start(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._server = await asyncio.start_unix_server(self._handle, path=self.path)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        if os.path.exists(self.path):
            os.unlink(self.path)

    async def _handle(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            raw = await reader.readline()
            if not raw:
                return
            try:
                cmd = json.loads(raw)
            except json.JSONDecodeError:
                cmd = {"prefix": raw.decode().strip()}
            prefix = cmd.get("prefix", "")
            entry = self._hooks.get(prefix)
            if entry is None:
                reply = {"error": f"unknown command {prefix!r}"}
            else:
                hook, _, mutating = entry
                if mutating and self.audit_cb is not None:
                    try:
                        self.audit_cb(prefix, cmd)
                    except Exception as e:
                        # auditing must never block the command itself
                        dout("asok", 1, f"audit hook failed for {prefix!r}: {e}")
                try:
                    result = hook(cmd)
                    if asyncio.iscoroutine(result):
                        result = await result
                    reply = {"result": result}
                except Exception as e:  # hook errors become error replies
                    reply = {"error": str(e)}
            writer.write(json.dumps(reply).encode() + b"\n")
            await writer.drain()
        finally:
            writer.close()


def admin_command(path: str, prefix: str, timeout: float = 5.0, **kwargs) -> object:
    """Synchronous client (the `ceph daemon <sock> <cmd>` analog)."""
    cmd = {"prefix": prefix, **kwargs}
    with socket.socket(socket.AF_UNIX, socket.SOCK_STREAM) as s:
        s.settimeout(timeout)
        s.connect(path)
        s.sendall(json.dumps(cmd).encode() + b"\n")
        buf = b""
        while not buf.endswith(b"\n"):
            chunk = s.recv(65536)
            if not chunk:
                break
            buf += chunk
    reply = json.loads(buf)
    if "error" in reply:
        raise RuntimeError(reply["error"])
    return reply["result"]
