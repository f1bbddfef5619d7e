"""Mgr module base — mirror of the MgrModule surface
(src/pybind/mgr/mgr_module.py)."""

from __future__ import annotations

import asyncio


class HttpServedModule:
    """Shared HTTP/1.0 scaffold for modules exposing an endpoint (the
    cherrypy analog): subclasses implement `render(path) -> (status,
    content_type, body)` and inherit serve()/shutdown().  One copy of the
    request parse / response framing, used by prometheus and dashboard."""

    def __init__(self, port: int = 0):
        self.port = port
        self._server = None
        self.addr = ""

    def render(self, path: str) -> tuple[int, str, str]:
        raise NotImplementedError

    async def serve(self, host: str = "127.0.0.1") -> str:
        async def handle(reader, writer):
            try:
                line = await reader.readline()
                parts = line.decode("latin1").split()
                path = parts[1] if len(parts) >= 2 else "/"
                while (await reader.readline()).strip():
                    pass  # drain request headers
                status, ctype, body = self.render(path.split("?")[0])
                payload = body.encode()
                writer.write(
                    f"HTTP/1.0 {status} {'OK' if status == 200 else 'NO'}\r\n"
                    f"Content-Type: {ctype}\r\n"
                    f"Content-Length: {len(payload)}\r\n\r\n".encode()
                    + payload
                )
                await writer.drain()
            except (ConnectionError, asyncio.IncompleteReadError):
                pass
            finally:
                writer.close()

        self._server = await asyncio.start_server(handle, host, self.port)
        sock = self._server.sockets[0].getsockname()
        self.addr = f"{sock[0]}:{sock[1]}"
        return self.addr

    async def shutdown(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None


def find_module(mgr, name: str):
    """The registered module with this NAME, or None.  The one lookup
    shared by the mgr asok, the dashboard routes, and the telemetry
    envelope — modules are opt-in, so every caller decides its own
    miss behavior, but the scan lives once."""
    for module in getattr(mgr, "modules", []) or []:
        if getattr(module, "NAME", "") == name:
            return module
    return None


class MgrModule:
    """Base class modules subclass (mgr_module.py MgrModule): `tick()`
    is the `serve()` loop body, called on the ACTIVE mgr about once a
    second; `self.mgr` is the daemon handle (maps, daemon state, mon
    commands); health checks surface like the reference's
    `set_health_checks`."""

    NAME = "module"

    def __init__(self) -> None:
        self.mgr = None  # set by Mgr.register_module
        self.health_checks: dict[str, dict] = {}

    def tick(self) -> None:  # may be async
        pass

    def set_health_check(
        self,
        code: str,
        severity: str,
        summary: str,
        detail: list[str] | None = None,
    ) -> None:
        self.health_checks[code] = {
            "severity": severity,
            "summary": summary,
            "detail": list(detail or []),
        }

    def clear_health_check(self, code: str) -> None:
        self.health_checks.pop(code, None)
