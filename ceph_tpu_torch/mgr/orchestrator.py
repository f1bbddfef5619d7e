"""orchestrator mgr module — mirror of src/pybind/mgr/orchestrator + a
local backend (the cephadm-analog).

The reference splits orchestration into an interface module (the `orch`
command family: ps, device ls, apply) and pluggable backends (cephadm,
rook) that realize desired state.  Same split here: OrchestratorModule
holds SERVICE SPECS (desired state) and reconciles them each tick
against observed daemons through a registered backend.  The in-process
backend (tests, vstart) spawns/stops daemon objects; a production
backend would shell out, exactly like cephadm does.

The port's copy of `ceph_tpu/mgr/orchestrator.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ServiceSpec:
    """Desired state for one service (python-common ServiceSpec)."""

    service_type: str  # "osd" | "mon" | "mgr" | "mds"
    count: int = 1
    unmanaged: bool = False
    extra: dict = field(default_factory=dict)

    @property
    def service_name(self) -> str:
        return self.service_type


class OrchBackend:
    """Backend interface (orchestrator._interface.Orchestrator): realize
    desired daemon counts.  Implementations own daemon lifecycle."""

    async def scale(self, service_type: str, current: int, target: int) -> None:
        raise NotImplementedError

    def inventory(self) -> list[dict]:
        """Host/device inventory (orch device ls)."""
        return []


from .modules import MgrModule


class OrchestratorModule(MgrModule):
    NAME = "orchestrator"

    SCALE_BACKOFF = 5.0  # seconds between scale attempts per service
    MAX_EVENTS = 100

    def __init__(self):
        super().__init__()
        self.specs: dict[str, ServiceSpec] = {}
        self.backend: OrchBackend | None = None
        self._reconciling = False
        self._last_scale: dict[str, float] = {}
        self.events: list[str] = []  # orch status history (bounded, deduped)

    def set_backend(self, backend: OrchBackend) -> None:
        self.backend = backend

    # -- orch command surface (orchestrator_cli) -----------------------------

    def apply(self, spec: ServiceSpec) -> str:
        """`orch apply <type> --count N` — record desired state; the
        reconcile loop realizes it."""
        self.specs[spec.service_name] = spec
        return f"Scheduled {spec.service_name} update (count {spec.count})"

    def ps(self) -> list[dict]:
        """`orch ps` — observed daemons."""
        out = []
        for osd, info in sorted(self.mgr.osdmap.osds.items()):
            out.append(
                {
                    "daemon_type": "osd",
                    "daemon_id": str(osd),
                    "status": "running" if info.up else "stopped",
                    "addr": info.addr,
                }
            )
        for d in self.mgr.list_daemons():
            kind, _, ident = d.partition(".")
            if kind != "osd":
                out.append(
                    {"daemon_type": kind, "daemon_id": ident, "status": "running"}
                )
        return out

    def device_ls(self) -> list[dict]:
        return self.backend.inventory() if self.backend else []

    def observed_count(self, service_type: str) -> int:
        if service_type == "osd":
            return sum(1 for i in self.mgr.osdmap.osds.values() if i.up)
        return sum(
            1 for d in self.mgr.list_daemons() if d.startswith(service_type + ".")
        )

    # -- reconcile loop (cephadm serve()) ------------------------------------

    def _event(self, msg: str) -> None:
        """Append deduped (vs the latest entry) and bounded — persistent
        drift must not grow the log or spam one line per tick."""
        if not self.events or self.events[-1] != msg:
            self.events.append(msg)
            if len(self.events) > self.MAX_EVENTS:
                del self.events[: -self.MAX_EVENTS]

    async def reconcile(self) -> None:
        if self.backend is None or self._reconciling:
            return
        import asyncio

        now = asyncio.get_event_loop().time()
        self._reconciling = True
        try:
            for spec in list(self.specs.values()):
                if spec.unmanaged:
                    continue
                have = self.observed_count(spec.service_type)
                if have == spec.count:
                    self._last_scale.pop(spec.service_name, None)
                    continue
                # Backoff between attempts: drift the backend cannot close
                # (e.g. a down daemon it can't replace) must not trigger a
                # scale call every 1-second tick.
                last = self._last_scale.get(spec.service_name, 0.0)
                if now - last < self.SCALE_BACKOFF:
                    continue
                self._last_scale[spec.service_name] = now
                self._event(
                    f"scaling {spec.service_name}: {have} -> {spec.count}"
                )
                await self.backend.scale(spec.service_type, have, spec.count)
        finally:
            self._reconciling = False

    async def tick(self) -> None:  # driven by the mgr module loop
        await self.reconcile()
