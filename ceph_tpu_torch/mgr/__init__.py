"""Manager daemon and its module runtime (src/mgr + src/pybind/mgr): the
port's copy of the daemon (`Mgr`: beacons and standby failover, the
DaemonServer state that `MMgrReport`s feed, the PGMap digest the monitors
serve as `df` and health), of the module base (`MgrModule`) and of the
modules: prometheus, iostat, progress, metrics_history, clog, balancer,
pg_autoscaler, telemetry, dashboard and orchestrator."""

from .clog import ClogModule
from .dashboard import DashboardModule
from .iostat import IostatModule
from .metrics_history import MetricsHistoryModule
from .mgr import Mgr
from .modules import MgrModule
from .orchestrator import OrchBackend, OrchestratorModule, ServiceSpec
from .progress import ProgressModule
from .telemetry import TelemetryModule

__all__ = [
    "ClogModule",
    "DashboardModule",
    "IostatModule",
    "MetricsHistoryModule",
    "Mgr",
    "MgrModule",
    "OrchBackend",
    "OrchestratorModule",
    "ProgressModule",
    "ServiceSpec",
    "TelemetryModule",
]
