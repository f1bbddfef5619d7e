"""Manager daemon and its module runtime (src/mgr + src/pybind/mgr): the
port's copy of the daemon (`Mgr`: beacons and standby failover, the
DaemonServer state that `MMgrReport`s feed, the PGMap digest the monitors
serve as `df` and health) and of the module base (`MgrModule`).  The
modules themselves are not ported yet (ROADMAP A10b)."""

from .mgr import Mgr
from .modules import MgrModule

__all__ = ["Mgr", "MgrModule"]
