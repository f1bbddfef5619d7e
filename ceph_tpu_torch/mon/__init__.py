"""The monitor side the OSD daemon needs: the monitor map and `MonClient`.

The monitor itself (Paxos, the OSDMonitor, the config and log services)
is not part of the port yet."""

from .client import MonClient
from .monmap import MonMap

__all__ = ["MonClient", "MonMap"]
