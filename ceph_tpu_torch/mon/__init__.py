"""The monitor — the port's copy of `ceph_tpu/mon/` (src/mon/).

Paxos-replicated cluster maps (`Paxos`, `paxos_service.ProposalQueue`),
rank elections (`Elector`), and the services that own the maps:
`OSDMonitor` (boots, failure reports, the down-out timer, EC profiles and
pools), `AuthMonitor`, `ConfigMonitor`, `LogMonitor` (the cluster log,
health history and mutes), `MgrMonitor` and `MDSMonitor`; `Monitor`
publishes them to subscribers, answers commands and renders health.  The
daemons' side is `MonClient` and the static `MonMap`.

The monitor's one device touch is the codec `OSDMonitor` builds to check
an EC profile: `Monitor(..., device=None)` puts it on cuda unless the
caller names another device.  Where the port differs from the reference
(the lease, proposing once caught up, the client's hunt on a reset) is in
ROADMAP.md §C (C16, C17, C18).  The mgr modules that feed the digest's
other slices are in `mgr/`.
"""

from .client import MonClient
from .elector import Elector
from .monmap import MonMap
from .monitor import Monitor
from .paxos import Paxos

__all__ = ["Elector", "MonClient", "MonMap", "Monitor", "Paxos"]
