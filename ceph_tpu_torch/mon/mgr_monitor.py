"""MgrMonitor — the PaxosService owning the MgrMap (src/mon/MgrMonitor.cc).

Mirrored behaviors:
- Mgr daemons announce themselves with beacons (MMgrBeacon →
  MgrMonitor::prepare_beacon); the first becomes **active**, later ones
  queue as **standbys**.
- A missed beacon window fails over to a standby
  (`mon_mgr_beacon_grace`, MgrMonitor::tick), bumping the map epoch.
- The map publishes to "mgrmap" subscribers so daemons know where to
  send their MMgrReports (check_sub).
"""

from __future__ import annotations

import time

from ..common.log import dout
from ..msg.messages import MMgrBeacon, MMgrMap
from .paxos_service import ProposalQueue

BEACON_GRACE = 6.0  # mon_mgr_beacon_grace (scaled down)


class MgrMap:
    def __init__(self) -> None:
        self.epoch = 0
        self.active_name = ""
        self.active_addr = ""
        self.standbys: dict[str, str] = {}  # name -> addr

    def to_msg(self) -> MMgrMap:
        return MMgrMap(
            epoch=self.epoch,
            active_name=self.active_name,
            active_addr=self.active_addr,
            standbys=sorted(self.standbys),
        )


class MgrMonitor:
    def __init__(self, mon):
        self.mon = mon
        self.map = MgrMap()
        self._last_beacon: dict[str, float] = {}
        # One proposal in flight at a time, each mutation computed against
        # the committed map at propose time (PaxosService::propose_pending)
        # — concurrent beacons must not race to the same epoch and drop
        # each other's updates.
        self._props = ProposalQueue(mon, "mgr")

    def _clog(self, prio: str, msg: str) -> None:
        """Cluster-log a lifecycle transition; unit harnesses drive this
        service with a bare mon stub that has no LogMonitor."""
        logmon = getattr(self.mon, "logmon", None)
        if logmon is not None:
            logmon.log(prio, f"mon.{self.mon.name}", msg)

    def on_election_changed(self) -> None:
        self._props.reset()
        # Re-baseline beacon timestamps: a newly elected leader has an empty
        # _last_beacon map, and tick() comparing against 0.0 would instantly
        # fail over a healthy active mgr.  Give every known daemon one full
        # grace period from election before judging it (the reference
        # re-baselines beacons on election, MgrMonitor.cc).
        now = time.monotonic()
        for name in [self.map.active_name, *self.map.standbys]:
            if name:
                self._last_beacon[name] = now

    # -- beacons ---------------------------------------------------------------

    def prepare_beacon(self, msg: MMgrBeacon) -> None:
        """Leader-only (MgrMonitor::prepare_beacon)."""
        self._last_beacon[msg.name] = time.monotonic()

        def mutate(m: MgrMap):
            if m.active_name == msg.name:
                if m.active_addr != msg.addr:
                    return (msg.name, msg.addr, m.standbys)
                return None
            if not m.active_name:
                standbys = dict(m.standbys)
                standbys.pop(msg.name, None)
                return (msg.name, msg.addr, standbys)
            if m.standbys.get(msg.name) != msg.addr:
                standbys = dict(m.standbys)
                standbys[msg.name] = msg.addr
                return (m.active_name, m.active_addr, standbys)
            return None

        self._queue(mutate)

    def tick(self) -> None:
        """Fail over when the active mgr stops beaconing
        (MgrMonitor::tick; driven by the monitor's periodic tick)."""
        if not self.mon.is_leader() or not self.map.active_name:
            return
        last = self._last_beacon.get(self.map.active_name, 0.0)
        if time.monotonic() - last <= BEACON_GRACE:
            return
        failed = self.map.active_name
        self._last_beacon.pop(failed, None)

        def mutate(m: MgrMap):
            if m.active_name != failed:
                return None  # someone else already took over
            standbys = dict(m.standbys)
            if standbys:
                name = sorted(standbys)[0]
                addr = standbys.pop(name)
                dout("mon", 1, f"mgr {failed} failed; promoting {name}")
                self._clog(
                    "warn",
                    f"mgr {failed} failed (no beacon); failing over to "
                    f"standby {name}",
                )
                return (name, addr, standbys)
            dout("mon", 1, f"mgr {failed} failed; no standby")
            self._clog(
                "warn",
                f"mgr {failed} failed (no beacon); no standby available",
            )
            return ("", "", {})

        self._queue(mutate)

    # -- paxos -----------------------------------------------------------------

    def _queue(self, mutate) -> None:
        import json

        def make_blob():
            result = mutate(self.map)
            if result is None:
                return None
            active_name, active_addr, standbys = result
            return json.dumps(
                {
                    "epoch": self.map.epoch + 1,
                    "active_name": active_name,
                    "active_addr": active_addr,
                    "standbys": standbys,
                }
            ).encode()

        self._props.queue(make_blob)

    def apply_commit(self, blob: bytes) -> None:
        import json

        info = json.loads(blob.decode())
        m = self.map
        m.epoch = info["epoch"]
        m.active_name = info["active_name"]
        m.active_addr = info["active_addr"]
        m.standbys = dict(info["standbys"])
        dout("mon", 10, f"mgrmap e{m.epoch}: active={m.active_name or '(none)'}")
        self.mon.publish_mgrmap()

    # -- subscriptions ---------------------------------------------------------

    def check_sub(self, conn, subs: dict[str, int]) -> None:
        if self.map.epoch == 0 or subs.get("mgrmap", 0) > self.map.epoch:
            return
        subs["mgrmap"] = self.map.epoch + 1
        self.mon.send_to_conn(conn, self.map.to_msg())
