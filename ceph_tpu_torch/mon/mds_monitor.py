"""MDSMonitor — the PaxosService owning the FSMap (src/mon/MDSMonitor.cc,
src/mds/FSMap.h).

Mirrored behaviors:
- MDS daemons announce themselves with beacons (MMDSBeacon →
  MDSMonitor::prepare_beacon) and pool as STANDBYS until a filesystem
  wants a rank; each `fs new` filesystem gets its own **rank 0** daemon
  assigned from the standby pool (FSMap::promote — the reference's
  multi-filesystem map, one MDSMap per fs inside the FSMap envelope).
- A missed beacon window fails a filesystem's active rank over to a
  standby (`mds_beacon_grace`, MDSMonitor::tick → maybe_replace_gid),
  bumping the map epoch; the promoted standby sees its assignment in
  the next MMDSMap and runs journal replay for THAT filesystem before
  serving.
- The map publishes to "mdsmap" subscribers (clients resolving their
  filesystem's active MDS; standbys learning of promotion) — check_sub.
- Commands: `fs new <name> <meta> <data>`, `fs rm <name>`, `fs status`.

Rank scope per filesystem: one ACTIVE rank (0); multi-rank subtree
partitioning is out of scope in ceph_tpu.mds and therefore here.

The port's copy of `ceph_tpu/mon/mds_monitor.py`.  Where it differs
(ROADMAP C30): the tick judges its own lateness.  A tick that woke more
than half the grace late judges no beacon and gives every active a fresh
grace (`beacon_stalls` counts such ticks), and a daemon's silence is
measured without the time the monitor's loop lost in the ticks since its
last beacon.  The monitor shares its event loop with its peers and, in
one process, with the MDS daemons, so a held loop delays the beacons it
would have received; the reference fails a healthy active over after
such a hold.
"""

from __future__ import annotations

import json
import time

from ..common.log import dout
from ..msg.messages import MMDSBeacon, MMDSMap
from .paxos_service import ProposalQueue

BEACON_GRACE = 6.0  # mds_beacon_grace (scaled down like mgr's)


class FSMap:
    """The multi-filesystem FSMap: per-fs rank-0 holder + a shared
    standby pool (FSMap.h filesystems + standby_daemons)."""

    def __init__(self) -> None:
        self.epoch = 0
        # fs name -> {meta_pool, data_pool, active_name, active_addr}
        self.filesystems: dict[str, dict] = {}
        self.standbys: dict[str, str] = {}  # daemon name -> addr
        # daemon name -> RADOS client instance id (objecter reqid),
        # learned from beacons.  COMMITTED state, not leader-local: the
        # fence on failover needs the failed daemon's client id, and the
        # failed daemon by definition never beacons the new leader —
        # keeping this in the map is what lets a post-election leader
        # still fence it.
        self.clients: dict[str, str] = {}
        # daemon name -> client id WE blocklisted on failover/fs-rm.
        # Committed alongside the mutation that moved the rank, so (a) a
        # post-election leader can still lift the fence when the daemon
        # demotes, and (b) the unfence path never touches blocklist
        # entries an admin added manually (it only lifts ids recorded
        # here).
        self.fenced: dict[str, str] = {}

    # -- queries ---------------------------------------------------------------

    def fs_of_daemon(self, daemon: str) -> str:
        """Filesystem this daemon holds rank 0 of ('' = none)."""
        for name, fs in self.filesystems.items():
            if fs["active_name"] == daemon:
                return name
        return ""

    def actives(self) -> dict[str, str]:
        return {
            name: fs["active_name"]
            for name, fs in self.filesystems.items()
            if fs["active_name"]
        }

    def to_msg(self) -> MMDSMap:
        return MMDSMap(
            epoch=self.epoch,
            fsmap=json.dumps(
                {"filesystems": self.filesystems, "standbys": self.standbys}
            ).encode(),
        )

    def to_blob(self, epoch: int) -> bytes:
        return json.dumps(
            {
                "epoch": epoch,
                "filesystems": self.filesystems,
                "standbys": self.standbys,
                "clients": self.clients,
                "fenced": self.fenced,
            }
        ).encode()

    @staticmethod
    def scratch(m: "FSMap") -> "FSMap":
        s = FSMap()
        s.epoch = m.epoch
        s.filesystems = {k: dict(v) for k, v in m.filesystems.items()}
        s.standbys = dict(m.standbys)
        s.clients = dict(m.clients)
        s.fenced = dict(m.fenced)
        return s

    def status(self) -> dict:
        """`ceph fs status` / `ceph status` fsmap line."""
        return {
            "epoch": self.epoch,
            "filesystems": [
                {
                    "name": name,
                    "metadata_pool": fs["meta_pool"],
                    "data_pool": fs["data_pool"],
                    "rank0": fs["active_name"] or None,
                    "state": "up:active" if fs["active_name"] else "down",
                }
                for name, fs in sorted(self.filesystems.items())
            ],
            "standbys": sorted(self.standbys),
        }


def _eligible(m: FSMap, daemon: str) -> bool:
    """A standby is promotable unless its CURRENT client instance is the
    one we fenced (blocklisted): promoting it would hand a filesystem to
    a client whose every write bounces, with no unfence path (the
    unfence requires a rank-less `standby` beacon).  A replacement
    daemon reusing the name carries a fresh client id, so it stays
    eligible while the zombie's fence stands."""
    fenced = m.fenced.get(daemon, "")
    return not fenced or fenced != m.clients.get(daemon, "")


def _assign_standbys(m: FSMap) -> bool:
    """Give every active-less filesystem an eligible standby
    (deterministic order); True when anything changed (FSMap::promote)."""
    changed = False
    for name in sorted(m.filesystems):
        fs = m.filesystems[name]
        if fs["active_name"]:
            continue
        for daemon in sorted(m.standbys):
            if not _eligible(m, daemon):
                continue
            fs["active_name"] = daemon
            fs["active_addr"] = m.standbys.pop(daemon)
            changed = True
            break
    return changed


class MDSMonitor:
    def __init__(self, mon):
        self.mon = mon
        self.map = FSMap()
        self._last_beacon: dict[str, float] = {}
        # the port's (C30): ticks that woke too late to judge a beacon,
        # the lateness of every tick summed (s), and its value when each
        # daemon's grace last restarted
        self.beacon_stalls = 0
        self._stalled = 0.0
        self._stalled_at: dict[str, float] = {}
        # daemon name -> RADOS client instance id, learned from beacons
        # (leader-local, like _last_beacon; repopulated within one beacon
        # interval after an election)
        self._clients: dict[str, str] = {}
        # fences whose blocklist proposal is COMMITTED (leader-local
        # fast path; the committed FSMap `fenced` record is what
        # survives elections) and fences still in flight — a tick firing
        # while a fence is mid-paxos must neither re-fence nor promote
        # ahead of it
        self._fenced: dict[str, str] = {}
        self._fence_inflight: dict[str, str] = {}
        self._props = ProposalQueue(mon, "mds")

    # -- fencing ---------------------------------------------------------------

    def _client_of(self, daemon: str) -> str:
        """The daemon's RADOS client instance id: freshest beacon first,
        then the COMMITTED FSMap record — the latter is what survives a
        mon election, where the failed daemon never beacons the new
        leader ('' for embedded daemons without a client)."""
        return self._clients.get(daemon) or self.map.clients.get(daemon, "")

    def _fence(self, daemon: str, why: str, then=None) -> bool:
        """Blocklist `daemon`'s RADOS client instance via the OSDMonitor
        BEFORE its rank moves (MDSMonitor::fail_mds_gid blocklisting the
        gid's addrs; same pattern as rbd/mirror.py promote(fence=True)).
        A stalled-but-alive old active keeps running its flush loop, and
        without the fence its writes race the promoted standby's journal
        — split-brain metadata corruption.

        Returns True when a fence proposal was queued; `then` (if given)
        runs from the blocklist proposal's commit callback, which is how
        callers guarantee the fence EPOCH commits strictly before the
        promotion epoch (queuing both fire-and-forget would let an
        unrelated in-flight osdmap round reorder them)."""
        client = self._client_of(daemon)
        if not client:
            return False  # embedded daemon: nothing to fence

        def mutate(m) -> str:
            m.blocklist.add(client)
            return f"blocklisting {client}"

        def on_committed(retval: int, _rs: str) -> None:
            self._fence_inflight.pop(daemon, None)
            if retval == 0:
                self._fenced[daemon] = client
                if then is not None:
                    then()
            # non-zero: leadership lost mid-propose — the new leader's
            # tick re-detects the stale beacon and redoes the failover

        self.mon.osdmon._queue(mutate, on_committed)
        self._fence_inflight[daemon] = client
        dout("mon", 1, f"mds {daemon}: fencing client {client} ({why})")
        return True

    def _unfence(self, daemon: str, client: str) -> None:
        """Lift a fence once the daemon has provably demoted (it beacons
        `standby` with the SAME client instance — its active-instance
        flush loop is stopped), so the instance can serve again as a
        standby.  A zombie never demotes and therefore stays fenced."""
        self._fenced.pop(daemon, None)

        def mutate(m) -> str:
            m.blocklist.discard(client)
            return f"un-blocklisting {client}"

        self.mon.osdmon._queue(mutate, None)

        def drop_record(m: FSMap):
            if m.fenced.get(daemon) != client:
                return None
            del m.fenced[daemon]
            # now-eligible again: an active-less filesystem waiting on
            # this standby gets it in the same commit
            _assign_standbys(m)
            return m

        self._queue(drop_record)
        dout("mon", 1, f"mds {daemon}: unfenced client {client} (demoted)")

    def on_election_changed(self) -> None:
        self._props.reset()
        # Re-baseline beacons: a fresh leader judging against 0.0 would
        # instantly fail a healthy active (same as MgrMonitor).
        now = time.monotonic()
        for name in [*self.map.actives().values(), *self.map.standbys]:
            self._restart_grace(name, now)
        # Drop leader-local fence state: a stale _fenced entry on a
        # re-elected leader would skip a NEEDED re-fence (the daemon was
        # unfenced by another leader in between), and an orphaned
        # in-flight entry (its commit callback died with the old
        # leadership) would block that daemon's failover forever.  The
        # committed FSMap `fenced` record is the authority that
        # survives; these are only caches/latches of this leadership.
        self._fenced.clear()
        self._fence_inflight.clear()

    # -- beacons ---------------------------------------------------------------

    def prepare_beacon(self, msg: MMDSBeacon) -> None:
        """Leader-only (MDSMonitor::prepare_beacon)."""
        self._restart_grace(msg.name, time.monotonic())
        client = getattr(msg, "client", "") or ""
        if client:
            self._clients[msg.name] = client
        if (
            client
            and msg.state == "standby"
            and self.map.fs_of_daemon(msg.name) == ""
            and (
                self._fenced.get(msg.name) == client
                or self.map.fenced.get(msg.name) == client
            )
        ):
            # THIS instance (client id must match — a replacement daemon
            # reusing the name must not lift a live zombie's fence)
            # demoted itself after losing its rank: safe to unfence and
            # let it pool.  The committed `fenced` record covers fences
            # placed by a pre-election leader; blocklist entries an
            # admin added manually are never recorded there and so are
            # never lifted here.
            self._unfence(msg.name, client)

        def mutate(m: FSMap):
            changed = False
            held = m.fs_of_daemon(msg.name)
            if held:
                fs = m.filesystems[held]
                if fs["active_addr"] != msg.addr:
                    fs["active_addr"] = msg.addr
                    changed = True
            elif m.standbys.get(msg.name) != msg.addr:
                m.standbys[msg.name] = msg.addr
                changed = True
            if client and m.clients.get(msg.name) != client:
                # commit the client id: a post-election leader must be
                # able to fence a daemon that will never beacon it
                m.clients[msg.name] = client
                changed = True
            changed |= _assign_standbys(m)
            return m if changed else None

        self._queue(mutate)

    def _restart_grace(self, daemon: str, now: float) -> None:
        self._last_beacon[daemon] = now
        self._stalled_at[daemon] = self._stalled

    def _silence(self, daemon: str, now: float) -> float:
        """Seconds since `daemon`'s last beacon, less the time the
        monitor's ticks lost meanwhile (C30)."""
        lost = self._stalled - self._stalled_at.get(daemon, self._stalled)
        return now - self._last_beacon.get(daemon, 0.0) - lost

    def tick(self, late: float) -> None:
        """Fail expired actives over (MDSMonitor::tick →
        maybe_replace_gid; driven by the monitor's periodic tick).
        `late` is how far past its interval the monitor's tick woke
        (the port's; C30)."""
        if not self.mon.is_leader():
            return
        now = time.monotonic()
        self._stalled += max(late, 0.0)
        if late > BEACON_GRACE / 2:
            # the loop that would have taken the beacons was held: their
            # absence says nothing of the daemons
            self.beacon_stalls += 1
            dout("mon", 1, f"mds beacon tick {late:.3f} s late; judging no beacon")
            for daemon in self.map.actives().values():
                self._restart_grace(daemon, now)
            return
        failed = [
            daemon
            for daemon in self.map.actives().values()
            if self._silence(daemon, now) > BEACON_GRACE
        ]
        # daemons whose fence proposal is still mid-paxos are skipped
        # outright: their promotion is already chained to that fence's
        # commit callback, and handling them again here would queue a
        # promotion AHEAD of the uncommitted fence
        failed = [d for d in failed if d not in self._fence_inflight]
        if not failed:
            return
        for daemon in failed:
            # re-baseline rather than pop: a tick firing between the
            # fence proposal and its commit must NOT re-detect this
            # daemon and queue the promotion ahead of the fence; if the
            # failover somehow doesn't commit (lost leadership), the
            # stale beacon re-trips one grace period later and retries
            self._restart_grace(daemon, now)
        # client ids we will have blocklisted by the time the promotion
        # commits — recorded in the SAME FSMap mutation, so a
        # post-election leader can still lift the fence when the daemon
        # demotes (and the unfence path never touches admin blocklists)
        fence_clients = {
            d: self._client_of(d) for d in failed if self._client_of(d)
        }

        def mutate(m: FSMap):
            changed = False
            for daemon in failed:
                held = m.fs_of_daemon(daemon)
                if not held:
                    continue  # already replaced
                fs = m.filesystems[held]
                fs["active_name"] = fs["active_addr"] = ""
                changed = True
                dout("mon", 1, f"mds {daemon} failed; fs {held} rank 0 vacated")
            for daemon, client in fence_clients.items():
                if m.fenced.get(daemon) != client:
                    m.fenced[daemon] = client
                    changed = True
            changed |= _assign_standbys(m)
            return m if changed else None

        # fence BEFORE the FSMap mutation promotes a standby, and queue
        # the promotion from the LAST fence's commit callback: the
        # blocklist epoch is committed before the promotion proposal even
        # enters paxos, so by the time the standby replays the journal
        # the zombie's writes already bounce at every OSD that applied
        # the epoch (fire-and-forget queuing could reorder behind an
        # unrelated in-flight osdmap round)
        fences = [
            d for d, client in fence_clients.items()
            if self._fenced.get(d) != client and self.map.fenced.get(d) != client
        ]
        if not fences:
            self._queue(mutate)
            return
        remaining = {"n": len(fences)}

        def after_fence() -> None:
            remaining["n"] -= 1
            if remaining["n"] == 0:
                self._queue(mutate)

        for daemon in fences:
            self._fence(daemon, "beacon timeout failover", then=after_fence)

    # -- commands --------------------------------------------------------------

    def command_handler(self, prefix: str):
        if prefix == "fs new":
            def handler(cmd, reply):
                name = cmd.get("fs_name", "")
                meta, data = cmd.get("metadata", ""), cmd.get("data", "")
                if not name or not meta or not data:
                    reply(-22, "usage: fs new <fs_name> <metadata> <data>")
                    return
                if name in self.map.filesystems:
                    reply(-17, f"filesystem {name!r} already exists")
                    return
                osdmap = self.mon.osdmon.osdmap
                pools = {p.name for p in osdmap.pools.values()}
                for pool in (meta, data):
                    if pool not in pools:
                        reply(-2, f"pool {pool!r} does not exist")
                        return

                def mutate(m: FSMap):
                    if name in m.filesystems:
                        return None
                    m.filesystems[name] = {
                        "meta_pool": meta,
                        "data_pool": data,
                        "active_name": "",
                        "active_addr": "",
                    }
                    _assign_standbys(m)
                    return m

                def on_committed(version: int) -> None:
                    if version < 0 and name not in self.map.filesystems:
                        reply(-17, f"filesystem {name!r} already exists")
                    else:
                        reply(
                            0,
                            f"new fs with metadata pool {meta} and data pool {data}",
                        )

                self._queue(mutate, on_committed)

            handler.mutating = True
            return handler
        if prefix == "fs rm":
            def handler(cmd, reply):
                name = cmd.get("fs_name", "")
                if not name:
                    reply(-22, "usage: fs rm <fs_name>")
                    return
                if name not in self.map.filesystems:
                    # a typo'd name must not remove a real filesystem
                    reply(-2, f"filesystem {name!r} does not exist")
                    return
                # fs rm of a still-beaconing active: fence its RADOS
                # client FIRST (rm commits from the fence's commit
                # callback) — queued flushes must not land in the
                # removed filesystem's pools after the map drops the
                # rank.  The fence lifts when the daemon demotes (its
                # `standby` beacon) and it rejoins the pool cleanly.
                active = self.map.filesystems[name]["active_name"]
                live = active and (
                    self._silence(active, time.monotonic()) <= BEACON_GRACE
                )
                fence_client = self._client_of(active) if live else ""

                def mutate(m: FSMap):
                    fs = m.filesystems.pop(name, None)
                    if fs is None:
                        return None
                    # its active returns to the standby pool (the daemon
                    # demotes itself when the map stops naming it)
                    if fs["active_name"]:
                        m.standbys[fs["active_name"]] = fs["active_addr"]
                        if fence_client:
                            # committed fence record: survives elections
                            # and scopes the unfence to exactly this id
                            m.fenced[fs["active_name"]] = fence_client
                    _assign_standbys(m)
                    return m

                def queue_rm() -> None:
                    self._queue(
                        mutate, lambda v: reply(0, f"fs {name!r} removed")
                    )

                if fence_client and self._fence(
                    active, "fs rm of live active", then=queue_rm
                ):
                    return
                queue_rm()

            handler.mutating = True
            return handler
        if prefix == "fs status":
            def handler(cmd, reply):
                reply(0, "", json.dumps(self.map.status()).encode())

            return handler
        return None

    # -- paxos -----------------------------------------------------------------

    def _queue(self, mutate, on_committed=None) -> None:
        def make_blob():
            scratch = FSMap.scratch(self.map)
            result = mutate(scratch)
            if result is None:
                return None
            return result.to_blob(self.map.epoch + 1)

        self._props.queue(make_blob, on_committed)

    def apply_commit(self, blob: bytes) -> None:
        info = json.loads(blob.decode())
        m = self.map
        m.epoch = info["epoch"]
        m.filesystems = info["filesystems"]
        m.standbys = dict(info["standbys"])
        m.clients = dict(info.get("clients", {}))
        m.fenced = dict(info.get("fenced", {}))
        dout(
            "mon", 10,
            f"fsmap e{m.epoch}: {sorted(m.actives().items())} "
            f"standbys={sorted(m.standbys)}",
        )
        self.mon.publish_mdsmap()

    # -- subscriptions ---------------------------------------------------------

    def check_sub(self, conn, subs: dict[str, int]) -> None:
        if self.map.epoch == 0 or subs.get("mdsmap", 0) > self.map.epoch:
            return
        subs["mdsmap"] = self.map.epoch + 1
        self.mon.send_to_conn(conn, self.map.to_msg())
