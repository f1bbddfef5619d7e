"""Monitor daemon — mirror of src/mon/Monitor.{h,cc}.

One Monitor per configured name; an elected leader drives Paxos proposals
for every PaxosService (here: OSDMonitor).  Mirrored structure:

- Elections (Elector) -> leader_init/peon_init on Paxos
  (Monitor::win_election / lose_election).
- Services propose encoded pending state through Paxos; every quorum member
  applies commits in order and publishes to its own subscribers
  (PaxosService::propose_pending / refresh).
- Subscriptions (MMonSubscribe): "osdmap" subscribers get the current full
  map immediately and incrementals as they commit
  (Monitor::handle_subscribe, OSDMonitor::check_osdmap_sub).
- Commands (MMonCommand, JSON like the reference's cmdmap): queries are
  answered by any quorum member from committed state; mutations on a peon
  return -EAGAIN naming the leader so clients re-target (the reference
  forwards instead; re-targeting keeps the same consistency).
- OSD boot/failure reports: OSDs broadcast to all mons; only the leader
  acts (prepare_boot / prepare_failure).

The port's copy differs in six places, each held by a test:

- `device`: the one device touch of the monitor is the codec
  `OSDMonitor` builds to check an EC profile; it is on `device`, cuda
  unless the caller names another, and a missing GPU raises
  (`codec.base.resolve_device`);
- the tick runs Paxos's lease on every quorum member: a peon whose
  lease lapses, or a leader missing a peer's acks, calls an election, so
  a dead monitor is replaced; a tick that wakes more than half the lease
  timeout late judges no lease (ROADMAP C16);
- services propose once the leader's Paxos has caught up, not at the
  election (ROADMAP C17);
- the MDS service's tick is told how late it woke and judges no beacon
  after a tick more than half the beacon grace late (ROADMAP C30,
  `mds_monitor.py`);
- a PROPOSE of an older election epoch is dropped, or, from a monitor
  outside the quorum, calls an election, and an election message to a
  rank supersedes the one still queued to it (ROADMAP C21; the elector's
  timers differ too, see `elector.py`);
- a device error (`ops.guard.is_device_error`: a kernel that does not
  build or launch, a CUDA failure) fails the monitor wherever it is met:
  in a message's dispatch, a command (answered -EIO first), the tick or
  an election's outcome.  The monitor records it in `failed`, stops, and
  `start()` and `wait_for_quorum()` raise it, where the reference's
  would go on without what the device was asked for.  Other command
  errors are answered -EINVAL as in the reference.
"""

from __future__ import annotations

import asyncio
import json
import time

from ..codec.base import resolve_device
from ..common.health import overall_status as health_status
from ..common.log import dout
from ..msg.messages import (
    MLog,
    MMDSBeacon,
    MMgrBeacon,
    MMonMgrReport,
    MMonCommand,
    MMonCommandAck,
    MMonElection,
    MMonPaxos,
    MMonSubscribe,
    MOSDBoot,
    MOSDFailure,
    MOSDMap,
)
from ..msg.messenger import Connection, Dispatcher, Messenger, Policy
from ..ops.guard import is_device_error
from .auth_monitor import AuthMonitor
from .config_monitor import ConfigMonitor
from .elector import Elector
from .log_monitor import LogMonitor
from .monmap import MonMap
from .mds_monitor import MDSMonitor
from .mgr_monitor import MgrMonitor
from .osd_monitor import OSDMonitor
from .paxos import Paxos
from ..common.errs import EAGAIN, EINVAL, EIO
from .paxos import LEASE_ACK_TIMEOUT_FACTOR


class Monitor(Dispatcher):
    def __init__(
        self,
        name: str,
        monmap: MonMap,
        election_timeout: float = 0.5,
        conf=None,  # common.config.Config; None = option-table defaults
        keyring=None,  # KeyRing enabling cephx on this mon's sessions
        secure: bool = False,
        compress: bool = False,
        stack: str = "posix",  # ms_type (msg/stack.py)
        admin_socket: str = "",  # unix socket path; empty disables
        device=None,  # the EC profile checks' codec device; cuda by default
    ):
        self.device = resolve_device(device)
        self._admin_socket_path = admin_socket
        self.admin_socket = None
        self.name = name
        self.monmap = monmap
        self.rank = monmap.rank_of(name)
        if conf is None:
            from ..common.config import Config

            conf = Config({"name": name})
        self.conf = conf
        auth = None
        if keyring is not None:
            from ..auth.cephx import CephxAuth

            auth = CephxAuth.for_daemon(f"mon.{name}", keyring)
        self.msgr = Messenger(
            f"mon.{name}", auth=auth, secure=secure, compress=compress,
            stack=stack,
        )
        self.msgr.default_policy = Policy.lossless_peer()
        self.elector = Elector(
            self.rank,
            monmap.size(),
            self._send_mon_election,
            on_win=self._device_fails(self._win_election),
            on_lose=self._device_fails(self._lose_election),
            timeout=election_timeout,
        )
        self.paxos = Paxos(self.rank, self._send_mon_paxos, self._apply_commit,
                           on_active=self._paxos_active)
        self.quorum: list[int] = []
        self.leader_rank: int | None = None
        self.osdmon = OSDMonitor(
            self,
            min_down_reporters=int(
                self.conf.get("mon_osd_min_down_reporters")
            ),
            device=self.device,
        )
        self.mgrmon = MgrMonitor(self)
        self.mdsmon = MDSMonitor(self)
        self.configmon = ConfigMonitor(self)
        self.logmon = LogMonitor(self)
        self.authmon = AuthMonitor(self)
        # conn -> {what -> next epoch}
        self.subs: dict[Connection, dict[str, int]] = {}
        # latest PGMap digest from the active mgr (MMonMgrReport);
        # volatile health data, re-sent every mgr beacon interval
        self.pg_digest: dict = {}
        self._started = asyncio.Event()
        self._tick_task: asyncio.Task | None = None
        # the lease's counters: elections it called, and ticks that woke
        # too late to judge it (C16)
        self.lease_elections = 0
        self.lease_stalls = 0
        # the device error that stopped this monitor, if one did
        self.failed: BaseException | None = None
        self._stopping: asyncio.Future | None = None
        self._dispatch_or_fail = self._device_fails(self._dispatch)
        # monitors whose session with this one reset since the quorum
        # formed: an older propose from one of them is a restart (C21)
        self._reset_ranks: set[int] = set()
        self._election_out: dict[int, MMonElection] = {}  # the last sent a rank

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> None:
        await self.msgr.bind(self.monmap.addrs[self.name])
        self.msgr.add_dispatcher_head(self)
        self.elector.start()
        self._tick_task = asyncio.create_task(self._tick_loop())
        self._raise_if_failed()
        await self._start_admin_socket()
        self._started.set()

    # -- a device error fails the monitor (the port's) --------------------------

    def _device_fails(self, fn):
        """`fn`, with a device error it raises sent to `_fail`."""
        def call(*args):
            try:
                return fn(*args)
            except Exception as e:
                if not is_device_error(e):
                    raise
                self._fail(e)
        return call

    def _fail(self, exc: BaseException) -> None:
        """The device failed under this monitor: record it and stop.  Its
        peers call an election once its lease lapses; its owner hears of
        it from `start()`, `wait_for_quorum()` or `failed`."""
        if self.failed is not None:
            return
        self.failed = exc
        dout("mon", 0, f"mon.{self.name}: device error, stopping: {exc!r}")
        asyncio.get_event_loop().create_task(self.stop())

    def _raise_if_failed(self) -> None:
        if self.failed is not None:
            raise self.failed

    async def _start_admin_socket(self) -> None:
        """Mon admin socket (Monitor::_add_admin_socket_commands):
        mon_status / quorum_status / paxos introspection."""
        if not self._admin_socket_path:
            return
        from ..common.admin_socket import AdminSocket

        sock = AdminSocket(self._admin_socket_path)
        sock.register("mon_status", lambda cmd: self.mon_status(),
                      "this monitor's state")
        # same payload as the MMonCommand quorum_status handler, so the
        # two views of the quorum can never drift apart
        sock.register("quorum_status", lambda cmd: self.quorum_status(),
                      "current quorum + leader")
        sock.register("paxosinfo", lambda cmd: {
            "last_committed": self.paxos.last_committed,
            "accepted_pn": self.paxos.accepted_pn,
            "leading": self.paxos.leading,
            "store_versions": len(self.paxos.store),
        }, "paxos engine state (Paxos::dump_info)")
        await sock.start()
        if self._stopping is not None:  # failed while the socket opened
            await sock.stop()
            return
        self.admin_socket = sock

    def quorum_status(self) -> dict:
        """Shared quorum view (the MMonCommand handler and the admin
        socket both serve this shape)."""
        return {
            "quorum": sorted(self.quorum),
            "leader": self.leader_rank,
            "epoch": self.elector.epoch,
        }

    def mon_status(self) -> dict:
        """`ceph tell mon.x mon_status` payload."""
        return {
            "name": self.name,
            "rank": self.rank,
            "state": (
                "leader" if self.is_leader()
                else "peon" if self.rank in self.quorum
                else "electing"
            ),
            "quorum": sorted(self.quorum),
            "monmap": dict(self.monmap.addrs),
        }

    async def stop(self) -> None:
        if self._stopping is None:
            self._stopping = asyncio.ensure_future(self._stop())
        await asyncio.shield(self._stopping)

    async def _stop(self) -> None:
        self.elector.cancel()
        if self._tick_task is not None:
            self._tick_task.cancel()
            self._tick_task = None
        if self.admin_socket is not None:
            await self.admin_socket.stop()
            self.admin_socket = None
        await self.msgr.shutdown()

    async def _tick_loop(self) -> None:
        """Monitor::tick: the lease on every quorum member, then periodic
        service timers (mgr beacon grace, health history) on the leader."""
        tick = self._device_fails(self._tick)
        while self.failed is None:
            interval = self.conf.get("mon_tick_interval")
            slept = time.monotonic()
            await asyncio.sleep(interval)
            tick(time.monotonic() - slept - interval)

    def _tick(self, late: float) -> None:
        self._lease_tick(late)
        if self.is_leader():
            self.mgrmon.tick()
            self.mdsmon.tick(late)
            self.osdmon.tick()
            # health-event history + mute maintenance:
            # diffs rendered checks against committed state
            self.logmon.tick()

    def _lease_tick(self, late: float) -> None:
        """Paxos's lease for this tick (the port's; C16).  `late` is how
        far past its interval the tick woke: the event loop this monitor
        shares (with its peers and daemons, in one process) was busy that
        long, and leases and acks waited in it too, so a tick later than
        half the lease timeout gives every clock a fresh timeout instead
        of calling an election."""
        if self.leader_rank is None or self.elector.electing:
            return
        now = time.monotonic()
        self.paxos.lease = float(self.conf.get("mon_lease"))
        if late > self.paxos.lease * LEASE_ACK_TIMEOUT_FACTOR / 2:
            self.lease_stalls += 1
            self.paxos.lease_reset(now)
            return
        if self.paxos.lease_tick(now):
            self.lease_elections += 1
            dout("mon", 1, f"mon.{self.name}: lease lost, calling an election")
            self.elector.start()

    async def wait_for_quorum(self, timeout: float = 5.0) -> None:
        deadline = asyncio.get_event_loop().time() + timeout
        while self.leader_rank is None and self.failed is None:
            if asyncio.get_event_loop().time() > deadline:
                raise TimeoutError("no quorum")
            await asyncio.sleep(0.01)
        self._raise_if_failed()

    def is_leader(self) -> bool:
        return self.leader_rank == self.rank

    # -- transport helpers -----------------------------------------------------

    def _send_mon(self, rank: int, msg) -> None:
        if rank == self.rank:
            return
        addr = self.monmap.addr_of_rank(rank)

        async def _send():
            try:
                await self.msgr.send_to(addr, msg)
            except ConnectionError:
                dout("mon", 10, f"mon.{self.name}: send to rank {rank} failed")

        asyncio.get_event_loop().create_task(_send())

    def _send_mon_election(self, rank: int, msg: MMonElection) -> None:
        """An election message replaces the one still queued or resending
        to that rank (the port's, C21): the elector's state only moves
        on, so a monitor that comes back hears the current round, not a
        backlog of finished ones."""
        old = self._election_out.get(rank)
        if old is not None:
            old.superseded = True
        self._election_out[rank] = msg
        self._send_mon(rank, msg)

    def _send_mon_paxos(self, rank: int, msg: MMonPaxos) -> None:
        self._send_mon(rank, msg)

    # -- election outcomes -----------------------------------------------------

    def _win_election(self, epoch: int, quorum: list[int]) -> None:
        self._reset_ranks.clear()
        self.quorum = quorum
        self.leader_rank = self.rank
        # the services become active once the collect round has caught
        # this leader up (`_paxos_active`; at once for a quorum of one)
        self.paxos.leader_init(quorum)

    def _paxos_active(self) -> None:
        """The leader's Paxos caught up with its quorum (C17): the
        services re-baseline against the committed maps (a fresh
        monitor's mgr map names the active mgr only now) and propose."""
        for svc in (self.mgrmon, self.mdsmon, self.configmon, self.logmon,
                    self.authmon):
            svc.on_election_changed()
        self.osdmon.on_active()

    def _lose_election(
        self, epoch: int, leader: int, quorum: list[int] | None = None
    ) -> None:
        # Peons DO know the quorum: the victory message carries it
        # (previously reset to [], which made every healthy peon report
        # "electing" with an empty quorum through mon_status).
        self._reset_ranks.clear()
        self.quorum = list(quorum or [])
        self.leader_rank = leader
        self.paxos.peon_init(leader)
        self.osdmon.on_election_lost()
        for svc in (self.mgrmon, self.mdsmon, self.configmon, self.logmon,
                    self.authmon):
            svc.on_election_changed()

    # -- commit application ----------------------------------------------------

    def _apply_commit(self, version: int, value: bytes) -> None:
        """Every quorum member applies committed service transactions in
        order (PaxosService::refresh)."""
        service, _, blob = value.partition(b"\x00")
        if service == b"osd":
            self.osdmon.apply_commit(blob)
        elif service == b"mgr":
            self.mgrmon.apply_commit(blob)
        elif service == b"mds":
            self.mdsmon.apply_commit(blob)
        elif service == b"config":
            self.configmon.apply_commit(blob)
        elif service == b"logm":
            self.logmon.apply_commit(blob)
        elif service == b"auth":
            self.authmon.apply_commit(blob)

    def propose(self, service: str, blob: bytes, on_done=None) -> None:
        self.paxos.propose(service.encode() + b"\x00" + blob, on_done)

    # -- dispatch --------------------------------------------------------------

    def ms_dispatch(self, conn: Connection, msg) -> bool:
        if self.failed is not None:
            return True  # stopping: the device failed under this monitor
        return self._dispatch_or_fail(conn, msg) is not False

    def _dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, MMonElection):
            if not self._older_propose(msg):
                self.elector.handle(msg)
        elif isinstance(msg, MMonPaxos):
            self.paxos.handle(msg, self._peer_rank(conn))
        elif isinstance(msg, MMonSubscribe):
            self._handle_subscribe(conn, msg)
        elif isinstance(msg, MMonCommand):
            self._handle_command(conn, msg)
        elif isinstance(msg, MOSDBoot):
            if self.is_leader():
                self.osdmon.prepare_boot(msg)
        elif isinstance(msg, MOSDFailure):
            if self.is_leader():
                self.osdmon.prepare_failure(msg, reporter=msg.src)
        elif isinstance(msg, MMgrBeacon):
            if self.is_leader():
                self.mgrmon.prepare_beacon(msg)
        elif isinstance(msg, MMDSBeacon):
            if self.is_leader():
                self.mdsmon.prepare_beacon(msg)
        elif isinstance(msg, MMonMgrReport):
            # Only the ACTIVE mgr (per the committed mgrmap) may supply the
            # digest: it drives FLAG_FULL_QUOTA and SLOW_OPS, so a stats
            # report from any other session (standby mgr, spoofed client)
            # is dropped (the reference's DaemonServer gates the same way).
            active = self.mgrmon.map.active_name
            if active and conn.peer_name == f"mgr.{active}":
                try:
                    self.pg_digest = json.loads(msg.digest.decode() or "{}")
                except json.JSONDecodeError:
                    pass
            else:
                dout(
                    "mon", 5,
                    f"mon.{self.name}: dropping MMonMgrReport from "
                    f"{conn.peer_name or msg.src!r} (active mgr: {active or 'none'})",
                )
        elif isinstance(msg, MLog):
            # Daemon clog entries: the leader proposes them; a peon forwards
            # to the leader (Monitor::forward_request_leader).
            if self.is_leader():
                self.logmon.prepare_log(msg)
            elif self.leader_rank is not None:
                self._send_mon(self.leader_rank, msg)
        else:
            return False
        return True

    def _older_propose(self, msg: MMonElection) -> bool:
        """Whether `msg` is a PROPOSE of an older election epoch than this
        monitor's (the port's, C21; Ceph's
        `ElectionLogic::receive_propose`).  From a monitor outside the
        standing quorum, or from a member whose session with this one
        reset since the quorum formed, it calls an election that monitor
        can join (it has just started); otherwise it is dropped: a
        lossless resend delivered after its round ended, which the
        reference's elector answers by deferring again, or by a round of
        its own."""
        if msg.op != MMonElection.OP_PROPOSE or msg.epoch >= self.elector.epoch:
            return False
        if not self.elector.electing and (msg.rank not in self.quorum
                                          or msg.rank in self._reset_ranks):
            dout("mon", 5, f"mon.{self.name}: propose of epoch {msg.epoch} from "
                           f"mon.{msg.rank}, which has restarted: calling an election")
            self.elector.start()
        else:
            dout("mon", 10, f"mon.{self.name}: dropping a propose of epoch {msg.epoch} "
                            f"from mon.{msg.rank} (epoch {self.elector.epoch})")
        return True

    def ms_handle_reset(self, conn: Connection) -> None:
        self.subs.pop(conn, None)
        for rank in range(self.monmap.size()):
            if (conn.peer_name == f"mon.{self.monmap.ranks[rank]}"
                    or conn.peer_addr == self.monmap.addr_of_rank(rank)):
                self._reset_ranks.add(rank)

    def _peer_rank(self, conn: Connection) -> int:
        name = conn.peer_name.removeprefix("mon.")
        return self.monmap.rank_of(name)

    # -- subscriptions ---------------------------------------------------------

    def _handle_subscribe(self, conn: Connection, msg: MMonSubscribe) -> None:
        subs = self.subs.setdefault(conn, {})
        for what, start in msg.what.items():
            subs[what] = start
            if what == "osdmap":
                self.osdmon.check_sub(conn, subs)
            elif what == "mgrmap":
                self.mgrmon.check_sub(conn, subs)
            elif what == "mdsmap":
                self.mdsmon.check_sub(conn, subs)
            elif what == "config":
                self.configmon.check_sub(conn, subs)
            elif what == "log":
                self.logmon.check_sub(conn, subs)

    def publish_osdmap(self) -> None:
        """Push new epochs to every osdmap subscriber (on commit)."""
        for conn, subs in list(self.subs.items()):
            if "osdmap" in subs:
                self.osdmon.check_sub(conn, subs)

    def publish_mgrmap(self) -> None:
        for conn, subs in list(self.subs.items()):
            if "mgrmap" in subs:
                self.mgrmon.check_sub(conn, subs)

    def publish_mdsmap(self) -> None:
        for conn, subs in list(self.subs.items()):
            if "mdsmap" in subs:
                self.mdsmon.check_sub(conn, subs)

    def publish_config(self) -> None:
        for conn, subs in list(self.subs.items()):
            if "config" in subs:
                self.configmon.check_sub(conn, subs)

    def publish_log(self, appended: list[dict]) -> None:
        for conn, subs in list(self.subs.items()):
            if "log" in subs:
                self.logmon.push_new(conn, subs, appended)

    def send_to_conn(self, conn: Connection, msg) -> None:
        async def _send():
            try:
                await conn.send_message(msg)
            except ConnectionError:
                self.subs.pop(conn, None)

        asyncio.get_event_loop().create_task(_send())

    # -- commands --------------------------------------------------------------

    def _handle_command(self, conn: Connection, msg: MMonCommand) -> None:
        try:
            cmd = json.loads(msg.cmd)
        except json.JSONDecodeError:
            self.send_to_conn(
                conn, MMonCommandAck(tid=msg.tid, retval=-EINVAL, rs="bad json", outbl=b"")
            )
            return
        prefix = cmd.get("prefix", "")
        handler = None
        for svc in (self.osdmon, self.mdsmon, self.configmon, self.logmon,
                    self.authmon):
            handler = svc.command_handler(prefix)
            if handler is not None:
                break
        handler = handler or self._mon_command_handler(prefix)
        if handler is None:
            self.send_to_conn(
                conn,
                MMonCommandAck(
                    tid=msg.tid, retval=-EINVAL, rs=f"unknown command {prefix!r}", outbl=b""
                ),
            )
            return
        mutating = getattr(handler, "mutating", False)
        if mutating and not self.is_leader():
            leader = self.leader_rank if self.leader_rank is not None else -1
            self.send_to_conn(
                conn,
                MMonCommandAck(
                    tid=msg.tid,
                    retval=-EAGAIN,
                    rs=f"not leader; leader is rank {leader}",
                    outbl=b"",
                ),
            )
            return

        def reply(retval: int, rs: str, outbl: bytes = b"") -> None:
            self.send_to_conn(
                conn, MMonCommandAck(tid=msg.tid, retval=retval, rs=rs, outbl=outbl)
            )

        if mutating:
            # every mutating command lands on the audit channel (the
            # reference mon's `audit` LogChannel: "from='client...'
            # cmd=[...]: dispatch"), logged at dispatch on the leader
            entity = conn.peer_name or "client.?"
            self.logmon.log(
                "info",
                entity,
                f"from='{entity}' cmd={json.dumps(cmd)}: dispatch",
                channel="audit",
            )
        try:
            handler(cmd, reply)
        except Exception as e:  # command bugs must not kill the mon
            if is_device_error(e):
                # the device's, not the command's: the caller hears EIO
                # and the error fails the monitor (`ms_dispatch`)
                reply(-EIO, f"command failed on the device: {e}")
                raise
            reply(-EINVAL, f"command failed: {e}")

    def health_checks(self) -> tuple[dict[str, str], dict[str, list[str]]]:
        """Mon-side cluster health (`ceph -s` HEALTH line / `ceph health
        [detail]`): (checks, detail) where checks maps code -> summary
        string and detail maps code -> per-entity breakdown lines.  Down
        OSDs, missing quorum members, and dead filesystems come from the
        mon's own committed maps; SLOW_OPS comes from the active mgr's
        digest (the OSDs' OpTracker complaint counts, the reference's
        OSDMap::check_health slow-request path)."""
        from ..common import health

        checks: dict[str, str] = {}
        details: dict[str, list[str]] = {}
        down = health.down_in_osds(self.osdmon.osdmap)
        if down:
            checks["OSD_DOWN"] = (
                f"{len(down)} osds down: "
                + ", ".join(f"osd.{o}" for o in sorted(down))
            )
            details["OSD_DOWN"] = [f"osd.{o} is down" for o in sorted(down)]
        # slow-but-alive peers: laggy evidence from the OSDs'
        # heartbeat/sub-read RTT reports (OSDMonitor.laggy).  Non-fatal
        # — the target serves I/O, slowly — so a WARN, never a markdown;
        # clears when reporters send the recovery report or their
        # evidence expires
        laggy = self.osdmon.slow_peers()
        summary = health.slow_peer_summary(laggy)
        if summary:
            checks["OSD_SLOW_PEER"] = summary
            details["OSD_SLOW_PEER"] = health.slow_peer_detail(laggy)
        if len(self.quorum) < self.monmap.size():
            out = self.monmap.size() - len(self.quorum)
            checks["MON_DOWN"] = f"{out} monitor(s) out of quorum"
            details["MON_DOWN"] = [
                f"mon rank {r} not in quorum"
                for r in range(self.monmap.size())
                if r not in self.quorum
            ]
        down_fs = [
            name
            for name, fs in self.mdsmon.map.filesystems.items()
            if not fs["active_name"]
        ]
        if down_fs:
            # a filesystem with no rank 0 serves nothing
            # (MDSMonitor MDS_ALL_DOWN health check)
            checks["MDS_ALL_DOWN"] = (
                f"fs {', '.join(sorted(down_fs))} has no active MDS"
            )
            details["MDS_ALL_DOWN"] = [
                f"fs {name} has no active MDS" for name in sorted(down_fs)
            ]
        slow = self.pg_digest.get("slow_ops") or {}
        summary = health.slow_ops_summary(slow)
        if summary:
            checks["SLOW_OPS"] = summary
            details["SLOW_OPS"] = health.slow_ops_detail(slow)
        # daemons whose EC dispatch fell back to the host oracle (device
        # backend wedged/erroring; ops/guard.py verdict via the mgr
        # digest).  Clears when the daemon's re-probe heals the backend.
        degraded = self.pg_digest.get("tpu_degraded") or {}
        summary = health.tpu_degraded_summary(degraded)
        if summary:
            checks["TPU_BACKEND_DEGRADED"] = summary
            details["TPU_BACKEND_DEGRADED"] = health.tpu_degraded_detail(
                degraded
            )
        # daemons over their HBM residency target (the mempool ledger's
        # pressure verdict via the mgr digest).  Clears when
        # the staged trims — cache, donation retention, pipeline depth
        # — bring residency back under the relief threshold, or the
        # holder frees its buffers.
        pressured = self.pg_digest.get("hbm_pressure") or {}
        summary = health.hbm_pressure_summary(pressured)
        if summary:
            checks["TPU_HBM_PRESSURE"] = summary
            details["TPU_HBM_PRESSURE"] = health.hbm_pressure_detail(
                pressured
            )
        # recovery/backfill events that stopped advancing (mgr progress
        # module digest slice); clears when progress resumes or
        # the event completes
        stalled = (self.pg_digest.get("progress") or {}).get("stalled") or {}
        summary = health.recovery_stalled_summary(stalled)
        if summary:
            checks["PG_RECOVERY_STALLED"] = summary
            details["PG_RECOVERY_STALLED"] = health.recovery_stalled_detail(
                stalled
            )
        # trend sentinels from the mgr metrics-history module:
        # throughput regression / occupancy collapse / queue-wait
        # inflation vs their trailing baselines.  The wording was built
        # mgr-side by common/health.py, so rendering the shipped
        # summary/detail verbatim keeps the two surfaces in lockstep —
        # the PG_RECOVERY_STALLED raise/clear shape.  The checks drop
        # when the trend recovers (the module clears the slice).
        sentinels = (self.pg_digest.get("history") or {}).get(
            "sentinels"
        ) or {}
        for code, rec in sorted(sentinels.items()):
            summary = rec.get("summary")
            if not summary:
                continue
            checks[code] = summary
            details[code] = list(rec.get("detail") or [])
        # pools burning their latency-SLO error budget (mgr iostat
        # module digest slice): raise/clear like
        # PG_RECOVERY_STALLED — the check drops when the load stops or
        # either burn window recovers
        breaches = (self.pg_digest.get("slo") or {}).get("breaches") or {}
        summary = health.slo_breach_summary(breaches)
        if summary:
            checks["SLO_LATENCY_BREACH"] = summary
            details["SLO_LATENCY_BREACH"] = health.slo_breach_detail(
                breaches
            )
        # scrub inconsistencies: the per-PG slice
        # the primaries reported through the mgr digest.  These are the
        # two HEALTH_ERR checks — shards disagree on user data — and
        # they clear when repair + the confirming scrub come back clean
        scrub = self.pg_digest.get("scrub_errors") or {}
        summary = health.osd_scrub_errors_summary(scrub)
        if summary:
            checks["OSD_SCRUB_ERRORS"] = summary
            checks["PG_DAMAGED"] = health.pg_damaged_summary(scrub)
            details["PG_DAMAGED"] = health.pg_damaged_detail(scrub)
            details["OSD_SCRUB_ERRORS"] = details["PG_DAMAGED"]
        return checks, details

    def _mon_command_handler(self, prefix: str):
        if prefix == "df":
            def handler(cmd, reply):
                # `ceph df`: the mgr's PGMap digest (pools' STORED /
                # OBJECTS / raw USED); empty until a mgr reports
                reply(0, "", json.dumps(self.pg_digest).encode())
            return handler
        if prefix == "osd df":
            def handler(cmd, reply):
                # `ceph osd df`: per-OSD raw usage from the same digest
                reply(
                    0, "",
                    json.dumps(self.pg_digest.get("osds", {})).encode(),
                )
            return handler
        if prefix == "health":
            def handler(cmd, reply):
                # `ceph health [detail]`: the status handler's checks,
                # served standalone (ClusterHealth essence); `detail`
                # adds the per-daemon breakdown lines.  Muted checks
                # drop out of the banner and the overall
                # status but are named, so the operator sees what is
                # silenced — the raw checks keep being evaluated and
                # scraped underneath.
                checks, details = self.health_checks()
                checks, details, muted = self.logmon.filter_muted(
                    checks, details
                )
                payload = {
                    "status": health_status(checks),
                    "checks": checks,
                    "muted": muted,
                }
                if cmd.get("detail"):
                    payload["detail"] = details
                reply(0, "", json.dumps(payload).encode())
            return handler
        if prefix == "quorum_status":
            def handler(cmd, reply):
                reply(0, "", json.dumps(self.quorum_status()).encode())
            return handler
        if prefix == "status":
            def handler(cmd, reply):
                m = self.osdmon.osdmap
                checks, _details = self.health_checks()
                checks, _details, muted = self.logmon.filter_muted(
                    checks, _details
                )
                reply(
                    0,
                    "",
                    json.dumps(
                        {
                            "health": {
                                "status": health_status(checks),
                                "checks": checks,
                                "muted": muted,
                            },
                            "quorum": sorted(self.quorum),
                            "osdmap_epoch": m.epoch,
                            "num_osds": len(m.osds),
                            "num_up_osds": m.num_up_osds(),
                            "pools": [p.name for p in m.pools.values()],
                            "fsmap": self.mdsmon.map.status(),
                            # per-PG progress bars with rate + ETA (mgr
                            # progress module via the PGMap digest) —
                            # the `ceph -s` progress block analog
                            "progress": self.pg_digest.get(
                                "progress", {}
                            ),
                            # per-pool IO rates / windowed p99 + top
                            # clients (mgr iostat module) —
                            # who is driving the load, from `status`
                            "iostat": self.pg_digest.get("iostat", {}),
                            # per-pool SLO burn-rate slice (the health
                            # check's evidence, machine-readable)
                            "slo": self.pg_digest.get("slo", {}),
                            # trend-sentinel slice + history store
                            # meta-stats (mgr metrics-history module)
                            # — the sentinel evidence,
                            # machine-readable from `status`
                            "history": self.pg_digest.get("history", {}),
                            # cluster-log tail: the last few
                            # committed entries, `ceph -s`'s recent-
                            # events block
                            "log": list(self.logmon.entries)[-10:],
                        }
                    ).encode(),
                )
            return handler
        return None
