"""MDS daemon — server-side CephFS metadata (mirror of src/mds).

The reference's MDS (src/mds/MDSDaemon.cc, MDCache.cc 13.6k LoC,
Server.cc) owns the namespace: clients send MClientRequest metadata ops;
the MDS journals every mutation into the metadata pool BEFORE applying
it (MDLog/Journaler — metadata is never lost to an MDS crash), caches
dirfrags, writes them back lazily, and hands out **capabilities** so
clients can do file DATA I/O straight to the data pool without the MDS
in the loop.  This daemon keeps that architecture:

- **Namespace**: one object per directory in the metadata pool
  (`dir.<ino>` holding the dentry map, the CDir/CDentry/CInode dirfrag
  commit shape) — the same on-pool layout as the client-only
  fs.FileSystem library, so the two interoperate.
- **Journal (MDLog)**: every mutation appends a JSON event to
  `mds_journal` (RADOS append) before the reply is sent; dirty dirfrags
  flush lazily (tick or size threshold), then the journal trims by
  recording the flushed sequence in `mds_journal_head` and resetting the
  journal object (Journaler::flush + trim semantics).  Startup replays
  events past the flushed sequence — a crashed MDS loses nothing that
  was acknowledged.
- **Caps** (Capability.h / Locker.cc essence): open("w") needs an
  exclusive grant per inode; open("r") shares with other readers.  A
  conflicting open REVOKEs the holders' caps (MClientCaps REVOKE), waits
  for their ACKs (bounded — a dead client's session reset also releases),
  then grants.  File data I/O is client-direct; the MDS only brokers the
  right to do it.
- **Sessions**: one per client connection; a reset drops its caps and
  unblocks waiters (Server::handle_client_session teardown).

Rank scope: one ACTIVE rank (0) at a time; multi-MDS subtree
partitioning (MDCache migrator) is out of scope and documented as such.
**Standby/failover is mon-managed**: given a `monmap`, the
daemon boots as a STANDBY, beacons MMDSBeacon to the mons, and only
activates — load + journal REPLAY + serve — when the committed FSMap
(MMDSMap) names it rank 0 (MDSDaemon::handle_mds_map state machine,
boot → standby → replay → active).  Without a monmap it activates
immediately (library/embedded use).

The port's copy of `ceph_tpu/mds/mds.py`.  Where it differs:

- Only a missing object is absent (ROADMAP C29, C26's rule): a fresh
  filesystem is made only when `mds_inotable` does not exist, a missing
  journal, journal head, completed table or dirfrag reads as empty, and
  every other error of those reads (an EIO from a degraded read whose
  decode failed) fails what needed it.  At activation that fails the
  activation: the daemon records the error in `failed` and stops, so it
  never serves a namespace it could not read, and in mon mode its
  beacons stop and the monitor's grace hands rank 0 to a standby.  In a
  request it fails the request with the error's errno, and the dirfrag
  is not cached, so no empty frag is written back over a real one.  The
  reference catches every exception there: it re-makes the filesystem
  over live metadata, drops acknowledged journal events, and treats an
  unreadable dirfrag as empty.
- A device error (`ops.guard.is_device_error`) on any path of the daemon
  (a request, the flush, the activation) stops it and is recorded in
  `failed`, as a monitor's or the mgr's does; a request that met it is
  answered -EIO first.  The flush loop still retries any other error at
  its next tick.
- The revoke wait judges its own lateness (C21's rule for the election
  timer): it waits in slices of `REVOKE_SLICE`, and a slice that woke
  late counts only its own length toward the holders' silence, so it
  waits again before it drops a silent holder (`revoke_stalls` counts
  slices that woke more than half a slice late).  A held event loop thus
  does not drop a holder whose ack is a few loop turns away and grant the
  cap while that holder's writes are in flight.
- `keyring=`: cephx for the daemon's messenger and its `MonClient`, as
  the port's mgr takes one; a create may name its file's layout
  (`CephFSClient(layout=)`), checked here.
"""

from __future__ import annotations

import asyncio
import json
import time

from ..client.absent import parse_json, unless_absent
from ..client.rados import RadosError
from ..common.errs import EAGAIN as EAGAIN_
from ..common.errs import EEXIST, EINVAL, EIO, ENOENT, ENOTDIR, ENOTEMPTY
from ..common.log import dout
from ..msg.messages import (
    MClientCaps,
    MClientReply,
    MClientRequest,
    MMDSBeacon,
    MMDSMap,
)
from ..msg.messenger import Connection, Dispatcher, Messenger
from ..ops.guard import is_device_error

ROOT_INO = 1  # MDS_INO_ROOT
INOTABLE_OID = "mds_inotable"
JOURNAL_OID = "mds_journal"
JOURNAL_HEAD_OID = "mds_journal_head"
COMPLETED_OID = "mds_completed"  # journaled (client, tid) reply records
COMPLETED_CAP = 1024  # retained completed-request records (oldest drop)
# ops whose re-execution is NOT idempotent: their results are journaled
# per (client, tid) so a retry after failover replays the recorded reply
# (Server::handle_client_request's completed_requests check) instead of
# re-running and surfacing spurious EEXIST/ENOENT
MUTATING_OPS = frozenset(
    ("mkdir", "create", "symlink", "unlink", "rmdir", "rename", "setattr")
)
FLUSH_INTERVAL = 0.5
JOURNAL_FLUSH_BYTES = 1 << 20
REVOKE_TIMEOUT = 3.0  # mds_session_timeout scaled down
REVOKE_SLICES = 10  # the port's revoke wait, in slices of REVOKE_SLICE
REVOKE_SLICE = REVOKE_TIMEOUT / REVOKE_SLICES
BEACON_INTERVAL = 1.0  # mds_beacon_interval (scaled down)


class MDS(Dispatcher):
    """One metadata server daemon (standby until the FSMap says active)."""

    def __init__(self, meta_ioctx=None, data_ioctx=None,
                 addr: str = "127.0.0.1:0",
                 layout: dict | None = None, stack: str = "posix",
                 name: str = "0", monmap=None, rados=None,
                 admin_socket: str = "", keyring=None):
        self._admin_socket_path = admin_socket
        self.admin_socket = None
        self.meta = meta_ioctx
        self.data = data_ioctx
        self.name = name
        self.monmap = monmap
        # with `rados`, pools bind at PROMOTION from the fsmap's
        # assignment (the reference's MDSRank opening the metadata pool
        # named by its MDSMap); fixed ioctxs are the embedded path
        self.rados = rados
        self.fs_name = ""  # filesystem this daemon holds rank 0 of
        self.monc = None
        self.state = "boot"  # boot -> standby -> replay -> active
        self.mdsmap_epoch = 0
        self._beacon_task: asyncio.Task | None = None
        self._activate_task: asyncio.Task | None = None
        self.layout = layout or {
            "stripe_unit": 64 * 1024, "stripe_count": 2, "object_size": 1 << 20
        }
        self._bind_addr = addr
        self._stack = stack
        # the port's: with a keyring the daemon runs cephx like the mgr
        self._auth = None
        if keyring is not None:
            from ..auth.cephx import CephxAuth

            self._auth = CephxAuth.for_daemon(f"mds.{name}", keyring)
        self.msgr = Messenger(f"mds.{name}", stack=stack, auth=self._auth)
        self.msgr.add_dispatcher_head(self)
        # the error that stopped this daemon, if one did; revoke waits
        # that woke too late to drop a holder (C21's rule)
        self.failed: BaseException | None = None
        self.revoke_stalls = 0
        self._stop_task: asyncio.Task | None = None
        self._early_flush: asyncio.Task | None = None
        # dirfrag cache: ino -> {name: entry dict}; which are dirty
        self._dirs: dict[int, dict] = {}
        self._dirty: set[int] = set()
        self._next_ino = 0
        self._ino_dirty = False
        self._journal_seq = 0
        self._journal_bytes = 0
        # completed non-idempotent requests: (client, tid) -> recorded
        # reply.  Journaled (write-ahead) and persisted at flush, so a
        # promoted standby serves a retried mkdir/create/unlink/rename
        # its ORIGINAL result instead of re-executing it.
        from collections import OrderedDict

        self._completed: "OrderedDict[tuple[str, int], dict]" = OrderedDict()
        self._completed_dirty = False
        self._flush_task: asyncio.Task | None = None
        self._running = False
        # caps: ino -> {conn: "r"|"w"} ; waiters for revoke acks
        self.caps: dict[int, dict[Connection, str]] = {}
        # (ino, tid) -> {"ev", "want", "requester"}: grant waits pending
        # on conflicting holders acking/releasing/dying
        self._revoke_waiters: dict[tuple[int, int], dict] = {}
        self._cap_tid = 0
        # file ino -> (parent dir ino, dentry name): lets handle-held ops
        # (setattr) address the INODE, immune to concurrent renames
        self._ino_loc: dict[int, tuple[int, str]] = {}
        from ..common.lockdep import make_async_lock

        # one mutation at a time (the MDS big lock; mds_lock in the ref)
        self._lock = make_async_lock("mds_big_lock")

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> None:
        await self.msgr.bind(self._bind_addr)
        self.addr = self.msgr.addr
        await self._start_admin_socket()
        if self.monmap is None:
            # embedded/library use: no mon control plane, activate now;
            # a failed activation stops the daemon and reaches the caller
            try:
                await self._activate()
            except Exception as e:
                await self._fail(e, "activation")
                raise
            return
        # Mon-managed: beacon as a standby; the FSMap decides who is
        # rank 0 (MDSDaemon boot → standby in handle_mds_map).
        from ..mon.client import MonClient

        self.state = "standby"
        self.monc = MonClient(
            f"mds.{self.name}", self.monmap,
            msgr=Messenger(f"mds.{self.name}", stack=self._stack, auth=self._auth),
        )
        self.monc.msgr.add_dispatcher_tail(self)  # MMDSMap arrives here
        await self.monc.subscribe("mdsmap")
        self._beacon_task = asyncio.create_task(self._beacon_loop())

    async def _start_admin_socket(self) -> None:
        """MDS admin socket (MDSDaemon::asok_command): status, session
        and cap introspection — what `ceph tell mds.<x> ...` reaches."""
        if not self._admin_socket_path:
            return
        from ..common.admin_socket import AdminSocket

        sock = AdminSocket(self._admin_socket_path)
        sock.register(
            "status",
            lambda cmd: {
                "name": self.name,
                "state": f"up:{self.state}" if self.state != "boot" else "boot",
                "fs": self.fs_name,
                "mdsmap_epoch": self.mdsmap_epoch,
                "journal_seq": self._journal_seq,
                "dirty_dirfrags": len(self._dirty),
            },
            "this MDS's state (MDSDaemon::dump_status)",
        )
        sock.register(
            "session ls",
            lambda cmd: [
                {
                    "client": getattr(conn, "peer_name", ""),
                    "caps": sum(
                        1 for holders in self.caps.values() if conn in holders
                    ),
                }
                for conn in {
                    c for holders in self.caps.values() for c in holders
                }
            ],
            "connected cap-holding sessions (Server::dump_sessions)",
        )
        sock.register(
            "dump caps",
            lambda cmd: {
                str(ino): {
                    getattr(c, "peer_name", "?"): mode
                    for c, mode in holders.items()
                }
                for ino, holders in self.caps.items()
            },
            "granted capabilities per inode (Locker state)",
        )
        await sock.start()
        self.admin_socket = sock

    async def _activate(self, fs: dict | None = None) -> None:
        """standby → replay → active (MDSDaemon::boot_start / replay_done):
        bind the assigned filesystem's pools, load the on-pool state,
        replay the journal, start serving."""
        self.state = "replay"
        if fs is not None and self.rados is not None:
            self.meta = await self.rados.open_ioctx(fs["meta_pool"])
            self.data = await self.rados.open_ioctx(fs["data_pool"])
        await self._load_or_mkfs()
        await self._replay_journal()
        self._running = True
        self.state = "active"
        self._flush_task = asyncio.create_task(self._flush_loop())
        dout(
            "mds", 1,
            f"mds.{self.name}: now active (rank 0"
            + (f" of {self.fs_name}" if self.fs_name else "") + ")",
        )

    async def _activate_or_fail(self, fs: dict) -> None:
        try:
            await self._activate(fs)
        except Exception as e:
            # not awaited: the stop cancels this task
            self._fail(e, "activation")

    def _fail(self, exc: BaseException, where: str) -> asyncio.Task:
        """Record the error that stops this daemon and stop it (the
        port's): it serves nothing more, and its beacons stop, so the
        monitor's grace hands its rank to a standby.  Returns the stop's
        task, which a caller may await."""
        if self.failed is None:
            self.failed = exc
            self._running = False
            dout("mds", 0, f"mds.{self.name}: {where} failed, stopping: {exc!r}")
            self._stop_task = asyncio.get_event_loop().create_task(self.stop(flush=False))
        return self._stop_task

    def _demote(self) -> None:
        """active → standby (fs removed / rank reassigned): stop serving
        and drop volatile state; the on-pool journal stays authoritative."""
        self._running = False
        if self._flush_task is not None:
            self._flush_task.cancel()
            self._flush_task = None
        self._dirs.clear()
        self._dirty.clear()
        self._ino_dirty = False
        self._completed.clear()  # reloaded from pool+journal on promotion
        self._completed_dirty = False
        self.caps.clear()
        self._revoke_waiters.clear()
        self._ino_loc.clear()
        self._journal_seq = 0
        self._journal_bytes = 0
        self.fs_name = ""
        self.state = "standby"
        dout("mds", 1, f"mds.{self.name}: demoted to standby")

    async def _beacon_loop(self) -> None:
        while True:
            # the daemon's RADOS client instance rides the beacon so the
            # mon can fence exactly this instance's pool I/O on failover
            client = ""
            if self.rados is not None and getattr(self.rados, "objecter", None):
                client = self.rados.objecter.reqid_name
            beacon = MMDSBeacon(
                name=self.name, addr=self.msgr.addr, state=self.state,
                client=client,
            )
            for mon_name in self.monmap.ranks:
                try:
                    await self.monc.msgr.send_to(
                        self.monmap.addrs[mon_name], beacon
                    )
                except ConnectionError:
                    continue
            try:
                await self.monc.resubscribe()
            except ConnectionError:
                pass
            await asyncio.sleep(BEACON_INTERVAL)

    def _handle_mds_map(self, msg: MMDSMap) -> None:
        if msg.epoch <= self.mdsmap_epoch:
            return
        self.mdsmap_epoch = msg.epoch
        mine = ""
        my_fs = None
        for fs_name, fs in msg.filesystems().items():
            if fs.get("active_name") == self.name:
                mine, my_fs = fs_name, fs
                break
        if mine and self.state == "standby" and self._activate_task is None:
            self.fs_name = mine
            task = asyncio.create_task(self._activate_or_fail(my_fs))
            task.add_done_callback(lambda _t: setattr(self, "_activate_task", None))
            self._activate_task = task
        elif not mine and self.state in ("replay", "active"):
            if self._activate_task is not None:
                self._activate_task.cancel()
                self._activate_task = None
            self._demote()

    async def stop(self, flush: bool = True) -> None:
        """flush=False models a CRASH: dirty dirfrags are abandoned and
        the journal must make the next active whole (replay test hook)."""
        was_active = self._running
        self._running = False
        for t in (self._flush_task, self._beacon_task, self._activate_task):
            if t is not None:
                t.cancel()
        self._flush_task = self._beacon_task = self._activate_task = None
        if was_active and flush:
            await self._flush()
        if self.admin_socket is not None:
            await self.admin_socket.stop()
            self.admin_socket = None
        if self.monc is not None:
            await self.monc.msgr.shutdown()
            self.monc = None
        await self.msgr.shutdown()

    async def _load_or_mkfs(self) -> None:
        raw = await unless_absent(self.meta.read(INOTABLE_OID))
        if raw is None:
            # fresh fs (ceph fs new): root dir + inotable; only a missing
            # inotable makes one, never an error reading it (C29)
            self._next_ino = 2
            await self.meta.write_full(
                INOTABLE_OID, json.dumps({"next": 2}).encode()
            )
            await self.meta.write_full(f"dir.{ROOT_INO}", b"{}")
        else:
            self._next_ino = json.loads(raw.decode())["next"]
        # fresh fs / pre-upgrade pool: no completed table yet
        raw = await unless_absent(self.meta.read(COMPLETED_OID))
        for client, tid, rec in parse_json(raw, []):
            self._completed[(client, int(tid))] = rec

    # -- journal (MDLog) -------------------------------------------------------

    async def _replay_journal(self) -> None:
        """Apply journaled events past the flushed sequence (MDLog replay:
        a crash between journal append and dirfrag write-back must lose
        nothing that was acknowledged to a client)."""
        head = parse_json(await unless_absent(self.meta.read(JOURNAL_HEAD_OID)), {})
        flushed = head.get("flushed", 0)
        raw = await unless_absent(self.meta.read(JOURNAL_OID))
        if raw is None:
            return
        replayed = 0
        for line in raw.splitlines():
            if not line.strip():
                continue
            try:
                ev = json.loads(line.decode())
            except json.JSONDecodeError:
                break  # torn tail: a partial append never acked, drop it
            self._journal_seq = max(self._journal_seq, ev["seq"])
            if ev["seq"] <= flushed:
                continue
            await self._apply_event(ev)
            replayed += 1
        if replayed:
            dout("mds", 1, f"mds.0: replayed {replayed} journal events")
            self._journal_bytes = len(raw)

    async def _apply_event(self, ev: dict) -> None:
        op = ev["op"]
        if op == "set_dentry":
            d = await self._dir(ev["dir"])
            d[ev["name"]] = ev["entry"]
            self._dirty.add(ev["dir"])
            if ev["entry"].get("type") == "file":
                self._ino_loc[ev["entry"]["ino"]] = (ev["dir"], ev["name"])
        elif op == "rm_dentry":
            d = await self._dir(ev["dir"])
            gone = d.pop(ev["name"], None)
            self._dirty.add(ev["dir"])
            if gone and gone.get("type") == "file":
                # a rename's set_dentry already retargeted the map: only
                # drop it when it still points at the removed location
                if self._ino_loc.get(gone["ino"]) == (ev["dir"], ev["name"]):
                    del self._ino_loc[gone["ino"]]
        elif op == "mkdir_obj":
            self._dirs.setdefault(ev["ino"], {})
            self._dirty.add(ev["ino"])
        elif op == "rmdir_obj":
            self._dirs.pop(ev["ino"], None)
            self._dirty.discard(ev["ino"])
            # a replayed rmdir of an already-gone object is expected on
            # re-replay; any other error reaches the caller (C29)
            await unless_absent(self.meta.remove(f"dir.{ev['ino']}"))
        elif op == "inotable":
            self._next_ino = ev["next"]
            self._ino_dirty = True
        elif op == "completed_req":
            key = (ev["client"], int(ev["tid"]))
            self._completed[key] = {
                "result": ev.get("result", 0),
                "payload": ev["payload"],
            }
            self._completed.move_to_end(key)
            while len(self._completed) > COMPLETED_CAP:
                self._completed.popitem(last=False)
            self._completed_dirty = True

    async def _journal(self, *events: dict) -> None:
        """Append events durably BEFORE applying/replying (MDLog::submit +
        flush: the write-ahead property)."""
        lines = []
        for ev in events:
            self._journal_seq += 1
            ev["seq"] = self._journal_seq
            lines.append(json.dumps(ev).encode() + b"\n")
        blob = b"".join(lines)
        await self.meta.append(JOURNAL_OID, blob)
        self._journal_bytes += len(blob)
        for ev in events:
            await self._apply_event(ev)
        if self._journal_bytes > JOURNAL_FLUSH_BYTES and self._running:
            # size-triggered early flush (Journaler's segment threshold);
            # scheduled, not inline: _flush takes the big lock we hold
            self._early_flush = asyncio.get_event_loop().create_task(self._flush_once())

    async def _flush_once(self) -> None:
        """One flush; an error other than the device's is left to the
        next tick, a device error stops the daemon (the port's)."""
        try:
            await self._flush()
        except Exception as e:
            if is_device_error(e):
                self._fail(e, "flush")
                return
            dout("mds", 1, f"mds.{self.name}: flush failed: {e!r}")

    async def _flush_loop(self) -> None:
        while self._running:
            await asyncio.sleep(FLUSH_INTERVAL)
            await self._flush_once()

    async def _flush(self) -> None:
        """Write back dirty dirfrags, then trim the journal
        (Journaler::flush + LogSegment trim).  Runs under the big lock:
        a mutation journaled between the dirty-set snapshot and the trim
        would otherwise be cleared unwritten and trimmed — losing acked
        metadata, the exact thing the journal exists to prevent."""
        async with self._lock:
            if (
                not self._dirty
                and not self._ino_dirty
                and not self._completed_dirty
            ):
                return
            for ino in sorted(self._dirty):
                await self.meta.write_full(
                    f"dir.{ino}", json.dumps(self._dirs.get(ino, {})).encode()
                )
            self._dirty.clear()
            if self._ino_dirty:
                await self.meta.write_full(
                    INOTABLE_OID, json.dumps({"next": self._next_ino}).encode()
                )
                self._ino_dirty = False
            if self._completed_dirty:
                # the completed-request table must survive the journal
                # trim below: a trimmed completed_req event can no longer
                # be replayed, so the table itself is the durable record
                await self.meta.write_full(
                    COMPLETED_OID,
                    json.dumps(
                        [[c, t, rec] for (c, t), rec in self._completed.items()]
                    ).encode(),
                )
                self._completed_dirty = False
            await self.meta.write_full(
                JOURNAL_HEAD_OID,
                json.dumps({"flushed": self._journal_seq}).encode(),
            )
            await self.meta.write_full(JOURNAL_OID, b"")
            self._journal_bytes = 0

    # -- namespace helpers -----------------------------------------------------

    async def _dir(self, ino: int) -> dict:
        d = self._dirs.get(ino)
        if d is None:
            # only a missing dirfrag is empty: an unreadable one fails the
            # caller and stays uncached, so no empty frag is written back
            # over the real one (C29)
            d = parse_json(await unless_absent(self.meta.read(f"dir.{ino}")), {})
            self._dirs[ino] = d
            for name, entry in d.items():
                if entry.get("type") == "file":
                    self._ino_loc.setdefault(entry["ino"], (ino, name))
        return d

    @staticmethod
    def _split(path: str) -> list[str]:
        return [p for p in path.split("/") if p]

    async def _walk(self, path: str) -> tuple[int, dict]:
        ino = ROOT_INO
        d = await self._dir(ino)
        for part in self._split(path):
            entry = d.get(part)
            if entry is None:
                raise _Err(ENOENT, f"{path}: no such entry {part!r}")
            if entry["type"] != "dir":
                raise _Err(ENOTDIR, f"{path}: {part!r} is a file")
            ino = entry["ino"]
            d = await self._dir(ino)
        return ino, d

    async def _walk_parent(self, path: str) -> tuple[int, dict, str]:
        parts = self._split(path)
        if not parts:
            raise _Err(EINVAL, "root has no parent")
        ino, d = await self._walk("/".join(parts[:-1]))
        return ino, d, parts[-1]

    # -- dispatch --------------------------------------------------------------

    def ms_dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, MMDSMap):
            if self.failed is None:
                self._handle_mds_map(msg)
            return True
        if isinstance(msg, MClientRequest):
            if self.failed is not None or (
                self.state not in ("active",) and self.monmap is not None
            ):
                # not rank 0 (standby, or mid-replay): clients must
                # re-resolve the active from the mdsmap and retry
                # (the reference returns CEPH_MDS_STATE-gated ESTALE)
                async def _reject() -> None:
                    try:
                        await conn.send_message(
                            MClientReply(
                                tid=msg.tid, result=-EAGAIN_, payload=b"{}"
                            )
                        )
                    except ConnectionError:
                        pass

                asyncio.get_event_loop().create_task(_reject())
                return True
            asyncio.get_event_loop().create_task(self._handle(conn, msg))
            return True
        if isinstance(msg, MClientCaps):
            if msg.op in (MClientCaps.ACK, MClientCaps.RELEASE):
                # a revoke-ack IS the release of the revoked caps
                self._drop_cap(msg.ino, conn)
            return True
        return False

    def ms_handle_reset(self, conn: Connection) -> None:
        """Session death releases its caps (Session teardown in Server.cc)."""
        for ino in list(self.caps):
            self._drop_cap(ino, conn)

    def _invalidate_caps(self, ino: int) -> None:
        """The inode is gone (unlink / rename-over): revoke every holder
        (fire-and-forget; the handle is invalid regardless) and clear the
        cap table so nothing leaks."""
        for holder in list(self.caps.pop(ino, {})):
            self._cap_tid += 1
            push = MClientCaps(
                op=MClientCaps.REVOKE, ino=ino, caps="", tid=self._cap_tid
            )

            async def _send(holder=holder, push=push) -> None:
                try:
                    await holder.send_message(push)
                except ConnectionError:
                    pass

            asyncio.get_event_loop().create_task(_send())
        self._check_grant_waiters(ino)

    def _drop_cap(self, ino: int, conn: Connection) -> None:
        holders = self.caps.get(ino)
        if holders and conn in holders:
            del holders[conn]
            if not holders:
                del self.caps[ino]
        self._check_grant_waiters(ino)

    def _check_grant_waiters(self, ino: int) -> None:
        """Wake grant waits whose conflicts are gone (acked, released, or
        session-reset)."""
        for (w_ino, _tid), w in list(self._revoke_waiters.items()):
            if w_ino != ino:
                continue
            remaining = [
                c
                for c in self._conflicting_holders(ino, w["want"])
                if c is not w["requester"]
            ]
            if not remaining:
                w["ev"].set()

    async def _handle(self, conn: Connection, msg: MClientRequest) -> None:
        try:
            args = json.loads(msg.args.decode() or "{}")
            key = None
            client = getattr(msg, "client", "") or ""
            if client:
                key = (client, int(msg.tid))
            async with self._lock:
                done = self._completed.get(key) if key is not None else None
                if done is not None:
                    # a retry of an already-applied request (stable reqid
                    # across resends): replay the recorded reply instead
                    # of re-executing — re-running mkdir/create/unlink/
                    # rename would return spurious EEXIST/ENOENT after a
                    # failover even though the ORIGINAL attempt succeeded
                    payload = done["payload"]
                    await self._reissue_caps(conn, payload)
                else:
                    payload = await self._dispatch_op(conn, msg.op, args)
                    if key is not None and msg.op in MUTATING_OPS:
                        # journal the completion write-ahead of the reply:
                        # a crash between apply and this record at worst
                        # re-executes (today's behavior); a crash after it
                        # replays the right answer
                        await self._journal(
                            {
                                "op": "completed_req",
                                "client": client,
                                "tid": int(msg.tid),
                                "result": 0,
                                "payload": payload,
                            }
                        )
            reply = MClientReply(
                tid=msg.tid, result=0, payload=json.dumps(payload).encode()
            )
        except _Err as e:
            reply = MClientReply(tid=msg.tid, result=e.errno, payload=b"{}")
        except RadosError as e:
            # the pool's error (an EIO of a degraded read) is the op's
            reply = MClientReply(tid=msg.tid, result=e.errno, payload=b"{}")
        except Exception as e:  # a server bug must not wedge the client
            if is_device_error(e):
                # answered first, then the daemon stops (the port's)
                reply = MClientReply(tid=msg.tid, result=-EIO, payload=b"{}")
                try:
                    await conn.send_message(reply)
                except ConnectionError:
                    pass
                self._fail(e, f"request {msg.op}")
                return
            dout("mds", 0, f"mds.{self.name}: {msg.op} raised {e!r}")
            reply = MClientReply(tid=msg.tid, result=-EINVAL, payload=b"{}")
        try:
            await conn.send_message(reply)
        except ConnectionError:
            pass

    async def _reissue_caps(self, conn: Connection, payload: dict) -> None:
        """A replayed create/open result promised capabilities: grant
        them to the retrying session (the original grant died with the
        failed-over daemon), or the client's next data op would bounce
        off the cap check it believes it passed."""
        entry = payload.get("entry") if isinstance(payload, dict) else None
        caps = payload.get("caps") if isinstance(payload, dict) else None
        if entry and caps:
            await self._acquire_caps(conn, entry["ino"], caps)

    async def _dispatch_op(self, conn, op: str, args: dict) -> dict:
        if op == "mkdir":
            return await self._op_mkdir(args)
        if op == "create":
            return await self._op_create(conn, args)
        if op == "lookup":
            return await self._op_lookup(args)
        if op == "readdir":
            ino, d = await self._walk(args["path"])
            return {"entries": sorted(d)}
        if op == "readdirplus":
            # Server::handle_client_readdir with stat records inline (the
            # reference's readdir returns full InodeStats per dentry)
            ino, d = await self._walk(args["path"])
            return {"entries": {n: d[n] for n in sorted(d)}}
        if op == "unlink":
            return await self._op_unlink(args)
        if op == "rmdir":
            return await self._op_rmdir(args)
        if op == "rename":
            return await self._op_rename(args)
        if op == "setattr":
            return await self._op_setattr(conn, args)
        if op == "open":
            return await self._op_open(conn, args)
        if op == "symlink":
            return await self._op_symlink(args)
        if op == "readlink":
            return await self._op_readlink(args)
        raise _Err(EINVAL, f"unknown mds op {op!r}")

    async def _op_mkdir(self, args) -> dict:
        pino, pdir, name = await self._walk_parent(args["path"])
        if name in pdir:
            raise _Err(EEXIST, f"{args['path']} exists")
        ino = self._next_ino
        entry = {"ino": ino, "type": "dir", "mtime": time.time()}
        await self._journal(
            {"op": "inotable", "next": ino + 1},
            {"op": "mkdir_obj", "ino": ino},
            {"op": "set_dentry", "dir": pino, "name": name, "entry": entry},
        )
        return {"ino": ino}

    async def _op_create(self, conn, args) -> dict:
        pino, pdir, name = await self._walk_parent(args["path"])
        if name in pdir:
            raise _Err(EEXIST, f"{args['path']} exists")
        ino = self._next_ino
        entry = {
            "ino": ino,
            "type": "file",
            "size": 0,
            "mtime": time.time(),
            "layout": _layout(args.get("layout")) or dict(self.layout),
        }
        await self._journal(
            {"op": "inotable", "next": ino + 1},
            {"op": "set_dentry", "dir": pino, "name": name, "entry": entry},
        )
        caps = await self._acquire_caps(conn, ino, args.get("caps", "w"))
        return {"entry": entry, "caps": caps}

    async def _op_symlink(self, args) -> dict:
        """Server::handle_client_symlink: a dentry of type symlink whose
        target string lives in the entry (CInode symlink member)."""
        pino, pdir, name = await self._walk_parent(args["path"])
        if name in pdir:
            raise _Err(EEXIST, f"{args['path']} exists")
        ino = self._next_ino
        entry = {
            "ino": ino, "type": "symlink", "target": args["target"],
            "mtime": time.time(),
        }
        await self._journal(
            {"op": "inotable", "next": ino + 1},
            {"op": "set_dentry", "dir": pino, "name": name, "entry": entry},
        )
        return {"entry": entry}

    async def _op_readlink(self, args) -> dict:
        pino, pdir, name = await self._walk_parent(args["path"])
        entry = pdir.get(name)
        if entry is None:
            raise _Err(ENOENT, args["path"])
        if entry["type"] != "symlink":
            raise _Err(EINVAL, f"{args['path']} is not a symlink")
        return {"target": entry["target"]}

    async def _op_lookup(self, args) -> dict:
        pino, pdir, name = await self._walk_parent(args["path"])
        entry = pdir.get(name)
        if entry is None:
            raise _Err(ENOENT, args["path"])
        return {"entry": entry}

    async def _op_unlink(self, args) -> dict:
        pino, pdir, name = await self._walk_parent(args["path"])
        entry = pdir.get(name)
        if entry is None:
            raise _Err(ENOENT, args["path"])
        if entry["type"] == "dir":
            raise _Err(EINVAL, f"{args['path']} is a directory (use rmdir)")
        await self._journal(
            {"op": "rm_dentry", "dir": pino, "name": name}
        )
        # open holders lose their caps: the inode is gone and the client
        # will purge its data objects (cap invalidation on unlink)
        self._invalidate_caps(entry["ino"])
        return {"entry": entry}  # client purges the data objects

    async def _op_rmdir(self, args) -> dict:
        pino, pdir, name = await self._walk_parent(args["path"])
        entry = pdir.get(name)
        if entry is None:
            raise _Err(ENOENT, args["path"])
        if entry["type"] != "dir":
            raise _Err(ENOTDIR, args["path"])
        if await self._dir(entry["ino"]):
            raise _Err(ENOTEMPTY, args["path"])
        await self._journal(
            {"op": "rm_dentry", "dir": pino, "name": name},
            {"op": "rmdir_obj", "ino": entry["ino"]},
        )
        return {}

    async def _op_rename(self, args) -> dict:
        sparts = self._split(args["src"])
        dparts = self._split(args["dst"])
        if sparts == dparts:
            # self-rename is a no-op, NOT set+remove of the same dentry
            _pino, pdir, name = await self._walk_parent(args["src"])
            entry = pdir.get(name)
            if entry is None:
                raise _Err(ENOENT, args["src"])
            return {"entry": entry, "replaced": None}
        if dparts[: len(sparts)] == sparts:
            # moving a directory into its own subtree detaches it into an
            # unreachable cycle (fs.py guards identically)
            raise _Err(EINVAL, f"cannot move {args['src']} into itself")
        spino, spdir, sname = await self._walk_parent(args["src"])
        entry = spdir.get(sname)
        if entry is None:
            raise _Err(ENOENT, args["src"])
        dpino, dpdir, dname = await self._walk_parent(args["dst"])
        existing = dpdir.get(dname)
        events = []
        if existing is not None:
            if existing["type"] == "dir" and await self._dir(existing["ino"]):
                raise _Err(ENOTEMPTY, args["dst"])
            if existing["type"] != entry["type"]:
                raise _Err(EINVAL, "rename across entry types")
            if existing["type"] == "dir":
                # reclaim the replaced empty directory's dirfrag object
                events.append({"op": "rmdir_obj", "ino": existing["ino"]})
            else:
                self._invalidate_caps(existing["ino"])  # replaced-over file
        events += [
            {"op": "set_dentry", "dir": dpino, "name": dname, "entry": entry},
            {"op": "rm_dentry", "dir": spino, "name": sname},
        ]
        await self._journal(*events)
        return {"entry": entry, "replaced": existing}

    async def _op_setattr(self, conn, args) -> dict:
        """Handle-held attribute updates address the INODE when the client
        supplies it: a concurrent rename (or replace-by-create at the old
        path) must never let one file's setattr land on another."""
        want_ino = args.get("ino")
        if want_ino is not None and conn not in self.caps.get(want_ino, {}):
            # a revoked holder's straggling size update must not land
            # after the new holder's grant (Locker's cap check on flush)
            raise _Err(EAGAIN_, f"ino {want_ino}: caps not held")
        if want_ino is not None and want_ino in self._ino_loc:
            pino, name = self._ino_loc[want_ino]
            pdir = await self._dir(pino)
        else:
            pino, pdir, name = await self._walk_parent(args["path"])
        entry = pdir.get(name)
        if entry is None:
            raise _Err(ENOENT, args["path"])
        if want_ino is not None and entry["ino"] != want_ino:
            raise _Err(ENOENT, f"{args['path']}: stale handle (renamed over)")
        entry = dict(entry)
        for field in ("size", "mtime"):
            if field in args:
                entry[field] = args[field]
        await self._journal(
            {"op": "set_dentry", "dir": pino, "name": name, "entry": entry}
        )
        return {"entry": entry}

    # -- capabilities (Locker.cc essence) --------------------------------------

    def _conflicting_holders(self, ino: int, want: str) -> list:
        holders = self.caps.get(ino, {})
        if want == "w":
            return list(holders)  # exclusive: anyone conflicts
        return [c for c, m in holders.items() if m == "w"]

    async def _acquire_caps(self, conn, ino: int, want: str) -> str:
        """Grant caps, revoking conflicting holders first (Locker's
        issue/revoke cycle).  The grant WAITS for every conflicting holder
        to ack/release (or die, or time out) — granting early would let
        the old holder's in-flight writes land after the new holder's
        open returns, the exact race revocation exists to prevent."""
        conflicts = [
            c for c in self._conflicting_holders(ino, want) if c is not conn
        ]
        if conflicts:
            self._cap_tid += 1
            tid = self._cap_tid
            ev = asyncio.Event()
            self._revoke_waiters[(ino, tid)] = {
                "ev": ev, "want": want, "requester": conn
            }
            for holder in conflicts:
                try:
                    await holder.send_message(
                        MClientCaps(
                            op=MClientCaps.REVOKE, ino=ino, caps="", tid=tid
                        )
                    )
                except ConnectionError:
                    self._drop_cap(ino, holder)  # dead session forfeits now
            self._check_grant_waiters(ino)
            loop = asyncio.get_event_loop()
            # the port's: the wait runs in slices, and a slice counts only
            # its own length toward the holders' silence, however late it
            # woke: the loop that would have taken their acks was held
            # for the rest, so a held loop never drops a holder whose ack
            # is a few turns away
            slices = 0
            try:
                while slices < REVOKE_SLICES:
                    due = loop.time() + REVOKE_SLICE
                    try:
                        await asyncio.wait_for(ev.wait(), REVOKE_SLICE)
                        break
                    except asyncio.TimeoutError:
                        pass
                    slices += 1
                    if loop.time() - due > REVOKE_SLICE / 2:
                        self.revoke_stalls += 1
                        dout("mds", 5, f"mds.{self.name}: revoke wait on {ino} woke "
                                       f"{loop.time() - due:.3f} s late")
                else:
                    # unresponsive holders forfeit (mds_session_timeout)
                    for holder in [
                        c
                        for c in self._conflicting_holders(ino, want)
                        if c is not conn
                    ]:
                        self._drop_cap(ino, holder)
            finally:
                self._revoke_waiters.pop((ino, tid), None)
        self.caps.setdefault(ino, {})[conn] = want
        return want

    async def _op_open(self, conn, args) -> dict:
        pino, pdir, name = await self._walk_parent(args["path"])
        entry = pdir.get(name)
        if entry is None:
            raise _Err(ENOENT, args["path"])
        if entry["type"] != "file":
            raise _Err(EINVAL, f"{args['path']} is a directory")
        caps = await self._acquire_caps(conn, entry["ino"], args.get("caps", "r"))
        return {"entry": entry, "caps": caps}


def _layout(raw) -> dict | None:
    """A client's file layout, checked (the striper's rules), or None
    when it named none."""
    if raw is None:
        return None
    try:
        lay = {k: int(raw[k]) for k in ("stripe_unit", "stripe_count", "object_size")}
    except (KeyError, TypeError, ValueError):
        raise _Err(EINVAL, f"bad layout {raw!r}") from None
    if min(lay.values()) <= 0 or lay["object_size"] % lay["stripe_unit"]:
        raise _Err(EINVAL, f"bad layout {raw!r}")
    return lay


class _Err(Exception):
    def __init__(self, err: int, msg: str = ""):
        self.errno = -abs(err)
        super().__init__(msg)
