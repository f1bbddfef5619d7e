"""OSD daemons over a messenger, with monitors and a mgr or a stand-in map
service, and a small client, for either package.

`DaemonCluster(root, ...)` starts, from the modules of the package named
`root` (`"ceph_tpu"` or `"ceph_tpu_torch"`), one `MapService` and
`n_osds` real `OSD` daemons (`osd/osd.py`), each on its own messenger of
that package (`stack`: `inproc` or `posix` on loopback), with cephx on
when a keyring is asked for.  The daemons boot through their `MonClient`
as they would against monitors; the map service answers them, and
`DaemonClient` sends client ops over the wire.

`MapService` is a `Dispatcher` on the package's own `Messenger`.  It does
for the daemons what the monitor's `OSDMonitor` does and nothing more:

- `MMonSubscribe` for `osdmap`: the full map to a new subscriber, then
  the incrementals it lacks (`OSDMonitor.check_sub`); `config`: an
  empty `MConfig` (no option is managed centrally here); `mgrmap`:
  nothing (no mgr runs here);
- `MMonCommand`: `osd pool selfmanaged-snap-create` only (the pool's
  snap id allocator, for RBD's snapshots), in a full-map epoch;
- `MOSDBoot`: the OSD is marked up at its address in a new epoch
  (`prepare_boot`).  The first boots share one epoch, published once every
  OSD has booted, so a run's epochs do not depend on timing; later boots
  that arrive within `boot_batch` seconds of one another share one, as
  the monitor's pending incremental does;
- `MOSDFailure`: kept in `failure_reports`, and the target is marked down
  once `min_down_reporters` distinct daemons report it
  (`prepare_failure`), unless `honor_failures` is false (a laggy report,
  which never marks down, is dropped);
- `MLog`: entries kept in `log`;
- `mark_out`, `mark_in`, `mark_down` and `set_tier` are the operator's
  commands, each an `Incremental` (the tier change a full-map epoch, as
  the monitor's tier commands make it).

The map is built as `tests/torch_pg_host.py` builds it (a flat CRUSH tree,
one OSD a host, pools made as the monitor makes them), with every OSD down
until it boots.

`DaemonClient` maps an object to its primary with the package's own
OSDMap, sends `MOSDOp`, waits for `MOSDOpReply`, and resends on a newer
map, on -EAGAIN or when the reply does not come.  It can hold a watch
and acks notifies as the reference's `Objecter` does.

With `mons=N`, `DaemonCluster` starts N real `Monitor`s and one `Mgr` of
the package in place of `MapService`: the daemons boot through
`OSDMonitor.prepare_boot`, failure reports and the down-out timer are the
monitor's, the pools are made by commands (`osd erasure-code-profile
set`, `osd pool create`), and `mark_out` / `mark_in` / `set_tier` /
`config_set` are `MMonCommand`s (coroutines there).  The first boots are
then not one epoch: compare such clusters by end states, not epochs.

This module imports neither package by name: the tests run one cluster
of each and compare them, and `chip_smoke.py` loads it by path and drives
the port's on the card.
"""

from __future__ import annotations

import asyncio
import importlib
import json
import os
import sys
import time
import uuid
from types import SimpleNamespace

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_pg_host import PgCluster  # noqa: E402  (pool construction)

CLIENT = "client.4100"


def modules(root: str) -> SimpleNamespace:
    def imp(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        root=root,
        messages=imp("msg.messages"),
        messenger=imp("msg.messenger"),
        osdmap=imp("osd.osdmap"),
        osd=imp("osd.osd"),
        config=imp("common.config"),
        crush=imp("crush.crush"),
        monmap=imp("mon.monmap"),
        mon=imp("mon.monitor"),
        monclient=imp("mon.client"),
        mgr=imp("mgr.mgr"),
        keyring=imp("auth.keyring"),
        cephx=imp("auth.cephx"),
        errs=imp("common.errs"),
    )


def free_port_addrs(names) -> dict:
    """Loopback host:port addresses, one a name, from ports the kernel
    handed out and this process released."""
    import socket

    socks, addrs = [], {}
    for name in names:
        s = socket.socket()
        s.bind(("127.0.0.1", 0))
        socks.append(s)
        addrs[name] = f"127.0.0.1:{s.getsockname()[1]}"
    for s in socks:
        s.close()
    return addrs


async def wait_until(pred, timeout: float, what: str = "", step: float = 0.005) -> None:
    """Poll `pred` until it holds; TimeoutError after `timeout` seconds."""
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(f"timed out after {timeout} s waiting for {what}")
        await asyncio.sleep(step)


class _MapServiceBody:
    """The body of `MapService`; the class itself also derives from the
    package's `Dispatcher` (`make_map_service`)."""

    def __init__(self, m, n_osds: int, pools: list[dict], *, stack: str = "inproc",
                 keyring=None, min_down_reporters: int = 2, honor_failures: bool = True,
                 boot_batch: float = 0.02, name: str = "mon.a"):
        self.m = m
        om = m.osdmap
        self.name = name
        self.stack = stack
        self.min_down_reporters = min_down_reporters
        self.honor_failures = honor_failures
        self.boot_batch = boot_batch
        osdmap = om.OSDMap()
        osdmap.fsid = f"daemon-host-{uuid.uuid4()}"
        osdmap.crush.build_flat(n_osds, 1)
        for i in range(n_osds):
            osdmap.add_osd(i, addr="", up=False)
        for spec in pools:
            PgCluster._create_pool(om, osdmap, spec)
        osdmap.epoch = 1
        self.osdmap = osdmap
        self.incrementals: dict[int, bytes] = {}
        self.full_epochs: set[int] = {1}
        self.subs: dict = {}  # conn -> {what: next epoch}
        self.failure_reports: dict[int, dict[str, float]] = {}
        self.log: list[dict] = []
        self._pending_up: dict[int, str] = {}
        self._boot_timer = None
        self.down_epochs: dict[int, int] = {}  # osd -> epoch it was marked down
        self.epoch_times: dict[int, float] = {1: time.monotonic()}
        auth = None
        if keyring is not None:
            auth = m.cephx.CephxAuth.for_daemon(name, keyring)
        self.msgr = m.messenger.Messenger(name, stack=stack, auth=auth)
        self.msgr.add_dispatcher_head(self)

    async def start(self, addr: str = "") -> str:
        if not addr:
            addr = "127.0.0.1:0" if self.stack == "posix" else ""
        await self.msgr.bind(addr)
        return self.msgr.addr

    async def stop(self) -> None:
        if self._boot_timer is not None:
            self._boot_timer.cancel()
        await self.msgr.shutdown()

    # -- dispatch ------------------------------------------------------------

    def ms_dispatch(self, conn, msg) -> bool:
        msgs = self.m.messages
        if isinstance(msg, msgs.MMonSubscribe):
            subs = self.subs.setdefault(conn, {})
            for what, start in msg.what.items():
                subs[what] = start
            if "osdmap" in msg.what:
                self._check_osdmap_sub(conn, subs)
            if "config" in msg.what:
                self._send(conn, msgs.MConfig(version=1, changes=b"{}"))
            return True
        if isinstance(msg, msgs.MOSDBoot):
            self._prepare_boot(msg)
            return True
        if isinstance(msg, msgs.MOSDFailure):
            self._prepare_failure(conn, msg)
            return True
        if isinstance(msg, msgs.MLog):
            self.log.extend(json.loads(msg.entries.decode() or "[]"))
            return True
        if isinstance(msg, msgs.MMonCommand):
            self._command(conn, msg)
            return True
        return False

    def _command(self, conn, msg) -> None:
        """`osd pool selfmanaged-snap-create` as `OSDMonitor` does it (the
        pool's `snap_seq` bumped in a new epoch, its value the answer);
        every other command -EINVAL."""
        msgs = self.m.messages
        cmd = json.loads(msg.cmd) if isinstance(msg.cmd, str) else msg.cmd
        if cmd.get("prefix") != "osd pool selfmanaged-snap-create":
            self._send(conn, msgs.MMonCommandAck(
                tid=msg.tid, retval=-self.m.errs.EINVAL,
                rs="the map service takes no other command", outbl=b""))
            return
        out = {}

        def mutate(m) -> None:
            pool = m.get_pool(cmd["pool"])
            pool.snap_seq += 1
            out["snap_id"] = pool.snap_seq

        self._change_full(mutate)
        self._send(conn, msgs.MMonCommandAck(tid=msg.tid, retval=0, rs="",
                                             outbl=json.dumps(out).encode()))

    def ms_handle_reset(self, conn) -> None:
        self.subs.pop(conn, None)

    def _send(self, conn, msg) -> None:
        async def _go():
            try:
                await conn.send_message(msg)
            except ConnectionError:
                pass

        asyncio.get_event_loop().create_task(_go())

    # -- osdmap ----------------------------------------------------------------

    def _check_osdmap_sub(self, conn, subs: dict) -> None:
        start = subs.get("osdmap", 0)
        if start > self.osdmap.epoch:
            return
        epochs = range(max(start, 1), self.osdmap.epoch + 1)
        maps, incs = {}, {}
        if start == 0 or any(e in self.full_epochs for e in epochs):
            maps[self.osdmap.epoch] = self.osdmap.tobytes()
        else:
            incs = {e: self.incrementals[e] for e in epochs}
        subs["osdmap"] = self.osdmap.epoch + 1
        self._send(conn, self.m.messages.MOSDMap(fsid=self.osdmap.fsid, maps=maps,
                                                 incrementals=incs))

    def _publish(self) -> None:
        for conn, subs in list(self.subs.items()):
            if "osdmap" in subs:
                self._check_osdmap_sub(conn, subs)

    def _change(self, **delta) -> int:
        om = self.m.osdmap
        inc = om.Incremental(epoch=self.osdmap.epoch + 1, **delta)
        blob = inc.tobytes()
        self.osdmap = om.Incremental.frombytes(blob).apply_to(self.osdmap)
        self.incrementals[inc.epoch] = blob
        self.epoch_times[inc.epoch] = time.monotonic()
        for osd in delta.get("new_down", ()):
            self.down_epochs[osd] = inc.epoch
        self._publish()
        return inc.epoch

    def _change_full(self, mutate) -> int:
        """A structural change (the tier commands): the next epoch is a
        full map."""
        om = self.m.osdmap
        new = om.OSDMap.frombytes(self.osdmap.tobytes())
        mutate(new)
        new.epoch = self.osdmap.epoch + 1
        inc = om.Incremental(epoch=new.epoch, full_map=new.tobytes())
        self.osdmap = om.Incremental.frombytes(inc.tobytes()).apply_to(self.osdmap)
        self.incrementals[new.epoch] = inc.tobytes()
        self.full_epochs.add(new.epoch)
        self.epoch_times[new.epoch] = time.monotonic()
        self._publish()
        return new.epoch

    def _prepare_boot(self, msg) -> None:
        info = self.osdmap.osds.get(msg.osd)
        if info is not None and info.up and info.addr == msg.addr:
            return  # a duplicate boot
        self._pending_up[msg.osd] = msg.addr
        self.failure_reports.pop(msg.osd, None)
        if self.osdmap.epoch == 1 and len(self._pending_up) < len(self.osdmap.osds):
            return  # the first boots: one epoch once every OSD has booted
        if self._boot_timer is None:
            self._boot_timer = asyncio.get_event_loop().call_later(
                self.boot_batch, self._flush_boots)

    def _flush_boots(self) -> None:
        self._boot_timer = None
        pending, self._pending_up = self._pending_up, {}
        if pending:
            self._change(new_up=pending)

    def _prepare_failure(self, conn, msg) -> None:
        if msg.laggy:
            return
        reporter = conn.auth_entity or conn.peer_name or conn.peer_addr
        reporters = self.failure_reports.setdefault(msg.target, {})
        reporters[reporter] = time.monotonic()
        if not self.honor_failures or not self.osdmap.is_up(msg.target):
            return
        if len(reporters) >= self.min_down_reporters:
            self.failure_reports.pop(msg.target, None)
            self._change(new_down=[msg.target])

    # -- the operator's commands ----------------------------------------------

    def mark_down(self, osd: int) -> int:
        return self._change(new_down=[osd])

    def mark_out(self, osd: int) -> int:
        return self._change(new_weights={osd: 0})

    def mark_in(self, osd: int) -> int:
        return self._change(new_weights={osd: self.m.crush.WEIGHT_ONE})

    def set_tier(self, base: str, cache: str, mode: str = "writeback",
                 target_max_objects: int | None = None) -> int:
        """`osd tier add` + `cache-mode` + `set-overlay` (+ the cache pool's
        `target_max_objects`) in one full-map epoch."""

        def mutate(m) -> None:
            b, c = m.get_pool(base), m.get_pool(cache)
            c.tier_of = b.id
            if c.id not in b.tiers:
                b.tiers.append(c.id)
            c.cache_mode = mode
            b.read_tier = b.write_tier = c.id
            if target_max_objects is not None:
                c.target_max_objects = target_max_objects

        return self._change_full(mutate)


def make_map_service(m, *args, **kw):
    cls = type("MapService", (_MapServiceBody, m.messenger.Dispatcher), {})
    return cls(m, *args, **kw)


class _ClientBody:
    """The body of `DaemonClient`; the class also derives from the
    package's `Dispatcher` (`make_client`)."""

    def __init__(self, m, monmap, *, name: str = CLIENT, stack: str = "inproc",
                 auth=None, timeout: float = 30.0):
        self.m = m
        self.name = name
        self.stack = stack
        self.timeout = timeout
        self.msgr = m.messenger.Messenger(name, stack=stack, auth=auth)
        self.msgr.add_dispatcher_head(self)
        self.monmap = monmap
        self.osdmap = m.osdmap.OSDMap()
        self._map_event = asyncio.Event()
        self._replies: dict[int, asyncio.Future] = {}
        self._tid = 0
        self._placement: dict = {}
        self._mon_rank = 0
        self.watches: dict = {}  # (pool, oid, cookie) -> callback(notify_id, payload)
        self.notifies: list = []
        self.resends = 0

    async def connect(self) -> None:
        await self.msgr.bind("127.0.0.1:0" if self.stack == "posix" else "")
        addr = self.monmap.addr_of_rank(0)
        await self.msgr.send_to(addr, self.m.messages.MMonSubscribe(what={"osdmap": 0}))
        await wait_until(lambda: self.osdmap.epoch > 0, self.timeout, "the client's first map")

    def ms_handle_reset(self, conn) -> None:
        """The monitor holding the subscription went away: subscribe at
        the next one (as the port's MonClient hunts)."""
        if self.monmap.size() < 2 or conn.peer_addr != self.monmap.addr_of_rank(self._mon_rank):
            return

        async def _hunt():
            for _ in range(self.monmap.size()):
                self._mon_rank = (self._mon_rank + 1) % self.monmap.size()
                try:
                    await self.msgr.send_to(self.monmap.addr_of_rank(self._mon_rank),
                                            self.m.messages.MMonSubscribe(what={"osdmap": 0}))
                    return
                except ConnectionError:
                    continue

        self._hunt = asyncio.get_event_loop().create_task(_hunt())

    async def shutdown(self) -> None:
        await self.msgr.shutdown()

    # -- dispatch ---------------------------------------------------------------

    def ms_dispatch(self, conn, msg) -> bool:
        msgs = self.m.messages
        if isinstance(msg, msgs.MOSDMap):
            self.osdmap = self.m.osdmap.advance_map(self.osdmap, msg)
            self._map_event.set()
            self._map_event = asyncio.Event()
            return True
        if isinstance(msg, msgs.MOSDOpReply):
            fut = self._replies.pop(msg.reqid.tid, None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return True
        if isinstance(msg, msgs.MWatchNotify) and not msg.is_ack:
            self.notifies.append((msg.oid, msg.notify_id, msg.cookie, bytes(msg.payload)))
            cb = self.watches.get((msg.pgid.pool, msg.oid, msg.cookie))
            payload = (cb(msg.notify_id, msg.payload) or b"") if cb is not None else b""
            ack = msgs.MWatchNotify(oid=msg.oid, pgid=msg.pgid, notify_id=msg.notify_id,
                                    cookie=msg.cookie, payload=bytes(payload), is_ack=1,
                                    watcher=self.name)

            async def _ack():
                try:
                    await conn.send_message(ack)
                except ConnectionError:
                    pass

            asyncio.get_event_loop().create_task(_ack())
            return True
        return False

    # -- ops ----------------------------------------------------------------------

    def target(self, pool: str, oid: str):
        """(pgid, primary) under the client's map, through the overlay."""
        msgs = self.m.messages
        p = self.osdmap.get_pool(pool)
        pool_id = p.read_tier if p.read_tier >= 0 and p.read_tier in self.osdmap.pools else p.id
        key = (self.osdmap.epoch, pool_id, oid)
        hit = self._placement.get(key)
        if hit is None:
            _pool, ps = self.osdmap.object_to_pg(pool_id, oid)
            primary = self.osdmap.pg_to_up_acting_osds(pool_id, ps)[3]
            hit = self._placement[key] = (msgs.PgId(pool_id, ps, -1), primary)
            if len(self._placement) > 4096:
                self._placement.clear()
        return hit

    async def op(self, pool: str, oid: str, ops: list, *, snap_id: int = 0, snapc=None,
                 tid: int | None = None, timeout: float | None = None):
        """One client op: the reply (`MOSDOpReply`).  Resends with the same
        tid on a newer map, on -EAGAIN or when the reply is late."""
        msgs = self.m.messages
        EAGAIN = self.m.errs.EAGAIN
        if tid is None:
            self._tid += 1
            tid = self._tid
        deadline = time.monotonic() + (timeout or self.timeout)
        snap_seq, snaps = snapc if snapc is not None else (0, [])
        while True:
            if time.monotonic() > deadline:
                raise TimeoutError(f"op {tid} on {oid} timed out")
            pgid, primary = self.target(pool, oid)
            info = self.osdmap.osds.get(primary)
            if primary < 0 or info is None or not info.addr or not info.up:
                await self._wait_map(0.2)
                continue
            msg = msgs.MOSDOp(reqid=msgs.ReqId(self.name, tid), pgid=pgid, oid=oid, ops=ops,
                              epoch=self.osdmap.epoch, snap_seq=snap_seq, snaps=list(snaps),
                              snap_id=snap_id)
            msg.deadline = deadline
            fut = asyncio.get_event_loop().create_future()
            self._replies[tid] = fut
            epoch = self.osdmap.epoch
            map_event = self._map_event
            try:
                await self.msgr.send_to(info.addr, msg)
                done, _ = await asyncio.wait(
                    [fut, asyncio.ensure_future(map_event.wait())],
                    timeout=min(max(deadline - time.monotonic(), 0.01), 5.0),
                    return_when=asyncio.FIRST_COMPLETED)
            except ConnectionError:
                done = set()
            if fut.done():
                rep = fut.result()
                if rep.result != -EAGAIN:
                    return rep
                await self._wait_map(0.05)
            else:
                self._replies.pop(tid, None)
                if self.osdmap.epoch == epoch:
                    await self._wait_map(0.05)
            self.resends += 1

    async def _wait_map(self, timeout: float) -> None:
        try:
            await asyncio.wait_for(self._map_event.wait(), timeout)
        except asyncio.TimeoutError:
            pass

    def osd_op(self, code: str, **kw):
        OSDOp = self.m.messages.OSDOp
        return OSDOp(op=getattr(OSDOp, code), **kw)

    async def watch(self, pool: str, oid: str, cookie: int, cb=None):
        """Register a watch; `cb(notify_id, payload)` returns the ack's
        payload."""
        p = self.osdmap.get_pool(pool)
        pool_id = p.read_tier if p.read_tier >= 0 else p.id
        self.watches[(pool_id, oid, cookie)] = cb
        return await self.op(pool, oid, [self.osd_op("WATCH", off=cookie, len=1)])


def make_client(m, monmap, **kw):
    cls = type("DaemonClient", (_ClientBody, m.messenger.Dispatcher), {})
    return cls(m, monmap, **kw)


class DaemonCluster:
    """A map service (or `mons` monitors and a mgr), `n_osds` OSD daemons
    of package `root` and a client.

    `conf` is applied to every daemon (with `name`), `osd_conf(i)` adds
    per-daemon options, `device` is passed to the port's daemons
    (`OSD(..., device=)`) and monitors, `keyring` (a path, or True for a
    generated one in `root_dir`, with keys for the daemons and `clients`)
    turns cephx on, and `store` is `memstore` or `bluestore` (each
    daemon's in `root_dir/osd.N`).  `mon_conf` is applied to every
    monitor and the mgr, `mgr_modules(mgr)` may register modules, and
    `election_timeout` is the monitors' (the reference's default 0.5 s)."""

    MGR = "x"

    def __init__(self, root: str, n_osds: int, pools: list[dict], *, conf: dict | None = None,
                 osd_conf=None, device=None, stack: str = "inproc", keyring=None,
                 root_dir: str | None = None, store: str = "memstore",
                 honor_failures: bool = False, min_down_reporters: int = 2,
                 admin_sockets: bool = False, clients=(CLIENT, "client.77"),
                 mons: int = 0, mon_conf: dict | None = None, election_timeout: float = 0.5,
                 mgr_beacon: float = 1.0):
        self.m = modules(root)
        self.n_mons = mons
        self.mon_names = [chr(ord("a") + i) for i in range(mons)]
        self.mon_conf = dict(mon_conf or {})
        self.election_timeout = election_timeout
        self.mgr_beacon = mgr_beacon
        self.monitors: list = []
        self.mgr = None
        self.monc = None
        self.t_quorum = self.t_mgr = self.t_up = self.t_pools = None
        self.root = root
        self.n_osds = n_osds
        self.pools = pools
        self.conf = dict(conf or {})
        self.osd_conf = osd_conf or (lambda i: {})
        self.device = device
        self.stack = stack
        self.root_dir = root_dir
        self.store = store
        self.admin_sockets = admin_sockets
        self.keyring = None
        self.keyring_path = None
        if keyring:
            kr = self.m.keyring.KeyRing()
            mon_ents = [f"mon.{n}" for n in self.mon_names] or ["mon.a"]
            extra = [f"mgr.{self.MGR}", "client.admin"] if mons else []
            for ent in [*mon_ents, *extra, *clients] + [f"osd.{i}" for i in range(n_osds)]:
                kr.add(ent)
            self.keyring = kr
            if isinstance(keyring, str):
                self.keyring_path = keyring
            elif root_dir is not None:
                self.keyring_path = os.path.join(root_dir, "keyring")
            if self.keyring_path:
                kr.save(self.keyring_path)
        self.mon = None if mons else make_map_service(
            self.m, n_osds, pools, stack=stack, keyring=self.keyring,
            honor_failures=honor_failures, min_down_reporters=min_down_reporters)
        self.osds: list = [None] * n_osds
        self.monmap = None
        self.client = None

    def daemon_conf(self, i: int) -> dict:
        c = {"name": f"osd.{i}", "ms_type": self.stack, "osd_objectstore": self.store,
             **self.conf, **self.osd_conf(i)}
        if self.root_dir is not None:
            c.setdefault("osd_data", os.path.join(self.root_dir, f"osd.{i}"))
            if self.admin_sockets:
                c.setdefault("admin_socket", os.path.join(self.root_dir, f"osd.{i}.asok"))
        if self.keyring_path:
            c["keyring"] = self.keyring_path
        return c

    def make_osd(self, i: int, store=None):
        m = self.m
        conf = m.config.Config(self.daemon_conf(i), env=False)
        auth = None
        if self.keyring is not None and not self.keyring_path:
            auth = m.cephx.CephxAuth.for_daemon(f"osd.{i}", self.keyring)
        kw = {} if self.device is None else {"device": self.device}
        addr = "127.0.0.1:0" if self.stack == "posix" else ""
        return m.osd.OSD(i, self.monmap, conf=conf, store=store, addr=addr, auth=auth, **kw)

    # -- monitors and the mgr (mons > 0) ----------------------------------------

    def make_monitor(self, name: str):
        m = self.m
        conf = m.config.Config({"name": f"mon.{name}", "ms_type": self.stack,
                                **self.mon_conf}, env=False)
        kw = {} if self.device is None or self.root == "ceph_tpu" else {"device": self.device}
        if self.admin_sockets and self.root_dir is not None:
            kw["admin_socket"] = os.path.join(self.root_dir, f"mon.{name}.asok")
        return m.mon.Monitor(name, self.monmap, election_timeout=self.election_timeout,
                             conf=conf, keyring=self.keyring, stack=self.stack, **kw)

    def leader(self):
        """The monitor that leads the quorum, or None in an election."""
        for mon in self.monitors:
            if mon is not None and mon._tick_task is not None and mon.is_leader():
                return mon
        return None

    @property
    def osdmap(self):
        """The map source's committed map: the map service's, or the
        leading monitor's (a running one's when no leader is known)."""
        if self.mon is not None:
            return self.mon.osdmap
        mon = self.leader() or next(m for m in self.monitors
                                    if m is not None and m._tick_task is not None)
        return mon.osdmon.osdmap

    async def command(self, cmd: dict, timeout: float = 30.0):
        """One monitor command: (retval, rs, outbl); raises on an error,
        with every monitor's state."""
        rv, rs, out = await self.monc.command(cmd, timeout)
        if rv != 0:
            raise RuntimeError(f"{cmd['prefix']}: {rv} {rs}; monitors "
                               f"{json.dumps(self.monitor_states())}")
        return rv, rs, out

    def monitor_states(self) -> list:
        """What each monitor believes: its election, Paxos and OSDMonitor
        queue (for a failure's report)."""
        out = []
        for mon in self.monitors:
            p, e = mon.paxos, mon.elector
            out.append({
                "name": mon.name, "rank": mon.rank, "running": mon._tick_task is not None,
                "leader": mon.leader_rank, "quorum": mon.quorum, "epoch": e.epoch,
                "electing": e.electing, "deferred": e.deferred, "acked": sorted(e.acked),
                "leading": p.leading, "collecting": p._collecting,
                "collect_acks": sorted(p._collect_acks), "pn": p.accepted_pn,
                "last_committed": p.last_committed, "active": p._active_value is not None,
                "pending": len(p._pending), "osdmon_proposing": mon.osdmon._proposing,
                "osdmon_pending": len(mon.osdmon._pending), "osdmap": mon.osdmon.osdmap.epoch,
            })
        return out

    async def create_pools(self) -> None:
        """The pools of `pools`, made as an operator makes them."""
        for spec in self.pools:
            if spec["kind"] == "ec":
                profile = {"plugin": spec.get("plugin", "tpu"), "k": str(spec["k"]),
                           "m": str(spec["m"]), **spec.get("profile", {})}
                if "stripe_unit" in spec:
                    profile["stripe_unit"] = str(spec["stripe_unit"])
                await self.command({"prefix": "osd erasure-code-profile set",
                                    "name": f"prof_{spec['name']}",
                                    "profile": [f"{k}={v}" for k, v in profile.items()]})
                await self.command({"prefix": "osd pool create", "pool": spec["name"],
                                    "pool_type": "erasure", "pg_num": spec["pg_num"],
                                    "erasure_code_profile": f"prof_{spec['name']}",
                                    "allow_ec_overwrites": bool(spec.get("overwrites"))})
            else:
                await self.command({"prefix": "osd pool create", "pool": spec["name"],
                                    "pool_type": "replicated", "pg_num": spec["pg_num"],
                                    "size": int(spec.get("size", 3))})

    async def start_monitors(self, timeout: float = 30.0) -> None:
        m = self.m
        t0 = time.monotonic()
        if self.stack == "posix":
            addrs = free_port_addrs(self.mon_names)
        else:
            tag = uuid.uuid4().hex[:8]
            addrs = {n: f"inproc:mon-{tag}-{n}" for n in self.mon_names}
        self.monmap = m.monmap.MonMap(addrs=addrs)
        self.monitors = [self.make_monitor(n) for n in self.monmap.ranks]
        for mon in self.monitors:
            await mon.start()

        def quorum() -> bool:
            self.raise_failed_monitor()
            return self.leader() is not None and all(
                len(mon.quorum) == self.n_mons for mon in self.monitors)

        await wait_until(quorum, timeout, "the quorum")
        self.t_quorum = time.monotonic() - t0
        mgr_conf = m.config.Config({"name": f"mgr.{self.MGR}", "ms_type": self.stack,
                                    **self.mon_conf}, env=False)
        kw = {"keyring": self.keyring} if self.keyring is not None and self.root != "ceph_tpu" else {}
        self.mgr = m.mgr.Mgr(self.MGR, self.monmap, conf=mgr_conf,
                             addr="127.0.0.1:0" if self.stack == "posix" else "", **kw)
        self.mgr.beacon_interval = self.mgr_beacon
        await self.mgr.start()
        await self.mgr.wait_for_active(timeout)
        self.t_mgr = time.monotonic() - t0
        msgr_kw = {"stack": self.stack}
        if self.keyring is not None:
            msgr_kw["auth"] = m.cephx.CephxAuth.for_client("client.admin",
                                                          self.keyring.get("client.admin"))
        self.monc = m.monclient.MonClient(
            "client.admin", self.monmap, msgr=m.messenger.Messenger("client.admin", **msgr_kw))

    async def stop_mon(self, name: str) -> None:
        i = self.monmap.ranks.index(name)
        await self.monitors[i].stop()

    async def restart_mon(self, name: str):
        """A fresh monitor (an empty store) in place of a stopped one."""
        i = self.monmap.ranks.index(name)
        mon = self.make_monitor(name)
        self.monitors[i] = mon
        await mon.start()
        return mon

    def raise_failed_monitor(self) -> None:
        """Raise the device error that stopped a monitor, if one did (the
        port's monitors; the reference's have no `failed`)."""
        for mon in self.monitors:
            if getattr(mon, "failed", None) is not None:
                raise mon.failed

    def quorum_epoch(self) -> int:
        """The highest election epoch a running monitor has seen."""
        return max(mon.elector.epoch for mon in self.monitors if mon._tick_task is not None)

    async def health(self) -> dict:
        return json.loads((await self.command({"prefix": "health", "detail": True}))[2])

    async def config_set(self, who: str, name: str, value) -> None:
        await self.command({"prefix": "config set", "who": who, "name": name,
                            "value": str(value)})

    # -- start and stop ------------------------------------------------------------

    async def start(self, timeout: float = 60.0) -> float:
        """Start everything; returns the seconds until every PG's primary
        is active and clean."""
        t0 = time.monotonic()
        if self.n_mons:
            await self.start_monitors(timeout)
        else:
            addr = await self.mon.start()
            self.monmap = self.m.monmap.MonMap(addrs={"a": addr})
        for i in range(self.n_osds):
            self.osds[i] = self.make_osd(i)
        for o in self.osds:
            await o.start()
        await wait_until(lambda: all(o.up for o in self.osds), timeout, "every OSD up")
        if self.n_mons:
            await wait_until(lambda: self.osdmap.num_up_osds() == self.n_osds, timeout,
                             "every OSD up in the map")
            self.t_up = time.monotonic() - t0
            await self.create_pools()
            self.t_pools = time.monotonic() - t0
        auth = None
        if self.keyring is not None:
            auth = self.m.cephx.CephxAuth.for_client(CLIENT, self.keyring.get(CLIENT))
        self.client = make_client(self.m, self.monmap, stack=self.stack, auth=auth)
        await self.client.connect()
        await self.wait_clean(timeout)
        return time.monotonic() - t0

    async def stop(self) -> None:
        if self.client is not None:
            await self.client.shutdown()
        for o in self.osds:
            if o is not None and o._running:
                await o.stop()
        if self.mon is not None:
            await self.mon.stop()
        if self.mgr is not None:
            await self.mgr.stop()
        if self.monc is not None:
            await self.monc.msgr.shutdown()
        for mon in self.monitors:
            if mon._tick_task is not None:
                await mon.stop()
        await asyncio.sleep(0)

    # -- the operator's commands (monitors) ----------------------------------------

    async def mark_out(self, osd: int) -> None:
        await self.command({"prefix": "osd out", "id": osd})

    async def mark_in(self, osd: int) -> None:
        await self.command({"prefix": "osd in", "id": osd})

    async def set_tier(self, base: str, cache: str, mode: str = "writeback",
                       target_max_objects: int | None = None) -> None:
        await self.command({"prefix": "osd tier add", "pool": base, "tierpool": cache})
        await self.command({"prefix": "osd tier cache-mode", "pool": cache, "mode": mode})
        await self.command({"prefix": "osd tier set-overlay", "pool": base,
                            "overlaypool": cache})
        if target_max_objects is not None:
            await self.command({"prefix": "osd pool set", "pool": cache,
                                "var": "target_max_objects", "val": target_max_objects})

    async def stop_osd(self, i: int) -> None:
        """Stop osd.i's daemon: its heartbeats stop, its store stays."""
        await self.osds[i].stop()

    async def asok(self, i: int, prefix: str, **kw):
        """One admin-socket command to osd.i (`ceph daemon osd.i ...`),
        off the event loop the daemon answers on."""
        admin_command = importlib.import_module(f"{self.root}.common.admin_socket").admin_command
        path = self.osds[i].conf.get("admin_socket")
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: admin_command(path, prefix, timeout=30.0, **kw))

    def status(self, i: int) -> dict:
        """osd.i's status blob, as its mgr report carries it."""
        return self.m.osd._osd_status(self.osds[i])

    # -- state ---------------------------------------------------------------------

    def running(self):
        return [o for o in self.osds if o is not None and o._running]

    def primaries(self):
        for o in self.running():
            for key in sorted(o.pgs):
                pg = o.pgs[key]
                if pg.peering.is_primary():
                    yield pg

    def all_clean(self) -> bool:
        om = self.osdmap
        for o in self.running():
            if o.osdmap.epoch != om.epoch:
                return False
        want = set()
        for pool in om.pools.values():
            for ps in range(pool.pg_num):
                want.add((pool.id, ps))
        seen = set()
        for o in self.running():
            for key, pg in o.pgs.items():
                if not pg.peering.is_primary():
                    continue
                if not pg.peering.is_active() or not pg.is_clean or pg.recovering:
                    return False
                seen.add(key)
        return seen == want

    async def wait_clean(self, timeout: float = 60.0) -> float:
        t0 = time.monotonic()
        await wait_until(self.all_clean, timeout, "every PG active and clean", step=0.01)
        return time.monotonic() - t0

    def pg_states(self) -> dict:
        """Each running daemon's PGs once quiet: peering state, acting set,
        primary, missing sets, recovering, clean."""
        out = {}
        for o in self.running():
            for key in sorted(o.pgs):
                pg = o.pgs[key]
                p = pg.peering
                out[(o.whoami, key)] = (
                    p.state.value, list(p.acting), p.primary, bool(pg.is_clean),
                    sorted(p.missing.items), sorted(pg.recovering))
        return out

    def stores(self) -> list:
        """Every daemon's objects: {coll: {oid: (data, xattrs, omap)}}."""
        out = []
        for o in self.osds:
            st = o.store
            objs = {}
            for coll in sorted(st.list_collections()):
                objs[coll] = {}
                for oid in sorted(st.list_objects(coll)):
                    objs[coll][oid] = (
                        bytes(st.read(coll, oid, 0, 0)),
                        dict(sorted(st.getattrs(coll, oid).items())),
                        dict(sorted(st.omap_get(coll, oid).items())),
                    )
            out.append(objs)
        return out
