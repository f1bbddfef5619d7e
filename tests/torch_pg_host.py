"""In-process OSD hosts for the placement-group layer, over either package.

`PgCluster(root, ...)` builds, from the modules of the package named
`root` (`"ceph_tpu"` or `"ceph_tpu_torch"`), one `OsdHost` per OSD over a
MemStore and an OSDMap with a flat CRUSH tree (one OSD a host) and the
pools it is given, made the way the monitor makes them
(`OSDMonitor` pool create: an `indep` rule for an EC profile, `firstn`
for replicated pools).  The host is what the OSD daemon does for its PGs
and nothing more:

- on a map, `advance_map` and then what `OSD._advance_pgs` does: make or
  advance every PG the host is in the acting set of, and drop the others;
- `dispatch` routes a cluster message as `OSD.ms_fast_dispatch` does:
  `MBackfillReserve` to the reservers or the primary's PG, peering and
  scrub messages to the PG, the rest to the PG's backend, creating a PG
  shell on demand as `OSD._get_pg` does;
- `tick` ticks every PG.

The hosts share one placement table an epoch (`placement`): CRUSH in
Python takes milliseconds a PG, and twelve hosts would each map every PG
of every map again; every map of one epoch is the same.

One thing the host does that the JAX package's daemon does not: a PG the
host leaves the acting set of is kept as a stray, and backend messages
for it (an EC primary's sub-reads) reach it.  The EC primary reads a
slot's chunks from the slot's last-clean holder while the new member
rebuilds (`PG.shard_data_source`); when the holder was marked out, the
daemon has dropped that PG and the read is never answered, so the
recovery stalls (ROADMAP.md C11).  Ceph itself keeps strays until the
PG is clean.

Map changes (`mark_down`, `mark_up`, `mark_out`, `mark_in`) go out as
`Incremental`s in `MOSDMap`s to the hosts that are up.  Marking an OSD
down stops its daemon: its PGs, logs and reservers are gone, its store
stays, and nothing it sent is delivered; marking it up starts a new
daemon on that store, which boots from the current full map (the PG log
is not persisted, as in the daemon, so the restarted OSD peers with an
empty log).  Client ops go to the
primary's `PG.do_op`.  `pump` is a coroutine: it delivers messages and
drains every EC backend's encode and decode pipes (`flush_encodes`)
whenever the queue runs dry, and yields to the running event loop until
the PGs' loopback callbacks (`PG.send_scrub`'s `call_soon`) have run.

This module imports neither package itself: the tests run one cluster of
each and compare them, and `chip_smoke.py` drives the port's on the card.
"""

from __future__ import annotations

import asyncio
import importlib
from collections import deque
from types import SimpleNamespace

CLIENT = "client.4100"


def modules(root: str) -> SimpleNamespace:
    def imp(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        messages=imp("msg.messages"),
        memstore=imp("os.memstore"),
        osdmap=imp("osd.osdmap"),
        pg=imp("osd.pg"),
        reserver=imp("osd.reserver"),
        config=imp("common.config"),
        perf_counters=imp("common.perf_counters"),
        crush=imp("crush.crush"),
    )


class OsdHost:
    """One OSD's PGs, store, config, reservers and map."""

    def __init__(self, cluster: "PgCluster", whoami: int, conf: dict, store=None):
        m = cluster.m
        self.cluster = cluster
        self.m = m
        self.whoami = whoami
        if store is None:
            store = m.memstore.MemStore()
            store.mount()
        self.store = store
        self.conf = m.config.Config(dict(conf), env=False)
        self.osdmap = m.osdmap.OSDMap()
        self.local_reserver = m.reserver.Reserver(lambda: self.conf.get("osd_max_backfills"))
        self.remote_reserver = m.reserver.Reserver(lambda: self.conf.get("osd_max_backfills"))
        b = m.perf_counters.PerfCountersBuilder(f"osd.{whoami}")
        b.add_u64_counter("backfill_pushes")
        self.perf = b.create_perf_counters()
        self.pgs: dict = {}
        self.strays: dict = {}  # PGs this host left the acting set of
        self.clog: list[str] = []

    # -- what the PG calls ---------------------------------------------------

    def send_cluster(self, osd: int, msg) -> None:
        self.cluster.post(self.whoami, osd, msg)

    def clog_error(self, text: str) -> None:
        self.clog.append(text)

    # -- maps (OSD::handle_osd_map, _advance_pgs, _get_pg) ---------------------

    def handle_osd_map(self, msg) -> None:
        self.osdmap = self.m.osdmap.advance_map(self.osdmap, msg)
        self.advance_pgs()

    def _make_pg(self, pool, ps: int):
        return self.m.pg.PG(self, pool, ps, self.osdmap.erasure_code_profiles,
                            **self.cluster.pg_kw)

    def advance_pgs(self) -> None:
        epoch = self.osdmap.epoch
        placement = self.cluster.placement(self.osdmap)
        for pool in self.osdmap.pools.values():
            for ps in range(pool.pg_num):
                _up, _upp, acting, _actp = placement[(pool.id, ps)]
                key = (pool.id, ps)
                if self.whoami in acting:
                    self.strays.pop(key, None)
                    pg = self.pgs.get(key)
                    if pg is None:
                        pg = self.pgs[key] = self._make_pg(pool, ps)
                    else:
                        pg.pool = pool
                    pg.on_new_interval(epoch, acting)
                elif key in self.pgs:
                    self.strays[key] = self.pgs.pop(key)

    def get_pg(self, pgid):
        pg = self.pgs.get((pgid.pool, pgid.ps))
        if pg is not None:
            return pg
        pool = self.osdmap.pools.get(pgid.pool)
        if pool is None:
            return None
        _up, _upp, acting, _actp = self.cluster.placement(self.osdmap)[(pool.id, pgid.ps)]
        if self.whoami not in acting:
            return None
        pg = self.pgs[(pgid.pool, pgid.ps)] = self._make_pg(pool, pgid.ps)
        pg.on_new_interval(self.osdmap.epoch, acting)
        return pg

    # -- cluster messages (OSD::ms_fast_dispatch) -------------------------------

    def dispatch(self, msg) -> None:
        msgs = self.m.messages
        if isinstance(msg, msgs.MBackfillReserve):
            self._handle_backfill_reserve(msg)
            return
        peering = (msgs.MOSDPGQuery, msgs.MOSDPGNotify, msgs.MOSDPGLog)
        scrub = (msgs.MOSDRepScrub, msgs.MOSDRepScrubMap)
        pg = self.get_pg(msg.pgid)
        if pg is None:
            stray = self.strays.get((msg.pgid.pool, msg.pgid.ps))
            if stray is not None and not isinstance(msg, peering + scrub):
                stray.backend.handle_message(msg)
            else:
                self.cluster.dropped.append((self.whoami, type(msg).__name__))
            return
        if isinstance(msg, peering):
            pg.handle_peering_message(msg)
        elif isinstance(msg, scrub):
            pg.handle_scrub_message(msg)
        else:
            pg.backend.handle_message(msg)

    def _handle_backfill_reserve(self, msg) -> None:
        R = self.m.messages.MBackfillReserve
        key = msg.pgid.key()
        if msg.op == R.REQUEST:
            granted = self.remote_reserver.try_reserve(key)
            self.send_cluster(msg.from_osd, R(pgid=msg.pgid, op=R.GRANT if granted else R.REJECT,
                                              epoch=msg.epoch, from_osd=self.whoami))
        elif msg.op == R.RELEASE:
            self.remote_reserver.release(key)
        else:
            pg = self.get_pg(msg.pgid)
            if pg is not None:
                pg.on_backfill_reserve(msg)

    def tick(self) -> None:
        for key in sorted(self.pgs):
            self.pgs[key].tick()

    def flush(self) -> None:
        """`flush_encodes` on every EC backend with work in it: an encode or
        decode pipe, or a write in flight (whose failed sub-writes the
        flush sends again).  On any other backend the call does nothing."""
        for pgs in (self.pgs, self.strays):
            for key in sorted(pgs):
                b = pgs[key].backend
                if getattr(b, "_encode_pipe", None) or getattr(b, "_decode_pipe", None) or (
                        hasattr(b, "_encode_pipe") and b.in_flight):
                    b.flush_encodes()


class PgCluster:
    """`n_osds` hosts of the package `root`, a map with `pools`, a pumped
    cluster-message queue and a client that sends ops to the primaries.

    `pools` is a list of dicts: `name`, `kind` ("ec" or "rep"), `pg_num`,
    and for EC `k`, `m`, `plugin`, `stripe_unit`, `overwrites`; for
    replicated `size`.  With `record`, every message posted and every map
    published is kept as (source, destination, type, bytes), every reply
    as its bytes.  `push_bytes` counts the object bytes recovery and
    backfill pushed."""

    def __init__(self, root: str, n_osds: int, pools: list[dict], conf: dict | None = None,
                 device=None, record: bool = True):
        self.m = modules(root)
        om = self.m.osdmap
        self.pg_kw = {} if device is None else {"device": device}
        self.record = record
        self.queue: deque = deque()
        self.sent: list = []
        self.dropped: list = []
        self.replies: list = []
        self.push_bytes = 0
        self.tid = 0
        self.conf = dict(conf or {})
        self.hosts = [OsdHost(self, i, self.conf) for i in range(n_osds)]
        self.up = set(range(n_osds))
        self.snap_seq: dict[str, int] = {}
        osdmap = om.OSDMap()
        osdmap.fsid = "pg-host"
        osdmap.crush.build_flat(n_osds, 1)
        for i in range(n_osds):
            osdmap.add_osd(i, addr=f"osd.{i}", up=True)
        for spec in pools:
            self._create_pool(om, osdmap, spec)
        osdmap.epoch = 1
        self.osdmap = osdmap
        self.incrementals: dict[int, bytes] = {}
        self._placements: dict[int, dict] = {}
        self._publish()

    @staticmethod
    def _create_pool(mod, osdmap, spec: dict) -> None:
        if spec["kind"] == "ec":
            k, m = int(spec["k"]), int(spec["m"])
            profile = f"prof_{spec['name']}"
            osdmap.erasure_code_profiles[profile] = {
                "plugin": spec.get("plugin", "tpu"), "k": str(k), "m": str(m),
                **spec.get("profile", {})}
            rule = osdmap.crush.rule_id(f"ec_{profile}")
            if rule is None:
                rule = osdmap.crush.add_simple_rule(f"ec_{profile}", failure_domain="host",
                                                    mode="indep")
            osdmap.create_pool(
                spec["name"], type=mod.POOL_TYPE_ERASURE, size=k + m,
                min_size=k + 1 if m > 1 else k, pg_num=spec["pg_num"], crush_rule=rule,
                erasure_code_profile=profile, stripe_width=k * int(spec.get("stripe_unit", 4096)),
                flags=mod.FLAG_EC_OVERWRITES if spec.get("overwrites") else 0)
        else:
            rule = osdmap.crush.rule_id("replicated_rule")
            if rule is None:
                rule = osdmap.crush.add_simple_rule("replicated_rule", failure_domain="host",
                                                    mode="firstn")
            osdmap.create_pool(spec["name"], type=mod.POOL_TYPE_REPLICATED,
                               size=int(spec.get("size", 3)), pg_num=spec["pg_num"],
                               crush_rule=rule)

    # -- maps --------------------------------------------------------------------

    def placement(self, osdmap) -> dict:
        """Every PG's `pg_to_up_acting_osds` under `osdmap`, computed once an
        epoch: every map of one epoch comes from the same incrementals, so
        the hosts share the table (CRUSH in Python takes milliseconds a
        PG, and each host would map every PG again)."""
        table = self._placements.get(osdmap.epoch)
        if table is None:
            table = self._placements[osdmap.epoch] = {
                (pool.id, ps): osdmap.pg_to_up_acting_osds(pool.id, ps)
                for pool in osdmap.pools.values() for ps in range(pool.pg_num)}
        return table

    def _publish(self) -> None:
        """Send every up host the maps it lacks: a booting one the full
        map, the others the incrementals past their epoch."""
        msgs = self.m.messages
        for osd in sorted(self.up):
            host = self.hosts[osd]
            have = host.osdmap.epoch
            if have == 0:
                msg = msgs.MOSDMap(fsid=self.osdmap.fsid,
                                   maps={self.osdmap.epoch: self.osdmap.tobytes()},
                                   incrementals={})
            else:
                msg = msgs.MOSDMap(fsid=self.osdmap.fsid, maps={}, incrementals={
                    e: blob for e, blob in self.incrementals.items() if e > have})
            if self.record:
                self.sent.append(("mon", osd, "MOSDMap", msg.tobytes()))
            host.handle_osd_map(msg)

    def _change(self, **delta) -> None:
        om = self.m.osdmap
        inc = om.Incremental(epoch=self.osdmap.epoch + 1, **delta)
        blob = inc.tobytes()
        self.osdmap = om.Incremental.frombytes(blob).apply_to(self.osdmap)
        self.incrementals[inc.epoch] = blob
        self._publish()

    def mark_down(self, osd: int) -> None:
        self.up.discard(osd)
        self._change(new_down=[osd])

    def mark_up(self, osd: int) -> None:
        self.hosts[osd] = OsdHost(self, osd, self.conf, store=self.hosts[osd].store)
        self.up.add(osd)
        self._change(new_up={osd: f"osd.{osd}"})

    def mark_out(self, osd: int) -> None:
        self._change(new_weights={osd: 0})

    def mark_in(self, osd: int) -> None:
        self._change(new_weights={osd: self.m.crush.WEIGHT_ONE})

    # -- messages ------------------------------------------------------------------

    def post(self, src: int, dst: int, msg) -> None:
        name = type(msg).__name__
        if self.record:
            self.sent.append((src, dst, name, msg.tobytes()))
        if name == "MOSDPGPush":
            self.push_bytes += sum(len(p.data) for p in msg.pushes)
        self.queue.append((src, dst, msg))

    def _deliver(self) -> None:
        src, dst, msg = self.queue.popleft()
        if src not in self.up or dst not in self.up:
            self.dropped.append((src, dst, type(msg).__name__))
            return
        self.hosts[dst].dispatch(msg)

    def flush(self) -> None:
        for host in self.hosts:
            host.flush()

    async def pump(self, limit: int = 1_000_000) -> int:
        """Deliver until quiescent: no message queued, every encode and
        decode pipe drained, and no callback ready on the event loop."""
        loop = asyncio.get_running_loop()
        steps = 0
        while True:
            while self.queue:
                self._deliver()
                steps += 1
                assert steps < limit, "message storm"
            self.flush()
            if self.queue:
                continue
            await asyncio.sleep(0)
            if self.queue or loop._ready:
                continue
            self.flush()
            if not self.queue:
                return steps

    def tick(self) -> None:
        for osd in sorted(self.up):
            self.hosts[osd].tick()

    async def settle(self, rounds: int = 60) -> int:
        """Tick and pump until every PG of every up host is active and
        clean, then tick once more (a clean tick is when an EC primary
        records its slots' holders); returns the ticks it took."""
        await self.pump()
        for n in range(1, rounds + 1):
            self.tick()
            await self.pump()
            if self.all_clean():
                self.tick()
                await self.pump()
                return n
        raise AssertionError(f"not clean after {rounds} ticks: {self.unclean()}")

    def primaries(self):
        for osd in sorted(self.up):
            for key in sorted(self.hosts[osd].pgs):
                pg = self.hosts[osd].pgs[key]
                if pg.peering.is_primary():
                    yield pg

    def all_active(self) -> bool:
        """Every PG's primary (by the current map) is active."""
        for pool in self.osdmap.pools.values():
            for ps in range(pool.pg_num):
                primary = self.placement(self.osdmap)[(pool.id, ps)][3]
                pg = self.hosts[primary].pgs.get((pool.id, ps))
                if pg is None or not pg.peering.is_primary() or not pg.peering.is_active():
                    return False
        return True

    def all_clean(self) -> bool:
        expected = set()
        for pool in self.osdmap.pools.values():
            for ps in range(pool.pg_num):
                primary = self.placement(self.osdmap)[(pool.id, ps)][3]
                expected.add((pool.id, ps, primary))
        for pool_id, ps, primary in expected:
            pg = self.hosts[primary].pgs.get((pool_id, ps))
            if pg is None or not pg.peering.is_primary() or not pg.is_clean or pg.recovering:
                return False
        return True

    def unclean(self) -> list:
        out = []
        for pg in self.primaries():
            if not pg.is_clean or pg.recovering:
                out.append((pg.pgid, pg.peering.state.value, sorted(pg.recovering),
                            pg.peering.all_missing_oids()[:4], sorted(pg.peering.backfill_targets)))
        return out

    # -- client ----------------------------------------------------------------------

    def op(self, pool: str, oid: str, ops: list, snap_id: int = 0, snapc=None,
           client: str = CLIENT, tid: int | None = None) -> list:
        """Send one MOSDOp to the object's primary; returns the list its
        replies land in (one reply, once the PGs have pumped)."""
        msgs = self.m.messages
        p = self.osdmap.get_pool(pool)
        pool_id, ps = self.osdmap.object_to_pg(p.id, oid)
        primary = self.placement(self.osdmap)[(pool_id, ps)][3]
        if tid is None:
            self.tid += 1
            tid = self.tid
        snap_seq, snaps = snapc if snapc is not None else (0, [])
        msg = msgs.MOSDOp(reqid=msgs.ReqId(client, tid), pgid=msgs.PgId(pool_id, ps, -1),
                          oid=oid, ops=ops, epoch=self.osdmap.epoch, snap_seq=snap_seq,
                          snaps=list(snaps), snap_id=snap_id)
        if self.record:
            self.sent.append(("client", primary, "MOSDOp", msg.tobytes()))
        out: list = []

        def reply(rep) -> None:
            out.append(rep)
            if self.record:
                self.replies.append(rep.tobytes())

        self.hosts[primary].pgs[(pool_id, ps)].do_op(msg, reply)
        return out

    def osd_op(self, code: str, **kw):
        OSDOp = self.m.messages.OSDOp
        return OSDOp(op=getattr(OSDOp, code), **kw)

    # -- state, for comparisons ---------------------------------------------------------

    def pg_states(self) -> dict:
        """Each host's PGs: peering state, info, log, missing sets,
        backfill cursors, recovery set and version."""

        def ev(v):
            return None if v is None else (v.epoch, v.version)

        def missing(ms):
            return sorted((oid, ev(n), ev(h)) for oid, (n, h) in ms.items.items())

        out = {}
        for host in self.hosts:
            for key in sorted(host.pgs):
                pg = host.pgs[key]
                p = pg.peering
                out[(host.whoami, key)] = (
                    p.state.value, p.epoch, list(p.acting), p.primary,
                    sorted(p.backfill_targets), sorted(p.last_backfill.items()),
                    p.backfill_started_total, pg.info.tobytes(),
                    [e.tobytes() for e in pg.pg_log.entries], ev(pg.pg_log.tail),
                    missing(p.missing),
                    {osd: missing(ms) for osd, ms in sorted(p.peer_missing.items())},
                    sorted(pg.recovering), pg._version, list(pg.acting()),
                    sorted(pg._shard_holders.items()), sorted(pg._moved_members.items()),
                )
        return out

    def stores(self) -> list:
        return [
            {coll: {oid: (bytes(o.data), dict(o.xattrs), dict(o.omap))
                    for oid, o in sorted(objs.items())}
             for coll, objs in sorted(host.store._colls.items())}
            for host in self.hosts
        ]
