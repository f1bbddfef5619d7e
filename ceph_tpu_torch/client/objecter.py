"""Objecter — the client op engine, mirror of src/osdc/Objecter.{h,cc}.

Reference call stack:

- `op_submit` (src/osdc/Objecter.cc:2268) registers the
  op, computes its target, and sends.
- `_calc_target` (:2775): object name → PG (OSDMap::object_locator_to_pg)
  → acting primary via CRUSH; recomputed whenever a new osdmap arrives,
  and ops whose target changed are **resent** (handle_osd_map →
  _scan_requests).
- Replies arrive as MOSDOpReply (`handle_osd_op_reply`, :989) and
  complete the registered op by tid.

This client keeps that loop: an op stays registered until a final reply;
map updates (via the MonClient osdmap subscription) wake every pending op
to re-target and resend.  A primary that is not yet peered answers
-EAGAIN with its epoch — the op waits for a newer map (or a short delay)
and resends, which is the same convergence the reference gets from
requeueing + map subscriptions.

The port's copy of `ceph_tpu/client/objecter.py`.  Where it differs
(ROADMAP C25): the reference resends an op whose reply takes over 2 s;
the port waits for the reply until the op's deadline and resends only
when a new map starts a new interval for the op's PG (its up or acting
set, its primary or the primary's address moved), the session to the
target resets, the send fails or the PG answers -EAGAIN, as Ceph's
Objecter does (`_calc_target`'s `is_new_interval`).  The OSD's half is
`PG.on_new_interval`, which answers the duplicates parked on a write of
the ended interval with -EAGAIN.
"""

from __future__ import annotations

import asyncio
import time

from ..common import tracer as tracer_mod
from ..common.errs import EAGAIN, ENOENT, ETIMEDOUT
from ..common.log import dout
from ..mon.client import MonClient
from ..mon.monmap import MonMap
from ..msg.messages import (
    MOSDMap,
    MOSDOp,
    MOSDOpReply,
    MWatchNotify,
    OSDOp,
    PgId,
    ReqId,
)
from ..msg.messenger import Connection, Dispatcher, Messenger
from ..osd.osdmap import PG_NONE, OSDMap, advance_map


class Objecter(Dispatcher):
    def __init__(
        self,
        name: str,
        monmap: MonMap,
        auth=None,
        secure: bool = False,
        compress: bool = False,
        stack: str = "posix",
    ):
        self.name = name
        # Per-INSTANCE identity for osd_reqid_t: the reference's clients
        # carry a mon-assigned global_id in entity_name_t, so two
        # processes (or sequential runs) named "client.foo" never share
        # reqids.  Without the nonce, a second process reusing the name
        # restarts tids at 1 and the PG's dup detection would serve it
        # the FIRST process's remembered replies instead of applying.
        import random
        import secrets

        self.reqid_name = f"{name}.{secrets.token_hex(4)}"
        # resend pacing: per-instance rng so many clients retrying through
        # the same map churn spread out instead of thundering in lockstep
        self._backoff_rng = random.Random(secrets.randbits(32))
        from ..common.perf_counters import PerfCountersBuilder

        b = PerfCountersBuilder(name)
        for c in ("op", "op_resend", "op_reply", "op_timeout"):
            b.add_u64_counter(c)
        self.perf = b.create_perf_counters()
        self.msgr = Messenger(
            name, auth=auth, secure=secure, compress=compress, stack=stack
        )
        # client end of the op trace (Objecter::op_submit's osd_trace root):
        # disabled by default; bench/diag flips .enabled and every op's
        # context rides the MOSDOp envelope so the OSD-side spans join it
        self.tracer = tracer_mod.Tracer(service=name, enabled=False)
        self.msgr.tracer = self.tracer
        self.monc = MonClient(name, monmap, msgr=self.msgr)
        self.msgr.add_dispatcher_head(self)
        self.osdmap = OSDMap()
        self._tid = 0
        self._replies: dict[int, asyncio.Future] = {}
        self._map_changed = asyncio.Event()
        # (pool, oid, cookie) -> callback(notify_id, payload) -> optional
        # reply bytes; pushes arrive on the session the WATCH op registered
        # on (Objecter::handle_watch_notify).  Cookies are allocated
        # process-wide so handles can never collide.
        self._watches: dict[tuple[int, str, int], object] = {}
        self._next_cookie = 0
        # the port's (C25): address -> an event set when its session resets
        self._resets: dict[str, asyncio.Event] = {}

    # -- lifecycle -------------------------------------------------------------

    async def start(self, timeout: float = 5.0) -> None:
        self.monc.on_osdmap = self._on_osdmap
        await self.monc.subscribe("osdmap")
        deadline = time.monotonic() + timeout
        while self.osdmap.epoch == 0:
            if time.monotonic() > deadline:
                raise TimeoutError("no osdmap from mons")
            await asyncio.sleep(0.02)
            # subscriptions can race mon elections; renew until a map lands
            await self.monc.resubscribe()

    async def stop(self) -> None:
        # the port's MonClient hunts on a reset: stop it with the messenger
        await self.monc.shutdown()

    def _on_osdmap(self, msg: MOSDMap) -> None:
        """handle_osd_map: advance, then wake pending ops to re-target
        (_scan_requests analog — ops re-send themselves)."""
        self.osdmap = advance_map(self.osdmap, msg)
        self._map_changed.set()
        self._map_changed = asyncio.Event()

    # -- dispatch --------------------------------------------------------------

    def ms_dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, MOSDOpReply):
            fut = self._replies.pop(msg.reqid.tid, None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return True
        if isinstance(msg, MWatchNotify) and not msg.is_ack:
            cb = self._watches.get((msg.pgid.pool, msg.oid, msg.cookie))
            ack_payload = b""
            if cb is not None:
                try:
                    ack_payload = cb(msg.notify_id, msg.payload) or b""
                except Exception as e:  # a watcher bug must not kill dispatch
                    dout("objecter", 1, f"{self.name}: watch cb raised {e!r}")
            ack = MWatchNotify(
                oid=msg.oid,
                pgid=msg.pgid,
                notify_id=msg.notify_id,
                cookie=msg.cookie,
                payload=bytes(ack_payload),
                is_ack=1,
                # the instance identity the watch REGISTERED under
                # (reqid.client): the PG's pending-ack set is keyed on it
                watcher=self.reqid_name,
            )

            async def _send_ack() -> None:
                try:
                    await conn.send_message(ack)
                except ConnectionError:
                    pass

            asyncio.get_event_loop().create_task(_send_ack())
            return True
        return False

    # -- targeting -------------------------------------------------------------

    def _effective_pool(self, pool_id: int) -> int:
        """Cache-tier overlay redirect (Objecter.cc _calc_target honoring
        pg_pool_t.read_tier): ops targeting a base pool with an overlay go
        to the cache pool; the cache PG promotes/flushes against the base
        (PrimaryLogPG promote_object / agent).  Re-evaluated every resend,
        so adding/removing an overlay retargets in-flight retries."""
        pool = self.osdmap.pools.get(pool_id)
        if pool is not None and pool.read_tier >= 0 and pool.read_tier in self.osdmap.pools:
            return pool.read_tier
        return pool_id

    def _calc_target(self, pool_id: int, oid: str) -> tuple[PgId, int]:
        """_calc_target (Objecter.cc:2775): (pgid, acting_primary)."""
        pool_id = self._effective_pool(pool_id)
        _pool, ps = self.osdmap.object_to_pg(pool_id, oid)
        _up, _upp, _acting, primary = self.osdmap.pg_to_up_acting_osds(pool_id, ps)
        return PgId(pool_id, ps, -1), primary

    # -- op submission ---------------------------------------------------------

    async def op_submit(
        self,
        pool_id: int,
        oid: str,
        ops: list[OSDOp],
        timeout: float = 10.0,
        ps: int | None = None,
        snap_seq: int = 0,
        snaps: list[int] | None = None,
        snap_id: int = 0,
    ) -> MOSDOpReply:
        """op_submit (Objecter.cc:2268): send + resend until a final
        reply.  Raises TimeoutError past `timeout`.  `ps` targets a
        specific PG instead of hashing `oid` (pg ops like PGLS)."""
        self._tid += 1
        reqid = ReqId(client=self.reqid_name, tid=self._tid)
        # trace root: ONE span per client op; every (re)send injects its
        # context into the MOSDOp envelope, so the messenger/OSD/EC/codec
        # spans downstream all share this trace id
        span = self.tracer.start_span("client:op")
        span.keyval("oid", oid)
        span.keyval("reqid", lambda: reqid.key())
        try:
            return await self._op_submit(
                pool_id, oid, ops, timeout, ps, snap_seq, snaps, snap_id,
                reqid, span,
            )
        except TimeoutError:
            # tail-based always-keep: a timed-out op keeps
            # its trace even when head sampling dropped it
            self.tracer.mark_keep(span)
            raise
        finally:
            span.finish()

    def _backoff_delay(self, attempt: int, base: float = 0.05,
                       cap: float = 1.0) -> float:
        """Bounded exponential backoff with jitter for op resends: many
        clients retrying through the same osdmap churn must NOT
        synchronize into resend storms, so each retry waits
        base * 2^attempt (capped at ~1 s) scaled by a uniform [0.5, 1.0)
        jitter — the classic decorrelated-retry shape."""
        return min(cap, base * (1 << min(attempt, 16))) * (
            0.5 + self._backoff_rng.random() / 2.0
        )

    def _backoff_or_timeout(self, deadline, attempt, reqid, oid,
                            span) -> float:
        """Resend pacing with fail-fast: returns the
        backoff delay to sleep before the retry, or raises TimeoutError
        NOW when the op's deadline lands inside that backoff — the old
        `min(remaining, delay)` shape slept the deadline away and only
        noticed at the top of the loop, turning a doomed op's last
        moments into a pointless wait for a retry it could not use."""
        delay = self._backoff_delay(attempt)
        if deadline - time.monotonic() <= delay:
            span.event("deadline exhausted mid-backoff: fail fast")
            self.perf.inc("op_timeout")
            raise TimeoutError(
                f"op {reqid.key()} on {oid} timed out "
                "(deadline inside resend backoff)"
            )
        return delay

    async def _op_submit(
        self, pool_id, oid, ops, timeout, ps, snap_seq, snaps, snap_id,
        reqid, span,
    ) -> MOSDOpReply:
        deadline = time.monotonic() + timeout
        self.perf.inc("op")
        attempt = 0
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                self.perf.inc("op_timeout")
                raise TimeoutError(f"op {reqid.key()} on {oid} timed out")
            target = self._target(pool_id, oid, ps)
            pgid, _up, _acting, primary, addr = target
            if primary == PG_NONE:
                # No live primary in this interval: wait for the map to move
                await self._wait_map_change(min(remaining, 0.5))
                continue
            if not addr:
                await self._wait_map_change(min(remaining, 0.5))
                continue
            msg = MOSDOp(
                reqid=reqid,
                pgid=pgid,
                oid=oid,
                ops=ops,
                epoch=self.osdmap.epoch,
                snap_seq=snap_seq,
                snaps=list(snaps or []),
                snap_id=snap_id,
            )
            tracer_mod.inject(span, msg)
            # end-to-end deadline propagation: the op's
            # remaining budget rides the envelope so the OSD can shed
            # already-expired work at admission and EC sub-reads inherit
            # the budget instead of pinning shard sources for a reply
            # nobody is waiting for
            msg.deadline = deadline
            fut: asyncio.Future = asyncio.get_event_loop().create_future()
            self._replies[reqid.tid] = fut
            try:
                span.event(lambda: f"sent to osd.{primary}")
                await self.msgr.send_to(addr, msg)
            except ConnectionError:
                # Peer died: re-target after a map change (or a backoff
                # delay) and resend — Objecter's resend loop, paced so
                # client fleets don't retry in lockstep.
                span.event("resend: connection lost")
                self._replies.pop(reqid.tid, None)
                delay = self._backoff_or_timeout(deadline, attempt, reqid,
                                                 oid, span)
                self.perf.inc("op_resend")
                await self._wait_map_change(delay)
                attempt += 1
                continue
            reply = await self._await_reply(fut, pool_id, oid, ps, target, deadline)
            if reply is None:
                # a new interval for the op's PG, its session reset, or
                # the deadline passed (the loop's top raises)
                self._replies.pop(reqid.tid, None)
                if deadline - time.monotonic() > 0:
                    span.event("resend: target moved or its session reset")
                    self.perf.inc("op_resend")
                    attempt += 1
                continue
            if reply.result == -EAGAIN:
                # Not primary / not yet active: refresh + retry.
                span.event("resend: target not active (-EAGAIN)")
                delay = self._backoff_or_timeout(deadline, attempt, reqid,
                                                 oid, span)
                self.perf.inc("op_resend")
                await self._wait_map_change(delay)
                attempt += 1
                continue
            if reply.result == -ETIMEDOUT:
                # the OSD shed this op at admission: its
                # deadline expired in flight/queue, so it was never
                # executed — surface the same TimeoutError a local
                # expiry raises instead of handing back a corpse
                span.event("osd shed op at admission (-ETIMEDOUT)")
                self.perf.inc("op_timeout")
                raise TimeoutError(
                    f"op {reqid.key()} on {oid} timed out "
                    "(shed at osd admission)"
                )
            span.event("reply received")
            self.perf.inc("op_reply")
            return reply

    def _target(self, pool_id: int, oid: str, ps: int | None) -> tuple:
        """The op's target as `_calc_target` compares it for a resend:
        (pgid, up, acting, acting primary, the primary's address), by
        `oid` or PG `ps` itself."""
        if ps is None:
            pool_id = self._effective_pool(pool_id)
            _pool, ps = self.osdmap.object_to_pg(pool_id, oid)
        up, _upp, acting, primary = self.osdmap.pg_to_up_acting_osds(pool_id, ps)
        info = self.osdmap.osds.get(primary)
        return (PgId(pool_id, ps, -1), tuple(up), tuple(acting), primary,
                info.addr if info is not None else "")

    async def _await_reply(self, fut, pool_id, oid, ps, target, deadline):
        """The port's (ROADMAP C25): the reply, or None when a new map
        starts a new interval for the op's PG (`target` moved), when the
        session to the primary resets, or at the deadline.  A reply that
        is only slow is waited for, not resent: the PG is still working
        on it, as Ceph's Objecter assumes."""
        addr = target[4]
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                return None
            moved = asyncio.ensure_future(self._map_changed.wait())
            reset = asyncio.ensure_future(
                self._resets.setdefault(addr, asyncio.Event()).wait())
            try:
                await asyncio.wait({fut, moved, reset}, timeout=remaining,
                                   return_when=asyncio.FIRST_COMPLETED)
            finally:
                moved.cancel()
                reset.cancel()
            if fut.done():
                return fut.result()
            if reset.done() and not reset.cancelled():
                return None
            if moved.done() and not moved.cancelled():
                if self._target(pool_id, oid, ps) != target:
                    return None

    def ms_handle_reset(self, conn: Connection) -> None:
        """A session to an OSD reset: the ops waiting on it resend."""
        ev = self._resets.pop(conn.peer_addr, None)
        if ev is not None:
            ev.set()

    async def _wait_map_change(self, timeout: float) -> None:
        ev = self._map_changed
        try:
            await asyncio.wait_for(ev.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        # nudge subscriptions in case our mon connection reset
        try:
            await self.monc.resubscribe()
        except ConnectionError:
            pass
