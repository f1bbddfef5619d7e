"""MonClient — mirror of src/mon/MonClient.{h,cc}.

Hunts for a usable monitor, issues commands (retargeting to the leader on
-EAGAIN, the analog of the reference's request forwarding), maintains
subscriptions, and delivers map updates to its owner (OSD daemon or
librados client).

The port's: when the session to the monitor holding the subscriptions
resets (that monitor stopped), the client hunts the next rank and renews
them there, as Ceph's MonClient reopens its session; the reference's keeps
them on the dead monitor, and its owner hears of no map again (ROADMAP
C18).  A pass over every rank that finds none to take them is counted in
`hunt_failures`, and the hunt goes on after a backoff until one does or
the client shuts down.
"""

from __future__ import annotations

import asyncio
import json
import re
from typing import Callable

from ..common.log import dout
from ..msg.messages import (
    MConfig,
    MLog,
    MMonCommand,
    MMonCommandAck,
    MMonSubscribe,
    MOSDMap,
)
from ..msg.messenger import Connection, Dispatcher, Messenger
from .monmap import MonMap
from ..common.errs import EAGAIN, ETIMEDOUT


class MonClient(Dispatcher):
    def __init__(
        self,
        name: str,
        monmap: MonMap,
        msgr: Messenger | None = None,
        stack: str = "posix",  # ms_type for the fallback messenger
    ):
        self.name = name
        self.monmap = monmap
        self.msgr = msgr or Messenger(name, stack=stack)
        self.msgr.add_dispatcher_tail(self)
        self._tid = 0
        self._acks: dict[int, asyncio.Future] = {}
        self.on_osdmap: Callable[[MOSDMap], None] | None = None
        self.on_config: Callable[[MConfig], None] | None = None
        self.on_log: Callable[[MLog], None] | None = None
        self._cur_rank = 0  # mon we're currently talking to
        self._subs: dict[str, int] = {}
        self.hunts = 0  # sessions reopened on another monitor after a reset
        self.hunt_failures = 0  # passes over every rank that none answered
        self._hunt: asyncio.Task | None = None
        self._closed = False

    # -- dispatch --------------------------------------------------------------

    def ms_dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, MMonCommandAck):
            fut = self._acks.pop(msg.tid, None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return True
        if isinstance(msg, MOSDMap):
            if self.on_osdmap is not None:
                self.on_osdmap(msg)
            return True
        if isinstance(msg, MConfig):
            if self.on_config is not None:
                self.on_config(msg)
            return True
        if isinstance(msg, MLog):
            if self.on_log is not None:
                self.on_log(msg)
            return True
        return False

    def ms_handle_reset(self, conn: Connection) -> None:
        """The session to the current monitor died: hunt the next rank
        and renew the subscriptions there (MonClient::ms_handle_reset ->
        _reopen_session; the port's, C18)."""
        if not self._subs or conn.peer_addr != self.monmap.addr_of_rank(self._cur_rank):
            return
        if self._closed or (self._hunt is not None and not self._hunt.done()):
            return  # shut down, or a hunt is on and carries on past this rank
        self._cur_rank = (self._cur_rank + 1) % self.monmap.size()
        self.hunts += 1
        self._hunt = asyncio.get_event_loop().create_task(self._reopen_session())

    async def _reopen_session(self) -> None:
        """Offer the subscriptions to each rank in turn until one takes
        them; after a pass that found none, wait (0.05 s, doubling to 2 s)
        and pass again."""
        backoff = 0.05
        while not self._closed:
            for _ in range(self.monmap.size()):
                try:
                    await self.resubscribe()
                    return
                except ConnectionError:
                    self._cur_rank = (self._cur_rank + 1) % self.monmap.size()
            self.hunt_failures += 1
            dout("monc", 1, f"{self.name}: no monitor took the subscriptions "
                            f"({self.hunt_failures} passes); hunting on")
            await asyncio.sleep(backoff)
            backoff = min(2 * backoff, 2.0)

    async def shutdown(self) -> None:
        """Stop hunting and close the client's messenger."""
        self._closed = True
        if self._hunt is not None:
            self._hunt.cancel()
            self._hunt = None
        await self.msgr.shutdown()

    # -- commands --------------------------------------------------------------

    async def command(
        self, cmd: dict, timeout: float = 5.0
    ) -> tuple[int, str, bytes]:
        """Send a JSON command, hunting for the leader (MonClient::
        start_mon_command + the -EAGAIN retarget loop)."""
        deadline = asyncio.get_event_loop().time() + timeout
        rank = self._cur_rank
        attempts = 0
        while True:
            if asyncio.get_event_loop().time() > deadline:
                return (-ETIMEDOUT, "timed out waiting for mon", b"")
            self._tid += 1
            tid = self._tid
            fut: asyncio.Future = asyncio.get_event_loop().create_future()
            self._acks[tid] = fut
            addr = self.monmap.addr_of_rank(rank % self.monmap.size())
            try:
                await self.msgr.send_to(addr, MMonCommand(tid=tid, cmd=json.dumps(cmd)))
                ack: MMonCommandAck = await asyncio.wait_for(
                    fut, max(deadline - asyncio.get_event_loop().time(), 0.05)
                )
            except (ConnectionError, asyncio.TimeoutError):
                self._acks.pop(tid, None)
                rank += 1  # hunt the next mon
                attempts += 1
                await asyncio.sleep(min(0.05 * attempts, 0.5))
                continue
            if ack.retval == -EAGAIN:
                m = re.search(r"leader is rank (-?\d+)", ack.rs)
                new_rank = int(m.group(1)) if m else -1
                if new_rank < 0:
                    await asyncio.sleep(0.05)
                else:
                    rank = new_rank
                continue
            self._cur_rank = rank % self.monmap.size()
            return (ack.retval, ack.rs, ack.outbl)

    # -- subscriptions ---------------------------------------------------------

    async def subscribe(self, what: str, start: int = 0) -> None:
        """Register interest (MonClient::sub_want + renew)."""
        self._subs[what] = start
        addr = self.monmap.addr_of_rank(self._cur_rank)
        try:
            await self.msgr.send_to(addr, MMonSubscribe(what=dict(self._subs)))
        except ConnectionError:
            dout("monc", 5, f"{self.name}: subscribe to {addr} failed")

    # -- cluster log -----------------------------------------------------------

    async def send_log(self, entries: list[dict]) -> None:
        """Ship clog entries to the current mon (LogClient::_send_to_mon);
        a peon forwards them to the leader.  Best-effort: a lost entry is
        re-reported by the next scrub, so no retry queue."""
        addr = self.monmap.addr_of_rank(self._cur_rank)
        try:
            await self.msgr.send_to(
                addr, MLog(version=0, entries=json.dumps(entries).encode())
            )
        except ConnectionError:
            dout("monc", 5, f"{self.name}: clog send to {addr} failed")

    async def resubscribe(self, rank: int | None = None) -> None:
        """Re-send subscriptions after a mon connection reset."""
        if rank is not None:
            self._cur_rank = rank % self.monmap.size()
        if self._subs:
            addr = self.monmap.addr_of_rank(self._cur_rank)
            await self.msgr.send_to(addr, MMonSubscribe(what=dict(self._subs)))
