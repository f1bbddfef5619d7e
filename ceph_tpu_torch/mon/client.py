"""MonClient — mirror of src/mon/MonClient.{h,cc}.

Hunts for a usable monitor, issues commands (retargeting to the leader on
-EAGAIN, the analog of the reference's request forwarding), maintains
subscriptions, and delivers map updates to its owner (OSD daemon or
librados client).
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
