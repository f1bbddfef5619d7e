"""Monitor elections — mirror of src/mon/ElectionLogic.cc / Elector.cc.

Classic rank-based election: every electing mon PROPOSEs itself; a mon
seeing a proposal from a lower (better) rank ACKs and defers; the proposer
declares VICTORY once every *reachable* peer has acked (or the election
timeout passes with a majority), then leads with the acked quorum.  Epochs
are bumped on every election so stale messages are discarded; like the
reference, an even epoch means "in election", odd means "stable quorum"
(ElectionLogic.h epoch semantics).

The port's timer differs in two places (ROADMAP C21): a monitor that
deferred gives its candidate the timeout plus 1 s to declare victory, as
Ceph's `Elector::_defer_to` does, so a victory still in flight when the
candidate's own timeout ends calls no second election; and a timer that
wakes more than half its wait late (the event loop this elector shares
was busy that long, and the messages it waited for waited in it too)
waits once more instead of acting, C16's rule for the lease.
"""

from __future__ import annotations

import asyncio
from typing import Callable

from ..common.log import dout
from ..msg.messages import MMonElection


# the extra time a monitor that deferred gives its candidate to declare
# victory (Ceph's Elector::_defer_to: mon_election_timeout + 1 s)
DEFER_GRACE = 1.0


class Elector:
    """One per monitor; drives MMonElection traffic."""

    def __init__(
        self,
        rank: int,
        n_mons: int,
        send: Callable[[int, MMonElection], None],
        on_win: Callable[[int, list[int]], None],
        on_lose: Callable[[int, int, list[int]], None],
        timeout: float = 0.5,
    ):
        self.rank = rank
        self.n_mons = n_mons
        self.send = send
        self.on_win = on_win  # (epoch, quorum ranks)
        self.on_lose = on_lose  # (epoch, leader rank, quorum ranks)
        self.timeout = timeout
        self.epoch = 1  # odd = stable, even = electing
        self.electing = False
        self.acked: set[int] = set()
        self.leader: int | None = None
        self.deferred: int | None = None  # better candidate we acked
        self._timer: asyncio.Task | None = None
        self.late_timeouts = 0  # timers that woke too late to judge (C21)

    def quorum_size(self) -> int:
        return self.n_mons // 2 + 1

    # -- driving --------------------------------------------------------------

    def start(self) -> None:
        """Call an election (Elector::call_election)."""
        if self.epoch % 2 == 1:
            self.epoch += 1  # enter electing epoch
        self.electing = True
        self.leader = None
        self.deferred = None
        self.acked = {self.rank}
        dout("mon", 10, f"mon.{self.rank} starting election epoch {self.epoch}")
        for r in range(self.n_mons):
            if r != self.rank:
                self.send(
                    r,
                    MMonElection(
                        op=MMonElection.OP_PROPOSE, epoch=self.epoch, rank=self.rank
                    ),
                )
        self._arm_timer()
        self._maybe_win()

    def _arm_timer(self, plus: float = 0.0) -> None:
        if self._timer is not None:
            self._timer.cancel()
        wait = self.timeout + plus

        async def expire():
            loop = asyncio.get_event_loop()
            while True:
                due = loop.time() + wait
                await asyncio.sleep(wait)
                if loop.time() - due <= wait / 2:
                    break
                self.late_timeouts += 1
                dout("mon", 5, f"mon.{self.rank} election timer woke "
                               f"{loop.time() - due:.3f} s late; waiting again")
            # timeout: a still-standing candidate wins with a majority;
            # anyone else (including a mon whose deferred candidate went
            # silent) restarts the election
            dout("mon", 10, f"mon.{self.rank} election timer expired at epoch "
                            f"{self.epoch}: electing {self.electing}, acked "
                            f"{sorted(self.acked)}, deferred {self.deferred}")
            if self.electing:
                if self.deferred is None and len(self.acked) >= self.quorum_size():
                    self._declare_victory()
                else:
                    self.start()

        self._timer = asyncio.get_event_loop().create_task(expire())

    def cancel(self) -> None:
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None

    # -- message handling ------------------------------------------------------

    def handle(self, msg: MMonElection) -> None:
        dout("mon", 10, f"mon.{self.rank} got election op {msg.op} from mon.{msg.rank} "
                        f"epoch {msg.epoch} (mine {self.epoch}, electing {self.electing}, "
                        f"deferred {self.deferred})")
        if msg.op == MMonElection.OP_PROPOSE:
            self._handle_propose(msg)
        elif msg.op == MMonElection.OP_ACK:
            self._handle_ack(msg)
        elif msg.op == MMonElection.OP_VICTORY:
            self._handle_victory(msg)

    def _handle_propose(self, msg: MMonElection) -> None:
        adopted = False
        if msg.epoch > self.epoch:
            # new election round: stale deferrals (e.g. to a dead leader)
            # don't carry over
            self.epoch = msg.epoch
            self.electing = True
            self.acked = {self.rank}
            self.deferred = None
            adopted = True
        if msg.rank < self.rank:
            if self.deferred is not None and self.deferred <= msg.rank:
                return  # already deferred to an equal-or-better candidate
            # better candidate: defer (ack) and drop our own candidacy —
            # ElectionLogic::defer; acking at most one candidate per epoch
            # keeps two candidates from both assembling a majority
            self.electing = True
            self.deferred = msg.rank
            self.acked.clear()
            self.send(
                msg.rank,
                MMonElection(op=MMonElection.OP_ACK, epoch=self.epoch, rank=self.rank),
            )
            self._arm_timer(DEFER_GRACE)
        else:
            # we outrank them: (re)launch our own full candidacy — start()
            # broadcasts to everyone and arms the timeout so the
            # majority-at-timeout victory path works even when we entered
            # the round via someone else's proposal
            if not self.electing or adopted:
                self.start()
            else:
                self.send(
                    msg.rank,
                    MMonElection(
                        op=MMonElection.OP_PROPOSE, epoch=self.epoch, rank=self.rank
                    ),
                )

    def _handle_ack(self, msg: MMonElection) -> None:
        if msg.epoch != self.epoch or not self.electing or self.deferred is not None:
            return
        self.acked.add(msg.rank)
        self._maybe_win()

    def _maybe_win(self) -> None:
        # Immediate victory once everyone acked; majority waits for timeout
        # so slower peers can still join the quorum.
        if self.deferred is None and len(self.acked) == self.n_mons:
            self._declare_victory()

    def _declare_victory(self) -> None:
        self.cancel()
        self.electing = False
        self.epoch += 1  # stable (odd) epoch
        self.leader = self.rank
        quorum = sorted(self.acked)
        dout("mon", 5, f"mon.{self.rank} wins election epoch {self.epoch} quorum {quorum}")
        for r in quorum:
            if r != self.rank:
                self.send(
                    r,
                    MMonElection(
                        op=MMonElection.OP_VICTORY, epoch=self.epoch,
                        rank=self.rank, quorum=quorum
                    ),
                )
        self.on_win(self.epoch, quorum)

    def _handle_victory(self, msg: MMonElection) -> None:
        if msg.epoch < self.epoch:
            return
        self.cancel()
        self.epoch = msg.epoch
        self.electing = False
        self.leader = msg.rank
        self.deferred = None
        dout("mon", 5, f"mon.{self.rank} defers to leader mon.{msg.rank}")
        self.on_lose(self.epoch, msg.rank, list(msg.quorum))
