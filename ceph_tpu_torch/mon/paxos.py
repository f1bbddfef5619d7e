"""Paxos — the mon's replicated transaction log (src/mon/Paxos.{h,cc}).

The reference runs classic multi-Paxos with a single active proposer (the
elected leader): after each election the leader runs a COLLECT round (new
proposal number; peons report their last_committed and any accepted-but-
uncommitted value, which the leader must re-drive); values then flow
BEGIN -> ACCEPT (majority) -> COMMIT, one in flight at a time
(Paxos.h:174 state machine).  Reads are forwarded to the leader.

State lives in a small dict store (the mon's KV analog): accepted_pn,
last_committed, and the committed value log keyed by version.

Two additions of the port's (ROADMAP C16, C17), both off the seeded
message path that the differential compares:

- the lease (Paxos::extend_lease, lease_timeout, lease_ack_timeout): the
  leader sends OP_LEASE every `mon_lease` * 0.6 seconds and peons answer
  OP_LEASE_ACK; a peon that hears no lease, or a leader that hears no
  ack from a quorum member that has acked before, for `mon_lease` * 2
  seconds calls an election.
  The monitor's tick drives it (`lease_tick`).  Without it a dead leader
  is never replaced;
- a leader restarted with an empty store collects under a proposal
  number below its peons' accepted one: a peon answers such a COLLECT
  with its own pn and the leader collects again above it (Ceph's
  handle_collect / handle_last), where the reference's peons drop it and
  the quorum never commits again; and `on_active` is called once the
  COLLECT round has caught the leader up (at once for a quorum of one),
  so services propose against the committed state and not the state a
  fresh monitor started from (PaxosService::_active).
"""

from __future__ import annotations

import time
from typing import Callable

from ..common.log import dout
from ..msg.messages import MMonPaxos

# Ceph's mon_lease_renew_interval_factor and mon_lease_ack_timeout_factor
LEASE_RENEW_FACTOR = 0.6
LEASE_ACK_TIMEOUT_FACTOR = 2.0


class Paxos:
    def __init__(
        self,
        rank: int,
        send: Callable[[int, MMonPaxos], None],
        on_commit: Callable[[int, bytes], None],
        on_active: Callable[[], None] | None = None,
    ):
        self.rank = rank
        self.on_active = on_active  # leader caught up: services may propose
        self.send = send
        self.on_commit = on_commit  # (version, value) applied in order
        self.store: dict[int, bytes] = {}  # version -> committed value
        self.last_committed = 0
        self.accepted_pn = 0
        self.quorum: list[int] = [rank]
        self.leading = True
        # leader proposal state
        self._collecting = False
        self._collect_acks: set[int] = set()
        self._uncommitted: tuple[int, int, bytes] | None = None  # (pn, v, value)
        self._pending: list[tuple[bytes, Callable[[int], None] | None]] = []
        self._active_value: tuple[int, bytes, Callable[[int], None] | None] | None = None
        self._accept_acks: set[int] = set()
        # peon state
        self._peon_uncommitted: tuple[int, int, bytes] | None = None
        # the lease: when the peon's lease runs out, and per quorum peer
        # when the leader last heard its ack (monotonic seconds)
        self.lease = 5.0  # mon_lease, set by the monitor
        self.lease_expire = 0.0
        self.lease_acks: dict[int, float] = {}
        self._lease_sent = 0.0

    # -- election hooks --------------------------------------------------------

    def leader_init(self, quorum: list[int]) -> None:
        """Election won: run the collect phase (Paxos::leader_init)."""
        self.quorum = quorum
        self.leading = True
        self._active_value = None
        self._accept_acks = set()
        self.lease_acks = {}
        self._lease_sent = 0.0
        if len(quorum) == 1:
            self._collecting = False
            self._became_active()
            return
        self._collecting = True
        self._collect_acks = {self.rank}
        self.accepted_pn = self._new_pn()
        self._uncommitted = None
        for r in self.quorum:
            if r != self.rank:
                self.send(
                    r,
                    MMonPaxos(
                        op=MMonPaxos.OP_COLLECT,
                        pn=self.accepted_pn,
                        last_committed=self.last_committed,
                        values={},
                    ),
                )

    def peon_init(self, leader: int) -> None:
        self.leading = False
        self._collecting = False
        self._pending.clear()
        self._active_value = None
        self.lease_expire = 0.0

    def recovering(self) -> bool:
        """The leader's COLLECT round is running: its state may lag the
        quorum's, so services hold their proposals (PaxosService::
        is_active)."""
        return self.leading and self._collecting

    def _became_active(self) -> None:
        if self.on_active is not None:
            self.on_active()
        self._drive_pending()

    def _new_pn(self) -> int:
        # proposal numbers namespaced by rank (Paxos::get_new_proposal_number)
        base = max(self.accepted_pn, 0) // 100 + 1
        return base * 100 + self.rank

    # -- client surface --------------------------------------------------------

    def propose(self, value: bytes, on_done: Callable[[int], None] | None = None) -> None:
        """Queue a transaction; leader-only (services check is_leader)."""
        assert self.leading, "propose on a peon"
        self._pending.append((value, on_done))
        self._drive_pending()

    def is_writeable(self) -> bool:
        return self.leading and not self._collecting and self._active_value is None

    def _drive_pending(self) -> None:
        if not self.is_writeable() or not self._pending:
            return
        value, on_done = self._pending.pop(0)
        v = self.last_committed + 1
        self._active_value = (v, value, on_done)
        self._accept_acks = {self.rank}
        for r in self.quorum:
            if r != self.rank:
                self.send(
                    r,
                    MMonPaxos(
                        op=MMonPaxos.OP_BEGIN,
                        pn=self.accepted_pn,
                        last_committed=self.last_committed,
                        values={v: value},
                    ),
                )
        self._check_accepted()

    # -- message handling ------------------------------------------------------

    def handle(self, msg: MMonPaxos, from_rank: int) -> None:
        op = msg.op
        if op == MMonPaxos.OP_COLLECT:
            self._handle_collect(msg, from_rank)
        elif op == MMonPaxos.OP_LAST:
            self._handle_last(msg, from_rank)
        elif op == MMonPaxos.OP_BEGIN:
            self._handle_begin(msg, from_rank)
        elif op == MMonPaxos.OP_ACCEPT:
            self._handle_accept(msg, from_rank)
        elif op == MMonPaxos.OP_COMMIT:
            self._handle_commit(msg, from_rank)
        elif op == MMonPaxos.OP_LEASE:
            self._handle_lease(msg, from_rank)
        elif op == MMonPaxos.OP_LEASE_ACK:
            self._handle_lease_ack(msg, from_rank)

    # peon: collect -> LAST (report state, adopt pn)
    def _handle_collect(self, msg: MMonPaxos, from_rank: int) -> None:
        if msg.pn < self.accepted_pn:
            # a proposer below our pn (a leader restarted with an empty
            # store): tell it our pn so it collects again above it, as
            # Ceph's handle_collect does; the reference drops it (C17)
            self.send(from_rank, MMonPaxos(op=MMonPaxos.OP_LAST, pn=self.accepted_pn,
                                           last_committed=self.last_committed, values={}))
            return
        self.accepted_pn = msg.pn
        values: dict[int, bytes] = {}
        # share commits the leader is missing (Paxos::share_state)
        for v in range(msg.last_committed + 1, self.last_committed + 1):
            if v in self.store:
                values[v] = self.store[v]
        uncommitted_pn = 0
        if self._peon_uncommitted is not None:
            pn, v, val = self._peon_uncommitted
            if v == self.last_committed + 1:
                values[v] = val
                uncommitted_pn = pn
        self.send(
            from_rank,
            MMonPaxos(
                op=MMonPaxos.OP_LAST,
                pn=msg.pn,
                last_committed=self.last_committed,
                values=values,
                uncommitted_pn=uncommitted_pn,
            ),
        )

    # leader: gather LASTs (collect acks AND lagging-peon catch-up requests)
    def _handle_last(self, msg: MMonPaxos, from_rank: int) -> None:
        if self.leading and self._collecting and msg.pn > self.accepted_pn:
            # a peon accepted a higher pn: collect again above it
            # (Paxos::handle_last; the port's, C17)
            self.accepted_pn = msg.pn
            self.leader_init(self.quorum)
            return
        if not self.leading or msg.pn != self.accepted_pn:
            return
        # Adopt only the peon's COMMITTED values (v <= its last_committed);
        # an accepted-but-uncommitted value (slot last_committed+1) was
        # possibly never chosen and MUST be re-proposed through a full
        # round, never committed directly (Paxos::handle_last's
        # uncommitted_v handling).
        for v in sorted(msg.values):
            if v > self.last_committed and v <= msg.last_committed:
                self._commit_value(v, msg.values[v])
        # share commits the peon is missing (Paxos::share_state)
        self._handle_last_catchup(from_rank, msg.last_committed)
        if not self._collecting:
            return
        uncommitted_v = msg.last_committed + 1
        if uncommitted_v in msg.values and uncommitted_v > self.last_committed:
            # keep the value accepted under the highest pn (Paxos invariant)
            if self._uncommitted is None or msg.uncommitted_pn > self._uncommitted[0]:
                self._uncommitted = (
                    msg.uncommitted_pn,
                    uncommitted_v,
                    msg.values[uncommitted_v],
                )
        self._collect_acks.add(from_rank)
        if len(self._collect_acks) >= len(self.quorum):
            self._collecting = False
            if self._uncommitted is not None:
                _pn, v, value = self._uncommitted
                self._uncommitted = None
                # re-propose only if the slot wasn't committed meanwhile
                if v > self.last_committed:
                    self._pending.insert(0, (value, None))
            dout("mon", 10, f"paxos.{self.rank} collect done at v{self.last_committed}")
            self._became_active()

    # peon: begin -> accept
    def _handle_begin(self, msg: MMonPaxos, from_rank: int) -> None:
        if msg.pn < self.accepted_pn:
            return
        self.accepted_pn = msg.pn
        (v, value), = msg.values.items()
        # catch up any commits implied by the leader's last_committed
        if msg.last_committed > self.last_committed:
            # we're behind and can't apply a value out of order; ask via LAST
            self.send(
                from_rank,
                MMonPaxos(
                    op=MMonPaxos.OP_LAST,
                    pn=msg.pn,
                    last_committed=self.last_committed,
                    values={},
                ),
            )
            return
        self._peon_uncommitted = (msg.pn, v, value)
        self.send(
            from_rank,
            MMonPaxos(
                op=MMonPaxos.OP_ACCEPT,
                pn=msg.pn,
                last_committed=self.last_committed,
                values={},
            ),
        )

    # leader: gather accepts -> commit
    def _handle_accept(self, msg: MMonPaxos, from_rank: int) -> None:
        if not self.leading or msg.pn != self.accepted_pn or self._active_value is None:
            return
        self._accept_acks.add(from_rank)
        self._check_accepted()

    def _handle_last_catchup(self, from_rank: int, their_lc: int) -> None:
        values = {
            v: self.store[v]
            for v in range(their_lc + 1, self.last_committed + 1)
            if v in self.store
        }
        if values:
            self.send(
                from_rank,
                MMonPaxos(
                    op=MMonPaxos.OP_COMMIT,
                    pn=self.accepted_pn,
                    last_committed=self.last_committed,
                    values=values,
                ),
            )

    def _check_accepted(self) -> None:
        if self._active_value is None:
            return
        majority = len(self.quorum) // 2 + 1
        if len(self._accept_acks) < majority:
            return
        v, value, on_done = self._active_value
        self._active_value = None
        self._commit_value(v, value)
        for r in self.quorum:
            if r != self.rank:
                self.send(
                    r,
                    MMonPaxos(
                        op=MMonPaxos.OP_COMMIT,
                        pn=self.accepted_pn,
                        last_committed=self.last_committed,
                        values={v: value},
                    ),
                )
        if on_done is not None:
            on_done(v)
        self._drive_pending()

    # peon: commit
    def _handle_commit(self, msg: MMonPaxos, from_rank: int) -> None:
        for v in sorted(msg.values):
            if v == self.last_committed + 1:
                self._commit_value(v, msg.values[v])
        self._peon_uncommitted = None
        if self.last_committed < msg.last_committed:
            # still behind: ask the leader for the gap
            self.send(
                from_rank,
                MMonPaxos(
                    op=MMonPaxos.OP_LAST,
                    pn=self.accepted_pn,
                    last_committed=self.last_committed,
                    values={},
                ),
            )

    def _commit_value(self, v: int, value: bytes) -> None:
        assert v == self.last_committed + 1, (v, self.last_committed)
        self.store[v] = value
        self.last_committed = v
        self.on_commit(v, value)

    # -- the lease (the port's; ROADMAP C16) -----------------------------------

    def lease_tick(self, now: float) -> bool:
        """One lease step at monotonic time `now`: the leader renews
        (Paxos::extend_lease) and checks its peers' acks; a peon checks
        its lease.  True when the lease is lost and the caller must call
        an election."""
        timeout = self.lease * LEASE_ACK_TIMEOUT_FACTOR
        if not self.leading:
            if self.lease_expire == 0.0:
                self.lease_expire = now + timeout  # the first lease is on its way
            return now > self.lease_expire
        if self._collecting:
            return False
        peers = [r for r in self.quorum if r != self.rank]
        # only a peer that has acked a lease this term is judged: the JAX
        # package's monitors never ack, and a quorum with one of them
        # keeps it as the reference would
        if any(now - self.lease_acks[r] > timeout for r in peers if r in self.lease_acks):
            return True
        if peers and now - self._lease_sent >= self.lease * LEASE_RENEW_FACTOR:
            self._lease_sent = now
            for r in peers:
                self.send(r, MMonPaxos(op=MMonPaxos.OP_LEASE, pn=self.accepted_pn,
                                       last_committed=self.last_committed, values={}))
        return False

    def lease_reset(self, now: float) -> None:
        """Give every lease clock a fresh timeout: the caller's event loop
        was stalled, so a missing lease or ack says nothing of the peer."""
        timeout = self.lease * LEASE_ACK_TIMEOUT_FACTOR
        if self.lease_expire:
            self.lease_expire = now + timeout
        for r in self.lease_acks:
            self.lease_acks[r] = now

    def _handle_lease(self, msg: MMonPaxos, from_rank: int) -> None:
        if self.leading or msg.pn < self.accepted_pn:
            return
        self.lease_expire = time.monotonic() + self.lease * LEASE_ACK_TIMEOUT_FACTOR
        self.send(from_rank, MMonPaxos(op=MMonPaxos.OP_LEASE_ACK, pn=msg.pn,
                                       last_committed=self.last_committed, values={}))

    def _handle_lease_ack(self, msg: MMonPaxos, from_rank: int) -> None:
        if self.leading and from_rank in self.quorum:
            self.lease_acks[from_rank] = time.monotonic()
