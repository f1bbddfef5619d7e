"""Shared proposal queue for Paxos services.

The analog of PaxosService::propose_pending (src/mon/PaxosService.{h,cc}):
every service (mgr, config, log, auth) funnels mutations through one
in-flight proposal at a time, with each mutation's blob computed against
the *committed* state at propose time — so concurrent mutations cannot
race to the same version and drop each other's updates.  In the port a
leader proposes only once its Paxos has caught up (ROADMAP C17).
"""

from __future__ import annotations

from typing import Callable

# make_blob() -> serialized proposal bytes, or None when the mutation is a
# no-op against the now-committed state (already true / already absent).
MakeBlob = Callable[[], "bytes | None"]
OnCommitted = Callable[[int], None]


def paxos_recovering(mon) -> bool:
    """The leader's Paxos is still catching up from its quorum, so a blob
    computed now could be built on state older than the committed one
    (the port's; ROADMAP C17).  Unit harnesses drive services with a bare
    mon stub that has no Paxos."""
    paxos = getattr(mon, "paxos", None)
    return paxos is not None and paxos.recovering()


class ProposalQueue:
    def __init__(self, mon, service: str):
        self.mon = mon
        self.service = service
        self._pending: list[tuple[MakeBlob, OnCommitted | None]] = []
        self._proposing = False

    def reset(self) -> None:
        """On election change: drop queued mutations (clients retry against
        the new leader; PaxosService::election_finished)."""
        self._proposing = False
        self._pending.clear()

    def queue(self, make_blob: MakeBlob, on_committed: OnCommitted | None = None) -> None:
        self._pending.append((make_blob, on_committed))
        self.kick()

    def kick(self) -> None:
        if self._proposing or not self._pending or not self.mon.is_leader():
            return
        if paxos_recovering(self.mon):
            return  # kicked again once the leader has caught up (C17)
        make_blob, on_committed = self._pending.pop(0)
        blob = make_blob()
        if blob is None:
            if on_committed is not None:
                on_committed(-1)  # no-op: already true in committed state
            self.kick()
            return
        self._proposing = True

        def on_done(version: int) -> None:
            self._proposing = False
            if on_committed is not None:
                on_committed(version)
            self.kick()

        self.mon.propose(self.service, blob, on_done)
