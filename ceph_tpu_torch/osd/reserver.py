"""Bounded reservation slots — src/common/AsyncReserver.h scaled down.

The port of `ceph_tpu/osd/reserver.py`.

The reference queues prioritized reservation requests, grants them
asynchronously, and PREEMPTS lower-priority holders when a
higher-priority request arrives (the recovery-beats-backfill rule that
keeps a whole-OSD rebuild from queueing behind a leisurely backfill).
OSDs hold a `local_reserver` (their own backfill/recovery slots) and a
`remote_reserver` (slots they grant to other primaries), both bounded by
`osd_max_backfills`.

Here grants are immediate-or-denied and denied callers retry from their
periodic tick (the tick loop is this framework's requeue mechanism, see
PeeringState.tick) — same bound, no queue — but the preemption half is
real: a `try_reserve` at a strictly higher priority than the
lowest-priority current holder evicts that holder, firing its
`on_preempt` callback exactly once so it can surrender cleanly and
retry later.  Ties never preempt (a re-granted backfill must not be
bounced by an equal-priority sibling), so grant order is deterministic
under the tick-retry discipline.
"""

from __future__ import annotations

from typing import Callable, Hashable


class Reserver:
    def __init__(self, slots: Callable[[], int]):
        self._slots = slots
        # key -> (priority, on_preempt or None)
        self._held: dict[Hashable, tuple[int, Callable[[], None] | None]] = {}
        self.preemptions = 0  # lifetime preempt count (introspection)

    def try_reserve(
        self,
        key: Hashable,
        priority: int = 0,
        on_preempt: Callable[[], None] | None = None,
    ) -> bool:
        """Grant a slot (idempotent per key; a re-reserve refreshes the
        priority/callback); False when full of >= priority holders.
        When full, the LOWEST-priority holder is preempted iff its
        priority is strictly below the request's — its `on_preempt`
        fires after its slot is gone, so the callback observes the
        post-preemption state and a re-reserve from inside it queues
        behind the winner instead of recursing into it."""
        if key in self._held:
            self._held[key] = (int(priority), on_preempt)
            return True
        if len(self._held) >= max(1, int(self._slots())):
            victim = min(
                self._held, key=lambda k: self._held[k][0], default=None
            )
            if victim is None or self._held[victim][0] >= int(priority):
                return False
            _vprio, vcb = self._held.pop(victim)
            self.preemptions += 1
            self._held[key] = (int(priority), on_preempt)
            if vcb is not None:
                vcb()
            return True
        self._held[key] = (int(priority), on_preempt)
        return True

    def release(self, key: Hashable) -> bool:
        """Release a held slot; True iff the key was actually held.
        Releasing a preempted (or never-granted) key is a no-op — the
        exactly-once contract interval-change cleanup relies on."""
        return self._held.pop(key, None) is not None

    def held(self) -> int:
        return len(self._held)

    def holders(self) -> dict[Hashable, int]:
        """{key: priority} snapshot (introspection/tests)."""
        return {k: prio for k, (prio, _cb) in self._held.items()}
