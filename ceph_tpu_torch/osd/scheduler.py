"""Op QoS schedulers — mirror of src/osd/scheduler/.

The port's copy of `ceph_tpu/osd/scheduler.py`: `SchedClass`,
`ClientProfile`, `WorkItem` and `MClockScheduler`, which the launch
scheduler (ops/launch_scheduler.py) and the OSD's op queue run on, and the
`WPQScheduler` that `osd_op_queue = wpq` selects (`make_scheduler`).

Reference: src/osd/scheduler/mClockScheduler.h:72 (dmClock
tag-based scheduler over the external dmclock submodule; see also
src/dmclock/src/dmclock_server.h) and OpScheduler.h's WPQ alternative
(`osd_op_queue` option selects one, as here).

The dmClock algorithm (Gulati et al., OSDI'10) assigns each scheduling
class a (reservation, weight, limit) triple in IOPS:

- every queued item gets three tags: R (reservation), P (proportional),
  L (limit), each advancing from the class's previous tag by 1/rate;
- dequeue first serves any class whose R tag is in the past (reservations
  are guaranteed), then falls back to the smallest P tag among classes
  whose L tag is in the past (weights share the spare capacity, limits
  cap it).

Items carry an abstract `cost` (bytes) that scales the tag increments the
way the reference's mClock cost model scales by item size
(mClockScheduler.cc calc_scaled_cost).
"""

from __future__ import annotations

import enum
import heapq
import time
from collections import deque
from dataclasses import dataclass
from typing import Callable


class SchedClass(enum.Enum):
    """Scheduling classes (op_scheduler_class in OpSchedulerItem.h)."""

    CLIENT = "client"
    RECOVERY = "background_recovery"
    SCRUB = "background_scrub"
    BEST_EFFORT = "background_best_effort"


@dataclass
class ClientProfile:
    """dmClock (reservation, weight, limit); 0 = unset/unlimited."""

    reservation: float = 0.0
    weight: float = 1.0
    limit: float = 0.0


@dataclass
class _Tags:
    r: float = 0.0
    p: float = 0.0
    l: float = 0.0


@dataclass
class WorkItem:
    """One schedulable unit (OpSchedulerItem): an opaque runnable plus
    its class, cost in bytes, and priority for the WPQ fallback."""

    run: Callable[[], None]
    klass: SchedClass = SchedClass.CLIENT
    cost: int = 4096
    priority: int = 63


class OpScheduler:
    """Abstract scheduler (OpScheduler.h)."""

    def enqueue(self, item: WorkItem) -> None:
        raise NotImplementedError

    def dequeue(self) -> WorkItem | None:
        raise NotImplementedError

    def __len__(self) -> int:
        raise NotImplementedError

    def empty(self) -> bool:
        return len(self) == 0


class MClockScheduler(OpScheduler):
    """dmClock-lite over per-class FIFO queues (mClockScheduler.h:72).

    Rates are expressed in items/sec for a nominal 4 KiB item; an item of
    cost C consumes C/4096 nominal items, matching the reference's scaled
    cost model.  The clock is injectable for deterministic tests.
    """

    NOMINAL_COST = 4096.0

    def __init__(
        self,
        profiles: dict[SchedClass, ClientProfile] | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.profiles = profiles or {
            SchedClass.CLIENT: ClientProfile(reservation=1.0, weight=2.0),
            SchedClass.RECOVERY: ClientProfile(weight=1.0, limit=3.0),
            SchedClass.SCRUB: ClientProfile(weight=1.0, limit=3.0),
            SchedClass.BEST_EFFORT: ClientProfile(weight=1.0),
        }
        self.clock = clock
        self._queues: dict[SchedClass, deque[tuple[_Tags, WorkItem]]] = {
            k: deque() for k in SchedClass
        }
        self._last: dict[SchedClass, _Tags] = {k: _Tags() for k in SchedClass}
        self._size = 0

    def _profile(self, klass: SchedClass) -> ClientProfile:
        return self.profiles.get(klass, ClientProfile())

    def update_profile(self, klass: SchedClass, profile: ClientProfile) -> None:
        """Runtime reconfiguration (the reference's config-observer path,
        mClockScheduler.h:72 md_config_obs_t).  The class's tag chain
        restarts: a reservation of 0 stores r = inf as the last tag, and
        without a reset a later nonzero reservation would compute
        max(now, inf + 1/res) forever — the knob would be permanently
        inert (the reference rebuilds the dmclock client info on config
        change for the same reason)."""
        self.profiles[klass] = profile
        self._last[klass] = _Tags()

    def enqueue(self, item: WorkItem) -> None:
        now = self.clock()
        prof = self._profile(item.klass)
        last = self._last[item.klass]
        scale = item.cost / self.NOMINAL_COST
        tags = _Tags()
        # Tag formulas from dmclock_server.h: next tag = max(now, prev+1/rate)
        tags.r = (
            max(now, last.r + scale / prof.reservation)
            if prof.reservation > 0
            else float("inf")
        )
        tags.p = max(now, last.p + scale / prof.weight) if prof.weight > 0 else now
        tags.l = max(now, last.l + scale / prof.limit) if prof.limit > 0 else now
        self._last[item.klass] = tags
        self._queues[item.klass].append((tags, item))
        self._size += 1

    def dequeue(self) -> WorkItem | None:
        if self._size == 0:
            return None
        now = self.clock()
        # Phase 1: honor reservations whose R tag has matured.
        best_r: SchedClass | None = None
        for klass, q in self._queues.items():
            if q and q[0][0].r <= now:
                if best_r is None or q[0][0].r < self._queues[best_r][0][0].r:
                    best_r = klass
        if best_r is not None:
            return self._pop(best_r)
        # Phase 2: weight-based among classes under their limit.
        best_p: SchedClass | None = None
        for klass, q in self._queues.items():
            if q and q[0][0].l <= now:
                if best_p is None or q[0][0].p < self._queues[best_p][0][0].p:
                    best_p = klass
        if best_p is not None:
            return self._pop(best_p)
        # Everything is limited: serve the nearest limit tag anyway rather
        # than idle (work-conserving, as the reference's immediate mode).
        nearest = min(
            (k for k in self._queues if self._queues[k]),
            key=lambda k: self._queues[k][0][0].l,
        )
        return self._pop(nearest)

    def _pop(self, klass: SchedClass) -> WorkItem:
        _tags, item = self._queues[klass].popleft()
        self._size -= 1
        return item

    def __len__(self) -> int:
        return self._size


class WPQScheduler(OpScheduler):
    """Weighted priority queue fallback (OpScheduler.h WPQ): strict
    priority with FIFO within a priority."""

    def __init__(self):
        self._heap: list[tuple[int, int, WorkItem]] = []
        self._seq = 0

    def enqueue(self, item: WorkItem) -> None:
        self._seq += 1
        heapq.heappush(self._heap, (-item.priority, self._seq, item))

    def dequeue(self) -> WorkItem | None:
        if not self._heap:
            return None
        return heapq.heappop(self._heap)[2]

    def __len__(self) -> int:
        return len(self._heap)


def make_scheduler(kind: str, **kw) -> OpScheduler:
    """`osd_op_queue` selection (OpScheduler.cc make_scheduler)."""
    if kind == "wpq":
        return WPQScheduler()
    return MClockScheduler(**kw)
