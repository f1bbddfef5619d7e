"""Unified device launch scheduler with QoS classes.

The port's copy of `ceph_tpu/ops/launch_scheduler.py`.  Without it, each
aggregator owns a private path to the device: whoever flushes first
dispatches first, so a bulk background workload (deep-scrub verify,
backfill decode storms) could park a multi-megabyte launch in front of a
latency-sensitive client encode with no arbitration at all.  This module
is the layer between the aggregators and ``ops/dispatch``: every ready
launch is
enqueued as a schedulable item tagged with a :class:`SchedClass`
(client / recovery / background), and launches leave the queue in
dmClock tag order — the same reservation/weight/limit machinery the OSD
op queue uses (``osd/scheduler.py``), with the launch's input bytes as
its mClock cost.  Client encodes therefore preempt queued scrub work
under load, while scrub soaks up idle device time (the scheduler is
work-conserving: the queue never idles while work is queued).

Threading model — no dedicated dispatcher thread.  ``submit`` enqueues
the launch and then *drives* the queue: whichever submitter holds the
device turn dequeues the best-tagged item (possibly another class's)
and executes it; everyone else blocks on their own item's completion.
This is the storage analog of cooperative io_uring submission — the
arbitration cost in the uncontended single-launch case is one lock
round-trip, and under contention the dequeue order IS the QoS policy.
Launch callables run under the submitter's captured ``contextvars``
context so the flight-recorder active-record scope (and tracing spans)
survive being executed by another submitter's drain loop.

Observability: per-class enqueue/dequeue/queue-depth/wait counters
export through ``ops/dispatch.perf_dump()`` (asok ``perf dump`` →
``ec_dispatch.sched_*``) and again as the ``ceph_tpu_ec_sched_*``
Prometheus families via the OSD's MMgrReport; the class tag also rides
every flight record (``sched_class``) so ``tools/trace_export.py`` can
render one lane per class and make a priority inversion visible.
"""

from __future__ import annotations

import contextvars
import threading
import time
from typing import Callable

from ..common.lockdep import make_lock

from ..osd.scheduler import (
    ClientProfile,
    MClockScheduler,
    SchedClass,
    WorkItem,
)

# The three launch lanes.  SCRUB and BEST_EFFORT both
# render as "background": a deep-scrub verify launch and a best-effort
# housekeeping launch compete in the same QoS bucket.
LANES = ("client", "recovery", "background")

# lane name -> the scheduler class an aggregator submits under (the
# aggregators name their lane as a string so codec/ never has to import
# the OSD scheduler enum at module-import time)
CLASS_BY_LANE = {
    "client": SchedClass.CLIENT,
    "recovery": SchedClass.RECOVERY,
    "background": SchedClass.SCRUB,
}


def lane_name(klass: SchedClass) -> str:
    """Collapse the OSD scheduling classes onto the three launch lanes
    (flight-record ``sched_class`` values, counter keys, trace rows)."""
    if klass is SchedClass.CLIENT:
        return "client"
    if klass is SchedClass.RECOVERY:
        return "recovery"
    return "background"


class _PendingLaunch:
    """One enqueued launch: the callable, its captured context, and the
    completion rendezvous its submitter blocks on."""

    __slots__ = ("fn", "klass", "cost", "ctx", "done", "result", "error",
                 "enqueue_ts")

    def __init__(self, fn: Callable[[], object], klass: SchedClass, cost: int):
        self.fn = fn
        self.klass = klass
        self.cost = int(cost)
        # the drain loop may run `fn` from ANOTHER submitter's thread;
        # the flight-record contextvar scope (and tracer span scope) set
        # by the launching aggregator must still be visible inside
        self.ctx = contextvars.copy_context()
        self.done = threading.Event()
        self.result: object = None
        self.error: BaseException | None = None
        self.enqueue_ts = time.monotonic()


class LaunchScheduler:
    """QoS arbiter for the shared device queue.

    ``profiles`` maps the three scheduler classes to dmClock
    (reservation, weight, limit) triples; rates are nominal-4KiB items
    per second exactly as in :class:`MClockScheduler`, so a launch of
    N bytes consumes N/4096 nominal items.  ``clock`` is injectable for
    deterministic ordering tests.
    """

    def __init__(
        self,
        profiles: dict[SchedClass, ClientProfile] | None = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if profiles is None:
            profiles = default_profiles()
        self._mclock = MClockScheduler(profiles=profiles, clock=clock)
        self._lock = make_lock("launch_scheduler")
        self._cv = threading.Condition(self._lock)
        self._busy = False  # a launch is executing (the device turn)
        # bytes_total: input bytes dispatched per lane — with
        # the pipelined aggregators the device turn covers only the
        # (async) dispatch, so per-lane BYTES, not launch counts, are
        # what the QoS knobs actually arbitrate; the gauge pair
        # (dequeued, bytes_total) makes a lane's launch-size mix visible
        self._counters: dict[str, dict[str, float]] = {
            lane: {"enqueued": 0, "dequeued": 0, "wait_ms_total": 0.0,
                   "bytes_total": 0}
            for lane in LANES
        }

    # -- configuration -----------------------------------------------------

    def configure(self, **profiles: ClientProfile) -> None:
        """Apply live QoS profiles by lane name (``client`` /
        ``recovery`` / ``background``): the OSD's ``ec_tpu_sched_*``
        config observers land here."""
        mapping = {
            "client": (SchedClass.CLIENT,),
            "recovery": (SchedClass.RECOVERY,),
            # both background classes share the knob set
            "background": (SchedClass.SCRUB, SchedClass.BEST_EFFORT),
        }
        with self._lock:
            for lane, profile in profiles.items():
                if profile is None:
                    continue
                for klass in mapping[lane]:
                    self._mclock.update_profile(klass, profile)

    # -- submission --------------------------------------------------------

    def submit(self, klass: SchedClass, fn: Callable[[], object],
               cost: int = 4096) -> object:
        """Enqueue one ready launch and drive the queue until it has
        run.  Returns ``fn``'s result (raises its exception).  The
        caller may end up executing OTHER queued launches first — the
        dequeue order is the QoS policy, not submission order."""
        pend = self.submit_async(klass, fn, cost)
        while not pend.done.is_set():
            ran = self._run_one()
            if ran is None and not pend.done.is_set():
                # our item is executing on another submitter's turn (or
                # the turn-holder will dequeue it next): wait for
                # progress instead of spinning
                with self._cv:
                    while self._busy and not pend.done.is_set():
                        self._cv.wait(timeout=0.5)
        if pend.error is not None:
            raise pend.error
        return pend.result

    def submit_async(self, klass: SchedClass, fn: Callable[[], object],
                     cost: int = 4096) -> _PendingLaunch:
        """Enqueue without driving (the test surface, and the first half
        of :meth:`submit`)."""
        pend = _PendingLaunch(fn, klass, cost)
        with self._lock:
            self._mclock.enqueue(
                WorkItem(run=pend, klass=klass, cost=pend.cost)
            )
            self._counters[lane_name(klass)]["enqueued"] += 1
        return pend

    def _run_one(self) -> _PendingLaunch | None:
        """Take the device turn and execute the best-tagged queued
        launch.  None when the turn is held elsewhere or the queue is
        empty."""
        with self._lock:
            if self._busy:
                return None
            item = self._mclock.dequeue()
            if item is None:
                return None
            self._busy = True
            pend: _PendingLaunch = item.run  # the payload, not a callable
            lane = self._counters[lane_name(pend.klass)]
            lane["dequeued"] += 1
            lane["bytes_total"] += pend.cost
            lane["wait_ms_total"] += (
                time.monotonic() - pend.enqueue_ts
            ) * 1e3
        try:
            pend.result = pend.ctx.run(pend.fn)
        except BaseException as e:
            pend.error = e
        finally:
            with self._cv:
                self._busy = False
                pend.done.set()
                self._cv.notify_all()
        return pend

    def drain(self) -> int:
        """Execute queued launches until the queue is empty (tests;
        barrier paths already drain implicitly because every submitter
        drives the queue).  Returns how many launches ran."""
        ran = 0
        while self._run_one() is not None:
            ran += 1
        return ran

    # -- introspection -----------------------------------------------------

    def queue_depths(self) -> dict[str, int]:
        """Per-lane queued-launch counts (the queue-depth gauges)."""
        depths = dict.fromkeys(LANES, 0)
        with self._lock:
            for klass, q in self._mclock._queues.items():
                depths[lane_name(klass)] += len(q)
        return depths

    def perf_dump(self) -> dict[str, float]:
        """Flat per-lane counters for ``ops/dispatch.perf_dump()`` (the
        ``sched.<lane>.<counter>`` keys) and the OSD's MMgrReport
        (``ec_sched.*`` → ``ceph_tpu_ec_sched_*`` families)."""
        depths = self.queue_depths()
        out: dict[str, float] = {}
        with self._lock:
            for lane in LANES:
                c = self._counters[lane]
                out[f"{lane}.enqueued"] = int(c["enqueued"])
                out[f"{lane}.dequeued"] = int(c["dequeued"])
                out[f"{lane}.bytes_total"] = int(c["bytes_total"])
                out[f"{lane}.wait_ms_total"] = round(c["wait_ms_total"], 3)
                out[f"{lane}.queue_depth"] = depths[lane]
        return out

    def reset_counters(self) -> None:
        with self._lock:
            for lane in LANES:
                self._counters[lane] = {
                    "enqueued": 0, "dequeued": 0, "wait_ms_total": 0.0,
                    "bytes_total": 0,
                }


def default_profiles() -> dict[SchedClass, ClientProfile]:
    """The option-table QoS defaults (``ec_tpu_sched_*``): client holds
    a reservation + double weight so its launches mature first; the
    background classes get half weight and no reservation, soaking idle
    time only.  Daemons with a live Config re-apply through
    ``LaunchScheduler.configure``."""
    from ..common.options import OPTIONS

    def prof(lane: str) -> ClientProfile:
        return ClientProfile(
            reservation=float(OPTIONS[f"ec_tpu_sched_{lane}_res"].default),
            weight=float(OPTIONS[f"ec_tpu_sched_{lane}_wgt"].default),
            limit=float(OPTIONS[f"ec_tpu_sched_{lane}_lim"].default),
        )

    background = prof("background")
    return {
        SchedClass.CLIENT: prof("client"),
        SchedClass.RECOVERY: prof("recovery"),
        SchedClass.SCRUB: background,
        SchedClass.BEST_EFFORT: background,
    }


_SCHEDULER: LaunchScheduler | None = None


def launch_scheduler() -> LaunchScheduler:
    """The process-wide scheduler every aggregator dispatches through
    (lazy, like the device guard and the default aggregators)."""
    global _SCHEDULER
    if _SCHEDULER is None:
        _SCHEDULER = LaunchScheduler()
    return _SCHEDULER
