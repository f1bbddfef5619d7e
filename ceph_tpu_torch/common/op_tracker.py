"""OpTracker — in-flight + historic op introspection
(src/common/TrackedOp.{h,cc}: OpTracker / OpRequest; surfaced via the
admin socket's `dump_ops_in_flight` / `dump_historic_ops`, the operator's
first stop for "why is this op slow").

Each tracked op records its description, arrival time, and event marks
("queued", "reached_pg", "done" — TrackedOp::mark_event); completed ops
move into a bounded history ring ordered by recency, with the
longest-duration ops kept in a second ring (dump_historic_slow_ops).
"""

from __future__ import annotations

import time
from collections import deque


class TrackedOp:
    __slots__ = (
        "desc", "start", "events", "duration",
        # workload-attribution tags: which pool/client this op
        # belongs to and its class (read/write/recovery) — what the OSD's
        # IOAccountant and the mgr iostat module aggregate by
        "pool_id", "client", "op_class",
    )

    def __init__(
        self,
        desc: str,
        pool_id: int = -1,
        client: str = "",
        op_class: str = "",
    ):
        self.desc = desc
        self.start = time.monotonic()
        self.events: list[tuple[float, str]] = [(self.start, "initiated")]
        self.duration: float | None = None
        self.pool_id = pool_id
        self.client = client
        self.op_class = op_class

    def mark_event(self, what: str) -> None:
        self.events.append((time.monotonic(), what))

    def dump(self) -> dict:
        now = time.monotonic()
        return {
            "description": self.desc,
            "pool": self.pool_id,
            "client": self.client,
            "op_class": self.op_class,
            "age": round(now - self.start, 6),
            "duration": None if self.duration is None else round(self.duration, 6),
            "type_data": {
                "events": [
                    {"time": round(t - self.start, 6), "event": e}
                    for t, e in self.events
                ],
                # per-stage durations: the gap
                # between consecutive event marks, named after the stage
                # they END ("queued" -> "reached_pg" renders as
                # reached_pg's duration) — where a historic op's time
                # went, without the reader diffing timestamps by hand
                "stages": [
                    {
                        "stage": self.events[i][1],
                        "duration": round(
                            self.events[i][0] - self.events[i - 1][0], 6
                        ),
                    }
                    for i in range(1, len(self.events))
                ],
            },
        }


class OpTracker:
    """Bounded in-flight registry + completion history."""

    # in-flight entries older than this are swept to history as aborted:
    # an op whose reply closure was lost to a fault path must stay visible
    # for a while (that IS dump_ops_in_flight's job) but not accumulate
    # forever under repeated faults
    ABORT_SWEEP_AGE = 600.0

    def __init__(self, history_size: int = 20, slow_size: int = 20):
        self._inflight: dict[int, TrackedOp] = {}
        self._seq = 0
        self.history: deque[TrackedOp] = deque(maxlen=history_size)
        self.slow: deque[TrackedOp] = deque(maxlen=slow_size)
        # in-flight ops older than this are "slow requests"
        # (osd_op_complaint_time; OpTracker::check_ops_in_flight's
        # complaint threshold) — counted into the SLOW_OPS health check
        self.complaint_time = 30.0

    def resize_history(self, history_size: int) -> None:
        """Runtime osd_op_history_size change (config observer)."""
        self.history = deque(self.history, maxlen=max(1, int(history_size)))

    def create(
        self,
        desc: str,
        pool_id: int = -1,
        client: str = "",
        op_class: str = "",
    ) -> int:
        """Register an op; returns the token finish() takes.  The
        attribution tags (pool, client, op class) ride the tracked op so
        `dump_ops_in_flight` answers "whose op is stuck", and the OSD's
        reply path feeds them into the IOAccountant at finish.

        Registration is UNCONDITIONAL — trace sampling (ISSUE 10 layer 3)
        gates span *retention*, never this registry, so a sampled-out op
        still ages into the SLOW_OPS complaint accounting."""
        self._seq += 1
        self._inflight[self._seq] = TrackedOp(
            desc, pool_id=pool_id, client=client, op_class=op_class
        )
        if self._seq % 256 == 0:
            self._sweep_aborted()
        return self._seq

    def _sweep_aborted(self) -> None:
        cutoff = time.monotonic() - self.ABORT_SWEEP_AGE
        for tok in [t for t, o in self._inflight.items() if o.start < cutoff]:
            op = self._inflight.pop(tok)
            op.mark_event("aborted (tracker sweep)")
            op.duration = time.monotonic() - op.start
            self.history.append(op)

    def mark_event(self, token: int, what: str) -> None:
        op = self._inflight.get(token)
        if op is not None:
            op.mark_event(what)

    def finish(self, token: int) -> None:
        op = self._inflight.pop(token, None)
        if op is None:
            return
        op.mark_event("done")
        op.duration = time.monotonic() - op.start
        self.history.append(op)
        # keep the slowest ops separately (dump_historic_slow_ops): evict
        # the fastest once full
        if len(self.slow) < self.slow.maxlen:
            self.slow.append(op)
        else:
            fastest = min(self.slow, key=lambda o: o.duration or 0.0)
            if (op.duration or 0.0) > (fastest.duration or 0.0):
                self.slow.remove(fastest)
                self.slow.append(op)

    def slow_ops(self) -> tuple[int, float]:
        """(count, oldest age in seconds) of in-flight ops older than the
        complaint time (OpTracker::check_ops_in_flight; feeds the OSD's
        mgr report and, through the mgr digest, the SLOW_OPS health
        check)."""
        now = time.monotonic()
        ages = [
            now - op.start
            for op in self._inflight.values()
            if now - op.start >= self.complaint_time
        ]
        return len(ages), max(ages, default=0.0)

    # -- dumps (OpTracker::dump_ops_in_flight / dump_historic_ops) -----------

    def dump_in_flight(self) -> dict:
        ops = sorted(self._inflight.values(), key=lambda o: o.start)
        return {"num_ops": len(ops), "ops": [o.dump() for o in ops]}

    def dump_historic(self) -> dict:
        ops = list(self.history)
        return {"num_ops": len(ops), "ops": [o.dump() for o in reversed(ops)]}

    def dump_slow(self) -> dict:
        ops = sorted(self.slow, key=lambda o: -(o.duration or 0.0))
        return {"num_ops": len(ops), "ops": [o.dump() for o in ops]}
