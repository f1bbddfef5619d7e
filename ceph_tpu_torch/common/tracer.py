"""Span tracing — mirror of src/common/tracer.h + blkin ZTracer.

The port's copy of `ceph_tpu/common/tracer.py`, whole.

Ceph: src/common/tracer.h:18 (`tracing::Tracer`
producing `jspan` opentelemetry spans) and the Zipkin/blkin traces
threaded through the EC data path (every ECBackend::handle_sub_* takes a
ZTracer::Trace, src/osd/ECBackend.h:64-87, with events like
`trace.event("start ec write")`, ECBackend.cc:2020).  Spans here are
in-process records with parent links, timed events, and keyvals,
exportable as JSON for offline analysis.

Cross-daemon propagation (the W3C traceparent / jspan-context analog):
every span carries a 63-bit `trace_id` shared by the whole operation and
a process-unique `span_id`.  `inject()` copies the pair into a message's
envelope fields and `extract()` recovers a `TraceContext` on the far
side, so one client write yields ONE trace spanning client → messenger →
OSD dispatch → EC encode → codec kernel → commit, with every hop
parent-linked across daemons.  `current_span()`/`span_scope()` expose
the active span through a contextvar so deep layers (codec plugins, the
stripe driver) can attach sub-spans without threading a parent through
every signature.
"""

from __future__ import annotations

import contextlib
import contextvars
import itertools
import random
import threading
import time
from dataclasses import dataclass, field

from .lockdep import make_lock


# envelope sampling-decision values (msg.trace_sampled): the head
# decision is made ONCE — at the first daemon with sampling CONFIGURED
# (the client when it has the knobs, else the OSD) — and carried on the
# message envelope so every downstream span honors it instead of
# re-rolling the dice
SAMPLED_KEEP = 1   # trace is head-sampled: retain spans immediately
SAMPLED_DROP = 2   # head-sampled OUT: spans stay provisional (tail-keep
                   # for slow/errored ops can still rescue them)
SAMPLED_NONE = 3   # sender traced but has NO sampling configured (e.g.
                   # a client without the OSD knobs): the receiver makes
                   # its own head decision rather than inheriting an
                   # implicit KEEP that would bypass the span budget


@dataclass(frozen=True)
class TraceContext:
    """The propagated (trace_id, span_id, sampled) triple — what rides a
    message envelope between daemons (jspan context / blkin trace info).
    `sampled` carries the head-sampling decision; envelopes from senders
    predating the flag default to KEEP (the pre-sampling behavior)."""

    trace_id: int
    span_id: int
    sampled: int = SAMPLED_KEEP


@dataclass
class Span:
    tracer: "Tracer"
    span_id: int
    parent_id: int | None
    name: str
    # True when this span is in the export buffer.  event()/keyval() key
    # off THIS, not the tracer's live flag: a runtime enable mid-op must
    # not grow events on spans the dump will never show, nor attach
    # exported children to unexported parents.
    recorded: bool = False
    # True while the span collects events but has NOT been committed to
    # the export ring: its trace was head-sampled out (or over budget)
    # and only a tail keep (slow/errored op) can still retain it.
    provisional: bool = False
    trace_id: int = 0
    start: float = field(default_factory=time.monotonic)
    end: float | None = None
    events: list[tuple[float, str]] = field(default_factory=list)
    tags: dict[str, str] = field(default_factory=dict)

    def event(self, name) -> None:
        """blkin Trace::event.  `name` may be a zero-arg callable so hot
        paths skip f-string construction when tracing is off."""
        if self.recorded:
            self.events.append(
                (time.monotonic(), name() if callable(name) else name)
            )

    def keyval(self, key: str, val: object) -> None:
        if self.recorded:
            self.tags[key] = str(val() if callable(val) else val)

    def child(self, name: str) -> "Span":
        return self.tracer.start_span(name, parent=self)

    def context(self) -> TraceContext:
        """The propagatable identity of this span."""
        return TraceContext(self.trace_id, self.span_id)

    def finish(self) -> None:
        self.end = time.monotonic()
        if self.provisional:
            self.tracer._provisional_finished(self)

    def __enter__(self) -> "Span":
        return self

    def __exit__(self, *exc) -> None:
        self.finish()

    def to_dict(self) -> dict:
        return {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            "parent_id": self.parent_id,
            "name": self.name,
            "start": self.start,
            "end": self.end,
            "events": [{"t": t, "name": n} for t, n in self.events],
            "tags": self.tags,
        }


class Tracer:
    """Span factory + in-memory export buffer (tracer.h Tracer::init;
    disabled tracers hand out no-op spans just like the reference's
    null jspan).

    Budgeted sampling: `sample_rate` head-samples NEW roots
    (the client/messenger entry decision, carried on message envelopes
    via TraceContext.sampled so downstream spans honor one decision),
    and `budget_per_sec` is a token bucket charged once per head-sampled
    trace — always-on tracing cannot exceed the retention budget however
    hot the workload.  Head-rejected traces stay PROVISIONAL: their
    spans still collect events (bounded by in-flight work) but only
    reach the export ring if `mark_keep()` fires before they all finish
    — the tail-based always-keep for ops that exceed the OpTracker
    complaint age or error out."""

    # provisional-trace bound: traces whose spans never finish (leaked
    # by a fault path) must not accumulate — evict oldest past this
    MAX_PENDING = 1024

    # NONE-envelope head-decision memo bound (oldest evicted first; a
    # resend arriving after eviction re-rolls, which only risks the
    # decision splitting on traces older than thousands of newer ones)
    MAX_HEAD_MEMO = 4096

    def __init__(
        self,
        service: str = "",
        enabled: bool = True,
        max_spans: int = 10000,
        sample_rate: float = 1.0,
        budget_per_sec: float = 0.0,
    ):
        from collections import OrderedDict, deque

        self.service = service
        self.enabled = enabled
        self.sample_rate = float(sample_rate)
        self.budget_per_sec = float(budget_per_sec)
        self._ids = itertools.count(1)
        # span ids must not collide across the daemons contributing to one
        # trace: offset each tracer's counter by a random 63-bit base (the
        # reference gets uniqueness from otel's random 64-bit span ids)
        self._id_base = random.getrandbits(63) & ~0xFFFFF
        self._lock = make_lock("tracer")
        # ring buffer: the NEWEST max_spans survive — an operator dumping
        # traces to debug a current problem needs recent spans, not the
        # daemon's boot-time history
        self._spans: "deque[Span]" = deque(maxlen=max_spans)
        # token bucket (retention budget): capacity = one second of burst
        self._tokens = self._budget_cap()
        self._tokens_t = time.monotonic()
        # provisional traces: trace_id -> {"spans": [Span], "keep": bool}
        self._pending: dict[int, dict] = {}
        # memoized head decisions for NONE-stamped envelopes: ONE roll
        # per trace, not per message — the objecter re-injects the SAME
        # context on every resend, and re-rolling could split a trace
        # keep/drop and charge the budget once per delivery
        self._head_memo: "OrderedDict[int, bool]" = OrderedDict()
        # sampling counters (exported via sampling_stats -> the scrape)
        self._stats = {
            "sampled": 0,          # head-sampled traces (budget-charged)
            "unsampled": 0,        # head-rejected by sample_rate
            "dropped_budget": 0,   # rate-accepted, bucket empty
            "dropped_tail": 0,     # provisional traces discarded at finish
            "kept_tail": 0,        # provisional traces rescued by mark_keep
            "retained_spans": 0,   # spans committed to the export ring
        }

    # -- sampling --------------------------------------------------------------

    def configure_sampling(
        self,
        sample_rate: float | None = None,
        budget_per_sec: float | None = None,
    ) -> None:
        """Runtime knob application (the OSD config-observer pattern:
        op_trace_sample_rate / op_trace_budget_per_sec)."""
        with self._lock:
            if sample_rate is not None:
                self.sample_rate = float(sample_rate)
            if budget_per_sec is not None:
                prev = self.budget_per_sec
                self.budget_per_sec = float(budget_per_sec)
                if prev <= 0.0:
                    # enabling (or re-enabling) the budget starts with
                    # the documented one-second burst — an empty bucket
                    # would count the first traces dropped_budget
                    self._tokens = self._budget_cap()
                else:
                    # lowering clamps to the new capacity; raising keeps
                    # the current tokens (refill reaches the new cap
                    # within a second anyway)
                    self._tokens = min(self._tokens, self._budget_cap())
                self._tokens_t = time.monotonic()

    def _sampling_active(self) -> bool:
        return self.sample_rate < 1.0 or self.budget_per_sec > 0.0

    def _budget_cap(self) -> float:
        """Bucket capacity: one second of burst, but never less than one
        whole token — a fractional budget (0 < budget < 1/s) must mean
        "one trace every 1/budget seconds", not "no traces ever"."""
        return max(self.budget_per_sec, 1.0)

    def _budget_take(self) -> bool:
        """One token per head-sampled trace; callers hold _lock."""
        if self.budget_per_sec <= 0.0:
            return True
        now = time.monotonic()
        self._tokens = min(
            self._budget_cap(),
            self._tokens + (now - self._tokens_t) * self.budget_per_sec,
        )
        self._tokens_t = now
        if self._tokens >= 1.0:
            self._tokens -= 1.0
            return True
        return False

    def _head_decision(self) -> bool:
        """The once-per-trace head decision (callers hold _lock)."""
        if self.sample_rate < 1.0 and random.random() >= self.sample_rate:
            self._stats["unsampled"] += 1
            return False
        if not self._budget_take():
            self._stats["dropped_budget"] += 1
            return False
        self._stats["sampled"] += 1
        return True

    def mark_keep(self, span: Span | None) -> None:
        """Tail-based always-keep: flag `span`'s trace for retention —
        called when an op exceeds the OpTracker complaint age or errors,
        so slow/broken ops NEVER lose their trace to sampling.  No-op
        for already-retained or unrecorded spans."""
        if span is None or not span.recorded or not span.provisional:
            return
        with self._lock:
            pending = self._pending.get(span.trace_id)
            if pending is not None:
                pending["keep"] = True

    def _provisional_finished(self, span: Span) -> None:
        """A provisional span finished: once EVERY span of its trace has
        finished, commit (keep flagged) or discard the whole set.
        Resolution waits for all spans — an OSD's op span outlives the
        messenger hop span that opened the trace locally."""
        retained: list[Span] = []
        with self._lock:
            pending = self._pending.get(span.trace_id)
            if pending is None:
                return
            if any(s.end is None for s in pending["spans"]):
                return
            del self._pending[span.trace_id]
            if pending["keep"]:
                self._stats["kept_tail"] += 1
                retained = pending["spans"]
                self._stats["retained_spans"] += len(retained)
                for s in retained:
                    s.provisional = False
                    self._spans.append(s)
            else:
                self._stats["dropped_tail"] += 1

    def sampling_stats(self) -> dict:
        """Sampled/kept/dropped counters + live config — the OSD ships
        these in its status blob and (flattened) on MMgrReport so the
        scrape carries ceph_tpu_trace_* families."""
        with self._lock:
            return {
                **self._stats,
                "sample_rate": self.sample_rate,
                "budget_per_sec": self.budget_per_sec,
                "pending_traces": len(self._pending),
            }

    def start_span(
        self,
        name: str,
        parent: Span | None = None,
        remote: TraceContext | None = None,
    ) -> Span:
        """Start a span.  `parent` links within this process; `remote` is
        an extracted cross-daemon context (takes effect only when no local
        parent is given)."""
        # children of unrecorded parents stay unrecorded (no dangling
        # parent_id in the export after a mid-op enable flip)
        record = self.enabled and (parent is None or parent.recorded)
        provisional = False
        if parent is not None:
            trace_id = parent.trace_id
            parent_id = parent.span_id
            provisional = parent.provisional
        elif remote is not None and remote.trace_id:
            trace_id = remote.trace_id
            parent_id = remote.span_id
            # honor the envelope-carried decision: a head-rejected trace
            # stays provisional here too (local tail-keep may rescue
            # it).  NONE means the sender traced without sampling
            # configured — the head decision falls to THIS daemon
            if (
                record
                and remote.sampled == SAMPLED_NONE
                and self._sampling_active()
            ):
                with self._lock:
                    keep = self._head_memo.get(trace_id)
                    if keep is None:
                        keep = self._head_decision()
                        self._head_memo[trace_id] = keep
                        if len(self._head_memo) > self.MAX_HEAD_MEMO:
                            self._head_memo.popitem(last=False)
                    provisional = not keep
            else:
                provisional = record and remote.sampled == SAMPLED_DROP
        else:
            # new root: allocate a trace id only when it can be exported;
            # the head-sampling decision is made HERE, exactly once
            parent_id = None
            trace_id = 0
            if record:
                trace_id = random.getrandbits(63) | 1
                if self._sampling_active():
                    with self._lock:
                        provisional = not self._head_decision()
        span = Span(
            tracer=self,
            span_id=self._id_base + next(self._ids),
            parent_id=parent_id,
            name=name,
            recorded=record,
            provisional=provisional,
            trace_id=trace_id,
        )
        if record:
            with self._lock:
                if provisional:
                    pending = self._pending.get(span.trace_id)
                    if pending is None:
                        if len(self._pending) >= self.MAX_PENDING:
                            # evict the oldest NON-keep trace: under
                            # sustained load the oldest pending traces
                            # are exactly the slowest ops, and a trace
                            # mark_keep already rescued must not be
                            # silently dropped by the memory bound —
                            # when every pending trace is keep-flagged,
                            # commit the evictee instead of dropping it
                            victim_id = next(
                                (
                                    tid
                                    for tid, p in self._pending.items()
                                    if not p["keep"]
                                ),
                                next(iter(self._pending)),
                            )
                            victim = self._pending.pop(victim_id)
                            if victim["keep"]:
                                self._stats["kept_tail"] += 1
                                self._stats["retained_spans"] += len(
                                    victim["spans"]
                                )
                                for s in victim["spans"]:
                                    s.provisional = False
                                    self._spans.append(s)
                            else:
                                self._stats["dropped_tail"] += 1
                        pending = self._pending[span.trace_id] = {
                            "spans": [], "keep": False,
                        }
                    pending["spans"].append(span)
                else:
                    self._spans.append(span)
                    self._stats["retained_spans"] += 1
        return span

    def export(self) -> list[dict]:
        with self._lock:
            return [s.to_dict() for s in self._spans]

    def export_traces(self) -> dict[str, list[dict]]:
        """Spans grouped by trace id, each trace ordered by start time —
        the `dump_tracing` admin-socket payload."""
        traces: dict[str, list[dict]] = {}
        for s in self.export():
            traces.setdefault(str(s["trace_id"]), []).append(s)
        for spans in traces.values():
            spans.sort(key=lambda s: s["start"])
        return traces

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()


NULL_TRACER = Tracer(enabled=False)


def null_span(name: str = "") -> Span:
    return NULL_TRACER.start_span(name)


# -- context propagation helpers ----------------------------------------------

_CURRENT: contextvars.ContextVar[Span | None] = contextvars.ContextVar(
    "ceph_tpu_current_span", default=None
)


def current_span() -> Span | None:
    """The active span in this execution context (if any)."""
    return _CURRENT.get()


@contextlib.contextmanager
def span_scope(span: Span | None):
    """Make `span` the current span for the duration of the block (the
    otel Scope analog).  Does NOT finish the span.  Unrecorded spans are
    fine here: consumers filter on `.recorded` (codec/tracing.active_span)
    or inherit unrecordedness through start_span, so callers need no
    `if span.recorded` guard."""
    token = _CURRENT.set(span)
    try:
        yield span
    finally:
        _CURRENT.reset(token)


def inject(span: Span | None, msg) -> None:
    """Copy a span's context into a message's envelope fields (the
    traceparent header write).  No-op for unrecorded spans, so disabled
    tracers cost two attribute reads.  The head-sampling decision rides
    along (`trace_sampled`): provisional spans mark the envelope DROP so
    downstream daemons buffer instead of retaining."""
    if span is not None and span.recorded:
        msg.trace_id = span.trace_id
        msg.span_id = span.span_id
        if span.provisional:
            msg.trace_sampled = SAMPLED_DROP
        elif span.tracer is not None and span.tracer._sampling_active():
            msg.trace_sampled = SAMPLED_KEEP
        else:
            # no sampling configured here: don't stamp an implicit KEEP
            # (it would bypass the receiver's budget) — let the first
            # sampling-configured daemon downstream decide
            msg.trace_sampled = SAMPLED_NONE


def extract(msg) -> TraceContext | None:
    """Recover the propagated context from a received message (the
    traceparent header read); None when the sender wasn't tracing.
    Envelopes without an explicit sampling decision (pre-sampling
    senders) default to KEEP."""
    trace_id = getattr(msg, "trace_id", 0)
    if not trace_id:
        return None
    return TraceContext(
        trace_id,
        getattr(msg, "span_id", 0),
        getattr(msg, "trace_sampled", 0) or SAMPLED_KEEP,
    )
