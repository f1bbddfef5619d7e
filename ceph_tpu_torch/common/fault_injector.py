"""Fault injection — mirror of src/common/fault_injector.h.

The port's copy of `ceph_tpu/common/fault_injector.py`.

Reference: src/common/fault_injector.h:57 (FaultInjector<T>:
named injection points that can be armed to fail with an errno or abort)
plus the messenger's probabilistic injections
(`ms_inject_socket_failures`, global.yaml.in:1240) and
`heartbeat_inject_failure` (:865).  Used by tests to drive the EIO /
corruption / connection-loss paths the qa suites exercise
(qa/standalone/erasure-code/test-erasure-eio.sh).
"""

from __future__ import annotations

import random

from .lockdep import make_lock


class InjectedFailure(Exception):
    def __init__(self, point: str, err: int):
        self.point = point
        self.errno = -abs(err)
        super().__init__(f"injected failure at {point} (errno {self.errno})")


class FaultInjector:
    """Named injection points, armed per-point with an errno and an
    optional remaining-hits budget."""

    def __init__(self) -> None:
        self._lock = make_lock("fault_injector")
        self._points: dict[str, tuple[int, int]] = {}  # name -> (errno, hits)
        self._probabilistic: dict[str, float] = {}  # name -> probability
        # delay_ms latency mode: name -> (delay_ms, hits, who).
        # A delayed point is slow, not failed — the gray-failure shape.
        # `who` scopes the delay to one caller identity ("osd.3"): the
        # injector is process-global, but a GRAY failure is one slow
        # daemon among healthy ones, so the harness must be able to
        # slow a single victim ("" = every caller, the legacy shape)
        self._delays: dict[str, tuple[float, int, str]] = {}
        self._rng = random.Random(0xEC)

    def inject(self, point: str, err: int, hits: int = -1) -> None:
        """Arm: next `hits` checks at `point` raise (hits<0 = forever)."""
        with self._lock:
            self._points[point] = (err, hits)

    def inject_probabilistic(self, point: str, one_in: int) -> None:
        """1-in-N failure chance (ms_inject_socket_failures semantics)."""
        with self._lock:
            if one_in <= 0:
                self._probabilistic.pop(point, None)
            else:
                self._probabilistic[point] = 1.0 / one_in

    def inject_delay(
        self, point: str, delay_ms: float, hits: int = -1, who: str = ""
    ) -> None:
        """Arm a LATENCY fault: the next `hits` checks at `point` report
        a pending delay of `delay_ms` (hits<0 = forever, <= 0 ms clears).
        Unlike `inject`, the seam stays functionally correct — callers
        apply the delay async-safely (sleep / call_later), never raise.
        `who` restricts the delay to one caller identity (e.g. "osd.3"):
        with daemons sharing one process-global injector, this is how a
        harness slows a single gray victim while its peers stay fast."""
        with self._lock:
            if delay_ms <= 0:
                self._delays.pop(point, None)
            else:
                self._delays[point] = (delay_ms, hits, who)

    def check_delay(self, point: str, who: str = "") -> float:
        """Pending injected delay in SECONDS for one pass through `point`
        (0.0 = none).  Decrements the hit budget like `check`.  A delay
        armed with a `who` scope only fires (and only spends hits) for
        the matching caller identity."""
        with self._lock:
            armed = self._delays.get(point)
            if armed is None:
                return 0.0
            delay_ms, hits, scope = armed
            if scope and scope != who:
                return 0.0
            if hits > 0:
                hits -= 1
                if hits == 0:
                    del self._delays[point]
                else:
                    self._delays[point] = (delay_ms, hits, scope)
            return delay_ms / 1000.0

    def clear(self, point: str | None = None) -> None:
        with self._lock:
            if point is None:
                self._points.clear()
                self._probabilistic.clear()
                self._delays.clear()
            else:
                self._points.pop(point, None)
                self._probabilistic.pop(point, None)
                self._delays.pop(point, None)

    def check(self, point: str) -> None:
        """Call at the injection point; raises InjectedFailure if armed."""
        with self._lock:
            armed = self._points.get(point)
            if armed is not None:
                err, hits = armed
                if hits > 0:
                    hits -= 1
                    if hits == 0:
                        del self._points[point]
                    else:
                        self._points[point] = (err, hits)
                raise InjectedFailure(point, err)
            p = self._probabilistic.get(point)
            if p is not None and self._rng.random() < p:
                raise InjectedFailure(point, 5)  # EIO

    def armed(self, point: str) -> bool:
        with self._lock:
            return (
                point in self._points
                or point in self._probabilistic
                or point in self._delays
            )


# The injection-point catalog: every name wired through `faultpoint()`
# in the port MUST be registered here, so a hook can never be armed
# under a typo'd name that silently never fires.  The port wires the
# device launch, the object store's media-error seams, the EC shard
# sub-read (its EIO mode; the delay mode comes with hedged reads), the
# recovery push and the PG's peering-message receive; the JAX package's
# other points come with the modules that check them.
FAULT_POINTS: dict[str, str] = {
    "codec.launch": (
        "device coding-launch submit in LaunchAggregator._launch: the "
        "device dispatch fails and the group re-runs on the byte-"
        "identical host oracle, marking the backend DEGRADED"
    ),
    "os.read": (
        "objectstore read() data path (memstore + bluestore; stat/attr "
        "lookups stay clean): raises StoreError(EIO), the "
        "test-erasure-eio.sh disk-error analog"
    ),
    "os.write": (
        "objectstore queue_transaction (every backend, checked before "
        "any op is applied or staged): raises StoreError(EIO), failing "
        "the transaction whole — per-op injection would tear it, since "
        "apply does not roll back"
    ),
    "ec.sub_read": (
        "EC shard-side sub-read in ECBackend.handle_sub_read: the shard "
        "answers with a per-object EIO, driving redundant-read "
        "escalation and reconstruction on the primary.  In delay_ms "
        "mode the shard answers CORRECTLY but late (the reply is "
        "deferred on the event loop, never blocking it) — the gray "
        "failure that drives adaptive hedged reads"
    ),
    "ec.recover_push": (
        "EC recovery push receive in ECBackend.handle_recovery_push: "
        "the target drops the PushOp on the floor, exactly as a dying "
        "target would — the primary's stalled-push retry "
        "(retry_stalled_pushes, osd_recovery_push_retry_sec) re-sends "
        "the pending shards so a wedged push cannot stall a "
        "recovery-storm wave forever"
    ),
    "peering.msg": (
        "peering message receive in PG.handle_peering_message: the "
        "query/notify/log message is dropped before the state machine "
        "sees it, wedging peering mid-storm; the tick-driven re-kick "
        "(PeeringState.tick restarts a primary stuck in GetInfo/GetLog) "
        "re-queries and self-heals"
    ),
}


# Process-wide injector used by daemons when none is passed explicitly.
_global = FaultInjector()


def global_injector() -> FaultInjector:
    return _global


def faultpoint(point: str) -> None:
    """Check a REGISTERED injection point on the process-global injector.

    The one spelling every wired seam uses (and the one the lint greps
    for): an unregistered name is a programming error, raised eagerly so
    a typo cannot create a hook that never fires."""
    if point not in FAULT_POINTS:
        raise ValueError(f"unregistered fault point {point!r}")
    _global.check(point)


def faultpoint_delay(point: str, who: str = "") -> float:
    """Pending injected delay (seconds) for a REGISTERED point on the
    process-global injector — the latency twin of `faultpoint()`.  The
    caller owns applying it async-safely (`await asyncio.sleep(d)` on
    the messenger path, `loop.call_later(d, ...)` around a synchronous
    reply) so an injected delay can never block the event loop.  `who`
    is the caller's daemon identity ("osd.3"); a delay armed with a
    scope only fires for the matching caller."""
    if point not in FAULT_POINTS:
        raise ValueError(f"unregistered fault point {point!r}")
    return _global.check_delay(point, who)
