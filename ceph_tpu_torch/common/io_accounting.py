"""Per-pool / per-client IO accounting — the OSD half of workload
attribution.

The reference attributes load through pg_stat_t / osd_stat_t and the mgr
`iostat` module; here one `IOAccountant` per OSD accumulates, for every
completed op, per-pool ops/bytes counters and log2 latency
`PerfHistogram`s split by op class (``read`` / ``write`` /
``recovery``), plus a bounded per-(pool, client) slice for
top-N-client views.  Everything is CUMULATIVE — the mgr's iostat module
(mgr/iostat.py) diffs successive status blobs into windowed rates, so a
restart (counters rebase to zero) is detected as a negative delta and
re-anchored rather than reported as negative IOPS.

The accountant ships in the OSD status blob (``pool_io`` /
``client_io``), which keeps the wire shape JSON-safe: histograms ride as
their standard cumulative ``PerfHistogram.dump()`` payload, which merges
across OSDs (and diffs across time) by plain per-bucket arithmetic.
"""

from __future__ import annotations

import threading
import time

from .lockdep import make_lock
from .perf_counters import PerfHistogram, PerfHistogramAxis

OP_CLASSES = ("read", "write", "recovery")

# latency axis shared by every accounting histogram: 1 µs .. ~8.4 s
# before +Inf, the op_latency shape (perf_counters.py defaults)
_LAT_LOWEST = 1e-6
_LAT_BUCKETS = 25

# per-pool client-slice bound: clients beyond this fold into a single
# overflow entry so one OSD tracking a million-client fleet stays O(1)
# per pool in memory (the mgr ranks top-N anyway — the tail is noise)
OTHER_CLIENT = "_other"


def _new_hist() -> PerfHistogram:
    return PerfHistogram(PerfHistogramAxis(_LAT_LOWEST, _LAT_BUCKETS))


class _ClassIO:
    __slots__ = ("ops", "bytes", "lat", "last")

    def __init__(self) -> None:
        self.ops = 0
        self.bytes = 0
        self.lat = _new_hist()
        self.last = 0.0  # monotonic time of the last account()

    def account(
        self, nbytes: int, latency: float | None, now: float = 0.0
    ) -> None:
        self.ops += 1
        self.bytes += int(nbytes)
        self.last = now
        if latency is not None:
            self.lat.sample(latency)

    def fold(self, other: "_ClassIO") -> None:
        """Absorb another record (same axis) — the overflow-bucket merge
        when an idle client is evicted from the tracked slice."""
        self.ops += other.ops
        self.bytes += other.bytes
        for i, c in enumerate(other.lat.counts):
            self.lat.counts[i] += c
        self.lat.sum += other.lat.sum
        self.lat.count += other.lat.count
        self.last = max(self.last, other.last)

    def dump(self) -> dict:
        return {"ops": self.ops, "bytes": self.bytes, "lat": self.lat.dump()}


class IOAccountant:
    """Cumulative per-pool (by op class) + per-(pool, client) IO
    counters for one OSD (thread-safe; sampled from the op reply path
    and the recovery push path)."""

    # a tracked client idle this long may be evicted (folded into
    # _other) to admit a new one — without this, 64 short-lived clients
    # (reqid names embed a per-process nonce, so every client restart is
    # a new key) would permanently saturate the slice and attribute ALL
    # subsequent load to _other
    IDLE_EVICT_SEC = 60.0

    def __init__(self, max_clients_per_pool: int = 64):
        self._lock = make_lock("io_accountant")
        self.max_clients_per_pool = int(max_clients_per_pool)
        # pool id -> op class -> _ClassIO
        self._pools: dict[int, dict[str, _ClassIO]] = {}
        # pool id -> client -> _ClassIO (class-agnostic: the per-client
        # question is "who", the per-class split already answers "what")
        self._clients: dict[int, dict[str, _ClassIO]] = {}

    def account(
        self,
        pool_id: int,
        client: str,
        op_class: str,
        nbytes: int,
        latency: float | None = None,
    ) -> None:
        if op_class not in OP_CLASSES:
            op_class = "read"
        now = time.monotonic()
        with self._lock:
            pool = self._pools.setdefault(int(pool_id), {})
            cls = pool.get(op_class)
            if cls is None:
                cls = pool[op_class] = _ClassIO()
            cls.account(nbytes, latency, now)
            if not client:
                return
            clients = self._clients.setdefault(int(pool_id), {})
            rec = clients.get(client)
            if rec is None:
                if len(clients) >= self.max_clients_per_pool:
                    # full slice: evict the least-recently-active
                    # tracked client into _other IF it has gone idle —
                    # active clients are never displaced, so a burst of
                    # new keys can't churn the slice, but departed
                    # clients don't pin it forever either
                    victim = min(
                        (k for k in clients if k != OTHER_CLIENT),
                        key=lambda k: clients[k].last,
                        default=None,
                    )
                    if (
                        victim is not None
                        and now - clients[victim].last >= self.IDLE_EVICT_SEC
                    ):
                        other = clients.get(OTHER_CLIENT)
                        if other is None:
                            other = clients[OTHER_CLIENT] = _ClassIO()
                        other.fold(clients.pop(victim))
                    else:
                        client = OTHER_CLIENT
                        rec = clients.get(client)
                if rec is None:
                    rec = clients[client] = _ClassIO()
            rec.account(nbytes, latency, now)

    # -- dumps (the OSD status blob slices) ----------------------------------

    def dump_pools(self) -> dict[str, dict]:
        """{"<pool id>": {"read"|"write"|"recovery": {ops, bytes, lat}}}
        — JSON-string pool keys so the blob survives json round-trips
        the same way the pool_stored/pool_bytes slices do."""
        with self._lock:
            return {
                str(pid): {cls: io.dump() for cls, io in classes.items()}
                for pid, classes in self._pools.items()
            }

    def dump_clients(self) -> dict[str, dict]:
        """{"<pool id>": {"<client>": {ops, bytes, lat}}}."""
        with self._lock:
            return {
                str(pid): {c: io.dump() for c, io in clients.items()}
                for pid, clients in self._clients.items()
            }

    def totals(self) -> dict[str, int]:
        """Cluster-reconciliation totals: overall ops/bytes across every
        pool and class (what an OSD's op counters must agree with)."""
        with self._lock:
            ops = sum(
                io.ops for p in self._pools.values() for io in p.values()
            )
            nbytes = sum(
                io.bytes for p in self._pools.values() for io in p.values()
            )
        return {"ops": ops, "bytes": nbytes}
