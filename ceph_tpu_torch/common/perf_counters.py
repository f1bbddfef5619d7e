"""Performance counters — mirror of src/common/perf_counters.h.

The port's copy of `ceph_tpu/common/perf_counters.py`.

Reference: src/common/perf_counters.h:63 (PerfCounters: a
contiguous block of typed counters built by PerfCountersBuilder between a
lower/upper bound enum; types u64 counter, u64 gauge, time, and averages
(sum+count pairs)), and PerfCountersCollection aggregating every logger in
the process for `perf dump` on the admin socket.  The mgr scrapes these
(DaemonServer.cc) — here the prometheus-style text export lives on the
collection too.
"""

from __future__ import annotations

from dataclasses import dataclass

from .lockdep import make_lock


PERFCOUNTER_U64 = 1
PERFCOUNTER_TIME = 2
PERFCOUNTER_LONGRUNAVG = 4
PERFCOUNTER_COUNTER = 8  # monotonic (vs gauge)
PERFCOUNTER_HISTOGRAM = 16  # PerfHistogram axes (perf_histogram.h)


class PerfHistogramAxis:
    """One log2-scaled axis (perf_histogram.h axis_config_d with
    SCALE_LOG2): bucket i covers (bounds[i-1], bounds[i]], where
    bounds[i] = lowest * 2^i; the last bucket is the +Inf overflow."""

    def __init__(self, lowest: float, buckets: int):
        if buckets < 2:
            raise ValueError("histogram needs >= 2 buckets")
        self.lowest = lowest
        self.buckets = buckets
        # finite upper bounds; the final bucket is implicit +Inf
        self.bounds: list[float] = [
            lowest * (1 << i) for i in range(buckets - 1)
        ]

    def index(self, value: float) -> int:
        lo, hi = 0, len(self.bounds)
        while lo < hi:
            mid = (lo + hi) // 2
            if value <= self.bounds[mid]:
                hi = mid
            else:
                lo = mid + 1
        return lo  # == len(bounds) -> overflow bucket


class PerfHistogram:
    """1D log2-bucketed histogram (PerfHistogram<1>): per-bucket counts
    plus sum/count so the export satisfies the Prometheus histogram
    contract (_bucket/_sum/_count)."""

    def __init__(self, axis: PerfHistogramAxis):
        self.axis = axis
        self.counts = [0] * axis.buckets
        self.sum = 0.0
        self.count = 0

    def sample(self, value: float) -> None:
        self.counts[self.axis.index(value)] += 1
        self.sum += value
        self.count += 1

    def dump(self) -> dict:
        """JSON-safe cumulative bucket form: [[le, cumulative], ...] with
        the literal string "+Inf" as the final bound."""
        cum = 0
        buckets: list[list] = []
        for i, c in enumerate(self.counts):
            cum += c
            le = self.axis.bounds[i] if i < len(self.axis.bounds) else "+Inf"
            buckets.append([le, cum])
        return {
            "histogram": {
                "buckets": buckets,
                "sum": self.sum,
                "count": self.count,
            }
        }


class PerfHistogram2D:
    """2D histogram (PerfHistogram<2>, e.g. the reference's
    op_w_latency_in_bytes_histogram): counts over size x latency so tail
    latency can be attributed to op size, not just averaged away."""

    def __init__(self, x_axis: PerfHistogramAxis, y_axis: PerfHistogramAxis):
        self.x_axis = x_axis
        self.y_axis = y_axis
        self.counts = [[0] * y_axis.buckets for _ in range(x_axis.buckets)]
        self.count = 0

    def sample(self, x: float, y: float) -> None:
        self.counts[self.x_axis.index(x)][self.y_axis.index(y)] += 1
        self.count += 1

    def dump(self) -> dict:
        return {
            "histogram2d": {
                "x_le": list(self.x_axis.bounds) + ["+Inf"],
                "y_le": list(self.y_axis.bounds) + ["+Inf"],
                "counts": [list(row) for row in self.counts],
                "count": self.count,
            }
        }


def histogram_sample_lines(metric: str, h: dict, labels: str = "") -> list[str]:
    """Prometheus histogram samples for a PerfHistogram.dump() payload:
    cumulative `_bucket{le=...}` ending at +Inf, then `_sum`/`_count`.
    `labels` is a pre-rendered `k="v"` list WITHOUT braces ('' for none).
    Shared by every exporter so the exposition shape cannot diverge."""
    sep = "," if labels else ""
    lines = [
        f'{metric}_bucket{{{labels}{sep}le="{le}"}} {cum}'
        for le, cum in h["buckets"]
    ]
    suffix = f"{{{labels}}}" if labels else ""
    lines.append(f"{metric}_sum{suffix} {h['sum']}")
    lines.append(f"{metric}_count{suffix} {h['count']}")
    return lines


@dataclass
class _Counter:
    name: str
    type: int
    desc: str = ""
    value: float = 0.0
    avgcount: int = 0
    hist: object = None  # PerfHistogram | PerfHistogram2D


class PerfCounters:
    """One subsystem's counter block (perf_counters.h:63)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = make_lock("perf_counters")
        self._counters: dict[str, _Counter] = {}

    # -- updates (perf_counters.h inc/dec/set/tinc) --------------------------

    def inc(self, name: str, amount: float = 1) -> None:
        with self._lock:
            self._counters[name].value += amount

    def dec(self, name: str, amount: float = 1) -> None:
        with self._lock:
            self._counters[name].value -= amount

    def set(self, name: str, value: float) -> None:
        with self._lock:
            self._counters[name].value = value

    def tinc(self, name: str, seconds: float) -> None:
        """Accumulate elapsed time; avg counters also count samples."""
        with self._lock:
            c = self._counters[name]
            c.value += seconds
            c.avgcount += 1

    def hinc(self, name: str, value: float) -> None:
        """Sample a 1D histogram counter (PerfCounters::hinc)."""
        with self._lock:
            self._counters[name].hist.sample(value)

    def hinc2(self, name: str, x: float, y: float) -> None:
        """Sample a 2D histogram counter."""
        with self._lock:
            self._counters[name].hist.sample(x, y)

    def ensure_histogram(
        self,
        name: str,
        desc: str = "",
        lowest: float = 1e-6,
        buckets: int = 25,
    ) -> None:
        """Lazily declare a 1D log2 histogram OUTSIDE the builder —
        for per-peer families whose membership is unknown at daemon
        construction (the osd_heartbeat_rtt_osd_<N> family).
        Idempotent; an existing counter of any type is left alone."""
        with self._lock:
            if name in self._counters:
                return
            self._counters[name] = _Counter(
                name,
                PERFCOUNTER_TIME | PERFCOUNTER_HISTOGRAM,
                desc,
                hist=PerfHistogram(PerfHistogramAxis(lowest, buckets)),
            )

    def get(self, name: str) -> float:
        with self._lock:
            return self._counters[name].value

    def avgcount(self, name: str) -> int:
        with self._lock:
            return self._counters[name].avgcount

    # -- dump ----------------------------------------------------------------

    def dump(self) -> dict[str, object]:
        with self._lock:
            out: dict[str, object] = {}
            for c in self._counters.values():
                if c.type & PERFCOUNTER_HISTOGRAM:
                    out[c.name] = c.hist.dump()
                elif c.type & PERFCOUNTER_LONGRUNAVG:
                    out[c.name] = {"avgcount": c.avgcount, "sum": c.value}
                else:
                    out[c.name] = c.value
            return out

    def dump_histograms(self) -> dict[str, object]:
        """Only the histogram counters (`perf histogram dump` /
        `dump_histograms` admin-socket payload)."""
        with self._lock:
            return {
                c.name: c.hist.dump()
                for c in self._counters.values()
                if c.type & PERFCOUNTER_HISTOGRAM
            }


class PerfCountersBuilder:
    """Declarative construction (perf_counters.h PerfCountersBuilder)."""

    def __init__(self, name: str):
        self._pc = PerfCounters(name)

    def add_u64_counter(self, name: str, desc: str = "") -> "PerfCountersBuilder":
        self._pc._counters[name] = _Counter(name, PERFCOUNTER_U64 | PERFCOUNTER_COUNTER, desc)
        return self

    def add_u64(self, name: str, desc: str = "") -> "PerfCountersBuilder":
        self._pc._counters[name] = _Counter(name, PERFCOUNTER_U64, desc)
        return self

    def add_time_avg(self, name: str, desc: str = "") -> "PerfCountersBuilder":
        self._pc._counters[name] = _Counter(
            name, PERFCOUNTER_TIME | PERFCOUNTER_LONGRUNAVG, desc
        )
        return self

    def add_histogram(
        self,
        name: str,
        desc: str = "",
        lowest: float = 1e-6,
        buckets: int = 25,
    ) -> "PerfCountersBuilder":
        """1D log2 histogram; the default axis covers 1 µs .. ~8.4 s of
        latency before the +Inf overflow bucket."""
        self._pc._counters[name] = _Counter(
            name,
            PERFCOUNTER_TIME | PERFCOUNTER_HISTOGRAM,
            desc,
            hist=PerfHistogram(PerfHistogramAxis(lowest, buckets)),
        )
        return self

    def add_histogram_2d(
        self,
        name: str,
        desc: str = "",
        x_lowest: float = 4096,
        x_buckets: int = 12,
        y_lowest: float = 1e-6,
        y_buckets: int = 25,
    ) -> "PerfCountersBuilder":
        """2D log2 histogram; defaults to size (4 KiB .. 8 MiB) x latency
        (1 µs .. ~8.4 s) — the op_w_latency_in_bytes_histogram shape."""
        self._pc._counters[name] = _Counter(
            name,
            PERFCOUNTER_U64 | PERFCOUNTER_HISTOGRAM,
            desc,
            hist=PerfHistogram2D(
                PerfHistogramAxis(x_lowest, x_buckets),
                PerfHistogramAxis(y_lowest, y_buckets),
            ),
        )
        return self

    def create_perf_counters(self) -> PerfCounters:
        return self._pc


class PerfCountersCollection:
    """Process-wide registry behind `perf dump` (perf_counters.h
    PerfCountersCollection; surfaced via the admin socket)."""

    def __init__(self) -> None:
        self._lock = make_lock("perf_counters_collection")
        self._loggers: dict[str, PerfCounters] = {}

    def add(self, pc: PerfCounters) -> None:
        with self._lock:
            self._loggers[pc.name] = pc

    def remove(self, name: str) -> None:
        with self._lock:
            self._loggers.pop(name, None)

    def dump(self) -> dict[str, dict[str, object]]:
        with self._lock:
            return {name: pc.dump() for name, pc in self._loggers.items()}

    def prometheus_text(self) -> str:
        """Prometheus exposition format — the mgr prometheus-module /
        ceph-exporter analog (src/exporter/, src/pybind/mgr/prometheus)."""
        def sanitize(name: str) -> str:
            return name.replace(".", "_").replace("-", "_")

        lines: list[str] = []
        for logger, counters in sorted(self.dump().items()):
            for cname, val in sorted(counters.items()):
                metric = f"ceph_tpu_{sanitize(logger)}_{sanitize(cname)}"
                if isinstance(val, dict) and "histogram" in val:
                    lines.append(f"# HELP {metric} perf histogram {cname}")
                    lines.append(f"# TYPE {metric} histogram")
                    lines.extend(
                        histogram_sample_lines(metric, val["histogram"])
                    )
                elif isinstance(val, dict) and "histogram2d" in val:
                    continue  # 2D grids have no prometheus family shape
                elif isinstance(val, dict):
                    lines.append(f"{metric}_sum {val['sum']}")
                    lines.append(f"{metric}_count {val['avgcount']}")
                else:
                    lines.append(f"{metric} {val}")
        return "\n".join(lines) + "\n"
