"""In-memory time-series store — the mgr-resident history substrate
(the prometheus-module + healthcheck-history role the
reference keeps in the mgr).

Every observability layer so far answers "what is happening now"; this
store answers "what changed, and when" with three design constraints:

- **Fixed memory.**  Each series holds one bounded ring per resolution
  level: raw samples land in the finest ring and are simultaneously
  folded into coarser min/max/avg/last buckets (classic RRD/whisper
  downsampling), so retention scales with bucket width while footprint
  stays `levels x slots` buckets per series, forever.
- **Bounded cardinality.**  Series are keyed by family + labels with an
  LRU cap: when a new series would exceed `max_series`, the
  least-recently-written series is evicted (counted) — churned daemons
  and departed clients age out the way the iostat module expires idle
  clients, instead of growing the mgr without bound.
- **Lock-cheap.**  One lockdep-named mutex; appends touch O(levels)
  bucket tails, queries copy only the requested window.

The store itself is clock-agnostic: callers pass timestamps (the
metrics-history module feeds `time.monotonic()`), which also keeps the
downsample math deterministic under test.

The port's copy of `ceph_tpu/common/tsdb.py`.
"""

from __future__ import annotations

from collections import OrderedDict, deque

from .lockdep import make_lock

# accounting estimate per retained bucket: 5 floats + tuple/deque
# overhead.  An estimate (not sys.getsizeof truth) so the bytes gauge is
# deterministic and cheap; the BOUND it witnesses is exact — buckets per
# series are structurally capped.
BYTES_PER_BUCKET = 120
BYTES_PER_SERIES = 256  # key + rings + bookkeeping overhead

AGGREGATES = ("avg", "min", "max", "last", "sum")


class _Bucket:
    """One downsample bucket: [start, start + width) of one series."""

    __slots__ = ("start", "vmin", "vmax", "vsum", "count", "last")

    def __init__(self, start: float, value: float):
        self.start = start
        self.vmin = value
        self.vmax = value
        self.vsum = value
        self.count = 1
        self.last = value

    def fold(self, value: float) -> None:
        if value < self.vmin:
            self.vmin = value
        if value > self.vmax:
            self.vmax = value
        self.vsum += value
        self.count += 1
        self.last = value

    def value(self, aggregate: str) -> float:
        if aggregate == "min":
            return self.vmin
        if aggregate == "max":
            return self.vmax
        if aggregate == "last":
            return self.last
        if aggregate == "sum":
            return self.vsum
        return self.vsum / self.count  # avg

    def dump(self) -> dict:
        return {
            "t": self.start,
            "min": self.vmin,
            "max": self.vmax,
            "avg": self.vsum / self.count,
            "last": self.last,
            "count": self.count,
        }


class _Series:
    """One (family, labels) series: a bounded ring per resolution."""

    __slots__ = ("rings", "last_t", "appends")

    def __init__(self, levels: int, slots: int):
        self.rings: list[deque] = [
            deque(maxlen=slots) for _ in range(levels)
        ]
        self.last_t = 0.0
        self.appends = 0

    def append(self, t: float, value: float, widths: tuple) -> None:
        # a clock-skewed out-of-order sample must not REWIND the
        # series' newest-sample anchor: default-anchored queries
        # (now=None) would shift into the past and drop genuinely
        # newer buckets from the view
        self.last_t = max(self.last_t, t)
        self.appends += 1
        for ring, width in zip(self.rings, widths):
            start = (t // width) * width
            tail = ring[-1] if ring else None
            if tail is not None and tail.start == start:
                tail.fold(value)
            elif tail is not None and start < tail.start:
                # out-of-order sample (a clock-skewed report): fold into
                # the tail rather than corrupting ring ordering
                tail.fold(value)
            else:
                ring.append(_Bucket(start, value))

    def buckets(self) -> int:
        return sum(len(r) for r in self.rings)


def _labels_key(labels: dict | None) -> tuple:
    return tuple(sorted((str(k), str(v)) for k, v in (labels or {}).items()))


class TimeSeriesStore:
    """Cardinality-bounded multi-resolution store (see module doc)."""

    def __init__(
        self,
        max_series: int = 256,
        slots: int = 360,
        resolutions: tuple[float, ...] = (1.0, 10.0, 60.0),
    ):
        self._lock = make_lock("tsdb")
        self._series: OrderedDict[tuple, _Series] = OrderedDict()
        self._max_series = max(1, int(max_series))
        self._slots = max(2, int(slots))
        self._resolutions = self._parse_resolutions(resolutions)
        self.evictions = 0
        self.appends = 0

    @staticmethod
    def _parse_resolutions(resolutions) -> tuple[float, ...]:
        if isinstance(resolutions, str):
            parts = [p.strip() for p in resolutions.split(",") if p.strip()]
            resolutions = tuple(float(p) for p in parts)
        widths = tuple(sorted(float(w) for w in resolutions if float(w) > 0))
        return widths or (1.0,)

    # -- configuration (runtime-mutable knobs) --------------------------------

    def configure(
        self,
        max_series: int | None = None,
        slots: int | None = None,
        resolutions=None,
    ) -> None:
        """Apply runtime knob changes.  Shrinking `max_series` evicts
        LRU immediately; changing slot count / resolutions rebuilds the
        rings empty (history restarts at the new geometry — the same
        newest-kept contract the flight recorder uses, but a geometry
        change invalidates the downsample alignment entirely)."""
        with self._lock:
            if max_series is not None and int(max_series) > 0:
                self._max_series = int(max_series)
                while len(self._series) > self._max_series:
                    self._series.popitem(last=False)
                    self.evictions += 1
            rebuild = False
            if slots is not None and int(slots) >= 2 and \
                    int(slots) != self._slots:
                self._slots = int(slots)
                rebuild = True
            if resolutions is not None:
                widths = self._parse_resolutions(resolutions)
                if widths != self._resolutions:
                    self._resolutions = widths
                    rebuild = True
            if rebuild:
                self._series.clear()

    @property
    def resolutions(self) -> tuple[float, ...]:
        return self._resolutions

    # -- writes ---------------------------------------------------------------

    def append(
        self, family: str, labels: dict | None, t: float, value: float
    ) -> None:
        key = (family, _labels_key(labels))
        with self._lock:
            series = self._series.get(key)
            if series is None:
                series = self._series[key] = _Series(
                    len(self._resolutions), self._slots
                )
            # LRU order = write recency: churned daemons/clients stop
            # writing and drift to the evictable end
            self._series.move_to_end(key)
            series.append(t, float(value), self._resolutions)
            self.appends += 1
            while len(self._series) > self._max_series:
                self._series.popitem(last=False)
                self.evictions += 1

    # -- queries --------------------------------------------------------------

    def series_ls(self) -> list[dict]:
        """One row per live series: identity + retention shape (the
        `perf history ls` payload)."""
        with self._lock:
            out = []
            for (family, lkey), series in self._series.items():
                # retention is the COARSEST ring's reach: once the fine
                # ring wraps, hours of downsampled history remain
                # queryable — the inventory must not understate it
                oldest = [r[0].start for r in series.rings if r]
                out.append({
                    "family": family,
                    "labels": dict(lkey),
                    "appends": series.appends,
                    "buckets": series.buckets(),
                    "newest_t": series.last_t,
                    "oldest_t": min(oldest) if oldest else None,
                })
            return out

    def _find(self, family: str, labels: dict | None) -> _Series | None:
        return self._series.get((family, _labels_key(labels)))

    def _choose_level(self, series: _Series, start: float) -> int:
        """Finest resolution whose OLDEST retained bucket reaches back
        to `start`.  When no level covers (the window outruns even the
        coarsest retention — OR the series is younger than the window,
        in which case every level holds the same since-birth span), the
        finest ring that retains the series' full observed history
        wins: maximum detail, never an artificially coarse view of a
        young series."""
        fine = series.rings[0]
        birth_covered = bool(fine) and len(fine) < (fine.maxlen or 1)
        for i, ring in enumerate(series.rings):
            if ring and (ring[0].start <= start or (birth_covered and i == 0)):
                return i
        return len(self._resolutions) - 1

    def query(
        self,
        family: str,
        labels: dict | None = None,
        window: float = 300.0,
        step: float = 0.0,
        aggregate: str = "avg",
        now: float | None = None,
    ) -> dict:
        """Re-bucketed view of one series over the trailing `window`
        seconds: picks the finest resolution whose retention covers the
        window, then folds those buckets into `step`-wide output points
        with the requested aggregate (`avg`/`min`/`max`/`last`/`sum`).
        `step` <= 0 returns the chosen resolution's buckets as-is."""
        if aggregate not in AGGREGATES:
            raise ValueError(
                f"aggregate must be one of {AGGREGATES}, got {aggregate!r}"
            )
        with self._lock:
            series = self._find(family, labels)
            if series is None:
                return {
                    "family": family,
                    "labels": dict(labels or {}),
                    "resolution": None,
                    "points": [],
                }
            end = series.last_t if now is None else now
            start = end - max(window, 0.0)
            chosen = self._choose_level(series, start)
            width = self._resolutions[chosen]
            buckets = [
                b for b in series.rings[chosen]
                if b.start + width > start and b.start <= end
            ]
            points: list[list[float]]
            if step and step > 0:
                # structural merge of the source buckets (min/max/
                # sum/count/last compose exactly), so a re-bucketed avg
                # is the true sample-weighted average — never an
                # avg-of-avgs skewed by uneven bucket fill
                folded: OrderedDict[float, _Bucket] = OrderedDict()
                for b in buckets:
                    s = (b.start // step) * step
                    f = folded.get(s)
                    if f is None:
                        f = folded[s] = _Bucket(s, b.last)
                        f.vmin, f.vmax = b.vmin, b.vmax
                        f.vsum, f.count = b.vsum, b.count
                    else:
                        f.vmin = min(f.vmin, b.vmin)
                        f.vmax = max(f.vmax, b.vmax)
                        f.vsum += b.vsum
                        f.count += b.count
                        f.last = b.last
                points = [
                    [s, f.value(aggregate)] for s, f in folded.items()
                ]
            else:
                points = [[b.start, b.value(aggregate)] for b in buckets]
            return {
                "family": family,
                "labels": dict(labels or {}),
                "resolution": width,
                "step": step or width,
                "aggregate": aggregate,
                "points": points,
            }

    def window_value(
        self,
        family: str,
        labels: dict | None,
        start_ago: float,
        end_ago: float,
        aggregate: str = "avg",
        now: float | None = None,
    ) -> float | None:
        """One aggregate over [now - start_ago, now - end_ago) — what
        the trend sentinels compare (recent window vs trailing
        baseline).  None when the series has no bucket in the span."""
        with self._lock:
            series = self._find(family, labels)
            if series is None:
                return None
            end_t = series.last_t if now is None else now
            lo = end_t - start_ago
            hi = end_t - end_ago
            chosen = self._choose_level(series, lo)
            width = self._resolutions[chosen]
            hit = [
                b for b in series.rings[chosen]
                if b.start + width > lo and b.start < hi
            ]
            if not hit:
                return None
            if aggregate == "min":
                return min(b.vmin for b in hit)
            if aggregate == "max":
                return max(b.vmax for b in hit)
            if aggregate == "last":
                return hit[-1].last
            if aggregate == "sum":
                return sum(b.vsum for b in hit)
            return sum(b.vsum for b in hit) / sum(b.count for b in hit)

    # -- accounting -----------------------------------------------------------

    def stats(self) -> dict:
        """The meta-gauges (`ceph_tpu_history_*`): series count, total
        retained buckets, the byte estimate of the bound, eviction and
        append totals."""
        with self._lock:
            buckets = sum(s.buckets() for s in self._series.values())
            return {
                "series": len(self._series),
                "max_series": self._max_series,
                "points": buckets,
                "bytes": (
                    len(self._series) * BYTES_PER_SERIES
                    + buckets * BYTES_PER_BUCKET
                ),
                "evictions": self.evictions,
                "appends": self.appends,
            }
