"""metrics_history mgr module — the time dimension of the metrics
stack (the insights/healthcheck-history role the reference
keeps in the mgr).

Every tick the module samples the same per-daemon MMgrReport
perf/status snapshots the prometheus module folds, derives rates from
the cumulative counters (restart-safe, like the iostat delta fold), and
appends them into a cardinality-bounded multi-resolution
``common/tsdb.py`` store — per-daemon series plus a cluster aggregate.
On top of the stored history it evaluates **trend sentinels**:

- ``TPU_THROUGHPUT_REGRESSION`` — encode/decode GB/s over the recent
  window falls below ``mgr_trend_regression_ratio`` of its trailing
  baseline while launch volume persists (the device got slower, not
  idler); decode's volume is its own launches' (see below);
- ``TPU_OCCUPANCY_COLLAPSE`` — device occupancy collapses vs its
  baseline under sustained launch volume;
- ``TPU_QUEUE_WAIT_INFLATION`` — mean launch queue-wait inflates past
  ``mgr_trend_queue_wait_factor`` x baseline (the scheduler is backing
  up even though the device keeps launching).

All three raise/clear mgr -> mon exactly like ``PG_RECOVERY_STALLED``:
wording built once in ``common/health.py``, shipped in the PGMap
digest's ``history`` slice, rendered by mon `health`/`status` and the
mgr healthcheck gauge.

Failover warm-start (the SLO burn rate's cold-start rule applied to
trends): a fresh module imports each daemon's boot-to-now cumulative
counters as a first-sight anchor — never a rate sample — and the
sentinels hold fire until a FULL evaluation window (baseline + recent)
of genuinely observed history exists, so a mgr failover can never
alarm on imported totals.

Query surface: mgr asok ``perf history ls`` / ``perf history get``,
the dashboard ``/api/perf_history`` route, and ``ceph_tpu_history_*``
meta-gauges on the scrape (series count, retained points, byte bound,
evictions — the fixed-memory witness).

The port's copy of `ceph_tpu/mgr/metrics_history.py`, with one policy
of its own: decode GB/s is judged only while decode launches persist
(``decode_launches_per_sec``, from ``ec_dispatch.decode_launches``, at
least ``mgr_trend_min_launch_rate`` in both windows and the recent one
at least half the baseline's), where the reference gates it on all
launches.  Degraded reads come in bursts while client encodes keep the
launch rate up, so there a decode burst that ends reads as a decode
regression on a healthy cluster (ROADMAP C37).  The module also keeps
the figures of its last raise transitions (`sentinel_raises`), which
the chaos harness prints when a healthy run fires a sentinel.

Encode follows the same rule (ROADMAP C38).  The reference's
``encode_gbps`` carries every dispatch's bytes: decodes, scrub verifies
and the checksum and compression offload launches included.  So a burst
of large recovery, scrub or offload batches that ends while small client
writes keep the launch rate up reads as an encode regression.  Where a
daemon reports those counters, encode is judged on its own bytes and
launches (``encode_only_gbps`` and ``encode_launches_per_sec``: the
totals less the decode, verify, ``csum`` and ``compress`` ones) by the
same volume rule; a daemon that does not report them is judged by the
reference's rule.
"""

from __future__ import annotations

import time

from ..common import health
from ..common.log import dout
from ..common.tsdb import TimeSeriesStore
from .modules import MgrModule

# raise transitions kept for their figures (`sentinel_raises`)
SENTINEL_RAISES_KEPT = 16

# minimum elapsed seconds between two snapshots of one daemon for a
# rate sample (duplicate same-tick folds are anchor refreshes)
_RATE_MIN_DT = 0.01

# drop a (daemon, counter) rate anchor this long after its daemon last
# reported: the tsdb store LRU-caps its series, but the anchor dict
# would otherwise grow one entry per daemon EVER seen — invisible to
# the very meta-gauges that witness the store's bound.  A pruned
# daemon that returns simply re-anchors first-sight (one lost rate
# sample, never a double-count — rates carry no cumulative totals).
_ANCHOR_PRUNE_SEC = 600.0

# absolute queue-wait floor (ms): inflation below this is noise, not a
# backlog — a 0.02 ms -> 0.1 ms swing must not page anyone
_QUEUE_WAIT_FLOOR_MS = 1.0

# (family, perf counter key) pairs derived as RATES from cumulative
# counters; bytes-based families scale to GB/s
_RATE_FAMILIES = (
    ("encode_gbps", "ec_dispatch.bytes", 1e-9),
    ("decode_gbps", "ec_dispatch.decode_bytes", 1e-9),
    ("launches_per_sec", "ec_dispatch.launches", 1.0),
    ("decode_launches_per_sec", "ec_dispatch.decode_launches", 1.0),
    ("fallback_per_sec", "ec_dispatch.fallback_launches", 1.0),
    ("op_rate", "op", 1.0),
)

# (family, (total counter, counters subtracted from it), scale): a
# coding kind's own rate, sampled only from a daemon that reports every
# counter it needs (C38: encode's own bytes and launches).  The offload
# services' launches are theirs (`ops/offload_runtime.py`: each launch of
# `csum` and `compress` is one dispatch of `launch_bytes` input bytes)
_OWN_RATE_FAMILIES = (
    ("encode_only_gbps",
     ("ec_dispatch.bytes", "ec_dispatch.decode_bytes", "ec_dispatch.verify_bytes",
      "offload.csum.launch_bytes", "offload.compress.launch_bytes"), 1e-9),
    ("encode_launches_per_sec",
     ("ec_dispatch.launches", "ec_dispatch.decode_launches",
      "ec_dispatch.verify_launches", "offload.csum.launches",
      "offload.compress.launches"), 1.0),
)


def _counter_total(value) -> float | None:
    """A counter's cumulative total: a number as it is, a histogram
    (`PerfHistogram.dump()`) by its sum; None for anything else."""
    if isinstance(value, (int, float)):
        return float(value)
    hist = value.get("histogram") if isinstance(value, dict) else None
    if isinstance(hist, dict) and isinstance(hist.get("sum"), (int, float)):
        return float(hist["sum"])
    return None


# (family, perf counter key) level gauges copied as-is
_GAUGE_FAMILIES = (
    ("occupancy", "ec_dispatch.device_occupancy"),
    ("queue_wait_ms", "ec_dispatch.flight_mean_queue_wait_ms"),
)

SENTINEL_CODES = (
    "TPU_THROUGHPUT_REGRESSION",
    "TPU_OCCUPANCY_COLLAPSE",
    "TPU_QUEUE_WAIT_INFLATION",
)


class MetricsHistoryModule(MgrModule):
    NAME = "metrics_history"

    def __init__(
        self,
        max_series: int | None = None,
        ring_slots: int | None = None,
        resolutions: str | None = None,
        window_sec: float | None = None,
        baseline_sec: float | None = None,
        regression_ratio: float | None = None,
        occupancy_ratio: float | None = None,
        queue_wait_factor: float | None = None,
        min_launch_rate: float | None = None,
    ):
        """Explicit constructor values pin the knob (tests, embedded
        harnesses); None tracks the mgr's live config each tick — the
        runtime-mutable pattern the iostat module uses."""
        super().__init__()
        self._pins = {
            "mgr_history_max_series": max_series,
            "mgr_history_ring_slots": ring_slots,
            "mgr_history_resolutions": resolutions,
            "mgr_trend_window_sec": window_sec,
            "mgr_trend_baseline_sec": baseline_sec,
            "mgr_trend_regression_ratio": regression_ratio,
            "mgr_trend_occupancy_ratio": occupancy_ratio,
            "mgr_trend_queue_wait_factor": queue_wait_factor,
            "mgr_trend_min_launch_rate": min_launch_rate,
        }
        from ..common.options import OPTIONS

        self._conf = {
            name: OPTIONS[name].default if pin is None else pin
            for name, pin in self._pins.items()
        }
        self.store = TimeSeriesStore(
            max_series=int(self._conf["mgr_history_max_series"]),
            slots=int(self._conf["mgr_history_ring_slots"]),
            resolutions=str(self._conf["mgr_history_resolutions"]),
        )
        # per-(daemon, counter) previous cumulative value + timestamp
        self._prev: dict[tuple[str, str], tuple[float, float]] = {}
        # first GENUINE (post-import) cluster sample: the sentinel
        # warm-up anchor — baselines seed from the first snapshot and
        # sentinels hold fire until a full evaluation window exists
        self._first_sample_t: float | None = None
        self.sentinels: dict[str, dict] = {}  # currently-raised, by code
        self.sentinels_fired = 0  # raise TRANSITIONS (chaos tracked key)
        # the last SENTINEL_RAISES_KEPT raise transitions: code, seconds
        # since the first sample, and the figures that raised it (the
        # chaos harness names them when a healthy run fires one)
        self.sentinel_raises: list[dict] = []
        self.config_errors = 0  # skipped config reads (visible, not silent)
        # the own-rate families some daemon has reported (C38)
        self._own_seen: set[str] = set()

    # -- config ----------------------------------------------------------------

    def _refresh_config(self) -> None:
        conf = getattr(self.mgr, "conf", None)
        for name, pin in self._pins.items():
            if pin is not None or conf is None:
                continue
            try:
                self._conf[name] = conf.get(name)
            except Exception as e:
                # stripped test configs miss keys — the skip must leave
                # a trace, or a typo'd option name would silently pin
                # the default forever
                self.config_errors += 1
                dout("mgr", 4, f"metrics_history: config read {name!r}: {e!r}")
        self.store.configure(
            max_series=int(self._conf["mgr_history_max_series"]),
            slots=int(self._conf["mgr_history_ring_slots"]),
            resolutions=str(self._conf["mgr_history_resolutions"]),
        )

    # -- sampling --------------------------------------------------------------

    def tick(self) -> None:
        now = time.monotonic()
        self._refresh_config()
        live = getattr(self.mgr, "_daemon_report_live", None)
        # cluster aggregates: rate families sum across daemons; level
        # gauges average across the daemons reporting them
        agg_rates: dict[str, float] = {}
        agg_gauges: dict[str, list[float]] = {}
        slow_total = 0
        any_report = False
        for daemon in self.mgr.list_daemons():
            if live is not None and not live(daemon):
                continue
            perf = self.mgr.get_daemon_perf(daemon) or {}
            status = self.mgr.get_daemon_status(daemon) or {}
            labels = {"daemon": daemon}
            reported = False
            for family, counter, scale in _RATE_FAMILIES:
                value = perf.get(counter)
                if not isinstance(value, (int, float)):
                    continue
                reported = True
                rate = self._counter_rate(daemon, counter, float(value), now)
                if rate is None:
                    continue  # first sight / restart: anchor, no sample
                rate *= scale
                self.store.append(family, labels, now, rate)
                agg_rates[family] = agg_rates.get(family, 0.0) + rate
            for family, counters, scale in _OWN_RATE_FAMILIES:
                values = [_counter_total(perf.get(c)) for c in counters]
                if None in values:
                    continue
                self._own_seen.add(family)
                rate = self._counter_rate(
                    daemon, family, values[0] - sum(values[1:]), now
                )
                if rate is None:
                    continue
                rate *= scale
                self.store.append(family, labels, now, rate)
                agg_rates[family] = agg_rates.get(family, 0.0) + rate
            for family, counter in _GAUGE_FAMILIES:
                value = perf.get(counter)
                if not isinstance(value, (int, float)):
                    continue
                reported = True
                self.store.append(family, labels, now, float(value))
                agg_gauges.setdefault(family, []).append(float(value))
            slow = (status.get("slow_ops") or {}).get("count")
            if isinstance(slow, (int, float)):
                self.store.append("slow_ops", labels, now, float(slow))
                slow_total += int(slow)
                reported = True
            any_report = any_report or reported
        if any_report:
            # cluster series carry NO label values — the telemetry
            # perf-envelope reads only these (privacy contract)
            for family, rate in agg_rates.items():
                self.store.append(family, {}, now, rate)
            for family, values in agg_gauges.items():
                self.store.append(family, {}, now, sum(values) / len(values))
            self.store.append("slow_ops", {}, now, float(slow_total))
            if self._first_sample_t is None and agg_rates:
                # the first RATE sample marks genuine observed history:
                # the import tick itself only anchored counters
                self._first_sample_t = now
        # prune rate anchors of churned daemons (anchors refresh every
        # tick a daemon reports, so a stale timestamp means the daemon
        # is gone — or down long enough that a fresh first-sight anchor
        # on return is the correct, sample-free behavior anyway)
        for key, (t0, _v) in list(self._prev.items()):
            if now - t0 > _ANCHOR_PRUNE_SEC:
                del self._prev[key]
        self._evaluate_sentinels(now)

    def _counter_rate(
        self, daemon: str, counter: str, value: float, now: float
    ) -> float | None:
        """Per-second rate of one cumulative counter vs its previous
        snapshot.  First sight (mgr failover importing boot-to-now
        totals) and counter regressions (daemon restart) re-anchor and
        return None — the trend store must never record hours of
        history as one tick's throughput."""
        key = (daemon, counter)
        prev = self._prev.get(key)
        self._prev[key] = (now, value)
        if prev is None:
            return None
        t0, v0 = prev
        dt = now - t0
        if value < v0 or dt < _RATE_MIN_DT:
            return None
        return (value - v0) / dt

    # -- sentinels -------------------------------------------------------------

    def _windows(self) -> tuple[float, float]:
        # floored only against degenerate (zero/negative) windows —
        # sub-second pins are legitimate for embedded harnesses
        recent = max(float(self._conf["mgr_trend_window_sec"]), 0.05)
        baseline = max(float(self._conf["mgr_trend_baseline_sec"]), recent)
        return recent, baseline

    def _trend(self, family: str, now: float) -> tuple[float | None, float | None]:
        """(recent avg, trailing baseline avg) of one cluster series."""
        recent, baseline = self._windows()
        cur = self.store.window_value(
            family, {}, start_ago=recent, end_ago=0.0, now=now
        )
        base = self.store.window_value(
            family, {}, start_ago=recent + baseline, end_ago=recent, now=now
        )
        return cur, base

    def _evaluate_sentinels(self, now: float) -> None:
        recent, baseline = self._windows()
        if (
            self._first_sample_t is None
            or now - self._first_sample_t < recent + baseline
        ):
            # warm-up: baselines are still seeding from the first
            # genuine snapshot — a sentinel raised off a partial window
            # would be the trend twin of the SLO burn rate's cold-EMA
            # false alarm
            return
        ratio = float(self._conf["mgr_trend_regression_ratio"])
        occ_ratio = float(self._conf["mgr_trend_occupancy_ratio"])
        qw_factor = float(self._conf["mgr_trend_queue_wait_factor"])
        min_launch = float(self._conf["mgr_trend_min_launch_rate"])
        cur_launch, base_launch = self._trend("launches_per_sec", now)

        def persists(cur, base) -> bool:
            return (
                cur is not None
                and base is not None
                and cur >= min_launch
                and base >= min_launch
                and cur >= 0.5 * base
            )

        # "launch volume persists": BOTH windows ran at least
        # min_launch/sec, and the recent one at least half the baseline
        # cadence.  A load drop (fewer launches) is not a regression —
        # the device got idler, not slower — and an IDLE baseline has
        # nothing for the recent window to regress FROM: without the
        # baseline-volume gate, the first busy window after an idle
        # spell would trivially pass `cur >= 0.5 * 0` and every
        # sentinel could fire on a perfectly healthy warm-up.
        volume_ok = persists(cur_launch, base_launch)
        # each kind's own cadence (C37, C38): a decode, or a recovery or
        # scrub burst, that ends is a load drop of that kind even while
        # other launches keep the total up
        own = "encode_launches_per_sec" in self._own_seen
        kind_ok = {
            "encode": (
                persists(*self._trend("encode_launches_per_sec", now))
                if own else True
            ),
            "decode": persists(*self._trend("decode_launches_per_sec", now)),
        }
        gbps_family = {
            "encode": "encode_only_gbps" if own else "encode_gbps",
            "decode": "decode_gbps",
        }
        raised: dict[str, dict] = {}
        if volume_ok:
            regressions = {}
            for kind in ("encode", "decode"):
                if not kind_ok[kind]:
                    continue
                cur, base = self._trend(gbps_family[kind], now)
                if (
                    cur is not None and base is not None and base > 0.0
                    and ratio > 0.0 and cur < ratio * base
                ):
                    regressions[kind] = {
                        "current_gbps": round(cur, 4),
                        "baseline_gbps": round(base, 4),
                        "ratio": round(cur / base, 4),
                        "launches_per_sec": round(cur_launch, 3),
                    }
            if regressions:
                raised["TPU_THROUGHPUT_REGRESSION"] = {
                    "summary": health.throughput_regression_summary(
                        regressions
                    ),
                    "detail": health.throughput_regression_detail(
                        regressions
                    ),
                    "data": regressions,
                }
            cur, base = self._trend("occupancy", now)
            if (
                cur is not None and base is not None and base > 0.01
                and occ_ratio > 0.0 and cur < occ_ratio * base
            ):
                data = {
                    "current": round(cur, 4),
                    "baseline": round(base, 4),
                    "ratio": round(cur / base, 4),
                    "launches_per_sec": round(cur_launch, 3),
                }
                raised["TPU_OCCUPANCY_COLLAPSE"] = {
                    "summary": health.occupancy_collapse_summary(data),
                    "detail": health.occupancy_collapse_detail(data),
                    "data": data,
                }
            cur, base = self._trend("queue_wait_ms", now)
            # the baseline is floored at the absolute noise floor: a
            # near-zero-wait baseline must require cur > factor x floor
            # (not factor x 0.001 ms) before "inflation" means backlog
            # rather than the first real queueing of a busy spell
            base_floored = max(base or 0.0, _QUEUE_WAIT_FLOOR_MS)
            if (
                cur is not None and base is not None
                and qw_factor > 0.0
                and cur > qw_factor * base_floored
            ):
                data = {
                    "current_ms": round(cur, 3),
                    "baseline_ms": round(base, 3),
                    "factor": round(cur / base_floored, 2),
                }
                raised["TPU_QUEUE_WAIT_INFLATION"] = {
                    "summary": health.queue_wait_inflation_summary(data),
                    "detail": health.queue_wait_inflation_detail(data),
                    "data": data,
                }
        for code in SENTINEL_CODES:
            rec = raised.get(code)
            if rec is not None:
                if code not in self.sentinels:
                    self.sentinels_fired += 1
                    self.sentinel_raises.append({
                        "code": code,
                        "at_s": round(now - self._first_sample_t, 3),
                        "data": rec["data"],
                    })
                    del self.sentinel_raises[:-SENTINEL_RAISES_KEPT]
                self.set_health_check(
                    code, "HEALTH_WARN", rec["summary"], rec["detail"]
                )
            else:
                self.clear_health_check(code)
        self.sentinels = raised

    # -- query surface ---------------------------------------------------------

    def history_ls(self) -> dict:
        """`perf history ls`: live series + the store's meta stats."""
        return {"series": self.store.series_ls(), "stats": self.store.stats()}

    def history_get(
        self,
        family: str,
        daemon: str | None = None,
        window: float = 300.0,
        step: float = 0.0,
        aggregate: str = "avg",
    ) -> dict:
        """`perf history get`: one series re-bucketed to `step` with the
        requested aggregate.  `daemon=None` reads the cluster-aggregate
        series."""
        labels = {"daemon": daemon} if daemon else {}
        return self.store.query(
            family,
            labels,
            window=float(window),
            step=float(step),
            aggregate=aggregate,
        )

    def history_digest(self) -> dict:
        """The `history` slice of the mgr's PGMap digest: the raised
        sentinels (summary + detail built by common/health.py, so mon
        `health` renders the identical wording) and the store's
        meta-stats."""
        return {
            "sentinels": {
                code: {
                    "summary": rec["summary"],
                    "detail": rec["detail"],
                    "data": rec["data"],
                }
                for code, rec in self.sentinels.items()
            },
            "sentinels_fired": self.sentinels_fired,
            "stats": self.store.stats(),
        }

    # -- prometheus ------------------------------------------------------------

    def prometheus_metrics(self) -> list[tuple[str, str, str, list[str]]]:
        """Module-metrics hook: the `ceph_tpu_history_*` meta-gauges —
        the fixed-memory witness (series count, retained points, byte
        bound, evictions) plus one always-rendered activity row per
        sentinel code."""
        stats = self.store.stats()
        sentinel_rows = [
            f'ceph_tpu_history_sentinel_active{{sentinel="{code}"}} '
            f"{int(code in self.sentinels)}"
            for code in SENTINEL_CODES
        ]
        return [
            ("ceph_tpu_history_series", "gauge",
             "time-series store: live series count (LRU-capped)",
             [f"ceph_tpu_history_series {stats['series']}"]),
            ("ceph_tpu_history_points", "gauge",
             "time-series store: retained downsample buckets",
             [f"ceph_tpu_history_points {stats['points']}"]),
            ("ceph_tpu_history_bytes", "gauge",
             "time-series store: estimated resident bytes (the fixed "
             "bound the ring geometry enforces)",
             [f"ceph_tpu_history_bytes {stats['bytes']}"]),
            ("ceph_tpu_history_evictions", "counter",
             "time-series store: series evicted by the cardinality cap",
             [f"ceph_tpu_history_evictions {stats['evictions']}"]),
            ("ceph_tpu_history_appends", "counter",
             "time-series store: samples appended",
             [f"ceph_tpu_history_appends {stats['appends']}"]),
            ("ceph_tpu_history_sentinel_active", "gauge",
             "trend sentinels currently raised (1 = raised)",
             sentinel_rows),
            ("ceph_tpu_history_sentinels_fired", "counter",
             "trend-sentinel raise transitions since module start",
             [f"ceph_tpu_history_sentinels_fired {self.sentinels_fired}"]),
        ]
