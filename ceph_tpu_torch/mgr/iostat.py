"""iostat mgr module — workload attribution at the cluster level
(the src/pybind/mgr/iostat analog grown a tenant dimension).

Every OSD's status blob carries the cumulative per-pool / per-client IO
counters its `IOAccountant` (common/io_accounting.py) sampled on the op
reply and recovery paths.  This module merges them across OSDs each
tick:

- **Rates**: per-(pool, op class) IOPS and bytes/sec as EMAs of the
  inter-tick deltas (the mgr/progress.py smoothing shape), restart-safe
  (a daemon whose counters rebased to zero re-anchors instead of
  contributing negative deltas).
- **Windowed p99**: per-pool latency from the merged log2 histograms,
  computed over the last `mgr_iostat_window_sec` of samples — the
  `iostat` number an operator steers by, not a boot-to-now average.
- **Top clients**: the N heaviest (pool, client) pairs by IOPS, bytes,
  or p99 (`mgr_iostat_top_clients` bounds scrape cardinality).
- **SLOs**: per-pool latency targets (`mgr_slo_latency_target_ms`
  default + `mgr_slo_pool_latency_targets` overrides, runtime-mutable)
  evaluated as multi-window burn rates: burn = (fraction of ops over
  target) / (1 - `mgr_slo_objective`).  ``SLO_LATENCY_BREACH``
  (HEALTH_WARN) raises when BOTH the fast and the slow window burn
  above `mgr_slo_burn_threshold` — the fast window confirms the pain is
  current, the slow one that it is not a blip — and clears when either
  recovers.

Surfaces: the mgr asok (`iostat` / `iostat top`), the PGMap digest
(`iostat` + `slo` slices → mon `status` and the mon-side health check),
and the module-metrics hook (`ceph_tpu_pool_*` / `ceph_tpu_top_client_*`
families on the prometheus scrape).

The port's copy of `ceph_tpu/mgr/iostat.py`.
"""

from __future__ import annotations

import time
from collections import deque

from ..common.io_accounting import OP_CLASSES
from ..common.log import dout
from ..common.perf_counters import histogram_sample_lines
from .modules import MgrModule

# EMA weight of the newest inter-tick rate sample (progress.py shape)
_RATE_ALPHA = 0.3
_RATE_MIN_DT = 0.01


def _hist_parts(dump: dict) -> tuple[list, list[int], float, int]:
    """(le bounds, NON-cumulative per-bucket counts, sum, count) from a
    PerfHistogram.dump() payload."""
    h = (dump or {}).get("histogram") or {}
    buckets = h.get("buckets") or []
    les = [le for le, _ in buckets]
    counts: list[int] = []
    prev = 0
    for _le, cum in buckets:
        counts.append(int(cum) - prev)
        prev = int(cum)
    return les, counts, float(h.get("sum", 0.0)), int(h.get("count", 0))


def _p_from_counts(les: list, counts: list[int], q: float) -> float | None:
    """Quantile upper bound from non-cumulative bucket counts; None when
    empty or when the quantile lands in the +Inf overflow bucket."""
    total = sum(counts)
    if not total:
        return None
    want = q * total
    cum = 0
    for le, c in zip(les, counts):
        cum += c
        if cum >= want:
            return None if le == "+Inf" else float(le)
    return None


def _bad_count(les: list, counts: list[int], target_sec: float) -> int:
    """Samples PROVABLY slower than `target_sec`: a log2 bucket counts
    as bad only when its LOWER bound is at or past the target.  The
    bucket straddling the target counts good — log2 buckets cannot
    split, and counting the straddler bad would snap the effective
    target down to the previous power-of-two boundary (up to 2x
    stricter than configured: every 9 ms op "breaching" a 10 ms
    target)."""
    bad = 0
    lower = 0.0
    for le, c in zip(les, counts):
        if lower >= target_sec:
            bad += c
        if le != "+Inf":
            lower = float(le)
    return bad


class _Series:
    """One merged cumulative series (a (pool, class) or (pool, client)
    key): cluster-wide totals + EMA rates + a snapshot ring for
    windowed deltas."""

    __slots__ = (
        "ops", "bytes", "lat_sum", "lat_count", "lat_counts", "les",
        "ops_rate", "bytes_rate", "snaps", "last_seen",
    )

    def __init__(self) -> None:
        self.ops = 0
        self.bytes = 0
        self.lat_sum = 0.0
        self.lat_count = 0
        self.lat_counts: list[int] = []
        self.les: list = []
        self.ops_rate = 0.0
        self.bytes_rate = 0.0
        # (t, ops, bytes, lat_count, tuple(lat_counts)) snapshots for
        # windowed p99 / burn rates; trimmed to the slow SLO window
        self.snaps: deque = deque()
        self.last_seen = 0.0

    def add_delta(
        self, d_ops: int, d_bytes: int, d_counts: list[int],
        d_sum: float, d_count: int, les: list,
    ) -> None:
        self.ops += d_ops
        self.bytes += d_bytes
        self.lat_sum += d_sum
        self.lat_count += d_count
        if les and not self.les:
            self.les = list(les)
            self.lat_counts = [0] * len(les)
        if d_counts and len(d_counts) == len(self.lat_counts):
            for i, c in enumerate(d_counts):
                self.lat_counts[i] += c

    def sample_rates(self, d_ops: int, d_bytes: int, dt: float) -> None:
        if dt < _RATE_MIN_DT:
            return
        for attr, delta in (("ops_rate", d_ops), ("bytes_rate", d_bytes)):
            inst = delta / dt
            prev = getattr(self, attr)
            setattr(
                self, attr,
                inst if prev == 0.0
                else _RATE_ALPHA * inst + (1 - _RATE_ALPHA) * prev,
            )

    def snapshot(self, now: float, keep_sec: float) -> None:
        self.snaps.append(
            (now, self.ops, self.bytes, self.lat_count,
             tuple(self.lat_counts))
        )
        while self.snaps and now - self.snaps[0][0] > keep_sec:
            self.snaps.popleft()

    def window_delta(
        self, now: float, window_sec: float
    ) -> tuple[float, int, int, int, list[int]]:
        """(elapsed, d_ops, d_bytes, d_lat_count, d_lat_counts) vs the
        NEWEST snapshot at or before the window start, so the delta
        always covers at least the window — when snapshots are sparser
        than the window (tick cadence > window), the effective window
        stretches to the snapshot cadence instead of collapsing to the
        zero-delta of the just-taken snapshot.  Before any snapshot has
        aged past the window start (warm-up), the OLDEST snapshot
        anchors the delta: the first fold after a mgr (re)start imports
        each OSD's entire boot-to-now cumulative history in one delta,
        and burning hours of history against a seconds-wide window
        would raise a spurious SLO_LATENCY_BREACH on every failover.
        Activity between series birth and its first snapshot is the
        only blind spot."""
        cutoff = now - window_sec
        base = None
        for snap in self.snaps:  # oldest -> newest
            if snap[0] <= cutoff:
                base = snap
            else:
                break
        if base is None:
            base = self.snaps[0] if self.snaps else (cutoff, 0, 0, 0, ())
        t0, ops0, bytes0, lc0, counts0 = base
        d_counts = [
            c - (counts0[i] if i < len(counts0) else 0)
            for i, c in enumerate(self.lat_counts)
        ]
        return (
            max(now - t0, 0.0), self.ops - ops0, self.bytes - bytes0,
            self.lat_count - lc0, d_counts,
        )


class IostatModule(MgrModule):
    NAME = "iostat"

    # stop rendering a (pool, client) row this long after its last
    # advance (a departed client must not pin scrape cardinality)
    CLIENT_IDLE_EXPIRE_SEC = 600.0

    # drop a _prev delta anchor this long after its key last appeared
    # in a live daemon's blob (see the prune step in tick())
    PREV_PRUNE_SEC = 60.0

    def __init__(
        self,
        window_sec: float | None = None,
        top_n: int | None = None,
        slo_target_ms: float | None = None,
        slo_pool_targets: str | None = None,
        slo_objective: float | None = None,
        slo_burn_threshold: float | None = None,
        slo_fast_window_sec: float | None = None,
        slo_slow_window_sec: float | None = None,
    ):
        """Explicit constructor values pin the knob (tests, embedded
        harnesses); None tracks the mgr's live config each tick — the
        runtime-mutable pattern the progress module uses."""
        super().__init__()
        self._pins = {
            "mgr_iostat_window_sec": window_sec,
            "mgr_iostat_top_clients": top_n,
            "mgr_slo_latency_target_ms": slo_target_ms,
            "mgr_slo_pool_latency_targets": slo_pool_targets,
            "mgr_slo_objective": slo_objective,
            "mgr_slo_burn_threshold": slo_burn_threshold,
            "mgr_slo_fast_window_sec": slo_fast_window_sec,
            "mgr_slo_slow_window_sec": slo_slow_window_sec,
        }
        from ..common.options import OPTIONS

        self._conf = {
            name: OPTIONS[name].default if pin is None else pin
            for name, pin in self._pins.items()
        }
        # (pid, op class) -> _Series ; (pid, client) -> _Series
        self.pools: dict[tuple[str, str], _Series] = {}
        self.clients: dict[tuple[str, str], _Series] = {}
        # per-(daemon, kind, pid, key) previous cumulative blob values
        self._prev: dict[tuple, dict] = {}
        self._last_tick = 0.0
        # pools currently breaching (hysteresis + clear detection)
        self.breaches: dict[str, dict] = {}
        self.config_errors = 0  # skipped config reads (visible, not silent)

    # -- config ----------------------------------------------------------------

    def _refresh_config(self) -> None:
        conf = getattr(self.mgr, "conf", None)
        for name, pin in self._pins.items():
            if pin is not None:
                continue
            if conf is None:
                continue
            try:
                self._conf[name] = conf.get(name)
            except Exception as e:
                # stripped test configs miss keys — but the skip must
                # leave a trace, or a typo'd option name would silently
                # pin the default forever
                self.config_errors += 1
                dout("mgr", 4, f"iostat: config read {name!r}: {e!r}")

    def _pool_names(self) -> dict[str, str]:
        osdmap = getattr(self.mgr, "osdmap", None)
        if osdmap is None:
            return {}
        return {str(p.id): p.name for p in osdmap.pools.values()}

    def slo_target_sec(self, pid: str) -> float:
        """This pool's latency target in SECONDS, honoring per-pool
        overrides matched by id or name; 0 = SLO disabled for it."""
        names = self._pool_names()
        name = names.get(pid, "")
        for entry in str(
            self._conf["mgr_slo_pool_latency_targets"]
        ).split(","):
            key, _, ms = entry.strip().partition(":")
            if not key or not ms:
                continue
            if key == pid or (name and key == name):
                try:
                    return float(ms) / 1e3
                except ValueError:
                    continue
        return float(self._conf["mgr_slo_latency_target_ms"]) / 1e3

    # -- aggregation -----------------------------------------------------------

    def tick(self) -> None:
        now = time.monotonic()
        self._refresh_config()
        keep = max(
            float(self._conf["mgr_slo_slow_window_sec"]),
            float(self._conf["mgr_iostat_window_sec"]),
        ) + 5.0
        dt = now - self._last_tick if self._last_tick else 0.0
        self._last_tick = now
        live = getattr(self.mgr, "_daemon_report_live", None)
        deltas: dict[tuple, list] = {}
        reporting: set[str] = set()
        for daemon in self.mgr.list_daemons():
            if live is not None and not live(daemon):
                continue
            status = self.mgr.get_daemon_status(daemon)
            if status.get("pool_io") or status.get("client_io"):
                reporting.add(daemon)
            for kind, blob_key in (("pool", "pool_io"), ("client", "client_io")):
                blob = status.get(blob_key) or {}
                for pid, entries in blob.items():
                    for key, rec in entries.items():
                        self._fold(deltas, (kind, pid, key), daemon, rec)
        # prune _prev anchors the OSD provably dropped: under client
        # churn (every client restart is a new reqid key) the dict would
        # otherwise grow for the life of the mgr.  A key absent from a
        # LIVE, still-reporting daemon's blob was evicted OSD-side
        # (folded into _other — its old cumulative totals can never be
        # reported again), so its anchor is dead weight after a grace
        # period.  Down daemons keep their anchors: a partition heal
        # resumes deltas against them, where a pruned anchor would
        # re-import boot-to-now history as one double-counting delta.
        for pkey, rec in list(self._prev.items()):
            if (
                pkey[0] in reporting
                and now - rec.get("t", now) > self.PREV_PRUNE_SEC
            ):
                del self._prev[pkey]
        for (kind, pid, key), d in deltas.items():
            table = self.pools if kind == "pool" else self.clients
            series = table.get((pid, key))
            d_ops, d_bytes, d_counts, d_sum, d_count, les, imported = d
            if series is None:
                # the OSDs keep reporting expired clients' (unchanged)
                # cumulative records forever; a zero delta must not
                # resurrect the series as a permanent zero row.  A
                # returning client restarts its mgr-side totals from the
                # moment it reappears — the expiry semantics ("who is
                # driving load NOW") apply to totals too.
                if not (d_ops or d_bytes or d_count):
                    continue
                series = table[(pid, key)] = _Series()
            series.add_delta(d_ops, d_bytes, d_counts, d_sum, d_count, les)
            if d_ops or d_bytes:
                series.last_seen = now
            # a first-sight fold imported a daemon's boot-to-now
            # cumulative history as one delta — totals want it, but
            # feeding it to the EMA would report hours of ops as one
            # tick's IOPS after a mgr failover (the window-delta warm-up
            # anchor already shields the SLO/p99 path; this shields the
            # rate path).  Rates resume from the next genuine delta.
            if not imported:
                series.sample_rates(d_ops, d_bytes, dt)
        for table in (self.pools, self.clients):
            for series in table.values():
                series.snapshot(now, keep)
        # idle clients expire so the top-N views and the scrape reflect
        # who is driving load NOW
        for key, series in list(self.clients.items()):
            if series.last_seen and now - series.last_seen > self.CLIENT_IDLE_EXPIRE_SEC:
                del self.clients[key]
        self._evaluate_slo(now)

    def _fold(self, deltas: dict, key: tuple, daemon: str, rec: dict) -> None:
        """Delta one daemon's cumulative record against its previous
        report; counter regressions (daemon restart) re-anchor."""
        les, counts, lat_sum, lat_count = _hist_parts(rec.get("lat"))
        cur = {
            "ops": int(rec.get("ops", 0)),
            "bytes": int(rec.get("bytes", 0)),
            "sum": lat_sum,
            "count": lat_count,
            "counts": counts,
            "t": self._last_tick,  # prune clock (refreshed every fold)
        }
        pkey = (daemon,) + key
        prev = self._prev.get(pkey)
        self._prev[pkey] = cur
        if (
            prev is None
            or cur["ops"] < prev["ops"]
            or cur["count"] < prev["count"]
            or len(prev["counts"]) != len(counts)
        ):
            # first sight or restart: the whole cumulative value is the
            # delta (first sight) / re-anchor without contribution
            # (restart would double-count the pre-restart history)
            if prev is not None:
                return
            prev = {"ops": 0, "bytes": 0, "sum": 0.0, "count": 0,
                    "counts": [0] * len(counts)}
            first_sight = True
        else:
            first_sight = False
        d = deltas.setdefault(
            key, [0, 0, [0] * len(counts), 0.0, 0, les, False]
        )
        if first_sight:
            d[6] = True
        d[0] += cur["ops"] - prev["ops"]
        d[1] += max(cur["bytes"] - prev["bytes"], 0)
        for i, c in enumerate(counts):
            if i < len(d[2]):
                d[2][i] += c - prev["counts"][i]
        d[3] += cur["sum"] - prev["sum"]
        d[4] += cur["count"] - prev["count"]
        if les and not d[5]:
            d[5] = les

    # -- SLO evaluation --------------------------------------------------------

    def _burn_rate(
        self, pid: str, now: float, window_sec: float, target_sec: float
    ) -> float:
        """Burn rate for one pool over one window: bad-op fraction
        across the client-visible classes (read + write; recovery is
        the cluster's own traffic) over the error budget."""
        budget = max(1.0 - float(self._conf["mgr_slo_objective"]), 1e-9)
        bad = total = 0
        for cls in ("read", "write"):
            series = self.pools.get((pid, cls))
            if series is None:
                continue
            _dt, _do, _db, d_count, d_counts = series.window_delta(
                now, window_sec
            )
            total += d_count
            bad += _bad_count(series.les, d_counts, target_sec)
        if total <= 0:
            return 0.0
        return (bad / total) / budget

    def _evaluate_slo(self, now: float) -> None:
        threshold = float(self._conf["mgr_slo_burn_threshold"])
        fast_w = float(self._conf["mgr_slo_fast_window_sec"])
        slow_w = float(self._conf["mgr_slo_slow_window_sec"])
        names = self._pool_names()
        breaches: dict[str, dict] = {}
        for pid in sorted({p for p, _c in self.pools}):
            target = self.slo_target_sec(pid)
            if target <= 0.0:
                continue
            fast = self._burn_rate(pid, now, fast_w, target)
            slow = self._burn_rate(pid, now, slow_w, target)
            if fast > threshold and slow > threshold:
                breaches[pid] = {
                    "pool": names.get(pid, pid),
                    "target_ms": round(target * 1e3, 3),
                    "burn_fast": round(fast, 3),
                    "burn_slow": round(slow, 3),
                    "p99_ms": self._pool_p99_ms(pid, now),
                }
        self.breaches = breaches
        if breaches:
            from ..common import health

            self.set_health_check(
                "SLO_LATENCY_BREACH",
                "HEALTH_WARN",
                health.slo_breach_summary(breaches) or "",
                health.slo_breach_detail(breaches),
            )
        else:
            self.clear_health_check("SLO_LATENCY_BREACH")

    def worst_burn_rate(self, window: str = "slow") -> float:
        """Max burn rate across SLO-enabled pools (chaos/bench tracked
        key `slo_worst_burn_rate`); 0.0 when no pool has a target."""
        now = time.monotonic()
        w = float(
            self._conf[
                "mgr_slo_fast_window_sec" if window == "fast"
                else "mgr_slo_slow_window_sec"
            ]
        )
        worst = 0.0
        for pid in {p for p, _c in self.pools}:
            target = self.slo_target_sec(pid)
            if target > 0.0:
                worst = max(worst, self._burn_rate(pid, now, w, target))
        return worst

    # -- rendered views --------------------------------------------------------

    def _pool_p99_ms(self, pid: str, now: float) -> float | None:
        """Windowed p99 across read+write, in ms (None = no samples in
        the window, or the tail overflowed the histogram range)."""
        window = float(self._conf["mgr_iostat_window_sec"])
        les: list = []
        merged: list[int] = []
        for cls in ("read", "write"):
            series = self.pools.get((pid, cls))
            if series is None:
                continue
            _dt, _do, _db, _dc, d_counts = series.window_delta(now, window)
            if not les:
                les = series.les
                merged = list(d_counts)
            elif len(d_counts) == len(merged):
                merged = [a + b for a, b in zip(merged, d_counts)]
        p99 = _p_from_counts(les, merged, 0.99)
        return None if p99 is None else round(p99 * 1e3, 3)

    def iostat(self) -> dict[str, dict]:
        """The per-pool `iostat` view: rates per class, windowed p99,
        cumulative totals — the mgr asok payload, the mon `status`
        slice, and what the acceptance test reconciles against the
        OSD-side counters."""
        now = time.monotonic()
        names = self._pool_names()
        out: dict[str, dict] = {}
        for (pid, cls), series in sorted(self.pools.items()):
            rec = out.get(pid)
            if rec is None:
                # computed once per pool, not per (pool, class) row —
                # the window merge is the expensive part of this view
                rec = out[pid] = {
                    "pool": names.get(pid, pid),
                    "p99_ms": self._pool_p99_ms(pid, now),
                    "ops_total": 0,
                    "bytes_total": 0,
                }
            rec[f"{cls}_ops_per_sec"] = round(series.ops_rate, 3)
            rec[f"{cls}_bytes_per_sec"] = round(series.bytes_rate, 1)
            rec[f"{cls}_ops"] = series.ops
            rec[f"{cls}_bytes"] = series.bytes
            rec["ops_total"] += series.ops
            rec["bytes_total"] += series.bytes
        return out

    def top_clients(
        self, n: int | None = None, by: str = "ops_rate"
    ) -> list[dict]:
        """Top-N (pool, client) rows by `ops_rate` (IOPS), `bytes_rate`,
        or `p99` — who is driving the load."""
        n = int(self._conf["mgr_iostat_top_clients"]) if n is None else n
        window = float(self._conf["mgr_iostat_window_sec"])
        now = time.monotonic()
        names = self._pool_names()
        rows = []
        for (pid, client), series in self.clients.items():
            # windowed p99, like the pool view: the lifetime cumulative
            # histogram would rank by stale history — a startup blip
            # (or a failover's boot-to-now import) keeping a busy
            # client "slowest" forever is not "who is slow NOW"
            _dt, _do, _db, _dc, d_counts = series.window_delta(
                now, window
            )
            p99 = _p_from_counts(series.les, d_counts, 0.99)
            # p99 is None for BOTH "no samples" and "quantile in the
            # +Inf overflow bucket"; for ranking, an overflowed client
            # is the SLOWEST (worse than any finite bound), not 0
            p99_rank = (
                p99 if p99 is not None
                else float("inf") if sum(d_counts) else 0.0
            )
            rows.append(
                (
                    p99_rank,
                    {
                        "pool_id": pid,
                        "pool": names.get(pid, pid),
                        "client": client,
                        "ops_per_sec": round(series.ops_rate, 3),
                        "bytes_per_sec": round(series.bytes_rate, 1),
                        "p99_ms": None if p99 is None
                        else round(p99 * 1e3, 3),
                        "ops": series.ops,
                        "bytes": series.bytes,
                    },
                )
            )
        key = {
            "ops_rate": lambda pr: pr[1]["ops_per_sec"],
            "bytes_rate": lambda pr: pr[1]["bytes_per_sec"],
            "p99": lambda pr: pr[0],
        }.get(by) or (lambda pr: pr[1]["ops_per_sec"])
        rows.sort(key=key, reverse=True)
        return [r for _rank, r in rows[: max(n, 0)]]

    def iostat_digest(self) -> dict:
        """The `iostat` slice of the mgr's PGMap digest: per-pool rates
        + top clients, what mon `status` renders."""
        return {
            "pools": self.iostat(),
            "top_clients": self.top_clients(),
        }

    def slo_digest(self) -> dict:
        """The `slo` digest slice the mon-side SLO_LATENCY_BREACH check
        reads (raise/clear like PG_RECOVERY_STALLED)."""
        return {
            "breaches": self.breaches,
            "worst_burn_rate": round(self.worst_burn_rate("slow"), 3),
            "worst_burn_rate_fast": round(self.worst_burn_rate("fast"), 3),
        }

    # -- prometheus ------------------------------------------------------------

    def prometheus_metrics(self) -> list[tuple[str, str, str, list[str]]]:
        """Module-metrics hook: the canonical workload-attribution
        families.  Cumulative ops/bytes are counters; rates, p99 and
        burn gauges rise and fall.  Families render even when empty so
        the scrape's family set is stable from the first tick."""
        now = time.monotonic()
        ops_rows: list[str] = []
        bytes_rows: list[str] = []
        lat_rows: list[str] = []
        rate_rows: list[str] = []
        brate_rows: list[str] = []
        p99_rows: list[str] = []
        for (pid, cls), series in sorted(self.pools.items()):
            labels = f'pool="{pid}",op="{cls}"'
            ops_rows.append(f"ceph_tpu_pool_ops{{{labels}}} {series.ops}")
            bytes_rows.append(
                f"ceph_tpu_pool_bytes{{{labels}}} {series.bytes}"
            )
            rate_rows.append(
                f"ceph_tpu_pool_ops_rate{{{labels}}} "
                f"{series.ops_rate:.3f}"
            )
            brate_rows.append(
                f"ceph_tpu_pool_bytes_rate{{{labels}}} "
                f"{series.bytes_rate:.1f}"
            )
            if series.les:
                cum = 0
                buckets = []
                for le, c in zip(series.les, series.lat_counts):
                    cum += c
                    buckets.append([le, cum])
                lat_rows.extend(
                    histogram_sample_lines(
                        "ceph_tpu_pool_latency_seconds",
                        {
                            "buckets": buckets,
                            "sum": series.lat_sum,
                            "count": series.lat_count,
                        },
                        labels,
                    )
                )
        for pid in sorted({p for p, _c in self.pools}):
            p99 = self._pool_p99_ms(pid, now)
            if p99 is not None:
                p99_rows.append(
                    f'ceph_tpu_pool_p99_latency_seconds{{pool="{pid}"}} '
                    f"{p99 / 1e3:.6f}"
                )
        burn_rows: list[str] = []
        target_rows: list[str] = []
        for pid in sorted({p for p, _c in self.pools}):
            target = self.slo_target_sec(pid)
            if target <= 0.0:
                continue
            target_rows.append(
                f'ceph_tpu_pool_slo_target_seconds{{pool="{pid}"}} '
                f"{target:.6f}"
            )
            for window, w in (
                ("fast", float(self._conf["mgr_slo_fast_window_sec"])),
                ("slow", float(self._conf["mgr_slo_slow_window_sec"])),
            ):
                burn_rows.append(
                    f"ceph_tpu_pool_slo_burn_rate"
                    f'{{pool="{pid}",window="{window}"}} '
                    f"{self._burn_rate(pid, now, w, target):.3f}"
                )
        top_ops: list[str] = []
        top_bytes: list[str] = []
        for row in self.top_clients():
            labels = f'pool="{row["pool_id"]}",client="{row["client"]}"'
            top_ops.append(
                f"ceph_tpu_top_client_ops_rate{{{labels}}} "
                f'{row["ops_per_sec"]:.3f}'
            )
            top_bytes.append(
                f"ceph_tpu_top_client_bytes_rate{{{labels}}} "
                f'{row["bytes_per_sec"]:.1f}'
            )
        return [
            ("ceph_tpu_pool_ops", "counter",
             "per-pool ops by op class (read/write/recovery)", ops_rows),
            ("ceph_tpu_pool_bytes", "counter",
             "per-pool bytes by op class", bytes_rows),
            ("ceph_tpu_pool_latency_seconds", "histogram",
             "per-pool op latency by op class (merged log2 histogram)",
             lat_rows),
            ("ceph_tpu_pool_ops_rate", "gauge",
             "per-pool smoothed IOPS by op class", rate_rows),
            ("ceph_tpu_pool_bytes_rate", "gauge",
             "per-pool smoothed bytes/sec by op class", brate_rows),
            ("ceph_tpu_pool_p99_latency_seconds", "gauge",
             "per-pool windowed p99 op latency", p99_rows),
            ("ceph_tpu_pool_slo_target_seconds", "gauge",
             "per-pool latency SLO target", target_rows),
            ("ceph_tpu_pool_slo_burn_rate", "gauge",
             "per-pool SLO burn rate by window (fast/slow)", burn_rows),
            ("ceph_tpu_top_client_ops_rate", "gauge",
             "top-N clients by smoothed IOPS", top_ops),
            ("ceph_tpu_top_client_bytes_rate", "gauge",
             "top-N clients by smoothed bytes/sec", top_bytes),
        ]
