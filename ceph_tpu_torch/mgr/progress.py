"""progress mgr module — mirror of src/pybind/mgr/progress.

The reference module turns long-running background work (recovery,
backfill, rebalance) into progress bars with completion estimates
(`ceph progress` / the `ceph -s` progress block).  Same here, fed from
the OSD status blobs: every primary reports per-PG
recovery/backfill/scrub events (objects/bytes done vs total,
PG.progress_status), and this module

- tracks each (pgid, kind) event across reports: completion fraction,
  an exponentially-smoothed objects/sec rate, and an ETA derived from
  the remaining work at that rate;
- aggregates a cluster-wide bar (total done / total objects across all
  active events);
- raises ``PG_RECOVERY_STALLED`` (HEALTH_WARN) when a recovery or
  backfill event reports no advance — objects, bytes, or newly
  discovered work — for ``mgr_progress_stall_sec``; the check clears on
  the next observed advance or when the event completes;
- exports prometheus gauges through the module-metrics hook
  (``ceph_tpu_progress_fraction`` / ``ceph_tpu_progress_rate_objects``
  / ``ceph_tpu_progress_eta_seconds``) and ships the rendered summary
  into the mgr's PGMap digest so `ceph_cli status` shows the bars.

The port's copy of `ceph_tpu/mgr/progress.py`.  Where it differs: a
tick that runs late (the event loop was held) credits the time lost to
every event's stall and expiry clocks (ROADMAP C23); and the mgr hands
every daemon report to `on_report`, so a completion reported between two
ticks (a PG's final done == total reports, a daemon's final storm bar)
is counted completed, not expired (C24).
"""

from __future__ import annotations

import time

from ..common.log import dout
from .modules import MgrModule

# rate smoothing: EMA weight of the newest inter-report sample.  High
# enough to react to a recovery speeding up, low enough that one bursty
# report doesn't swing the ETA wildly.
_RATE_ALPHA = 0.3
# minimum elapsed seconds between reports for a rate sample (duplicate
# same-tick reports are baseline updates, never samples)
_RATE_MIN_DT = 0.01

# how long regressing same-total reports are treated as failover-stale
# blobs before they are accepted as a genuinely new episode.  Stale
# overlap lasts ~one status heartbeat (the demoted primary's next
# report drops the event); a new episode persists far longer.
_REGRESS_WINDOW = 2.5


class _Event:
    """One tracked (pgid, kind) progress event."""

    __slots__ = (
        "pgid", "kind", "started", "last_change", "done", "total",
        "bytes_done", "rate", "last_seen", "_observed", "_regress_since",
        "_last_done_change",
    )

    def __init__(self, pgid: str, kind: str, now: float):
        self.pgid = pgid
        self.kind = kind
        self.started = now
        self.last_change = now  # last observed ADVANCE (stall anchor)
        self._last_done_change = now  # last OBJECTS advance (rate clock)
        self.done = 0
        self.total = 0
        self.bytes_done = 0
        self.rate = 0.0  # objects/sec, EMA
        self.last_seen = now  # last report carrying this event
        self._observed = False  # first report seeds counts, not a rate
        self._regress_since: float | None = None  # regressing-report clock

    def observe(self, ev: dict, now: float) -> None:
        done = int(ev.get("objects_done", 0))
        total = int(ev.get("objects_total", 0))
        bytes_done = int(ev.get("bytes_done", 0))
        if self._observed and done < self.done:
            if total == self.total:
                # a regressing report with the SAME total is (briefly)
                # a stale blob from the event's previous reporter —
                # primary failover overlap lasts ~one heartbeat.
                # Accepting it would lower the baseline and let the
                # next fresh report register a fake advance, masking
                # PG_RECOVERY_STALLED.  But a regression that PERSISTS
                # past the window is a genuinely new episode that
                # happens to reuse the total (rapid flap) — dropping it
                # forever would freeze the bar and raise a FALSE stall.
                if self._regress_since is None:
                    self._regress_since = now
                    return
                if now - self._regress_since < _REGRESS_WINDOW:
                    return
            # new episode on this key (different total, or a persistent
            # same-total regression): rebase everything — the old rate
            # and start time belong to another episode
            self.done = done
            self.total = max(total, done)
            self.bytes_done = bytes_done
            self.rate = 0.0
            self.started = now
            self.last_change = now
            self._last_done_change = now
            self.last_seen = now
            self._regress_since = None
            return
        self._regress_since = None
        # bytes/total baselines are MONOTONE within an episode: a stale
        # blob with equal done but lower bytes/total (failover overlap)
        # must not lower them, or the next fresh-but-unchanged report
        # would register a fake advance and re-arm the stall clock.
        # The one allowed shrink: a completion report (done == total)
        # collapses the high-water total down to done so the event can
        # classify as completed at expiry.
        if self._observed and total == done and done >= self.done:
            total = max(done, self.done)
        else:
            total = max(total, self.total)
        bytes_done = max(bytes_done, self.bytes_done)
        advanced = (
            done > self.done
            or bytes_done > self.bytes_done
            or total > self.total  # new work discovered still means alive
        )
        # a rate sample needs two reports AND real elapsed time: the
        # first report only seeds the baseline, and a duplicate report
        # in the same tick (a stale blob from the old primary next to
        # the new primary's fresh one) has dt ~ 0 — dividing by it
        # would explode the EMA to millions of objects/sec and poison
        # the ETA for many ticks.  The sample divides by the time since
        # the last ADVANCE, not the last report: a recovery advancing
        # one object per 10 heartbeats must sample 0.1 obj/s, not the
        # 1 obj/s a per-report dt would fabricate.
        dt = now - self.last_seen
        if self._observed and done > self.done and dt >= _RATE_MIN_DT:
            # the dt guard filters duplicate reports; the divisor is
            # time since the last OBJECTS advance specifically — the
            # stall anchor (last_change) also resets on bytes/total
            # advances, and dividing by that would overstate objects/sec
            # whenever bytes trickle between object completions
            sample = (done - self.done) / max(
                _RATE_MIN_DT, now - self._last_done_change
            )
            self.rate = (
                sample
                if self.rate == 0.0
                else _RATE_ALPHA * sample + (1 - _RATE_ALPHA) * self.rate
            )
        if done > self.done:
            self._last_done_change = now
        if advanced:
            self.last_change = now
        self.done = done
        self.total = max(total, done)
        self.bytes_done = bytes_done
        self.last_seen = now
        self._observed = True

    def fraction(self) -> float:
        if self.total <= 0:
            return 0.0
        return min(1.0, self.done / self.total)

    def eta_seconds(self) -> float | None:
        """Remaining objects over the smoothed rate; None until a rate
        exists (no ETA beats a bogus one)."""
        if self.rate <= 0.0:
            return None
        return max(0.0, (self.total - self.done) / self.rate)

    def render(self, now: float, stall_sec: float) -> dict:
        # a stalled event renders NO rate/ETA: the EMA's last positive
        # value next to stalled=true would be contradictory operator
        # output (a finite ETA for work that is not advancing)
        stalled = self.is_stalled(now, stall_sec)
        eta = None if stalled else self.eta_seconds()
        return {
            "pgid": self.pgid,
            "kind": self.kind,
            "objects_done": self.done,
            "objects_total": self.total,
            "bytes_done": self.bytes_done,
            "fraction": round(self.fraction(), 4),
            "rate_objects_per_sec": 0.0 if stalled else round(self.rate, 3),
            "eta_seconds": None if eta is None else round(eta, 1),
            "elapsed_seconds": round(now - self.started, 1),
            "stalled": stalled,
        }

    def is_stalled(self, now: float, stall_sec: float) -> bool:
        """Recovery/backfill that stopped advancing for the window.
        Scrubs are excluded: a chunk blocked behind client writes is
        throttling, not a stuck PG."""
        if stall_sec <= 0 or self.kind not in ("recovery", "backfill"):
            return False
        return now - self.last_change >= stall_sec

    def key(self) -> tuple[str, str]:
        return (self.pgid, self.kind)


def _storm_key(storm: dict) -> str:
    victims = storm.get("victims") or []
    return "+".join(victims) if victims else "cluster"


class ProgressModule(MgrModule):
    NAME = "progress"

    # events missing from this many seconds of reports are complete
    # (the OSD stops reporting an event when the work finishes)
    EVENT_EXPIRE_SEC = 5.0
    # the port's (ROADMAP C23): the mgr's module loop ticks every
    # TICK_SEC; a tick later than that by more than LATE_SEC found the
    # loop held, and the time lost counts toward no event's stall or
    # expiry (the reports that would have advanced it were held too)
    TICK_SEC = 1.0
    LATE_SEC = 0.5

    def __init__(self, stall_sec: float | None = None):
        super().__init__()
        # an explicit constructor value pins the window (tests, embedded
        # harnesses); otherwise it tracks the mgr's live config
        self._stall_pinned = stall_sec is not None
        if stall_sec is None:
            from ..common.options import OPTIONS

            stall_sec = float(OPTIONS["mgr_progress_stall_sec"].default)
        self.stall_sec = float(stall_sec)
        self.events: dict[tuple[str, str], _Event] = {}
        # whole-OSD rebuild bars: one _Event per victim set,
        # aggregated each tick from the daemons' recovery_storm status
        # slices (every surviving primary contributes its share of the
        # failed OSD's rebuild; the sum is the whole-OSD bar)
        self.storms: dict[str, _Event] = {}
        self.completed = 0  # events that ran to completion (gauge)
        self.expired = 0    # events dropped mid-flight (reporter died)
        self.config_errors = 0  # skipped config reads (visible, not silent)
        self.lost_sec = 0.0  # time late ticks lost, credited to the events
        self._last_tick: float | None = None
        # the port's (C24): each daemon's last final storm bar (done ==
        # total), seen by `on_report`, summed at a tick until observed
        self._storm_final: dict[str, dict] = {}

    # -- aggregation -----------------------------------------------------------

    def _refresh_config(self) -> None:
        """mgr_progress_stall_sec is runtime-mutable: re-read it from
        the mgr's Config each tick so `config set` takes effect without
        a module reload."""
        if self._stall_pinned:
            return
        conf = getattr(self.mgr, "conf", None)
        if conf is None:
            return
        try:
            self.stall_sec = float(conf.get("mgr_progress_stall_sec"))
        except Exception as e:
            # stripped test configs miss the key — trace the skip so a
            # typo'd option can't silently pin the default
            self.config_errors += 1
            dout("mgr", 4, f"progress: config read failed: {e!r}")

    def _credit_lost_time(self, now: float) -> None:
        """A late tick: move every event's stall and expiry anchors on by
        the time the loop was held, so the module judges a recovery by
        the time it could watch it (the port's, C23)."""
        last, self._last_tick = self._last_tick, now
        if last is None:
            return
        lost = now - last - self.TICK_SEC
        if lost <= self.LATE_SEC:
            return
        self.lost_sec += lost
        for ev in (*self.events.values(), *self.storms.values()):
            ev.last_change += lost
            ev.last_seen += lost

    def on_report(self, daemon: str, status: dict, now: float) -> None:
        """Every daemon report, as the mgr receives it (the port's, C24):
        a PG's final done == total report and a daemon's final storm bar
        last three heartbeats, which may fall between two ticks; a
        completion seen here is not lost."""
        for pgid, events in (status.get("progress") or {}).items():
            for ev in events:
                total = int(ev.get("objects_total", 0))
                if not total or int(ev.get("objects_done", 0)) < total:
                    continue
                key = (pgid, str(ev.get("kind", "recovery")))
                tracked = self.events.get(key)
                if tracked is None:
                    tracked = self.events[key] = _Event(pgid, key[1], now)
                tracked.observe(ev, now)
        storm = status.get("recovery_storm") or {}
        total = int(storm.get("objects_total", 0))
        if total and int(storm.get("objects_done", 0)) >= total:
            self._storm_final[daemon] = storm

    def tick(self) -> None:
        now = time.monotonic()
        self._credit_lost_time(now)
        self._refresh_config()
        seen: set[tuple[str, str]] = set()
        # a down daemon's frozen status must not keep refreshing its
        # events (the event would never expire and a stall could never
        # clear) — the same liveness rule the slow-ops/tpu-degraded
        # digest slices apply (Mgr._daemon_report_live)
        live = getattr(self.mgr, "_daemon_report_live", None)
        # per-victim whole-OSD rebuild accumulators: summed
        # across daemons this tick, then observed as one event each
        storm_sums: dict[str, dict] = {}
        storm_live: set[str] = set()  # storm keys some daemon reports now
        for daemon in self.mgr.list_daemons():
            if live is not None and not live(daemon):
                continue
            status = self.mgr.get_daemon_status(daemon)
            for pgid, events in (status.get("progress") or {}).items():
                for ev in events:
                    kind = str(ev.get("kind", "recovery"))
                    key = (pgid, kind)
                    seen.add(key)
                    tracked = self.events.get(key)
                    if tracked is None:
                        tracked = self.events[key] = _Event(pgid, kind, now)
                    tracked.observe(ev, now)
            storm = status.get("recovery_storm") or {}
            if storm.get("objects_total"):
                storm_live.add(_storm_key(storm))
            else:
                # the port's (C24): a daemon whose final bar a tick missed
                storm = self._storm_final.get(daemon) or {}
            if storm.get("objects_total"):
                skey = _storm_key(storm)
                agg = storm_sums.setdefault(
                    skey, {"objects_done": 0, "objects_total": 0}
                )
                agg["objects_done"] += int(storm.get("objects_done", 0))
                agg["objects_total"] += int(storm.get("objects_total", 0))
        storm_seen: set[str] = set()
        for skey, agg in storm_sums.items():
            storm_seen.add(skey)
            tracked = self.storms.get(skey)
            if tracked is None:
                tracked = self.storms[skey] = _Event(skey, "storm", now)
            tracked.observe(agg, now)
        # a rebuild no daemon reports any more was observed whole from its
        # final bars just now: drop them, so it vanishes and completes
        for daemon, storm in list(self._storm_final.items()):
            if _storm_key(storm) not in storm_live:
                del self._storm_final[daemon]
        for skey, ev in list(self.storms.items()):
            if (
                skey not in storm_seen
                and now - ev.last_seen > self.EVENT_EXPIRE_SEC
            ):
                del self.storms[skey]
                # same completion rule as recovery events below: the
                # controller re-emits a final done==total bar, so a
                # storm that vanished below total lost its reporter
                # mid-rebuild — that is `expired`, not success
                if ev.total and ev.done >= ev.total:
                    self.completed += 1
                else:
                    self.expired += 1
        for key, ev in list(self.events.items()):
            if key not in seen and now - ev.last_seen > self.EVENT_EXPIRE_SEC:
                del self.events[key]
                # recovery emits an explicit final done==total report
                # (PG._recovery_final_reports), so a recovery that
                # vanished below total lost its reporter mid-flight —
                # that is `expired`.  Backfill/scrub stop reporting the
                # moment their last chunk lands (cursor/objects lag one
                # report), so their disappearance IS completion.
                if ev.kind != "recovery" or (ev.total and ev.done >= ev.total):
                    self.completed += 1
                else:
                    self.expired += 1
        self._update_health(now)

    def _update_health(self, now: float) -> None:
        slice_ = self.stalled_slice(now)
        if slice_:
            from ..common import health

            self.set_health_check(
                "PG_RECOVERY_STALLED",
                "HEALTH_WARN",
                health.recovery_stalled_summary(slice_) or "",
                health.recovery_stalled_detail(slice_),
            )
        else:
            self.clear_health_check("PG_RECOVERY_STALLED")

    # -- rendered surfaces -----------------------------------------------------

    def stalled_slice(self, now: float | None = None) -> dict[str, dict]:
        """{"<pgid>:<kind>": {pgid, kind, stalled_for_sec, objects_done,
        objects_total}} — the digest slice the mon-side health check
        renders from.  Keyed by (pgid, kind) so a PG whose recovery AND
        backfill both stall reports both, not whichever iterated last."""
        now = time.monotonic() if now is None else now
        return {
            f"{ev.pgid}:{ev.kind}": {
                "pgid": ev.pgid,
                "kind": ev.kind,
                "stalled_for_sec": round(now - ev.last_change, 1),
                "objects_done": ev.done,
                "objects_total": ev.total,
            }
            for ev in self.events.values()
            if ev.is_stalled(now, self.stall_sec)
        }

    def progress_digest(self) -> dict:
        """The `progress` slice of the mgr's PGMap digest (MMonMgrReport):
        what `ceph_cli status` renders as per-PG bars + the cluster-wide
        aggregate, and what the mon's PG_RECOVERY_STALLED check reads."""
        now = time.monotonic()
        events = [
            ev.render(now, self.stall_sec)
            for ev in sorted(self.events.values(), key=_Event.key)
        ]
        total = sum(e["objects_total"] for e in events)
        done = sum(e["objects_done"] for e in events)
        return {
            "events": events,
            "completed": self.completed,
            "expired": self.expired,
            "cluster": {
                "objects_done": done,
                "objects_total": total,
                "fraction": round(done / total, 4) if total else 1.0,
            },
            "stalled": self.stalled_slice(now),
            # whole-OSD rebuild bars: kept out of the
            # cluster aggregate above — the same objects already count
            # through their per-PG recovery events
            "storms": [
                ev.render(now, self.stall_sec)
                for ev in sorted(self.storms.values(), key=_Event.key)
            ],
        }

    def prometheus_metrics(self) -> list[tuple[str, str, str, list[str]]]:
        """Module-metrics hook the prometheus module renders: one gauge
        family per progress dimension, labeled by pgid + kind."""
        now = time.monotonic()
        frac: list[str] = []
        rate: list[str] = []
        eta: list[str] = []
        for ev in sorted(
            list(self.events.values()) + list(self.storms.values()),
            key=_Event.key,
        ):
            # built from render()'s already-gated fields so the scrape
            # can never desynchronize from the `status` bars (stalled
            # events show rate 0 / no ETA on BOTH surfaces); the storm
            # bars ride the same families labeled kind="storm"
            r = ev.render(now, self.stall_sec)
            labels = f'pgid="{ev.pgid}",kind="{ev.kind}"'
            frac.append(
                f"ceph_tpu_progress_fraction{{{labels}}} {r['fraction']:.4f}"
            )
            rate.append(
                f"ceph_tpu_progress_rate_objects{{{labels}}} "
                f"{r['rate_objects_per_sec']:.3f}"
            )
            if r["eta_seconds"] is not None:
                eta.append(
                    f"ceph_tpu_progress_eta_seconds{{{labels}}} "
                    f"{r['eta_seconds']:.1f}"
                )
        return [
            ("ceph_tpu_progress_fraction", "gauge",
             "completion fraction of active recovery/backfill/scrub", frac),
            ("ceph_tpu_progress_rate_objects", "gauge",
             "smoothed objects/sec of active progress events", rate),
            ("ceph_tpu_progress_eta_seconds", "gauge",
             "estimated seconds to completion of active progress events",
             eta),
            ("ceph_tpu_progress_active", "gauge",
             "number of active progress events",
             [f"ceph_tpu_progress_active {len(self.events)}"]),
        ]
