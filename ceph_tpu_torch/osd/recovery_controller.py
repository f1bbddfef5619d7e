"""Recovery-storm controller — wave-batched whole-OSD rebuild.

The port's copy of `ceph_tpu/osd/recovery_controller.py`.  Without it a
whole-OSD rebuild trickles per-PG through `osd_recovery_max_active`, with
no cross-PG coordination and no feedback from the SLO pipeline, however
much decode bandwidth the device has.  This controller makes rebuild a
deliberately scheduled pipeline:

- **Wave batching**: when the outstanding missing-object count across
  this OSD's primaried PGs crosses `osd_recovery_storm_min_objects`
  (the whole-OSD-failure signature — an osdmap out-event is noted as
  the storm's *victim* for the progress bar), the controller ENGAGES:
  it widens the shared DecodeAggregator window to the wave size and
  admits recoveries round-robin across PGs in waves of up to
  `osd_recovery_storm_wave_objects`, so many PGs' reconstruction
  decodes co-ride few padded launches of the hand decode kernel on the
  recovery QoS lane (the ECBackend decode pipeline does the heavy
  lifting; this is the conductor).  Wave
  depth is bounded by `osd_recovery_storm_max_inflight` across ALL
  PGs — the cross-PG analog of the per-PG knob it supersedes.
- **SLO-aware admission**: each tick the controller evaluates a LOCAL
  client burn rate from the OSD's own io-accounting latency histograms
  (the per-OSD input of the mgr iostat/SLO layer): the delta of
  client read/write ops slower than `osd_recovery_storm_slo_target_ms`
  over the error budget (1 - `osd_recovery_storm_slo_objective`).
  Burn above `osd_recovery_storm_burn_threshold` SHEDS (wave halves
  toward the floor); at/below it RAMPS (wave doubles toward the
  ceiling).  An idle cluster rebuilds at full blast; one burning its
  latency budget backs recovery off before SLO_LATENCY_BREACH fires.
- **Priority**: an engaged storm holds a `local_reserver` slot at
  `osd_recovery_op_priority`, PREEMPTING a granted backfill reservation
  (osd/reserver.py) — rebuild-for-durability outranks rebalancing.
- **Observability**: per-wave flight records (kind ``recovery_wave``,
  rendered as their own Perfetto row by tools/trace_export.py),
  ``recovery_storm.*`` counters/gauges on the MMgrReport (the
  ``ceph_tpu_recovery_storm_*`` scrape families), and a
  ``recovery_storm`` status-blob slice the mgr progress module
  aggregates into a whole-OSD rebuild bar with rate + ETA.

Every knob is runtime-mutable: all reads happen per tick, and the wave
ceiling additionally has a config observer clamping the live adaptive
wave the moment it shrinks.
"""

from __future__ import annotations

import time
import weakref

from ..common.log import dout

# rate smoothing: EMA weight of the newest objects/sec sample (the
# progress module's constant, reused so the two ETAs behave alike)
_RATE_ALPHA = 0.3
# minimum client ops in a burn window before the rate is trusted —
# two slow ops on an idle pool are noise, not an SLO breach
_BURN_MIN_OPS = 4
# minimum seconds between burn evaluations: ticks are completion-driven
# (PG.on_global_recover kicks per recovered object), and swapping the
# io-accounting baseline on every kick would shrink the window below
# the min-ops floor — burn would read 0.0 mid-breach and a shed would
# ramp right back.  Wave adjustments clock to these evaluations.
_BURN_EVAL_SEC = 0.25

# storms currently ENGAGED across the process: the decode aggregator is
# process-wide (embedded multi-OSD harnesses share it), so the widened
# window is restored from config only when the LAST storm disengages —
# one OSD finishing must not narrow a sibling's mid-episode window.
# Weak references: a torn-down controller (harness OSD that never ran
# to disengage) must not pin the refcount forever.
_ENGAGED: "weakref.WeakSet" = weakref.WeakSet()


def _under_target(lat_dump: dict | None, target_sec: float) -> tuple[int, int]:
    """(total samples, samples at/under target) from a cumulative
    PerfHistogram.dump() payload ({"histogram": {"buckets": [[le, cum],
    ...], "count": N}}); tolerates missing/empty dumps."""
    h = (lat_dump or {}).get("histogram") or {}
    total = int(h.get("count") or 0)
    under = 0
    for le, cum in h.get("buckets") or []:
        if le == "+Inf":
            continue
        if float(le) <= target_sec:
            under = int(cum)
        else:
            break
    return total, under


class RecoveryStormController:
    """Per-OSD cross-PG recovery orchestrator (one per OSD daemon)."""

    # completed-storm status re-emits on this many reports: the mgr
    # samples a last-write-wins status blob, so a one-shot final bar
    # could vanish before a module tick sees it (the PG progress
    # renderer's trick, applied to the whole-OSD bar)
    FINAL_REPORTS = 3

    def __init__(self, osd):
        self.osd = osd
        self.engaged = False
        # osd id -> monotonic stamp it was seen leaving up+in: the
        # storm's "victims" label for the whole-OSD rebuild bar
        self.victims: dict[int, float] = {}
        # monotone counters (the ceph_tpu_recovery_storm_* families)
        self.waves = 0
        self.objects_admitted = 0
        self.sheds = 0
        self.ramps = 0
        self.storms_started = 0
        self.storms_completed = 0
        self.preempted_backfills = 0
        # live levels (gauges)
        self._wave = int(osd.conf.get("osd_recovery_storm_wave_objects"))
        self._burn = 0.0
        self._inflight = 0
        # episode progress
        self._total = 0
        self._done = 0
        self._rate = 0.0
        self._engaged_at = 0.0
        self._last_tick = 0.0
        self._last_done = 0
        self._prev_io: dict | None = None
        self._last_burn_eval = 0.0
        self._final_reports = 0
        self._last_status: dict = {}
        # a runtime ceiling change clamps the live adaptive wave NOW —
        # the observer half of the config wiring (the per-tick re-reads
        # are the other half)
        osd.conf.add_observer(
            ["osd_recovery_storm_wave_objects"],
            lambda _n, v: self._clamp_wave(int(v)),
        )

    def _clamp_wave(self, ceiling: int) -> None:
        self._wave = max(1, min(self._wave, max(1, ceiling)))

    # -- osdmap transitions ----------------------------------------------------

    def note_osdmap(self, old, new) -> None:
        """Called on every map advance: an OSD leaving up+in is a storm
        victim candidate (named on the rebuild bar); one returning to
        up+in is struck — its data no longer needs a whole-OSD rebuild."""
        now = time.monotonic()
        for oid, info in old.osds.items():
            ninfo = new.osds.get(oid)
            if ninfo is None:
                continue
            if (info.up and info.in_) and not (ninfo.up and ninfo.in_):
                self.victims[oid] = now
        for oid in list(self.victims):
            ninfo = new.osds.get(oid)
            if ninfo is not None and ninfo.up and ninfo.in_:
                del self.victims[oid]

    # -- the tick loop ---------------------------------------------------------

    def tick(self) -> None:
        """One admission pass (heartbeat-driven, like PG.tick)."""
        conf = self.osd.conf
        ready: list[tuple[object, list[str]]] = []
        inflight = 0
        outstanding = 0
        for key in sorted(self.osd.pgs):
            pg = self.osd.pgs[key]
            if not (pg.peering.is_primary() and pg.peering.is_active()):
                continue
            inflight += len(pg.recovering)
            oids = [
                o for o in pg.peering.all_missing_oids()
                if o not in pg.recovering
            ]
            outstanding += len(oids)
            if oids:
                ready.append((pg, oids))
        self._inflight = inflight
        if not self.engaged:
            if (
                outstanding + inflight
                >= int(conf.get("osd_recovery_storm_min_objects"))
            ):
                self._engage(outstanding + inflight)
            else:
                return
        # episode progress: high-water total, done derived from what is
        # no longer outstanding (newly discovered work grows the
        # denominator, never regresses done — the PG bar's discipline)
        self._total = max(self._total, self._done + outstanding + inflight)
        self._done = max(self._done, self._total - outstanding - inflight)
        self._update_rate()
        self._adapt_wave()
        max_inflight = int(conf.get("osd_recovery_storm_max_inflight"))
        if ready and inflight < max_inflight:
            budget = min(self._wave, max_inflight - inflight)
            admitted = self._admit_wave(ready, budget)
            if admitted:
                self.waves += 1
                self.objects_admitted += admitted
                self._inflight += admitted
        if outstanding == 0 and inflight == 0:
            self._disengage()

    def _update_rate(self) -> None:
        now = time.monotonic()
        dt = now - self._last_tick
        if dt >= 0.01:
            # sample from the done-delta over the tick; first tick of an
            # episode only seeds the clock
            delta = self._done - getattr(self, "_last_done", 0)
            if delta > 0:
                sample = delta / dt
                self._rate = (
                    sample if self._rate == 0.0
                    else _RATE_ALPHA * sample + (1 - _RATE_ALPHA) * self._rate
                )
            self._last_tick = now
            self._last_done = self._done

    def _clog(self, prio: str, msg: str) -> None:
        """Storm timeline entries: engage/shed/wave/complete
        land in the cluster log so the storm is reconstructable from
        `log last` alone.  Guarded — unit tests drive the controller
        with a bare fake OSD."""
        clog = getattr(self.osd, "cluster_log", None)
        if clog is not None:
            clog(prio, msg, code="RECOVERY_STORM")

    # -- engagement ------------------------------------------------------------

    def _engage(self, total: int) -> None:
        self.engaged = True
        self.storms_started += 1
        now = time.monotonic()
        self._engaged_at = now
        self._last_tick = now
        self._last_done = 0
        self._total = total
        self._done = 0
        self._rate = 0.0
        self._burn = 0.0
        self._prev_io = None
        self._final_reports = 0
        self._wave = max(
            1, int(self.osd.conf.get("osd_recovery_storm_wave_objects"))
        )
        self._last_burn_eval = 0.0
        # widen the (shared) decode window so one wave's decodes co-ride
        # few padded launches; restored from config when the LAST
        # engaged storm in the process disengages (the aggregator is
        # shared — widening is monotone across concurrent storms, and
        # the _ENGAGED refcount keeps one OSD's finish from narrowing
        # a sibling's mid-episode window)
        _ENGAGED.add(self)
        self.osd.decode_aggregator.configure(
            window=max(
                int(self.osd.conf.get("ec_tpu_decode_aggregate_window")),
                self._wave,
            )
        )
        # rebuild-for-durability outranks rebalancing: take a local slot
        # at recovery priority, preempting a granted backfill (its
        # on_preempt surrenders cleanly; the tick loop re-grants after
        # the storm releases)
        before = self.osd.local_reserver.preemptions
        self.osd.local_reserver.try_reserve(
            ("storm", self.osd.whoami),
            priority=int(self.osd.conf.get("osd_recovery_op_priority")),
        )
        self.preempted_backfills += (
            self.osd.local_reserver.preemptions - before
        )
        dout(
            "osd", 1,
            f"osd.{self.osd.whoami}: recovery storm ENGAGED "
            f"({total} objects outstanding, victims "
            f"{sorted(self.victims) or '[]'})",
        )
        self._clog(
            "info",
            f"recovery storm ENGAGED: {total} objects outstanding, "
            f"victims {sorted(self.victims) or '[]'}",
        )

    def _disengage(self) -> None:
        self.engaged = False
        self.storms_completed += 1
        self._done = self._total  # the bar completes at exactly 100%
        self._final_reports = self.FINAL_REPORTS
        self._last_status = self._render(final=True)
        _ENGAGED.discard(self)
        if not _ENGAGED:
            self.osd.decode_aggregator.configure(
                window=int(
                    self.osd.conf.get("ec_tpu_decode_aggregate_window")
                )
            )
        self.osd.local_reserver.release(("storm", self.osd.whoami))
        self.victims.clear()
        dout(
            "osd", 1,
            f"osd.{self.osd.whoami}: recovery storm complete "
            f"({self._total} objects, {self.waves} waves lifetime)",
        )
        self._clog(
            "info",
            f"recovery storm complete: {self._total} objects rebuilt, "
            f"{self.waves} waves lifetime",
        )

    # -- wave admission --------------------------------------------------------

    def _admit_wave(
        self, ready: list[tuple[object, list[str]]], budget: int
    ) -> int:
        """Admit up to `budget` recoveries round-robin across PGs (one
        object per PG per turn, so a 40-object PG cannot starve a
        4-object one) and commit the wave's flight record."""
        t0 = time.monotonic()
        queues = [(pg, list(oids)) for pg, oids in ready]
        admitted = 0
        pgs_touched: set = set()
        while queues and admitted < budget:
            next_queues = []
            for pg, oids in queues:
                if admitted >= budget:
                    break
                oid = oids.pop(0)
                already = oid in pg.recovering
                pg._recover_one(oid)
                if not already and oid in pg.recovering:
                    admitted += 1
                    pgs_touched.add(id(pg))
                if oids:
                    next_queues.append((pg, oids))
            queues = next_queues
        if admitted:
            self._record_wave(t0, admitted, len(pgs_touched))
            # per-wave timeline breadcrumb at debug severity: the
            # "waves" step of the storm sequence, cheap enough that the
            # client-side rate limiter is the only bound it needs
            self._clog(
                "debug",
                f"recovery storm wave: {admitted} objects across "
                f"{len(pgs_touched)} pgs (wave size {self._wave})",
            )
        return admitted

    def _record_wave(self, t0: float, objects: int, pgs: int) -> None:
        """One flight record per wave: the Perfetto storm row and the
        launches-vs-objects witness chaos asserts against."""
        from ..ops.flight_recorder import flight_recorder, new_record

        rec = new_record(
            "recovery_wave",
            group=self._group_name(),
            tickets=pgs,
            stripes=objects,
            batch=objects,
            submit_ts=t0,
            sched_class="recovery",
        )
        rec["dispatch_ts"] = t0
        flight_recorder().commit(rec)

    def _group_name(self) -> str:
        victims = "+".join(f"osd.{o}" for o in sorted(self.victims))
        return f"storm:{victims or f'osd.{self.osd.whoami}:local'}"

    # -- SLO-aware admission ---------------------------------------------------

    def _adapt_wave(self) -> None:
        # clock shed/ramp decisions to the burn-evaluation cadence: a
        # completion-driven tick between evaluations must neither swap
        # the io baseline (shrinking the burn window to nothing) nor
        # step the wave on a stale verdict
        now = time.monotonic()
        if now - self._last_burn_eval < _BURN_EVAL_SEC:
            return
        self._last_burn_eval = now
        conf = self.osd.conf
        self._burn = self._client_burn()
        ceiling = max(1, int(conf.get("osd_recovery_storm_wave_objects")))
        floor = max(
            1, int(conf.get("osd_recovery_storm_min_wave_objects"))
        )
        floor = min(floor, ceiling)
        threshold = float(conf.get("osd_recovery_storm_burn_threshold"))
        if self._burn > threshold:
            new = max(floor, self._wave // 2)
            if new < self._wave:
                self.sheds += 1
                self._clog(
                    "info",
                    f"recovery storm SHED: wave {self._wave} -> {new} "
                    f"(client burn {self._burn:.2f} > {threshold})",
                )
        else:
            new = min(ceiling, max(self._wave * 2, floor))
            if new > self._wave:
                self.ramps += 1
        self._wave = max(floor, min(new, ceiling))

    def _client_burn(self) -> float:
        """Worst per-pool local burn rate over the last tick window:
        (client read/write ops slower than the target) / error budget,
        from the io-accounting histogram deltas.  0.0 while disabled,
        on the first tick (no baseline), or under the min-ops floor."""
        conf = self.osd.conf
        target_ms = float(conf.get("osd_recovery_storm_slo_target_ms"))
        accountant = getattr(self.osd, "io_accountant", None)
        if accountant is None:
            return 0.0
        cur = accountant.dump_pools()
        prev, self._prev_io = self._prev_io, cur
        if target_ms <= 0 or prev is None:
            return 0.0
        objective = float(conf.get("osd_recovery_storm_slo_objective"))
        budget = max(1e-6, 1.0 - objective)
        target_sec = target_ms / 1e3
        worst = 0.0
        for pid, classes in cur.items():
            for cls in ("read", "write"):
                total1, under1 = _under_target(
                    (classes.get(cls) or {}).get("lat"), target_sec
                )
                total0, under0 = _under_target(
                    ((prev.get(pid) or {}).get(cls) or {}).get("lat"),
                    target_sec,
                )
                d_total = total1 - total0
                if d_total < _BURN_MIN_OPS:
                    continue
                d_bad = d_total - (under1 - under0)
                worst = max(worst, (d_bad / d_total) / budget)
        return worst

    # -- surfaces --------------------------------------------------------------

    def _render(self, final: bool = False) -> dict:
        now = time.monotonic()
        remaining = max(0, self._total - self._done)
        eta = (
            None
            if final or self._rate <= 0.0
            else round(remaining / self._rate, 1)
        )
        return {
            "engaged": bool(self.engaged),
            "victims": sorted(f"osd.{o}" for o in self.victims),
            "objects_done": self._done,
            "objects_total": self._total,
            "wave_objects": self._wave,
            "inflight": self._inflight,
            "waves": self.waves,
            "burn_rate": round(self._burn, 3),
            "rate_objects_per_sec": 0.0 if final else round(self._rate, 3),
            "eta_seconds": eta,
            "elapsed_seconds": round(now - self._engaged_at, 1),
        }

    def status(self) -> dict:
        """The `recovery_storm` OSD status-blob slice ({} when idle):
        the mgr progress module aggregates these across daemons into a
        whole-OSD rebuild bar with rate + ETA."""
        if self.engaged:
            self._last_status = self._render()
            return dict(self._last_status)
        if self._final_reports > 0:
            self._final_reports -= 1
            return dict(self._last_status)
        return {}

    def perf_dump(self) -> dict:
        """Flat scalars for the MMgrReport `recovery_storm.*` namespace
        (the scrape renders one ceph_tpu_recovery_storm_* family per
        key; wave_objects/inflight/engaged/burn_rate are gauges, the
        rest monotone counters — mgr/prometheus._perf_type)."""
        return {
            "waves": self.waves,
            "objects_admitted": self.objects_admitted,
            "sheds": self.sheds,
            "ramps": self.ramps,
            "storms_started": self.storms_started,
            "storms_completed": self.storms_completed,
            "preempted_backfills": self.preempted_backfills,
            "wave_objects": self._wave,
            "inflight": self._inflight,
            "engaged": int(self.engaged),
            "burn_rate": round(self._burn, 3),
        }
