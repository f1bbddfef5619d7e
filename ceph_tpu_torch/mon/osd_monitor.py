"""OSDMonitor — the PaxosService owning the OSDMap (src/mon/OSDMonitor.cc).

Mirrored responsibilities:
- OSD lifecycle: boot marks up (prepare_boot), failure reports are
  quorum-checked before marking down (prepare_failure, OSDMonitor.cc:2791;
  `mon_osd_min_down_reporters`).
- EC profile CRUD: `osd erasure-code-profile set/get/ls/rm`
  (OSDMonitor.cc:6859-6915) with `normalize_profile` (:7416) instantiating
  the codec through the plugin registry to validate, and the
  `chunk_size == stripe_unit` check at pool create (:7437-7455,
  prepare_pool_stripe_width :7715).
- Pool create/rm with CRUSH rule creation (`indep` for EC,
  ErasureCode.cc:64-82).
- Map publication: every committed epoch is pushed to `osdmap` subscribers
  as an Incremental (full-map epochs for structural changes).

Mutations queue as closures against a scratch copy of the committed map and
ride ONE proposal at a time (the reference's pending_inc batching).

The port's: every codec the service builds (to normalize a profile, to
check a pool's stripe unit) is on the monitor's `device`, cuda unless the
caller names another; the bootstrap profile's seeding catches only the
profile's own errors, so a device that is absent or broken fails the
monitor instead of leaving it with no default profile; proposals wait
until the leader's Paxos has caught up (ROADMAP C17); and a failure whose
markdown is already proposed is not counted again (ROADMAP C19).
"""

from __future__ import annotations

import json
import time
from typing import Callable

from ..codec.interface import EcError
from ..common.errs import EAGAIN, EINVAL
from ..codec.registry import ErasureCodePluginRegistry
from ..common.log import dout
from ..msg.messages import MOSDBoot, MOSDFailure, MOSDMap
from .paxos_service import paxos_recovering
from ..osd.osdmap import (
    FLAG_EC_OVERWRITES,
    FLAG_FULL_QUOTA,
    Incremental,
    OSDMap,
    POOL_TYPE_ERASURE,
    POOL_TYPE_REPLICATED,
)

DEFAULT_STRIPE_UNIT = 4096


class OSDMonitor:
    def __init__(self, mon, min_down_reporters: int = 2, device=None):
        self.mon = mon
        self.device = device  # the codecs' device (registry.factory(device=))
        self.osdmap = OSDMap()
        self.inc_by_epoch: dict[int, bytes] = {}
        # target -> {reporter: report time}; entries expire (prepare_failure)
        self.failure_reports: dict[int, dict[str, float]] = {}
        # targets whose markdown is proposed and not yet committed: more
        # reports for them are the same failure (Ceph's check_failure
        # skips a target already down in pending_inc; the port's, C19)
        self._pending_down: set[int] = set()
        self.min_down_reporters = min_down_reporters
        self.report_expiry = 20.0  # seconds a failure report stays valid
        # down-and-in OSDs awaiting auto-out (mon_osd_down_out_interval)
        self._down_since: dict[int, float] = {}
        # flap dampening: per-OSD recent markdown stamps
        # (pruned to mon_osd_flap_window); the down->out grace grows
        # mon_osd_flap_backoff^(markdowns-1) so a flapping OSD stops
        # re-triggering full peering storms on every bounce
        self._recent_markdowns: dict[int, list[float]] = {}
        self.auto_outs_total = 0  # lifetime auto-out count (the sweep's)
        self.dampened_holds = 0   # sweep passes where dampening held fire
        # OSDs whose current down episode already clog'd a dampening
        # hold (one timeline entry per episode, not one per sweep tick)
        self._hold_logged: set[int] = set()
        # OSDs the sweep auto-outed: marked back IN on reboot (the
        # reference's mon_osd_auto_mark_auto_out_in), unlike an
        # operator's explicit `osd out` which sticks
        self._auto_outed: set[int] = set()
        # laggy (slow-but-alive) OSDs: target -> {reporter: {at, rtt}}
        # evidence from MOSDFailure(laggy=1) reports, plus the episode's
        # start stamp.  NON-FATAL: no osdmap mutation, no auto-out — only
        # the OSD_SLOW_PEER health warn and a clog event per episode (set
        # and clear, like the markdown timeline: one entry per
        # transition, never per report)
        self.laggy: dict[int, dict] = {}
        # seconds laggy evidence stays valid without a refresh: reports
        # re-send on the reporter's heartbeat-grace cadence, so 3x the
        # failure-report expiry forgives a couple of lost beacons while
        # still self-clearing if the reporter dies mid-episode
        self.laggy_report_expiry = 3 * self.report_expiry
        # queued mutations: (mutate(map) -> rs, reply or None)
        self._pending: list[tuple[Callable, Callable | None]] = []
        self._proposing = False

    def _clog(self, prio: str, msg: str, code: str | None = None) -> None:
        """Cluster-log a lifecycle transition; unit harnesses drive this
        service with a bare mon stub that has no LogMonitor."""
        logmon = getattr(self.mon, "logmon", None)
        if logmon is not None:
            logmon.log(prio, f"mon.{self.mon.name}", msg, code=code)

    # -- paxos plumbing --------------------------------------------------------

    def on_election_lost(self) -> None:
        """Became a peon: the in-flight proposal's on_done (if any) was
        dropped by paxos peon_init; queued mutations can't commit here, so
        their callers retry against the new leader."""
        self._proposing = False
        self._pending_down.clear()
        pending, self._pending = self._pending, []
        for _mutate, reply in pending:
            if reply is not None:
                reply(-EAGAIN, "lost leadership; retry")

    def on_active(self) -> None:
        """Leader became active (its Paxos caught up); bootstrap the first
        map epoch."""
        self._proposing = False  # a pre-election in-flight on_done is gone
        self._pending_down.clear()  # and with it any markdown it carried
        if self.osdmap.epoch == 0:
            def init(m: OSDMap) -> str:
                m.fsid = "tpu-fsid"
                m.crush.add_bucket("default", "root")
                # seed the bootstrap EC profile from
                # osd_pool_default_erasure_code_profile so
                # `pool create ... erasure` works out of the box.  Only
                # the profile's own errors are caught (a bad option
                # value): a CUDA or build failure of the codec the
                # check instantiates propagates to the Monitor, which
                # stops (`Monitor._fail`), so a monitor whose device is
                # absent or broken fails instead of coming up without a
                # default profile.
                try:
                    raw = self.mon.conf.get(
                        "osd_pool_default_erasure_code_profile"
                    )
                    prof = dict(
                        kv.split("=", 1) for kv in str(raw).split() if "=" in kv
                    )
                    m.erasure_code_profiles["default"] = (
                        self._normalize_profile(prof)
                    )
                except (EcError, ValueError, KeyError) as e:
                    dout("mon", 1,
                         f"default EC profile unseedable: {e!r}")
                return "created initial map"

            self._queue(init, None)
        else:
            self._try_propose()

    def apply_commit(self, blob: bytes) -> None:
        """Applied on EVERY quorum member in commit order."""
        inc = Incremental.frombytes(blob)
        self.osdmap = inc.apply_to(self.osdmap)
        self.inc_by_epoch[self.osdmap.epoch] = blob
        dout("mon", 10, f"osdmap e{self.osdmap.epoch} committed")
        self.mon.publish_osdmap()

    def _queue(self, mutate: Callable, reply: Callable | None) -> None:
        self._pending.append((mutate, reply))
        self._try_propose()

    def _try_propose(self) -> None:
        if self._proposing or not self._pending or not self.mon.is_leader():
            return
        if paxos_recovering(self.mon):
            return  # on_active proposes once the leader has caught up (C17)
        batch, self._pending = self._pending, []
        # scratch copy of the committed map (the pending_inc)
        scratch = OSDMap.frombytes(self.osdmap.tobytes())
        results: list[tuple[Callable | None, int, str]] = []
        for mutate, reply in batch:
            try:
                rs = mutate(scratch)
                results.append((reply, 0, rs or ""))
            except EcError as e:
                results.append((reply, e.errno, str(e)))
            except (KeyError, ValueError) as e:
                results.append((reply, -EINVAL, str(e)))
        scratch.epoch = self.osdmap.epoch + 1
        inc = Incremental(epoch=scratch.epoch, full_map=scratch.tobytes())
        self._proposing = True

        def on_done(_version: int) -> None:
            self._proposing = False
            for reply, retval, rs in results:
                if reply is not None:
                    reply(retval, rs)
            self._try_propose()

        self.mon.propose("osd", inc.tobytes(), on_done)

    # -- subscriptions ---------------------------------------------------------

    def check_sub(self, conn, subs: dict[str, int]) -> None:
        """Send epochs the subscriber is missing (check_osdmap_sub)."""
        start = subs.get("osdmap", 0)
        if self.osdmap.epoch == 0 or start > self.osdmap.epoch:
            return
        incs: dict[int, bytes] = {}
        maps: dict[int, bytes] = {}
        # Delta incrementals ride as-is; full-map-backed epochs collapse to
        # ONE latest full map (sending a full map per missed epoch would be
        # strictly worse than the maps path).
        pending = [
            self.inc_by_epoch.get(e) for e in range(max(start, 1), self.osdmap.epoch + 1)
        ]
        if (
            start == 0
            or any(p is None for p in pending)
            or any(Incremental.frombytes(p).full_map for p in pending)
        ):
            maps[self.osdmap.epoch] = self.osdmap.tobytes()
        else:
            for e in range(max(start, 1), self.osdmap.epoch + 1):
                incs[e] = self.inc_by_epoch[e]
        subs["osdmap"] = self.osdmap.epoch + 1
        self.mon.send_to_conn(
            conn, MOSDMap(fsid=self.osdmap.fsid, maps=maps, incrementals=incs)
        )

    # -- OSD lifecycle ---------------------------------------------------------

    def prepare_boot(self, msg: MOSDBoot) -> None:
        osd, addr = msg.osd, msg.addr
        info = self.osdmap.osds.get(osd)
        if info is not None and info.up and info.addr == addr:
            return  # duplicate boot

        def mutate(m: OSDMap) -> str:
            if osd not in m.osds:
                # grow the crush tree: one host per osd (the standalone
                # many-OSDs-one-host topology, qa/standalone/ceph-helpers.sh)
                host = m.crush.add_bucket(f"host{osd}", "host")
                m.crush.add_item(host, osd, 1.0)
                m.crush.add_item("default", host, 1.0)
                m.add_osd(osd, addr=addr, up=True)
            else:
                m.set_osd_state(osd, True, addr)
                if osd in self._auto_outed:
                    # the down-out sweep outed it, not an operator:
                    # a reboot marks it back in so its capacity returns
                    from ..crush.crush import WEIGHT_ONE

                    self._auto_outed.discard(osd)
                    if m.osds[osd].weight == 0:
                        m.set_osd_weight(osd, WEIGHT_ONE)
            self.failure_reports.pop(osd, None)
            return f"osd.{osd} boot"

        self._queue(mutate, None)
        # lifecycle timeline: boots, markdowns and auto-outs all land in
        # the cluster log, not just dout
        self._clog("info", f"osd.{osd} boot")

    def prepare_failure(self, msg: MOSDFailure, reporter: str) -> None:
        """Quorum-check failure reports (OSDMonitor.cc:2791, :3134).
        Reports expire after `report_expiry` seconds — a stale reporter
        from a long-past blip must not combine with a fresh one to mark
        a healthy OSD down (failure_info_t's report window)."""
        target = msg.target
        if getattr(msg, "laggy", 0):
            # laggy reports branch BEFORE the is_up gate: a laggy target
            # is by definition still up (it answers heartbeats — slowly)
            self._handle_laggy_report(msg, reporter)
            return
        if not self.osdmap.is_up(target) or target in self._pending_down:
            return
        now = time.monotonic()
        reporters = self.failure_reports.setdefault(target, {})
        reporters[reporter] = now
        for r, ts in list(reporters.items()):
            if now - ts > self.report_expiry:
                del reporters[r]
        if len(reporters) < self.min_down_reporters:
            dout(
                "mon", 10,
                f"osd.{target} failure: {len(reporters)}/{self.min_down_reporters} reporters",
            )
            return
        nrep = len(reporters)
        self.failure_reports.pop(target, None)
        self._pending_down.add(target)
        # a quorum-confirmed death retires any laggy episode: dead beats
        # slow, and OSD_DOWN must not double-bill as OSD_SLOW_PEER
        self._laggy_retire(target, reason="marked down")
        self._note_markdown(target, now)

        def mutate(m: OSDMap) -> str:
            m.set_osd_state(target, False)
            return f"osd.{target} marked down"

        self._queue(mutate, lambda _rv, _rs: self._pending_down.discard(target))
        self._clog(
            "warn", f"osd.{target} marked down ({nrep} reporters)",
            code="OSD_DOWN",
        )

    # -- flap dampening ---------------------------------------------------------

    def _note_markdown(self, osd: int, now: float) -> None:
        """Record one markdown event in the OSD's recent-flap history
        (pruned to the window on read)."""
        self._recent_markdowns.setdefault(osd, []).append(now)

    def _recent_markdown_count(self, osd: int, now: float) -> int:
        window = float(self.mon.conf.get("mon_osd_flap_window"))
        stamps = self._recent_markdowns.get(osd)
        if not stamps:
            return 0
        if window <= 0:
            # dampening off: report 0 but KEEP the (bounded) history so
            # a runtime re-enable resumes from live data instead of
            # forgiving an active flapper
            if len(stamps) > 16:
                self._recent_markdowns[osd] = stamps[-16:]
            return 0
        live = [t for t in stamps if now - t <= window]
        if live:
            self._recent_markdowns[osd] = live
        else:
            self._recent_markdowns.pop(osd, None)
        return len(live)

    def _down_out_grace(self, osd: int, now: float) -> float:
        """Effective down->out grace for `osd`: the base interval scaled
        by backoff^(recent markdowns - 1), exponent capped at 8.  A
        first-time failure uses the base interval unchanged; every
        additional markdown inside the flap window doubles (by default)
        the time the mon waits before remapping the OSD's data."""
        base = float(self.mon.conf.get("mon_osd_down_out_interval"))
        if base <= 0:
            return base
        n = self._recent_markdown_count(osd, now)
        if n <= 1:
            return base
        backoff = max(1.0, float(self.mon.conf.get("mon_osd_flap_backoff")))
        return base * backoff ** min(n - 1, 8)

    def flap_stats(self) -> dict:
        """Dampening introspection (chaos/tests and the asok surface):
        lifetime auto-out count plus each tracked OSD's recent markdown
        count and current effective grace."""
        now = time.monotonic()
        per_osd = {}
        for osd in sorted(self._recent_markdowns):
            n = self._recent_markdown_count(osd, now)
            if n:
                per_osd[osd] = {
                    "markdowns": n,
                    "grace_sec": round(self._down_out_grace(osd, now), 3),
                }
        return {
            "auto_outs_total": self.auto_outs_total,
            "dampened_holds": self.dampened_holds,
            "osds": per_osd,
        }

    # -- laggy (slow-but-alive) OSDs --------------------------------------------

    def _handle_laggy_report(self, msg: MOSDFailure, reporter: str) -> None:
        """A peer reports the target LAGGY (laggy=1, failed_for carries
        the reporter's RTT EWMA) or recovered (laggy=2).  Pure health
        state: no osdmap mutation, no markdown, no auto-out — the
        target still serves I/O, just slowly.  One clog entry per
        episode edge (set/clear), never per report."""
        target = msg.target
        now = time.monotonic()
        if msg.laggy == 2:
            ent = self.laggy.get(target)
            if ent is None:
                return
            ent["reporters"].pop(reporter, None)
            if not ent["reporters"]:
                self._laggy_retire(target, reason="recovered")
            return
        if not self.osdmap.is_up(target):
            return  # dead beats laggy
        ent = self.laggy.setdefault(
            target, {"reporters": {}, "since": now, "new": True}
        )
        ent["reporters"][reporter] = {"at": now, "rtt": float(msg.failed_for)}
        self._prune_laggy(target, now)
        if ent.get("new") and target in self.laggy:
            ent["new"] = False
            rtt_ms = max(
                r["rtt"] for r in ent["reporters"].values()
            ) * 1000.0
            self._clog(
                "warn",
                f"osd.{target} reported laggy by {reporter} "
                f"(rtt ewma {rtt_ms:.0f} ms): heartbeats answer but "
                "service is slow",
                code="OSD_SLOW_PEER",
            )

    def _prune_laggy(self, target: int, now: float) -> None:
        """Expire stale laggy evidence; retire the episode when the last
        reporter ages out (a reporter that died mid-episode must not
        pin a recovered OSD in OSD_SLOW_PEER forever)."""
        ent = self.laggy.get(target)
        if ent is None:
            return
        for r, info in list(ent["reporters"].items()):
            if now - info["at"] > self.laggy_report_expiry:
                del ent["reporters"][r]
        if not ent["reporters"]:
            self._laggy_retire(target, reason="reports expired")

    def _laggy_retire(self, target: int, reason: str) -> None:
        ent = self.laggy.pop(target, None)
        if ent is None or ent.get("new"):
            return  # never surfaced: no clear entry for an unlogged set
        self._clog(
            "info", f"osd.{target} no longer laggy ({reason})",
            code="OSD_SLOW_PEER",
        )

    def slow_peers(self) -> dict[int, dict]:
        """Current laggy OSDs for the health surface: target -> episode
        summary (reporters, worst reported RTT EWMA, age)."""
        now = time.monotonic()
        for target in list(self.laggy):
            self._prune_laggy(target, now)
        out: dict[int, dict] = {}
        for target, ent in self.laggy.items():
            out[target] = {
                "reporters": sorted(ent["reporters"]),
                "rtt_ms": round(
                    max(r["rtt"] for r in ent["reporters"].values()) * 1000.0,
                    3,
                ),
                "since_sec": round(now - ent["since"], 3),
            }
        return out

    # -- commands --------------------------------------------------------------

    def command_handler(self, prefix: str):
        handlers = {
            "osd erasure-code-profile set": (self._cmd_profile_set, True),
            "osd erasure-code-profile get": (self._cmd_profile_get, False),
            "osd erasure-code-profile ls": (self._cmd_profile_ls, False),
            "osd erasure-code-profile rm": (self._cmd_profile_rm, True),
            "osd pool create": (self._cmd_pool_create, True),
            "osd pool ls": (self._cmd_pool_ls, False),
            "osd pool get": (self._cmd_pool_get, False),
            "osd pool application enable": (self._cmd_app_enable, True),
            "osd pool application get": (self._cmd_app_get, False),
            "osd blocklist add": (self._cmd_blocklist_add, True),
            "osd blocklist rm": (self._cmd_blocklist_rm, True),
            "osd blocklist ls": (self._cmd_blocklist_ls, False),
            "osd pool rm": (self._cmd_pool_rm, True),
            "osd dump": (self._cmd_dump, False),
            "osd out": (self._cmd_out, True),
            "osd in": (self._cmd_in, True),
            "osd reweight": (self._cmd_reweight, True),
            "osd pool set": (self._cmd_pool_set, True),
            "osd pool set-quota": (self._cmd_pool_set_quota, True),
            "osd pool selfmanaged-snap-create": (self._cmd_snap_create, True),
            "osd tier add": (self._cmd_tier_add, True),
            "osd tier remove": (self._cmd_tier_remove, True),
            "osd tier cache-mode": (self._cmd_tier_cache_mode, True),
            "osd tier set-overlay": (self._cmd_tier_set_overlay, True),
            "osd tier remove-overlay": (self._cmd_tier_remove_overlay, True),
        }
        entry = handlers.get(prefix)
        if entry is None:
            return None
        fn, mutating = entry
        fn.__func__.mutating = mutating
        return fn

    # normalize_profile (OSDMonitor.cc:7416): instantiate through the
    # registry so plugin defaults land in the stored profile; the codec is
    # the monitor's one device touch.
    def _normalize_profile(self, profile: dict[str, str]) -> dict[str, str]:
        profile = dict(profile)
        plugin = profile.setdefault("plugin", "tpu")
        work = {k: v for k, v in profile.items() if not k.startswith("crush-") and k != "stripe_unit"}
        ec = ErasureCodePluginRegistry.instance().factory(plugin, work, device=self.device)
        out = dict(ec.get_profile())
        for k, v in profile.items():
            if k.startswith("crush-") or k == "stripe_unit":
                out[k] = v
        return out

    def _cmd_profile_set(self, cmd, reply) -> None:
        name = cmd["name"]
        profile_kv = dict(kv.split("=", 1) for kv in cmd.get("profile", []))
        normalized = self._normalize_profile(profile_kv)
        force = bool(cmd.get("force"))

        def mutate(m: OSDMap) -> str:
            existing = m.erasure_code_profiles.get(name)
            if existing is not None and existing != normalized and not force:
                raise ValueError(
                    f"will not override erasure code profile {name}"
                )
            m.erasure_code_profiles[name] = normalized
            return f"profile {name} set"

        self._queue(mutate, lambda rv, rs: reply(rv, rs))

    def _cmd_profile_get(self, cmd, reply) -> None:
        name = cmd["name"]
        prof = self.osdmap.erasure_code_profiles.get(name)
        if prof is None:
            reply(-2, f"no such profile {name}")
        else:
            reply(0, "", json.dumps(prof).encode())

    def _cmd_profile_ls(self, cmd, reply) -> None:
        reply(0, "", json.dumps(sorted(self.osdmap.erasure_code_profiles)).encode())

    def _cmd_profile_rm(self, cmd, reply) -> None:
        name = cmd["name"]

        def mutate(m: OSDMap) -> str:
            for pool in m.pools.values():
                if pool.erasure_code_profile == name:
                    raise ValueError(f"profile {name} in use by pool {pool.name}")
            if name not in m.erasure_code_profiles:
                raise KeyError(f"no such profile {name}")
            del m.erasure_code_profiles[name]
            return f"profile {name} removed"

        self._queue(mutate, lambda rv, rs: reply(rv, rs))

    def _cmd_pool_create(self, cmd, reply) -> None:
        name = cmd["pool"]
        pool_type = cmd.get("pool_type", "replicated")
        pg_num = int(cmd.get(
            "pg_num", self.mon.conf.get("osd_pool_default_pg_num")
        ))

        if pool_type == "erasure":
            profile_name = cmd.get("erasure_code_profile", "default")

            def mutate(m: OSDMap) -> str:
                prof = m.erasure_code_profiles.get(profile_name)
                if prof is None:
                    raise KeyError(f"no such erasure-code profile {profile_name}")
                ec = ErasureCodePluginRegistry.instance().factory(
                    prof.get("plugin", "tpu"),
                    {k: v for k, v in prof.items()
                     if not k.startswith("crush-") and k != "stripe_unit"},
                    device=self.device,
                )
                k = ec.get_data_chunk_count()
                stripe_unit = int(prof.get(
                    "stripe_unit",
                    self.mon.conf.get("osd_pool_erasure_code_stripe_unit"),
                ))
                # stripe_unit must equal the codec chunk size
                # (OSDMonitor.cc:7437-7455)
                chunk = ec.get_chunk_size(k * stripe_unit)
                if chunk != stripe_unit:
                    raise ValueError(
                        f"stripe_unit {stripe_unit} incompatible: codec chunk "
                        f"size would be {chunk}"
                    )
                rule = m.crush.rule_id(f"ec_{profile_name}")
                if rule is None:
                    rule = m.crush.add_simple_rule(
                        f"ec_{profile_name}",
                        failure_domain=prof.get("crush-failure-domain", "host"),
                        mode="indep",
                    )
                flags = FLAG_EC_OVERWRITES if cmd.get("allow_ec_overwrites") else 0
                m.create_pool(
                    name,
                    type=POOL_TYPE_ERASURE,
                    size=ec.get_chunk_count(),
                    min_size=k + 1 if ec.get_coding_chunk_count() > 1 else k,
                    pg_num=pg_num,
                    crush_rule=rule,
                    erasure_code_profile=profile_name,
                    stripe_width=k * stripe_unit,
                    flags=flags,
                    # osd_fast_read: the pool-level default for issuing
                    # k+m sub-reads with the first k winning
                    fast_read=bool(cmd.get(
                        "fast_read", self.mon.conf.get("osd_fast_read")
                    )),
                )
                return f"pool '{name}' created"

        else:

            def mutate(m: OSDMap) -> str:
                rule = m.crush.rule_id("replicated_rule")
                if rule is None:
                    rule = m.crush.add_simple_rule(
                        "replicated_rule",
                        failure_domain=cmd.get("crush_failure_domain", "host"),
                        mode="firstn",
                    )
                m.create_pool(
                    name,
                    type=POOL_TYPE_REPLICATED,
                    size=int(cmd.get("size", 3)),
                    pg_num=pg_num,
                    crush_rule=rule,
                )
                return f"pool '{name}' created"

        self._queue(mutate, lambda rv, rs: reply(rv, rs))

    def _cmd_pool_set_quota(self, cmd, reply) -> None:
        """`osd pool set-quota <pool> max_bytes|max_objects <val>`
        (OSDMonitor prepare_command; 0 clears).  Enforcement closes the
        loop in tick(): the mgr digest flips FLAG_FULL_QUOTA."""
        pool, field, val = cmd.get("pool"), cmd.get("field"), cmd.get("val")
        if field not in ("max_bytes", "max_objects"):
            reply(-EINVAL, f"unknown quota field {field!r}")
            return

        def mutate(m: OSDMap) -> str:
            p = m.get_pool(pool)
            if p is None:
                raise KeyError(f"pool {pool!r} does not exist")
            setattr(p, f"quota_{field}", int(val))
            if not p.quota_max_bytes and not p.quota_max_objects:
                p.flags &= ~FLAG_FULL_QUOTA  # clearing quotas unfulls
            return f"set-quota {field}={val} on pool {pool!r}"

        self._queue(mutate, reply)

    def tick(self) -> None:
        """Leader timers: auto-out of long-down OSDs
        (mon_osd_down_out_interval, OSDMonitor::tick's down-out sweep)
        and quota enforcement — compare the mgr's PGMap digest against
        pool quotas and flip FLAG_FULL_QUOTA via paxos."""
        if not self.mon.is_leader():
            return
        self._tick_down_out()
        # expire stale laggy evidence even when nobody reads health: the
        # clog clear must fire from the timeline, not a status request
        now = time.monotonic()
        for target in list(self.laggy):
            self._prune_laggy(target, now)
        stats = (self.mon.pg_digest or {}).get("pools", {})
        for p in list(self.osdmap.pools.values()):
            if not p.quota_max_bytes and not p.quota_max_objects:
                continue
            st = stats.get(p.name)
            if st is None:
                continue
            full = (
                (p.quota_max_objects and st["objects"] >= p.quota_max_objects)
                or (p.quota_max_bytes and st["stored"] >= p.quota_max_bytes)
            )
            if bool(p.flags & FLAG_FULL_QUOTA) == bool(full):
                continue
            name, want = p.name, bool(full)

            def mutate(m: OSDMap, name=name, want=want) -> str:
                tp = m.get_pool(name)
                if tp is None:
                    return ""
                if want:
                    tp.flags |= FLAG_FULL_QUOTA
                else:
                    tp.flags &= ~FLAG_FULL_QUOTA
                return f"pool {name!r} {'full (quota)' if want else 'no longer full'}"

            self._queue(mutate, None)

    def _cmd_app_enable(self, cmd, reply) -> None:
        """`osd pool application enable <pool> <app>` (OSDMonitor
        application metadata; rbd/cephfs/rgw tag their pools)."""
        pool, app = cmd.get("pool"), cmd.get("app", "")
        if not app:
            reply(-EINVAL, "usage: osd pool application enable <pool> <app>")
            return

        def mutate(m: OSDMap) -> str:
            p = m.get_pool(pool)
            if p is None:
                raise KeyError(f"pool {pool!r} does not exist")
            if p.application and p.application != app:
                raise ValueError(
                    f"pool {pool!r} already tagged {p.application!r}"
                )
            p.application = app
            return f"enabled application {app!r} on pool {pool!r}"

        self._queue(mutate, reply)

    def _cmd_app_get(self, cmd, reply) -> None:
        p = self.osdmap.get_pool(cmd.get("pool"))
        if p is None:
            reply(-EINVAL, f"pool {cmd.get('pool')!r} does not exist")
            return
        reply(0, "", json.dumps({"application": p.application}).encode())

    def _cmd_blocklist_add(self, cmd, reply) -> None:
        """`osd blocklist add <entity>` — fence a client instance
        (OSDMonitor blocklist; OSDs refuse its ops from the next epoch)."""
        entity = cmd.get("addr") or cmd.get("entity") or ""
        if not entity:
            reply(-EINVAL, "usage: osd blocklist add <entity>")
            return

        def mutate(m: OSDMap) -> str:
            m.blocklist.add(entity)
            return f"blocklisting {entity}"

        self._queue(mutate, reply)

    def _cmd_blocklist_rm(self, cmd, reply) -> None:
        entity = cmd.get("addr") or cmd.get("entity") or ""

        def mutate(m: OSDMap) -> str:
            if entity not in m.blocklist:
                raise KeyError(f"{entity} is not blocklisted")
            m.blocklist.discard(entity)
            return f"un-blocklisting {entity}"

        self._queue(mutate, reply)

    def _cmd_blocklist_ls(self, cmd, reply) -> None:
        reply(0, "", json.dumps(sorted(self.osdmap.blocklist)).encode())

    def _cmd_pool_get(self, cmd, reply) -> None:
        """`osd pool get <pool> <var>|all` (OSDMonitor prepare_command
        get variants)."""
        import dataclasses

        p = self.osdmap.get_pool(cmd.get("pool"))
        if p is None:
            reply(-EINVAL, f"pool {cmd.get('pool')!r} does not exist")
            return
        info = dataclasses.asdict(p)
        var = cmd.get("var", "all")
        if var in ("", "all"):
            reply(0, "", json.dumps(info).encode())
            return
        if var not in info:
            reply(-EINVAL, f"unknown pool variable {var!r}")
            return
        reply(0, "", json.dumps({var: info[var]}).encode())

    def _cmd_pool_ls(self, cmd, reply) -> None:
        reply(0, "", json.dumps([p.name for p in self.osdmap.pools.values()]).encode())

    def _cmd_pool_rm(self, cmd, reply) -> None:
        name = cmd["pool"]

        def mutate(m: OSDMap) -> str:
            pool = m.get_pool(name)
            if pool is None:
                raise KeyError(f"no such pool {name}")
            del m.pools[pool.id]
            del m.pool_name_to_id[name]
            return f"pool '{name}' removed"

        self._queue(mutate, lambda rv, rs: reply(rv, rs))

    # -- cache tiering (OSDMonitor prepare_command `osd tier ...`) -----------

    def _cmd_tier_add(self, cmd, reply) -> None:
        """`osd tier add <base> <tierpool>` — attach tierpool as a cache
        tier of base (OSDMonitor.cc tier add: both must exist, neither may
        already be in a tier relationship)."""
        base_n, tier_n = cmd["pool"], cmd["tierpool"]

        def mutate(m: OSDMap) -> str:
            base, tier = m.get_pool(base_n), m.get_pool(tier_n)
            if base is None or tier is None:
                raise KeyError(f"no such pool {base_n if base is None else tier_n}")
            if tier.tier_of >= 0:
                raise ValueError(f"pool '{tier_n}' is already a tier")
            if tier.tiers or base.tier_of >= 0:
                raise ValueError("tiers cannot be stacked")
            if tier.id == base.id:
                raise ValueError("pool cannot be a tier of itself")
            if tier.is_erasure():
                # The reference requires replicated cache pools too
                # (OSDMonitor tier add: EC tiers rejected).
                raise ValueError("cache tier pools must be replicated")
            tier.tier_of = base.id
            base.tiers.append(tier.id)
            return f"pool '{tier_n}' is now (or already was) a tier of '{base_n}'"

        self._queue(mutate, lambda rv, rs: reply(rv, rs))

    def _cmd_tier_remove(self, cmd, reply) -> None:
        base_n, tier_n = cmd["pool"], cmd["tierpool"]

        def mutate(m: OSDMap) -> str:
            base, tier = m.get_pool(base_n), m.get_pool(tier_n)
            if base is None or tier is None:
                raise KeyError(f"no such pool {base_n if base is None else tier_n}")
            if tier.tier_of != base.id:
                raise ValueError(f"pool '{tier_n}' is not a tier of '{base_n}'")
            if base.read_tier == tier.id:
                raise ValueError("remove the overlay first (osd tier remove-overlay)")
            tier.tier_of = -1
            tier.cache_mode = "none"
            base.tiers.remove(tier.id)
            return f"pool '{tier_n}' is now (or already was) not a tier of '{base_n}'"

        self._queue(mutate, lambda rv, rs: reply(rv, rs))

    def _cmd_tier_cache_mode(self, cmd, reply) -> None:
        tier_n, mode = cmd["pool"], cmd["mode"]

        def mutate(m: OSDMap) -> str:
            tier = m.get_pool(tier_n)
            if tier is None:
                raise KeyError(f"no such pool {tier_n}")
            if tier.tier_of < 0:
                raise ValueError(f"pool '{tier_n}' is not a tier")
            if mode not in ("none", "writeback", "readonly"):
                raise ValueError(f"unknown cache mode '{mode}'")
            base = m.get_pool(tier.tier_of)
            if mode == "none" and base is not None and base.read_tier == tier.id:
                # mode 'none' disables the PG-side tier gate while clients
                # still redirect to this pool: base-resident data would
                # stop promoting.  Same ordering rule as tier remove.
                raise ValueError(
                    "pool is an overlay; remove the overlay first "
                    "(osd tier remove-overlay)"
                )
            tier.cache_mode = mode
            return f"set cache-mode for pool '{tier_n}' to {mode}"

        self._queue(mutate, lambda rv, rs: reply(rv, rs))

    def _cmd_tier_set_overlay(self, cmd, reply) -> None:
        """`osd tier set-overlay <base> <overlaypool>` — clients targeting
        base redirect ops to the overlay (Objecter _calc_target read_tier)."""
        base_n, overlay_n = cmd["pool"], cmd["overlaypool"]

        def mutate(m: OSDMap) -> str:
            base, overlay = m.get_pool(base_n), m.get_pool(overlay_n)
            if base is None or overlay is None:
                raise KeyError(
                    f"no such pool {base_n if base is None else overlay_n}"
                )
            if overlay.tier_of != base.id:
                raise ValueError(f"pool '{overlay_n}' is not a tier of '{base_n}'")
            if overlay.cache_mode == "none":
                raise ValueError("set a cache-mode first (osd tier cache-mode)")
            base.read_tier = overlay.id
            return f"overlay for '{base_n}' is now (or already was) '{overlay_n}'"

        self._queue(mutate, lambda rv, rs: reply(rv, rs))

    def _cmd_tier_remove_overlay(self, cmd, reply) -> None:
        base_n = cmd["pool"]

        def mutate(m: OSDMap) -> str:
            base = m.get_pool(base_n)
            if base is None:
                raise KeyError(f"no such pool {base_n}")
            base.read_tier = -1
            return f"there is now (or already was) no overlay for '{base_n}'"

        self._queue(mutate, lambda rv, rs: reply(rv, rs))

    def _cmd_dump(self, cmd, reply) -> None:
        m = self.osdmap
        reply(
            0,
            "",
            json.dumps(
                {
                    "epoch": m.epoch,
                    "osds": {
                        str(o): {"up": i.up, "in": i.in_, "addr": i.addr}
                        for o, i in m.osds.items()
                    },
                    "pools": {
                        str(p.id): {
                            "name": p.name,
                            "type": p.type,
                            "size": p.size,
                            "pg_num": p.pg_num,
                            "erasure_code_profile": p.erasure_code_profile,
                            "stripe_width": p.stripe_width,
                        }
                        for p in m.pools.values()
                    },
                }
            ).encode(),
        )

    def _tick_down_out(self) -> None:
        """mon_osd_down_out_interval: an OSD that stays down for the
        interval is marked OUT so CRUSH remaps its data and recovery
        starts — without it a dead OSD's PGs stay degraded forever
        unless an operator runs `osd out` by hand.  <= 0 disables the
        sweep.

        The per-OSD grace is flap-dampened (a
        repeatedly-bouncing OSD earns backoff^(markdowns-1) times the
        base interval before its data is remapped — a genuinely dead
        OSD, with one markdown, still goes out at the base interval),
        and at most mon_osd_flap_max_auto_out_per_tick OSDs are outed
        per sweep — a rack-wide blip cannot rewrite the whole map in
        one epoch.  OSDs over budget keep their down-clock and go out
        on later ticks."""
        interval = float(self.mon.conf.get("mon_osd_down_out_interval"))
        budget = int(self.mon.conf.get("mon_osd_flap_max_auto_out_per_tick"))
        outed = 0
        now = time.monotonic()
        for oid, info in list(self.osdmap.osds.items()):
            if info.up or not info.in_:
                self._down_since.pop(oid, None)
                self._hold_logged.discard(oid)
                continue
            t0 = self._down_since.setdefault(oid, now)
            if interval <= 0:
                continue
            grace = self._down_out_grace(oid, now)
            if now - t0 < grace:
                if now - t0 >= interval:
                    # past the base interval but inside the dampened
                    # grace: the hold is the dampening WORKING, counted
                    # so chaos/tests can witness it
                    self.dampened_holds += 1
                    if oid not in self._hold_logged:
                        # one timeline entry per down episode: the
                        # "flap-dampened" step in the storm sequence
                        self._hold_logged.add(oid)
                        self._clog(
                            "info",
                            f"osd.{oid} down {now - t0:.0f}s; auto-out "
                            f"deferred by flap dampening "
                            f"(grace {grace:.0f}s, "
                            f"{self._recent_markdown_count(oid, now)} "
                            f"recent markdowns)",
                        )
                continue
            if budget > 0 and outed >= budget:
                continue  # churn cap: keep the clock, out it next tick
            self._down_since.pop(oid, None)
            self._hold_logged.discard(oid)
            outed += 1
            self.auto_outs_total += 1

            def mutate(m: OSDMap, oid=oid, grace=grace) -> str:
                m.set_osd_weight(oid, 0)
                self._auto_outed.add(oid)
                return f"osd.{oid} marked out after {grace:.0f}s down"

            dout("mon", 1, f"osd.{oid} down {now - t0:.0f}s >= "
                           f"{grace:.0f}s (dampened grace): marking out")
            self._queue(mutate, None)
            self._clog(
                "warn",
                f"osd.{oid} marked out after {grace:.0f}s down (auto-out)",
            )

    def _cmd_out(self, cmd, reply) -> None:
        osd = int(cmd["id"])

        def mutate(m: OSDMap) -> str:
            m.set_osd_weight(osd, 0)
            return f"osd.{osd} out"

        self._queue(mutate, lambda rv, rs: reply(rv, rs))

    def _cmd_in(self, cmd, reply) -> None:
        osd = int(cmd["id"])

        def mutate(m: OSDMap) -> str:
            from ..crush.crush import WEIGHT_ONE

            m.set_osd_weight(osd, WEIGHT_ONE)
            return f"osd.{osd} in"

        self._queue(mutate, lambda rv, rs: reply(rv, rs))

    def _cmd_reweight(self, cmd, reply) -> None:
        """`osd reweight <id> <weight>` — the balancer's knob
        (OSDMonitor reweight; weight in [0,1] scales CRUSH acceptance)."""
        osd = int(cmd["id"])
        weight = float(cmd["weight"])
        if not 0.0 <= weight <= 1.0:
            reply(-EINVAL, f"weight {weight} not in [0, 1]")
            return

        def mutate(m: OSDMap) -> str:
            from ..crush.crush import WEIGHT_ONE

            if osd not in m.osds:
                raise KeyError(f"osd.{osd} does not exist")
            m.set_osd_weight(osd, int(weight * WEIGHT_ONE))
            return f"osd.{osd} reweighted to {weight}"

        self._queue(mutate, lambda rv, rs: reply(rv, rs))

    def _cmd_snap_create(self, cmd, reply) -> None:
        """Allocate a self-managed snapshot id from the pool's snap_seq
        (OSDMonitor prepare_pool_op SELFMANAGED_SNAP_CREATE): the id is
        durable via paxos before any client uses it in a SnapContext."""
        import json as _json

        name = cmd["pool"]
        out: dict = {}

        def mutate(m: OSDMap) -> str:
            if name not in m.pool_name_to_id:
                raise KeyError(f"no such pool {name}")
            pool = m.pools[m.pool_name_to_id[name]]
            pool.snap_seq += 1
            out["snap_id"] = pool.snap_seq
            return f"created snap {pool.snap_seq} in {name}"

        self._queue(
            mutate,
            lambda rv, rs: reply(
                rv, rs, _json.dumps(out).encode() if rv == 0 else b""
            ),
        )

    def _cmd_pool_set(self, cmd, reply) -> None:
        """`osd pool set <pool> <var> <val>` (OSDMonitor prepare_command
        pool set).  pg_num changes remap existing objects and this
        framework has no PG-splitting data migration, so they require the
        caller to assert the pool is empty via `yes_i_really_mean_it`
        (the reference's own force-flag convention for dangerous pool
        mutations); the autoscaler defaults to warn-only mode for the
        same reason."""
        name = cmd["pool"]
        var = cmd["var"]
        val = cmd["val"]
        if var == "pg_num" and not cmd.get("yes_i_really_mean_it"):
            reply(
                -EINVAL,
                "pg_num changes move every object's placement and existing "
                "data is NOT migrated (no PG splitting); pass "
                "yes_i_really_mean_it for an empty pool",
            )
            return

        def mutate(m: OSDMap) -> str:
            pool = m.get_pool(name)
            if pool is None:
                raise KeyError(f"pool {name!r} does not exist")
            if var == "pg_num":
                pool.pg_num = int(val)
            elif var == "size":
                pool.size = int(val)
            elif var == "min_size":
                pool.min_size = int(val)
            elif var == "fast_read":
                pool.fast_read = str(val).lower() in ("1", "true", "yes")
            elif var == "target_max_objects":
                pool.target_max_objects = int(val)
            else:
                raise ValueError(f"unknown pool variable {var!r}")
            return f"set pool {name} {var} to {val}"

        self._queue(mutate, lambda rv, rs: reply(rv, rs))
