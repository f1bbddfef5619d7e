"""Chaos / recovery-under-load harness.

The port's copy of `ceph_tpu/tools/chaos.py`: it boots a real multi-OSD
vstart-style cluster (loopback messengers, live mon/mgr/OSD daemons on
in-memory BlueStore) and drives mixed client load while injecting the
failure modes the wired FaultInjector seams expose:

- probabilistic socket failures (`msgr.send`, the ms_inject_socket_
  failures analog) under lossless-policy resend,
- shard-read EIO bursts (`ec.sub_read`) driving EC redundant-read
  escalation and reconstruction,
- a gray-OSD phase: one OSD's shard reads are delayed ~50x
  (`ec.sub_read` delay_ms mode, scoped to the victim daemon) while its
  heartbeats stay on time — adaptive hedged reads keep client p99
  bounded under the injected delay, the laggy detector raises
  OSD_SLOW_PEER on exactly the victim and clears it when the delay
  lifts, and a healthy control window proves hedging is quiescent,
- device coding-launch failures (`codec.launch`) under client writes,
- a deep-scrub-under-load phase: silent shard corruption is planted on
  disk, every primary deep-scrubs (the device parity verify through the
  VerifyAggregator's background QoS lane) WHILE client writes keep
  flowing — the phase asserts the corruption is detected, that verify
  launches aggregated (fewer launches than objects), and that client
  p99 stayed within the QoS bound while the scrub stream ran,
- launch faults armed while depth > 1 encode launches are in flight,
- launch faults armed while the device crc32c and batched-compressor
  services have launches in flight under mixed load with
  `bluestore_csum_offload` switched on live — stored csums stay
  byte-identical to utils/crc32c, the offload_inflight mempool drains
  to zero, and client p99 stays bounded,
- an OSD flap (stop, degraded writes, restart on the old store) driving
  peering + recovery pushes,
- a whole-OSD recovery storm: an OSD dies for good, the mon's dampened
  down→out sweep remaps it, and every surviving primary's
  recovery-storm controller batches the flooded missing sets into
  cross-PG decode waves while mixed load keeps flowing — with
  recovery-path wedges (`ec.recover_push`, `peering.msg`) armed
  mid-storm; asserts the rebuild-time bound AND the client-p99 bound
  simultaneously, and wave batching (decode launches < objects
  recovered, witnessed by flight records),
- a flapping-OSD phase: rapid bounces accumulate markdown history, the
  dampened grace grows exponentially (map stays stable: zero
  auto-outs), then the same OSD dies for real and is still outed past
  the longer grace — dampening delays churn without orphaning data.

Where the reference's three launch-fault phases (3, 3.7 and 3.8) expect
every failed launch to be recomputed on the host, the port has no such
fallback (`ops/guard.py`): a failed launch fails its riders with EIO, the
backend goes DEGRADED, and the guard's probe heals it.  So here:

- a client write that answers -EIO while launch faults are armed, or
  while the backend is DEGRADED after them, is UNACKNOWLEDGED: it stays
  out of the acknowledged set, and at the end it must read back absent
  (-ENOENT) or exactly the bytes written (a write some shards committed
  rolls forward); any other error fails the run;
- a directly submitted encode, checksum or compressor ticket whose launch
  failed raises EIO (EcError) at its reap; every other ticket equals the
  host oracle, and a failed one, submitted again after the heal, equals
  it too;
- after each such phase the run waits for the guard's probe to heal the
  backend, and no launch is counted as a host fallback
  (`fallback_launches` and every `*.host_fallbacks` delta read 0).

The daemons, the codecs, the checksum and compressor services and the
aggregators run on `device` (`cuda` unless the caller names the CPU; the
guard's probe runs there too).  A device error is never retried or read
as a failed write: it ends the run (`main` exits DEVICE_ERROR_EXIT).

The run is SEEDED and deterministic in its decision sequence (payloads,
object names, injection arming order all come from one rng; socket-fault
draws use the injector's own fixed-seed rng), asserts convergence — all
PGs active+clean, every acked write readable byte-identical, health
clear of stuck SLOW_OPS and TPU_BACKEND_DEGRADED — and reports
machine-readable metrics pulled from the daemons' histograms: p99
client op latency, recovery launch occupancy, launch-fault counts,
messenger resends.

`--smoke` is the fast, seed-fixed variant the CPU tests run; the full
mode scales objects/rounds up:

    python -m ceph_tpu_torch.tools.chaos [--smoke] [--device cpu] [--out FILE]
"""

from __future__ import annotations

import argparse
import asyncio
import json
import random
import sys
import time

from ..common.errs import EIO
from ..ops.guard import is_device_error
from .guarded import exits_on_device_error
from .vstart import _free_port_addrs


def _osd_conf(i: int):
    from ..common.config import Config

    return Config(
        {
            "name": f"osd.{i}",
            # a real (in-memory) BlueStore, not MemStore: the offload
            # phase switches bluestore_csum_offload on live
            # and verifies the csums the store actually persisted
            "osd_objectstore": "bluestore",
            "osd_heartbeat_interval": 0.1,
            "osd_heartbeat_grace": 0.6,
            # tight deadline so an (injected) wedged launch falls back
            # within the run instead of riding the 20 s default
            "ec_tpu_launch_timeout_ms": 5000,
            "ec_tpu_probe_interval_ms": 200,
            # recovery-storm controller: engage at smoke
            # scale, small waves, quick stalled-push retry so the
            # armed ec.recover_push wedge self-heals within the run
            "osd_recovery_storm_min_objects": 6,
            "osd_recovery_storm_wave_objects": 8,
            "osd_recovery_storm_max_inflight": 24,
            "osd_recovery_storm_slo_target_ms": 2000.0,
            "osd_recovery_push_retry_sec": 0.5,
        },
        env=False,
    )


def _mon_conf(cfg: dict):
    """Mon config for the storm/flap phases: a fast tick,
    flap dampening armed, and the down→out sweep DISABLED until the
    storm phase arms it (runtime `conf.set`) — the early phases' flap
    must never race the auto-out."""
    from ..common.config import Config

    return Config(
        {
            "name": "mon.chaos",
            "mon_tick_interval": 0.2,
            "mon_osd_down_out_interval": 0.0,
            "mon_osd_flap_window": 120.0,
            "mon_osd_flap_backoff": 2.0,
            "mon_osd_flap_max_auto_out_per_tick": 2,
        },
        env=False,
    )


def _osd_complaint_default() -> float:
    from ..common.options import OPTIONS

    return float(OPTIONS["osd_op_complaint_time"].default)


async def _wait_until(pred, timeout: float, what: str) -> None:
    deadline = time.monotonic() + timeout
    while not pred():
        if time.monotonic() > deadline:
            raise TimeoutError(f"chaos: timed out waiting for {what}")
        await asyncio.sleep(0.02)


def _p99_from_histogram(dump: dict) -> float:
    """99th-percentile upper bound from a PerfHistogram.dump() payload
    (cumulative [le, count] buckets): the smallest bound covering >= 99%
    of samples.  inf means the tail spilled into the overflow bucket."""
    h = (dump or {}).get("histogram") or {}
    buckets = h.get("buckets") or []
    total = h.get("count") or 0
    if not total:
        return 0.0
    want = 0.99 * total
    for le, cum in buckets:
        if cum >= want:
            return float("inf") if le == "+Inf" else float(le)
    return float("inf")


async def _run(cfg: dict, device) -> dict:
    """The harness on `device` (a resolved torch.device: the daemons,
    the codecs and the offload services run there)."""
    from ..client import Rados
    from ..client.rados import RadosError
    from ..common.fault_injector import global_injector
    from ..mgr import Mgr
    from ..mon import MonMap, Monitor
    from ..ops import dispatch as ec_dispatch
    from ..ops.guard import device_guard
    from ..osd.osd import OSD

    rng = random.Random(cfg["seed"])
    inj = global_injector()
    report: dict = {
        "seed": cfg["seed"],
        "smoke": cfg["smoke"],
        "osds": cfg["osds"],
        "objects": cfg["objects"],
        "converged": False,
        "lost_writes": -1,
        "events": [],
    }
    # dynamic lock-order validation rides every chaos run:
    # the concurrent aggregator/scheduler/pipeline/cache stack under
    # faults is exactly where a latent ordering cycle would surface.
    # Violations are counted process-wide, so baseline for an embedded
    # run (a test process whose other cases raise some on purpose).
    from ..common import lockdep

    lockdep.enable()
    lockdep_violations0 = lockdep.violations()
    fallback0 = ec_dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
    guard = device_guard()
    degraded0 = guard.degraded_total
    probes0 = guard.probes
    # run-start baselines: the dispatch counters and flight recorder are
    # process-lifetime, and an embedded run (the smoke in a shared test
    # process) must not report OTHER tests' launches as chaos metrics
    decode0 = ec_dispatch.DECODE_LAUNCHES.snapshot()
    from ..ops.flight_recorder import flight_recorder

    flight_recorder().reset()
    # HBM mempool ledger: rebase the peaks so the reported
    # high-water mark is a property of THIS run, and so the end-of-run
    # leak assertion measures this run's drains
    from ..common.mempool import ledger as hbm_ledger

    hbm = hbm_ledger()
    hbm.reset_peaks()

    monmap = MonMap(addrs=_free_port_addrs(1))
    mons = [
        Monitor(n, monmap, election_timeout=0.3, conf=_mon_conf(cfg),
                device=device)
        for n in monmap.addrs
    ]
    for m in mons:
        await m.start()
    for m in mons:
        await m.wait_for_quorum()
    osds = [
        OSD(i, monmap, conf=_osd_conf(i), device=device)
        for i in range(cfg["osds"])
    ]
    for o in osds:
        await o.start()
    for o in osds:
        await o.wait_for_up()
    mgr = Mgr("x", monmap)
    mgr.beacon_interval = 0.1
    # progress module: per-PG recovery bars with rate/ETA ride
    # the digest; the harness reports how many events it observed so the
    # flap phase's recovery is visibly tracked end to end
    from ..mgr.progress import ProgressModule

    progress_mod = ProgressModule()
    mgr.register_module(progress_mod)
    # iostat module: per-pool/per-client rates + SLO burn
    # rates over short pinned windows so the mixed-load phase can
    # assert the burn stays under bound within a smoke-scale run.  The
    # latency target is the scrub QoS bound — generous for shared CI
    # hosts; the assertion catches seconds-scale starvation, not noise.
    from ..mgr.iostat import IostatModule

    iostat_mod = IostatModule(
        window_sec=2.0,
        slo_target_ms=cfg["slo_target_ms"],
        slo_fast_window_sec=0.5,
        slo_slow_window_sec=1.5,
    )
    mgr.register_module(iostat_mod)
    # metrics-history module: short pinned trend windows so
    # the sentinels genuinely EVALUATE inside a smoke-scale run (the
    # defaults would hold fire for 75 s) — a healthy converged chaos
    # run must end with history_sentinels_fired == 0.  The regression
    # ratio is pinned low and the volume floor high because chaos load
    # is deliberately bursty: the assertion exists to catch spurious
    # raises on phase transitions, not to benchmark.
    from ..mgr.metrics_history import MetricsHistoryModule

    history_mod = MetricsHistoryModule(
        window_sec=2.0,
        baseline_sec=6.0,
        regression_ratio=0.2,
        occupancy_ratio=0.2,
        queue_wait_factor=50.0,
        min_launch_rate=0.5,
    )
    mgr.register_module(history_mod)
    await mgr.start()
    await mgr.wait_for_active()
    progress_pgs_seen: set[tuple] = set()

    client = Rados(monmap)
    await client.connect()
    rv, rs, _ = await client.mon_command(
        {
            "prefix": "osd erasure-code-profile set",
            "name": "chaos21",
            "profile": ["k=2", "m=1", "plugin=tpu"],
        }
    )
    assert rv == 0, rs
    await client.pool_create(
        "chaospool", "erasure", profile="chaos21", pg_num=cfg["pg_num"]
    )
    io = await client.open_ioctx("chaospool")

    # cluster-event timeline: every fault point the harness
    # arms ships an `audit` entry through the mon's LogMonitor, exactly
    # like an operator command — the end-of-run asserts reconstruct the
    # run's story from `log last` output alone
    armed_points: list[str] = []

    async def _audit_arm(point: str, detail: str) -> None:
        armed_points.append(point)
        await client.objecter.monc.send_log([{
            "prio": "info", "channel": "audit", "who": "client.chaos",
            "seq": len(armed_points), "stamp": time.time(),
            "msg": f"from='client.chaos' cmd=fault-arm point={point} "
                   f"{detail}: dispatch",
        }])

    async def arm_prob(point: str, one_in: int) -> None:
        inj.inject_probabilistic(point, one_in)
        await _audit_arm(point, f"one_in={one_in}")

    async def arm(point: str, err: int, hits: int) -> None:
        inj.inject(point, err, hits=hits)
        await _audit_arm(point, f"err={err} hits={hits}")

    expected: dict[str, bytes] = {}
    # writes that answered -EIO under armed launch faults: never
    # acknowledged, so at the end each must read back absent or whole
    unacked: dict[str, bytes] = {}

    async def put(oid: str, nbytes: int, faults_armed: bool = False) -> bool:
        """Write `oid`; True once the write was ACKED.  With launch faults
        armed (or the backend DEGRADED after them) an -EIO answer is an
        unacknowledged write, False; any other error fails the run."""
        data = bytes(rng.getrandbits(8) for _ in range(nbytes))
        try:
            await io.write_full(oid, data)
        except RadosError as e:
            if not faults_armed or e.errno != -EIO:
                raise
            unacked[oid] = data
            return False
        expected[oid] = data  # recorded only once the write was ACKED
        return True

    async def healed(what: str) -> None:
        """Wait for the guard's probe to heal the backend after `what`'s
        launch faults (maybe_probe probes at most every probe interval
        and answers True once healthy)."""
        await _wait_until(guard.maybe_probe, cfg["converge_timeout"],
                          f"the device guard's probe to heal after {what}")

    # the guard's default probe runs where the launches go: on the CPU
    # for a CPU run (restored at the end)
    probe_device0 = guard.probe_device
    guard.probe_device = device.type
    try:
        # ---- phase 0: baseline load -------------------------------------
        for i in range(cfg["objects"]):
            await put(f"base{i}", 8192 + 512 * (i % 5))
        report["events"].append("baseline written")

        # ---- phase 1: socket faults under load --------------------------
        await arm_prob("msgr.send", cfg["sock_one_in"])
        for i in range(cfg["objects"] // 2):
            await put(f"sock{i}", 8192)
            back = await io.read(f"base{i % cfg['objects']}")
            assert back == expected[f"base{i % cfg['objects']}"]
        inj.clear("msgr.send")
        report["events"].append("socket-fault load survived")

        # ---- phase 1.5: workload attribution + SLO + budgeted tracing ---
        # Mixed multi-pool load (EC chaospool + a replicated pool) with
        # ALWAYS-ON sampled tracing: head rate 1%, a token-bucket span
        # budget, and a forced complaint-age op proving tail always-keep.
        # Asserts the three promises at once: per-pool rates
        # and p99 attribute the load, the SLO burn rate stays under
        # bound while the cluster is healthy, and span retention honors
        # the budget WITHOUT losing the slow op's trace.
        await client.pool_create(
            "chaosrep", "replicated", size=min(2, cfg["osds"]),
            pg_num=cfg["pg_num"],
        )
        io_rep = await client.open_ioctx("chaosrep")
        expected_rep: dict[str, bytes] = {}
        for o in osds:
            o.conf.set("jaeger_tracing_enable", True)
            o.conf.set("op_trace_sample_rate", cfg["trace_sample_rate"])
            o.conf.set("op_trace_budget_per_sec", cfg["trace_budget"])
        sample_t0 = time.monotonic()
        for i in range(cfg["objects"]):
            await put(f"mix{i}", 8192)
            data = bytes(rng.getrandbits(8) for _ in range(4096))
            await io_rep.write_full(f"rep{i}", data)
            expected_rep[f"rep{i}"] = data
            back = await io.read(f"base{i % cfg['objects']}")
            assert back == expected[f"base{i % cfg['objects']}"]
            if i % 4 == 0:
                iostat_mod.tick()
        # force complaint-age ops: with the complaint window at zero,
        # every op finishing counts as slow — its trace must be KEPT
        # whatever the 1% head rate said
        for o in osds:
            o.op_tracker.complaint_time = 0.0
        await put("slowmix", 8192)
        await io_rep.write_full("repslow", b"s" * 4096)
        for o in osds:
            o.op_tracker.complaint_time = _osd_complaint_default()
        sample_elapsed = time.monotonic() - sample_t0
        iostat_mod.tick()
        for o in osds:
            o.conf.set("jaeger_tracing_enable", False)
            o.conf.set("op_trace_sample_rate", 1.0)
            o.conf.set("op_trace_budget_per_sec", 0.0)
        stats = [o.tracer.sampling_stats() for o in osds]
        agg = {
            k: sum(s[k] for s in stats)
            for k in ("sampled", "unsampled", "dropped_budget",
                      "kept_tail", "retained_spans")
        }
        report["trace_sampling"] = agg
        # retention within the token-bucket budget: head-sampled traces
        # are the budget-charged ones, bounded per daemon by refill
        # over the phase plus one burst
        budget_bound = len(osds) * (
            cfg["trace_budget"] * sample_elapsed + cfg["trace_budget"] + 1
        )
        assert agg["sampled"] <= budget_bound, (
            f"chaos: {agg['sampled']} head-sampled traces exceeded the "
            f"budget bound {budget_bound:.0f}"
        )
        assert agg["unsampled"] >= 1, (
            "chaos: a 1% sample rate under mixed load sampled everything"
            f" ({agg})"
        )
        assert agg["kept_tail"] >= 1, (
            f"chaos: complaint-age ops lost their traces to sampling ({agg})"
        )
        # SLO burn under bound while healthy + per-pool p99 attribution
        report["slo_worst_burn_rate"] = round(
            iostat_mod.worst_burn_rate("slow"), 3
        )
        assert report["slo_worst_burn_rate"] <= cfg["slo_burn_bound"], (
            f"chaos: SLO burn rate {report['slo_worst_burn_rate']} over "
            f"the {cfg['slo_burn_bound']} bound during mixed load"
        )
        iostat_view = iostat_mod.iostat()
        report["pool_p99_ms"] = {
            rec["pool"]: rec["p99_ms"] for rec in iostat_view.values()
        }
        assert any(
            rec["ops_total"] > 0 for rec in iostat_view.values()
        ), "chaos: iostat attributed no ops to any pool"
        report["events"].append(
            "mixed-load attribution + SLO + sampled tracing held"
        )

        # ---- phase 2: shard-read EIO burst ------------------------------
        # counted hits so the run converges deterministically: early reads
        # eat the errors (redundant-read escalation reconstructs where a
        # survivor set remains; a read whose EVERY shard answered EIO is
        # correctly failed to the client and retried), later reads run
        # clean as the hit budget drains.  Only that -EIO is retried: any
        # other error fails the run, and a device error is never retried
        # (it is not a RadosError, so it passes this catch)
        await arm("ec.sub_read", 5, cfg["eio_hits"])
        eio_retries = 0
        for i in range(cfg["objects"] // 2):
            oid = f"base{i % cfg['objects']}"
            for _attempt in range(cfg["eio_hits"] + 2):
                try:
                    back = await io.read(oid)
                    break
                except RadosError as e:
                    if e.errno != -EIO:
                        raise
                    eio_retries += 1
            else:
                raise AssertionError(f"chaos: {oid} unreadable after EIO burst")
            assert back == expected[oid]
        inj.clear("ec.sub_read")
        report["eio_client_retries"] = eio_retries
        report["events"].append("EIO burst reconstructed")

        # ---- phase 2.5: gray OSD — hedged reads + laggy detection -------
        # The gray failure: one OSD heartbeats on time but
        # serves shard reads ~50x slow.  A healthy CONTROL window first
        # proves hedging is quiescent; then the victim's sub-reads are
        # delayed (delay_ms mode scoped to the victim daemon — its peers
        # stay fast), and the phase asserts the whole tolerance chain at
        # once: client read p99 stays UNDER the injected delay because
        # hedged/re-planned reads win, the victim — and ONLY the victim
        # — is detected laggy and surfaced as OSD_SLOW_PEER, the hedge
        # spend stays within the token-bucket budget, every read stays
        # byte-identical (no lost or doubled completions), and the laggy
        # state + health warn CLEAR once the delay lifts.
        from ..common.options import OPTIONS as _opts
        from ..osd.ec_backend import HEDGE_BURST
        from ..osd.pg_backend import shard_coll as _gray_coll

        chaos_primaries = [
            (o, pg)
            for o in osds
            if o._running
            for pg in o.pgs.values()
            if pg.pool.name == "chaospool" and pg.peering.is_primary()
        ]
        prim_count = {i: 0 for i in range(cfg["osds"])}
        for o, _pg in chaos_primaries:
            prim_count[o.whoami] += 1
        # a non-primary DATA-shard slot (acting[:k], k=2 for chaos21) is
        # where a gray peer actually hurts reads: normal whole-object
        # reads fetch exactly the k data shards
        data_member = {i: 0 for i in range(cfg["osds"])}
        for o, pg in chaos_primaries:
            for w in pg.acting()[:2]:
                if w != o.whoami:
                    data_member[w] += 1
        gray_id = min(
            (i for i in range(cfg["osds"]) if data_member[i] > 0),
            key=lambda i: (prim_count[i], -data_member[i], i),
        )
        gray_pgs = [
            (o, pg)
            for o, pg in chaos_primaries
            if o.whoami != gray_id and gray_id in pg.acting()[:2]
        ]
        assert gray_pgs, "chaos: gray victim serves no remote data shards"
        gray_oids = sorted(
            oid
            for o, pg in gray_pgs
            for oid in o.store.list_objects(
                _gray_coll(pg.pgid, pg.whoami_shard())
            )
            if oid in expected
        )[: 2 * cfg["objects"]]
        assert gray_oids, "chaos: no readable objects behind the gray victim"

        def _hedge_totals() -> dict[str, int]:
            return {
                k: sum(int(o.perf.get(k)) for o in osds if o._running)
                for k in ("ec_hedge_reads", "ec_hedge_wins",
                          "ec_hedge_denied")
            }

        hedge0 = _hedge_totals()
        for oid in gray_oids:  # control window: healthy reads
            assert await io.read(oid) == expected[oid]
        control = _hedge_totals()
        control_hedges = (
            control["ec_hedge_reads"] - hedge0["ec_hedge_reads"]
        )
        report["control_hedges"] = control_hedges
        assert control_hedges <= max(2, len(gray_oids) // 10), (
            f"chaos: healthy control window hedged {control_hedges} "
            f"times over {len(gray_oids)} reads"
        )
        # gray the victim: its sub-reads answer correctly but late
        inj.inject_delay(
            "ec.sub_read", cfg["gray_delay_ms"], who=f"osd.{gray_id}"
        )
        await _audit_arm(
            "ec.sub_read",
            f"delay_ms={cfg['gray_delay_ms']:.0f} who=osd.{gray_id}",
        )
        # priming reads: the first slow round trips are what the EWMA
        # laggy detector feeds on; reactive hedges keep even these fast
        # (the late losers land their RTT through the late-send ledger)
        for oid in gray_oids:
            assert await io.read(oid) == expected[oid]
        detectors = [
            o for o in osds if o._running and o.whoami != gray_id
        ]
        await _wait_until(
            lambda: any(gray_id in o.laggy_peers() for o in detectors),
            cfg["converge_timeout"],
            f"osd.{gray_id} to be detected laggy",
        )
        await _wait_until(
            lambda: gray_id in mons[0].osdmon.slow_peers(),
            cfg["converge_timeout"],
            "the mon to surface the laggy report",
        )
        slow = mons[0].osdmon.slow_peers()
        assert set(slow) == {gray_id}, (
            f"chaos: laggy detection fingered the wrong victim(s): "
            f"{sorted(slow)} (expected {{{gray_id}}})"
        )
        checks, _details = mons[0].health_checks()
        assert "OSD_SLOW_PEER" in checks, (
            f"chaos: no OSD_SLOW_PEER health warn ({sorted(checks)})"
        )
        assert f"osd.{gray_id}" in checks["OSD_SLOW_PEER"], (
            f"chaos: OSD_SLOW_PEER names the wrong victim: "
            f"{checks['OSD_SLOW_PEER']}"
        )
        # measured window: mixed load with the victim still gray — the
        # laggy deprioritization re-plans reads around it, so p99 must
        # land far under the injected delay
        gray_lat_s: list[float] = []
        for i in range(2 * len(gray_oids)):
            oid = gray_oids[i % len(gray_oids)]
            t0 = time.monotonic()
            back = await io.read(oid)
            gray_lat_s.append(time.monotonic() - t0)
            assert back == expected[oid], (
                f"chaos: {oid} corrupt while reading around the gray OSD"
            )
            if i % 4 == 0:
                await put(f"gray{i}", 8192)
        inj.clear("ec.sub_read")
        gray = _hedge_totals()
        gray_lat_s.sort()
        gray_p99_s = gray_lat_s[int(0.99 * (len(gray_lat_s) - 1))]
        gray_reads = len(gray_oids) + len(gray_lat_s)
        gray_hedges = (
            gray["ec_hedge_reads"] - control["ec_hedge_reads"]
        )
        report["gray_victim"] = gray_id
        report["gray_delay_ms"] = cfg["gray_delay_ms"]
        report["gray_reads"] = gray_reads
        report["gray_p99_ms"] = round(gray_p99_s * 1e3, 3)
        report["gray_hedges"] = gray_hedges
        report["gray_hedge_wins"] = (
            gray["ec_hedge_wins"] - hedge0["ec_hedge_wins"]
        )
        report["gray_hedge_denied"] = (
            gray["ec_hedge_denied"] - hedge0["ec_hedge_denied"]
        )
        report["hedge_rate"] = round(gray_hedges / max(1, gray_reads), 4)
        assert gray_hedges >= 1, "chaos: the gray window never hedged"
        assert report["gray_hedge_wins"] >= 1, (
            "chaos: no hedged read ever beat the gray straggler"
        )
        assert gray_p99_s * 1e3 <= cfg["gray_p99_bound_ms"], (
            f"chaos: gray-window read p99 {gray_p99_s * 1e3:.1f} ms "
            f"exceeded the {cfg['gray_p99_bound_ms']} ms bound (injected "
            f"delay {cfg['gray_delay_ms']:.0f} ms — hedging failed)"
        )
        # budget contract: spend is bounded by every primary backend's
        # burst plus the percent-of-subreads earn over the window
        # (k=2 sub-reads per read, plus the hedges themselves)
        pct = float(_opts["osd_ec_hedge_budget_percent"].default)
        budget_bound = HEDGE_BURST * len(chaos_primaries) + (
            pct / 100.0
        ) * (3 * gray_reads) + 1
        assert gray_hedges <= budget_bound, (
            f"chaos: {gray_hedges} hedges burst past the token-bucket "
            f"bound {budget_bound:.0f}"
        )
        # the delay lifted: laggy state and the health warn must CLEAR
        # (ping RTT keeps sampling the victim, decaying the EWMA through
        # the exit hysteresis; each reporter retracts, the mon retires)
        await _wait_until(
            lambda: all(
                gray_id not in o.laggy_peers() for o in detectors
            ),
            cfg["converge_timeout"],
            f"osd.{gray_id}'s laggy state to clear",
        )
        await _wait_until(
            lambda: "OSD_SLOW_PEER" not in mons[0].health_checks()[0],
            cfg["converge_timeout"], "OSD_SLOW_PEER to clear",
        )
        report["events"].append(
            f"gray osd.{gray_id} hedged around, detected laggy, cleared"
        )

        # ---- phase 3: device-launch faults fail their writes -----------
        # No host fallback: a failed encode launch answers its writes
        # -EIO (unacknowledged, checked at the end), the backend goes
        # DEGRADED, and the guard's probe heals it
        await arm("codec.launch", 5, cfg["launch_faults"])
        launch_unacked = 0
        for i in range(cfg["objects"] // 2):
            if not await put(f"launch{i}", 2 * 8192, faults_armed=True):
                launch_unacked += 1
        inj.clear("codec.launch")
        await healed("the write-path launch faults")
        report["degraded_entered"] = guard.degraded_total > degraded0
        report["launch_unacked_writes"] = launch_unacked
        report["events"].append(
            "launch faults failed their writes; backend healed"
        )

        # ---- phase 3.5: deep scrub under load (QoS) ----------------------
        # Plant silent shard corruption, then deep-scrub every primary
        # WHILE client writes keep flowing.  The scrub's parity verify
        # rides aggregated compare-only launches on the background QoS
        # lane, so the phase proves three things at once: the corruption
        # is DETECTED (integrity), verify launches COALESCE (fewer
        # launches than objects scrubbed), and client write p99 stays
        # within the configured bound (QoS actually works — scrub never
        # starves the client lane).
        from ..os.transaction import Transaction
        from ..osd.pg_backend import shard_coll

        verify0 = ec_dispatch.VERIFY_LAUNCHES.snapshot()
        primaries = [
            (o, pg)
            for o in osds
            if o._running
            for pg in o.pgs.values()
            if pg.pool.name == "chaospool" and pg.peering.is_primary()
        ]
        # victim: the first object of the first primary PG that has one,
        # corrupted on a non-primary acting shard (the write path never
        # sees it; only deep scrub can)
        victim_oid = victim_pg = None
        for o, pg in primaries:
            coll = shard_coll(pg.pgid, pg.whoami_shard())
            oids = sorted(o.store.list_objects(coll))
            if oids:
                victim_oid, victim_pg = oids[0], pg
                break
        assert victim_oid is not None, "chaos: no scrubable objects"
        acting = victim_pg.acting()
        bad_shard = next(
            s for s, w in enumerate(acting) if w != victim_pg.whoami()
        )
        bad_osd = next(o for o in osds if o.whoami == acting[bad_shard])
        coll = shard_coll(victim_pg.pgid, bad_shard)
        good_bytes = bad_osd.store.read(coll, victim_oid, 0, 0)
        bad_osd.store.queue_transaction(
            Transaction().write(
                coll, victim_oid, 0,
                bytes([good_bytes[0] ^ 0xFF]) + good_bytes[1:],
            )
        )
        scrub_results: list = []
        pending_scrubs = 0
        for _o, pg in primaries:
            if pg.scrub(deep=True, on_done=scrub_results.append):
                pending_scrubs += 1
        # client load WHILE the scrub stream runs, per-op latency sampled
        scrub_lat_s: list[float] = []
        i = 0
        while len(scrub_results) < pending_scrubs:
            t0 = time.monotonic()
            await put(f"scrubload{i}", 8192)
            scrub_lat_s.append(time.monotonic() - t0)
            i += 1
            if i > 500:  # scrub wedged: fail via the wait below
                break
        await _wait_until(
            lambda: len(scrub_results) >= pending_scrubs,
            cfg["converge_timeout"], "deep scrubs under load to finish",
        )
        detected = any(
            victim_oid in res.inconsistent
            and acting[bad_shard] in res.inconsistent[victim_oid]
            for res in scrub_results
        )
        assert detected, "chaos: planted shard corruption not detected"
        vdelta = ec_dispatch.VERIFY_LAUNCHES.snapshot()
        v_launches = vdelta["launches"] - verify0["launches"]
        v_stripes = vdelta["stripes"] - verify0["stripes"]
        assert v_launches >= 1, "chaos: scrub never reached the verify kernel"
        objects_scrubbed = sum(r.objects_scrubbed for r in scrub_results)
        assert v_launches < max(2, objects_scrubbed), (
            "chaos: verify launches did not aggregate "
            f"({v_launches} launches for {objects_scrubbed} objects)"
        )
        scrub_lat_s.sort()
        scrub_p99 = (
            scrub_lat_s[int(0.99 * (len(scrub_lat_s) - 1))]
            if scrub_lat_s else 0.0
        )
        report["scrub_p99_ms"] = round(scrub_p99 * 1e3, 3)
        report["scrub_errors_detected"] = sum(r.errors for r in scrub_results)
        report["verify_launches"] = v_launches
        report["verify_stripes"] = v_stripes
        report["scrub_objects"] = objects_scrubbed
        assert scrub_p99 * 1e3 <= cfg["scrub_p99_bound_ms"], (
            f"chaos: client p99 {scrub_p99 * 1e3:.1f} ms exceeded the "
            f"{cfg['scrub_p99_bound_ms']} ms QoS bound under deep scrub"
        )
        # repair + rebuild so the run still converges damage-free: the
        # detected inconsistency raises PG_DAMAGED until the repair
        # scrub re-queues the shard and recovery rewrites it
        repair_done: list = []
        assert victim_pg.scrub(
            deep=True, repair=True, on_done=repair_done.append
        )
        await _wait_until(lambda: bool(repair_done), cfg["converge_timeout"],
                          "repair scrub to finish")
        await _wait_until(
            lambda: bad_osd.store.read(coll, victim_oid, 0, 0) == good_bytes,
            cfg["converge_timeout"], "repair to rewrite the corrupt shard",
        )
        report["events"].append("deep scrub under load detected + repaired")

        # ---- phase 3.7: pipelined wedge -------------------------------
        # Launch faults armed while depth>1 launches are IN FLIGHT: every
        # ticket of a failed group raises EIO at its reap, WITHOUT losing
        # the other in-flight groups' tickets (each equals the host
        # oracle), the failed batches submitted again after the heal
        # equal it too, and the donation pool's per-slot refcounts must
        # never recycle a live buffer (the invariant gauge stays 0).  A
        # launch refused while DEGRADED never dispatches, so the first
        # half goes in healthy, and the faults are armed while those
        # groups are in flight: the second half's windows wait behind the
        # full ring (fused) and dispatch at the flush, with the first
        # half's launches still in flight.  The live OSDs' aggregators
        # get the depth through the runtime config observer — the knob
        # path itself is under test.
        import numpy as np

        from ..codec.interface import EcError
        from ..codec.matrix_codec import EncodeAggregator
        from ..codec.registry import instance as codec_registry

        def reaped(ticket):
            """A ticket's bytes, or None when its launch failed: the
            reap's EIO.  Any other error fails the run."""
            try:
                return np.asarray(ticket.result())
            except EcError as e:
                if e.errno != -EIO:
                    raise
                return None

        for o in osds:
            if o._running:
                o.conf.set("ec_tpu_pipeline_depth", 3)
        pipe0 = ec_dispatch.PIPELINE.snapshot()
        ec42 = codec_registry().factory(
            "tpu", {"k": "4", "m": "2"}, device=device
        )
        pagg = EncodeAggregator(window=2, pipeline_depth=2)
        nrng = np.random.default_rng(cfg["seed"] ^ 0x11)
        batches = [
            nrng.integers(0, 256, (2, 4, 4096), dtype=np.uint8)
            for _ in range(8)
        ]
        oracle = [ec42.encode_array_host(b) for b in batches]
        half = len(batches) // 2
        tickets = [pagg.submit(ec42, b) for b in batches[:half]]
        inflight_at_fault = (
            ec_dispatch.PIPELINE.snapshot()["inflight"] - pipe0["inflight"]
        )
        assert inflight_at_fault >= 2, (
            "chaos: the wedge's faults would land at depth "
            f"{inflight_at_fault}, not while depth>1 launches are in flight"
        )
        await arm("codec.launch", 5, 2)
        tickets += [pagg.submit(ec42, b) for b in batches[half:]]
        pagg.flush()
        inj.clear("codec.launch")
        failed = []
        for i, t in enumerate(tickets):
            got = reaped(t)
            if got is None:
                failed.append(i)
                continue
            assert np.array_equal(got, oracle[i]), (
                f"chaos: pipelined-wedge ticket {i} diverged from the host "
                "oracle"
            )
        assert failed, "chaos: the armed wedge failed no ticket"
        await healed("the pipelined wedge")
        again = [pagg.submit(ec42, batches[i]) for i in failed]
        pagg.flush()
        for i, t in zip(failed, again):
            got = reaped(t)
            assert got is not None and np.array_equal(got, oracle[i]), (
                f"chaos: wedge batch {i} submitted again after the heal "
                "diverged from the host oracle"
            )
        pipe1 = ec_dispatch.PIPELINE.snapshot()
        max_depth = max(
            (
                r.get("inflight_depth", 0)
                for r in flight_recorder().records()
                if r["kind"] == "encode"
            ),
            default=0,
        )
        assert max_depth >= 2, (
            f"chaos: pipelined wedge never reached depth>1 ({max_depth})"
        )
        recycled = (
            pipe1["donation_recycled_live"]
            - pipe0["donation_recycled_live"]
        )
        assert recycled == 0, (
            f"chaos: donation pool recycled {recycled} LIVE buffer(s)"
        )
        report["pipeline_wedge_tickets"] = len(tickets)
        report["pipeline_wedge_failed"] = len(failed)
        report["pipeline_inflight_at_fault"] = inflight_at_fault
        report["pipeline_max_inflight_depth"] = max_depth
        report["pipeline_drains"] = pipe1["drains"] - pipe0["drains"]
        report["donation_recycled_live"] = recycled
        report["events"].append(
            "pipelined wedge failed its groups' tickets; the rest and the "
            "resubmissions byte-identical"
        )

        # ---- phase 3.8: offload faults — csum + compressor -------------
        # Launch faults armed while the NON-EC offload services' launches
        # are in flight: the device crc32c service (BlueStore per-block
        # checksums, switched on live through the bluestore_csum_offload
        # observer — the knob path itself is under test) and the batched
        # device compressor.  An affected launch fails (EIO), never a
        # host recompute; every other launch is byte-identical — the csum
        # oracle IS utils/crc32c and the compressor's host transform is
        # the device transform's twin — so the phase proves it three ways
        # at once: directly-submitted tickets fail or match the host
        # oracle (and match it when submitted again after the heal), the
        # csums BlueStore actually STORED under fire equal crc32c of the
        # stored form, and compressed blobs round-trip.  Client writes
        # follow phase 3's rule.  The offload_inflight mempool must drain
        # to zero (EC-fusion tickets whose transactions were wire-encoded
        # are never consumed — the drain is what settles them), and
        # client p99 stays bounded while the faults land.
        from ..compressor import get_compressor
        from ..ops.checksum_offload import (
            crc32c_host_rows,
            default_csum_aggregator,
        )
        from ..compressor.device import default_compress_aggregator
        from ..ops.offload_runtime import offload_perf_dump
        from ..os.bluestore import BLOCK as BS_BLOCK
        from ..utils.crc32c import crc32c as host_crc32c

        off0 = offload_perf_dump()
        for o in osds:
            if o._running:
                o.conf.set("bluestore_csum_offload", True)
        csum_agg = default_csum_aggregator()
        crng = np.random.default_rng(cfg["seed"] ^ 0x20)
        csum_batches = [
            crng.integers(0, 256, (8, BS_BLOCK), dtype=np.uint8)
            for _ in range(4)
        ]
        dev_comp = get_compressor("device")
        comp_blocks = []
        for i in range(12):  # zero-heavy: the elision path really elides
            buf = bytearray(BS_BLOCK)
            buf[64 * (i % 8): 64 * (i % 8) + 16] = bytes(range(16))
            buf[0] = i + 1
            comp_blocks.append(bytes(buf))
        def compressed(blocks):
            """The device compressor's blobs for `blocks`, or None when
            its launch failed (EIO); any other error fails the run."""
            try:
                blobs = dev_comp.compress_batch(blocks, device)
            except EcError as e:
                if e.errno != -EIO:
                    raise
                return None
            assert all(
                dev_comp.decompress(blob) == blk
                for blob, blk in zip(blobs, blocks)
            ), "chaos: compressor blobs did not round-trip"
            assert all(
                blob == dev_comp.compress(blk)
                for blob, blk in zip(blobs, blocks)
            ), "chaos: compressor blobs diverged from the host form"
            return blobs

        def csums_failed(tickets, batches) -> list[int]:
            """Indices of the csum tickets whose launch failed; every
            other ticket must equal utils/crc32c."""
            failed = []
            for i, (t, b) in enumerate(zip(tickets, batches)):
                got = reaped(t)
                if got is None:
                    failed.append(i)
                else:
                    assert np.array_equal(got, crc32c_host_rows(b)), (
                        "chaos: csum ticket diverged from utils/crc32c"
                    )
            return failed

        await arm("codec.launch", 5, 2 + cfg["launch_faults"])
        csum_tickets = [
            csum_agg.submit_blocks(b, device) for b in csum_batches
        ]
        comp_blobs = compressed(comp_blocks)
        csum_failed = csums_failed(csum_tickets, csum_batches)
        # mixed client load while the remaining armed hits land on the
        # write path's OWN csum launches (and the read-backs' verify
        # recomputes), per-op latency sampled for the p99 bound
        off_lat_s: list[float] = []
        for i in range(cfg["objects"]):
            t0 = time.monotonic()
            acked = await put(f"offload{i}", 8 * BS_BLOCK, faults_armed=True)
            off_lat_s.append(time.monotonic() - t0)
            if not acked:
                continue  # read back at the end: absent or whole
            back = await io.read(f"offload{i}")
            assert back == expected[f"offload{i}"], (
                f"chaos: offload{i} corrupt under csum-offload faults"
            )
        inj.clear("codec.launch")
        await healed("the offload launch faults")
        # what failed under fire, submitted again after the heal
        assert not csums_failed(
            [csum_agg.submit_blocks(csum_batches[i], device)
             for i in csum_failed],
            [csum_batches[i] for i in csum_failed],
        ), "chaos: a csum batch failed again after the heal"
        if comp_blobs is None:
            assert compressed(comp_blocks) is not None, (
                "chaos: the compressor batch failed again after the heal"
            )
        # the csums BlueStore STORED under fire are the host oracle's:
        # walk every live store's offload-phase blocks and recompute
        checked_blocks = 0
        for o in osds:
            if not o._running:
                continue
            st = o.store
            for coll in sorted(st._colls):
                for oid in sorted(st.list_objects(coll)):
                    if not str(oid).startswith("offload"):
                        continue
                    on = st._get_onode(coll, oid)
                    for bidx in sorted(on.blocks):
                        poff, crc, clen = on.blocks[bidx]
                        stored = st._staged.get(poff)
                        if stored is None:
                            stored = st._block_read(
                                poff, clen if clen else BS_BLOCK
                            )
                        if not clen:
                            stored = stored.ljust(BS_BLOCK, b"\x00")
                        assert host_crc32c(stored) == crc, (
                            f"chaos: stored csum for {coll}/{oid} block "
                            f"{bidx} is not utils/crc32c of the stored "
                            "form"
                        )
                        checked_blocks += 1
        assert checked_blocks >= 8, (
            f"chaos: offload phase verified only {checked_blocks} stored "
            "blocks — the load never reached the csum-offload write path"
        )
        # settle the never-consumed EC-fusion tickets, then the
        # offload_inflight pool must hold ZERO bytes
        csum_agg.drain()
        default_compress_aggregator().drain()
        offload_leaked = hbm.current_bytes("offload_inflight")
        off1 = offload_perf_dump()
        for o in osds:
            if o._running:
                o.conf.set("bluestore_csum_offload", False)
        off_lat_s.sort()
        off_p99_s = (
            off_lat_s[int(0.99 * (len(off_lat_s) - 1))]
            if off_lat_s else 0.0
        )
        report["offload_csum_launches"] = (
            off1.get("csum.launches", 0) - off0.get("csum.launches", 0)
        )
        report["offload_csum_fallbacks"] = (
            off1.get("csum.host_fallbacks", 0)
            - off0.get("csum.host_fallbacks", 0)
        )
        report["offload_compress_fallbacks"] = (
            off1.get("compress.host_fallbacks", 0)
            - off0.get("compress.host_fallbacks", 0)
        )
        report["offload_csum_failed"] = len(csum_failed)
        report["offload_compress_failed"] = int(comp_blobs is None)
        report["offload_stored_blocks"] = checked_blocks
        report["offload_leaked_bytes"] = offload_leaked
        report["offload_p99_ms"] = round(off_p99_s * 1e3, 3)
        assert report["offload_csum_launches"] >= 1, (
            "chaos: the csum service never launched under the offload load"
        )
        assert report["offload_csum_fallbacks"] == 0, (
            "chaos: a csum launch was recomputed on the host"
        )
        assert report["offload_compress_fallbacks"] == 0, (
            "chaos: a compress launch was recomputed on the host"
        )
        assert report["offload_csum_failed"] >= 1, (
            "chaos: armed launch faults failed no csum ticket"
        )
        assert report["offload_compress_failed"] >= 1, (
            "chaos: armed launch faults failed no compressor batch"
        )
        assert offload_leaked == 0, (
            f"chaos: {offload_leaked} offload_inflight bytes leaked "
            f"after drain (reconcile: {hbm.reconcile()})"
        )
        assert off_p99_s * 1e3 <= cfg["offload_p99_bound_ms"], (
            f"chaos: client p99 {off_p99_s * 1e3:.1f} ms exceeded the "
            f"{cfg['offload_p99_bound_ms']} ms bound under offload faults"
        )
        report["events"].append(
            "offload faults failed their launches; the rest byte-identical"
        )

        # ---- phase 4: OSD flap + recovery -------------------------------
        victim_id = rng.randrange(cfg["osds"])
        victim = osds[victim_id]
        victim_store = victim.store
        await victim.stop()
        await _wait_until(
            lambda: not mons[0].osdmon.osdmap.is_up(victim_id),
            10.0,
            f"mon marking osd.{victim_id} down",
        )
        for i in range(cfg["objects"] // 2):
            await put(f"flap{i}", 8192)  # degraded writes
            oid = f"base{i % cfg['objects']}"
            assert await io.read(oid) == expected[oid]  # degraded reads
        revived = OSD(victim_id, monmap, conf=_osd_conf(victim_id),
                      store=victim_store, device=device)
        await revived.start()
        await revived.wait_for_up()
        osds[victim_id] = revived
        report["events"].append(f"osd.{victim_id} flapped")

        # ---- phase 5: whole-OSD recovery storm ----------------
        # A victim dies for good.  The mon's (dampened) down->out sweep
        # outs it — first markdown, so the base grace applies — CRUSH
        # fills its slots in place from the standing membership (the
        # cluster runs k+m+1 OSDs, so indep placement has a spare to
        # pull into each hole without disturbing survivor positions),
        # and every surviving primary's recovery-storm controller
        # batches the flooded missing sets into cross-PG decode waves
        # WHILE mixed client load keeps flowing.  Recovery-path wedges
        # (ec.recover_push, peering.msg) are armed mid-storm so the
        # stalled-push retry and the peering re-kick self-heal under
        # fire.  Asserts the storm's acceptance: rebuild-time bound
        # AND client-p99 bound simultaneously, decode launches <
        # objects recovered (wave batching witnessed by flight
        # records), and the whole-OSD bar was visible.
        def _primaries_clean() -> bool:
            return all(
                pg.is_clean
                for o in osds
                if o._running
                for pg in o.pgs.values()
                if pg.peering.is_primary()
            )

        # let the phase-4 flap's recovery settle before the kill so the
        # storm phase measures the FAILURE rebuild alone
        await _wait_until(_primaries_clean, cfg["converge_timeout"],
                          "pre-storm churn to settle")
        # arm the mon's down->out sweep NOW (it was off so the earlier
        # flap could never race an auto-out); from here on a dead OSD's
        # data is remapped after the (dampened) grace
        mons[0].conf.set(
            "mon_osd_down_out_interval", cfg["down_out_interval"]
        )
        def _ec_pgs_holding(osd_id: int) -> int:
            osdmap = mons[0].osdmon.osdmap
            ec_pool = osdmap.pools[osdmap.pool_name_to_id["chaospool"]]
            n = 0
            for ps in range(ec_pool.pg_num):
                _u, _up, acting, _p = osdmap.pg_to_up_acting_osds(
                    ec_pool.id, ps
                )
                if osd_id in acting:
                    n += 1
            return n

        # the storm victim: an original OSD (not the phase-4 flapper,
        # whose markdown history would dampen the auto-out) holding the
        # most EC shards, so the kill floods the widest missing set
        candidates = [i for i in range(cfg["osds"]) if i != victim_id]
        storm_victim_id = max(candidates, key=_ec_pgs_holding)
        assert _ec_pgs_holding(storm_victim_id) >= 1, (
            "chaos: no storm victim holds chaospool shards"
        )
        storm_victim = osds[storm_victim_id]
        decode_storm0 = ec_dispatch.DECODE_LAUNCHES.snapshot()
        # baselines over the SURVIVOR set: the victim's counters leave
        # the final sum with it, so including them here would undercount
        # the delta (earlier phases can legitimately engage storms)
        storm_objs0 = sum(
            o.recovery_storm.objects_admitted
            for o in osds
            if o._running and o.whoami != storm_victim_id
        )
        storm_waves0 = sum(
            o.recovery_storm.waves
            for o in osds
            if o._running and o.whoami != storm_victim_id
        )
        wave_recs0 = sum(
            1 for r in flight_recorder().records()
            if r["kind"] == "recovery_wave"
        )
        await storm_victim.stop()
        await arm("ec.recover_push", 5, 2)
        await arm("peering.msg", 5, 2)
        await _wait_until(
            lambda: not mons[0].osdmon.osdmap.is_up(storm_victim_id),
            10.0, f"mon marking osd.{storm_victim_id} down",
        )
        await _wait_until(
            lambda: not mons[0].osdmon.osdmap.osds[storm_victim_id].in_,
            max(20.0, 10 * cfg["down_out_interval"]),
            f"auto-out of dead osd.{storm_victim_id}",
        )
        t_out = time.monotonic()
        await _wait_until(
            lambda: not _primaries_clean(), 10.0,
            "the storm's re-peer/missing flood to become visible",
        )
        # mixed load WHILE the rebuild storms, per-op latency sampled
        # for the simultaneous client-p99 bound
        storm_lat_s: list[float] = []
        i = 0
        while not _primaries_clean() and i < 400:
            t0 = time.monotonic()
            await put(f"storm{i}", 8192)
            storm_lat_s.append(time.monotonic() - t0)
            oid = f"base{i % cfg['objects']}"
            back = await io.read(oid)
            assert back == expected[oid], f"chaos: {oid} lost mid-storm"
            i += 1
        await _wait_until(_primaries_clean, cfg["converge_timeout"],
                          "whole-OSD rebuild to complete")
        rebuild_seconds = time.monotonic() - t_out
        inj.clear("ec.recover_push")
        inj.clear("peering.msg")
        live = [o for o in osds if o._running]
        dec_storm = ec_dispatch.DECODE_LAUNCHES.snapshot()
        storm_launches = dec_storm["launches"] - decode_storm0["launches"]
        storm_objects = sum(
            o.recovery_storm.objects_admitted for o in live
        ) - storm_objs0
        storm_waves = sum(o.recovery_storm.waves for o in live) - storm_waves0
        wave_recs = sum(
            1 for r in flight_recorder().records()
            if r["kind"] == "recovery_wave"
        ) - wave_recs0
        push_retries = sum(
            getattr(pg.backend, "push_retries", 0)
            for o in live
            for pg in o.pgs.values()
        )
        storm_lat_s.sort()
        storm_p99 = (
            storm_lat_s[int(0.99 * (len(storm_lat_s) - 1))]
            if storm_lat_s else 0.0
        )
        report["rebuild_seconds"] = round(rebuild_seconds, 3)
        report["storm_p99_ms"] = round(storm_p99 * 1e3, 3)
        report["storm_waves"] = storm_waves
        report["storm_objects"] = storm_objects
        report["storm_decode_launches"] = storm_launches
        report["storm_wave_flight_records"] = wave_recs
        report["storm_push_retries"] = push_retries
        assert storm_waves >= 1, "chaos: no recovery-storm wave launched"
        assert wave_recs >= 1, (
            "chaos: storm waves left no flight records"
        )
        assert storm_objects >= 5, (
            f"chaos: storm recovered too few objects ({storm_objects}) "
            "to witness wave batching"
        )
        assert storm_launches < storm_objects, (
            f"chaos: decode launches ({storm_launches}) did not batch "
            f"below objects recovered ({storm_objects})"
        )
        assert rebuild_seconds <= cfg["storm_rebuild_bound_sec"], (
            f"chaos: whole-OSD rebuild took {rebuild_seconds:.1f}s, over "
            f"the {cfg['storm_rebuild_bound_sec']}s bound"
        )
        assert storm_p99 * 1e3 <= cfg["storm_p99_bound_ms"], (
            f"chaos: client p99 {storm_p99 * 1e3:.1f} ms exceeded the "
            f"{cfg['storm_p99_bound_ms']} ms bound during the storm"
        )
        # the storm victim stays dead+out: this framework keeps PG
        # logs/infos in memory, so a revived-after-reshuffle OSD would
        # rejoin with no interval history (the one case stray-shard
        # redirection cannot source) — the cluster runs k+m+2 OSDs so
        # both failure phases rebuild onto standing capacity instead
        report["events"].append("whole-OSD storm rebuilt under load")

        # ---- phase 6: flapping OSD vs mon dampening ----------------------
        # Rapid stop/start bounces accumulate markdowns; the dampened
        # down->out grace grows exponentially, so the map stays stable
        # (ZERO auto-outs) through the flaps — then the same OSD dies
        # for real, and the sweep still outs it past the (longer)
        # grace, proving dampening delays churn without ever orphaning
        # a genuinely dead OSD's data.
        auto_outs0 = mons[0].osdmon.flap_stats()["auto_outs_total"]
        flapper_id = max(
            (
                i for i in range(cfg["osds"])
                if i not in (victim_id, storm_victim_id)
            ),
            key=_ec_pgs_holding,
        )
        for _cycle in range(2):
            flapper = osds[flapper_id]
            fstore = flapper.store
            await flapper.stop()
            await _wait_until(
                lambda: not mons[0].osdmon.osdmap.is_up(flapper_id),
                10.0, f"mon marking flapping osd.{flapper_id} down",
            )
            flapper = OSD(flapper_id, monmap, conf=_osd_conf(flapper_id),
                          store=fstore, device=device)
            await flapper.start()
            await flapper.wait_for_up()
            osds[flapper_id] = flapper
        stats = mons[0].osdmon.flap_stats()
        report["flap_auto_outs"] = (
            stats["auto_outs_total"] - auto_outs0
        )
        fl = stats["osds"].get(flapper_id, {})
        report["flap_markdowns"] = fl.get("markdowns", 0)
        report["flap_grace_sec"] = fl.get("grace_sec", 0.0)
        assert report["flap_auto_outs"] == 0, (
            f"chaos: dampening failed — {report['flap_auto_outs']} "
            "auto-out(s) during the flap bounces"
        )
        assert report["flap_markdowns"] >= 2, (
            f"chaos: flap history lost ({report['flap_markdowns']})"
        )
        assert report["flap_grace_sec"] >= 2 * cfg["down_out_interval"], (
            f"chaos: dampened grace {report['flap_grace_sec']}s did not "
            f"grow past 2x the {cfg['down_out_interval']}s base"
        )
        # the genuinely dead case: the flapper dies for good — outed
        # past the dampened grace, and its data still rebuilds
        dead = osds[flapper_id]
        await dead.stop()
        await _wait_until(
            lambda: not mons[0].osdmon.osdmap.is_up(flapper_id),
            10.0, f"mon marking dead osd.{flapper_id} down",
        )
        t_dead = time.monotonic()
        await _wait_until(
            lambda: not mons[0].osdmon.osdmap.osds[flapper_id].in_,
            max(30.0, 20 * cfg["down_out_interval"]),
            "dead flapper's dampened auto-out",
        )
        dead_out_wait = time.monotonic() - t_dead
        report["flap_dead_out_wait_sec"] = round(dead_out_wait, 3)
        report["flap_dampened_holds"] = (
            mons[0].osdmon.flap_stats()["dampened_holds"]
        )
        assert dead_out_wait >= 1.5 * cfg["down_out_interval"], (
            f"chaos: dead flapper outed after {dead_out_wait:.1f}s — the "
            "dampened grace never applied"
        )
        await _wait_until(_primaries_clean, cfg["converge_timeout"],
                          "dead flapper's data to rebuild")
        report["events"].append("flap dampening held; dead OSD rebuilt")

        # ---- convergence ------------------------------------------------
        def all_clean() -> bool:
            # PG.progress_active() is the READ-ONLY predicate:
            # progress_status()'s episode bookkeeping belongs to the
            # OSD's own status reports, not a monitoring poll.  A SET of
            # distinct PGs (not a per-poll tally) so the reported count
            # is a property of the run, not of the poll frequency.
            progress_pgs_seen.update(
                (o.whoami, pg.pool.id, pg.ps)
                for o in osds
                if o._running
                for pg in o.pgs.values()
                if pg.progress_active()
            )
            return all(
                pg.is_clean
                for o in osds
                if o._running
                for pg in o.pgs.values()
                if pg.peering.is_primary()
            )

        await _wait_until(all_clean, cfg["converge_timeout"],
                          "all PGs active+clean")
        # the device guard must have healed (probe) by convergence time
        await _wait_until(
            guard.maybe_probe, 10.0, "device backend re-probe self-heal",
        )
        # health clear: no stuck SLOW_OPS, no TPU_BACKEND_DEGRADED
        def health_clear() -> bool:
            checks, _ = mons[0].health_checks()
            return (
                "SLOW_OPS" not in checks
                and "TPU_BACKEND_DEGRADED" not in checks
            )

        await _wait_until(health_clear, cfg["converge_timeout"],
                          "health clear of SLOW_OPS/TPU_BACKEND_DEGRADED")

        # ---- zero lost writes -------------------------------------------
        lost = 0
        for oid, data in expected.items():
            if await io.read(oid) != data:
                lost += 1
        for oid, data in expected_rep.items():
            if await io_rep.read(oid) != data:
                lost += 1
        report["lost_writes"] = lost
        report["converged"] = lost == 0
        # an unacknowledged write reads back absent, or whole where the
        # shards that committed it rolled it forward; never other bytes
        from ..common.errs import ENOENT

        rolled_forward = 0
        for oid, data in unacked.items():
            try:
                back = await io.read(oid)
            except RadosError as e:
                if e.errno != -ENOENT:
                    raise
                continue
            assert back == data, (
                f"chaos: unacknowledged write {oid} reads back "
                f"{len(back)} bytes that are not the {len(data)} written"
            )
            rolled_forward += 1
        report["unacked_writes"] = len(unacked)
        report["unacked_rolled_forward"] = rolled_forward
        assert report["unacked_writes"] >= 1, (
            "chaos: the armed launch faults failed no client write"
        )

        # ---- metrics (the PR-1 histogram substrate) ---------------------
        live = [o for o in osds if o._running]
        p99 = [
            _p99_from_histogram(o.perf.dump_histograms().get("op_latency"))
            for o in live
        ]
        # the tracked-metric aliases ROADMAP item 4 promotes into the
        # bench trajectory (PROGRESS/bench reporting reads these keys):
        # p99 in milliseconds, and recovery-launch occupancy = mean
        # stripes per aggregated decode launch (1.0 = no aggregation
        # benefit, higher = recovery coalesced).  A p99 in the
        # histogram's +Inf overflow bucket reports as null — json.dumps
        # would otherwise emit the non-RFC `Infinity` token and poison
        # every strict consumer of the --out file / bench fold.
        p99_max = max(p99) if p99 else 0.0
        if p99_max == float("inf"):
            report["p99_op_latency_sec"] = None
            report["chaos_p99_ms"] = None
        else:
            report["p99_op_latency_sec"] = p99_max
            report["chaos_p99_ms"] = round(p99_max * 1e3, 3)
        dec = ec_dispatch.DECODE_LAUNCHES.snapshot()
        d_launches = dec["launches"] - decode0["launches"]
        d_stripes = dec["stripes"] - decode0["stripes"]
        report["recovery_occupancy"] = round(
            d_stripes / d_launches, 3
        ) if d_launches else 0.0
        occ = [
            o.decode_aggregator.perf.get("launches") for o in live
        ]
        report["recovery_decode_launches"] = int(sum(occ))
        report["progress_events_seen"] = len(progress_pgs_seen)
        # flight-recorder summary: launches, mean queue-wait,
        # device occupancy over the chaos run (the recorder was reset at
        # run start, so these are run-relative)
        report["flight"] = flight_recorder().summary()
        report["fallback_launches"] = (
            ec_dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] - fallback0
        )
        assert report["fallback_launches"] == 0, (
            f"chaos: {report['fallback_launches']} launch(es) fell back to "
            "the host"
        )
        report["guard_degraded_total"] = guard.degraded_total - degraded0
        report["guard_probes"] = guard.probes - probes0
        # HBM ledger verdict: peak residency during the run
        # and ZERO leaked bytes once the EC pipelines drain — failed and
        # sticky-error launches released their holds too, or this
        # assertion names the bytes they kept
        from ..ops.offload_runtime import drain_all_aggregators

        drain_all_aggregators()
        report["hbm_peak_bytes"] = hbm.peak_total_bytes()
        hbm_leaked = (
            hbm.current_bytes("ec_pipeline_inflight")
            + hbm.current_bytes("verify")
            + hbm.current_bytes("offload_inflight")
        )
        report["hbm_leaked_bytes"] = hbm_leaked
        assert hbm_leaked == 0, (
            f"chaos: {hbm_leaked} HBM bytes leaked after drain "
            f"(reconcile: {hbm.reconcile()})"
        )
        report["msgr_resends"] = sum(
            o.msgr.resends + o.monc.msgr.resends for o in live
        ) + client.objecter.msgr.resends
        report["op_resends"] = int(client.objecter.perf.get("op_resend"))
        # trend-sentinel verdict: a healthy converged run
        # must not have fired TPU_THROUGHPUT_REGRESSION /
        # TPU_OCCUPANCY_COLLAPSE / TPU_QUEUE_WAIT_INFLATION — the
        # module sampled real MMgrReports the whole run with windows
        # short enough to actually evaluate (pinned above)
        report["history_sentinels_fired"] = history_mod.sentinels_fired
        report["history_sentinels_active"] = sorted(history_mod.sentinels)
        report["history_sentinel_raises"] = list(history_mod.sentinel_raises)
        report["history_store"] = history_mod.store.stats()
        assert report["history_sentinels_fired"] == 0, (
            f"chaos: trend sentinels fired on a healthy run: "
            f"{report['history_sentinels_active']} "
            f"(fired {report['history_sentinels_fired']}: "
            f"{report['history_sentinel_raises']})"
        )
        # the final snapshot re-waits health_clear: the metrics section
        # above takes long enough for one stale beacon (e.g. a status
        # blob sampled mid-probe) to transiently re-raise a check the
        # run already proved clear — capture a settled view, not a race
        await _wait_until(health_clear, 10.0,
                          "health to settle for the final snapshot")
        report["health_checks"] = mons[0].health_checks()[0]

        # ---- cluster-event timeline --------------------------
        # The run's story must be reconstructable from `log last` output
        # ALONE: pull the committed tail once, then derive every verdict
        # below from that single payload — no daemon introspection.
        rv, rs, out = await client.mon_command(
            {"prefix": "log last", "num": 1000}, timeout=10.0
        )
        assert rv == 0, f"chaos: log last failed: {rs}"
        clog_tail = json.loads(out)["entries"]
        rv, _, out = await client.mon_command(
            {"prefix": "log last", "num": 1000, "channel": "audit"},
            timeout=10.0,
        )
        assert rv == 0
        audit_tail = json.loads(out)["entries"]
        report["clog_entries"] = len(clog_tail)
        err_entries = [e for e in clog_tail if e.get("prio") == "error"]
        report["clog_errors"] = len(err_entries)
        # a healthy converged run carries NO error entries beyond the
        # ones the harness deliberately caused: the planted scrub
        # corruption (including the OSD_SCRUB_ERRORS health raise, when
        # the mon tick catches it before the repair clears it) and the
        # armed fault points.  A repeat-dedup marker inherits the
        # collapsed entry's prio, so an error-level "last message
        # repeated" stands for an already-allowed error.
        expected_err = ("inconsistent", "crc mismatch", "recovery of",
                        "backfill push", "RMW read", "encode launch",
                        "scrub errors", "last message repeated")
        unexpected = [
            e["msg"] for e in err_entries
            if not any(pat in e["msg"] for pat in expected_err)
        ]
        assert not unexpected, (
            f"chaos: unexpected ERR cluster-log entries: {unexpected}"
        )
        # every armed fault point produced an audit entry, and so did
        # the run's mutating mon commands (profile/pool creation)
        assert all(e.get("channel") == "audit" for e in audit_tail), (
            "chaos: `log last channel=audit` returned non-audit entries"
        )
        audit_msgs = [e["msg"] for e in audit_tail]
        for point in sorted(set(armed_points)):
            assert any(f"point={point}" in m for m in audit_msgs), (
                f"chaos: armed fault point {point} left no audit entry"
            )
        assert any("osd pool create" in m for m in audit_msgs), (
            "chaos: pool creation left no audit entry"
        )
        report["audit_entries"] = len(audit_tail)

        # storm-phase reconstruction: the ordered milestone subsequence
        # (down -> out -> engage -> wave -> complete for the storm
        # victim; down -> dampened hold -> out for the dead flapper)
        # must read straight out of the committed log, in order
        def _subsequence(entries, milestones, start=0):
            found, pos = [], start
            for label, pat in milestones:
                idx = next(
                    (j for j in range(pos, len(entries))
                     if pat in entries[j]["msg"]),
                    -1,
                )
                assert idx >= 0, (
                    f"chaos: timeline milestone {label!r} ({pat!r}) "
                    f"missing from the cluster log after index {pos}"
                )
                found.append(label)
                pos = idx + 1
            return found

        storm_timeline = _subsequence(clog_tail, [
            ("down", f"osd.{storm_victim_id} marked down"),
            ("out", f"osd.{storm_victim_id} marked out"),
            ("storm_engaged", "recovery storm ENGAGED"),
            ("wave", "recovery storm wave"),
            ("storm_complete", "recovery storm complete"),
        ])
        # the dead flapper's final down is its LAST markdown entry; the
        # dampened hold ("osd.N down Xs; auto-out deferred ...") and the
        # auto-out must follow it
        last_down = max(
            j for j, e in enumerate(clog_tail)
            if f"osd.{flapper_id} marked down" in e["msg"]
        )
        flap_timeline = ["down"] + _subsequence(clog_tail, [
            ("dampened", f"osd.{flapper_id} down"),
            ("out", f"osd.{flapper_id} marked out"),
        ], start=last_down + 1)
        report["storm_timeline"] = storm_timeline
        report["flap_timeline"] = flap_timeline
        report["events"].append("timeline reconstructed from cluster log")
        # lock-order verdict: zero violations is
        # part of convergence, and the observed ordering graph rides the
        # JSON so a run's lock hierarchy is inspectable after the fact
        report["lockdep_violations"] = (
            lockdep.violations() - lockdep_violations0
        )
        report["lockdep_graph"] = lockdep.graph_dump()
        assert report["lockdep_violations"] == 0, (
            f"lock-order violations during the chaos run: "
            f"{report['lockdep_violations']} (graph: "
            f"{report['lockdep_graph']})"
        )
        # round-over-round gating: fold the perf_compare
        # regressions slice against the port's BENCH_r*.json rounds
        # (chaos keys ride the bench rounds' `chaos` sub-object), so
        # the chaos trajectory is judged like the throughput one.
        # Guarded: a converged report must survive a compare fault.  The
        # broad catch stands because compare_round only parses JSON and
        # does no device work, so no device error can reach it.
        try:
            from .perf_compare import compare_round

            report["regressions"] = compare_round({"chaos": report})
        except Exception as e:
            from ..common.log import dout

            dout("chaos", 1, f"perf-compare fold failed: {e!r}")
            report["regressions"] = {"error": repr(e)}
    finally:
        inj.clear()
        guard.probe_device = probe_device0
        guard.mark_healthy()
        # the pipelined-wedge phase raised the process-wide default
        # aggregators' depth through the OSD observers — restore the
        # option default so an embedded run (the smoke inside a
        # shared test process) leaves no config behind
        from ..codec.matrix_codec import (
            default_decode_aggregator,
            default_encode_aggregator,
            default_verify_aggregator,
        )
        from ..common.options import OPTIONS

        depth_default = int(OPTIONS["ec_tpu_pipeline_depth"].default)
        for agg in (default_encode_aggregator(), default_decode_aggregator(),
                    default_verify_aggregator()):
            agg.configure(pipeline_depth=depth_default)
        await client.shutdown()
        await mgr.stop()
        for o in osds:
            if o._running:
                await o.stop()
        for m in mons:
            await m.stop()
        await asyncio.sleep(0.05)
    return report


def run_chaos(
    seed: int = 0xC405,
    smoke: bool = False,
    osds: int = 5,
    objects: int = 24,
    pg_num: int = 4,
    device=None,
) -> dict:
    """Run the harness to completion and return the report dict.  Raises
    (TimeoutError / AssertionError) when the cluster fails to converge —
    convergence IS the assertion — and a device error as it is.  The
    cluster and the offload services run on `device`: `cuda` unless the
    caller names another (no GPU raises)."""
    from ..codec import base

    dev = base.resolve_device(device)
    if smoke:
        # fast, seed-fixed variant: small but still crossing every
        # phase (sockets, EIO, launch faults, flap + recovery, whole-OSD
        # storm + flap dampening).  k+m+2 OSDs: BOTH failure phases
        # (storm victim, dead flapper) leave their OSD out for good and
        # rebuild onto standing capacity — CRUSH fills the holes from
        # the known membership, and the stray-shard redirection covers
        # the slot reshuffles the fill can cause.
        osds, objects, pg_num = 5, 8, 4
    cfg = {
        "seed": seed,
        "smoke": smoke,
        "osds": osds,
        "objects": objects,
        "pg_num": pg_num,
        "sock_one_in": 25,
        "eio_hits": 3 if smoke else 8,
        "launch_faults": 2 if smoke else 4,
        "converge_timeout": 30.0 if smoke else 90.0,
        # client write p99 bound while the deep-scrub verify stream runs
        # (the QoS acceptance gate).  Deliberately generous for shared
        # CI hosts — the assertion exists to catch scrub BLOCKING the
        # client lane (seconds-scale stalls), not to benchmark
        "scrub_p99_bound_ms": 2000.0 if smoke else 1000.0,
        # mixed-load gates: the pool latency SLO target (same
        # generosity rationale as the scrub bound — the burn-rate
        # assertion catches seconds-scale starvation, not CI noise),
        # the burn bound the mixed phase must stay under, and the
        # always-on trace sampling knobs (1% head rate + span budget)
        "slo_target_ms": 2000.0 if smoke else 1000.0,
        "slo_burn_bound": 1.0,
        "trace_sample_rate": 0.01,
        "trace_budget": 10.0,
        # storm/flap gates: the mon's down->out base interval
        # (kept small so the auto-out and the dampened grace both land
        # inside the run), the whole-OSD rebuild-time bound, and the
        # client p99 bound enforced SIMULTANEOUSLY with it.  Bounds are
        # generous for shared CI hosts — they catch a rebuild that
        # stalls or starves clients for seconds, not noise.
        "down_out_interval": 2.0 if smoke else 5.0,
        "storm_rebuild_bound_sec": 30.0 if smoke else 60.0,
        "storm_p99_bound_ms": 2000.0 if smoke else 1000.0,
        # gray-OSD gates: the injected sub-read delay (the
        # "~50x" gray multiplier against millisecond-scale healthy
        # reads) and the client read-p99 bound the hedged/re-planned
        # reads must beat.  The bound sits DELIBERATELY under the delay:
        # if hedging fails, every victim-shard read eats the full delay
        # and the assertion trips — it cannot pass vacuously.
        "gray_delay_ms": 3000.0,
        "gray_p99_bound_ms": 2000.0 if smoke else 1000.0,
        # offload-fault gate: client write p99 bound while
        # launch faults land on the csum/compressor services (same
        # generosity rationale — catches seconds-scale stalls, not noise)
        "offload_p99_bound_ms": 2000.0 if smoke else 1000.0,
    }
    return asyncio.run(_run(cfg, dev))


@exits_on_device_error("chaos")
def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="fast seed-fixed variant")
    ap.add_argument("--seed", type=int, default=0xC405)
    ap.add_argument("--osds", type=int, default=5)
    ap.add_argument("--objects", type=int, default=24)
    ap.add_argument("--pg-num", type=int, default=4)
    ap.add_argument("--out", default="",
                    help="also write the report JSON to this file")
    ap.add_argument("--device", default=None,
                    help="where the daemons' codecs and the offload services "
                         "run (default: cuda)")
    args = ap.parse_args(argv)
    try:
        report = run_chaos(
            seed=args.seed, smoke=args.smoke, osds=args.osds,
            objects=args.objects, pg_num=args.pg_num, device=args.device,
        )
    except Exception as e:
        # EVERY failure's payload must reach --out (not just the
        # convergence errors): a stale success report from a previous
        # run would otherwise be read as if this run had converged.  A
        # device error then ends the tool with DEVICE_ERROR_EXIT.
        payload = json.dumps({"converged": False, "error": repr(e)})
        if args.out:
            with open(args.out, "w") as f:
                f.write(payload)
        print(payload)
        if is_device_error(e):
            raise
        return 1
    payload = json.dumps(report, indent=2, sort_keys=True, default=str)
    if args.out:
        with open(args.out, "w") as f:
            f.write(payload)
    print(payload)
    return 0 if report.get("converged") else 1


if __name__ == "__main__":
    sys.exit(main())
