"""OSD daemon — mirror of src/osd/OSD.{h,cc} + src/ceph_osd.cc.

Structure mirrored from the reference (§3.3 of SURVEY.md):

- **Boot** (src/ceph_osd.cc:120): mount the object store, bind the
  messenger, announce to the monitors with MOSDBoot, subscribe to osdmap
  updates (the reference's `osd->init()` → `_send_boot`).
- **Map handling** (OSD::handle_osd_map → consume_map): full maps and
  incrementals advance the in-memory OSDMap; every PG whose acting set we
  appear in is created/advanced through a new peering interval.
- **Dispatch** (OSD::ms_fast_dispatch, OSD.cc:7244): backend sub-ops are
  fast-dispatched straight into the owning PG's backend (the reference
  bypasses the dispatch queue for exactly these); client MOSDOps are
  queued through the mClock/WPQ OpScheduler (enqueue_op/dequeue_op,
  OSD.cc:9431,9491) and run by the op worker.
- **Heartbeats** (handle_osd_ping OSD.cc:5463, heartbeat_check :5834):
  periodic MOSDPing to every up peer; peers that miss
  `osd_heartbeat_grace` seconds of replies are reported to the monitors
  with MOSDFailure, where the failure-quorum logic decides
  (OSDMonitor.cc:2791 prepare_failure).
- Cluster sends are ordered per peer through a single drain task — the
  per-connection ordering the reference gets from its one writer thread
  per AsyncConnection.

The port's copy of `ceph_tpu/osd/osd.py`.  `OSD(..., device=None)` runs
every PG's EC codec and the store's offloads on `device` (None: `cuda`,
which raises with no GPU; tests pass "cpu"); the status blob keeps the
reference's keys, `tpu_backend` reading the port's device guard and
`fallback_launches` 0 (nothing is recomputed on the host), `hbm_*` the
port's mempool ledger; `ec_tpu_shard_*` feed the sharded-dispatch policy
(parallel/dispatch.py), which splits a large launch over the CUDA
devices the process sees and never builds a mesh over one.  Where the port's daemon differs: it keeps a PG
it leaves as a stray for backend messages (ROADMAP C12), pings leave on
a heartbeat messenger of their own and a heartbeat tick that woke late
judges no peer (C14), placement is computed once for each set of
placement inputs and shared by the daemons of a process (`_placement`),
and the scrub timer also runs deep scrubs (`osd_deep_scrub_interval`),
and a device error that escapes `PG.do_op` is answered -EIO, where the
reference's op worker logs it and the client waits out its op (ROADMAP
C36).
"""

from __future__ import annotations

import asyncio
import random
import time

from ..common import tracer as tracer_mod
from ..common.clog import ClusterLogClient
from ..common.config import Config
from ..common.log import dout
from ..common.perf_counters import PerfCountersBuilder
from ..common.tracer import Tracer, null_span
from ..codec.base import resolve_device
from ..common.errs import EIO
from ..ops.guard import is_device_error
from ..mon.client import MonClient
from ..mon.monmap import MonMap
from ..msg.message import Message
from ..msg.messages import (
    MBackfillReserve,
    MOSDBoot,
    MOSDECSubOpRead,
    MOSDECSubOpReadReply,
    MOSDECSubOpWrite,
    MOSDECSubOpWriteReply,
    MOSDFailure,
    MOSDMap,
    MOSDOp,
    MOSDOpReply,
    MOSDPGLog,
    MOSDPGNotify,
    MOSDPGPull,
    MOSDPGPush,
    MOSDPGPushReply,
    MOSDPGQuery,
    MOSDPing,
    MOSDRepOp,
    MOSDRepOpReply,
    MOSDRepScrub,
    MOSDRepScrubMap,
    MWatchNotify,
    MMgrMap,
    MMgrReport,
    OSDOp,
    PgId,
    ReqId,
)
from ..msg.messenger import Connection, Dispatcher, Messenger, Policy
from .osdmap import PG_NONE, OSDMap, advance_map
from .pg import PG
from .reserver import Reserver
from .scheduler import SchedClass, WorkItem, make_scheduler

# Messages owned by a PG's backend (fast-dispatched, OSD.cc:7244).
BACKEND_MSGS = (
    MOSDECSubOpWrite,
    MOSDECSubOpWriteReply,
    MOSDECSubOpRead,
    MOSDECSubOpReadReply,
    MOSDRepOp,
    MOSDRepOpReply,
    MOSDPGPush,
    MOSDPGPushReply,
    MOSDPGPull,
)
PEERING_MSGS = (MOSDPGQuery, MOSDPGNotify, MOSDPGLog)
SCRUB_MSGS = (MOSDRepScrub, MOSDRepScrubMap)

# placement tables (OSD._placement): placement inputs ->
# {(pool, ps): pg_to_up_acting_osds}, the newest few
_PLACEMENTS: dict = {}


def _placement_inputs(osdmap: OSDMap) -> tuple:
    """What `pg_to_up_acting_osds` reads: the CRUSH map, each OSD's up
    state and weight, and each pool's type, size, pg_num and rule (the
    map's fsid too, so two clusters in one process never share)."""
    from ..common.encoding import Encoder

    enc = Encoder()
    osdmap.crush.encode(enc)
    return (
        osdmap.fsid,
        enc.tobytes(),
        tuple(sorted((o, i.up, i.weight) for o, i in osdmap.osds.items())),
        tuple(sorted((pid, p.type, p.size, p.pg_num, p.crush_rule)
                     for pid, p in osdmap.pools.items())),
    )

# laggy detection's absolute RTT floor: below this a peer is
# never laggy no matter how it compares to the median — an all-local toy
# mesh has microsecond RTTs where relative inflation is pure noise
LAGGY_RTT_FLOOR = 0.010


class OSD(Dispatcher):
    def __init__(
        self,
        whoami: int,
        monmap: MonMap,
        conf: Config | None = None,
        store=None,
        addr: str = "127.0.0.1:0",
        auth=None,  # CephxAuth; built from the `keyring` option when unset
        device=None,
    ):
        self.whoami = whoami
        self.monmap = monmap
        self.conf = conf or Config({"name": f"osd.{whoami}"})
        # every PG's codec, the store's offloads and the status blob's
        # device: `cuda` unless the caller names another; no GPU raises
        self.device = resolve_device(device)
        if store is not None:
            self.store = store
        else:
            from ..os.bluestore import make_store

            self.store = make_store(self.conf, device=self.device)
        self._bind_addr = addr
        if auth is None and self.conf.get("keyring"):
            from ..auth.cephx import CephxAuth
            from ..auth.keyring import KeyRing

            auth = CephxAuth.for_daemon(
                f"osd.{whoami}", KeyRing.load(self.conf.get("keyring"))
            )
        msgr_kw = dict(
            crc_data=self.conf.get("ms_crc_data"),
            inject_socket_failures=self.conf.get("ms_inject_socket_failures"),
            inject_internal_delays=self.conf.get("ms_inject_internal_delays"),
            dispatch_throttle_bytes=self.conf.get("ms_dispatch_throttle_bytes"),
            auth=auth,
            secure=self.conf.get("ms_secure"),
            compress=self.conf.get("ms_compress"),
            stack=self.conf.get("ms_type"),
        )
        self.msgr = Messenger(f"osd.{whoami}", **msgr_kw)
        self.msgr.default_policy = Policy.lossless_peer()
        # heartbeat pings leave on a messenger of their own, so they never
        # queue behind the bulk data of the cluster connection to the same
        # peer (Ceph's hb_back messengers); the peer answers on the
        # connection the ping came in on (ROADMAP C14)
        self.hb_msgr = Messenger(f"osd.{whoami}", **msgr_kw)
        self.monc = MonClient(
            f"osd.{whoami}",
            monmap,
            msgr=Messenger(f"osd.{whoami}", **msgr_kw),
        )
        # the ms_inject_* fault knobs are runtime-mutable (the chaos
        # harness arms them mid-run via injectargs/config set): changes
        # must reach BOTH live messengers, not just the next boot
        def _apply_ms_inject(name: str, v) -> None:
            for m in (self.msgr, self.hb_msgr, self.monc.msgr):
                if name == "ms_inject_socket_failures":
                    m.inject_socket_failures = int(v)
                else:
                    m.inject_internal_delays = float(v)

        self.conf.add_observer(
            ["ms_inject_socket_failures", "ms_inject_internal_delays"],
            _apply_ms_inject,
        )
        self.osdmap = OSDMap()
        self.pgs: dict[tuple[int, int], PG] = {}
        # PGs this OSD left the acting set of (ROADMAP C12, _advance_pgs)
        self.strays: dict[tuple[int, int], PG] = {}
        self._map_key = None  # the current map's key into _PLACEMENTS
        # op scheduler: the osd_mclock_* dmClock triples come from the
        # option table; any knob changing re-derives all three profiles
        # live
        def _mclock_profiles() -> dict:
            from .scheduler import ClientProfile

            return {
                SchedClass.CLIENT: ClientProfile(
                    reservation=self.conf.get("osd_mclock_client_res"),
                    weight=self.conf.get("osd_mclock_client_wgt"),
                    limit=self.conf.get("osd_mclock_client_lim"),
                ),
                SchedClass.RECOVERY: ClientProfile(
                    reservation=self.conf.get("osd_mclock_recovery_res"),
                    weight=self.conf.get("osd_mclock_recovery_wgt"),
                    limit=self.conf.get("osd_mclock_recovery_lim"),
                ),
            }

        self.sched = make_scheduler(
            self.conf.get("osd_op_queue"), profiles=_mclock_profiles()
        )

        def _apply_mclock(_n=None, _v=None) -> None:
            # update_profile, NOT a raw profiles.update(): the class's
            # tag chain must restart — a reservation of 0 stores
            # last.r = inf, and without the reset a later nonzero
            # reservation would compute max(now, inf + 1/res) forever
            if hasattr(self.sched, "update_profile"):
                for klass, prof in _mclock_profiles().items():
                    self.sched.update_profile(klass, prof)

        self.conf.add_observer(
            [
                f"osd_mclock_{lane}_{knob}"
                for lane in ("client", "recovery")
                for knob in ("res", "wgt", "lim")
            ],
            _apply_mclock,
        )
        self._sched_kick = asyncio.Event()
        b = PerfCountersBuilder(f"osd.{whoami}")
        for c in ("op", "op_r", "op_w", "op_in_bytes", "op_out_bytes",
                  "recovery_ops", "heartbeat_failures", "backfill_pushes",
                  # gray-failure tolerance: ops shed at
                  # admission / sub-reads shed shard-side after the
                  # deadline, and the hedged-read ledger (issued /
                  # joined-the-decode-set / budget-denied)
                  "op_deadline_shed", "subread_deadline_shed",
                  "ec_hedge_reads", "ec_hedge_wins", "ec_hedge_denied"):
            b.add_u64_counter(c)
        # latency distributions (PerfHistogram; the reference's
        # op_latency / op_w_latency_in_bytes_histogram family): log2
        # buckets so the prometheus export is a real histogram, not an
        # average that hides the tail
        b.add_histogram("op_latency", "client op dispatch->reply (s)")
        b.add_histogram_2d(
            "op_size_latency", "op payload bytes x dispatch->reply (s)"
        )
        b.add_histogram("ec_encode_latency", "EC encode launch->reap (s)")
        b.add_histogram("ec_decode_latency", "EC reconstruct decode (s)")
        # heartbeat ping + EC sub-read round-trips, aggregate; per-peer
        # osd_heartbeat_rtt_osd_<N> twins are declared lazily on first
        # sample (ensure_histogram) since peer membership is an osdmap
        # fact.  The osd_ prefix puts the scrape family at
        # ceph_tpu_osd_heartbeat_rtt_* — the name the docs index.
        b.add_histogram("osd_heartbeat_rtt", "peer ping/sub-read rtt (s)")
        self.perf = b.create_perf_counters()
        self.clog: list[str] = []
        # structured cluster-log client: batching + dedup +
        # rate limit in front of monc.send_log; every load-bearing
        # transition (DEGRADED/heal, HBM pressure, storm engage/shed/
        # disengage, scrub found/repaired) lands here, and the asok's
        # mutating commands audit through it
        self.clogc = ClusterLogClient(f"osd.{whoami}", send=self.monc.send_log)
        # last-seen transition state for the beacon-driven clog diffs
        self._clog_degraded = False
        self._clog_hbm_stage = 0
        self._pushed_config: set[str] = set()  # mon-managed option names
        # backfill reservation slots (AsyncReserver pair, OSDService):
        # local = backfills this OSD primaries, remote = slots granted to
        # other primaries targeting this OSD; both bound by
        # osd_max_backfills (runtime-mutable via the config push path).
        self.local_reserver = Reserver(
            lambda: self.conf.get("osd_max_backfills")
        )
        self.remote_reserver = Reserver(
            lambda: self.conf.get("osd_max_backfills")
        )
        # internal (OSD-as-client) reads for COPY_FROM source fetches
        self._internal_tid = 0
        self._internal_reads: dict[int, object] = {}
        # op tracking (TrackedOp.h OpTracker; dumped via the admin socket)
        from ..common.op_tracker import OpTracker

        # workload attribution: per-pool / per-client ops,
        # bytes and log2 latency histograms sampled on the op reply and
        # recovery paths; shipped in the status blob for the mgr iostat
        # module to merge into cluster-wide rates
        from ..common.io_accounting import IOAccountant

        self.io_accountant = IOAccountant()
        self.op_tracker = OpTracker(
            history_size=self.conf.get("osd_op_history_size")
        )
        self.op_tracker.complaint_time = self.conf.get("osd_op_complaint_time")
        # runtime-mutable: resize the history ring on config push
        self.conf.add_observer(
            ["osd_op_history_size"],
            lambda _n, v: self.op_tracker.resize_history(int(v)),
        )
        self.conf.add_observer(
            ["osd_op_complaint_time"],
            lambda _n, v: setattr(self.op_tracker, "complaint_time", float(v)),
        )
        # span tracer threaded through the EC data path (common/tracer.py;
        # the reference's ZTracer/jaeger integration, dumped via the admin
        # socket's `dump_tracer`)
        self.tracer = Tracer(
            f"osd.{whoami}", enabled=self.conf.get("jaeger_tracing_enable")
        )
        # the option is runtime-mutable: flips must reach the live tracer
        self.conf.add_observer(
            ["jaeger_tracing_enable"],
            lambda _n, v: setattr(self.tracer, "enabled", bool(v)),
        )
        # budgeted trace sampling: head-sampling rate + span
        # retention budget, runtime-mutable via the same observer
        # pattern — what makes always-on tracing safe at harness scale
        self.tracer.configure_sampling(
            sample_rate=self.conf.get("op_trace_sample_rate"),
            budget_per_sec=self.conf.get("op_trace_budget_per_sec"),
        )
        self.conf.add_observer(
            ["op_trace_sample_rate"],
            lambda _n, v: self.tracer.configure_sampling(sample_rate=float(v)),
        )
        self.conf.add_observer(
            ["op_trace_budget_per_sec"],
            lambda _n, v: self.tracer.configure_sampling(
                budget_per_sec=float(v)
            ),
        )
        # incoming trace-carrying messages get a messenger hop span
        # parent-linked to the sender (tracer.py inject/extract)
        self.msgr.tracer = self.tracer
        # EC encode/decode launch aggregation: this OSD's PGs share the
        # process-wide aggregators; apply the daemon's config to them and
        # keep them in sync on runtime sets (all four options are
        # runtime=True)
        from ..codec.matrix_codec import (
            default_decode_aggregator,
            default_encode_aggregator,
            default_verify_aggregator,
        )

        self.encode_aggregator = default_encode_aggregator()
        self.encode_aggregator.configure(
            window=self.conf.get("ec_tpu_aggregate_window"),
            max_bytes=self.conf.get("ec_tpu_aggregate_max_bytes"),
        )
        self.conf.add_observer(
            ["ec_tpu_aggregate_window"],
            lambda _n, v: self.encode_aggregator.configure(window=int(v)),
        )
        self.conf.add_observer(
            ["ec_tpu_aggregate_max_bytes"],
            lambda _n, v: self.encode_aggregator.configure(max_bytes=int(v)),
        )
        self.decode_aggregator = default_decode_aggregator()
        self.decode_aggregator.configure(
            window=self.conf.get("ec_tpu_decode_aggregate_window"),
            max_bytes=self.conf.get("ec_tpu_decode_aggregate_max_bytes"),
        )
        self.conf.add_observer(
            ["ec_tpu_decode_aggregate_window"],
            lambda _n, v: self.decode_aggregator.configure(window=int(v)),
        )
        self.conf.add_observer(
            ["ec_tpu_decode_aggregate_max_bytes"],
            lambda _n, v: self.decode_aggregator.configure(max_bytes=int(v)),
        )
        self.verify_aggregator = default_verify_aggregator()
        self.verify_aggregator.configure(
            window=self.conf.get("ec_tpu_verify_aggregate_window"),
            max_bytes=self.conf.get("ec_tpu_verify_aggregate_max_bytes"),
        )
        self.conf.add_observer(
            ["ec_tpu_verify_aggregate_window"],
            lambda _n, v: self.verify_aggregator.configure(window=int(v)),
        )
        self.conf.add_observer(
            ["ec_tpu_verify_aggregate_max_bytes"],
            lambda _n, v: self.verify_aggregator.configure(max_bytes=int(v)),
        )
        # launch-scheduler QoS profiles: the nine
        # ec_tpu_sched_* knobs map onto the three lanes' dmClock
        # triples; any one changing re-derives all three profiles (the
        # mClockScheduler config-observer pattern, reapplied to the
        # device launch queue)
        from ..ops.launch_scheduler import launch_scheduler
        from .scheduler import ClientProfile

        def _apply_sched_profiles(_n=None, _v=None) -> None:
            launch_scheduler().configure(**{
                lane: ClientProfile(
                    reservation=self.conf.get(f"ec_tpu_sched_{lane}_res"),
                    weight=self.conf.get(f"ec_tpu_sched_{lane}_wgt"),
                    limit=self.conf.get(f"ec_tpu_sched_{lane}_lim"),
                )
                for lane in ("client", "recovery", "background")
            })

        _apply_sched_profiles()
        self.conf.add_observer(
            [
                f"ec_tpu_sched_{lane}_{knob}"
                for lane in ("client", "recovery", "background")
                for knob in ("res", "wgt", "lim")
            ],
            _apply_sched_profiles,
        )
        # backpressure bound: both aggregators share the knob,
        # runtime-mutable like the window/byte-budget settings
        def _apply_inflight(v: int) -> None:
            self.encode_aggregator.configure(inflight_max_bytes=int(v))
            self.decode_aggregator.configure(inflight_max_bytes=int(v))

        _apply_inflight(self.conf.get("ec_tpu_inflight_max_bytes"))
        self.conf.add_observer(
            ["ec_tpu_inflight_max_bytes"], lambda _n, v: _apply_inflight(v)
        )
        # depth-N async launch pipeline: every aggregator
        # shares the in-flight ring bound, runtime-mutable like the
        # aggregation knobs
        def _apply_pipeline_depth(v: int) -> None:
            self.encode_aggregator.configure(pipeline_depth=int(v))
            self.decode_aggregator.configure(pipeline_depth=int(v))
            self.verify_aggregator.configure(pipeline_depth=int(v))

        _apply_pipeline_depth(self.conf.get("ec_tpu_pipeline_depth"))
        self.conf.add_observer(
            ["ec_tpu_pipeline_depth"],
            lambda _n, v: _apply_pipeline_depth(v),
        )
        # super-launch fusion + bucketed pad specialization:
        # every aggregator shares both knobs, runtime-mutable; shrinking
        # the bucket budget trims the now-dead pooled shapes in place
        def _apply_fuse_windows(v: int) -> None:
            self.encode_aggregator.configure(fuse_max_windows=int(v))
            self.decode_aggregator.configure(fuse_max_windows=int(v))
            self.verify_aggregator.configure(fuse_max_windows=int(v))

        def _apply_pad_buckets(v: int) -> None:
            self.encode_aggregator.configure(pad_buckets=int(v))
            self.decode_aggregator.configure(pad_buckets=int(v))
            self.verify_aggregator.configure(pad_buckets=int(v))

        _apply_fuse_windows(self.conf.get("ec_tpu_fuse_max_windows"))
        self.conf.add_observer(
            ["ec_tpu_fuse_max_windows"],
            lambda _n, v: _apply_fuse_windows(v),
        )
        _apply_pad_buckets(self.conf.get("ec_tpu_pad_buckets"))
        self.conf.add_observer(
            ["ec_tpu_pad_buckets"],
            lambda _n, v: _apply_pad_buckets(v),
        )
        # on-device RMW delta path: process-wide arm bit the
        # EC backend consults before trying the zero-copy delta encode
        from . import ec_backend as ec_backend_mod

        ec_backend_mod.configure_rmw_delta(
            bool(self.conf.get("ec_tpu_rmw_delta"))
        )
        self.conf.add_observer(
            ["ec_tpu_rmw_delta"],
            lambda _n, v: ec_backend_mod.configure_rmw_delta(bool(v)),
        )
        # device-resident chunk cache bound: the process-wide
        # HBM cache degraded reads / RMW read legs consult before H2D
        from ..ops.device_cache import device_chunk_cache

        device_chunk_cache().configure(
            max_bytes=self.conf.get("ec_tpu_device_cache_bytes")
        )
        self.conf.add_observer(
            ["ec_tpu_device_cache_bytes"],
            lambda _n, v: device_chunk_cache().configure(max_bytes=int(v)),
        )
        # HBM mempool ledger: call-site debug sharding and
        # the residency target the pressure layer trims against, both
        # runtime-mutable through the same observer plumbing
        from ..common.mempool import ledger as hbm_ledger

        hbm_ledger().configure(
            debug=self.conf.get("ec_tpu_mempool_debug"),
            target_bytes=self.conf.get("ec_tpu_hbm_target_bytes"),
        )
        self.conf.add_observer(
            ["ec_tpu_mempool_debug"],
            lambda _n, v: hbm_ledger().configure(debug=bool(v)),
        )
        self.conf.add_observer(
            ["ec_tpu_hbm_target_bytes"],
            lambda _n, v: hbm_ledger().configure(target_bytes=int(v)),
        )
        # flight recorder ring capacity: runtime-mutable like
        # the aggregation knobs; resizing keeps the newest records
        from ..ops.flight_recorder import flight_recorder

        flight_recorder().configure(
            capacity=self.conf.get("ec_tpu_flight_records")
        )
        self.conf.add_observer(
            ["ec_tpu_flight_records"],
            lambda _n, v: flight_recorder().configure(capacity=int(v)),
        )
        # device-launch watchdog (ops/guard.py): per-launch deadline +
        # degraded-mode re-probe cadence, runtime-mutable
        from ..ops.guard import device_guard

        device_guard().configure(
            timeout_ms=self.conf.get("ec_tpu_launch_timeout_ms"),
            probe_interval_ms=self.conf.get("ec_tpu_probe_interval_ms"),
        )
        self.conf.add_observer(
            ["ec_tpu_launch_timeout_ms"],
            lambda _n, v: device_guard().configure(timeout_ms=int(v)),
        )
        self.conf.add_observer(
            ["ec_tpu_probe_interval_ms"],
            lambda _n, v: device_guard().configure(probe_interval_ms=int(v)),
        )
        # device-offload runtime riders: the csum/compress
        # service aggregators share the bluestore_csum_offload_window /
        # _max_bytes knobs, and the BlueStore arm bit is runtime-mutable
        # through the store's setter — all three options runtime=True
        from ..compressor.device import default_compress_aggregator
        from ..ops.checksum_offload import default_csum_aggregator

        self.csum_aggregator = default_csum_aggregator()
        self.compress_aggregator = default_compress_aggregator()

        def _apply_offload_window(v: int) -> None:
            self.csum_aggregator.configure(window=int(v))
            self.compress_aggregator.configure(window=int(v))

        def _apply_offload_max_bytes(v: int) -> None:
            self.csum_aggregator.configure(max_bytes=int(v))
            self.compress_aggregator.configure(max_bytes=int(v))

        _apply_offload_window(self.conf.get("bluestore_csum_offload_window"))
        _apply_offload_max_bytes(
            self.conf.get("bluestore_csum_offload_max_bytes")
        )
        self.conf.add_observer(
            ["bluestore_csum_offload_window"],
            lambda _n, v: _apply_offload_window(v),
        )
        self.conf.add_observer(
            ["bluestore_csum_offload_max_bytes"],
            lambda _n, v: _apply_offload_max_bytes(v),
        )
        if hasattr(self.store, "set_csum_offload"):
            self.conf.add_observer(
                ["bluestore_csum_offload"],
                lambda _n, v: self.store.set_csum_offload(bool(v)),
            )
        # sharded-dispatch policy: the process-wide mesh fan-out knobs
        # ride the same config/observer plumbing as the aggregators
        from ..parallel import dispatch as shard_dispatch

        shard_dispatch.configure(
            min_batch=self.conf.get("ec_tpu_shard_min_batch"),
            devices=self.conf.get("ec_tpu_shard_devices"),
        )
        self.conf.add_observer(
            ["ec_tpu_shard_min_batch"],
            lambda _n, v: shard_dispatch.configure(min_batch=int(v)),
        )
        self.conf.add_observer(
            ["ec_tpu_shard_devices"],
            lambda _n, v: shard_dispatch.configure(devices=int(v)),
        )
        # recovery-storm controller: the cross-PG wave
        # orchestrator — engages when a whole-OSD failure floods the
        # missing sets, batches reconstruction decodes into mesh-wide
        # waves, and adapts admission to the local client burn rate.
        # Constructed after the reservers/aggregators/accountant it
        # coordinates; its knobs are re-read per tick (plus a ceiling
        # observer), so runtime config sets land immediately.
        from .recovery_controller import RecoveryStormController

        self.recovery_storm = RecoveryStormController(self)
        self.admin_socket = None
        # periodic-scrub schedule: pgid -> last periodic scrub kickoff
        self._last_periodic_scrub: dict = {}
        self._last_deep_scrub: dict = {}  # pgid -> last periodic deep kickoff
        # heartbeat state: peer -> last reply rx time
        self._hb_last_rx: dict[int, float] = {}
        self._hb_late = 0.0  # how late the last heartbeat tick woke (s)
        # every heartbeat tick's lateness summed (s), and its value when
        # each peer's grace last restarted (C14)
        self._hb_stalled = 0.0
        self._hb_stalled_at: dict[int, float] = {}
        self.heartbeat_stalls = 0  # ticks that judged no peer (C14)
        self._hb_first_tx: dict[int, float] = {}
        self._reported_failed: set[int] = set()
        self._last_failure_report: dict[int, float] = {}
        # laggy-OSD detection: per-peer RTT EWMA fed by ping
        # replies AND EC sub-read round-trips; peers past the slow-factor
        # threshold are flagged laggy — alive but slow, the gray failure
        # the markdown path cannot see — reported non-fatally to the mon
        # and deprioritized as EC sub-read sources
        self._peer_rtt_ewma: dict[int, float] = {}
        self._laggy_peers: set[int] = set()
        self._laggy_reported: dict[int, float] = {}  # peer -> last report
        # ordered cluster sends: addr -> queue + drain task
        self._out_q: dict[str, asyncio.Queue] = {}
        self._out_tasks: dict[str, asyncio.Task] = {}
        self._tasks: list[asyncio.Task] = []
        self._running = False
        self.up = False
        self.mgr_addr = ""  # active mgr (from the mgrmap subscription)
        self._mgrmap_epoch = 0

    # -- lifecycle -------------------------------------------------------------

    async def start(self) -> None:
        """Boot sequence (ceph_osd.cc main → OSD::init)."""
        # preload codec plugins (global_init_preload_erasure_code,
        # src/global/global_init.cc:593; option global.yaml.in:2541)
        from ..codec.registry import instance as ec_registry
        from ..common.log import dout as _dout

        for name in self.conf.get("osd_erasure_code_plugins").split():
            try:
                ec_registry().load(name)
            except Exception as e:
                _dout("osd", 1, f"osd.{self.whoami}: preload {name} failed: {e}")
        # preload object classes (ClassHandler::open_all_classes via
        # osd_class_load_list; others load lazily on first CALL)
        from ..cls.objclass import load_class

        for name in self.conf.get("osd_op_class_load_list").split():
            try:
                load_class(name)
            except Exception as e:
                _dout("osd", 1, f"osd.{self.whoami}: cls {name} failed: {e}")
        self.store.mount()
        await self.msgr.bind(self._bind_addr)
        self.msgr.add_dispatcher_head(self)
        self.hb_msgr.add_dispatcher_head(self)
        self.monc.on_osdmap = self._on_osdmap_msg
        self.monc.on_config = self._on_config_msg
        self._running = True
        self.monc.msgr.add_dispatcher_tail(self)  # mgrmap rides the mon conn
        await self.monc.subscribe("osdmap")
        await self.monc.subscribe("mgrmap")
        await self.monc.subscribe("config")
        await self._send_boot()
        await self._start_admin_socket()
        self._tasks.append(asyncio.create_task(self._op_worker()))
        self._tasks.append(asyncio.create_task(self._heartbeat_loop()))

    async def _start_admin_socket(self) -> None:
        """Daemon admin socket (AdminSocket::init): perf/config/trace/ops
        introspection, enabled by the `admin_socket` path option."""
        path = self.conf.get("admin_socket")
        if not path:
            return
        from ..common.admin_socket import AdminSocket

        sock = AdminSocket(path)
        # every MUTATING asok command lands on the audit channel:
        # injectargs fault arming, mark_unfound_lost, ... — the
        # operator's state-changing actions are part of the timeline
        sock.audit_cb = lambda prefix, cmd: self.cluster_log(
            "info",
            f"asok from='osd.{self.whoami}' cmd={prefix!r} "
            f"args={ {k: v for k, v in cmd.items() if k != 'prefix'} }",
            channel="audit",
        )
        # the OSD's encode/decode aggregators (the shared instances this
        # daemon configured at init) export their occupancy/launch-size
        # distributions alongside the daemon counters
        agg_perf = self.encode_aggregator.perf
        dec_perf = self.decode_aggregator.perf
        ver_perf = self.verify_aggregator.perf
        from ..ops import dispatch as ec_dispatch
        from ..ops.offload_runtime import (
            offload_perf_dump as _offload_perf_dump,
        )

        sock.register(
            "perf dump",
            lambda cmd: {
                **self.perf.dump(),
                "ec_aggregator": agg_perf.dump(),
                "ec_decode_aggregator": dec_perf.dump(),
                "ec_verify_aggregator": ver_perf.dump(),
                # process-wide launch counters incl. the sharded-launch /
                # devices-per-launch dimension and the launch-scheduler
                # per-class QoS counters (ops/dispatch.py)
                "ec_dispatch": ec_dispatch.perf_dump(),
                # offload-runtime service registry slice
                "offload": _offload_perf_dump(),
            },
            "dump perf counters",
        )
        sock.register("config show", lambda cmd: self.conf.show(),
                      "dump current config")
        sock.register("config diff", lambda cmd: self.conf.diff(),
                      "config values differing from defaults")
        sock.register(
            "dump_tracer",
            lambda cmd: {
                "spans": self.tracer.export(),
                "sampling": self.tracer.sampling_stats(),
            },
            "dump collected trace spans (EC data path) + sampling stats",
        )
        sock.register(
            "dump_io_accounting",
            lambda cmd: {
                "pools": self.io_accountant.dump_pools(),
                "clients": self.io_accountant.dump_clients(),
                "totals": self.io_accountant.totals(),
            },
            "per-pool / per-client cumulative IO counters + latency "
            "histograms (the iostat module's per-OSD input)",
        )
        sock.register(
            "dump_tracing",
            lambda cmd: {"traces": self.tracer.export_traces()},
            "spans grouped per trace id (cross-daemon op traces; "
            "client/messenger/dispatch/encode/codec stages)",
        )
        sock.register(
            "dump_histograms",
            lambda cmd: {
                **self.perf.dump_histograms(),
                "ec_aggregator": agg_perf.dump_histograms(),
                "ec_decode_aggregator": dec_perf.dump_histograms(),
                "ec_verify_aggregator": ver_perf.dump_histograms(),
            },
            "log2-bucketed latency (and size x latency) histograms",
        )
        def _pg_for_cmd(cmd):
            if "pool" not in cmd or "ps" not in cmd:
                raise ValueError("command requires args: pool, ps")
            pg = self.pgs.get((int(cmd["pool"]), int(cmd["ps"])))
            if pg is None:
                raise ValueError(f"no pg {cmd.get('pool')}.{cmd.get('ps')} here")
            return pg

        sock.register(
            "dump_blocked_ops",
            lambda cmd: {
                "pgs": {
                    repr(pg.pgid): blocked
                    for pg in self.pgs.values()
                    if (blocked := pg.blocked_ops_summary())
                }
            },
            "ops queued behind recovery / promotion / flush, per PG "
            "(pairs with list_unfound for stuck-op diagnosis)",
        )
        sock.register(
            "list_unfound",
            lambda cmd: {"unfound": _pg_for_cmd(cmd).list_unfound()},
            "missing objects with no live source (args: pool, ps)",
        )
        sock.register(
            "mark_unfound_lost",
            lambda cmd: {
                "lost": _pg_for_cmd(cmd).mark_unfound_lost(
                    cmd.get("mode", "delete")
                )
            },
            "give up on unfound objects: delete + release waiters "
            "(args: pool, ps[, mode=delete])",
            mutating=True,
        )
        def _injectargs(cmd: dict) -> dict:
            """injectargs-style runtime fault arming: the harness and the
            tests drive the SAME process-global FaultInjector hooks the
            data path checks (common/fault_injector.py catalog).

            Forms: {point, error?, hits?} arms a counted errno fault;
            {point, one_in} arms a probabilistic fault
            (ms_inject_socket_failures semantics); {point, delay_ms}
            arms a LATENCY fault — the seam stays functionally correct
            but slow, the gray-failure shape; {clear: true,
            point?} disarms one point or everything; {conf: {name:
            value}} additionally applies runtime config sets (the
            classic `injectargs '--opt val'` use)."""
            from ..common.fault_injector import FAULT_POINTS, global_injector

            inj = global_injector()
            if cmd.get("clear"):
                inj.clear(cmd.get("point"))
            elif "point" in cmd:
                point = cmd["point"]
                if point not in FAULT_POINTS:
                    raise ValueError(f"unregistered fault point {point!r}")
                if "one_in" in cmd:
                    inj.inject_probabilistic(point, int(cmd["one_in"]))
                elif "delay_ms" in cmd:
                    # `who` ("osd.3") scopes the latency to one daemon:
                    # the injector is process-global, a gray failure is
                    # one slow daemon among healthy ones
                    inj.inject_delay(
                        point, float(cmd["delay_ms"]),
                        hits=int(cmd.get("hits", -1)),
                        who=str(cmd.get("who", "")),
                    )
                else:
                    inj.inject(
                        point, int(cmd.get("error", 5)),
                        hits=int(cmd.get("hits", -1)),
                    )
            for name, value in (cmd.get("conf") or {}).items():
                self.conf.set(name, value)
            return {
                "armed": sorted(
                    p for p in FAULT_POINTS if inj.armed(p)
                ),
            }

        sock.register(
            "injectargs",
            _injectargs,
            "arm/clear fault-injection points + runtime config sets "
            "(args: point, error, hits, one_in, delay_ms, who, clear, conf)",
            mutating=True,
        )
        def _dump_flight(cmd: dict) -> dict:
            # the launch flight recorder (ops/flight_recorder.py): the
            # per-launch timeline behind the ec_dispatch counters.
            # `reset: true` rebases the ring + utilization window so a
            # bench stage can measure its own occupancy.
            from ..ops.flight_recorder import flight_recorder

            fr = flight_recorder()
            if cmd.get("reset"):
                fr.reset()
                return {"reset": True}
            return fr.dump()

        sock.register(
            "dump_flight",
            _dump_flight,
            "per-launch flight records: queue-wait + h2d/kernel/d2h "
            "sub-spans, device width, fallback/degraded/throttle flags "
            "(args: reset; export with tools/trace_export.py)",
        )
        def _dump_mempools(cmd: dict) -> dict:
            # the device mempool ledger (common/mempool.py):
            # per-pool current/peak bytes+buffers, per-device breakdown,
            # pressure state, and (in ec_tpu_mempool_debug mode) the
            # per-call-site shards.  `reset_peaks: true` rebases the
            # peak gauges, like the reference's mempool peak reset.
            from ..common.mempool import ledger as _hbm

            if cmd.get("reset_peaks"):
                _hbm().reset_peaks()
                return {"reset_peaks": True}
            return _hbm().dump()

        sock.register(
            "dump_mempools",
            _dump_mempools,
            "HBM mempool ledger: per-pool current/peak bytes+buffers, "
            "per-device breakdown, pressure state, call-site shards in "
            "debug mode (args: reset_peaks)",
        )
        sock.register(
            "dump_recovery_storm",
            lambda cmd: {
                "status": self.recovery_storm.status(),
                "perf": self.recovery_storm.perf_dump(),
            },
            "recovery-storm controller state: whole-OSD rebuild bar, "
            "wave/shed/ramp counters, live wave size + burn rate",
        )
        sock.register(
            "dump_historic_ops",
            lambda cmd: self.op_tracker.dump_historic(),
            "recently completed ops with events + per-stage durations "
            "(OpTracker)",
        )
        sock.register(
            "dump_historic_slow_ops",
            lambda cmd: self.op_tracker.dump_slow(),
            "slowest completed ops retained (OpTracker)",
        )
        sock.register(
            "dump_ops_in_flight",
            lambda cmd: {
                **self.op_tracker.dump_in_flight(),
                "pgs": {
                    repr(pg.pgid): sorted(
                        f"{c}:{t}" for c, t in pg._inflight_reqids
                    )
                    for pg in self.pgs.values()
                    if pg._inflight_reqids
                },
            },
            "in-flight client writes",
        )
        await sock.start()
        self.admin_socket = sock

    async def stop(self) -> None:
        try:
            # ship any batched clog entries before the messenger dies
            await asyncio.wait_for(self.clogc.flush(), timeout=0.5)
        except Exception as e:
            # best-effort: the mon may already be gone at shutdown
            dout("osd", 5, f"final clog flush failed: {e}")
        self._running = False
        for t in self._tasks + list(self._out_tasks.values()):
            t.cancel()
        self._tasks.clear()
        self._out_tasks.clear()
        if self.admin_socket is not None:
            await self.admin_socket.stop()
            self.admin_socket = None
        await self.msgr.shutdown()
        await self.hb_msgr.shutdown()
        await self.monc.shutdown()
        self.store.umount()

    async def _send_boot(self) -> None:
        """MOSDBoot broadcast to every mon (OSD::_send_boot; only the
        Paxos leader acts on it)."""
        boot = MOSDBoot(osd=self.whoami, addr=self.msgr.addr, epoch=self.osdmap.epoch)
        for name in self.monmap.ranks:
            try:
                await self.monc.msgr.send_to(self.monmap.addrs[name], boot)
            except ConnectionError:
                continue

    async def wait_for_up(self, timeout: float = 5.0) -> None:
        deadline = time.monotonic() + timeout
        while not self.up:
            if time.monotonic() > deadline:
                raise TimeoutError(f"osd.{self.whoami} never marked up")
            await asyncio.sleep(0.01)

    # -- osdmap handling -------------------------------------------------------

    def _on_osdmap_msg(self, msg: MOSDMap) -> None:
        """OSD::handle_osd_map: apply full maps / incrementals in epoch
        order, then advance the PGs."""
        old_map = self.osdmap
        self.osdmap = advance_map(self.osdmap, msg)
        self._map_key = None
        info = self.osdmap.osds.get(self.whoami)
        self.up = bool(info and info.up and info.addr == self.msgr.addr)
        # storm victim detection: an OSD leaving up+in across this
        # advance names the whole-OSD rebuild the controller conducts
        self.recovery_storm.note_osdmap(old_map, self.osdmap)
        self._restart_heartbeat_peers(old_map)
        self._advance_pgs()

    def _restart_heartbeat_peers(self, old_map: OSDMap) -> None:
        """The port's (ROADMAP C35): a peer the map marks down, or has
        come back up (another address or up epoch: a new instance),
        starts over, so its grace restarts from the first ping to that
        instance (C20), not from the last reply of the one before.  Ceph
        removes a down peer's HeartbeatInfo and adds a fresh one when it
        is up again (OSD::maybe_update_heartbeat_peers).  The reference
        keeps the old instance's last reply: a daemon that restarts
        within a few seconds is reported by its peers at their next tick
        and marked down again, and comes back with its PG logs empty."""
        for peer, info in self.osdmap.osds.items():
            old = old_map.osds.get(peer)
            if (
                info.up and old is not None and old.up and old.addr == info.addr
                and old.last_up_epoch == info.last_up_epoch
            ):
                continue
            for state in (self._hb_first_tx, self._hb_last_rx, self._hb_stalled_at,
                          self._last_failure_report):
                state.pop(peer, None)
            self._reported_failed.discard(peer)

    def _advance_pgs(self) -> None:
        """consume_map: create/advance every PG we participate in."""
        epoch = self.osdmap.epoch
        for pool in self.osdmap.pools.values():
            for ps in range(pool.pg_num):
                try:
                    _up, _upp, acting, _actp = self._placement(pool.id, ps)
                except Exception:
                    continue
                key = (pool.id, ps)
                if self.whoami in acting:
                    pg = self.pgs.get(key)
                    self.strays.pop(key, None)
                    if pg is None:
                        pg = self.pgs[key] = PG(
                            self, pool, ps, self.osdmap.erasure_code_profiles,
                            device=self.device,
                        )
                    else:
                        # Full-map decodes build fresh PgPool objects, and
                        # pool metadata mutates across epochs (cache-tier
                        # attach/overlay, target sizes): the PG must see
                        # the CURRENT pool, not its creation-time snapshot.
                        pg.pool = pool
                    pg.on_new_interval(epoch, acting)
                elif key in self.pgs:
                    # no longer in the acting set: the PG becomes a stray.
                    # It takes no peering or scrub message and no tick,
                    # but its backend still answers sub-reads and pushes:
                    # an EC primary reads a slot's chunks from the slot's
                    # last-clean holder while the new member rebuilds, and
                    # that holder may be an OSD marked out but running
                    # (ROADMAP C12).  Ceph keeps strays until the PG is
                    # clean; the port keeps one until this OSD rejoins the
                    # PG's acting set or stops.
                    self.strays[key] = self.pgs.pop(key)

    def _placement(self, pool_id: int, ps: int):
        """`pg_to_up_acting_osds` under the current map, computed once
        for each set of placement inputs.  CRUSH in Python takes
        milliseconds a PG, and a daemon maps every PG of every pool on
        every map, on the event loop that also answers heartbeats; a
        resubscribing daemon is sent the same full map again.  The table
        is keyed by everything placement reads (`_placement_inputs`), so
        its answers are the reference's, and the daemons of one process
        share it (`_PLACEMENTS`), as they share the aggregators."""
        key = self._map_key
        if key is None:
            key = self._map_key = _placement_inputs(self.osdmap)
        table = _PLACEMENTS.get(key)
        if table is None:
            table = _PLACEMENTS[key] = {}
            while len(_PLACEMENTS) > 8:
                _PLACEMENTS.pop(next(iter(_PLACEMENTS)))
        hit = table.get((pool_id, ps))
        if hit is None:
            hit = table[(pool_id, ps)] = self.osdmap.pg_to_up_acting_osds(pool_id, ps)
        return hit

    def _get_pg(self, pgid) -> PG | None:
        pg = self.pgs.get((pgid.pool, pgid.ps))
        if pg is not None:
            return pg
        # A peering message can arrive before our copy of the map does
        # (OSD::handle_pg_create path): create the PG shell on demand.
        pool = self.osdmap.pools.get(pgid.pool)
        if pool is None:
            return None
        try:
            _up, _upp, acting, _actp = self._placement(pool.id, pgid.ps)
        except Exception:
            return None
        if self.whoami not in acting:
            return None
        self.strays.pop((pgid.pool, pgid.ps), None)
        pg = self.pgs[(pgid.pool, pgid.ps)] = PG(
            self, pool, pgid.ps, self.osdmap.erasure_code_profiles,
            device=self.device,
        )
        pg.on_new_interval(self.osdmap.epoch, acting)
        return pg

    # -- mgr reporting ---------------------------------------------------------

    def ms_dispatch(self, conn: Connection, msg: Message) -> bool:
        if isinstance(msg, MMgrMap):
            if msg.epoch > self._mgrmap_epoch:
                self._mgrmap_epoch = msg.epoch
                self.mgr_addr = msg.active_addr
            return True
        return False

    def ms_handle_reset(self, conn: Connection) -> None:
        """A client session died: its watches evaporate and pending
        notifies stop waiting on it (Watch::remove on session reset)."""
        for pg in self.pgs.values():
            pg.on_client_reset(conn)

    def _send_mgr_report(self) -> None:
        """Periodic perf/status report to the active mgr
        (MgrClient::send_report)."""
        import json

        if not self.mgr_addr:
            return
        # the encode/decode aggregators' occupancy/launch-size histograms
        # ride the report (namespaced), so the mgr prometheus scrape
        # exports them like any daemon counter — not just the local
        # admin socket
        perf = dict(self.perf.dump())
        for name, val in self.encode_aggregator.perf.dump().items():
            perf[f"ec_aggregator.{name}"] = val
        for name, val in self.decode_aggregator.perf.dump().items():
            perf[f"ec_decode_aggregator.{name}"] = val
        for name, val in self.verify_aggregator.perf.dump().items():
            perf[f"ec_verify_aggregator.{name}"] = val
        # trace-sampling counters: sampled/kept/dropped +
        # live knobs ride the report flat so the scrape carries
        # ceph_tpu_trace_* families (rate/budget/pending are gauges,
        # the rest monotonic counters — mgr/prometheus._perf_type)
        for name, val in self.tracer.sampling_stats().items():
            perf[f"trace.{name}"] = val
        # recovery-storm controller counters/gauges: the
        # ceph_tpu_recovery_storm_* scrape families — wave/shed/ramp
        # totals plus the live wave size, in-flight depth, engagement
        # flag and local burn rate
        for name, val in self.recovery_storm.perf_dump().items():
            perf[f"recovery_storm.{name}"] = val
        # launch counters incl. sharded launches / devices-per-launch
        # (ops/dispatch.py): flat scalars, so the mgr prometheus scrape
        # exports one ceph_tpu_ec_dispatch_* family per counter
        from ..ops import dispatch as ec_dispatch

        for name, val in ec_dispatch.perf_dump().items():
            perf[f"ec_dispatch.{name}"] = val
        # device-offload runtime services: one flat
        # <service>.<counter> slice per registered rider (csum, compress,
        # plus the EC trio), exported as ceph_tpu_offload_* families
        from ..ops.offload_runtime import offload_perf_dump

        for name, val in offload_perf_dump().items():
            perf[f"offload.{name}"] = val
        # launch-scheduler QoS counters under their canonical prometheus
        # prefix: aliases of the sched.* slice the dispatch
        # loop above just exported, re-namespaced so the scrape renders
        # ceph_tpu_ec_sched_<class>_<counter> families.  Copied from the
        # snapshot already in `perf` — a second perf_dump() here could
        # disagree with its own alias within one report
        for name, val in list(perf.items()):
            if name.startswith("ec_dispatch.sched."):
                perf["ec_sched." + name[len("ec_dispatch.sched."):]] = val
        # device-utilization accounting under its canonical prometheus
        # names: aliases of the flight-derived scalars the
        # perf_dump() loop above just computed — one utilization
        # snapshot per report, two export names
        perf["ec_device_busy_seconds"] = perf["ec_dispatch.device_busy_seconds"]
        perf["ec_device_occupancy"] = perf["ec_dispatch.device_occupancy"]
        status = _osd_status(self)
        self._clog_transitions(status)
        self._send_addr(
            self.mgr_addr,
            MMgrReport(
                daemon=f"osd.{self.whoami}",
                perf=json.dumps(perf).encode(),
                status=json.dumps(status).encode(),
            ),
        )

    # -- dispatch --------------------------------------------------------------

    def ms_can_fast_dispatch(self, msg: Message) -> bool:
        return isinstance(
            msg,
            BACKEND_MSGS
            + PEERING_MSGS
            + SCRUB_MSGS
            + (MOSDPing, MOSDOp, MBackfillReserve, MWatchNotify, MOSDOpReply),
        )

    def ms_fast_dispatch(self, conn: Connection, msg: Message) -> None:
        if isinstance(msg, MOSDPing):
            self._handle_ping(conn, msg)
            return
        if isinstance(msg, MOSDOp):
            if msg.reqid.client in self.osdmap.blocklist:
                # fenced client (OSDMap blocklist): its ops bounce with
                # -EBLOCKLISTED so in-flight writers cannot land bytes
                # after a failover fenced them (rbd-mirror / MDS eviction)
                from ..common.errs import ESHUTDOWN

                rep = MOSDOpReply(
                    reqid=msg.reqid,
                    result=-ESHUTDOWN,
                    outdata=[],
                    version=0,
                    epoch=self.osdmap.epoch,
                )

                async def _send(c=conn, r=rep):
                    try:
                        await c.send_message(r)
                    except ConnectionError:
                        pass

                asyncio.get_event_loop().create_task(_send())
                return
            self._enqueue_op(conn, msg)
            return
        if isinstance(msg, MBackfillReserve):
            self._handle_backfill_reserve(msg)
            return
        if isinstance(msg, MWatchNotify):
            pg = self._get_pg(msg.pgid)
            if pg is not None and msg.is_ack:
                pg.handle_watch_ack(msg)
            return
        if isinstance(msg, MOSDOpReply):
            # reply to an internal op (COPY_FROM source fetch)
            entry = self._internal_reads.pop(msg.reqid.tid, None)
            if entry is not None:
                cb, multi = entry
                if multi:
                    cb(msg.result, list(msg.outdata))
                else:
                    cb(msg.result, msg.outdata[0] if msg.outdata else b"")
            return
        pg = self._get_pg(msg.pgid)
        if pg is None:
            stray = self.strays.get((msg.pgid.pool, msg.pgid.ps))
            if stray is not None and isinstance(msg, BACKEND_MSGS):
                stray.backend.handle_message(msg)
                return
            dout("osd", 5, f"osd.{self.whoami}: no pg for {msg.pgid}, dropping {msg!r}")
            return
        if isinstance(msg, PEERING_MSGS):
            pg.handle_peering_message(msg)
        elif isinstance(msg, SCRUB_MSGS):
            pg.handle_scrub_message(msg)
        else:
            pg.backend.handle_message(msg)

    def _handle_backfill_reserve(self, msg: MBackfillReserve) -> None:
        """Target side grants/releases remote slots; primary side routes
        replies to the PG (OSD::handle_pg_backfill_reserve)."""
        key = msg.pgid.key()
        if msg.op == MBackfillReserve.REQUEST:
            granted = self.remote_reserver.try_reserve(key)
            self.send_cluster(
                msg.from_osd,
                MBackfillReserve(
                    pgid=msg.pgid,
                    op=MBackfillReserve.GRANT
                    if granted
                    else MBackfillReserve.REJECT,
                    epoch=msg.epoch,
                    from_osd=self.whoami,
                ),
            )
        elif msg.op == MBackfillReserve.RELEASE:
            self.remote_reserver.release(key)
        else:  # GRANT / REJECT -> the requesting primary's PG
            pg = self._get_pg(msg.pgid)
            if pg is not None:
                pg.on_backfill_reserve(msg)

    # -- client ops through the scheduler --------------------------------------

    def _enqueue_op(self, conn: Connection, msg: MOSDOp) -> None:
        """enqueue_op (OSD.cc:9431): into the QoS scheduler."""
        from .pg import op_class_of

        cost = sum(len(op.data) for op in msg.ops) or 4096
        self.perf.inc("op")
        op_class = op_class_of(msg.ops)
        # OpTracker registration (OpRequest created at dispatch,
        # TrackedOp::mark_event through the pipeline) with the
        # attribution tags: pool, client, op class.
        # UNCONDITIONAL — trace sampling gates span retention only, so
        # a sampled-out op still ages into SLOW_OPS accounting.
        token = self.op_tracker.create(
            f"osd_op({msg.reqid.client}:{msg.reqid.tid} "
            f"{msg.pgid.pool}.{msg.pgid.ps} {msg.oid} "
            f"[{','.join(str(op.op) for op in msg.ops)}])",
            pool_id=msg.pgid.pool,
            client=msg.reqid.client,
            op_class=op_class,
        )
        # op span: child of the messenger hop span when the delivery is
        # being traced, else adopted from the message's remote context
        # (OpRequest's osd_trace in the reference)
        span = self.tracer.start_span(
            "osd:op",
            parent=tracer_mod.current_span(),
            remote=tracer_mod.extract(msg),
        )
        span.keyval("oid", msg.oid)
        span.keyval("reqid", lambda: msg.reqid.key())
        span.event("queued")

        def run() -> None:
            self.op_tracker.mark_event(token, "dequeued")
            span.event("dequeued")
            with tracer_mod.span_scope(span):
                self._do_dispatch_op(
                    conn, msg, token, span=span, cost=cost,
                    op_class=op_class,
                )

        self.sched.enqueue(
            WorkItem(
                run=run, klass=SchedClass.CLIENT, cost=cost,
                priority=int(self.conf.get("osd_client_op_priority")),
            )
        )
        self._sched_kick.set()

    def _do_dispatch_op(
        self, conn: Connection, msg: MOSDOp, token: int = 0, span=None,
        cost: int | None = None, op_class: str | None = None,
    ) -> None:
        """dequeue_op (OSD.cc:9491) → PG::do_op."""
        pg = self._get_pg(msg.pgid)
        op_span = span if span is not None else null_span()
        t0 = time.monotonic()
        if cost is None:
            cost = sum(len(op.data) for op in msg.ops) or 4096
        if op_class is None:
            from .pg import op_class_of

            op_class = op_class_of(msg.ops)

        def reply(rep: MOSDOpReply) -> None:
            self.op_tracker.finish(token)
            lat = time.monotonic() - t0
            self.perf.hinc("op_latency", lat)
            self.perf.hinc2("op_size_latency", cost, lat)
            # workload attribution: writes account their
            # payload bytes, reads what they returned.  -EAGAIN bounces
            # (misdirected / not-yet-peered) are NOT accounted — the op
            # was never executed and the client's retry will be, so
            # counting both would inflate the pool's ops over what the
            # client actually submitted.  -ETIMEDOUT admission sheds
            # are excluded for the same reason: the op never
            # executed, only its corpse was returned
            from ..common.errs import EAGAIN, ETIMEDOUT

            if rep.result not in (-EAGAIN, -ETIMEDOUT):
                # real payload bytes, NOT `cost` — the QoS cost floors
                # zero-payload ops (delete/create/truncate) at 4096,
                # which would add phantom write bytes to the pool and
                # client views
                nbytes = (
                    sum(len(op.data) for op in msg.ops)
                    if op_class == "write"
                    else sum(len(d) for d in (rep.outdata or []))
                )
                self.io_accountant.account(
                    msg.pgid.pool, msg.reqid.client, op_class, nbytes, lat
                )
            # tail-based always-keep (trace sampling): an op that
            # crossed the complaint age or errored keeps its FULL trace
            # even when head sampling dropped it — the traces worth
            # reading are exactly the ones sampling must not lose
            if lat >= self.op_tracker.complaint_time or rep.result < 0:
                self.tracer.mark_keep(op_span)
            op_span.event("reply sent")
            op_span.finish()

            async def _send():
                try:
                    await conn.send_message(rep)
                except ConnectionError:
                    pass

            asyncio.get_event_loop().create_task(_send())

        deadline = getattr(msg, "deadline", 0.0)
        if deadline and time.monotonic() > deadline:
            # admission-time deadline shed: the client has
            # already given up on this op — queue wait ate its budget —
            # so executing it now would spend OSD time nobody is waiting
            # on.  -ETIMEDOUT back (the objecter maps it to the same
            # TimeoutError a local expiry raises), never executed, and
            # excluded from io-accounting like the -EAGAIN bounce.
            from ..common.errs import ETIMEDOUT

            self.perf.inc("op_deadline_shed")
            op_span.event("deadline expired at admission: shed")
            reply(
                MOSDOpReply(
                    reqid=msg.reqid,
                    result=-ETIMEDOUT,
                    outdata=[],
                    version=0,
                    epoch=self.osdmap.epoch,
                )
            )
            return
        if pg is None:
            from ..common.errs import EAGAIN

            reply(
                MOSDOpReply(
                    reqid=msg.reqid,
                    result=-EAGAIN,
                    outdata=[],
                    version=0,
                    epoch=self.osdmap.epoch,
                )
            )
            return
        for op in msg.ops:
            if op.data:
                self.perf.inc("op_in_bytes", len(op.data))
        op_span.event("reached_pg")
        try:
            pg.do_op(msg, reply, conn)
        except Exception as e:
            if is_device_error(e):
                # a device error the PG did not answer: the client is
                # told EIO, as a failed launch's write is, instead of
                # waiting out its op (ROADMAP C36)
                reply(
                    MOSDOpReply(
                        reqid=msg.reqid,
                        result=-EIO,
                        outdata=[],
                        version=0,
                        epoch=self.osdmap.epoch,
                    )
                )
                return
            # a faulting op handler must not leak its tracker entry (the
            # reply closure, the only finish() site, will never run)
            self.op_tracker.finish(token)
            op_span.event("op handler raised")
            op_span.finish()
            raise

    async def _op_worker(self) -> None:
        """The op worker (the reference's ShardedThreadPool shards,
        OSD.h:1584, collapsed onto the event loop)."""
        while self._running:
            item = self.sched.dequeue()
            if item is None:
                self._sched_kick.clear()
                await self._sched_kick.wait()
                continue
            try:
                item.run()
            except Exception as e:  # an op must not kill the worker
                dout("osd", 0, f"osd.{self.whoami}: op raised {e!r}")
            await asyncio.sleep(0)

    # -- ordered cluster sends -------------------------------------------------

    def internal_op(
        self,
        pool_id: int,
        oid: str,
        ops: list[OSDOp],
        cb,
        snap_id: int = 0,
        timeout: float = 5.0,
        multi: bool = False,
    ) -> None:
        """One op with this OSD acting as a RADOS client toward the
        object's primary — the objecter leg of COPY_FROM and of the cache
        tier's promote/flush (PrimaryLogPG::do_copy_from / agent_work →
        Objecter).  cb(err, data); with multi=True, cb(err, outdata_list)
        receives every sub-op's outdata (the copy-get data+attrs legs).
        -EAGAIN on timeout or unplaceable target so the calling op
        retries."""
        from ..common.errs import EAGAIN

        empty: object = [] if multi else b""
        _pool, ps = self.osdmap.object_to_pg(pool_id, oid)
        _u, _up, _a, primary = self._placement(pool_id, ps)
        if primary == PG_NONE:
            cb(-EAGAIN, empty)
            return
        self._internal_tid += 1
        tid = self._internal_tid
        self._internal_reads[tid] = (cb, multi)

        def expire() -> None:
            stale = self._internal_reads.pop(tid, None)
            if stale is not None:
                stale[0](-EAGAIN, empty)

        asyncio.get_event_loop().call_later(timeout, expire)
        self.send_cluster(
            primary,
            MOSDOp(
                reqid=ReqId(client=f"osd.{self.whoami}", tid=tid),
                pgid=PgId(pool_id, ps, -1),
                oid=oid,
                ops=ops,
                epoch=self.osdmap.epoch,
                snap_id=snap_id,
            ),
        )

    def internal_read(
        self, pool_id: int, oid: str, snap_id: int, cb, timeout: float = 5.0
    ) -> None:
        """Whole-object fetch via internal_op (cb(err, data))."""
        self.internal_op(
            pool_id, oid, [OSDOp(op=OSDOp.READ)], cb, snap_id=snap_id,
            timeout=timeout,
        )

    def send_cluster(self, osd: int, msg: Message) -> None:
        """Ordered send to a peer OSD by id (cluster messenger)."""
        info = self.osdmap.osds.get(osd)
        if info is None or not info.addr:
            dout("osd", 5, f"osd.{self.whoami}: no addr for osd.{osd}, dropping")
            return
        self._send_addr(info.addr, msg)

    def _send_addr(self, addr: str, msg: Message) -> None:
        q = self._out_q.get(addr)
        if q is None:
            q = self._out_q[addr] = asyncio.Queue()
            self._out_tasks[addr] = asyncio.create_task(self._drain(addr, q))
        q.put_nowait(msg)

    async def _drain(self, addr: str, q: asyncio.Queue) -> None:
        while True:
            msg = await q.get()
            try:
                await self.msgr.send_to(addr, msg)
            except ConnectionError:
                dout("osd", 5, f"osd.{self.whoami}: send to {addr} failed")
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # A malformed message must not wedge the whole peer queue.
                dout(
                    "osd", 0,
                    f"osd.{self.whoami}: dropping unsendable {type(msg).__name__}"
                    f" to {addr}: {e!r}",
                )

    # -- heartbeats ------------------------------------------------------------

    def _hb_peers(self) -> list[int]:
        return [
            o
            for o, info in self.osdmap.osds.items()
            if o != self.whoami and info.up
        ]

    async def _heartbeat_loop(self) -> None:
        interval = self.conf.get("osd_heartbeat_interval")
        while self._running:
            slept = time.monotonic()
            await asyncio.sleep(interval)
            # how late this tick woke: the event loop this daemon shares
            # with its messenger (and, in one process, with its peers)
            # was busy that long, and ping replies waited in it too
            self._hb_late = time.monotonic() - slept - interval
            self._hb_stalled += max(self._hb_late, 0.0)
            if not self.up:
                # Mon may have missed our boot (election in progress) or the
                # subscription connection reset: renew both (OSD::tick).
                await self._send_boot()
                try:
                    await self.monc.resubscribe()
                except ConnectionError:
                    pass
                continue
            for pg in list(self.pgs.values()):
                pg.tick()
            # cross-PG recovery-storm waves ride the same cadence as the
            # per-PG ticks they coordinate; a faulting tick
            # must not kill the heartbeat task — pings, failure reports
            # and mgr beacons all ride this loop
            try:
                self.recovery_storm.tick()
            except Exception as e:
                dout("osd", 0,
                     f"osd.{self.whoami}: recovery-storm tick raised {e!r}")
            self._maybe_periodic_scrub()
            self._send_mgr_report()
            if self.conf.get("heartbeat_inject_failure") > 0:
                continue  # pretend our pings are lost (global.yaml.in:865)
            now = time.monotonic()
            for peer in self._hb_peers():
                self._send_ping(
                    peer,
                    MOSDPing(
                        op=MOSDPing.PING,
                        stamp=now,
                        epoch=self.osdmap.epoch,
                        from_osd=self.whoami,
                    ),
                )
            self._heartbeat_check(now)

    def _maybe_periodic_scrub(self) -> None:
        """osd_scrub_interval: kick a shallow scrub on primaried PGs
        whose last periodic scrub is older than the interval (the
        reference's OSD::sched_scrub timer, scaled to the toy tick), deep
        where osd_deep_scrub_interval says so.  0 (the default) disables
        the timer — scrubs then only run on operator command."""
        interval = self.conf.get("osd_scrub_interval")
        if interval <= 0:
            return
        deep_interval = self.conf.get("osd_deep_scrub_interval")
        now = time.monotonic()
        for pg in list(self.pgs.values()):
            if not pg.peering.is_primary():
                continue
            # first-seen PGs get a random phase inside the interval so
            # the whole cluster never scrubs (and re-scrubs, since each
            # PG records the same kick time) in one tick — the
            # reference jitters scrub scheduling for the same reason
            last = self._last_periodic_scrub.setdefault(
                pg.pgid, now - random.uniform(0.0, interval)
            )
            if now - last < interval:
                continue
            # the port's deep timer (osd_deep_scrub_interval, Ceph's
            # OSD::sched_scrub upgrade of a due scrub to deep): the first
            # deep kick of a PG is phased like the shallow one
            deep = deep_interval > 0 and now - self._last_deep_scrub.setdefault(
                pg.pgid, now - random.uniform(0.0, deep_interval)
            ) >= deep_interval
            if pg.scrub(deep=deep):
                self._last_periodic_scrub[pg.pgid] = now
                if deep:
                    self._last_deep_scrub[pg.pgid] = now

    def _heartbeat_check(self, now: float) -> None:
        """heartbeat_check (OSD.cc:5834): report peers past the grace.

        The port's changes (ROADMAP C14, C20): a tick that woke more than
        half the grace late judges nobody.  The loop that would have
        handled the peers' replies was stalled, so their silence says
        nothing about them; every peer gets a fresh grace from now, as
        Ceph's OSD drops its heartbeat work while its own threads are
        unhealthy (`HeartbeatMap::is_healthy`).  Without it one stalled
        loop makes every daemon of the process report every peer.  A
        peer's silence is also measured without the time the loop lost
        in the ticks since its last reply: stalls each too short to make
        a tick late can add up past the grace between two of a peer's
        replies.  And a peer's grace starts when the first ping to it
        went out, not when it was queued behind the heartbeat session's
        handshake (`_send_ping`)."""
        grace = self.conf.get("osd_heartbeat_grace")
        if self._hb_late > grace / 2:
            self.heartbeat_stalls += 1
            dout("osd", 1, f"osd.{self.whoami}: heartbeat tick {self._hb_late:.3f} s late; "
                           "judging no peer this tick")
            for peer in self._hb_peers():
                if peer in self._hb_first_tx:
                    self._hb_last_rx[peer] = max(self._hb_last_rx.get(peer, now), now)
                    self._hb_stalled_at[peer] = self._hb_stalled
            return
        for peer in self._hb_peers():
            first = self._hb_first_tx.get(peer)
            if first is None:
                continue
            last = self._hb_last_rx.get(peer, first)
            failed_for = now - last
            lost = self._hb_stalled - self._hb_stalled_at.get(peer, self._hb_stalled)
            if failed_for - lost > grace and now - first > grace:
                if peer not in self._reported_failed:
                    self._reported_failed.add(peer)
                    self.perf.inc("heartbeat_failures")
                # re-report at most once per grace period while the peer
                # stays failed: reports expire mon-side and a
                # send can die with its connection, so a one-shot report
                # could silently never form a markdown quorum — a dead
                # OSD would stay 'up' forever.  The grace cadence keeps
                # transient event-loop stalls from double-reporting a
                # healthy peer every heartbeat.
                last = self._last_failure_report.get(peer, 0.0)
                if now - last >= grace:
                    self._last_failure_report[peer] = now
                    dout("osd", 1, f"osd.{self.whoami}: reporting osd.{peer}: no reply for "
                                   f"{failed_for:.3f} s, {lost:.3f} s of it lost by late "
                                   f"ticks (this tick {self._hb_late:.3f} s late)")
                    self._report_failure(peer, failed_for)
            else:
                self._reported_failed.discard(peer)
                self._last_failure_report.pop(peer, None)
        self._laggy_check(now)

    def _laggy_check(self, now: float) -> None:
        """Laggy-OSD detection: a peer whose RTT EWMA (ping
        replies + EC sub-read service, _note_peer_rtt) inflates past
        osd_heartbeat_slow_factor x the cluster-median peer EWMA —
        floored at 10 ms absolute so a uniformly-fast mesh never flags
        on microsecond noise — is LAGGY: alive (heartbeats answer) but
        slow, the gray failure the markdown path cannot see.  Reported
        to the mon as a non-fatal MOSDFailure(laggy=1) on the grace
        cadence while it persists; hysteresis (exit at half the enter
        threshold) stops boundary flapping; recovery sends a one-shot
        laggy=2 so the mon retires its OSD_SLOW_PEER evidence."""
        factor = self.conf.get("osd_heartbeat_slow_factor")
        if factor <= 0:
            for peer in list(self._laggy_peers):
                self._laggy_clear(peer)
            return
        samples = sorted(self._peer_rtt_ewma.values())
        if len(samples) < 3:
            return  # too few peers for a meaningful median
        median = samples[len(samples) // 2]
        enter = max(factor * median, LAGGY_RTT_FLOOR)
        grace = self.conf.get("osd_heartbeat_grace")
        for peer, ewma in list(self._peer_rtt_ewma.items()):
            if peer in self._reported_failed:
                # dead beats laggy: the markdown path owns this peer
                if peer in self._laggy_peers:
                    self._laggy_peers.discard(peer)
                    self._laggy_reported.pop(peer, None)
                continue
            if peer not in self._laggy_peers:
                if ewma >= enter:
                    self._laggy_peers.add(peer)
                    self._laggy_reported[peer] = now
                    self._report_failure(peer, ewma, laggy=1)
            elif ewma <= enter / 2.0:
                self._laggy_clear(peer)
            elif now - self._laggy_reported.get(peer, 0.0) >= grace:
                # re-report on the grace cadence: mon-side evidence
                # expires and a send can die with its connection
                self._laggy_reported[peer] = now
                self._report_failure(peer, ewma, laggy=1)

    def _laggy_clear(self, peer: int) -> None:
        self._laggy_peers.discard(peer)
        self._laggy_reported.pop(peer, None)
        self._report_failure(peer, 0.0, laggy=2)

    def laggy_peers(self) -> set[int]:
        """Peers currently flagged laggy — EC read planning (via the PG
        listener) deprioritizes these as sub-read sources."""
        return set(self._laggy_peers)

    def _note_peer_rtt(self, peer: int, rtt: float) -> None:
        """One peer round-trip sample: EWMA for the laggy detector plus
        the aggregate and lazily-declared per-peer RTT histograms."""
        prev = self._peer_rtt_ewma.get(peer)
        self._peer_rtt_ewma[peer] = (
            rtt if prev is None else 0.2 * rtt + 0.8 * prev
        )
        self.perf.hinc("osd_heartbeat_rtt", rtt)
        name = f"osd_heartbeat_rtt_osd_{peer}"
        self.perf.ensure_histogram(name, f"ping/sub-read rtt to osd.{peer} (s)")
        self.perf.hinc(name, rtt)

    def note_subread_rtt(self, peer: int, rtt: float) -> None:
        """EC sub-read service-time sample (PG listener hook): feeds the
        same per-peer EWMA as ping RTT, so a peer that answers pings
        promptly but serves reads slowly still trips laggy detection."""
        if peer == self.whoami:
            return  # self-sends are a function call, not the network
        self._note_peer_rtt(peer, rtt)

    def _report_failure(self, peer: int, failed_for: float, laggy: int = 0) -> None:
        """Report a dead peer to every mon (re-sent on the grace cadence
        by _heartbeat_check while the failure persists; the mon dedupes
        repeats per reporter).  laggy=1/2 reports the non-fatal
        slow-peer state instead (failed_for then carries the RTT EWMA);
        the mon surfaces OSD_SLOW_PEER and never marks the target down."""
        info = self.osdmap.osds.get(peer)
        fail = MOSDFailure(
            target=peer,
            target_addr=info.addr if info else "",
            failed_for=failed_for,
            epoch=self.osdmap.epoch,
            laggy=laggy,
        )
        for name in self.monmap.ranks:
            async def _send(addr=self.monmap.addrs[name]):
                try:
                    await self.monc.msgr.send_to(addr, fail)
                except ConnectionError:
                    dout("osd", 2,
                         f"osd.{self.whoami}: failure report for "
                         f"osd.{peer} lost (mon connection)")

            asyncio.get_event_loop().create_task(_send())

    def _send_ping(self, peer: int, msg: MOSDPing) -> None:
        """A ping on the heartbeat messenger (lossy: a lost ping is the
        signal, never resent)."""
        info = self.osdmap.osds.get(peer)
        if info is None or not info.addr:
            return

        async def _send() -> None:
            try:
                await self.hb_msgr.send_to(info.addr, msg)
            except ConnectionError:
                pass
            # the peer's grace starts once its first ping went out (or its
            # session failed), not while the handshake was queued (C20)
            if peer not in self._hb_first_tx:
                self._hb_first_tx[peer] = time.monotonic()
                self._hb_stalled_at[peer] = self._hb_stalled

        asyncio.get_event_loop().create_task(_send())

    def _handle_ping(self, conn: Connection, msg: MOSDPing) -> None:
        """handle_osd_ping (OSD.cc:5463).  The reply goes back on the
        connection the ping came in on, the pinger's heartbeat one."""
        if msg.op == MOSDPing.PING:
            reply = MOSDPing(
                op=MOSDPing.PING_REPLY,
                stamp=msg.stamp,
                epoch=self.osdmap.epoch,
                from_osd=self.whoami,
            )

            async def _send() -> None:
                try:
                    await conn.send_message(reply)
                except ConnectionError:
                    pass

            asyncio.get_event_loop().create_task(_send())
        elif msg.op == MOSDPing.PING_REPLY:
            now = time.monotonic()
            self._hb_last_rx[msg.from_osd] = now
            self._hb_stalled_at[msg.from_osd] = self._hb_stalled
            # ping round-trip (now - our PING's stamp, echoed back):
            # the laggy detector's baseline signal
            self._note_peer_rtt(msg.from_osd, now - msg.stamp)

    # -- misc ------------------------------------------------------------------

    def _on_config_msg(self, msg) -> None:
        """Apply centrally-pushed config (MConfig from the ConfigMonitor) to
        the runtime Config, hitting the same observer path a local `set`
        takes — so e.g. QoS/debug knobs change live (md_config_t::
        apply_changes; ConfigMonitor push in the reference).  Options that
        were mon-managed in a previous push but absent now (`config rm`)
        revert to their defaults; unchanged values are skipped so
        observers fire only on real changes."""
        import json as _json

        changes = _json.loads(msg.changes.decode())
        dropped = set(self._pushed_config) - set(changes)
        for name in dropped:
            try:
                default = self.conf.get_option(name).default
                if self.conf.get(name) != default:
                    self.conf.set(name, default)
                    dout("osd", 10, f"osd.{self.whoami} config revert: {name}")
            except KeyError:
                pass
        self._pushed_config = set(changes)
        for name, value in changes.items():
            try:
                if self.conf.get(name) == self.conf.get_option(name).parse(value):
                    continue
                self.conf.set(name, value)
                dout("osd", 10, f"osd.{self.whoami} config push: {name}={value}")
            except (KeyError, ValueError) as e:
                dout("osd", 5, f"osd.{self.whoami} config push skipped {name}: {e}")

    def cluster_log(
        self,
        prio: str,
        msg: str,
        channel: str = "cluster",
        code: str | None = None,
    ) -> None:
        """Structured cluster-log entry (clog → ClusterLogClient →
        LogMonitor): batched, deduped and rate-limited client-side, then
        committed through the mons' paxos so the whole quorum holds the
        same timeline."""
        dout("osd", 0 if prio == "error" else 5,
             f"osd.{self.whoami} clog: {msg}")
        if self._running:
            self.clogc.log(prio, msg, channel=channel, code=code)

    def clog_error(self, msg: str) -> None:
        """Cluster-log error: recorded locally and shipped to the mons'
        LogMonitor (the EC CRC-mismatch sink, src/osd/ECBackend.cc:1080)."""
        self.clog.append(msg)
        self.cluster_log("error", msg)

    def _clog_transitions(self, status: dict) -> None:
        """Diff the beacon's status blob against the last one and emit
        cluster-log entries for the load-bearing transitions that used
        to live only in dout: device-backend DEGRADED/heal and the HBM
        pressure stages."""
        tb = status.get("tpu_backend") or {}
        degraded = bool(tb.get("degraded"))
        if degraded != self._clog_degraded:
            self._clog_degraded = degraded
            if degraded:
                self.cluster_log(
                    "warn",
                    "device backend DEGRADED: "
                    f"{tb.get('reason') or 'unknown'} (launches fail with "
                    "EIO until the probe heals)",
                    code="TPU_BACKEND_DEGRADED",
                )
            else:
                self.cluster_log(
                    "info",
                    "device backend healed: device launches resumed",
                    code="TPU_BACKEND_DEGRADED",
                )
        hp = status.get("hbm_pressure") or {}
        stage = int(hp.get("stage") or 0)
        if stage != self._clog_hbm_stage:
            prev = self._clog_hbm_stage
            self._clog_hbm_stage = stage
            if stage > prev:
                self.cluster_log(
                    "warn",
                    f"HBM pressure stage {stage} "
                    f"({hp.get('stage_name', '?')}) engaged: "
                    f"residency ratio {hp.get('ratio', 0.0)}",
                    code="TPU_HBM_PRESSURE",
                )
            else:
                self.cluster_log(
                    "info",
                    f"HBM pressure relieved (stage {prev} -> {stage}): "
                    f"residency ratio {hp.get('ratio', 0.0)}",
                    code="TPU_HBM_PRESSURE",
                )

    def num_pgs(self) -> int:
        return len(self.pgs)

    def all_clean(self) -> bool:
        return all(pg.is_clean for pg in self.pgs.values() if pg.peering.is_primary())


def _osd_status(osd: "OSD") -> dict:
    """The status blob the mgr aggregates (DaemonServer daemon status)."""
    pool_objects: dict[str, int] = {}
    pool_bytes: dict[str, int] = {}
    pool_stored: dict[str, int] = {}
    pool_heads: dict[str, int] = {}
    progress: dict[str, list] = {}
    scrub_errors: dict[str, dict] = {}
    slow_count, slow_oldest = osd.op_tracker.slow_ops()
    for pg in osd.pgs.values():
        events = pg.progress_status()
        if events:
            progress[f"{pg.pool.id}.{pg.ps}"] = events
        # scrub inconsistencies from the PGs this OSD primaries: the
        # last scrub's errors ride the status blob so
        # the mgr digest and the mon's OSD_SCRUB_ERRORS / PG_DAMAGED
        # HEALTH_ERR can see them — before this they only hit clog and
        # vanished.  Cleared by a later clean scrub (last_result
        # replaced) or by repair rebuilding every bad shard.
        last = pg.scrubber.last_result
        if (
            pg.peering.is_primary()
            and last is not None
            and last.errors
            and not last.aborted
            # a repair scrub that re-queued every inconsistent object
            # for recovery counts as handled: recovery rebuilds the
            # shards, and the next scrub confirms — holding HEALTH_ERR
            # through that window would punish the operator for
            # running `pg repair` exactly as intended
            and last.repaired < len(last.inconsistent)
        ):
            scrub_errors[f"{pg.pool.id}.{pg.ps}"] = {
                "errors": last.errors,
                "deep": last.deep,
                "repaired": last.repaired,
                "inconsistent": {
                    oid: {str(osd_id): why for osd_id, why in bad.items()}
                    for oid, bad in last.inconsistent.items()
                },
            }
        pid = str(pg.pool.id)
        pool_objects[pid] = pool_objects.get(pid, 0) + pg.local_object_count()
        pool_bytes[pid] = pool_bytes.get(pid, 0) + pg.local_bytes_used()
        if pg.peering.is_primary():
            # logical ("STORED") bytes + head counts, counted once from
            # primaries only
            heads = pg.list_heads()
            pool_stored[pid] = pool_stored.get(pid, 0) + sum(
                pg.logical_object_size(o) for o in heads
            )
            pool_heads[pid] = pool_heads.get(pid, 0) + len(heads)
    hbm_pools, hbm_pressure = _hbm_status()
    return {
        "num_pgs": len(osd.pgs),
        "up": osd.up,
        "osdmap_epoch": osd.osdmap.epoch,
        "clog_errors": len(osd.clog),
        # per-pool local object counts — the pg-stats slice the autoscaler
        # needs to verify a pool is empty before a pg_num change
        # (the reference's richer MPGStats -> mgr flow)
        "pool_objects": pool_objects,
        # raw bytes on this OSD (replicas/shards multi-count, `ceph df`
        # USED) and primary-only logical bytes (`ceph df` STORED)
        "pool_bytes": pool_bytes,
        "pool_stored": pool_stored,
        "pool_heads": pool_heads,
        # in-flight ops older than osd_op_complaint_time (OpTracker) —
        # aggregated by the mgr into the digest that raises SLOW_OPS
        "slow_ops": {"count": slow_count, "oldest_sec": slow_oldest},
        # workload attribution: cumulative per-pool /
        # per-client ops, bytes and log2 latency histograms from the op
        # reply + recovery paths — the mgr iostat module merges these
        # across OSDs into windowed rates, top-client views, and the
        # SLO burn-rate evaluation
        "pool_io": osd.io_accountant.dump_pools(),
        "client_io": osd.io_accountant.dump_clients(),
        # trace-sampling verdicts (sampled/kept/dropped + live knobs)
        "trace_sampling": osd.tracer.sampling_stats(),
        # per-PG recovery/backfill/scrub progress events from the
        # primaries this OSD hosts (PG.progress_status) — the mgr's
        # progress module turns them into bars with rate + ETA and the
        # PG_RECOVERY_STALLED health check
        "progress": progress,
        # device-backend verdict (ops/guard.py): the mgr aggregates this
        # into the digest slice the TPU_BACKEND_DEGRADED health check
        # (mon HEALTH_WARN + mgr prometheus healthcheck gauge) reads
        "tpu_backend": _tpu_backend_status(),
        # HBM mempool ledger + pressure verdict: per-pool
        # residency for the ceph_tpu_mempool_* scrape families, and the
        # pressure evaluation (which also APPLIES the staged trims) the
        # TPU_HBM_PRESSURE health check reads — the status beacon is
        # the periodic driver of the pressure loop
        "hbm_mempools": hbm_pools,
        "hbm_pressure": hbm_pressure,
        # per-PG scrub inconsistencies from this OSD's primaries —
        # aggregated by the mgr into the digest slice the mon's
        # OSD_SCRUB_ERRORS / PG_DAMAGED HEALTH_ERR checks read
        "scrub_errors": scrub_errors,
        # whole-OSD rebuild progress: the storm controller's
        # bar — the mgr progress module aggregates these across daemons
        # into per-victim rebuild bars with rate + ETA
        "recovery_storm": osd.recovery_storm.status(),
        # gray-failure tolerance: peers this OSD currently
        # sees as laggy plus its hedge/shed ledger — the evidence trail
        # behind the mon's OSD_SLOW_PEER detail and the chaos harness's
        # hedge-rate assertions
        "slow_peers": {
            "laggy": sorted(osd._laggy_peers),
            "hedge_reads": osd.perf.get("ec_hedge_reads"),
            "hedge_wins": osd.perf.get("ec_hedge_wins"),
            "hedge_denied": osd.perf.get("ec_hedge_denied"),
            "op_deadline_shed": osd.perf.get("op_deadline_shed"),
            "subread_deadline_shed": osd.perf.get("subread_deadline_shed"),
        },
        # the MonClient's hunts for a monitor after a reset, and its
        # passes over every rank that found none (the port's, C18)
        "monclient": {"hunts": osd.monc.hunts, "hunt_failures": osd.monc.hunt_failures},
    }


def _hbm_status() -> tuple[dict, dict]:
    """(per-pool ledger snapshot, pressure verdict) for the status blob.
    The pressure call is the EVALUATING one — each beacon re-checks the
    ratio and applies/releases the staged trims, so a runtime target
    change takes effect within one report interval."""
    from ..common.mempool import ledger as hbm_ledger

    led = hbm_ledger()
    return led.snapshot(), led.check_pressure()


def _tpu_backend_status() -> dict:
    from ..ops import dispatch as ec_dispatch
    from ..ops.guard import device_guard

    snap = device_guard().snapshot()
    return {
        "degraded": bool(snap["degraded"]),
        "degraded_for_sec": snap["degraded_for_sec"],
        "reason": snap["reason"],
        "fallback_launches": ec_dispatch.FALLBACK_LAUNCHES.snapshot()["launches"],
    }
