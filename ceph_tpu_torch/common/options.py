"""Typed option schema — mirror of the reference's options framework.

The port's copy of `ceph_tpu/common/options.py`: the `Option` type and the
entries the offload runtime reads (the aggregators, the device guard, the
launch scheduler's QoS lanes, the mempool ledger), those of the device
chunk cache and the RMW delta path, and those of the object stores
(`osd_objectstore`, `osd_data`, BlueStore's compression and checksum
offload), those the placement-group layer reads (recovery, backfill
and log-trim bounds), and those of the monitor and the mgr (the lease and
tick, the failure reporters, the down-out timer and its flap dampening,
the cluster log's bound, the pool defaults `osd pool create` applies, and
the `mgr_*` table the mgr modules read).  The table holds every name of
the reference's, and one more: `osd_deep_scrub_interval`.

Reference: src/common/options/global.yaml.in (~800 typed
options code-generated into md_config_t) and src/common/options.h (Option
struct: name, type, level, default, description, see_also, flags).  This
framework keeps the same shape — a declarative table of typed, leveled,
documented options — scoped to the subsystems this framework implements.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass


class OptionLevel(enum.Enum):
    """Audience levels (options.h LEVEL_BASIC/ADVANCED/DEV)."""

    BASIC = "basic"
    ADVANCED = "advanced"
    DEV = "dev"


@dataclass(frozen=True)
class Option:
    """One typed option (src/common/options.h Option)."""

    name: str
    type: type  # int | float | bool | str
    default: object
    level: OptionLevel = OptionLevel.ADVANCED
    desc: str = ""
    see_also: tuple[str, ...] = ()
    # Runtime-mutable options notify registered observers on change
    # (md_config_obs_t; e.g. mClockScheduler, src/osd/scheduler/
    # mClockScheduler.h:72).
    runtime: bool = False

    def parse(self, value: object):
        """Coerce a raw (usually string) value to the option's type."""
        if isinstance(value, self.type):
            return value
        s = str(value)
        if self.type is bool:
            if s.lower() in ("true", "1", "yes", "on"):
                return True
            if s.lower() in ("false", "0", "no", "off"):
                return False
            raise ValueError(f"invalid bool for {self.name}: {s!r}")
        return self.type(s)


def _opts(*options: Option) -> dict[str, Option]:
    table: dict[str, Option] = {}
    for o in options:
        if o.name in table:
            raise ValueError(f"duplicate option {o.name}")
        table[o.name] = o
    return table


B = OptionLevel.BASIC
A = OptionLevel.ADVANCED
D = OptionLevel.DEV

# The option table (names, types, defaults and flags as in the reference's).
OPTIONS: dict[str, Option] = _opts(
    Option(
        "ec_tpu_aggregate_window",
        int,
        0,
        A,
        "EC encode launch aggregation window: submissions of one "
        "(matrix, chunk-size) geometry held before a coalesced device "
        "launch (codec/matrix_codec.py EncodeAggregator).  <= 1 launches "
        "every submission immediately.  Commit barriers always drain the "
        "window, so a value up to the encode queue depth trades no "
        "durability, only launch count",
        see_also=("ec_tpu_aggregate_max_bytes",),
        runtime=True,
    ),
    Option(
        "ec_tpu_aggregate_max_bytes",
        int,
        64 << 20,
        A,
        "input-byte budget per aggregation group: a group launches as "
        "soon as its queued stripe bytes reach this, whatever the window "
        "(bounds device memory held by deferred encodes)",
        see_also=("ec_tpu_aggregate_window",),
        runtime=True,
    ),
    Option(
        "ec_tpu_decode_aggregate_window",
        int,
        0,
        A,
        "EC decode launch aggregation window: recovery/degraded-read "
        "decodes of one (decode-matrix, chunk-size) signature held before "
        "a coalesced device launch (codec/matrix_codec.py "
        "DecodeAggregator).  <= 1 launches every submission immediately.  "
        "Recovery drains its decode pipeline at every barrier, so a value "
        "up to the decode queue depth trades no correctness, only launch "
        "count during backfill/recovery",
        see_also=("ec_tpu_decode_aggregate_max_bytes",
                  "ec_tpu_aggregate_window"),
        runtime=True,
    ),
    Option(
        "ec_tpu_decode_aggregate_max_bytes",
        int,
        64 << 20,
        A,
        "survivor-byte budget per decode aggregation group: a group "
        "launches as soon as its queued survivor bytes reach this, "
        "whatever the window (bounds device memory held by deferred "
        "recovery decodes)",
        see_also=("ec_tpu_decode_aggregate_window",),
        runtime=True,
    ),
    Option(
        "ec_tpu_verify_aggregate_window",
        int,
        64,
        A,
        "EC verify launch aggregation window: deep-scrub parity "
        "recompute submissions of one (matrix, chunk-size) geometry held "
        "before a coalesced compare-only device launch "
        "(codec/matrix_codec.py VerifyAggregator).  <= 1 launches every "
        "submission immediately.  Scrub has no commit barrier, so the "
        "window is open by default — the scrubber's per-chunk bitmap "
        "reap is the flush",
        see_also=("ec_tpu_verify_aggregate_max_bytes",
                  "ec_tpu_aggregate_window"),
        runtime=True,
    ),
    Option(
        "ec_tpu_verify_aggregate_max_bytes",
        int,
        64 << 20,
        A,
        "codeword-byte budget per verify aggregation group: a group "
        "launches as soon as its queued scrub bytes reach this, whatever "
        "the window (bounds device memory held by deferred verifies)",
        see_also=("ec_tpu_verify_aggregate_window",),
        runtime=True,
    ),
    Option("ec_tpu_sched_client_res", float, 25600.0, A,
           "launch-scheduler reservation for the client lane (encode "
           "launches), in nominal 4 KiB items/sec: matured reservations "
           "dequeue before any weight-phase launch.  A launch of N bytes "
           "consumes N/4096 items, so the rate must be launch-scaled to "
           "matter — the default 25600 guarantees ~100 MiB/s of client "
           "launch bandwidth (a 64 MiB launch advances the reservation "
           "tag 0.64 s); a per-op-scale value like 1.0 would push the "
           "tag hours into the future on the first aggregated launch "
           "and never mature again", runtime=True),
    Option("ec_tpu_sched_client_wgt", float, 2.0, A,
           "launch-scheduler weight for the client lane", runtime=True),
    Option("ec_tpu_sched_client_lim", float, 0.0, A,
           "launch-scheduler limit for the client lane (0 = unlimited)",
           runtime=True),
    Option("ec_tpu_sched_recovery_res", float, 0.0, A,
           "launch-scheduler reservation for the recovery lane (decode "
           "launches), in nominal 4 KiB items/sec (launch-scaled, see "
           "ec_tpu_sched_client_res); 0 = no reservation", runtime=True),
    Option("ec_tpu_sched_recovery_wgt", float, 1.0, A,
           "launch-scheduler weight for the recovery lane", runtime=True),
    Option("ec_tpu_sched_recovery_lim", float, 0.0, A,
           "launch-scheduler limit for the recovery lane (0 = unlimited)",
           runtime=True),
    Option("ec_tpu_sched_background_res", float, 0.0, A,
           "launch-scheduler reservation for the background lane "
           "(deep-scrub verify, best-effort work), in nominal 4 KiB "
           "items/sec (launch-scaled, see ec_tpu_sched_client_res); "
           "0 = no reservation", runtime=True),
    Option("ec_tpu_sched_background_wgt", float, 0.5, A,
           "launch-scheduler weight for the background lane: under "
           "contention a queued client encode dequeues ahead of a "
           "queued scrub verify; when the queue is otherwise idle the "
           "background lane drains at full device speed "
           "(work-conserving)", runtime=True),
    Option("ec_tpu_sched_background_lim", float, 0.0, A,
           "launch-scheduler limit for the background lane (0 = "
           "unlimited; a nonzero value deprioritizes scrub launches "
           "past the rate without ever idling the device)",
           runtime=True),
    Option(
        "ec_tpu_launch_timeout_ms",
        int,
        20000,
        A,
        "per-launch deadline (ms) for EC device dispatches and their "
        "blocking materialization, enforced by a watchdog thread "
        "(ops/guard.py DeviceGuard).  A launch that exceeds it marks the "
        "backend DEGRADED and re-runs on the byte-identical host oracle "
        "so in-flight writes/recoveries complete instead of "
        "chain-aborting behind a wedged device.  <= 0 disables the "
        "watchdog (launches may block forever)",
        see_also=("ec_tpu_probe_interval_ms",),
        runtime=True,
    ),
    Option(
        "ec_tpu_probe_interval_ms",
        int,
        2000,
        A,
        "while DEGRADED, re-probe the device backend with a tiny compile "
        "probe at most this often (ms); a probe that completes under the "
        "launch deadline self-heals dispatch back to the device path "
        "(the TPU_BACKEND_DEGRADED health check of the reference).  "
        "<= 0 disables "
        "re-probing (degraded mode is then sticky until restart)",
        see_also=("ec_tpu_launch_timeout_ms",),
        runtime=True,
    ),
    Option(
        "ec_tpu_inflight_max_bytes",
        int,
        256 << 20,
        A,
        "end-to-end backpressure bound: input bytes admitted into the EC "
        "launch aggregators (windowed + launched-but-unreaped) before a "
        "new submission must first settle older launches.  Bounds the "
        "memory a degraded/slow backend can queue behind itself and "
        "pushes back on submitters instead of growing the window "
        "unboundedly.  <= 0 disables admission control",
        see_also=("ec_tpu_aggregate_max_bytes",
                  "ec_tpu_decode_aggregate_max_bytes"),
        runtime=True,
    ),
    Option(
        "ec_tpu_pipeline_depth",
        int,
        2,
        A,
        "depth of the asynchronous device-launch pipeline: "
        "how many aggregated launches may be in flight (dispatched, not "
        "yet settled) before a new launch first settles the oldest.  At "
        "depth >= 2 window N+1's H2D staging overlaps window N's kernel "
        "— the overlap the flight recorder's idle gaps pointed at.  The "
        "settle order is oldest-first, and the donation pool's per-slot "
        "refcounts guarantee an in-flight launch's output buffer is "
        "never recycled early.  <= 0 disables the ring (in-flight "
        "launches bounded only by ec_tpu_inflight_max_bytes, the "
        "behavior without a ring)",
        see_also=("ec_tpu_inflight_max_bytes", "ec_tpu_aggregate_window"),
        runtime=True,
    ),
    Option(
        "ec_tpu_fuse_max_windows",
        int,
        4,
        A,
        "super-launch fusion bound: when the in-flight launch "
        "ring (ec_tpu_pipeline_depth) is full as an aggregation window "
        "trips, the group keeps accumulating up to this many whole "
        "windows and launches them as ONE fused multi-window dispatch — "
        "amortizing the fixed dispatch overhead exactly when the backlog "
        "proves demand.  Per-ticket settle slices, QoS arbitration and "
        "the host-oracle fallback are unchanged; fused launches count on "
        "fused_launches/fused_windows and flag `fused` on their flight "
        "records.  <= 1 disables fusion (every window trip launches "
        "immediately)",
        see_also=("ec_tpu_pipeline_depth", "ec_tpu_aggregate_window"),
        runtime=True,
    ),
    Option(
        "ec_tpu_pad_buckets",
        int,
        4,
        A,
        "learned pad-bucket slots per aggregation group key: "
        "a batch size the key's workload produces repeatedly is promoted "
        "to an exact-fit launch target instead of rounding up to the "
        "static pow2/64-multiple bucket, cutting zero-pad stripes on "
        "recurring sizes while the bounded, LRU-evicted slot set keeps "
        "the jit-cache geometry count capped (evicted targets drop "
        "their pooled output buffers so bucket churn cannot pin HBM).  "
        "Waste is exported as padding_waste_ratio / pad_waste.<label>.  "
        "<= 0 keeps the static buckets only",
        see_also=("ec_tpu_aggregate_window",),
        runtime=True,
    ),
    Option(
        "ec_tpu_rmw_delta",
        bool,
        True,
        A,
        "on-device RMW delta-encode path: when every operand "
        "of a read-modify-write — the k pre-write data chunks AND the m "
        "parity chunks — is resident in the device chunk cache at the "
        "op's pre-write generation, parity is updated on the device "
        "through the GF(2)-linear delta program (parity_new = parity_old "
        "xor Encode(data_old xor data_new), the same plane program as "
        "a full encode) — one launch, zero H2D and zero D2H on its "
        "flight record, byte-identical to the materialize path.  A "
        "cache miss or a DEGRADED backend takes the materialize path; "
        "a failed delta launch fails the write with EIO",
        see_also=("ec_tpu_device_cache_bytes",),
        runtime=True,
    ),
    Option(
        "ec_tpu_device_cache_bytes",
        int,
        32 << 20,
        A,
        "device-resident chunk cache bound: recently "
        "encoded/decoded chunk buffers kept in device memory keyed by "
        "(object, shard, generation), consulted by the RMW delta path "
        "and degraded reads BEFORE issuing H2D — a repeated degraded "
        "read of a hot object serves its missing chunks with one D2H "
        "copy and no launch.  Invalidated on overwrite and cleared on a "
        "DEGRADED backend transition; hit/miss/evict counters ride the "
        "ec_dispatch perf dump (cache.*).  <= 0 disables the cache",
        see_also=("ec_tpu_pipeline_depth",),
        runtime=True,
    ),
    Option(
        "ec_tpu_mempool_debug",
        bool,
        False,
        A,
        "shard HBM mempool ledger counts by allocation call-site "
        "(common/mempool.py), like the reference's mempool "
        "debug mode: asok dump_mempools then breaks each pool down by "
        "the file:line that allocated the bytes.  Costs one stack walk "
        "per tracked allocation; off by default",
        see_also=("ec_tpu_hbm_target_bytes",),
        runtime=True,
    ),
    Option(
        "ec_tpu_hbm_target_bytes",
        int,
        0,
        A,
        "device-memory residency target for the mempool pressure "
        "layer (the osd_memory_target analog for device memory).  When total "
        "ledger-tracked bytes exceed 85% of the target the staged "
        "response engages — trim the device-resident chunk cache, then "
        "cap donation-pool retention, then clamp the effective pipeline "
        "depth to 1 — and TPU_HBM_PRESSURE raises through the OSD "
        "status -> mgr digest -> mon health pipeline, clearing (and "
        "releasing the caps) once residency falls back under 70%.  "
        "0 disables pressure evaluation entirely",
        see_also=("ec_tpu_mempool_debug", "ec_tpu_device_cache_bytes",
                  "ec_tpu_pipeline_depth"),
        runtime=True,
    ),
    # --- objectstore --------------------------------------------------------
    Option("osd_objectstore", str, "memstore", A,
           "objectstore backend: memstore | filestore | bluestore"),
    Option("osd_data", str, "", A,
           "data directory for persistent stores (empty = in-memory)"),
    Option("bluestore_compression_algorithm", str, "none", A,
           "blob compression: none | zlib | zstd | device "
           "(src/compressor plugin family; bluestore_compression_algorithm; "
           "`device` is the batched byte-plane transpose + zero-run "
           "elision plugin riding the offload runtime, compressor/device.py)"),
    Option("bluestore_compression_required_ratio", float, 0.875, A,
           "store compressed only when compressed/raw <= this ratio"),
    Option(
        "bluestore_csum_offload",
        bool,
        False,
        A,
        "compute BlueStore per-block crc32c on the device through the "
        "offload runtime (ops/checksum_offload.py ChecksumAggregator, "
        "background lane): large-write stored-form checksums and batched "
        "read-verify ride coalesced launches of the crc32c kernel.  A "
        "failed or refused launch fails the store transaction or read "
        "with EIO; nothing is recomputed on the host.  Off = every "
        "checksum on the host table loop",
        see_also=("bluestore_csum_offload_window",
                  "bluestore_csum_offload_max_bytes"),
        runtime=True,
    ),
    Option(
        "bluestore_csum_offload_window",
        int,
        64,
        A,
        "checksum/compressor offload aggregation window: same-length "
        "block batches held before a coalesced device launch "
        "(ChecksumAggregator / CompressAggregator).  <= 1 launches every "
        "submission immediately.  Store reaps drain the window, so the "
        "value trades no durability, only launch count",
        see_also=("bluestore_csum_offload",
                  "bluestore_csum_offload_max_bytes"),
        runtime=True,
    ),
    Option(
        "bluestore_csum_offload_max_bytes",
        int,
        64 << 20,
        A,
        "input-byte budget per checksum/compressor aggregation group: a "
        "group launches as soon as its queued block bytes reach this, "
        "whatever the window (bounds device memory held by deferred "
        "csum/compress launches)",
        see_also=("bluestore_csum_offload_window",),
        runtime=True,
    ),
    # --- OSD: the placement-group layer (osd/pg.py) --------------------------
    Option("osd_recovery_max_active", int, 3, A,
           "max concurrent recovery ops per OSD"),
    Option("osd_recovery_push_retry_sec", float, 5.0, A,
           "re-send pending recovery PushOps whose target has not "
           "acked for this many seconds (ECBackend.retry_stalled_pushes, "
           "tick-driven): a push a dying target dropped cannot park its "
           "RecoveryOp in WRITING forever.  Re-applying a landed push is "
           "idempotent.  <= 0 disables the retry", runtime=True),
    Option("osd_max_backfills", int, 1, A, "max concurrent backfills",
           runtime=True),
    Option("osd_min_pg_log_entries", int, 250, A,
           "entries kept after a trim (PGLog floor)"),
    Option("osd_max_pg_log_entries", int, 500, A,
           "trim threshold (PGLog ceiling)"),
    Option("osd_backfill_scan_max", int, 64, A,
           "objects per backfill scan chunk", runtime=True),
    # --- the OSD daemon (osd/osd.py): identity, logging, the messenger,
    # cephx, heartbeats, the op queue, hedged reads, the recovery storm,
    # scrub scheduling, tracing and the admin socket ----------------------
    Option("name", str, "", B, "entity name, e.g. osd.0 / mon.a / client"),
    Option("fsid", str, "", B, "cluster fsid"),
    Option("mon_host", str, "", B, "comma-separated mon addresses"),
    Option(
        "osd_erasure_code_plugins",
        str,
        "tpu native jerasure lrc shec clay",
        A,
        "space-separated plugins preloaded at OSD boot (global.yaml.in:2541)",
    ),
    Option(
        "osd_op_class_load_list",
        str,
        "lock version numops refcount",
        A,
        "object classes preloaded at OSD boot (osd_class_load_list; "
        "others load lazily on first CALL)",
    ),
    Option(
        "ec_tpu_flight_records",
        int,
        512,
        A,
        "launch flight-recorder ring capacity (ops/flight_recorder.py): "
        "completed per-launch records retained for the asok dump_flight "
        "command and tools/trace_export.py timelines.  Resizing at "
        "runtime keeps the newest records; the ring is the memory bound "
        "— each record is a small flat dict",
        see_also=("ec_tpu_aggregate_window",),
        runtime=True,
    ),
    Option(
        "ec_tpu_shard_min_batch",
        int,
        32,
        A,
        "minimum stripe count before a coding launch shards "
        "data-parallel over the visible devices (parallel/dispatch.py); "
        "smaller launches stay on one device",
        see_also=("ec_tpu_shard_devices", "ec_tpu_aggregate_window"),
        runtime=True,
    ),
    Option(
        "ec_tpu_shard_devices",
        int,
        0,
        A,
        "device width for sharded coding launches (0 = every visible "
        "CUDA device, 1 = no sharding, N = the first N devices); a "
        "process that sees one device never shards",
        see_also=("ec_tpu_shard_min_batch",),
        runtime=True,
    ),
    Option("osd_recovery_max_chunk", int, 8 << 20, A,
           "max recovery push size; rounded to stripe (ECBackend.h:206)"),
    Option("osd_recovery_storm_min_objects", int, 8, A,
           "outstanding missing objects across this OSD's primaried PGs "
           "before the recovery-storm controller engages: below it the "
           "per-PG osd_recovery_max_active trickle is the right tool; at "
           "or above it the controller batches cross-PG reconstruction "
           "into mesh-wide decode waves",
           see_also=("osd_recovery_storm_wave_objects",), runtime=True),
    Option("osd_recovery_storm_wave_objects", int, 16, A,
           "max objects admitted per recovery-storm wave (the adaptive "
           "wave size's ceiling): one wave's decodes coalesce through "
           "the DecodeAggregator into few padded launches on the "
           "recovery QoS lane.  Admission adapts between "
           "osd_recovery_storm_min_wave_objects and this ceiling on the "
           "live client burn rate", runtime=True,
           see_also=("osd_recovery_storm_min_wave_objects",
                     "osd_recovery_storm_burn_threshold")),
    Option("osd_recovery_storm_min_wave_objects", int, 2, A,
           "adaptive wave-size floor under SLO shedding: even a pool "
           "burning its latency budget keeps rebuilding at this trickle "
           "(availability beats a perfectly idle rebuild)",
           see_also=("osd_recovery_storm_wave_objects",), runtime=True),
    Option("osd_recovery_storm_max_inflight", int, 32, A,
           "bounded wave depth: objects mid-recovery across ALL "
           "primaried PGs before the controller stops admitting new "
           "waves (the cross-PG analog of osd_recovery_max_active)",
           runtime=True),
    Option("mgr_slo_latency_target_ms", float, 0.0, A,
           "default per-pool op latency SLO target in milliseconds: the "
           "objective is `mgr_slo_objective` of ops under this latency. "
           "0 disables SLO evaluation.  Per-pool overrides via "
           "mgr_slo_pool_latency_targets",
           see_also=("mgr_slo_pool_latency_targets", "mgr_slo_objective"),
           runtime=True),
    # the SLO options the recovery storm's see_also names
    Option("mgr_slo_pool_latency_targets", str, "", A,
           "per-pool latency-target overrides as comma-separated "
           "`<pool id or name>:<ms>` entries, e.g. `rbd:50,7:10`; pools "
           "not listed use mgr_slo_latency_target_ms",
           see_also=("mgr_slo_latency_target_ms",), runtime=True),
    Option("mgr_slo_objective", float, 0.99, A,
           "latency SLO objective: the target fraction of ops under the "
           "pool's latency target; the error budget is 1 - objective "
           "and burn rate = observed bad fraction / error budget",
           runtime=True),
    Option("osd_recovery_storm_slo_target_ms", float, 0.0, A,
           "client-op latency target (ms) the storm admission loop "
           "evaluates the LOCAL burn rate against, from this OSD's own "
           "io-accounting histograms (the iostat/SLO layer's per-OSD "
           "input): ops slower than this eat the error budget.  0 "
           "disables admission feedback — waves always ramp to the "
           "ceiling", see_also=("osd_recovery_storm_burn_threshold",
                                "mgr_slo_latency_target_ms"),
           runtime=True),
    Option("osd_recovery_storm_slo_objective", float, 0.99, A,
           "fraction of client ops that must land under the storm SLO "
           "target; the error budget is 1 - objective and burn rate = "
           "observed bad fraction / error budget (the "
           "mgr_slo_objective shape, evaluated OSD-locally per tick)",
           see_also=("osd_recovery_storm_slo_target_ms",), runtime=True),
    Option("osd_recovery_storm_burn_threshold", float, 1.0, A,
           "local burn rate above which the storm SHEDS (halves the "
           "wave toward the floor) and at/below which it RAMPS (doubles "
           "toward the ceiling) — the SLO_LATENCY_BREACH-risk feedback "
           "that keeps a whole-OSD rebuild from eating client p99",
           see_also=("osd_recovery_storm_slo_target_ms",), runtime=True),
    Option("osd_op_num_shards", int, 4, A,
           "op queue shards (OSD.h sharded op queue)"),
    Option("osd_op_history_size", int, 20, A,
           "completed ops kept for dump_historic_ops (TrackedOp.h)",
           runtime=True),
    Option("osd_op_complaint_time", float, 30.0, A,
           "in-flight ops older than this count as slow requests "
           "(osd.yaml.in osd_op_complaint_time; feeds SLOW_OPS health)",
           runtime=True),
    Option("osd_op_num_threads_per_shard", int, 2, A, ""),
    Option("osd_heartbeat_interval", float, 1.0, A,
           "seconds between OSD->OSD pings (osd.yaml.in, scaled down)"),
    Option("osd_heartbeat_grace", float, 6.0, A,
           "seconds without reply before reporting failure "
           "(OSDMonitor.cc:3240)", runtime=True),
    Option("osd_ec_hedge_quantile", float, 3.0, A,
           "hedge trigger as a multiple of the shard source's EWMA "
           "sub-read latency: an outstanding EC sub-read older than "
           "quantile x the peer's smoothed round-trip (floored at "
           "osd_ec_hedge_min_ms) triggers one speculative read to an "
           "unused shard source; first k replies win through the "
           "redundant-read escalation path, the loser is reaped when "
           "its tid completes.  <= 0 disables hedging",
           see_also=("osd_ec_hedge_min_ms",
                     "osd_ec_hedge_budget_percent"), runtime=True),
    Option("osd_ec_hedge_min_ms", float, 10.0, A,
           "floor (ms) under the EWMA-scaled hedge threshold: sub-reads "
           "younger than this never hedge, so microsecond-fast healthy "
           "clusters do not hedge on scheduling noise",
           see_also=("osd_ec_hedge_quantile",), runtime=True),
    Option("osd_ec_hedge_budget_percent", float, 5.0, A,
           "token-bucket hedge budget as a percentage of issued "
           "sub-reads (burst = 10 tokens): each sub-read earns "
           "percent/100 of a token, each hedge spends one, and an empty "
           "bucket falls back to plain waiting — a cluster-wide "
           "slowdown cannot melt itself with speculative load.  "
           "<= 0 removes the cap",
           see_also=("osd_ec_hedge_quantile",), runtime=True),
    Option("osd_heartbeat_slow_factor", float, 8.0, A,
           "laggy-peer threshold: a peer whose EWMA ping RTT (or EC "
           "sub-read service time) inflates past this multiple of the "
           "cluster-median peer RTT (floored at 10 ms absolute) is "
           "reported to the mon as LAGGY — a non-fatal OSD_SLOW_PEER "
           "health warn, never an auto-down/out; primaries deprioritize "
           "the peer as an EC read source and hedge it preemptively.  "
           "The report clears when the peer's RTT recovers.  <= 0 "
           "disables laggy detection",
           see_also=("osd_heartbeat_grace",
                     "osd_ec_hedge_quantile"), runtime=True),
    Option("osd_scrub_interval", float, 0.0, A,
           "periodic scrub interval; 0 disables the timer"),
    Option("osd_deep_scrub_interval", float, 0.0, A,
           "a periodic scrub of a PG whose last periodic deep scrub is older "
           "than this many seconds runs deep (Ceph's osd_deep_scrub_interval; "
           "its default is a week).  0 keeps every periodic scrub shallow, "
           "the JAX package's schedule, which has no deep timer",
           see_also=("osd_scrub_interval",)),
    Option("osd_client_op_priority", int, 63, A, "", runtime=True),
    Option("osd_recovery_op_priority", int, 3, A, "", runtime=True),
    Option("osd_op_queue", str, "mclock_scheduler", A,
           "op scheduler: mclock_scheduler | wpq "
           "(osd/scheduler/OpScheduler)"),
    Option("osd_fast_read", bool, False, A,
           "issue k+m reads, first k win (pool fast_read default)"),
    Option("osd_mclock_client_res", float, 1.0, A, "", runtime=True),
    Option("osd_mclock_client_wgt", float, 2.0, A, "", runtime=True),
    Option("osd_mclock_client_lim", float, 0.0, A, "", runtime=True),
    Option("osd_mclock_recovery_res", float, 0.0, A, "", runtime=True),
    Option("osd_mclock_recovery_wgt", float, 1.0, A, "", runtime=True),
    Option("osd_mclock_recovery_lim", float, 3.0, A, "", runtime=True),
    Option("ms_type", str, "async+posix", A,
           "messenger stack: async+posix (TCP) or async+inproc "
           "(in-process pipes, kernel-bypass for one-host topologies)"),
    Option("ms_crc_data", bool, True, A, "crc32c-protect frame payloads"),
    Option("ms_inject_socket_failures", int, 0, D,
           "1-in-N chance of injected connection failure "
           "(global.yaml.in:1240)", runtime=True),
    Option("ms_inject_internal_delays", float, 0.0, D,
           "injected delay seconds in delivery (global.yaml.in:1271)",
           runtime=True),
    Option("ms_dispatch_throttle_bytes", int, 100 << 20, A, ""),
    Option("ms_secure", bool, False, A,
           "require AES-GCM-encrypted sessions (ms_*_mode=secure analog); "
           "needs a keyring for the cephx-derived session key"),
    Option("ms_compress", bool, False, A,
           "compress on-wire frames when the peer supports it"),
    Option("keyring", str, "", A,
           "keyring file for cephx (daemon identity + peer verification)"),
    Option("log_file", str, "", B, "empty = stderr"),
    Option("log_max_recent", int, 500, A,
           "in-memory ring entries kept for crash dump (Log.h)"),
    Option("debug_osd", str, "1/5", A, "log/gather levels for subsystem osd"),
    Option("debug_ms", str, "0/5", A, ""),
    Option("debug_ec", str, "1/5", A, ""),
    Option("debug_objecter", str, "0/5", A, ""),
    Option("debug_crush", str, "0/5", A, ""),
    Option("debug_objectstore", str, "0/5", A, ""),
    Option("admin_socket", str, "", A,
           "unix socket path; empty disables the admin socket"),
    Option("jaeger_tracing_enable", bool, False, A,
           "record spans through the EC data path in the in-process tracer "
           "(default off, matching the reference)", runtime=True),
    Option("op_trace_sample_rate", float, 1.0, A,
           "head-sampling probability for op traces: the "
           "retention decision is made once at the client/messenger "
           "entry and carried on the message envelope so every "
           "downstream span honors it.  Sampled-out ops still register "
           "in the OpTracker (SLOW_OPS accounting is never sampled) and "
           "still keep their FULL trace if they exceed the complaint "
           "age or error (tail-based always-keep).  1.0 = record "
           "everything (pre-sampling behavior)",
           see_also=("op_trace_budget_per_sec", "jaeger_tracing_enable"),
           runtime=True),
    Option("op_trace_budget_per_sec", float, 0.0, A,
           "token-bucket retention budget: head-sampled traces retained "
           "per second (burst = one second's worth).  Rate-accepted "
           "traces that find the bucket empty fall back to provisional "
           "(tail-keep still rescues slow/errored ops), so always-on "
           "tracing under the traffic harness cannot exceed this span "
           "budget.  <= 0 = unlimited",
           see_also=("op_trace_sample_rate",), runtime=True),
    Option("heartbeat_inject_failure", float, 0.0, D,
           "seconds to pretend heartbeats fail (global.yaml.in:865)",
           runtime=True),
    # --- the monitor, the mgr and the pool defaults they apply -------------
    Option("erasure_code_dir", str, "", A, "directory for native codec plugins"),
    Option(
        "osd_pool_erasure_code_stripe_unit",
        int,
        4096,
        A,
        "default stripe unit (bytes) for EC pools (osd.yaml.in)",
    ),
    Option(
        "osd_pool_default_erasure_code_profile",
        str,
        "plugin=tpu technique=reed_sol_van k=2 m=1",
        A,
        "default EC profile (global.yaml.in)",
    ),
    Option("mgr_iostat_window_sec", float, 10.0, A,
           "iostat rate window: per-pool/per-client IOPS, bytes/sec and "
           "windowed p99 are computed over the last this-many seconds "
           "of merged OSD reports (EMA-smoothed like the progress "
           "module's rates)", runtime=True),
    Option("mgr_iostat_top_clients", int, 10, A,
           "how many clients the iostat module ranks in its "
           "top-by-IOPS/bytes/p99 views (mgr asok `iostat top`, mon "
           "`status`, and the ceph_tpu_top_client_* scrape families — "
           "the scrape cardinality bound)", runtime=True),
    Option("mgr_slo_burn_threshold", float, 1.0, A,
           "burn-rate threshold: SLO_LATENCY_BREACH raises when BOTH "
           "the fast and slow windows burn above this (the multi-window "
           "burn-rate alert shape: the fast window confirms it is "
           "happening now, the slow window that it is not a blip); "
           "clears when either window drops back under", runtime=True),
    Option("mgr_slo_fast_window_sec", float, 10.0, A,
           "fast burn-rate window (seconds)",
           see_also=("mgr_slo_slow_window_sec",), runtime=True),
    Option("mgr_slo_slow_window_sec", float, 60.0, A,
           "slow burn-rate window (seconds)",
           see_also=("mgr_slo_fast_window_sec",), runtime=True),
    Option("mgr_history_max_series", int, 256, A,
           "cardinality cap of the mgr-resident time-series store "
           "(common/tsdb.py): when a new series would exceed it, the "
           "least-recently-written series is evicted — churned daemons "
           "and departed clients age out instead of growing the mgr "
           "without bound.  Evictions are counted on the "
           "ceph_tpu_history_evictions counter", runtime=True),
    Option("mgr_history_ring_slots", int, 360, A,
           "downsample buckets retained per resolution level per "
           "series: with the default 1s/10s/60s resolutions, 360 slots "
           "keep ~6 minutes of raw samples, an hour at 10 s, and six "
           "hours at 1 min — in fixed memory per series",
           see_also=("mgr_history_resolutions",), runtime=True),
    Option("mgr_history_resolutions", str, "1,10,60", A,
           "comma-separated downsample bucket widths in seconds, "
           "finest first; raw samples land in the finest ring and fold "
           "into min/max/avg/last buckets at each coarser width.  "
           "Changing this at runtime restarts the history at the new "
           "geometry", see_also=("mgr_history_ring_slots",), runtime=True),
    Option("mgr_trend_window_sec", float, 15.0, A,
           "recent window the trend sentinels average over; compared "
           "against the trailing mgr_trend_baseline_sec window that "
           "precedes it.  Sentinels hold fire until a full "
           "window + baseline of genuinely observed history exists "
           "(mgr failover never alarms on imported totals)",
           see_also=("mgr_trend_baseline_sec",), runtime=True),
    Option("mgr_trend_baseline_sec", float, 60.0, A,
           "trailing baseline window the trend sentinels compare the "
           "recent window against", see_also=("mgr_trend_window_sec",),
           runtime=True),
    Option("mgr_trend_regression_ratio", float, 0.5, A,
           "TPU_THROUGHPUT_REGRESSION threshold: the check raises when "
           "recent encode/decode GB/s falls below this fraction of the "
           "trailing baseline while launch volume persists (>= "
           "mgr_trend_min_launch_rate and >= half the baseline launch "
           "cadence — a load DROP is not a regression).  <= 0 disables "
           "the sentinel", see_also=("mgr_trend_min_launch_rate",),
           runtime=True),
    Option("mgr_trend_occupancy_ratio", float, 0.5, A,
           "TPU_OCCUPANCY_COLLAPSE threshold: raises when recent device "
           "occupancy falls below this fraction of the trailing "
           "baseline under sustained launch volume.  <= 0 disables the "
           "sentinel", runtime=True),
    Option("mgr_trend_queue_wait_factor", float, 3.0, A,
           "TPU_QUEUE_WAIT_INFLATION threshold: raises when the recent "
           "mean launch queue-wait exceeds this multiple of the "
           "trailing baseline (baseline floored at 1 ms, so a "
           "near-zero-wait baseline requires factor x 1 ms) under "
           "sustained launch volume.  <= 0 disables the sentinel",
           runtime=True),
    Option("mgr_trend_min_launch_rate", float, 0.1, A,
           "launch-volume floor (launches/sec over BOTH trend windows) "
           "below which NO trend sentinel evaluates — an idle or "
           "draining cluster has trends worth graphing, not alarming "
           "on, and an idle baseline is nothing to regress from",
           see_also=("mgr_trend_regression_ratio",), runtime=True),
    Option(
        "mgr_progress_stall_sec",
        float,
        60.0,
        A,
        "PG_RECOVERY_STALLED window (mgr/progress.py): a PG whose "
        "recovery/backfill event reports no objects/bytes advance for "
        "this many seconds raises the health warning; it clears on the "
        "next observed advance (or event completion).  <= 0 disables "
        "the check",
        runtime=True,
    ),
    Option("osd_pool_default_pg_num", int, 8, B, ""),
    Option("mon_lease", float, 5.0, A, "paxos lease seconds (Paxos.h)"),
    Option("mon_tick_interval", float, 1.0, A, ""),
    Option("mon_osd_min_down_reporters", int, 2, A,
           "distinct reporters needed to mark an osd down "
           "(OSDMonitor.cc can_mark_down quorum; reference default 2)"),
    Option("mon_osd_reporter_subtree_level", str, "host", A, ""),
    Option("mon_osd_down_out_interval", float, 30.0, A,
           "seconds down before an osd is marked out"),
    Option("mon_osd_flap_window", float, 300.0, A,
           "seconds a markdown stays in an OSD's recent-flap history: "
           "the down->out grace for an OSD with N markdowns inside the "
           "window is mon_osd_down_out_interval * "
           "mon_osd_flap_backoff^(N-1), so a flapping OSD earns an "
           "exponentially longer grace instead of re-triggering "
           "peering storms on every bounce.  <= 0 disables dampening "
           "(every markdown uses the base interval)",
           see_also=("mon_osd_flap_backoff",
                     "mon_osd_down_out_interval"), runtime=True),
    Option("mon_osd_flap_backoff", float, 2.0, A,
           "grace multiplier per recent markdown beyond the first "
           "(exponent capped at 8); 1.0 disables the growth",
           see_also=("mon_osd_flap_window",), runtime=True),
    Option("mon_osd_flap_max_auto_out_per_tick", int, 4, A,
           "auto-out churn cap: at most this many OSDs are marked out "
           "per down-out sweep tick — a rack-wide blip cannot remap "
           "the whole map in one epoch; the remainder keep their "
           "down-clock and go out on later ticks.  <= 0 removes the "
           "cap", see_also=("mon_osd_down_out_interval",), runtime=True),
    Option("mon_log_max", int, 500, A,
           "committed cluster-log entries each mon retains (the `log "
           "last` tail; mon/log_monitor.py).  Entries past the bound "
           "age out oldest-first on the next commit; lowering it at "
           "runtime trims immediately, raising it lets the tail grow. "
           "History beyond the bound lives only in daemon logs",
           runtime=True),
    Option("memstore_device_bytes", int, 1 << 30, A, ""),
    Option("debug_mon", str, "1/5", A, ""),
    Option("debug_paxos", str, "1/5", A, ""),
    Option("telemetry_salt", str, "", A,
           "cluster-persistent salt for the telemetry report's anonymized "
           "cluster id; set once (e.g. via the central config DB) so reports "
           "stay correlated across mgr failovers.  Empty -> a per-mgr random "
           "salt (ids change on failover).  Mirrors the reference telemetry "
           "module's persisted report id.", runtime=True),
)
