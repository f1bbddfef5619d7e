"""Typed option schema — mirror of the reference's options framework.

The port's copy of `ceph_tpu/common/options.py`: the `Option` type and the
entries the offload runtime reads (the aggregators, the device guard, the
launch scheduler's QoS lanes, the mempool ledger), those of the device
chunk cache and the RMW delta path, and those of the object stores
(`osd_objectstore`, `osd_data`, BlueStore's compression and checksum
offload), and those the placement-group layer reads (recovery, backfill
and log-trim bounds).  The rest of the table
comes with the modules that read it.

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
)
