#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (ceph_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR] [--mon-log PATH] [--only {14,15,16,17}]

With --parent, phase 7c also times the packed kernels of the older
checkout at DIR beside this one's, and phase 12b its crc32c and transform
kernels (parent, this, this, parent), each in a process of its own.  With
--mon-log, the monitors' log (Paxos, the elector's messages and timers,
the lease) is written at level 10 to PATH.  With --only N, phase 1
builds the kernels and phase N (14, 15, 16 or 17) runs alone; the script
then exits without the kernel and contract lines.

Phases, each of which fails the run (non-zero exit) if it fails:

1. Environment: the card's name and power limit; build every hand kernel
   with nvcc, all at once (one nvcc per source): csrc/swar_gf.cu,
   csrc/copy_floor.cu, and the generated swar_baked/swar3_baked sources for
   the RS(8,3) Vandermonde and Cauchy encode matrices and one decode matrix
   (erasures [0, 5, 10]); print each build's time and ptxas registers and
   spills, and count the 16-byte loads and stores of copy_floor_kernel<8>
   in its SASS.  For csrc/swar_gf.cu: ptxas's registers and spills of every
   swar_gf_kernel instance (fails on a spill, or on more than 128 registers
   for RS(8,3)'s), the SASS mix of RS(8,3)'s instance and of its 4-chunk
   loop, and no CALL in any instance.  For csrc/packed_gf.cu: ptxas's
   registers, spills and stack frame of each instance of its three kernels
   (32 or 512 rows; fails on a spill or on local memory), and the CUDA
   toolkit's release (the 512-row parameters need 12.1).
2. Kernel vs plain on the card: the kernel against its plain PyTorch
   version (`swar_code_reference`) and against the numpy oracle
   (`xor_matmul_host_batch` on the first stripe, the GF(2^8) table product
   `gf_matmul` on the last), byte for byte, over RS(8,3) encode matrices of
   both techniques, RS(8,3) decode matrices, RS(4,2), RS(5,2), RS(10,4)
   encode and a 4-erasure RS(10,4) decode (one pass of 4 rows), and Cauchy
   (6,6) (two passes of 3), at chunk lengths {128, 256, 512, 131072} and
   {1, 2, 256} stripes, and at the main path's own shape (1, k, 524288).
   Then two views a caller may pass to `encode_array` (fault C1 of
   ROADMAP.md): `cw[:, :8]` of a dense
   (2, 11, 4096) CUDA tensor, and a dense (2, 8, 4096) input whose base is
   1 byte past a 16-byte boundary; each equal to `gf_matmul`, each one
   `swar_gf` launch.
3. The main path at a real size: plugin `tpu` RS(8,3) built through the
   registry with no device argument (so on the card), 32 objects of 4 MiB
   (RBD's default object size) encoded and decoded for every erasure class
   (1 data, 1 parity, 2 mixed, 3 mixed), both techniques, parity held
   against the GF(2^8) table product `gf_matmul` and every erasure rebuilt
   to the encoded bytes.  Kernel launch counts are reset just before and read
   just after, and must equal the kernel-tier calls made.
4. Bulk timing: `encode_array` on (256, 8, 131072) uint8 on the card, CUDA
   events around 5 back-to-back calls, median of 20 runs, beside the bound (the larger of the bytes
   moved at the HBM rate and the ops of the packed ring program at the
   INT32 rate), the plain version, the hand copy floor (which moves the
   same bytes) and a device copy of the whole input as the memory
   yardstick, and the baked kernel swar_baked (rs83-van-encode, its SASS
   instructions per word beside swar_gf's modelled ops per word); then
   `decode_array` at the same shape for one pattern of each erasure class,
   beside its bound, and RS(10,4)'s with 4 erasures (m = 4) at
   (256, 10, 131072).
5. The kernel experiments (ceph_tpu_torch/diag): copy_floor, swar_baked and
   swar3_baked against their plain versions and the oracle, byte for byte,
   on (1, 8, L) for L in {4096, 131072, 524288}, (8, 8, 16384) and
   (64, 8, 131072), for the three matrices of phase 1, at every block width
   and tile of the scripts; then each experiment's main() once at its
   script's own sizes, with launch counts reset before and held against
   the calls it made; then each kernel timed at (256, 8, 131072), median
   of 20, beside its bound, its plain version and (copy only) the library
   call `dst.copy_(data[:, :3])`.
6. The bit-matrix kernels of csrc/bitmatrix.cu (diag/kern_exp.py): grouped,
   for every (g, operand type, tile) of kern_exp.main(), against its plain
   version and `gf_matmul`; mm_only against its plain version's counts;
   expand_only against its plain version and a numpy popcount; byte for
   byte, on (8, 8, 4096) and (64, 8, 131072) for the three matrices of
   phase 1 and on (8, 4, 4096) for RS(4,2).  Then kern_exp.main() once at
   its script's sizes, launch counts reset before and held against its
   calls; then each kernel timed at (256, 8, 131072) beside its bound, its
   plain version and (mm_only only) the library call
   `torch.matmul(bm_bf16, planes).to(torch.uint8)`.  mm_only runs on the
   tensor cores: phase 6a also holds it, byte for byte against its plain
   version and integer counts, at RS(5,2) (8k = 40, K padded to 48),
   RS(10,4) (8m = 32, 8k = 80) and RS(3,1) (8m = 8, K padded to 32), at its
   tile and at one ring stage (tile 128).  grouped runs on the tensor cores
   with either operand type (`bitmatrix_grouped_int8`, wgmma m64n32k32;
   `bitmatrix_grouped_bf16`, wgmma m64n32k16): phase 6a also holds both
   against their plain versions and `gf_matmul` at RS(3,1) (m = 1),
   RS(5,2) (padded chunks), RS(10,4) (also at g = 8: g·k = 80), Cauchy
   (6,6) (two passes), RS(40,2) at g = 2 (chunk groups) and RS(96,4) (chunk
   groups, narrow stages), on (8, k, 4096), at a tile of one warp's ring
   stage (256: three warps code stale bytes and store nothing), at tile
   512, at tile 1028 on (8, 8, 4112) (not a multiple of 16: masked
   m-tiles, 4-byte copies) and at tile 4, the smallest.  Phase 6b also
   fails if `grouped_reference` is called during kern_exp.main() (a CUDA
   tensor launches the kernel or raises).  Phase 6c times every grouped
   variant at tile 4096 (g1, g2, g4, g8, each operand type), and reports
   the best of each operand type as its own kernel row.  Phase 1 builds the library with the others and checks the
   SASS: tensor-core instructions (HMMA) in mm_only's RS(8,3) instance,
   printed with ptxas's registers for it and for the largest instance
   (8m = 32, 8k = 128); IGMMA (wgmma's integer product) in the int8 grouped
   kernel's RS(8,3) instance and HGMMA (its bf16 product) in the bf16
   grouped kernel's (IGMMA/HGMMA, LDS, SHFL, PRMT, LOP3 and FADD counted,
   ptxas's registers printed for these and the largest instances, at most
   168 for RS(8,3)'s bf16 instance); none in expand_only; no spill in any
   mm_only or grouped instance.
7. The packed plane kernels of csrc/packed_gf.cu (ops/packed_gf.py).  7a:
   packed_code against its plain version, `packed_code_host` (first
   stripe) and `gf_matmul` (last stripe), byte for byte, over Vandermonde
   encode matrices for k in {2, 4, 8, 12} x m in {1..4}, RS(8,3) Cauchy and
   the RS(8,3) and RS(12,4) decode matrices for erasures 0..m-1, at L in
   {1, 3, 5, 127, 4100, 4128, 131075, 4096, 131072} and {1, 2, 64}
   stripes; each construction (naive, CSE, ring) and a legacy row
   schedule forced in turn; a strided view (`cw[:, :8]`), a view 1 byte
   past a 16-byte boundary, and `out=`.  packed_verify with a one-byte
   corruption at every shard position (and a clean stripe) against its
   plain version, `packed_verify_host` and the expected bitmap;
   packed_delta, stacked and over separately allocated flat shard
   buffers, against its plain version, `packed_delta_host` and a
   re-encode of the new data.  Then fault C3's profiles, each on its ring
   program and held against the plain version of that program and
   `gf_matmul` on one stripe: Cauchy(128,16) encode and 16-erasure decode
   at L = 4100 and 131075, Cauchy(200,56) encode (46216 ops, 256 rows),
   the flat deltas of Cauchy(96,8) and Cauchy(128,128) (208 and 512 rows),
   and Cauchy(248,8)'s verify corrupted at every shard position (256
   rows).  7b: plugin `tpu` RS(8,3) from the registry
   with no device argument: `verify_array` on one scrub chunk (25 objects
   of 4 MiB, (3200, 11, 4096), encoded on the card), clean and with a
   corruption at every shard position of one object; `encode_delta_device`
   over 19 flat 512 KiB shard buffers for 32 objects, each equal to
   `encode_array` of the new data; `encode_array` and `decode_array` (the
   four erasure classes) on (32, 8, 524320), the packed tier, against
   `gf_matmul` and the encoded bytes; plugin `tpu` Cauchy(128,16)'s
   `encode_array` twice on (4, 128, 4100), the packed tier, against
   `gf_matmul`.  Launch counts (kernels and the
   dispatch counters) reset just before and read just after, each equal
   to its tier's calls; the plain versions must be called 0 times.  7c:
   each kernel timed (median of 20 runs of 5 calls) beside its bound (the
   bytes at the HBM rate against the program's ops at the INT32 rate, an
   xtime XTIME_OPS) and its plain version, with the wrapper's host time a
   call: packed_code at (256, 8, 131072) beside swar_gf and at
   (256, 8, 131104), packed_verify at (3200, 11, 4096) (with its grid and
   the host time of a `PackedVerifyPlan` call step by step), packed_delta
   over flat shards at (256, 8, 131072); with --parent, the older tree's
   packed_code (bulk and RS(32,3)'s decode), packed_verify and
   packed_delta beside this one's, time, device time and host time.
8. The offload runtime (ops/offload_runtime.py and the EC aggregators of
   codec/matrix_codec.py) through plugin `tpu` RS(8,3) reed_sol_van with
   no device argument, at a deployment's size: RBD's 4 MiB object at
   stripe_unit 4096 (128 stripes of 8 x 4096), option defaults (pipeline
   depth 2, inflight 256 MiB, launch timeout 20 s).  8a: 64 client writes
   from 8 submitter threads into an encode aggregator (window 1, then
   window 8), tickets reaped out of order, parity equal to
   `encode_array_host`, host-to-host GB/s of each.  8b: a backfill of 64
   objects for each erasure class of PERF.md §2 through a decode
   aggregator (window 8), then 16 objects at isa's chunk length 524320 (the
   packed tier) in two rounds, so the second reuses the first's donated
   out= buffer.  8c: one scrub chunk of 25 objects, (3200, 11, 4096),
   submitted object by object to a verify aggregator (window 64, a byte
   budget of the chunk: the default 64 MiB would split it), one launch a
   pass, clean and corrupted at every shard position, exact.  8d:
   EncodePipeline(depth=4) over 32 objects, poll reaping only launches
   whose CUDA event has fired, flush the rest, exact.  8e: the guard
   drill: `codec.launch` armed once fails its launch (the reap raises EIO,
   the kernel is not reached, nothing is recomputed on the host,
   FALLBACK_LAUNCHES unchanged, DEGRADED), then the cuda probe heals the
   backend and the next launch runs swar_gf, exact.  8f: with the device turn held, a
   queued client encode leaves the launch scheduler ahead of a queued
   background verify.  Every part outside 8e: the aggregators' launches =
   the change in LAUNCHES (and DECODE_/VERIFY_LAUNCHES) = the change in
   the kernel's own launch count (swar_gf, packed_code, packed_verify), no
   fallback, the guard never degraded, the in-flight mempool pools at 0
   after the drain, one committed flight record a launch.  Printed beside
   the card's name and power limit: the GB/s of 8a, the medians of the
   flight records' spans (queue wait, h2d, kernel, d2h) a launch, and the
   pipeline and padding gauges.
9. The EC write path end to end (osd/ec_backend.py and the modules under
   it): an in-process cluster of 11 OSDs, one port ECBackend each over a
   MemStore holding one shard of one PG, messages through a pumped queue,
   the codec from `build_pg_backend` with no device argument, encodes and
   decodes through the default aggregators.  Pool rbd (RBD's data pool,
   RS(8,3), stripe unit 4096, allow_ec_overwrites): 9a 64 WRITEFULLs of 4
   MiB at QD1 (write, pump) and QD8 (8 writes a pump, encode window 8:
   one launch a batch), with the wall time split by stage; 9b 256
   unaligned RMW writes of 4-64 KiB in batches of 8, each batch with one
   overlapping pair on one object; 9c every object read whole against the
   model, and every shard against `encode_array_host` of the model; 9d
   every object read with the holes of each erasure class of PERF.md §2
   (decode window 8, 8 objects a read), and four holes giving -EIO from
   osd.4.  Pool rgw (append-only, the hinfo path): 9e 16 objects of 4
   stripe-aligned 1 MiB appends, every shard's hinfo equal to its crc32c
   (the C++ library; the table version on one object's shards), then one
   byte of shard 0 flipped on 4 objects, each read back exact by
   redundant-read escalation with 4 crc mismatches logged.  Every part:
   each commit fires once and no failure, nothing left in flight or
   pinned after the barrier, the in-flight pools at 0, the aggregators'
   launches = the change in LAUNCHES (DECODE_LAUNCHES) = the change in
   the tier's kernel count (swar_gf), no fallback, the guard never
   degraded, one committed flight record a launch; under 90 s.  Printed
   beside the card's name and power limit: MB/s of 9a, RMW writes/s with
   p50 and p99 submit-to-commit latency, read and degraded-read GB/s,
   the median `ec_encode_latency`, the flight spans' medians, and the
   stage split of 9a (QD8) and 9e.
10. Recovery and the other codecs.  Phase 1 also builds
   csrc/gf2_plane.cu (ptxas's registers; fails on a spill).  10a:
   `gf2_plane_matmul` (jerasure's bit-matrix techniques) against its plain
   version (`gf2_plane_matmul_reference`) and a numpy oracle, byte for
   byte, for the encode matrices of liberation (k = 4, 7; w = 7),
   blaum_roth (k = 4, w = 6) and liber8tion (k = 4, 8) and the decode plan
   of every one- and two-erasure pattern of liberation k = 4, at packets of
   4, 8, 32, 2048 and 2052 bytes and 1, 3 and 256 super-packets, and on two
   strided views; then timed (median of 20 runs of 5 calls) at liberation
   k = 7, w = 7, (2048, 49, 2048), beside its bound and its plain version.
   10b: the Ceph documentation's example profile of every plugin
   (jerasure reed_sol_van, cauchy_good and liberation, isa, shec, lrc,
   clay, xor) built with no device argument: 16 objects of 4 MiB through
   `encode`, then every erasure set up to m that `minimum_to_decode`
   accepts through `decode`, each equal to the same call on
   device="cpu"; the launches of swar_gf, packed_code, the xor_matmul tier
   and gf2_plane_matmul printed by plugin (gf2_plane_matmul's counts set
   to 0 just before and read just after: the `kernels` line's launches).
   10c: recovery through ECBackend on 11 OSDs (phase 9's pool rbd, RS(8,3),
   stripe unit 4096): 64 objects of 4 MiB written, then for each loss of
   [3], [9], [0] (the primary's own), [3, 9] and [0, 5, 10] the shards
   wiped and marked missing, `recover_object` for all 64 and the queue
   drained, the barrier only when it runs dry (decode window 8): every
   rebuilt shard and its attrs equal the
   bytes before the loss, every callback 0, fewer decode launches than
   objects (each a swar_gf launch and a clean flight record, no fallback);
   printed: MB/s of logical and of rebuilt shard bytes, the median
   `ec_decode_latency`, the decode launches and the flight spans.  10d:
   CLAY k = 4, m = 2, d = 5 on 6 OSDs, 16 objects of 4 MiB, shard 1 lost and
   recovered exact from fragments, fewer than 4 whole chunks an object
   read from the helpers (d helpers x 1/q of a chunk = 2.5).
   Phases 9 and 10 run at the option defaults, so the device chunk cache
   (32 MiB) and the RMW delta path are on: a write on pool rbd seeds its
   chunks, a reconstruct or a rebuild the cache serves commits a `#cache`
   flight record and launches nothing, and a cache-hit RMW launches
   packed_delta (a `#delta` record); each part counts them beside the
   aggregators' launches.
11. Deep scrub, the device chunk cache and the RMW delta path
   (osd/scrubber.py, ops/device_cache.py, the cache branches of
   osd/ec_backend.py) on phase 9's harness at the option defaults, launch
   counts set to 0 just before and read just after (the `kernels` line's
   launches of packed_verify and packed_delta add these to phase 7b's).
   11a: PgScrubber deep-scrubs 100 objects of 4 MiB on the append-only
   pool (RS(8,3), stripe unit 4096, 11 OSDs: the parity verify needs the
   hinfo digests, which an allow_ec_overwrites pool drops) in 4 scrub
   chunks of 25, each one packed_verify launch of (3200, 11, 4096) through
   the backend's verify aggregator, every bitmap equal to
   `verify_array_host`; GB/s of codewords verified and the verify spans
   printed.  First one flipped shard byte (caught by its digest, repaired
   through recover_object) and one data shard corrupted with its hinfo
   rewritten to match (caught only by the parity verify, `unrepairable`,
   repair refused) in one repair scrub; then, the forged shard restored,
   a clean rescrub, the one timed.  11b: 4 hot
   RBD objects of 4 MiB on pool rbd (22 MiB resident after their
   WRITEFULLs), 256 seeded overwrites of 4-64 KiB inside a 64 KiB region
   of each at QD1, with the delta path and then without it
   (`ec_tpu_rmw_delta` false) on a fresh cluster: packed_delta launches and
   materialize launches sum to the writes, every delta record has h2d_s
   == d2h_s == 0, every byte reads back and every shard equals
   `encode_array_host` of the model; writes/s, p50 and p99 of both.  11c:
   each hole class of phase 9d read twice on the hot objects from an empty
   cache: the first decodes, the second is served by one D2H an object
   with no decode launch and its hits counted.  11d: `codec.launch` armed
   on a delta dispatch (EIO, DEGRADED, cache and ledger bytes 0, nothing
   re-encoded, the cuda probe heals, the next write materializes); armed
   on a verify launch (the deep scrub aborts, never clean); the mempool
   pressure layer at a target of the tracked bytes (stage 1 trims the
   cache, the ledger's device_cache bytes fall by what it trimmed).
   Under 60 s; the phase's and the whole script's times printed.
12. BlueStore under the EC write path, with the checksum service and the
   device compressor (os/bluestore.py, ops/checksum_offload.py,
   compressor/device.py) and their three kernels, csrc/crc32c.cu,
   csrc/compress_transform.cu and csrc/xor_reduce.cu (phase 1 builds them
   with the others and prints their ptxas registers and spills; phase 3
   counts the xor_reduce launches of its single erasures under the all-ones
   parity row, and 10b those of plugin xor).  12a: each kernel against its
   plain version and its host oracle, byte for byte, on dense rows and on a
   misaligned strided view: crc32c at L in {1, 3, 63, 64, 100, 4095, 4096,
   4097, 65536} and S in {1, 7, 128, 1408, 11264} (up to 64 MiB of rows;
   the plain version, whose bit planes take 32 bytes a byte, up to 48
   MiB), and on zero-heavy, all-zero and constant rows (the patterns whose
   table reads broadcast) at L in {4096, 4097, 65536}; the transform at Lp
   in {64, 128, 192, 4032, 4096, 4160, 65536, 8192, 262144} (up to 96 MiB
   of rows; each launch counted on the path the C entry chose, tiles
   exactly where Lp % 4096 == 0); xor_reduce at k in
   {1, 2, 8, 11}, lead shapes of rank 1 and 2.  Phase 1 prints ptxas's
   registers of crc32c_kernel and transform_tiles_kernel, the SASS of
   crc32c's step loop (fails unless it reads each of its 59 tables once)
   and the tile kernel's PRMT/LDGSTS/STG.E.128, and fails on local memory
   in either.  12b: each kernel at its bulk shape
   ((65536, 4096); (256, 8, 131072) for xor_reduce) and at the path's
   ((11264, 4096) and (128, 4096); (1, 8, 524288)), median of 20 runs of
   5 calls, beside its bound and plain version, and the transpose alone
   beside the transform; crc32c also on zero-heavy bulk rows, the
   transform's general path at (65536, 4160); with --parent, the older
   tree's two kernels at those shapes, in turns with this one's.  12d
   checks that every transform launch of BlueStore's 4 KiB blocks took
   the tile path.  12c: phase 9's pool rbd (RS(8,3),
   stripe unit 4096, 11 OSDs) over in-memory BlueStores, 64 WRITEFULLs of
   4 MiB at QD1 and QD8, the checksum offload off and then on (fresh
   clusters); MB/s, crc32c launches a write, the blocks the stores
   checksum and those `_csum_submit` submits apart, the csum service's
   flight spans; every object read back whole (csum-verified), and every
   shard's block image and KV records equal with the offload off and on.
   12d: the same with `bluestore_compression_algorithm = device` at
   Ceph's default required ratio 0.875, objects of half random pages and
   half record pages (64-byte records, 16 nonzero bytes each): the share
   of blocks stored compressed, stored over logical bytes, transform
   launches, MB/s; every stored blob equal to the host oracle's, every
   object read back.  12e: an on-disk BlueStore (umount and mount, WAL
   replay after a simulated crash, a flipped byte is EIO with the offload
   on); `codec.launch` armed on the stores' csum and then compress
   launches: the write fails with EIO, no shard commits, the backend goes
   DEGRADED with no host recompute, the cuda probe heals it and the next
   write commits.  Under 60 s.
13. The placement-group layer: 12 in-process OSD hosts on MemStores
   (tests/torch_pg_host.py, the host the CPU tests hold against the JAX
   package's PGs), a flat CRUSH tree of one OSD a host, pool `rbd` (EC
   RS(8,3) plugin `tpu` reed_sol_van, stripe_unit 4096,
   allow_ec_overwrites, pg_num 32, Ceph's osd_pool_default_pg_num) and
   pool `rbd_meta` (replicated size 3, pg_num 32), every EC PG's codec on
   the card (`PG(..., device=None)`), a PG log of at most 2 entries so that
   the members CRUSH adds after an out backfill.  Client ops reach
   `PG.do_op` on each object's primary.  13a: 128 WRITEFULLs of 4 MiB
   `rbd_data.*` objects, 64 at QD1 and 64 at QD8 (MB/s); 13b: every object
   read whole at QD8 (GB/s); 13c: osd.3 marked down (seconds from the map
   to every PG active), every object read degraded; 13d: osd.3 marked out
   (seconds to active and to clean, bytes pushed by recovery and backfill,
   MB/s), every object read; 13e: 16 objects of 4 MiB written to pool
   `rgw_data` (EC RS(8,3), append-only, pg_num 8: RGW's bucket data, whose
   objects keep hinfo), then a deep scrub of its PG with the most objects
   (the parity verify) and of rbd's (an overwrites pool keeps no hinfo, so
   digests and sizes only), both clean; 13f: 256 overwrites of 4-64 KiB in a 64 KiB hot region
   of 8 objects at QD1 (writes/s), read back against a model; 13g: 64
   `rbd_header.*` objects of 4 KiB with omap written and read back on
   rbd_meta (ops/s).  Every byte is checked against what was written.  The
   launch counts of swar_gf, xor_reduce, packed_verify and packed_delta
   are set to 0 before 13a and read after each part: 13a launches
   swar_gf (encode), 13c and 13d swar_gf (the backend's decodes, single
   erasures included: they go through the decode aggregator, not
   xor_reduce, whose count is printed), 13e packed_verify and 13f
   packed_delta, or the run fails; no launch falls back to the host, the
   guard never degrades and no PG logs a cluster error.

14. The OSD daemon: 12 port `OSD` daemons in this process on the card,
   each on its own BlueStore in a temporary directory, over the `posix`
   messenger on loopback (Ceph's default `ms_type`) with cephx on (a
   generated keyring; `ms_secure` off), booting through their MonClient
   against the test-side map service of tests/torch_daemon_host.py (it
   answers subscriptions and boots, and marks a daemon down once two peers
   report it); the pools of phase 13.  Client ops go over the wire from
   that file's small client.  Cuts: one host, heartbeats every 0.25 s with
   a 1.5 s grace, the out given by the map service, scrub timers of 2 s.
   14a boot to every PG active and clean (s); 14b 64 WRITEFULLs of 4 MiB
   on rbd at QD1 and QD8 (MB/s), whole reads (GB/s); 14c QD8 again after
   `bluestore_csum_offload` is set through each daemon's admin socket
   (`injectargs` with `conf`; MB/s and crc32c launches), then set back to
   its default, off; 14d osd.3's
   daemon stopped (s to the down epoch its peers' MOSDFailures bring,
   degraded-read GB/s); 14e osd.3 out (s to clean, MB/s rebuilt, the
   recovery-storm controllers' waves); 14f 16 objects on rgw_data, then
   the daemon's own scrub timer deep-scrubs one of its PGs (s,
   packed_verify launches); 14g 256 hot-region overwrites at QD1 (writes/s,
   packed_delta launches); 14h a watch/notify round trip and a COPY_FROM
   (ms); 14i a launch fault armed on one daemon through `injectargs`: the
   op gets EIO, `tpu_backend.degraded` turns true, the probe heals it and
   the next write lands.  Each part's flight records are read through an
   admin socket's `dump_flight` (queue wait, h2d, kernel, d2h summed, and
   the kernel's share of the part's wall time).  The launch counts are
   set to 0 before 14a and read after each part: 14b-14e launch swar_gf,
   14c crc32c, 14f packed_verify and 14g packed_delta, or the run fails;
   every daemon's status blob reads fallback_launches 0, and any daemon
   marked down other than osd.3 is reported.
15. The control plane: phase 14's 12 daemons and pools, booted, placed,
   failed, marked out and reconfigured by 3 port `Monitor`s in a Paxos
   quorum (their EC profile checks' codecs on the card) and a port `Mgr`,
   all over the `posix` messenger with cephx, from
   tests/torch_daemon_host.py's `DaemonCluster(mons=3)`; the pools made by
   commands (`osd erasure-code-profile set`, `osd pool create`).  Cuts:
   32 objects of 4 MiB on rbd, `mon_osd_down_out_interval` 3 s (Ceph's
   600), phase 14's heartbeats and PG log.  15a seconds to the quorum,
   the mgr active, every OSD up through `OSDMonitor.prepare_boot`, the
   pools, every PG active and clean; 15b WRITEFULLs at QD1 and QD8 (MB/s),
   whole reads (GB/s); 15c the leader monitor stopped under a QD8 write
   batch (s to a quorum of 2 through the lease, s to MON_DOWN, every write
   read back), then restarted with an empty store (s to a quorum of 3 with
   its last_committed caught up); 15d osd.3's daemon stopped (s to down
   through `prepare_failure`, degraded-read GB/s, s to the down-out
   timer's out, s from the out to clean, MB/s rebuilt); 15e `config set
   osd bluestore_csum_offload true` through ConfigMonitor (s until every
   daemon has it, QD8 MB/s, crc32c launches); 15f `config set` of the
   scrub timer deep-scrubs an rgw_data PG (packed_verify launches); 15g a
   launch fault through `injectargs`: s until TPU_BACKEND_DEGRADED shows
   in `ceph health` through the mgr, s until it clears after the probe
   heals the guard.  Each part reads its flight spans, counts its
   elections (the quorum's election epoch; fails above one in 15a, two
   in 15c and none elsewhere), fails if a daemon other than osd.3 was
   marked down (the monitors' cluster log) or if a monitor stopped on a
   device error.
16. The client and the operator's view: phase 15's cluster anew (3
   monitors, 12 daemons on BlueStore, posix, cephx, the same pools), the
   port's `Mgr` with ten modules (vstart's eight: prometheus, dashboard,
   telemetry, orchestrator, progress, iostat, metrics_history, clog; and
   the balancer and pg_autoscaler in their default advise and warn
   modes), prometheus served on 127.0.0.1 and the mgr's admin socket on;
   every op through the port's `Rados` as `client.admin` with the
   generated key, none through the test host's client.  Cuts: 32 objects,
   a 64 MiB image, one out.  16a seconds to every PG clean and to
   `Rados.connect`; 16b 32 `IoCtx.write_full` of 4 MiB on rbd, half at
   QD1 and half at QD8 (MB/s), read back byte-exact (GB/s), the iostat
   module's rbd write ops equal to the writes issued, `iostat top` on the
   mgr's admin socket listing client.admin; 16c a 64 MiB image through
   `striper.StripedObject` over 4 MiB objects (RBD's default layout),
   written and read back byte-exact (MB/s), a `cls_lock` lock and unlock on
   `rbd_header.img16` and a `cls log` add and list on rbd_meta through
   `cls/client.py` and `IoCtx.exec`; 16d a prometheus scrape over HTTP that
   passes tests/test_metrics_lint.py's `lint_exposition` (its copy,
   tests/torch_metrics_lint.py, which imports neither package), with nonzero
   ec_dispatch, ec_aggregator and trace families, and osd.0's
   `launches_per_sec` history over 16b-16c within 20% of the dispatch
   counters' rate (every daemon of the process reports the same
   process-wide counters, so the cluster series is about 12 times one
   daemon's); 16e `osd out 3` as a mon command from `Rados`: seconds to
   clean and MB/s rebuilt, the progress module's events and storm bar,
   each event to done == total and counted completed (none expired), the
   health checks PG_RECOVERY_STALLED and TPU_* raised on the way, a
   nonzero recovery_storm family, and `perf history ls` / `get` on the
   mgr's admin socket.  swar_gf launches in 16b, 16c and 16e;
   `fallback_per_sec` stays 0 and every daemon's fallback_launches reads
   0; the phase fails above 150 s.
17. The access layers: phase 16's cluster built anew the same way (3
   monitors, 12 daemons on BlueStore, posix, cephx, the mgr with its ten
   modules) with one more pool, rbd_peer (phase 13's rbd shape at pg_num
   8), and Ceph's heartbeat interval, grace and down-out interval; every
   op through the port's `Rados` as `client.admin`.  17a an RBD image of 128 MiB at order 22 on rbd
   (RS(8,3), `allow_ec_overwrites`): written whole in 4 MiB writes at QD1
   and again at QD8, read back byte-exact, 256 random overwrites of 4-64
   KiB (QD8, distinct objects in flight), a snapshot, 8 writes after it read at the snapshot and at the
   head, the snapshot protected and cloned, a copy-up write in the clone,
   a flatten, the clone's export (which holds every overwrite) equal to
   the host model; 17b a journaled 32 MiB image with 16 writes of 1
   MiB mirrored by `MirrorDaemon.sync_once` into rbd_peer (seconds from
   the last write until the destination equals the source, replay MB/s);
   17d the `fs` library with the metadata on rbd_meta and the data on
   rbd: 64 files of 256 KiB-4 MiB in 8 directories written, listed, read
   back (QD8) and renamed; 17c the gateway on rgw_data (append-only) at RGW's
   4 MiB stripe: S3 over HTTP on 127.0.0.1 signed with `sign_v2`, 32
   PUTs of 4 MiB (16 at QD1, 16 at QD8 into 8 buckets), GETs at QD8, 32
   ranged reads of 1 MiB at QD8 (through the striper: the S3 front end
   serves no Range), a 32 MiB multipart upload in parts of 8 MiB, Swift's
   token, 8 PUTs of 1 MiB and 8 GETs at QD8, then osd.3 stopped and 8 GETs of objects with a data shard
   on it, byte-exact, which decode on `swar_gf`.  MB/s for each step and
   the `swar_gf` and `packed_delta` launches of each; `swar_gf` launches
   in every part; no fallback; the phase fails above 400 s.

The last line of standard output is one JSON object,
{"ok": true, "device": {...}}; the line before it lists each kernel.
There is no CPU branch: without CUDA the script exits non-zero.
"""

from __future__ import annotations

import argparse
import atexit
import collections
import ctypes
import functools
import inspect
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

T_START = time.perf_counter()
SEED = 20261016
# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data
# sheet): HBM3 bandwidth, and INT32 issue rate = 64 lanes/SM x 132 SMs x
# 1.98 GHz (half the fp32 lanes behind the 67 TFLOP/s float32 figure).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# Dense tensor-core rates of the same sheet, ops (2 per multiply-add) a second.
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12
# 32-bit ops of one SWAR multiply-by-x of 4 packed GF(2^8) bytes,
# ((w << 1) & 0xfefefefe) ^ (((w >> 7) & 0x01010101) * 0x1d):
# shl, shr, and, imul, and one LOP3 for the closing and-xor.
XTIME_OPS = 5


# Phase 2's (chunk length, stripes): the TPU on-chip test geometries, and
# the main path's own shape (one 4 MiB RS(8,3) object: 512 KiB chunks).
SHAPES = [(L, S) for L in (128, 256, 512, 131072) for S in (1, 2, 256)] + [(524288, 1)]
# Phase 5's (S, k, L): one chunk of 4 KiB, 128 KiB (the scripts' CHUNK) and
# 512 KiB (the main path's), and two batches.
DIAG_SHAPES = [(1, 8, 4096), (1, 8, 131072), (1, 8, 524288), (8, 8, 16384), (64, 8, 131072)]
# Phase 6's (S, k, L) for RS(8,3) (every grouped variant divides both), and
# for RS(4,2).
BITMATRIX_SHAPES = [(8, 8, 4096), (64, 8, 131072)]
BITMATRIX_RS42_SHAPE = (8, 4, 4096)
# mm_only's other geometries (k, m): K padded (8k = 40 -> 48), 8m = 32 with
# 8k = 80, and 8m = 8 with K padded (24 -> 32); at (8, k, 4096).
MM_ONLY_GEOMETRIES = [(5, 2), (10, 4), (3, 1)]
# mm_only's instances in csrc/bitmatrix.cu, mm_only_kernel<8m/8, ceil(8k/16)>:
# RS(8,3)'s, and the largest (the most operand fragments in registers).
MM_ONLY_RS83 = "mm_only_kernelILi3ELi4E"
MM_ONLY_LARGEST = "mm_only_kernelILi4ELi8E"
# The int8 grouped kernel's instances, grouped_imma_kernel<k-steps of 4
# chunks, columns of a warp's stage>: RS(8,3)'s (2 steps, 256 columns), and
# the largest (8 steps: the most A fragments in registers).
GROUPED_IMMA_RS83 = "grouped_imma_kernelILi2ELi256E"
GROUPED_IMMA_LARGEST = "grouped_imma_kernelILi8ELi256E"
# The bf16 grouped kernel's instances, grouped_hgmma_kernel<words of 4
# chunks, columns of a warp's stage>: RS(8,3)'s (2 words, 256 columns), and
# the largest (4 words: the most A fragments in registers).
GROUPED_HGMMA_RS83 = "grouped_hgmma_kernelILi2ELi256E"
GROUPED_HGMMA_LARGEST = "grouped_hgmma_kernelILi4ELi256E"
GROUPED_HGMMA_MAX_REGISTERS = 168  # 3 blocks of 128 threads an SM
# The grouped kernels' other geometries, both operand types, (label, k, m,
# shape, (g, tile) pairs): m = 1, padded chunks (k = 5), m = 4 (also g·k =
# 80), two passes (m = 6), chunk groups (k = 40 at g = 2; k = 96, which also
# takes narrower stages), one warp's ring stage a tile (256) and two (512),
# a tile that is not a multiple of 16, and the smallest tile (4).
GROUPED_GEOMETRIES = [
    ("rs31-van-encode", 3, 1, (8, 3, 4096), [(1, 4096)]),
    ("rs52-van-encode", 5, 2, (8, 5, 4096), [(1, 4096), (2, 2048)]),
    ("rs104-van-encode", 10, 4, (8, 10, 4096), [(1, 4096), (2, 2048), (8, 4096)]),
    ("rs66-cauchy-encode", 6, 6, (8, 6, 4096), [(1, 4096), (2, 2048)]),
    ("rs402-van-encode", 40, 2, (8, 40, 4096), [(2, 4096)]),
    ("rs83-van-encode", 8, 3, (8, 8, 4096), [(1, 256), (4, 512)]),
    ("rs83-van-encode", 8, 3, (8, 8, 4112), [(1, 1028), (2, 1028)]),
    ("rs83-van-encode", 8, 3, (8, 8, 1024), [(1, 4), (2, 4)]),
    ("rs964-van-encode", 96, 4, (2, 96, 4096), [(1, 4096)]),
]
# swar_gf_kernel<rows> instances in csrc/swar_gf.cu (rows of a pass: 1-4),
# and RS(8,3)'s (3 rows, one pass).
SWAR_GF_INSTANCES = [f"swar_gf_kernelILi{rows}E" for rows in range(1, 5)]
SWAR_GF_RS83 = "swar_gf_kernelILi3E"
# The bulk shape every kernel is timed at, and the calls timed per run.
BULK = (256, 8, 131072)
CALLS_PER_RUN = 5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def card_line() -> str:
    proc = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def ring_word_ops(mat) -> int:
    """Integer ops per 32-bit word position of the k chunks that the coding
    function needs, counted on Horner's ring program over the packed bytes
    as stored (the construction ops/packed_gf.py picks for RS(8,3), 47
    program ops): per output row, XOR the chunks of each coefficient bit and
    chain multiply-by-x from the top bit down.  The ALU side of bound_ms."""
    ops = 0
    for row in np.asarray(mat, dtype=np.uint8):
        levels = [sum((int(c) >> b) & 1 for c in row) for b in range(8)]
        nonzero = [b for b in range(8) if levels[b]]
        if not nonzero:
            continue
        top = nonzero[-1]
        ops += levels[top] - 1 + XTIME_OPS * top
        # a lower level: its XOR chain (n - 1) and one XOR into the sum
        ops += sum(levels[b] for b in range(top))
    return ops


def kernel_word_ops(plan, swar) -> int:
    """Integer ops per 32-bit word position of the k chunks that
    csrc/swar_gf.cu itself does (a diagnostic, not the bound), over the
    rows padded to whole passes: per pass, a nibble swap of each chunk word
    (3 ops), two LOP3 per (row, pair, chunk) (acc ^= (w & A) ^ (ws & B)),
    and per row the two last levels of the parity butterfly (3 merges of 5
    ops)."""
    passes, rows = swar.pass_geometry(plan.m)
    return passes * (3 * plan.k + rows * (8 * plan.k + 3 * 5))


def time_ms(torch, fn, warmup: int = 3, reps: int = 20) -> float:
    """Median over `reps` runs of the CUDA-event time of CALLS_PER_RUN
    back-to-back calls of fn(), per call, after `warmup` calls.  Back-to-back
    calls let the host enqueue a launch while the card runs the previous
    one, so the host's per-call cost stays out of a kernel's time unless it
    is the larger."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(CALLS_PER_RUN):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / CALLS_PER_RUN)
    return statistics.median(times)


def baked_matrices(gf):
    """The matrices the baked kernels are built for (phase 1) and checked on
    (phase 5): RS(8,3) encode of both techniques, and one decode matrix."""
    van = gf.isa_rs_vandermonde_matrix(8, 3)
    dec, _ = gf.isa_decode_matrix(van, [0, 5, 10], 8)
    return [("rs83-van-encode", van[8:]),
            ("rs83-cauchy-encode", gf.isa_cauchy_matrix(8, 3)[8:]),
            ("rs83-van-decode[0,5,10]", dec)]


def ptxas_lines(info: dict, kernel: str | None = None) -> list[str]:
    """ptxas's register and spill lines, of the functions whose mangled
    name contains `kernel` (all functions if None)."""
    lines, mine = [], kernel is None
    for line in info.get("ptxas", "").splitlines():
        if "Compiling entry function" in line and kernel is not None:
            mine = kernel in line
        elif mine and ("registers" in line or "spill" in line):
            lines.append(line.replace("ptxas info    :", "").strip())
    return lines


@functools.cache
def sass_text(tool: str, library: str) -> str:
    proc = subprocess.run([tool, "-sass", library], capture_output=True, text=True,
                          timeout=120)
    check(proc.returncode == 0, f"cuobjdump failed: {proc.stderr.strip()}")
    return proc.stdout


def sass_section(nvcc: str, library: str, kernel: str) -> str | None:
    """The SASS listing of the function of `library` whose name contains
    `kernel`; None if the toolkit has no cuobjdump."""
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    if not os.path.exists(tool):
        return None
    for section in sass_text(tool, library).split("Function : ")[1:]:
        if kernel in section.splitlines()[0]:
            return section
    check(False, f"no function {kernel} in the SASS of {library}")


_SASS_INSTRUCTION = re.compile(
    r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;\n]*)")


def sass_opcodes(nvcc: str, library: str, kernel: str):
    """Counter of the SASS opcodes (e.g. "LOP3.LUT", "LDG.E.128.CONSTANT")
    of the function of `library` whose name contains `kernel`; None if the
    toolkit has no cuobjdump."""
    section = sass_section(nvcc, library, kernel)
    if section is None:
        return None
    return collections.Counter(m.group(2) for m in _SASS_INSTRUCTION.finditer(section))


def sass_loops(nvcc: str, library: str, kernel: str):
    """The loops of the function of `library` whose name contains `kernel`:
    for each backward branch, the opcodes from its target to the branch, in
    order.  None if the toolkit has no cuobjdump."""
    section = sass_section(nvcc, library, kernel)
    if section is None:
        return None
    ops, labels, pending = [], {}, []
    for line in section.splitlines():
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label:
            pending.append(label.group(1))
            continue
        inst = _SASS_INSTRUCTION.search(line)
        if inst:
            addr = int(inst.group(1), 16)
            for name in pending:
                labels[name] = addr
            pending = []
            ops.append((addr, inst.group(2), inst.group(3)))
    loops = []
    for n, (addr, op, args) in enumerate(ops):
        target = re.search(r"0x([0-9a-f]+)|(\.L_x_\d+)", args) if op.startswith("BRA") else None
        if target is None:
            continue
        dest = int(target.group(1), 16) if target.group(1) else labels.get(target.group(2))
        if dest is not None and dest <= addr:
            loops.append([o for a, o, _ in ops[: n + 1] if a >= dest])
    return loops


def count_prefix(ops, prefix: str) -> int:
    return sum(n for op, n in ops.items() if op.startswith(prefix))


def phase_env(torch, swar, gf, diag, kern_exp, packed, xor_mm, nvcc):
    kern_exp2, kern_exp3, kern_exp4 = diag[:3]
    name = torch.cuda.get_device_name(0)
    card = card_line()
    print(f"[1] device: {name}  count={torch.cuda.device_count()}")
    print(f"[1] nvidia-smi: {card}")
    print(f"[1] torch {torch.__version__} cuda {torch.version.cuda}")
    release = subprocess.run([nvcc, "--version"], capture_output=True, text=True, timeout=60)
    print(f"[1] nvcc: {release.stdout.strip().splitlines()[-2:]} (csrc/packed_gf.cu needs 12.1+)")

    def swar_gf_info():
        swar.build_library()
        return swar.build_info

    def packed_gf_info():
        packed.build_library()
        return packed.build_info

    def gf2_plane_info():
        xor_mm.build_library()
        return xor_mm.build_info

    def xor_reduce_info():
        xor_mm.build_xor_reduce_library()
        return xor_mm.xor_reduce_build_info

    def crc32c_info():
        from ceph_tpu_torch.ops import checksum_offload

        checksum_offload.build_library()
        return checksum_offload.build_info

    def compress_transform_info():
        from ceph_tpu_torch.compressor import device

        device.build_library()
        return device.build_info

    jobs = {"swar_gf": swar_gf_info, "copy_floor": lambda: kern_exp4.build().info,
            "bitmatrix": lambda: kern_exp.build().info, "packed_gf": packed_gf_info,
            "gf2_plane": gf2_plane_info, "xor_reduce": xor_reduce_info,
            "crc32c": crc32c_info, "compress_transform": compress_transform_info}
    for label, mat in baked_matrices(gf):
        jobs[f"swar_baked {label}"] = lambda mat=mat: kern_exp2.make_swar(mat, 128).build().info
        jobs[f"swar3_baked {label}"] = (
            lambda mat=mat: kern_exp3.make_swar3(mat, 128, 256).build().info)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        futures = {label: pool.submit(job) for label, job in jobs.items()}
        infos = {label: future.result() for label, future in futures.items()}
    print(f"[1] built {len(jobs)} libraries in {time.perf_counter() - t0:.2f} s "
          "(one nvcc each, all started together)")
    for label, info in infos.items():
        print(f"[1] {label}: {info['seconds']:.2f} s, sha256 {info['source_sha256']}")
        # bitmatrix has 32 mm_only instances: its checked kernels are below,
        # as are packed_gf's
        for line in ptxas_lines(info) if label not in ("bitmatrix", "packed_gf") else []:
            print(f"[1]   ptxas: {line}")
    copy_ops = sass_opcodes(nvcc, infos["copy_floor"]["library"], "copy_floor_kernelILi8E")
    if copy_ops is None:
        print("[1] SASS: no cuobjdump in the toolkit, not counted")
    else:
        loads, stores = count_prefix(copy_ops, "LDG.E.128"), count_prefix(copy_ops, "STG.E.128")
        print(f"[1] copy_floor_kernel<8> SASS: {loads} LDG.E.128, {stores} STG.E.128 "
              "(every path of the loop reads all 8 chunks)")
        check(loads > 0 and loads % 8 == 0 and stores >= 3,
              f"copy_floor_kernel<8> SASS has {loads} 16-byte loads, {stores} stores")
        # the loop body codes one 16-byte vector (4 words) of each chunk
        ops = sass_opcodes(nvcc, infos["swar_baked rs83-van-encode"]["library"],
                           "swar_baked_kernel")
        total = sum(ops.values())
        mix = ", ".join(f"{op} {n}" for op, n in ops.most_common(8))
        print(f"[1] swar_baked_kernel (rs83-van-encode) SASS: {total} instructions, "
              f"{total / 4:.1f} per word (TPU program as written: 539); {mix}")
        # expand_only runs on the CUDA cores: no HMMA/IMMA/HGMMA/IGMMA...
        # (HFMA2.MMA, a move idiom on the FMA pipe, is not a matrix op);
        # mm_only on the tensor cores: HMMA (mma.sync); the grouped kernels:
        # IGMMA (int8) and HGMMA (bf16), wgmma's products
        for kernel in ("expand_only_kernel", MM_ONLY_RS83, GROUPED_IMMA_RS83, GROUPED_HGMMA_RS83):
            ops = sass_opcodes(nvcc, infos["bitmatrix"]["library"], kernel)
            mma = sum(n for op, n in ops.items() if op.split(".")[0].endswith("MMA"))
            mix = ", ".join(f"{op} {n}" for op, n in ops.most_common(8))
            print(f"[1] bitmatrix {kernel} SASS: {sum(ops.values())} instructions, "
                  f"{mma} tensor-core; {mix}")
            if kernel == MM_ONLY_RS83:
                hmma = count_prefix(ops, "HMMA")
                print(f"[1] bitmatrix {kernel}: {hmma} HMMA, {count_prefix(ops, 'LDSM')} LDSM, "
                      f"{count_prefix(ops, 'LDGSTS')} LDGSTS, {count_prefix(ops, 'F2I')} F2I")
                check(hmma > 0, f"bitmatrix {kernel}: no HMMA in its SASS")
            elif kernel in (GROUPED_IMMA_RS83, GROUPED_HGMMA_RS83):
                want = "IGMMA" if kernel == GROUPED_IMMA_RS83 else "HGMMA"
                n = count_prefix(ops, want)
                print(f"[1] bitmatrix {kernel}: {n} {want}, {count_prefix(ops, 'IMMA')} IMMA, "
                      f"{count_prefix(ops, 'LDS')} LDS, {count_prefix(ops, 'SHFL')} SHFL, "
                      f"{count_prefix(ops, 'PRMT')} PRMT, {count_prefix(ops, 'LOP3')} LOP3, "
                      f"{count_prefix(ops, 'FADD')} FADD, {count_prefix(ops, 'LDGSTS')} LDGSTS")
                check(n > 0, f"bitmatrix {kernel}: no {want} in its SASS")
            else:
                check(mma == 0, f"bitmatrix {kernel}: {mma} tensor-core instructions")
    check_swar_gf_build(nvcc, infos["swar_gf"])
    check_packed_build(infos["packed_gf"])
    for label, kernel in (("gf2_plane", "gf2_plane_kernel"), ("xor_reduce", "xor_reduce_kernel"),
                          ("crc32c", "crc32c_kernel"),
                          ("compress_transform", "transform_kernel"),
                          ("compress_transform", "transform_tiles_kernel")):
        lines = ptxas_lines(infos[label], kernel)
        check("ptxas" not in infos[label] or len(lines) >= 2, f"no ptxas lines for {label}")
        check(not any("spill" in line and not re.search(r"\b0 bytes spill stores", line)
                      for line in lines), f"{kernel} spills: {lines}")
    check_bluestore_sass(nvcc, infos)
    for kernel in ("expand_only_kernel", MM_ONLY_RS83, MM_ONLY_LARGEST, GROUPED_IMMA_RS83,
                   GROUPED_IMMA_LARGEST, GROUPED_HGMMA_RS83, GROUPED_HGMMA_LARGEST):
        for line in ptxas_lines(infos["bitmatrix"], kernel):
            print(f"[1]   ptxas bitmatrix {kernel}: {line}")
    regs = [int(n) for line in ptxas_lines(infos["bitmatrix"], GROUPED_HGMMA_RS83)
            for n in re.findall(r"Used (\d+) registers", line)]
    check("ptxas" not in infos["bitmatrix"]
          or (regs and max(regs) <= GROUPED_HGMMA_MAX_REGISTERS),
          f"{GROUPED_HGMMA_RS83}: {regs} registers, want <= {GROUPED_HGMMA_MAX_REGISTERS}")
    for family in ("mm_only_kernel", "grouped_"):
        lines = ptxas_lines(infos["bitmatrix"], family)
        check("ptxas" not in infos["bitmatrix"] or lines, f"no ptxas lines for {family}")
        spills = [line for line in lines if "spill" in line and not (
            re.search(r"\b0 bytes spill stores", line)
            and re.search(r"\b0 bytes spill loads", line))]
        check(not spills, f"{family} instances spill: {spills}")
    return name, card, infos


def check_bluestore_sass(nvcc: str, infos: dict) -> None:
    """The redesigned crc32c and transform kernels as compiled: ptxas's
    registers of each; crc32c's innermost loop (one 1 KiB warp step: an LDS
    for each of its 52 L32 and 7 S1024 tables) and its opcode mix; the tile
    kernel's PRMT, LDGSTS, LDS and 16-byte stores.  Fails on local memory
    in either, or on a step loop that does not read its 59 tables."""
    from ceph_tpu_torch.ops import checksum_offload as co

    for label, kernel in (("crc32c", "crc32c_kernel"),
                          ("compress_transform", "transform_tiles_kernel")):
        for line in ptxas_lines(infos[label], kernel):
            print(f"[1]   ptxas {kernel}: {line}")
    loops = sass_loops(nvcc, infos["crc32c"]["library"], "crc32c_kernel")
    if loops is None:
        print("[1] SASS: no cuobjdump in the toolkit, crc32c and the tiles not counted")
        return
    tables = co.L_TABLES + co.S_TABLES
    step = min((loop for loop in loops
                if count_prefix(collections.Counter(loop), "LDS") >= tables), key=len, default=None)
    check(step is not None, f"crc32c_kernel: no loop with {tables} LDS "
                            f"({[len(x) for x in loops]} instructions)")
    mix = collections.Counter(step)
    lds = count_prefix(mix, "LDS")
    print(f"[1] crc32c_kernel step loop (1 KiB a warp): {len(step)} instructions, {lds} LDS "
          f"({len(step) - lds} others); " + ", ".join(f"{op} {n}" for op, n in mix.most_common(8)))
    check(lds == tables, f"crc32c_kernel: {lds} LDS in its step loop, want {tables}")
    for label, kernel in (("crc32c", "crc32c_kernel"),
                          ("compress_transform", "transform_tiles_kernelILb1E")):
        ops = sass_opcodes(nvcc, infos[label]["library"], kernel)
        local = count_prefix(ops, "LDL") + count_prefix(ops, "STL")
        print(f"[1] {kernel} SASS: {sum(ops.values())} instructions, {local} local; "
              f"{count_prefix(ops, 'PRMT')} PRMT, {count_prefix(ops, 'LDGSTS')} LDGSTS, "
              f"{count_prefix(ops, 'LDS')} LDS, {count_prefix(ops, 'STG.E.128')} STG.E.128, "
              f"{count_prefix(ops, 'SHFL')} SHFL, {count_prefix(ops, 'REDUX')} REDUX")
        check(local == 0, f"{kernel}: {local} local-memory instructions")


def check_swar_gf_build(nvcc: str, info: dict) -> None:
    """csrc/swar_gf.cu as compiled: ptxas's registers and spills of every
    swar_gf_kernel instance (none may spill; RS(8,3)'s at most 128
    registers), the SASS mix of RS(8,3)'s instance and of its 4-chunk loop,
    and no CALL (a called routine, such as 64-bit division) in any
    instance."""
    if "ptxas" not in info:
        print("[1] swar_gf: loaded from the build directory, ptxas not read")
    else:
        for kernel in SWAR_GF_INSTANCES:
            lines = ptxas_lines(info, kernel)
            print(f"[1] ptxas {kernel}: {'; '.join(lines)}")
            check(lines, f"no ptxas lines for {kernel}")
            spills = [line for line in lines if "spill" in line and not (
                re.search(r"\b0 bytes spill stores", line)
                and re.search(r"\b0 bytes spill loads", line))]
            check(not spills, f"{kernel} spills: {spills}")
            regs = [int(n) for line in lines for n in re.findall(r"Used (\d+) registers", line)]
            if kernel == SWAR_GF_RS83:
                check(regs and max(regs) <= 128, f"{kernel}: {regs} registers, want <= 128")
    lib = info["library"]
    ops = sass_opcodes(nvcc, lib, SWAR_GF_RS83)
    if ops is None:
        print("[1] swar_gf SASS: no cuobjdump in the toolkit, not counted")
        return
    mix = ", ".join(f"{op} {n}" for op, n in ops.most_common(8))
    print(f"[1] {SWAR_GF_RS83} SASS (whole kernel, static): {sum(ops.values())} instructions, "
          f"LOP3 {count_prefix(ops, 'LOP3')}, LDS {count_prefix(ops, 'LDS')}, "
          f"LDG.E.128 {count_prefix(ops, 'LDG.E.128')}, STG.E.128 {count_prefix(ops, 'STG.E.128')}, "
          f"CALL {count_prefix(ops, 'CALL')}; {mix}")
    for kernel in SWAR_GF_INSTANCES:
        calls = count_prefix(sass_opcodes(nvcc, lib, kernel), "CALL")
        check(calls == 0, f"{kernel}: {calls} CALL in its SASS")
    groups = [loop for loop in sass_loops(nvcc, lib, SWAR_GF_RS83)
              if sum(op.startswith("LDG.E.128") for op in loop) == 4]
    if not groups:
        print(f"[1] {SWAR_GF_RS83}: its 4-chunk loop was not found in the SASS")
        return
    body = collections.Counter(min(groups, key=len))
    n = sum(body.values())
    print(f"[1] {SWAR_GF_RS83} 4-chunk loop: {n} instructions for 4 chunks x 4 words "
          f"({n / 16:.1f} per chunk-word, {n / 2:.1f} per word at k = 8 before the fold); "
          f"LOP3 {count_prefix(body, 'LOP3')}, LDS {count_prefix(body, 'LDS')}, "
          f"LDG.E.128 {count_prefix(body, 'LDG.E.128')}; "
          + ", ".join(f"{op} {c}" for op, c in body.most_common(6)))


def check_packed_build(info: dict) -> None:
    """csrc/packed_gf.cu as compiled: ptxas's registers, spills and local
    memory (stack frame) of each instance of its three kernels (32 or 512
    rows); none may spill or use local memory (the slots live in shared
    memory)."""
    if "ptxas" not in info:
        print("[1] packed_gf: loaded from the build directory, ptxas not read")
        return
    for kernel in PACKED_KERNELS:
        for rows in (32, 512):
            name = f"{kernel}_kernelILi{rows}E"
            lines = ptxas_lines(info, name)
            print(f"[1] ptxas {kernel}_kernel<rows={rows}>: {'; '.join(lines)}")
            check(lines, f"no ptxas lines for {name}")
            bad = [line for line in lines if "spill" in line and not (
                re.search(r"\b0 bytes stack frame", line)
                and re.search(r"\b0 bytes spill stores", line)
                and re.search(r"\b0 bytes spill loads", line))]
            check(not bad, f"{name} spills or uses local memory: {bad}")


def phase_kernel_checks(torch, swar, gf, registry) -> int:
    """Kernel vs plain and vs oracle, then the views of fault C1 through
    `encode_array`; returns the max abs byte error."""
    dev = torch.device("cuda")
    mats = []
    for tech, build in (("van", gf.isa_rs_vandermonde_matrix),
                        ("cauchy", gf.isa_cauchy_matrix)):
        full = build(8, 3)
        mats.append((f"rs83-{tech}-encode", full[8:]))
        for erasures in ([0, 1], [0, 9], [9, 10], [0, 5, 10]):
            c, _ = gf.isa_decode_matrix(full, erasures, 8)
            mats.append((f"rs83-{tech}-decode{erasures}", c))
        mats.append((f"rs42-{tech}-encode", build(4, 2)[4:]))
        mats.append((f"rs52-{tech}-encode", build(5, 2)[5:]))
    # m = 4 (one pass of 4 rows), encode and a 4-erasure decode, and m = 6
    # (two passes of 3)
    van104 = gf.isa_rs_vandermonde_matrix(10, 4)
    mats.append(("rs104-van-encode", van104[10:]))
    c, _ = gf.isa_decode_matrix(van104, [0, 3, 10, 13], 10)
    mats.append(("rs104-van-decode[0, 3, 10, 13]", c))
    mats.append(("rs66-cauchy-encode", gf.isa_cauchy_matrix(6, 6)[6:]))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    max_err = 0
    cases = 0
    for label, mat in mats:
        plan = swar.CodingPlan(mat, device=dev)
        bm = gf.expand_matrix(mat)
        for L, S in SHAPES:
            data = torch.randint(0, 256, (S, plan.k, L), dtype=torch.uint8,
                                 device=dev, generator=gen)
            got = swar.swar_gf(plan, data)
            ref = swar.swar_code_reference(plan.sched, data)
            torch.cuda.synchronize()
            err = int((got.to(torch.int16) - ref.to(torch.int16)).abs().max())
            max_err = max(max_err, err)
            check(err == 0, f"{label} L={L} S={S}: kernel != plain (max err {err})")
            # the bitslice oracle costs seconds per MiB on the host: it
            # takes the first stripe up to 128 KiB, the table product
            # the last stripe at every length
            if L <= 131072:
                oracle = gf.xor_matmul_host_batch(bm, data[:1].cpu().numpy())
                check(np.array_equal(got[:1].cpu().numpy(), oracle),
                      f"{label} L={L} S={S}: kernel != bitslice oracle")
            table = gf.gf_matmul(mat, data[S - 1].cpu().numpy())
            check(np.array_equal(got[S - 1].cpu().numpy(), table),
                  f"{label} L={L} S={S}: kernel != table oracle")
            cases += 1
            del data, got, ref
    print(f"[2] kernel == plain == oracle on {cases} cases "
          f"({len(mats)} matrices, (passes, rows) "
          f"{sorted({swar.pass_geometry(len(mat)) for _, mat in mats})}), max_abs_err={max_err}")
    check_views(torch, swar, registry, gf)
    return max_err


def check_views(torch, swar, registry, gf) -> None:
    """Fault C1: `encode_array` of a strided and of a misaligned CUDA view
    goes through the kernel tier (one `swar_gf` launch each) and equals
    the GF(2^8) table product."""
    dev = torch.device("cuda")
    ec = registry.instance().factory("tpu", {"k": "8", "m": "3"})
    mat = ec.distribution_matrix()[8:]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)
    cw = torch.randint(0, 256, (2, 11, 4096), dtype=torch.uint8, device=dev, generator=gen)
    n = 2 * 8 * 4096
    buf = torch.randint(0, 256, (n + 16,), dtype=torch.uint8, device=dev, generator=gen)
    off = (1 - buf.data_ptr()) % 16
    views = {"cw[:, :8]": cw[:, :8], "base 1 byte past 16": buf[off:off + n].view(2, 8, 4096)}
    check(not views["cw[:, :8]"].is_contiguous(), "cw[:, :8] is contiguous")
    check(views["base 1 byte past 16"].data_ptr() % 16 == 1, "misaligned view is aligned")
    before = swar.launches
    for label, view in views.items():
        got = ec.encode_array(view).cpu().numpy()
        host = view.cpu().numpy()
        for s in range(host.shape[0]):
            check(np.array_equal(got[s], gf.gf_matmul(mat, host[s])),
                  f"encode_array({label}) stripe {s} != gf_matmul")
    torch.cuda.synchronize()
    launched = swar.launches - before
    print(f"[2] encode_array of views (fault C1): {', '.join(views)} == gf_matmul; "
          f"swar_gf launches {launched} for {len(views)} calls")
    check(launched == len(views), f"views: {launched} launches for {len(views)} calls")


def phase_main_path(torch, swar, registry, gf):
    """RS(8,3) encode + decode of 32 x 4 MiB objects through plugin `tpu`;
    returns the launches of swar_gf and of xor_reduce (the single erasures
    under the all-ones parity row)."""
    from ceph_tpu_torch.ops import xor_mm

    rng = np.random.default_rng(SEED)
    n_obj, obj_size = 32, 4 << 20
    objects = [rng.integers(0, 256, obj_size, dtype=np.uint8).tobytes()
               for _ in range(n_obj)]
    swar.launches = 0
    xor_mm.xor_reduce.launches = 0
    expected = expected_xor = 0
    t0 = time.perf_counter()
    for tech in ("reed_sol_van", "cauchy"):
        ec = registry.instance().factory("tpu", {"k": "8", "m": "3", "technique": tech})
        check(ec.device.type == "cuda", f"codec on {ec.device}, want cuda")
        km = ec.get_chunk_count()
        for n, obj in enumerate(objects):
            enc = ec.encode(set(range(km)), obj)
            expected += 1
            chunk = len(enc[0])
            check(chunk == 512 << 10, f"chunk size {chunk}")
            data = np.stack([enc[i] for i in range(8)])
            want = gf.gf_matmul(ec.distribution_matrix()[8:], data)
            for i in range(3):
                check(np.array_equal(enc[8 + i], want[i]),
                      f"{tech} object {n}: parity {i} != oracle")
            d = n % 8
            patterns = ([d], [8 + n % 3], [d, 8 + (n + 1) % 3],
                        [d, (d + 3) % 8, 8 + (n + 2) % 3])
            for erasures in patterns:
                avail = {i: enc[i] for i in range(km) if i not in erasures}
                dec = ec.decode(set(erasures), avail)
                for e in erasures:
                    check(np.array_equal(dec[e], enc[e]),
                          f"{tech} object {n}: decode {erasures} chunk {e}")
                if not ec._use_xor_decode(sorted(erasures)):
                    expected += 1
                else:
                    expected_xor += 1
            avail = {i: enc[i] for i in range(km) if i not in patterns[3]}
            whole = ec.decode_concat(avail)
            expected += 1
            check(whole[: len(obj)].tobytes() == obj,
                  f"{tech} object {n}: decode_concat != object")
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, xor_launches = swar.launches, xor_mm.xor_reduce.launches
    print(f"[3] main path: 2 techniques x {n_obj} objects x 4 MiB, "
          f"encode + 4 erasure classes + decode_concat, exact; {seconds:.2f} s host clock")
    print(f"[3] swar_gf launches {launches}, kernel-tier calls {expected}; xor_reduce "
          f"launches {xor_launches}, single erasures under the all-ones row {expected_xor}")
    check(launches == expected, f"launches {launches} != kernel-tier calls {expected}")
    check(xor_launches == expected_xor > 0,
          f"xor_reduce launches {xor_launches} != xor decodes {expected_xor}")
    return launches, xor_launches


def phase_bulk(torch, swar, registry, gf, card, kern_exp4, kern_exp2, nvcc):
    dev = torch.device("cuda")
    ec = registry.instance().factory("tpu", {"k": "8", "m": "3"})
    S, k, L = BULK
    m = ec.m
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 1)
    data = torch.randint(0, 256, (S, k, L), dtype=torch.uint8, device=dev, generator=gen)
    mat = ec.distribution_matrix()[k:]
    plan = swar.CodingPlan(mat, device=dev)
    out = ec.encode_array(data)
    ref = swar.swar_code_reference(plan.sched, data)
    torch.cuda.synchronize()
    check(torch.equal(out, ref), "bulk encode != plain version")
    baked = kern_exp2.make_swar(mat, 512)  # the schedule compiled in, as a yardstick
    check(torch.equal(baked(data), ref), "swar_baked != plain version at the bulk shape")
    del out, ref
    entry_ms = time_ms(torch, lambda: ec.encode_array(data))
    kernel_ms = time_ms(torch, lambda: swar.swar_gf(plan, data))
    plain_ms = time_ms(torch, lambda: swar.swar_code_reference(plan.sched, data),
                       warmup=2, reps=5)
    dst = torch.empty_like(data)
    copy_ms = time_ms(torch, lambda: dst.copy_(data))
    floor = kern_exp4.make_copy(4096)
    check(torch.equal(floor(data), data[:, :3]), "copy floor != data[:, :3]")
    floor_ms = time_ms(torch, lambda: floor(data))
    floor_bytes = (k + 3) * S * L
    in_bytes = S * k * L
    moved = (k + m) * S * L
    words = S * (L // 4)
    mem_ms = moved / HBM_BYTES_PER_S * 1e3
    need_ops = ring_word_ops(mat) * words
    alu_ms = need_ops / INT32_OPS_PER_S * 1e3
    bound_ms = max(mem_ms, alu_ms)
    bound_by = "bytes" if mem_ms >= alu_ms else "operations"
    own_ops = kernel_word_ops(plan, swar) * words
    print(f"[4] card: {card}")
    print(f"[4] encode_array (256, 8, 131072) uint8: {entry_ms:.4f} ms, "
          f"{in_bytes / entry_ms / 1e6:.2f} GB/s input")
    print(f"[4] swar_gf kernel: {kernel_ms:.4f} ms, "
          f"{in_bytes / kernel_ms / 1e6:.2f} GB/s input")
    print(f"[4] memory bound: {moved} B / 3.35 TB/s = {mem_ms:.4f} ms")
    print(f"[4] int ALU bound (ring program, xtime = {XTIME_OPS} ops): "
          f"{ring_word_ops(mat)} ops/word x {words} words = {need_ops} ops "
          f"/ {INT32_OPS_PER_S:.4g} ops/s = {alu_ms:.4f} ms")
    print(f"[4] bound {bound_ms:.4f} ms by {bound_by}; kernel at "
          f"{bound_ms / kernel_ms:.3f} of it")
    print(f"[4] (diagnostic) the kernel's own ops: {kernel_word_ops(plan, swar)} ops/word "
          f"= {own_ops / INT32_OPS_PER_S * 1e3:.4f} ms at the INT32 peak")
    baked_ms = time_ms(torch, lambda: baked(data))
    baked_ops = sass_opcodes(nvcc, baked.build().info["library"], "swar_baked_kernel")
    baked_words = "not counted" if baked_ops is None else (
        f"{sum(baked_ops.values()) / 4:.1f} SASS instructions/word")
    print(f"[4] per word at {BULK}: swar_gf (schedule a runtime operand) "
          f"{kernel_word_ops(plan, swar)} integer ops/word modelled, {kernel_ms:.4f} ms; "
          f"swar_baked rs83-van-encode (wt 512, schedule compiled in) {baked_words}, "
          f"{baked_ms:.4f} ms")
    print(f"[4] plain swar_code_reference: {plain_ms:.4f} ms")
    print(f"[4] copy yardstick (read {in_bytes} B + write {in_bytes} B): "
          f"{copy_ms:.4f} ms, {2 * in_bytes / copy_ms / 1e6:.2f} GB/s moved")
    print(f"[4] hand copy floor (copy_floor, tile 4096: reads all {k} chunks, writes 3, "
          f"{floor_bytes} B, what encode moves): {floor_ms:.4f} ms, "
          f"{floor_bytes / floor_ms / 1e6:.2f} GB/s moved")
    print(f"[4] swar_gf takes {kernel_ms / floor_ms:.3f}x the hand copy floor's time "
          f"(share {floor_ms / kernel_ms:.3f}); {kernel_ms / copy_ms:.3f}x the torch copy's")
    print("[4] library_ms: none (no single PyTorch call computes GF(2^8) coding)")
    full = ec.distribution_matrix()
    for erasures in ([0], [9], [0, 9], [0, 5, 10]):
        c, _ = gf.isa_decode_matrix(full, erasures, k)
        dec_ms = time_ms(torch, lambda: ec.decode_array(erasures, data))
        dec_bytes = (k + len(erasures)) * S * L
        dec_ops = ring_word_ops(c) * words
        dec_bound = max(dec_bytes / HBM_BYTES_PER_S, dec_ops / INT32_OPS_PER_S) * 1e3
        print(f"[4] decode_array {erasures}: {dec_ms:.4f} ms, "
              f"{in_bytes / dec_ms / 1e6:.2f} GB/s input, bound {dec_bound:.4f} ms")
    # m = 4, the most rows one pass holds: RS(10,4) with 4 erasures
    ec104 = registry.instance().factory("tpu", {"k": "10", "m": "4"})
    erasures = [0, 3, 10, 13]
    survivors = torch.randint(0, 256, (S, ec104.k, L), dtype=torch.uint8, device=dev,
                              generator=gen)
    c, _ = gf.isa_decode_matrix(ec104.distribution_matrix(), erasures, ec104.k)
    check(torch.equal(ec104.decode_array(erasures, survivors),
                      swar.swar_code_reference(swar.schedule_from_matrix(c), survivors)),
          "RS(10,4) decode_array != plain version")
    dec_ms = time_ms(torch, lambda: ec104.decode_array(erasures, survivors))
    dec_bound, dec_by = coding_bound(c, S, ec104.k, L)
    print(f"[4] RS(10,4) decode_array {erasures} at {(S, ec104.k, L)} (m = 4, one pass of "
          f"{swar.pass_geometry(len(c))[1]} rows): {dec_ms:.4f} ms, bound {dec_bound:.4f} ms "
          f"by {dec_by} ({dec_bound / dec_ms:.3f} of it)")
    return {"ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "floor_ms": floor_ms}


def coding_bound(mat, S: int, k: int, L: int) -> tuple[float, str]:
    """The least time the card could take for (S, k, L) -> (S, m, L) coding
    by `mat`: the larger of the bytes moved at the HBM rate and the ring
    program's ops at the INT32 rate (as phase 4 prints it)."""
    mem_ms = (k + len(mat)) * S * L / HBM_BYTES_PER_S * 1e3
    alu_ms = ring_word_ops(mat) * S * (L // 4) / INT32_OPS_PER_S * 1e3
    return max(mem_ms, alu_ms), ("bytes" if mem_ms >= alu_ms else "operations")


def bitmatrix_bounds(S: int, k: int, L: int, m: int = 3) -> dict:
    """Bounds (ms, by) at (S, k, L) of the kernels of csrc/bitmatrix.cu
    (the TPU kernels of benchmarks/diag/kern_exp.py), from their shapes:
    each input byte read once, each output byte written once, at the HBM
    rate; the (8m, 8k) 0/1 bit-matrix product over S·L columns (2 ops per
    multiply-add) at the dense tensor rate of the operand's type (bf16
    989e12/s, int8 1979e12/s); the bytewise popcount of k chunks as SWAR on
    32-bit words (10 ops per word of each chunk, k - 1 adds) at the INT32
    rate."""
    mm_ops = 2 * (8 * m) * (8 * k) * S * L
    popc_ms = (10 * k + k - 1) * S * (L // 4) / INT32_OPS_PER_S * 1e3
    rows = {
        # (S,k,L) u8 -> (S,m,L) u8, operand int8 or bf16
        "bitmatrix_grouped_int8": ((k + m) * S * L, mm_ops / INT8_OPS_PER_S * 1e3),
        "bitmatrix_grouped_bf16": ((k + m) * S * L, mm_ops / BF16_OPS_PER_S * 1e3),
        # bf16 planes -> u8 counts
        "bitmatrix_mm_only": ((2 * 8 * k + 8 * m) * S * L, mm_ops / BF16_OPS_PER_S * 1e3),
        # (S,k,L) u8 -> (S,1,L) u8
        "bitmatrix_expand_only": ((k + 1) * S * L, popc_ms),
    }
    out = {}
    for name, (moved, ops_ms) in rows.items():
        mem_ms = moved / HBM_BYTES_PER_S * 1e3
        out[name] = (max(mem_ms, ops_ms), "bytes" if mem_ms >= ops_ms else "operations")
    return out


def byte_err(torch, got, want) -> int:
    return int((got.to(torch.int16) - want.to(torch.int16)).abs().max())


def phase_diag_checks(torch, swar, gf, diag) -> dict:
    """copy_floor, swar_baked and swar3_baked against their plain versions
    and the oracle, byte for byte; returns each kernel's max abs error."""
    kern_exp2, kern_exp3, kern_exp4, kern_exp5 = diag
    dev = torch.device("cuda")
    geometries = list(dict.fromkeys(kern_exp3.GEOMETRIES + kern_exp5.SWAR3_GEOMETRIES))
    mats = baked_matrices(gf)
    errs = dict.fromkeys(("copy_floor", "swar_baked", "swar3_baked"), 0)
    cases = dict.fromkeys(errs, 0)
    copy = kern_exp4.make_copy(4096)

    def record(kernel, label, got, plain, oracle):
        err = byte_err(torch, got, plain)
        errs[kernel] = max(errs[kernel], err)
        check(err == 0, f"{kernel} {label}: kernel != plain (max err {err})")
        for s, want in oracle.items():
            check(np.array_equal(got[s].cpu().numpy(), want),
                  f"{kernel} {label}: stripe {s} != oracle")
        cases[kernel] += 1

    for n, shape in enumerate(DIAG_SHAPES):
        S, k, L = shape
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 10 + n)
        data = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
        ends = sorted({0, S - 1})  # the oracle costs host time: first and last stripe
        record("copy_floor", f"{shape}", copy(data), kern_exp4.copy_reference(data),
               {s: data[s, :3].cpu().numpy() for s in ends})
        for label, mat in mats:
            sched = swar.schedule_from_matrix(mat)
            plain = swar.swar_code_reference(sched, data)
            oracle = {s: gf.gf_matmul(mat, data[s].cpu().numpy()) for s in ends}
            for wt in kern_exp2.WTS:
                if (L // 32) % wt == 0:
                    record("swar_baked", f"{label} {shape} wt={wt}",
                           kern_exp2.make_swar(mat, wt)(data), plain, oracle)
            for rows, cols in geometries:
                if L % (rows * cols) == 0:
                    record("swar3_baked", f"{label} {shape} {rows}x{cols}",
                           kern_exp3.make_swar3(mat, rows, cols)(data),
                           kern_exp3.swar3_reference(sched, data, rows, cols), oracle)
        del data
    for kernel, err in errs.items():
        print(f"[5] {kernel} == plain == oracle on {cases[kernel]} cases, max_abs_err={err}")
    return errs


def phase_diag_mains(torch, swar, diag) -> dict:
    """Each experiment's main() at its script's own sizes; launch counts
    reset just before and held against the calls made."""
    kern_exp2, kern_exp3, kern_exp4, kern_exp5 = diag
    counters = {"swar_baked": kern_exp2, "swar3_baked": kern_exp3,
                "copy_floor": kern_exp4, "swar_gf": swar}
    for module in counters.values():
        module.launches = 0
    calls = {}
    for script, run in (("kern_exp2", lambda: kern_exp2.main([])),
                        ("kern_exp3", lambda: kern_exp3.main([])),
                        ("kern_exp4", kern_exp4.main), ("kern_exp5", kern_exp5.main)):
        print(f"[5] --- ceph_tpu_torch.diag.{script}.main()", flush=True)
        for kernel, n in run().items():
            calls[kernel] = calls.get(kernel, 0) + n
    torch.cuda.synchronize()
    launches = {kernel: module.launches for kernel, module in counters.items()}
    for kernel, n in launches.items():
        print(f"[5] {kernel}: launches {n}, wrapper calls {calls.get(kernel, 0)}")
        check(n > 0 and n == calls.get(kernel, 0),
              f"{kernel}: launches {n} != wrapper calls {calls.get(kernel, 0)}")
    return launches


def phase_diag_timing(torch, swar, gf, diag, floor_ms) -> dict:
    """Each kernel at the bulk shape, median of 20, beside its bound, its
    plain version and (copy only) the library call."""
    kern_exp2, kern_exp3, kern_exp4, kern_exp5 = diag
    dev = torch.device("cuda")
    S, k, L = BULK
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 2)
    data = torch.randint(0, 256, BULK, dtype=torch.uint8, device=dev, generator=gen)
    mat = gf.isa_rs_vandermonde_matrix(k, 3)[k:]
    sched = swar.schedule_from_matrix(mat)
    plain = swar.swar_code_reference(sched, data)
    bound_ms, bound_by = coding_bound(mat, S, k, L)
    in_bytes = S * k * L

    def best(kernel, variants):
        times = {}
        for label, fn in variants.items():
            check(torch.equal(fn(data), plain), f"{kernel} {label} != plain at {BULK}")
            times[label] = time_ms(torch, lambda: fn(data))
            print(f"[5] {kernel} {label}: {times[label]:.4f} ms, "
                  f"{in_bytes / times[label] / 1e6:.2f} GB/s input, "
                  f"{bound_ms / times[label]:.3f} of the bound")
        label = min(times, key=times.get)
        return label, times[label]

    wt_label, swar_ms = best("swar_baked", {
        f"wt={wt}": kern_exp2.make_swar(mat, wt) for wt in kern_exp2.WTS})
    geometries = list(dict.fromkeys(kern_exp3.GEOMETRIES + kern_exp5.SWAR3_GEOMETRIES))
    geo_label, swar3_ms = best("swar3_baked", {
        f"{rows}x{cols}": kern_exp3.make_swar3(mat, rows, cols) for rows, cols in geometries})
    rows, cols = (int(x) for x in geo_label.split("x"))
    plain_ms = time_ms(torch, lambda: swar.swar_code_reference(sched, data), warmup=2, reps=5)
    plain3_ms = time_ms(torch, lambda: kern_exp3.swar3_reference(sched, data, rows, cols),
                        warmup=2, reps=5)
    copy_plain_ms = time_ms(torch, lambda: kern_exp4.copy_reference(data))
    dst = torch.empty((S, 3, L), dtype=torch.uint8, device=dev)
    library_ms = time_ms(torch, lambda: dst.copy_(data[:, :3]))
    copy_bound_ms = (k + 3) * S * L / HBM_BYTES_PER_S * 1e3
    print(f"[5] bound of coding at {BULK}: {bound_ms:.4f} ms by {bound_by}; "
          f"of the copy floor: {copy_bound_ms:.4f} ms by bytes")
    print(f"[5] swar_baked best {wt_label}: {swar_ms:.4f} ms; plain swar_code_reference "
          f"{plain_ms:.4f} ms")
    print(f"[5] swar3_baked best {geo_label}: {swar3_ms:.4f} ms; plain swar3_reference "
          f"{plain3_ms:.4f} ms")
    print(f"[5] copy_floor (phase 4): {floor_ms:.4f} ms, {copy_bound_ms / floor_ms:.3f} of "
          f"its bound; plain copy_reference {copy_plain_ms:.4f} ms; library "
          f"dst.copy_(data[:, :3]) {library_ms:.4f} ms")
    return {
        "copy_floor": {"ms": floor_ms, "plain_ms": copy_plain_ms, "bound_ms": copy_bound_ms,
                       "bound_by": "bytes", "library_ms": library_ms, "variant": "tile=4096",
                       "source_sha256": kern_exp4.build().info["source_sha256"]},
        "swar_baked": {"ms": swar_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": None, "variant": wt_label,
                       "source_sha256": kern_exp2.make_swar(mat, 128).build().info["source_sha256"]},
        "swar3_baked": {"ms": swar3_ms, "plain_ms": plain3_ms, "bound_ms": bound_ms,
                        "bound_by": bound_by, "library_ms": None, "variant": geo_label,
                        "source_sha256": kern_exp3.make_swar3(mat, 128, 256).build().info["source_sha256"]},
    }


BITMATRIX_KERNELS = ("bitmatrix_grouped_int8", "bitmatrix_grouped_bf16", "bitmatrix_mm_only",
                     "bitmatrix_expand_only")


def popcount_oracle(host: np.ndarray) -> np.ndarray:
    """(k, L) uint8 -> (1, L): the set bits of each column, by numpy."""
    return np.unpackbits(host[..., None], axis=-1).sum(axis=(0, 2)).astype(np.uint8)[None]


def phase_bitmatrix_checks(torch, gf, kern_exp) -> dict:
    """The three bit-matrix kernels against their plain versions and the
    oracles, byte for byte: grouped for every variant of kern_exp.main()
    (oracle `gf_matmul`), mm_only (counts of the plain version) and
    expand_only (numpy popcount); returns each kernel's max abs error."""
    dev = torch.device("cuda")
    rs42 = ("rs42-van-encode", gf.isa_rs_vandermonde_matrix(4, 2)[4:])
    cases = [(shape, baked_matrices(gf)) for shape in BITMATRIX_SHAPES]
    cases.append((BITMATRIX_RS42_SHAPE, [rs42]))
    errs = dict.fromkeys(BITMATRIX_KERNELS, 0)
    counts = dict.fromkeys(BITMATRIX_KERNELS, 0)

    def record(kernel, label, got, plain, oracle):
        err = byte_err(torch, got, plain)
        errs[kernel] = max(errs[kernel], err)
        check(err == 0, f"{kernel} {label}: kernel != plain (max err {err})")
        for s, want in oracle.items():
            check(np.array_equal(got[s].cpu().numpy(), want),
                  f"{kernel} {label}: stripe {s} != oracle")
        counts[kernel] += 1

    expand = kern_exp.make_expand_only(kern_exp.EXPAND_TILE)
    for n, (shape, mats) in enumerate(cases):
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 20 + n)
        data = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
        ends = sorted({0, shape[0] - 1})  # the oracle costs host time: first and last stripe
        host = {s: data[s].cpu().numpy() for s in ends}
        record("bitmatrix_expand_only", f"{shape}", expand(data),
               kern_exp.expand_only_reference(data), {s: popcount_oracle(host[s]) for s in ends})
        for label, mat in mats:
            oracle = {s: gf.gf_matmul(mat, host[s]) for s in ends}
            plain = {}
            for g, dn, tile in kern_exp.GROUPED_VARIANTS:
                fn = kern_exp.make_grouped(mat, g, kern_exp.OPERANDS[dn], tile)
                if (g, dn) not in plain:
                    plain[g, dn] = kern_exp.grouped_reference(fn.operand.on(dev), data, g)
                record(fn.kernel, f"{label} {shape} {kern_exp.variant_name(g, dn, tile)}",
                       fn(data), plain[g, dn], oracle)
            del plain
            planes = kern_exp.bit_planes(data, torch.bfloat16)
            mm = kern_exp.make_mm_only(mat, kern_exp.MM_TILE)
            record("bitmatrix_mm_only", f"{label} {shape}", mm(planes),
                   kern_exp.mm_only_reference(mm.operand.on(dev), planes), {})
            del planes
        del data
    for n, (k, m) in enumerate(MM_ONLY_GEOMETRIES):
        mat = gf.isa_rs_vandermonde_matrix(k, m)[k:]
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 30 + n)
        data = torch.randint(0, 256, (8, k, 4096), dtype=torch.uint8, device=dev, generator=gen)
        planes = kern_exp.bit_planes(data, torch.bfloat16)
        # integer counts of the first stripe, by numpy
        bm = kern_exp.arrange_dense_matrix(mat).astype(np.int64)
        first = {0: (bm @ planes[0].to(torch.int64).cpu().numpy()).astype(np.uint8)}
        for tile in (kern_exp.MM_TILE, kern_exp.MM_STAGE_COLS):
            mm = kern_exp.make_mm_only(mat, tile)
            record("bitmatrix_mm_only", f"rs{k}{m}-van-encode (8, {k}, 4096) tile {tile}",
                   mm(planes), kern_exp.mm_only_reference(mm.operand.on(dev), planes), first)
        del data, planes
    # the grouped kernels' other geometries, both operand types
    for n, (label, k, m, shape, variants) in enumerate(GROUPED_GEOMETRIES):
        build = gf.isa_cauchy_matrix if "cauchy" in label else gf.isa_rs_vandermonde_matrix
        mat = build(k, m)[k:]
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 40 + n)
        data = torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)
        ends = sorted({0, shape[0] - 1})
        oracle = {s: gf.gf_matmul(mat, data[s].cpu().numpy()) for s in ends}
        for g, tile in variants:
            for dn, dtype in kern_exp.OPERANDS.items():
                fn = kern_exp.make_grouped(mat, g, dtype, tile)
                record(fn.kernel, f"{label} {shape} {kern_exp.variant_name(g, dn, tile)}",
                       fn(data), kern_exp.grouped_reference(fn.operand.on(dev), data, g), oracle)
        del data
    for kernel, err in errs.items():
        print(f"[6] {kernel} == plain == oracle on {counts[kernel]} cases, max_abs_err={err}")
    return errs


def phase_bitmatrix_main(torch, swar, kern_exp) -> dict:
    """kern_exp.main() at its script's sizes; launch counts reset just before
    and held against the calls it made."""
    for kernel in kern_exp.launches:
        kern_exp.launches[kernel] = 0
    swar.launches = 0
    plain_calls = []
    reference = kern_exp.grouped_reference

    def counted_reference(*args, **kwargs):  # main() must never reach it on the card
        plain_calls.append(1)
        return reference(*args, **kwargs)

    print("[6] --- ceph_tpu_torch.diag.kern_exp.main()", flush=True)
    kern_exp.grouped_reference = counted_reference
    try:
        calls = kern_exp.main([])
    finally:
        kern_exp.grouped_reference = reference
    torch.cuda.synchronize()
    print(f"[6] grouped_reference calls during main(): {len(plain_calls)}")
    check(not plain_calls, f"kern_exp.main() reached grouped_reference {len(plain_calls)} times")
    launches = {**kern_exp.launches, "swar_gf": swar.launches}
    for kernel, n in launches.items():
        print(f"[6] {kernel}: launches {n}, wrapper calls {calls.get(kernel, 0)}")
        check(n > 0 and n == calls.get(kernel, 0),
              f"{kernel}: launches {n} != wrapper calls {calls.get(kernel, 0)}")
    return launches


def phase_bitmatrix_timing(torch, gf, kern_exp) -> dict:
    """Each bit-matrix kernel at the bulk shape, median of 20, beside its
    bound, its plain version and (mm_only only) the library call."""
    dev = torch.device("cuda")
    S, k, L = BULK
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    data = torch.randint(0, 256, BULK, dtype=torch.uint8, device=dev, generator=gen)
    mat = gf.isa_rs_vandermonde_matrix(k, 3)[k:]
    in_bytes = S * k * L
    want = kern_exp.grouped_reference(
        kern_exp.make_grouped(mat, 1, torch.int8, 4096).operand.on(dev), data, 1)
    check(np.array_equal(want[0].cpu().numpy(), gf.gf_matmul(mat, data[0].cpu().numpy())),
          "grouped_reference != oracle at the bulk shape")
    times, fns = {}, {}
    for dn in ("int8", "bf16"):
        for g in (1, 2, 4, 8):
            label = kern_exp.variant_name(g, dn, 4096)
            fn = fns[label] = kern_exp.make_grouped(mat, g, kern_exp.OPERANDS[dn], 4096)
            check(torch.equal(fn(data), want), f"{fn.kernel} {label} != plain at {BULK}")
            times[label] = time_ms(torch, lambda: fn(data))
            print(f"[6] {fn.kernel} {label}: {times[label]:.4f} ms, "
                  f"{in_bytes / times[label] / 1e6:.2f} GB/s input", flush=True)
    del want
    bounds = bitmatrix_bounds(S, k, L)
    grouped = {}
    for dn in kern_exp.OPERANDS:
        best = min((label for label in times if f"_{dn}_" in label), key=times.get)
        fn = fns[best]
        plain_ms = time_ms(
            torch, lambda: kern_exp.grouped_reference(fn.operand.on(dev), data, fn.g),
            warmup=2, reps=5)
        grouped[fn.kernel] = (times[best], plain_ms, None, best)

    planes = kern_exp.bit_planes(data, torch.bfloat16)
    mm = kern_exp.make_mm_only(mat, kern_exp.MM_TILE)
    operand = mm.operand.on(dev)
    counts = mm(planes)
    check(torch.equal(counts, kern_exp.mm_only_reference(operand, planes)),
          f"bitmatrix_mm_only != plain at {BULK}")

    def library():  # cuBLAS on the same planes; counts <= 64 are exact in bf16
        return torch.matmul(operand, planes).to(torch.uint8)

    check(torch.equal(library(), counts), f"library matmul != bitmatrix_mm_only at {BULK}")
    del counts
    mm_ms = time_ms(torch, lambda: mm(planes))
    mm_plain_ms = time_ms(torch, lambda: kern_exp.mm_only_reference(operand, planes),
                          warmup=2, reps=5)
    mm_library_ms = time_ms(torch, library)
    del planes

    expand = kern_exp.make_expand_only(kern_exp.EXPAND_TILE)
    check(torch.equal(expand(data), kern_exp.expand_only_reference(data)),
          f"bitmatrix_expand_only != plain at {BULK}")
    expand_ms = time_ms(torch, lambda: expand(data))
    expand_plain_ms = time_ms(torch, lambda: kern_exp.expand_only_reference(data),
                              warmup=2, reps=5)

    rows = {
        **grouped,
        "bitmatrix_mm_only": (mm_ms, mm_plain_ms, mm_library_ms, f"tile={kern_exp.MM_TILE}"),
        "bitmatrix_expand_only": (expand_ms, expand_plain_ms, None,
                                  f"tile={kern_exp.EXPAND_TILE}"),
    }
    sha = kern_exp.build().info["source_sha256"]
    out = {}
    for kernel, (ms, plain_ms, library_ms, variant) in rows.items():
        bound_ms, bound_by = bounds[kernel]
        library = "" if library_ms is None else (
            f"; library torch.matmul(bm_bf16, planes).to(uint8) {library_ms:.4f} ms")
        print(f"[6] {kernel} {variant}: {ms:.4f} ms, bound {bound_ms:.4f} ms by {bound_by} "
              f"({bound_ms / ms:.4f} of it); plain {plain_ms:.4f} ms{library}")
        out[kernel] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                       "bound_by": bound_by, "library_ms": library_ms, "variant": variant,
                       "source_sha256": sha}
    for dn in kern_exp.OPERANDS:
        g1 = times[f"g1_{dn}_t4096"]
        print(f"[6] bitmatrix_grouped_{dn} gN / g1 time: " + ", ".join(
            f"g{g} {times[f'g{g}_{dn}_t4096'] / g1:.3f}x" for g in (2, 4, 8)))
    bf16_g1 = times["g1_bf16_t4096"]
    grouped_bound = bounds["bitmatrix_grouped_bf16"][0]
    print(f"[6] bitmatrix_grouped_bf16 g1 t4096: {bf16_g1:.4f} ms, {grouped_bound / bf16_g1:.4f} "
          f"of its {grouped_bound:.4f} ms bound")
    print(f"[6] bitmatrix_grouped_bf16 / bitmatrix_grouped_int8 at g1: "
          f"{bf16_g1 / times['g1_int8_t4096']:.3f}x")
    return out


# Phase 7's chunk lengths: odd ones (rows not 16-byte aligned, ragged last
# vectors), 4100 and 4128 (a multiple of 4 and of 16, not of 128), 131075,
# and the aligned 4096 and 131072; stripes cycle through {1, 2, 64}.
PACKED_LENGTHS = (1, 3, 5, 127, 4100, 4128, 131075, 4096, 131072)
PACKED_STRIPES = (1, 2, 64)
# Phase 7b: one scrub chunk (osd_scrub_chunk_max = 25 objects of 4 MiB at
# Ceph's EC stripe_unit 4096: 3200 stripes of 8 x 4096), 32 cache-hit RMW
# objects of 128 stripes, and a chunk length of Ceph's isa plugin (aligned
# to its SIMD_ALIGN of 32, not to 128) for the packed tier.
SCRUB_SHAPE = (3200, 11, 4096)
SCRUB_OBJECT_STRIPES = 128
RMW_OBJECTS = 32
PACKED_TIER_SHAPE = (32, 8, 524320)
WIDE_SHAPE = (32, 32, 131072)  # RS(32,3)'s decode, timed in 7c
WIDE_TIER_SHAPE = (4, 128, 4100)  # plugin tpu Cauchy(128,16) on the packed tier, 7b
PACKED_KERNELS = ("packed_code", "packed_verify", "packed_delta")
PACKED_PLAIN = ("packed_code_reference", "packed_verify_reference", "packed_delta_reference")


# wide profiles whose best_program needs 150-233 slots: a full block fits
# only their ring program, and Cauchy(32,3)'s CSE decode takes 32 threads
WIDE_LABELS = ("rs214-van-decode[0, 1, 2, 3]", "rs323-van-decode[0, 1, 2]", "cauchy214-encode",
               "cauchy323-decode[0, 1, 2]")


def packed_matrices(gf):
    """Phase 7a's matrices: Vandermonde encode rows over k in {2, 4, 8, 12}
    x m in {1..4}, RS(8,3) and Cauchy(21,4) encode, and decode matrices
    for erasures 0..m-1 of RS(8,3), RS(12,4), RS(21,4), RS(32,3) and
    Cauchy(32,3) (the largest programs)."""
    mats = [(f"rs{k}{m}-van-encode", gf.isa_rs_vandermonde_matrix(k, m)[k:])
            for k in (2, 4, 8, 12) for m in (1, 2, 3, 4)]
    mats.append(("rs83-cauchy-encode", gf.isa_cauchy_matrix(8, 3)[8:]))
    for k, m in ((8, 3), (12, 4), (21, 4), (32, 3)):
        c, _ = gf.isa_decode_matrix(gf.isa_rs_vandermonde_matrix(k, m), list(range(m)), k)
        mats.append((f"rs{k}{m}-van-decode{list(range(m))}", c))
    mats.append(("cauchy214-encode", gf.isa_cauchy_matrix(21, 4)[21:]))
    c, _ = gf.isa_decode_matrix(gf.isa_cauchy_matrix(32, 3), [0, 1, 2], 32)
    mats.append(("cauchy323-decode[0, 1, 2]", c))
    return mats


def verify_expected(mat, k: int, m: int, pos: int) -> int:
    """The bitmap of a codeword corrupted at shard `pos` only: for a data
    chunk, the rows whose coefficient on it is nonzero; for parity row i,
    bit i."""
    if pos < k:
        return sum(1 << i for i in range(m) if mat[i, pos])
    return 1 << (pos - k)


def phase_packed_checks(torch, packed, gf) -> dict:
    """The three kernels of csrc/packed_gf.cu against their plain versions
    and the host oracles, byte for byte; returns each kernel's max abs
    error."""
    dev = torch.device("cuda")
    errs = dict.fromkeys(PACKED_KERNELS, 0)
    cases = dict.fromkeys(PACKED_KERNELS, 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 50)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    def record(kernel, label, got, plain):
        torch.cuda.synchronize()
        err = byte_err(torch, got, plain)
        errs[kernel] = max(errs[kernel], err)
        check(err == 0, f"{kernel} {label}: kernel != plain (max err {err})")
        cases[kernel] += 1

    def code_case(label, mat, sched, data, n):
        got = packed.packed_code(sched, data)
        record("packed_code", label, got, packed.packed_code_reference(packed.best_program(mat),
                                                                       data))
        S = data.shape[0]
        check(np.array_equal(got[0].cpu().numpy(),
                             packed.packed_code_host(mat, data[0].cpu().numpy())),
              f"packed_code {label}: stripe 0 != packed_code_host")
        if n % 3 == 0 or data.shape[-1] <= 4128:  # the table product costs host time
            check(np.array_equal(got[S - 1].cpu().numpy(),
                                 gf.gf_matmul(mat, data[S - 1].cpu().numpy())),
                  f"packed_code {label}: stripe {S - 1} != gf_matmul")
        return got

    mats = packed_matrices(gf)
    n = 0
    for label, mat in mats:
        m, k = mat.shape
        prog = packed.best_program(mat)
        grid = ([(L, S) for L in PACKED_LENGTHS for S in PACKED_STRIPES]
                if label in ("rs83-van-encode", "rs83-cauchy-encode") else
                [(L, PACKED_STRIPES[i % 3]) for i, L in enumerate(PACKED_LENGTHS)])
        for L, S in grid:
            if S * k * L > (64 << 20):
                S = 2
            code_case(f"{label} ({S}, {k}, {L})", mat, prog, rand(S, k, L), n)
            n += 1
    # each construction forced in turn (the wide codes' CSE and tower
    # programs take blocks of 64 or 32 threads), a legacy row schedule, and
    # the construction a plan gives the kernels
    for label, mat in mats:
        if label not in ("rs83-van-encode", "rs83-cauchy-encode", "rs83-van-decode[0, 1, 2]",
                         *WIDE_LABELS):
            continue
        names = ("naive_program", "cse_program", "ring_program", "plane_schedule")
        plan = packed.PackedPlan(mat)
        if label in WIDE_LABELS:
            shapes = {name: (len(lp.ops), lp.nslots, lp.threads) for name, lp in
                      ((name, packed.lower_program(getattr(packed, name)(mat), mat.shape[1]))
                       for name in names)}
            print(f"[7] {label}: (ops, slots, threads) {shapes}; the plan's "
                  f"{(len(plan.lowered.ops), plan.lowered.nslots, plan.lowered.threads)}")
            check(plan.lowered.threads == 128, f"{label}: the plan's program takes "
                  f"{plan.lowered.threads} threads a block, want 128")
        for L in (5, 4100, 131072):
            data = rand(2, mat.shape[1], L)
            for name in names:
                code_case(f"{label} {name} (2, {mat.shape[1]}, {L})", mat,
                          getattr(packed, name)(mat), data, n)
                n += 1
            code_case(f"{label} plan (2, {mat.shape[1]}, {L})", mat, plan.lowered, data, n)
            n += 1
    # a strided view (data rows of codewords), a misaligned view, and out=
    mat = gf.isa_rs_vandermonde_matrix(8, 3)[8:]
    for L in (4096, 4100):
        cw = rand(2, 11, L)
        code_case(f"cw[:, :8] L={L}", mat, packed.best_program(mat), cw[:, :8], 0)
        buf = rand(2 * 8 * L + 16)
        off = (1 - buf.data_ptr()) % 16
        view = buf[off:off + 2 * 8 * L].view(2, 8, L)
        check(view.data_ptr() % 16 == 1, "misaligned view is aligned")
        code_case(f"base 1 byte past 16 L={L}", mat, packed.best_program(mat), view, 0)
        out = torch.empty((2, 3, L), dtype=torch.uint8, device=dev)
        got = packed.PackedPlan(mat)(view, out=out)
        check(got is out, "PackedPlan ignored a fitting out")
        record("packed_code", f"out= L={L}", out,
               packed.packed_code_reference(packed.best_program(mat), view))
    # verify: a one-byte corruption at every shard position, and a clean codeword
    for label, mat in mats:
        m, k = mat.shape
        if label not in ("rs83-van-encode", "rs83-cauchy-encode", "rs124-van-encode",
                         "rs21-van-encode", "rs124-van-decode[0, 1, 2, 3]",
                         "cauchy214-encode"):
            continue
        prog = packed.best_program(mat)
        for L in (1, 127, 4096, 4100, 131075):
            data = rand(k + m + 1, k, L)
            cw = torch.cat([data, packed.packed_code(prog, data)], dim=1)
            for pos in range(k + m):
                byte = (pos * 37) % L
                cw[pos, pos, byte] ^= 1 << (pos % 8)
            got = packed.packed_verify(prog, cw)
            record("packed_verify", f"{label} L={L}", got, packed.packed_verify_reference(prog, cw))
            host = got.cpu().numpy()
            check(np.array_equal(host, packed.packed_verify_host(mat, cw.cpu().numpy())),
                  f"packed_verify {label} L={L} != packed_verify_host")
            want = [verify_expected(mat, k, m, pos) for pos in range(k + m)] + [0]
            check(host.tolist() == want, f"packed_verify {label} L={L}: {host.tolist()} != {want}")
    # delta, stacked and flat (separately allocated shard buffers)
    for label, mat in mats:
        m, k = mat.shape
        if label not in ("rs83-van-encode", "rs83-cauchy-encode", "rs124-van-encode",
                         "rs124-van-decode[0, 1, 2, 3]", "rs323-van-decode[0, 1, 2]"):
            continue
        prog = packed.best_program(mat)
        for L, S in ((1, 64), (4100, 2), (4096, 64), (131075, 2), (131072, 2)):
            old, new = rand(S, k, L), rand(S, k, L)
            parity = packed.packed_code(prog, old)
            got = packed.packed_delta(prog, old, new, parity)
            record("packed_delta", f"{label} stacked ({S}, {k}, {L})", got,
                   packed.packed_delta_reference(prog, old, new, parity))
            check(torch.equal(got, packed.packed_code(prog, new)),
                  f"packed_delta {label} ({S}, {k}, {L}) != re-encode of the new data")
            check(np.array_equal(got[S - 1].cpu().numpy(), packed.packed_delta_host(
                mat, old[S - 1].cpu().numpy(), new[S - 1].cpu().numpy(),
                parity[S - 1].cpu().numpy())), f"packed_delta {label}: != packed_delta_host")
            shards = lambda t: [t[:, j].contiguous().view(-1) for j in range(t.shape[1])]
            flat = packed.packed_delta_flat(prog, shards(old), shards(new), shards(parity), L)
            record("packed_delta", f"{label} flat ({S}, {k}, {L})", flat, got)
    wide_packed_checks(torch, packed, gf, rand, record)
    for kernel in PACKED_KERNELS:
        print(f"[7] {kernel} == plain == oracle on {cases[kernel]} cases, "
              f"max_abs_err={errs[kernel]}")
    return errs


def wide_packed_checks(torch, packed, gf, rand, record) -> None:
    """Fault C3's profiles (Cauchy has no k, m cap; k + m <= 256), each on
    its ring program lowered for the kernels (never best_program, whose
    CSE takes minutes at k = 128): Cauchy(128,16) encode and 16-erasure
    decode at L = 4100 and 131075, Cauchy(200,56) encode (46216 ops, 256
    rows), the flat deltas of Cauchy(96,8) (208 rows) and Cauchy(128,128)
    (512 rows, 69632 ops), and Cauchy(248,8)'s verify (256 rows) corrupted
    at every shard position; each against the plain version of the same
    program and `gf_matmul` on one stripe."""
    c128 = gf.isa_cauchy_matrix(128, 16)
    for label, mat, lengths in (
            ("cauchy128-16-encode", c128[128:], (4100, 131075)),
            ("cauchy128-16-decode[0..15]", gf.isa_decode_matrix(c128, list(range(16)), 128)[0],
             (4100, 131075)),
            ("cauchy200-56-encode", gf.isa_cauchy_matrix(200, 56)[200:], (4100,))):
        m, k = mat.shape
        lowered = packed.LoweredProgram(packed.ring_program(mat))
        for L in lengths:
            data = rand(2, k, L)
            got = packed.packed_code(lowered, data)
            record("packed_code", f"{label} (2, {k}, {L})", got,
                   packed.packed_code_reference(lowered.prog, data))
            check(np.array_equal(got[1].cpu().numpy(), gf.gf_matmul(mat, data[1].cpu().numpy())),
                  f"packed_code {label} L={L}: != gf_matmul")
        print(f"[7] {label}: ring program {len(lowered.ops)} ops, {lowered.nslots} slots, "
              f"{lowered.threads} threads, {k + m} rows: exact")
    shards = lambda t: [t[:, j].contiguous().view(-1) for j in range(t.shape[1])]
    for k, m in ((96, 8), (128, 128)):
        mat = gf.isa_cauchy_matrix(k, m)[k:]
        lowered = packed.LoweredProgram(packed.ring_program(mat))
        L = 4100
        old, new, parity = rand(2, k, L), rand(2, k, L), rand(2, m, L)
        got = packed.packed_delta_flat(lowered, shards(old), shards(new), shards(parity), L)
        record("packed_delta", f"cauchy{k}-{m} flat (2, {k}, {L})", got,
               packed.packed_delta_reference(lowered.prog, old, new, parity))
        want = parity[1].cpu().numpy() ^ gf.gf_matmul(mat, (old[1] ^ new[1]).cpu().numpy())
        check(np.array_equal(got[1].cpu().numpy(), want), f"packed_delta cauchy{k}-{m}: "
              "!= parity ^ gf_matmul(old ^ new)")
        print(f"[7] cauchy{k}-{m} flat delta: ring program {len(lowered.ops)} ops, "
              f"{lowered.nslots} slots, {lowered.threads} threads, {2 * (k + m)} rows: exact")
    k, m, L = 248, 8, 4100
    mat = gf.isa_cauchy_matrix(k, m)[k:]
    lowered = packed.LoweredProgram(packed.ring_program(mat))
    data = rand(k + m + 1, k, L)
    cw = torch.cat([data, packed.packed_code(lowered, data)], dim=1)
    check(np.array_equal(cw[0, k:].cpu().numpy(), gf.gf_matmul(mat, data[0].cpu().numpy())),
          "cauchy248-8 encode != gf_matmul")
    for pos in range(k + m):
        cw[pos, pos, (pos * 37) % L] ^= 1 << (pos % 8)
    got = packed.packed_verify(lowered, cw)
    record("packed_verify", f"cauchy248-8 L={L}", got,
           packed.packed_verify_reference(lowered.prog, cw))
    want = [verify_expected(mat, k, m, pos) for pos in range(k + m)] + [0]
    check(got.cpu().tolist() == want, "cauchy248-8 verify: bitmap != the corrupted shards")
    print(f"[7] cauchy248-8 verify: ring program {len(lowered.ops)} ops, {lowered.nslots} "
          f"slots, {lowered.threads} threads, {k + m} rows, every shard position: exact")


def phase_packed_path(torch, packed, swar, dispatch, registry, gf) -> dict:
    """The slice's path at real size through plugin `tpu` RS(8,3): deep
    scrub of one scrub chunk, cache-hit RMW deltas, the packed tier of
    encode_array and decode_array; launch counts reset just before and
    read just after, plain versions counted (none may run)."""
    dev = torch.device("cuda")
    ec = registry.instance().factory("tpu", {"k": "8", "m": "3"})
    check(ec.device.type == "cuda", f"codec on {ec.device}, want cuda")
    k, m = ec.k, ec.m
    mat = ec.distribution_matrix()[k:]
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 60)

    def rand(*shape):
        return torch.randint(0, 256, shape, dtype=torch.uint8, device=dev, generator=gen)

    scrub_data = rand(SCRUB_SHAPE[0], k, SCRUB_SHAPE[2])
    rmw = [(rand(SCRUB_OBJECT_STRIPES, k, 4096), rand(SCRUB_OBJECT_STRIPES, k, 4096))
           for _ in range(RMW_OBJECTS)]
    tier_data = rand(*PACKED_TIER_SHAPE)
    wide = registry.instance().factory("tpu", {"k": "128", "m": "16", "technique": "cauchy"})
    wide_mat = wide.distribution_matrix()[wide.k:]
    wide_data = rand(*WIDE_TIER_SHAPE)
    torch.cuda.synchronize()

    plain_calls = collections.Counter()
    originals = {(module, name): getattr(module, name)
                 for module, names in ((packed, PACKED_PLAIN), (swar, ("swar_code_reference",)))
                 for name in names}

    def counted(name, fn):
        def wrapper(*args, **kwargs):  # the path must never reach a plain version on the card
            plain_calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    for (module, name), fn in originals.items():
        setattr(module, name, counted(name, fn))
    for kernel in PACKED_KERNELS:
        packed.launches[kernel] = 0
    swar.launches = 0
    counters = {"LAUNCHES": dispatch.LAUNCHES, "DECODE_LAUNCHES": dispatch.DECODE_LAUNCHES,
                "VERIFY_LAUNCHES": dispatch.VERIFY_LAUNCHES}
    for counter in counters.values():
        counter.reset()
    calls = collections.Counter()
    t0 = time.perf_counter()
    try:
        # deep scrub of one scrub chunk: 25 objects of 4 MiB, codewords encoded on the card
        cw = torch.cat([scrub_data, ec.encode_array(scrub_data)], dim=1)
        calls["swar"] += 1
        del scrub_data
        before = dispatch.VERIFY_LAUNCHES.snapshot()["launches"]
        clean = ec.verify_array(cw)
        calls["verify"] += 1
        check(dispatch.VERIFY_LAUNCHES.snapshot()["launches"] == before + 1,
              "verify_array did not count one VERIFY launch")
        check(tuple(clean.shape) == (SCRUB_SHAPE[0],) and not bool(clean.any()),
              "clean scrub chunk: bitmap not all zero")
        for pos in range(k + m):  # object 0, stripe pos, shard pos
            cw[pos, pos, (pos * 373) % SCRUB_SHAPE[2]] ^= 1 << (pos % 8)
        bitmap = ec.verify_array(cw)
        calls["verify"] += 1
        check(dispatch.VERIFY_LAUNCHES.snapshot()["launches"] == before + 2,
              "verify_array did not count one VERIFY launch")
        want = np.zeros(SCRUB_SHAPE[0], np.uint8)
        want[: k + m] = [verify_expected(mat, k, m, pos) for pos in range(k + m)]
        host = bitmap.cpu().numpy()
        check(np.array_equal(host, want), f"scrub bitmap {host[:k + m].tolist()} != "
              f"{want[:k + m].tolist()} (or a clean object flagged)")
        obj0 = cw[:SCRUB_OBJECT_STRIPES].cpu().numpy()
        check(np.array_equal(host[:SCRUB_OBJECT_STRIPES], ec.verify_array_host(obj0)),
              "scrub bitmap of object 0 != verify_array_host")
        del cw, obj0
        # cache-hit RMW: 19 flat 512 KiB shard buffers an object
        for old, new in rmw:
            parity = ec.encode_array(old)
            shards = lambda t: [t[:, j].contiguous().view(-1) for j in range(t.shape[1])]
            got = ec.encode_delta_device(shards(old), shards(new), shards(parity), 4096)
            calls["delta"] += 1
            check(torch.equal(got, ec.encode_array(new)),
                  "encode_delta_device != encode_array of the new data")
            calls["swar"] += 2
        del rmw
        # the packed tier: L = 524320 (isa's SIMD_ALIGN 32, not 128)
        parity = ec.encode_array(tier_data)
        calls["code"] += 1
        S = PACKED_TIER_SHAPE[0]
        for s in (0, S - 1):
            check(np.array_equal(parity[s].cpu().numpy(),
                                 gf.gf_matmul(mat, tier_data[s].cpu().numpy())),
                  f"packed tier encode stripe {s} != gf_matmul")
        full = torch.cat([tier_data, parity], dim=1)
        for erasures in ([0], [9], [0, 9], [0, 5, 10]):
            survivors = full[:, ec.decode_index(erasures)]
            rec = ec.decode_array(erasures, survivors)
            calls["code"] += 1
            calls["decode"] += 1
            check(torch.equal(rec, full[:, erasures]),
                  f"packed tier decode {erasures} != the encoded bytes")
        del full, parity, tier_data
        # fault C3: a wide Cauchy code on the packed tier (L % 128 != 0)
        for _ in range(2):
            wide_parity = wide.encode_array(wide_data)
            calls["code"] += 1
        for s in (0, WIDE_TIER_SHAPE[0] - 1):
            check(np.array_equal(wide_parity[s].cpu().numpy(),
                                 gf.gf_matmul(wide_mat, wide_data[s].cpu().numpy())),
                  f"Cauchy(128,16) packed tier encode stripe {s} != gf_matmul")
        del wide_parity, wide_data
        torch.cuda.synchronize()
    finally:
        for (module, name), fn in originals.items():
            setattr(module, name, fn)
    seconds = time.perf_counter() - t0
    launches = dict(packed.launches)
    counts = {name: counter.snapshot()["launches"] for name, counter in counters.items()}
    print(f"[7] slice path: scrub of {SCRUB_SHAPE} (2 verifies), {RMW_OBJECTS} RMW deltas over "
          f"19 flat 512 KiB shards, packed tier on {PACKED_TIER_SHAPE} (encode + 4 erasure "
          f"classes), Cauchy(128,16) packed tier encode of {WIDE_TIER_SHAPE} twice, exact; "
          f"{seconds:.2f} s host clock")
    print(f"[7] launches {launches}, swar_gf {swar.launches}; tier calls {dict(calls)}; "
          f"dispatch counters {counts}; plain-version calls {dict(plain_calls)}")
    check(not plain_calls, f"the path reached plain versions: {dict(plain_calls)}")
    want = {"packed_code": calls["code"], "packed_verify": calls["verify"],
            "packed_delta": calls["delta"]}
    check(launches == want, f"launches {launches} != tier calls {want}")
    check(swar.launches == calls["swar"], f"swar_gf launches {swar.launches} != {calls['swar']}")
    total = calls["code"] + calls["verify"] + calls["delta"] + calls["swar"]
    check(counts == {"LAUNCHES": total, "DECODE_LAUNCHES": calls["decode"],
                     "VERIFY_LAUNCHES": calls["verify"]},
          f"dispatch counters {counts}")
    return launches


def packed_bound(prog, moved: int, words: int, extra_ops: int = 0) -> tuple[float, str]:
    """(ms, by): `moved` bytes at the HBM rate against the program's ops
    on `words` 32-bit words (an XOR 1 op, an xtime XTIME_OPS; `extra_ops`
    a word beside them) at the INT32 rate."""
    ops = sum(1 if op[0] == "x" else XTIME_OPS for op in prog[3]) + extra_ops
    mem_ms = moved / HBM_BYTES_PER_S * 1e3
    alu_ms = ops * words / INT32_OPS_PER_S * 1e3
    return max(mem_ms, alu_ms), ("bytes" if mem_ms >= alu_ms else "operations")


def host_us(torch, fn, calls: int = 50) -> float:
    """Host time of one call of fn() enqueued behind the others, in
    microseconds: the wall time of `calls` calls with no synchronise
    between them.  Where it is close to a kernel's time_ms, the host's
    enqueue, not the card, sets that time."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def device_ms(torch, fn, calls: int = 20, reps: int = 5) -> float:
    """Median over `reps` runs of the device time of one call of fn(): the
    CUDA-event time of `calls` calls enqueued behind a spin kernel
    (torch.cuda._sleep) that keeps the card busy while the host enqueues
    them, so the host's time a call is hidden even where it is the larger
    (time_ms then reads the host)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)  # ~25 ms of spinning, longer than the enqueue
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def packed_compare(torch, packed, gf) -> dict:
    """One tree's packed kernels (this checkout's, or an older one's through
    --packed-timing-of) at the slice's shapes, RS(8,3) Vandermonde: ms
    (`time_ms`), device ms (`device_ms`) and host us a call (`host_us`) of
    packed_code at BULK and of RS(32,3)'s 3-erasure decode (the plan's
    program) at WIDE_SHAPE, packed_verify at SCRUB_SHAPE and packed_delta
    over 19 flat shard buffers at BULK.  Uses only the wrappers every tree
    since the packed kernels landed has."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 80)
    rand = lambda *shape: torch.randint(0, 256, shape, dtype=torch.uint8, device=dev,
                                        generator=gen)
    lowered = packed.lower_program(packed.best_program(gf.isa_rs_vandermonde_matrix(8, 3)[8:]))
    out = {}

    def timed(name, fn, host=True):
        out[name] = {"ms": time_ms(torch, fn), "device_ms": device_ms(torch, fn)}
        if host:
            out[name]["host_us"] = host_us(torch, fn)

    data = rand(*BULK)
    timed("packed_code", lambda: packed.packed_code(lowered, data))
    wmat, _ = gf.isa_decode_matrix(gf.isa_rs_vandermonde_matrix(32, 3), [0, 1, 2], 32)
    wide = packed.PackedPlan(wmat).lowered
    wdata = rand(*WIDE_SHAPE)
    timed("packed_code_wide", lambda: packed.packed_code(wide, wdata), host=False)
    del wdata
    vdata = rand(SCRUB_SHAPE[0], 8, SCRUB_SHAPE[2])
    cw = torch.cat([vdata, packed.packed_code(lowered, vdata)], dim=1)
    del vdata
    check(not bool(packed.packed_verify(lowered, cw).any()), "clean codewords flagged")
    timed("packed_verify", lambda: packed.packed_verify(lowered, cw))
    del cw
    shards = lambda t: [t[:, j].contiguous().view(-1) for j in range(t.shape[1])]
    bufs = (shards(data), shards(rand(*BULK)), shards(packed.packed_code(lowered, data)))
    timed("packed_delta", lambda: packed.packed_delta_flat(lowered, *bufs, BULK[2]))
    return out


def timing_turns(parent: str, flag: str, tag: str, card: str = "") -> list[dict]:
    """`chip_smoke.py <flag> ROOT` for an older tree (`parent`, the root of a
    checkout of it) and this one in turns (parent, this, this, parent), each
    in a process of its own so both trees' ceph_tpu_torch are imported under
    their own name.  Prints each timed name's four results and the
    change/parent ratio of the best of each side; returns the four JSON
    results."""
    runs = []
    here = os.path.dirname(os.path.abspath(__file__))
    for root in (parent, here, here, parent):
        proc = subprocess.run([sys.executable, os.path.abspath(__file__), flag,
                               os.path.abspath(root)], capture_output=True, text=True,
                              timeout=600)
        lines = [line for line in proc.stdout.splitlines() if line.startswith("{")]
        check(proc.returncode == 0 and lines,
              f"{flag} {root} failed: {proc.stderr.strip()[-2000:]}")
        runs.append(json.loads(lines[-1]))
    label = ("parent", "change", "change", "parent")
    for name in runs[0]:
        cells = "; ".join(
            f"{who} {r[name]['ms']:.4f} ms, device {r[name]['device_ms']:.4f}"
            + (f", host {r[name]['host_us']:.1f} us" if "host_us" in r[name] else "")
            for who, r in zip(label, runs))
        best = lambda rs, key: min(r[name][key] for r in rs)
        print(f"[{tag}] {name} parent/change: {cells}; change/parent "
              f"{best(runs[1:3], 'ms') / best(runs[::3], 'ms'):.3f}x (ms), "
              f"{best(runs[1:3], 'device_ms') / best(runs[::3], 'device_ms'):.3f}x (device)"
              + (f"; {card}" if card else ""))
    return runs


def parent_minima(runs: list[dict], names) -> dict:
    return {name: {"parent_ms": min(r[name]["ms"] for r in runs[::3]),
                   "parent_device_ms": min(r[name]["device_ms"] for r in runs[::3])}
            for name in names}


def parent_comparison(parent: str | None) -> dict:
    """`packed_compare` of an older tree beside this one's (`timing_turns`).
    Returns, per kernel, the parent's best ms and device ms (empty without
    a parent)."""
    if parent is None:
        print("[7] parent comparison: not run (no --parent DIR)")
        return {}
    runs = timing_turns(parent, "--packed-timing-of", "7")
    return parent_minima(runs, ("packed_code", "packed_verify", "packed_delta"))


def bluestore_compare(torch, co, dev) -> dict:
    """One tree's crc32c and transform kernels (this checkout's, or an older
    one's through --bluestore-timing-of) at 12b's shapes: ms (`time_ms`) and
    device ms (`device_ms`) of crc32c at CRC_BULK on random and on
    zero-heavy rows and at CRC_PATH, and of the transform at XFORM_BULK,
    XFORM_PATH and XFORM_GENERAL, on random rows.  Uses only the wrappers
    every tree since the two kernels landed has."""
    cuda = torch.device("cuda")
    gen = torch.Generator(device=cuda)
    gen.manual_seed(SEED + 124)
    rand = lambda *shape: torch.randint(0, 256, shape, dtype=torch.uint8, device=cuda,
                                        generator=gen)
    out = {}

    def timed(name, fn):
        out[name] = {"ms": time_ms(torch, fn), "device_ms": device_ms(torch, fn)}

    for S, L in (CRC_BULK, *CRC_PATH):
        rows = rand(S, L)
        timed(f"crc32c {S}x{L}", lambda: co.crc32c_device(rows))
        if (S, L) == CRC_BULK:
            rows[torch.rand((S, L), device=cuda, generator=gen) < 0.875] = 0
            timed(f"crc32c {S}x{L} zero-heavy", lambda: co.crc32c_device(rows))
        del rows
    for S, Lp in (XFORM_BULK, *XFORM_PATH, XFORM_GENERAL):
        rows = rand(S, Lp)
        timed(f"compress_transform {S}x{Lp}", lambda: dev.transform_rows_device(rows))
        del rows
    return out


def bluestore_parent_comparison(parent: str | None, card: str) -> dict:
    """12b's kernels of an older tree beside this one's (`timing_turns` of
    `bluestore_compare`).  Returns, per timed name, the parent's best ms and
    device ms (empty without a parent)."""
    if parent is None:
        print("[12] 12b parent comparison: not run (no --parent DIR)")
        return {}
    import torch

    torch.cuda.empty_cache()
    runs = timing_turns(parent, "--bluestore-timing-of", "12", card)
    return parent_minima(runs, runs[0])


def verify_host_steps(torch, packed, plan, cw, calls: int = 2000) -> dict:
    """Host us a call of each step of a `PackedVerifyPlan` call on a scrub
    chunk, each step timed alone: what `host_us` of the call is made of.
    `_launch` (packing the descriptor, the operand, the device and stream
    lookups, the C entry's launch, the count) is timed over 200 calls, so
    its launches do not fill the card's queue."""
    dev = cw.device
    lowered = plan.lowered
    src = packed._stripes(cw, cw.shape[1])
    flags = torch.empty(cw.shape[0], dtype=torch.uint8, device=dev)
    groups = (packed.group(src),)
    steps = {
        "record_launch": lambda: packed.record_launch(packed.lead_stripes(cw.shape), cw.numel(),
                                                      verify=True),
        "operand_for": lambda: plan.operand_for(cw),
        "_check": lambda: packed._check("packed_verify", cw),
        "_stripes": lambda: packed._stripes(cw, cw.shape[1]),
        "torch.empty flags": lambda: torch.empty(cw.shape[0], dtype=torch.uint8, device=dev),
        "group": lambda: packed.group(src),
        "_launch": lambda: packed._launch(packed.MODE_VERIFY, "packed_verify", lowered, groups,
                                          cw.shape[0], cw.shape[2], dev, flags),
        "  descriptor pack": lambda: packed.struct.pack("4q", *groups[0]),
        "  operand": lambda: lowered.operand(dev),
        "  current_device": lambda: torch.cuda.current_device(),
        "  raw stream": lambda: packed._RAW_STREAM(dev.index),
    }
    out = {}
    for name, fn in steps.items():
        n = 200 if name == "_launch" else calls
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        out[name] = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
    out["whole call"] = host_us(torch, lambda: plan(cw))
    return out


def phase_packed_timing(torch, packed, swar, gf) -> dict:
    """The three kernels timed (median of 20 runs of 5 calls) beside their
    plain versions and bounds, and each wrapper's host time a call and
    device time a call (`device_ms`); packed_code beside swar_gf in this
    call."""
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 70)
    mat = gf.isa_rs_vandermonde_matrix(8, 3)[8:]
    prog = packed.best_program(mat)
    lowered = packed.lower_program(prog)
    k, m = 8, 3
    out = {}
    S, _, L = BULK
    data = torch.randint(0, 256, BULK, dtype=torch.uint8, device=dev, generator=gen)
    plan = swar.CodingPlan(mat, device=dev)
    want = swar.swar_gf(plan, data)
    check(torch.equal(packed.packed_code(lowered, data), want), "packed_code != swar_gf at bulk")
    code_ms = time_ms(torch, lambda: packed.packed_code(lowered, data))
    swar_ms = time_ms(torch, lambda: swar.swar_gf(plan, data))
    code_plain_ms = time_ms(torch, lambda: packed.packed_code_reference(prog, data),
                            warmup=2, reps=5)
    bound, by = packed_bound(prog, (k + m) * S * L, S * L // 4)
    print(f"[7] packed_code {BULK}: {code_ms:.4f} ms, bound {bound:.4f} ms by {by} "
          f"({bound / code_ms:.3f} of it); swar_gf in this call {swar_ms:.4f} ms "
          f"(packed/swar {code_ms / swar_ms:.3f}x); plain {code_plain_ms:.4f} ms; "
          f"host {host_us(torch, lambda: packed.packed_code(lowered, data)):.1f} us a call")
    code_dev_ms = device_ms(torch, lambda: packed.packed_code(lowered, data))
    swar_dev_ms = device_ms(torch, lambda: swar.swar_gf(plan, data))
    print(f"[7] device time a call: packed_code {code_dev_ms:.4f} ms, swar_gf "
          f"{swar_dev_ms:.4f} ms")
    out["packed_code"] = {"ms": code_ms, "plain_ms": code_plain_ms, "bound_ms": bound,
                          "bound_by": by, "library_ms": None, "variant": f"{BULK}",
                          "swar_gf_ms": swar_ms, "device_ms": code_dev_ms}
    L2 = 131104
    ragged = torch.randint(0, 256, (S, k, L2), dtype=torch.uint8, device=dev, generator=gen)
    check(torch.equal(packed.packed_code(lowered, ragged),
                      packed.packed_code_reference(prog, ragged)), "packed_code != plain at L2")
    ragged_ms = time_ms(torch, lambda: packed.packed_code(lowered, ragged))
    rbound, rby = packed_bound(prog, (k + m) * S * L2, S * L2 // 4)
    print(f"[7] packed_code {(S, k, L2)}: {ragged_ms:.4f} ms, bound {rbound:.4f} ms by {rby} "
          f"({rbound / ragged_ms:.3f} of it)")
    del ragged
    out["packed_code"]["ragged_ms"] = ragged_ms
    # a wide decode: the construction a plan takes (the ring program, 128
    # threads a block) beside best_program (CSE, 204 slots, 64 threads)
    wmat, _ = gf.isa_decode_matrix(gf.isa_rs_vandermonde_matrix(32, 3), [0, 1, 2], 32)
    wplan = packed.PackedPlan(wmat)
    wbest = packed.lower_program(packed.best_program(wmat))
    wdata = torch.randint(0, 256, WIDE_SHAPE, dtype=torch.uint8, device=dev, generator=gen)
    check(torch.equal(packed.packed_code(wplan.lowered, wdata), packed.packed_code(wbest, wdata)),
          "RS(32,3) decode: the plan's program != best_program on the card")
    wide_ms = time_ms(torch, lambda: packed.packed_code(wplan.lowered, wdata))
    wbest_ms = time_ms(torch, lambda: packed.packed_code(wbest, wdata))
    Sw, kw, Lw = WIDE_SHAPE
    wbound, wby = packed_bound(wplan.lowered.prog, (kw + 3) * Sw * Lw, Sw * Lw // 4)
    print(f"[7] packed_code RS(32,3) decode {WIDE_SHAPE}: the plan's program "
          f"({len(wplan.lowered.ops)} ops, {wplan.lowered.nslots} slots, "
          f"{wplan.lowered.threads} threads) {wide_ms:.4f} ms, bound {wbound:.4f} ms by {wby} "
          f"({wbound / wide_ms:.3f} of it); best_program ({len(wbest.ops)} ops, "
          f"{wbest.nslots} slots, {wbest.threads} threads) {wbest_ms:.4f} ms")
    del wdata
    out["packed_code"].update(wide_variant=f"RS(32,3) decode {WIDE_SHAPE}", wide_ms=wide_ms,
                              wide_bound_ms=wbound, wide_best_program_ms=wbest_ms)
    # verify at one scrub chunk
    Sv, rows, Lv = SCRUB_SHAPE
    vdata = torch.randint(0, 256, (Sv, k, Lv), dtype=torch.uint8, device=dev, generator=gen)
    cw = torch.cat([vdata, packed.packed_code(lowered, vdata)], dim=1)
    del vdata
    check(not bool(packed.packed_verify(lowered, cw).any()), "clean codewords flagged")
    verify_ms = time_ms(torch, lambda: packed.packed_verify(lowered, cw))
    verify_plain_ms = time_ms(torch, lambda: packed.packed_verify_reference(prog, cw),
                              warmup=2, reps=5)
    vbound, vby = packed_bound(prog, rows * Sv * Lv + Sv, Sv * Lv // 4, extra_ops=m)
    verify_dev_ms = device_ms(torch, lambda: packed.packed_verify(lowered, cw))
    print(f"[7] packed_verify {SCRUB_SHAPE}: {verify_ms:.4f} ms, bound {vbound:.4f} ms by {vby} "
          f"({vbound / verify_ms:.3f} of it); plain {verify_plain_ms:.4f} ms; "
          f"host {host_us(torch, lambda: packed.packed_verify(lowered, cw)):.1f} us a call; "
          f"device {verify_dev_ms:.4f} ms a call")
    out["packed_verify"] = {"ms": verify_ms, "plain_ms": verify_plain_ms, "bound_ms": vbound,
                            "bound_by": vby, "library_ms": None, "variant": f"{SCRUB_SHAPE}",
                            "device_ms": verify_dev_ms}
    # the scrub launch's grid, and the host time of the plan's call step by step
    grid = (ctypes.c_int * 2)()
    flags = torch.empty(Sv, dtype=torch.uint8, device=dev)
    err = packed._LAUNCH(packed.MODE_VERIFY, packed.struct.pack("4q", *packed.group(cw)), 1,
                         lowered.operand(dev).data_ptr(), len(lowered.ops), lowered.nslots,
                         lowered.threads, k, m, Sv, Lv, packed._XTIME_RED, flags.data_ptr(),
                         packed._RAW_STREAM(cw.device.index), grid)
    torch.cuda.synchronize()
    check(err == 0, f"packed_verify launch for its grid: cudaError {err}")
    print(f"[7] packed_verify {SCRUB_SHAPE}: grid {grid[0]} blocks of {lowered.threads} threads "
          f"({grid[1]} resident an SM, {Sv / grid[0]:.2f} stripes a block)")
    steps = verify_host_steps(torch, packed, packed.PackedVerifyPlan(mat), cw)
    print("[7] packed_verify host us a call, step by step: "
          + ", ".join(f"{name.strip()} {us:.2f}" for name, us in steps.items()))
    out["packed_verify"]["host_us"] = steps["whole call"]
    del cw
    # delta over flat shard buffers at the bulk shape
    new = torch.randint(0, 256, BULK, dtype=torch.uint8, device=dev, generator=gen)
    shards = lambda t: [t[:, j].contiguous().view(-1) for j in range(t.shape[1])]
    bufs = (shards(data), shards(new), shards(want))
    del new
    check(torch.equal(packed.packed_delta_flat(lowered, *bufs, L),
                      packed.packed_delta_reference(prog, *(torch.stack(
                          [b.view(-1, L) for b in group], dim=1) for group in bufs))),
          "packed_delta_flat != plain at bulk")
    delta_ms = time_ms(torch, lambda: packed.packed_delta_flat(lowered, *bufs, L))
    stacked = [torch.stack([b.view(-1, L) for b in group], dim=1) for group in bufs]
    delta_plain_ms = time_ms(torch, lambda: packed.packed_delta_reference(prog, *stacked),
                             warmup=2, reps=5)
    dbound, dby = packed_bound(prog, (2 * k + 2 * m) * S * L, S * L // 4, extra_ops=k + m)
    delta_dev_ms = device_ms(torch, lambda: packed.packed_delta_flat(lowered, *bufs, L))
    print(f"[7] packed_delta flat {BULK}: {delta_ms:.4f} ms, bound {dbound:.4f} ms by {dby} "
          f"({dbound / delta_ms:.3f} of it); plain (stacked) {delta_plain_ms:.4f} ms; "
          f"host {host_us(torch, lambda: packed.packed_delta_flat(lowered, *bufs, L)):.1f} "
          f"us a call; device {delta_dev_ms:.4f} ms a call")
    print("[7] library_ms: none (no PyTorch call computes GF(2^8) coding)")
    out["packed_delta"] = {"ms": delta_ms, "plain_ms": delta_plain_ms, "bound_ms": dbound,
                           "bound_by": dby, "library_ms": None, "variant": f"flat {BULK}",
                           "device_ms": delta_dev_ms}
    sha = packed.build_info["source_sha256"]
    for row in out.values():
        row["source_sha256"] = sha
    return out


# Phase 8's deployment sizes: RBD's default 4 MiB object at stripe_unit
# 4096 (RS(8,3): 32 KiB stripes, 128 an object), 64 client writes from 8
# submitter threads (256 MiB), a backfill of 64 objects for each erasure
# class, 16 objects at isa's chunk length (the packed tier), one scrub chunk
# of 25 objects (osd_scrub_chunk_max), EncodePipeline over 32 objects.
RT_OBJECTS = 64
RT_THREADS = 8
RT_WINDOW = 8
RT_OBJECT_STRIPES = 128
RT_L = 4096
RT_ISA_OBJECTS = 16
RT_ISA_L = 524320
RT_SCRUB_OBJECTS = 25
RT_PIPELINE_OBJECTS = 32
RT_PIPELINE_DEPTH = 4
RT_CLASSES = ([0], [9], [0, 9], [0, 5, 10])  # PERF.md §2's four erasure classes
RT_INFLIGHT_POOLS = ("ec_pipeline_inflight", "verify", "offload_inflight")


class RuntimeProbe:
    """What phase 8 reads around each part: the kernels' own launch counts,
    the dispatch counters, the fallback gauge, the device guard, the
    in-flight pools and the flight records committed in the part."""

    def __init__(self, torch, swar, packed, dispatch, fr, guard, led):
        self.torch, self.swar, self.packed, self.dispatch = torch, swar, packed, dispatch
        self.fr, self.guard, self.led = fr, guard, led

    def counts(self) -> dict:
        d = self.dispatch
        return {"swar_gf": self.swar.launches, **self.packed.launches,
                "LAUNCHES": d.LAUNCHES.snapshot()["launches"],
                "DECODE_LAUNCHES": d.DECODE_LAUNCHES.snapshot()["launches"],
                "VERIFY_LAUNCHES": d.VERIFY_LAUNCHES.snapshot()["launches"],
                "FALLBACK_LAUNCHES": d.FALLBACK_LAUNCHES.snapshot()["launches"],
                "degraded_total": self.guard.snapshot()["degraded_total"]}

    def start(self) -> dict:
        self.torch.cuda.synchronize()
        self.fr.reset()
        return self.counts()

    def finish(self, part: str, before: dict, aggs, kernel: str,
               counter: str | None = None) -> dict:
        """Drain `aggs`, then hold the part to phase 8's four checks (no
        fallback, the guard never degraded, the in-flight pools at 0, one
        committed flight record a launch) and to: the aggregators' launches
        = the change in LAUNCHES (and in `counter`) = the change in
        `kernel`'s own launch count."""
        for agg in aggs:
            agg.drain()
        self.torch.cuda.synchronize()
        after = self.counts()
        delta = {key: after[key] - before[key] for key in after}
        launches = sum(int(agg.perf.get("launches")) for agg in aggs)
        records = [r for r in self.fr.records() if r["group"] != "#raw"]
        check(launches > 0, f"{part}: no aggregated launch")
        check(delta["FALLBACK_LAUNCHES"] == 0,
              f"{part}: {delta['FALLBACK_LAUNCHES']} launches fell back to the host")
        check(delta["degraded_total"] == 0 and not self.guard.degraded,
              f"{part}: the device guard degraded ({self.guard.reason})")
        check(delta["LAUNCHES"] == launches,
              f"{part}: LAUNCHES moved {delta['LAUNCHES']}, the aggregator launched {launches}")
        check(delta[kernel] == launches,
              f"{part}: {kernel} launched {delta[kernel]} times for {launches} launches")
        if counter is not None:
            check(delta[counter] == launches,
                  f"{part}: {counter} moved {delta[counter]} for {launches} launches")
        held = {pool: self.led.current_bytes(pool) for pool in RT_INFLIGHT_POOLS}
        check(not any(held.values()), f"{part}: in-flight pools after the drain: {held}")
        check(len(records) == launches,
              f"{part}: {len(records)} committed flight records for {launches} launches")
        check(not any(r["flags"]["fallback"] or r["flags"]["error"] for r in records),
              f"{part}: a flight record flags a fallback or an error")
        return {"delta": delta, "launches": launches, "records": records}


def span_medians(records) -> dict:
    """Median of each flight-record span over a part's launches, in ms
    (none when the part launched nothing)."""
    return {span: statistics.median(r[span] for r in records) * 1e3
            for span in ("queue_wait_s", "h2d_s", "kernel_s", "d2h_s") if records}


def phase_runtime(torch, swar, packed, dispatch, registry, card) -> dict:
    """The offload runtime at a deployment's size through plugin `tpu`
    RS(8,3) reed_sol_van on the card: the encode, decode and verify
    aggregators (8a-8c), EncodePipeline (8d), the guard drill (8e) and the
    QoS order (8f).  The kernels' launch counts are set to 0 just before
    and each must be non-zero after."""
    import threading

    from ceph_tpu_torch.codec import matrix_codec as mc
    from ceph_tpu_torch.common.fault_injector import global_injector
    from ceph_tpu_torch.common.mempool import ledger
    from ceph_tpu_torch.ops.flight_recorder import flight_recorder
    from ceph_tpu_torch.ops.guard import device_guard
    from ceph_tpu_torch.ops.launch_scheduler import CLASS_BY_LANE, launch_scheduler

    ec = registry.instance().factory("tpu", {"k": "8", "m": "3", "technique": "reed_sol_van"})
    check(ec.device.type == "cuda", f"codec on {ec.device}, want cuda")
    k, m = ec.k, ec.m
    mat = ec.distribution_matrix()[k:]
    guard = device_guard()
    check(guard.timeout_ms == 20000 and not guard.degraded,
          f"device guard at {guard.timeout_ms} ms, degraded {guard.degraded}")
    probe = RuntimeProbe(torch, swar, packed, dispatch, flight_recorder(), guard, ledger())
    rng = np.random.default_rng(SEED + 80)
    objs = rng.integers(0, 256, (RT_OBJECTS, RT_OBJECT_STRIPES, k, RT_L), dtype=np.uint8)
    want_parity = ec.encode_array_host(objs.reshape(-1, k, RT_L)).reshape(
        RT_OBJECTS, RT_OBJECT_STRIPES, m, RT_L)
    full = np.concatenate([objs, want_parity], axis=2)  # (objects, stripes, k + m, L)
    swar.launches = 0
    for kernel in PACKED_KERNELS:
        packed.launches[kernel] = 0
    out: dict = {"spans": {}}

    # 8a: 64 client writes from 8 submitter threads, reaped out of order
    def write_all(window: int) -> tuple[float, dict, object]:
        agg = mc.EncodeAggregator(window=window)
        got: list = [None] * RT_OBJECTS
        errors: list = []

        def submitter(t: int) -> None:
            try:
                tickets = [(i, agg.submit(ec, objs[i])) for i in range(t, RT_OBJECTS, RT_THREADS)]
                for i, ticket in reversed(tickets):
                    got[i] = ticket.result()
            except BaseException as e:  # surfaced after the join
                errors.append(e)

        before = probe.start()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=submitter, args=(t,)) for t in range(RT_THREADS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=300)
            check(not th.is_alive(), "8a: a submitter thread did not finish")
        seconds = time.perf_counter() - t0
        check(not errors, f"8a: a submitter failed: {errors[:1]}")
        res = probe.finish(f"8a window {window}", before, [agg], "swar_gf")
        for i in range(RT_OBJECTS):
            check(np.array_equal(got[i], want_parity[i]),
                  f"8a window {window}: object {i}'s parity != encode_array_host")
        return objs.nbytes / seconds / 1e9, res, agg

    gbps1, res1, _ = write_all(1)
    gbps8, res8, agg8 = write_all(RT_WINDOW)
    out["spans"]["8a window 1"] = span_medians(res1["records"])
    out["spans"]["8a window 8"] = span_medians(res8["records"])
    out["8a"] = {"GBps_window1": gbps1, "GBps_window8": gbps8,
                 "launches_window1": res1["launches"], "launches_window8": res8["launches"],
                 "fused_launches": int(agg8.perf.get("fused_launches"))}
    print(f"[8] 8a: {RT_OBJECTS} writes of 4 MiB ({objs.nbytes >> 20} MiB) from {RT_THREADS} "
          f"threads, exact: host-to-host {gbps1:.3f} GB/s at window 1 ({res1['launches']} "
          f"launches), {gbps8:.3f} GB/s at window {RT_WINDOW} ({res8['launches']} launches, "
          f"{out['8a']['fused_launches']} fused); {card}")

    # 8b: a backfill, 64 objects for each erasure class, reaped out of order
    dec = mc.DecodeAggregator(window=RT_WINDOW)
    before = probe.start()
    tickets = []
    for erasures in RT_CLASSES:
        idx = ec.decode_index(erasures)
        tickets += [(erasures, i, dec.submit(ec, erasures, full[i][:, idx]))
                    for i in range(RT_OBJECTS)]
    got = [None] * len(tickets)
    for j in rng.permutation(len(tickets)):
        erasures, i, ticket = tickets[j]
        got[j] = ticket.result()
        check(np.array_equal(got[j], full[i][:, erasures]),
              f"8b: decode {erasures} of object {i} != the encoded bytes")
    res = probe.finish("8b backfill", before, [dec], "swar_gf", "DECODE_LAUNCHES")
    out["spans"]["8b backfill"] = span_medians(res["records"])
    for c, erasures in enumerate(RT_CLASSES):  # the host oracle on one object a class
        j = c * RT_OBJECTS + c
        want = ec.decode_array_host(erasures, full[c][:, ec.decode_index(erasures)])
        check(np.array_equal(got[j], want), f"8b: decode {erasures} != decode_array_host")
    del tickets, got
    # 16 objects at isa's chunk length: the packed tier, which writes into a
    # donated out= buffer; two rounds, so the second reuses the first's
    isa = rng.integers(0, 256, (RT_ISA_OBJECTS, 1, k, RT_ISA_L), dtype=np.uint8)
    isa_full = np.concatenate(
        [isa, ec.encode_array_host(isa.reshape(-1, k, RT_ISA_L))[:, None]], axis=2)
    erasures = RT_CLASSES[-1]
    idx = ec.decode_index(erasures)
    check(ec.decode_donatable(erasures, (RT_WINDOW, k, RT_ISA_L)),
          "8b: the packed tier's decode does not take a donated buffer")
    dec_isa = mc.DecodeAggregator(window=RT_WINDOW)
    pipe0 = dispatch.PIPELINE.snapshot()
    before = probe.start()
    for first in range(0, RT_ISA_OBJECTS, RT_WINDOW):
        round_tickets = [(i, dec_isa.submit(ec, erasures, isa_full[i][:, idx]))
                         for i in range(first, first + RT_WINDOW)]
        for i, ticket in reversed(round_tickets):
            check(np.array_equal(ticket.result(), isa_full[i][:, erasures]),
                  f"8b: packed-tier decode of object {i} != the encoded bytes")
    check(np.array_equal(isa_full[0][:, erasures],
                         ec.decode_array_host(erasures, isa_full[0][:, idx])),
          "8b: packed-tier decode != decode_array_host")
    res = probe.finish("8b packed tier", before, [dec_isa], "packed_code", "DECODE_LAUNCHES")
    out["spans"]["8b packed tier"] = span_medians(res["records"])
    pipe1 = dispatch.PIPELINE.snapshot()
    reused = pipe1["donation_reuses"] - pipe0["donation_reuses"]
    live = pipe1["donation_recycled_live"] - pipe0["donation_recycled_live"]
    check(reused > 0, "8b: no donated out= buffer was reused on the packed tier")
    check(live == 0, f"8b: {live} live buffers were handed out for donation")
    out["8b"] = {"donation_reused": reused, "recycled_live": live}
    print(f"[8] 8b: {RT_OBJECTS} objects x {len(RT_CLASSES)} erasure classes at L={RT_L} and "
          f"{RT_ISA_OBJECTS} objects at L={RT_ISA_L} decoded exact; donated buffers reused "
          f"{reused}, live recycled {live}")
    del isa, isa_full

    # 8c: one scrub chunk, submitted object by object: one verify launch a pass
    chunk = np.ascontiguousarray(full[:RT_SCRUB_OBJECTS])
    corrupt = chunk.copy()
    want_bits = np.zeros(RT_SCRUB_OBJECTS * RT_OBJECT_STRIPES, np.uint8)
    for pos in range(k + m):  # object pos, stripe pos, shard pos
        corrupt[pos, pos, pos, (pos * 373) % RT_L] ^= 1 << (pos % 8)
        want_bits[pos * RT_OBJECT_STRIPES + pos] = verify_expected(mat, k, m, pos)
    for label, codewords, want in (("clean", chunk, np.zeros_like(want_bits)),
                                   ("corrupted", corrupt, want_bits)):
        # the default 64 MiB budget would split the 141 MB chunk into three
        ver = mc.VerifyAggregator(window=64, max_bytes=codewords.nbytes)
        before = probe.start()
        tickets = [ver.submit(ec, codewords[i]) for i in range(RT_SCRUB_OBJECTS)]
        bitmap = np.concatenate([t.result() for t in reversed(tickets)][::-1])
        res = probe.finish(f"8c {label}", before, [ver], "packed_verify", "VERIFY_LAUNCHES")
        check(res["launches"] == 1, f"8c {label}: {res['launches']} verify launches, want 1")
        check(res["records"][0]["sched_class"] == "background",
              "8c: the verify launch did not ride the background lane")
        check(np.array_equal(bitmap, want), f"8c {label}: bitmap not exact")
        check(np.array_equal(bitmap, ec.verify_array_host(codewords.reshape(-1, k + m, RT_L))),
              f"8c {label}: bitmap != verify_array_host")
        out["spans"][f"8c {label}"] = span_medians(res["records"])
    print(f"[8] 8c: scrub chunk ({RT_SCRUB_OBJECTS * RT_OBJECT_STRIPES}, {k + m}, {RT_L}) "
          f"submitted per object, one verify launch a pass, clean and corrupted at every "
          f"shard position, exact")
    del chunk, corrupt

    # 8d: EncodePipeline(depth=4) over 32 objects: poll never waits on a kernel
    pipe = mc.EncodePipeline(ec, depth=RT_PIPELINE_DEPTH)
    raw = objs[:RT_PIPELINE_OBJECTS].reshape(RT_PIPELINE_OBJECTS, -1)
    real_complete, polling = pipe._complete, [False]
    unready_reaps = []

    def complete(ticket, chunks, parity_dev, event):
        if polling[0] and not event.query():  # poll may reap only fired events
            unready_reaps.append(ticket)
        return real_complete(ticket, chunks, parity_dev, event)

    pipe._complete = complete
    before = probe.start()
    stripes, reaped, poll_s = [], [], []
    for i in range(RT_PIPELINE_OBJECTS):
        chunks = ec.encode_prepare(raw[i])
        stripes.append(chunks)
        pipe.submit(chunks)
        polling[0] = True
        t0 = time.perf_counter()
        reaped += pipe.poll()
        poll_s.append(time.perf_counter() - t0)
        polling[0] = False
    by_poll = len(reaped)
    reaped += pipe.flush()
    torch.cuda.synchronize()
    delta = {key: val - before[key] for key, val in probe.counts().items()}
    check(sorted(reaped) == list(range(1, RT_PIPELINE_OBJECTS + 1)),
          f"8d: tickets reaped {sorted(reaped)}")
    check(not unready_reaps, f"8d: poll reaped unfinished launches {unready_reaps}")
    check(delta["swar_gf"] == delta["LAUNCHES"] == RT_PIPELINE_OBJECTS
          and delta["FALLBACK_LAUNCHES"] == 0,
          f"8d: launches {delta} for {RT_PIPELINE_OBJECTS} submits")
    L = len(stripes[0][0])
    want = ec.encode_array_host(raw.reshape(RT_PIPELINE_OBJECTS, k, L))
    for i, chunks in enumerate(stripes):
        for r in range(m):
            check(np.array_equal(chunks[k + r], want[i, r]),
                  f"8d: object {i} parity chunk {r} != encode_array_host")
    out["8d"] = {"reaped_by_poll": by_poll, "poll_ms_max": max(poll_s) * 1e3}
    print(f"[8] 8d: EncodePipeline(depth={RT_PIPELINE_DEPTH}) over {RT_PIPELINE_OBJECTS} "
          f"objects (L={L}), exact; {by_poll} reaped by poll, the rest by flush; poll "
          f"{statistics.median(poll_s) * 1e3:.4f} ms median, {max(poll_s) * 1e3:.4f} ms max")

    # 8e: the guard drill: a faulted launch fails with EIO, the probe heals
    from ceph_tpu_torch.codec.interface import EcError

    agg = mc.EncodeAggregator(window=0)
    before = probe.start()
    global_injector().inject("codec.launch", 5, hits=1)
    faulted = agg.submit(ec, objs[0])
    try:
        faulted.result()
        check(False, "8e: the faulted launch returned bytes")
    except EcError as e:
        check(e.errno == -5 and "InjectedFailure" in str(e),
              f"8e: the faulted launch raised {e!r}, want EIO from the fault")
    mid = probe.counts()
    check(mid["FALLBACK_LAUNCHES"] == before["FALLBACK_LAUNCHES"]
          and agg.perf.get("host_fallbacks") == 0,
          "8e: the faulted launch was recomputed on the host")
    check(mid["swar_gf"] == before["swar_gf"] and mid["LAUNCHES"] == before["LAUNCHES"],
          "8e: the faulted launch reached the kernel")
    check(guard.degraded and mid["degraded_total"] - before["degraded_total"] == 1,
          "8e: the backend is not DEGRADED after the fault")
    rec = [r for r in flight_recorder().records() if r["group"] != "#raw"][-1]
    check(rec["flags"]["error"] and not rec["flags"]["fallback"],
          "8e: the faulted launch's flight record does not flag its error")
    probes0 = guard.probes
    check(np.array_equal(agg.submit(ec, objs[1]).result(), want_parity[1]),
          "8e: the healed launch's parity != encode_array_host")
    after = probe.counts()
    check(not guard.degraded and guard.probes == probes0 + 1,
          f"8e: the probe did not heal the backend ({guard.snapshot()})")
    check(after["swar_gf"] == mid["swar_gf"] + 1 and after["LAUNCHES"] == mid["LAUNCHES"] + 1
          and after["FALLBACK_LAUNCHES"] == mid["FALLBACK_LAUNCHES"],
          "8e: the launch after the heal did not run the kernel")
    agg.drain()
    print("[8] 8e: codec.launch armed once: EIO to its reap, no host recompute, "
          "FALLBACK_LAUNCHES unchanged, DEGRADED; the cuda probe healed it and the "
          "next launch ran swar_gf, exact")

    # 8f: a queued client encode leaves the scheduler ahead of a queued verify
    sched = launch_scheduler()
    enc, ver = mc.EncodeAggregator(window=0), mc.VerifyAggregator(window=0)
    hold = threading.Event()
    results: dict = {}
    before = probe.start()
    holder = threading.Thread(target=sched.submit,
                              args=(CLASS_BY_LANE["client"], lambda: hold.wait(60)))
    holder.start()
    deadline = time.monotonic() + 60
    while not sched._busy and time.monotonic() < deadline:
        time.sleep(0.001)
    background = threading.Thread(
        target=lambda: results.update(verify=ver.submit(ec, full[0]).result()))
    background.start()
    while sched.queue_depths()["background"] < 1 and time.monotonic() < deadline:
        time.sleep(0.001)
    client = threading.Thread(
        target=lambda: results.update(encode=enc.submit(ec, objs[2]).result()))
    client.start()
    while sched.queue_depths()["client"] < 1 and time.monotonic() < deadline:
        time.sleep(0.001)
    check(sched.queue_depths() == {"client": 1, "recovery": 0, "background": 1},
          f"8f: queued {sched.queue_depths()}")
    hold.set()
    for th in (holder, background, client):
        th.join(timeout=120)
        check(not th.is_alive(), "8f: a submitter did not finish")
    check(np.array_equal(results["encode"], want_parity[2]) and not results["verify"].any(),
          "8f: the QoS launches' bytes are not exact")
    recs = {r["kind"]: r for r in flight_recorder().records() if r["group"] != "#raw"}
    check(recs["encode"]["dispatch_ts"] < recs["verify"]["dispatch_ts"],
          "8f: the queued background verify left the scheduler before the client encode")
    for agg in (enc, ver):
        agg.drain()
    delta = {key: val - before[key] for key, val in probe.counts().items()}
    check(delta["FALLBACK_LAUNCHES"] == 0 and delta["degraded_total"] == 0,
          f"8f: fallback or degraded: {delta}")
    print("[8] 8f: with the device turn held, a queued client encode left the launch "
          "scheduler ahead of a queued background verify")

    launches = {"swar_gf": swar.launches, **packed.launches}
    for kernel in ("swar_gf", "packed_code", "packed_verify"):
        check(launches[kernel] > 0, f"phase 8 never launched {kernel}")
    dump = dispatch.perf_dump()
    gauges = {key: dump[key] for key in sorted(dump)
              if key.startswith("pipeline.") or key in ("padding_waste_ratio",
                                                        "fused_launches", "fused_windows")}
    check(gauges["pipeline.donation_recycled_live"] == 0,
          "pipeline.donation_recycled_live is not 0")
    for part, spans in out["spans"].items():
        print(f"[8] {part}: median per launch (ms): "
              + ", ".join(f"{span} {ms:.4f}" for span, ms in spans.items()) + f"; {card}")
    print(f"[8] pipeline and padding gauges: {gauges}; kernel launches {launches}; {card}")
    out["gauges"] = gauges
    out["launches"] = launches
    return out


# Phase 9's deployments, both plugin `tpu` RS(8,3) reed_sol_van at
# osd_pool_erasure_code_stripe_unit 4096 (32 KiB stripes): RBD's data pool
# on EC with allow_ec_overwrites (Ceph's "Erasure Coding with Overwrites"),
# 64 objects of RBD's 4 MiB, written whole at QD1 and QD8, then 256 RMW
# writes of 4-64 KiB in batches of 8; and RGW's append-only EC data pool
# (the hinfo path), 16 objects of 4 appends of 1 MiB.
BK_K, BK_M, BK_SU = 8, 3, 4096
BK_OBJECTS = 64
BK_OBJECT_BYTES = 4 << 20
BK_QD = 8
BK_RMW_WRITES = 256
BK_RMW_BYTES = (4 << 10, 64 << 10)
BK_RGW_OBJECTS = 16
BK_RGW_APPENDS = 4
BK_RGW_APPEND = 1 << 20
BK_CORRUPT = 4
BK_EIO_HOLES = [0, 1, 2, 3]
BK_PROFILE = {"plugin": "tpu", "k": str(BK_K), "m": str(BK_M), "technique": "reed_sol_van"}


class BkCluster:
    """Phase 9's in-process cluster (the harness of tests/test_ec_backend.py):
    one port ECBackend per OSD over a MemStore (or what `make_store` makes),
    each OSD holding one shard of one PG, the primary on OSD 0, messages
    through a pumped queue.  The codecs come from build_pg_backend with no
    device argument."""

    def __init__(self, pool_id: int, name: str, overwrites: bool, profile: dict | None = None,
                 make_store=None):
        from ceph_tpu_torch.msg.messages import PgId, ReqId
        from ceph_tpu_torch.os.memstore import MemStore
        from ceph_tpu_torch.os.transaction import Transaction
        from ceph_tpu_torch.osd import osdmap
        from ceph_tpu_torch.osd.ec_transaction import PGTransaction
        from ceph_tpu_torch.osd.pg_backend import PGListener, build_pg_backend, shard_coll
        from ceph_tpu_torch.osd.pg_log import Eversion

        cluster = self
        self.ReqId, self.PGTransaction, self.PG_NONE = ReqId, PGTransaction, osdmap.PG_NONE

        class Listener(PGListener):
            def __init__(self, osd):
                self.osd, self.pgid, self.version = osd, cluster.pgid, 0
                self.log, self.clog, self.hists = [], [], collections.defaultdict(list)

            def whoami(self):
                return self.osd

            def whoami_shard(self):
                return self.osd

            def acting(self):
                return cluster.acting

            def epoch(self):
                return 1

            def next_version(self):
                self.version += 1
                return Eversion(1, self.version)

            def send_shard(self, osd, msg):
                cluster.queue.append((osd, msg))

            def append_log(self, entry):
                self.log.append(entry)

            def clog_error(self, msg):
                self.clog.append(msg)

            def perf_hist(self, name, value):
                self.hists[name].append(value)

            def get_shard_missing(self, oid):
                return cluster.missing.get(oid, set())

        profile = dict(profile or BK_PROFILE)
        k = int(profile["k"])
        n = k + int(profile["m"])
        self.pool = osdmap.PgPool(
            id=pool_id, name=name, type=osdmap.POOL_TYPE_ERASURE, size=n, min_size=k + 1,
            pg_num=1, erasure_code_profile="ec", stripe_width=k * BK_SU,
            flags=osdmap.FLAG_EC_OVERWRITES if overwrites else 0, application=name)
        self.pgid = PgId(pool_id, 0, -1)
        self.acting = list(range(n))
        self.queue: list = []
        self.missing: dict = {}
        self.commits: collections.Counter = collections.Counter()
        self.failures: list = []
        self.failed_ok: set = set()  # tags a drill failed on purpose
        self.latency: dict = {}
        self.colls = [shard_coll(self.pgid, s) for s in range(n)]
        self.stores, self.listeners, self.backends = [], [], []
        for osd in range(n):
            store = MemStore() if make_store is None else make_store()
            store.mount()
            store.queue_transaction(Transaction().create_collection(self.colls[osd]))
            listener = Listener(osd)
            self.backends.append(build_pg_backend(self.pool, {"ec": dict(profile)},
                                                  listener, store))
            self.stores.append(store)
            self.listeners.append(listener)
        self.submitted = 0

    @property
    def primary(self):
        return self.backends[0]

    def pump(self) -> None:
        """Deliver queued messages until quiescent, reaping the launched
        encodes first (no event loop here: flush_encodes is the barrier)."""
        while True:
            for b in self.backends:
                b.flush_encodes()
            if not self.queue:
                return
            osd, msg = self.queue.pop(0)
            if osd != self.PG_NONE:
                self.backends[osd].handle_message(msg)

    def drain(self) -> None:
        """Deliver queued messages until quiescent with the barrier
        (flush_encodes, which also reaps the recovery decodes) only when the
        queue runs dry: the recovery decodes of the objects whose reads
        complete in one delivery round share aggregated launches, as they do
        on an OSD's event loop."""
        while True:
            while self.queue:
                osd, msg = self.queue.pop(0)
                if osd != self.PG_NONE:
                    self.backends[osd].handle_message(msg)
            for b in self.backends:
                b.flush_encodes()
            if not self.queue:
                return

    def submit(self, pgt) -> int:
        self.submitted += 1
        tag = self.submitted
        t0 = time.perf_counter()

        def on_commit():
            self.commits[tag] += 1
            self.latency[tag] = time.perf_counter() - t0

        self.primary.submit_transaction(pgt, self.ReqId("client.9", tag), on_commit,
                                        lambda err: self.failures.append((tag, err)))
        return tag

    def writefull(self, oid: str, data: bytes) -> int:
        return self.submit(self.PGTransaction(oid, truncate=len(data)).write(0, data))

    def read(self, reads: dict, backend=None) -> dict:
        out: dict = {}
        (backend or self.primary).objects_read_and_reconstruct(reads, out.update)
        self.pump()
        check(set(out) == set(reads), f"reads {sorted(reads)} completed {sorted(out)}")
        return out

    def shard(self, s: int, oid: str) -> bytes:
        return bytes(self.stores[s]._colls[self.colls[s]][oid].data)

    def settled(self, part: str, led) -> None:
        """Every commit fired once, nothing failed (but the writes a drill
        failed on purpose, once each), and after the final barrier no
        backend holds an op, a pin or an in-flight pool byte."""
        for b in self.backends:
            b.flush_encodes()
        check(sorted(t for t, _err in self.failures) == sorted(self.failed_ok)
              and not self.failed_ok & set(self.commits),
              f"{part}: on_failure fired: {self.failures[:4]}")
        check(len(self.commits) == self.submitted - len(self.failed_ok)
              and all(v == 1 for v in self.commits.values()),
              f"{part}: {len(self.commits)} of {self.submitted} writes committed, "
              f"repeats {[t for t, v in self.commits.items() if v != 1][:4]}")
        for b in self.backends:
            check(not b.in_flight and not b._encode_pipe and not b.waiting_reads
                  and not b.read_ops and not b._projected and b.extent_cache.empty()
                  and not b.recovery_ops and not b._decode_pipe,
                  f"{part}: osd.{b.listener.osd} still holds ops or pins")
        held = {pool: led.current_bytes(pool) for pool in RT_INFLIGHT_POOLS}
        check(not any(held.values()), f"{part}: in-flight pools after the drain: {held}")


class StageClock:
    """Exclusive wall time of the write path's stages: each wrapped call's
    time less the wrapped calls inside it (per thread).  Installed around
    one part only, then removed."""

    def __init__(self):
        self.totals: collections.Counter = collections.Counter()
        self._local = threading.local()
        self._lock = threading.Lock()
        self._undo: list = []

    def _timed(self, stage: str, fn):
        def timed(*args, **kwargs):
            stack = self._local.__dict__.setdefault("stack", [])
            stack.append(0.0)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                inner = stack.pop()
                with self._lock:
                    self.totals[stage] += dt - inner
                if stack:
                    stack[-1] += dt
        return timed

    def wrap(self, owner, attr: str, stage: str) -> None:
        """Time `owner.attr` (a class's method or classmethod, inherited
        or its own, or a name in a module's namespace dict) as `stage`."""
        if isinstance(owner, dict):
            orig = owner[attr]
            owner[attr] = self._timed(stage, orig)
            self._undo.append(lambda: owner.__setitem__(attr, orig))
            return
        static = inspect.getattr_static(owner, attr)
        own = attr in vars(owner)
        if isinstance(static, classmethod):
            setattr(owner, attr, classmethod(self._timed(stage, static.__func__)))
        else:
            setattr(owner, attr, self._timed(stage, static))
        self._undo.append((lambda: setattr(owner, attr, static)) if own
                          else (lambda: delattr(owner, attr)))

    def install(self) -> "StageClock":
        from ceph_tpu_torch.ops.offload_runtime import LaunchAggregator
        from ceph_tpu_torch.os.memstore import MemStore
        from ceph_tpu_torch.os.transaction import Transaction
        from ceph_tpu_torch.osd import ec_backend
        from ceph_tpu_torch.stripe import stripe
        from ceph_tpu_torch.stripe.hashinfo import HashInfo

        for owner, attr, stage in (
            (ec_backend.ECBackend, "submit_transaction", "submit"),
            (vars(ec_backend), "launch_encode", "merge"),
            (vars(stripe), "encode_launch", "dispatch"),
            (LaunchAggregator, "_launch", "dispatch"),
            (stripe.PendingEncode, "result", "reap"),
            (vars(ec_backend), "finish_transactions", "finish_transactions"),
            (Transaction, "tobytes", "txn_codec"),
            (Transaction, "frombytes", "txn_codec"),
            (MemStore, "queue_transaction", "apply"),
            (HashInfo, "append", "hinfo_crc"),
            (HashInfo, "verify_chunk", "hinfo_crc"),
            (BkCluster, "pump", "pump"),
        ):
            self.wrap(owner, attr, stage)
        return self

    def remove(self) -> None:
        while self._undo:
            self._undo.pop()()

    def shares(self, wall: float) -> dict:
        out = {stage: t / wall for stage, t in sorted(self.totals.items())}
        out["other"] = 1.0 - sum(out.values())
        return out


def phase_backend(torch, swar, packed, dispatch, registry, card) -> dict:
    """The port's ECBackend on the card at a deployment's size (9a-9e):
    client writes, RMW overwrites, whole, degraded and corrupted reads
    through the default encode and decode aggregators onto swar_gf."""
    from ceph_tpu_torch.codec import matrix_codec as mc
    from ceph_tpu_torch.common.mempool import ledger
    from ceph_tpu_torch.common.options import OPTIONS
    from ceph_tpu_torch.ops.flight_recorder import flight_recorder
    from ceph_tpu_torch.ops.guard import device_guard
    from ceph_tpu_torch.osd.ec_transaction import HINFO_ATTR
    from ceph_tpu_torch.stripe.hashinfo import HashInfo
    from ceph_tpu_torch.utils import crc32c as crc_mod

    t_phase = time.perf_counter()
    led, fr, guard = ledger(), flight_recorder(), device_guard()
    enc_agg, dec_agg = mc.default_encode_aggregator(), mc.default_decode_aggregator()
    probe = RuntimeProbe(torch, swar, packed, dispatch, fr, guard, led)
    rbd = BkCluster(1, "rbd", overwrites=True)
    ec = rbd.primary.ec
    check(ec.device.type == "cuda", f"the backend's codec is on {ec.device}, want cuda")
    sw = rbd.pool.stripe_width
    stripes = BK_OBJECT_BYTES // sw
    tier = mc._DeviceCoder.tier((stripes, BK_K, BK_SU))
    kernel = {"swar": "swar_gf", "packed": "packed_code"}.get(tier)
    check(kernel == "swar_gf", f"the backend's chunk {BK_SU} takes the {tier} tier")
    rng = np.random.default_rng(SEED + 90)
    model = rng.integers(0, 256, (BK_OBJECTS, BK_OBJECT_BYTES), dtype=np.uint8)
    oids = [f"rbd_data.{i:016x}" for i in range(BK_OBJECTS)]
    out: dict = {"spans": {}}
    swar.launches = 0
    for name in PACKED_KERNELS:
        packed.launches[name] = 0

    def part(label: str, before: dict, aggs0: tuple, decodes: int | None = None) -> dict:
        """The launch checks of one part: the aggregators' launches = the
        change in LAUNCHES (DECODE_LAUNCHES for the decodes) = the change
        in the tier's kernel count, plus one packed_delta launch a delta
        record; no fallback, no degrade; one committed flight record a
        launch.  At the option defaults the device chunk cache is on: a
        reconstruct it serves commits a `#cache` record and launches
        nothing, and a cache-hit RMW a `#delta` record (zero h2d and d2h)."""
        torch.cuda.synchronize()
        delta = {key: val - before[key] for key, val in probe.counts().items()}
        enc = int(enc_agg.perf.get("launches")) - aggs0[0]
        dec = int(dec_agg.perf.get("launches")) - aggs0[1]
        all_records = [r for r in fr.records() if r["group"] != "#raw"]
        served = [r for r in all_records if r["group"] == "#cache"]
        deltas = [r for r in all_records if r["group"] == "#delta"]
        records = [r for r in all_records if r["group"] not in ("#cache", "#delta")]
        check(delta["LAUNCHES"] == enc + dec + len(deltas)
              and delta["DECODE_LAUNCHES"] == dec,
              f"{label}: LAUNCHES +{delta['LAUNCHES']}, DECODE_LAUNCHES "
              f"+{delta['DECODE_LAUNCHES']} for {enc} encode, {dec} decode and "
              f"{len(deltas)} delta launches")
        check(delta[kernel] == enc + dec and delta["packed_delta"] == len(deltas),
              f"{label}: {kernel} launched {delta[kernel]} times for {enc + dec} launches, "
              f"packed_delta {delta['packed_delta']} for {len(deltas)} delta records")
        check(delta["FALLBACK_LAUNCHES"] == 0 and delta["degraded_total"] == 0
              and not guard.degraded, f"{label}: fallback or degraded: {delta}")
        check(len(records) == enc + dec,
              f"{label}: {len(records)} committed flight records for {enc + dec} launches")
        check(not any(r["flags"]["fallback"] or r["flags"]["error"] for r in all_records),
              f"{label}: a flight record flags a fallback or an error")
        check(all(r["h2d_s"] == 0 and r["kernel_s"] == 0 and r["flags"]["cache_hit"]
                  for r in served), f"{label}: a cache-served record has h2d or kernel time")
        check(all(r["h2d_s"] == 0 and r["d2h_s"] == 0 and r["flags"]["delta"]
                  for r in deltas), f"{label}: a delta record has h2d or d2h time")
        if decodes is not None:
            check((dec > 0) == (decodes > len(served)) and dec <= decodes,
                  f"{label}: {dec} decode launches for {decodes} decodes, "
                  f"{len(served)} served by the cache")
        return {"enc": enc, "dec": dec, "records": records, "served": len(served),
                "deltas": len(deltas)}

    def aggs0():
        return int(enc_agg.perf.get("launches")), int(dec_agg.perf.get("launches"))

    # 9a: 64 WRITEFULLs of 4 MiB at QD1 (write, pump), then at QD8 (8 writes,
    # one pump; encode window 8: one launch a batch)
    for qd, window in ((1, int(OPTIONS["ec_tpu_aggregate_window"].default)), (BK_QD, BK_QD)):
        if qd > 1:
            model = rng.integers(0, 256, (BK_OBJECTS, BK_OBJECT_BYTES), dtype=np.uint8)
        enc_agg.configure(window=window)
        clock = StageClock().install() if qd > 1 else None
        before, a0 = probe.start(), aggs0()
        rbd.listeners[0].hists.clear()
        t0 = time.perf_counter()
        for first in range(0, BK_OBJECTS, qd):
            for i in range(first, first + qd):
                rbd.writefull(oids[i], model[i].tobytes())
            rbd.pump()
        wall = time.perf_counter() - t0
        if clock is not None:
            clock.remove()
        enc_agg.configure(window=int(OPTIONS["ec_tpu_aggregate_window"].default))
        res = part(f"9a QD{qd}", before, a0)
        rbd.settled(f"9a QD{qd}", led)
        check(res["enc"] == BK_OBJECTS // qd,
              f"9a QD{qd}: {res['enc']} encode launches, want {BK_OBJECTS // qd}")
        out["spans"][f"9a QD{qd}"] = span_medians(res["records"])
        out[f"9a_QD{qd}_MBps"] = model.nbytes / wall / 1e6
        out[f"9a_QD{qd}_encode_latency_ms"] = statistics.median(
            rbd.listeners[0].hists["ec_encode_latency"]) * 1e3
        if clock is not None:
            out["9a_split"] = clock.shares(wall)
        print(f"[9] 9a: {BK_OBJECTS} WRITEFULLs of 4 MiB at QD{qd}: "
              f"{out[f'9a_QD{qd}_MBps']:.1f} MB/s (first submit to last commit), "
              f"{res['enc']} encode launches, ec_encode_latency median "
              f"{out[f'9a_QD{qd}_encode_latency_ms']:.3f} ms; {card}")
    print(f"[9] 9a QD{BK_QD} wall-time split: "
          + ", ".join(f"{s} {v:.3f}" for s, v in out["9a_split"].items()) + f"; {card}")

    # 9b: 256 RMW writes of 4-64 KiB, unaligned, batches of 8 with one
    # overlapping pair on one object each; the stripes served from an
    # earlier write's pin are counted (ROADMAP.md C5: a range partly pinned)
    from ceph_tpu_torch.osd.ec_backend import ECBackend
    from ceph_tpu_torch.osd.extent_cache import ExtentCache

    pins = collections.Counter()
    real_present, real_runs = ExtentCache.present, ECBackend._unpinned_runs

    def present(cache, oid, off, ln):
        got = real_present(cache, oid, off, ln)
        pins["served from a pin" if got is not None else "not pinned"] += 1
        return got

    def unpinned_runs(backend, op, off, ln):
        runs = real_runs(backend, op, off, ln)
        pins["partly pinned ranges"] += runs != [(off, ln)]
        return runs

    ExtentCache.present, ECBackend._unpinned_runs = present, unpinned_runs
    before, a0 = probe.start(), aggs0()
    tags = []
    t0 = time.perf_counter()
    for _ in range(BK_RMW_WRITES // BK_QD):
        batch = []
        for j in range(BK_QD):
            if j == 1:  # overlaps write 0 of the batch
                i, off0, ln0 = batch[0]
                ln = int(rng.integers(*BK_RMW_BYTES))
                off = max(0, min(BK_OBJECT_BYTES - ln, off0 + int(rng.integers(-ln + 1, ln0))))
            else:
                i = int(rng.integers(BK_OBJECTS))
                ln = int(rng.integers(*BK_RMW_BYTES))
                off = int(rng.integers(0, BK_OBJECT_BYTES - ln))
            if off % sw == 0:
                off += 1
            if (off + ln) % sw == 0:
                ln -= 1
            batch.append((i, off, ln))
        for i, off, ln in batch:
            patch = rng.integers(0, 256, ln, dtype=np.uint8)
            model[i, off:off + ln] = patch
            tags.append(rbd.submit(rbd.PGTransaction(oids[i]).write(off, patch.tobytes())))
        rbd.pump()
    wall = time.perf_counter() - t0
    ExtentCache.present, ECBackend._unpinned_runs = real_present, real_runs
    check(pins["served from a pin"] > 0, f"9b: no RMW read was served from a pin: {pins}")
    res = part("9b", before, a0)
    rbd.settled("9b", led)
    check(res["enc"] + res["deltas"] == BK_RMW_WRITES,
          f"9b: {res['enc']} encode and {res['deltas']} delta launches for "
          f"{BK_RMW_WRITES} writes")
    lat = sorted(rbd.latency[t] for t in tags)
    out["spans"]["9b"] = span_medians(res["records"])
    out["9b"] = {"writes_per_s": BK_RMW_WRITES / wall,
                 "p50_ms": lat[len(lat) // 2] * 1e3, "p99_ms": lat[int(len(lat) * 0.99)] * 1e3,
                 "pins": dict(pins), "delta_writes": res["deltas"]}
    print(f"[9] 9b: {BK_RMW_WRITES} RMW writes of 4-64 KiB in batches of {BK_QD}: "
          f"{out['9b']['writes_per_s']:.1f} writes/s, submit to commit p50 "
          f"{out['9b']['p50_ms']:.3f} ms p99 {out['9b']['p99_ms']:.3f} ms; RMW read ranges "
          f"{dict(pins)}; {res['deltas']} on the delta path; {card}")

    # 9c: every object read back whole, and every shard against the host oracle
    def read_all(label: str, holes: list) -> float:
        saved = list(rbd.acting)
        for h in holes:
            rbd.acting[h] = rbd.PG_NONE
        reader = rbd.backends[next(o for o in rbd.acting if o != rbd.PG_NONE)]
        t0 = time.perf_counter()
        for first in range(0, BK_OBJECTS, BK_QD):
            got = rbd.read({oids[i]: [(0, BK_OBJECT_BYTES)]
                            for i in range(first, first + BK_QD)}, reader)
            for i in range(first, first + BK_QD):
                err, bufs = got[oids[i]]
                check(err == 0 and bufs[0] == model[i].tobytes(),
                      f"{label}: object {i} read back err {err}, not the model's bytes")
        seconds = time.perf_counter() - t0
        rbd.acting[:] = saved
        return model.nbytes / seconds / 1e9

    before, a0 = probe.start(), aggs0()
    out["9c_GBps"] = read_all("9c", [])
    part("9c", before, a0, decodes=0)
    for i in range(BK_OBJECTS):
        shaped = model[i].reshape(stripes, BK_K, BK_SU)
        parity = ec.encode_array_host(shaped)
        for s in range(BK_K + BK_M):
            want = shaped[:, s] if s < BK_K else parity[:, s - BK_K]
            check(rbd.shard(s, oids[i]) == want.tobytes(),
                  f"9c: object {i} shard {s} != encode_array_host of the model")
    print(f"[9] 9c: {BK_OBJECTS} objects read whole, exact, {out['9c_GBps']:.3f} GB/s; every "
          f"shard equal to encode_array_host of the model; {card}")

    # 9d: degraded reads, each erasure class; four holes are EIO
    dec_agg.configure(window=BK_QD)
    out["9d_GBps"] = {}
    for holes in RT_CLASSES:
        before, a0 = probe.start(), aggs0()
        submits0 = int(dec_agg.perf.get("submits"))
        gbps = read_all(f"9d {holes}", holes)
        decodes = BK_OBJECTS if any(h < BK_K for h in holes) else 0
        res = part(f"9d {holes}", before, a0, decodes=decodes)
        check(int(dec_agg.perf.get("submits")) - submits0 + res["served"] == decodes,
              f"9d {holes}: {int(dec_agg.perf.get('submits')) - submits0} decode submits and "
              f"{res['served']} reads served by the cache, want {decodes}")
        out["9d_GBps"][str(holes)] = gbps
        out.setdefault("9d_cache_served", {})[str(holes)] = res["served"]
        if res["records"]:
            out["spans"][f"9d {holes}"] = span_medians(res["records"])
        print(f"[9] 9d: holes {holes}: {BK_OBJECTS} objects exact, {gbps:.3f} GB/s, "
              f"{res['dec']} decode launches ({kernel}) for {decodes} decodes, "
              f"{res['served']} served by the device chunk cache; {card}")
    dec_agg.configure(window=int(OPTIONS["ec_tpu_decode_aggregate_window"].default))
    saved = list(rbd.acting)
    for h in BK_EIO_HOLES:
        rbd.acting[h] = rbd.PG_NONE
    err, bufs = rbd.read({oids[0]: [(0, BK_OBJECT_BYTES)]}, rbd.backends[4])[oids[0]]
    rbd.acting[:] = saved
    check(err == -5 and bufs == [], f"9d: holes {BK_EIO_HOLES} read gave {err}, want -EIO")
    rbd.settled("9d", led)
    print(f"[9] 9d: holes {BK_EIO_HOLES} from osd.4: -EIO")

    # 9e: the hinfo path on pool rgw: stripe-aligned appends, crc-checked reads
    rgw = BkCluster(2, "rgw", overwrites=False)
    rgw_oids = [f"rgw.bucket.{i}" for i in range(BK_RGW_OBJECTS)]
    rgw_model = rng.integers(0, 256, (BK_RGW_OBJECTS, BK_RGW_APPENDS * BK_RGW_APPEND),
                             dtype=np.uint8)
    before, a0 = probe.start(), aggs0()
    clock = StageClock().install()
    t0 = time.perf_counter()
    for a in range(BK_RGW_APPENDS):
        for i, oid in enumerate(rgw_oids):
            off = a * BK_RGW_APPEND
            rgw.submit(rgw.PGTransaction(oid).write(off, rgw_model[i, off:off + BK_RGW_APPEND]
                                                   .tobytes()))
        rgw.pump()
    wall = time.perf_counter() - t0
    clock.remove()
    out["9e_split"] = clock.shares(wall)
    out["9e_MBps"] = rgw_model.nbytes / wall / 1e6
    for i, oid in enumerate(rgw_oids):
        blobs = {rgw.stores[s].getattr(rgw.colls[s], oid, HINFO_ATTR) for s in range(11)}
        check(len(blobs) == 1, f"9e: {oid}'s shards disagree on hinfo")
        hinfo = HashInfo.decode(blobs.pop())
        for s in range(BK_K + BK_M):
            data = rgw.shard(s, oid)
            check(hinfo.get_total_chunk_size() == len(data)
                  and hinfo.get_chunk_hash(s) == crc_mod.crc32c(data, HashInfo.SEED),
                  f"9e: {oid} shard {s}'s hinfo != the C++ crc32c of the shard")
            if i == 0:  # the table version runs at about 1 MB/s: one object's shards
                check(hinfo.get_chunk_hash(s) == crc_mod._crc32c_py(HashInfo.SEED, data),
                      f"9e: {oid} shard {s}'s hinfo != the table crc32c of the shard")
    for i in range(BK_CORRUPT):
        good = rgw.shard(0, rgw_oids[i])
        rgw.stores[0]._write(rgw.colls[0], rgw_oids[i], 4096 * i + 7,
                             bytes([good[4096 * i + 7] ^ 0x5A]))
    got = rgw.read({oid: [(0, rgw_model.shape[1])] for oid in rgw_oids[:BK_CORRUPT]})
    for i in range(BK_CORRUPT):
        err, bufs = got[rgw_oids[i]]
        check(err == 0 and bufs[0] == rgw_model[i].tobytes(),
              f"9e: corrupted object {i} read back err {err}, not the model's bytes")
    mismatches = sum("crc mismatch" in e for e in rgw.listeners[0].clog)
    check(mismatches == BK_CORRUPT, f"9e: {mismatches} crc mismatches logged, want {BK_CORRUPT}")
    res = part("9e", before, a0, decodes=BK_CORRUPT)
    rgw.settled("9e", led)
    out["spans"]["9e"] = span_medians(res["records"])
    print(f"[9] 9e: pool rgw, {BK_RGW_OBJECTS} objects of {BK_RGW_APPENDS} x 1 MiB appends, "
          f"{out['9e_MBps']:.1f} MB/s; every shard's hinfo = its crc32c (C++, and the table "
          f"version on one object); {BK_CORRUPT} corrupted shards escalated around, "
          f"{mismatches} crc mismatches logged, {res['dec']} decode launches; {card}")
    print("[9] 9e wall-time split: "
          + ", ".join(f"{s} {v:.3f}" for s, v in out["9e_split"].items()) + f"; {card}")

    check(swar.launches > 0, "phase 9 never launched swar_gf")
    out["launches"] = {"swar_gf": swar.launches, **packed.launches}
    for label, spans in out["spans"].items():
        print(f"[9] {label}: flight spans, median per launch (ms): "
              + ", ".join(f"{span} {ms:.4f}" for span, ms in spans.items()) + f"; {card}")
    out["seconds"] = time.perf_counter() - t_phase
    check(out["seconds"] < 90, f"phase 9 took {out['seconds']:.1f} s, over its 90 s")
    print(f"[9] phase 9 numbers: {json.dumps({k: v for k, v in out.items() if k != 'spans'})}")
    return out


# Phase 10's shapes and deployments.  10a: the GF(2) plane product at
# jerasure's packet sizes (the corpus's 32, test_jerasure.py's 8, the
# default 2048 and two that are not multiples of 16) and its timing shape,
# liberation k = 7, w = 7 at packetsize 2048 over 2048 super-packets.
# 10b: the Ceph documentation's example profile of each plugin, 16 RBD
# objects of 4 MiB each.  10c: phase 9's pool rbd, 64 objects of 4 MiB, and
# the five losses (one data shard, one parity, the primary's own, two, and
# three with the primary's); the recovery decodes in windows of 8 objects.
# 10d: a CLAY pool (k = 4, m = 2, d = 5) of 6 OSDs, 16 objects, shard 1 lost.
G2_PACKETS = (4, 8, 32, 2048, 2052)
G2_STRIPES = (1, 3, 256)
G2_TIMING = (7, 7, 2048, 2048)  # liberation k, w, packetsize, super-packets
PL_OBJECTS = 16
PL_PROFILES = [
    ("jerasure", {"technique": "reed_sol_van", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "2"}),
    ("jerasure", {"technique": "liberation", "k": "4", "m": "2", "w": "7",
                  "packetsize": "2048"}),
    ("isa", {"k": "8", "m": "3"}),
    ("shec", {"k": "4", "m": "3", "c": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "3"}),
    ("clay", {"k": "4", "m": "2", "d": "5"}),
    ("xor", {"k": "4"}),
]
RC_OBJECTS = 64
RC_LOSSES = ([3], [9], [0], [3, 9], [0, 5, 10])
RC_WINDOW = 8
CL_PROFILE = {"plugin": "clay", "k": "4", "m": "2", "d": "5"}
CL_OBJECTS = 16
CL_LOST = 1


def gf2_host_oracle(bm: np.ndarray, planes: np.ndarray) -> np.ndarray:
    """(S, Q, P) planes -> (S, R, P): each output packet the XOR of the
    packets its row selects (numpy)."""
    out = np.zeros((planes.shape[0], bm.shape[0], planes.shape[2]), dtype=np.uint8)
    for r in range(bm.shape[0]):
        sel = np.nonzero(bm[r])[0]
        if sel.size:
            out[:, r] = np.bitwise_xor.reduce(planes[:, sel], axis=1)
    return out


def phase_gf2_plane(torch, gf2, xor_mm, PLAN_CACHE, card) -> dict:
    """10a: gf2_plane_matmul on the card against its plain version and the
    numpy oracle, byte for byte, then timed beside its bound."""
    rng = np.random.default_rng(SEED + 100)
    mats = {
        "liberation-4-7": gf2.liberation_bitmatrix(4, 7),
        "liberation-7-7": gf2.liberation_bitmatrix(7, 7),
        "blaum_roth-4-6": gf2.blaum_roth_bitmatrix(4, 6),
        "liber8tion-4": gf2.liber8tion_bitmatrix(4),
        "liber8tion-8": gf2.liber8tion_bitmatrix(8),
    }
    for r in (1, 2):
        for er in itertools.combinations(range(6), r):
            dec, _ = PLAN_CACHE.gf2_decode_plan(mats["liberation-4-7"], 4, 7, list(er))
            mats[f"liberation-4-7-decode{list(er)}"] = dec
    cases, launches0 = 0, xor_mm.gf2_plane_matmul.launches
    for label, bm in mats.items():
        for P in G2_PACKETS:
            for S in G2_STRIPES:
                host = rng.integers(0, 256, (S, bm.shape[1], P), dtype=np.uint8)
                dev = torch.from_numpy(host).cuda()
                got = xor_mm.gf2_plane_matmul(bm, dev)
                plain = xor_mm.gf2_plane_matmul_reference(bm, dev)
                torch.cuda.synchronize()
                check(torch.equal(got, plain), f"10a {label} P={P} S={S}: kernel != plain")
                pick = [0, S - 1]
                check(np.array_equal(got[pick].cpu().numpy(), gf2_host_oracle(bm, host[pick])),
                      f"10a {label} P={P} S={S}: kernel != numpy oracle")
                cases += 1
    # a strided view: every other plane of a wider batch, a 16-byte-aligned
    # packet slice (the 16-byte path), then a 4-byte-aligned one
    bm = mats["liberation-4-7"]
    wide = torch.from_numpy(rng.integers(0, 256, (5, 2 * bm.shape[1], 2100),
                                         dtype=np.uint8)).cuda()
    for lo, hi in ((16, 2064), (4, 2056)):
        view = wide[:, ::2, lo:hi]
        got = xor_mm.gf2_plane_matmul(bm, view)
        check(torch.equal(got, xor_mm.gf2_plane_matmul_reference(bm, view)),
              f"10a strided view [:, ::2, {lo}:{hi}]: kernel != plain")
        check(np.array_equal(got.cpu().numpy(), gf2_host_oracle(bm, view.cpu().numpy())),
              f"10a strided view [:, ::2, {lo}:{hi}]: kernel != numpy oracle")
        cases += 1
    check(xor_mm.gf2_plane_matmul.launches - launches0 == cases,
          f"10a: {xor_mm.gf2_plane_matmul.launches - launches0} launches for {cases} calls")
    print(f"[10] 10a: gf2_plane_matmul exact against its plain version and the numpy oracle "
          f"on {cases} cases ({len(mats)} matrices x P {G2_PACKETS} x S {G2_STRIPES}, and "
          f"two strided views)")
    k, w, P, S = G2_TIMING
    bm = gf2.liberation_bitmatrix(k, w)
    R, Q = bm.shape
    planes = torch.from_numpy(rng.integers(0, 256, (S, Q, P), dtype=np.uint8)).cuda()
    ms = time_ms(torch, lambda: xor_mm.gf2_plane_matmul(bm, planes))
    plain_ms = time_ms(torch, lambda: xor_mm.gf2_plane_matmul_reference(bm, planes),
                       warmup=1, reps=3)
    moved = (Q + R) * S * P
    ops = int(bm.sum()) * S * P // 4
    bound_ms, bound_by = max((moved / HBM_BYTES_PER_S * 1e3, "bytes"),
                             (ops / INT32_OPS_PER_S * 1e3, "operations"))
    print(f"[10] 10a: gf2_plane_matmul (S, Q, P) = ({S}, {Q}, {P}), R = {R}, nnz = "
          f"{int(bm.sum())}: {ms:.4f} ms (median of 20 runs of {CALLS_PER_RUN} calls), "
          f"{moved / ms / 1e6:.1f} GB/s, bound {bound_ms:.4f} ms ({bound_by}: {moved} bytes, "
          f"{ops} XORs), {bound_ms / ms:.3f} of bound; plain version {plain_ms:.3f} ms; {card}")
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None, "max_abs_err": 0}


def phase_plugins(torch, swar, packed, xor_mm, registry, card) -> dict:
    """10b: every plugin's documented example profile on the card: 16
    objects of 4 MiB through encode, then every erasure set up to m that
    minimum_to_decode accepts through decode, each equal to the same call
    on device="cpu"; the kernels' launches by plugin."""
    from ceph_tpu_torch.codec import matrix_codec as mc

    rng = np.random.default_rng(SEED + 101)
    objects = [rng.integers(0, 256, BK_OBJECT_BYTES, dtype=np.uint8).tobytes()
               for _ in range(PL_OBJECTS)]
    xm_calls = collections.Counter()
    real_xor_matmul = mc.xor_matmul

    def counted_xor_matmul(bm, data):
        xm_calls["n"] += 1
        return real_xor_matmul(bm, data)

    out = {}
    swar.launches = 0
    for name in PACKED_KERNELS:
        packed.launches[name] = 0
    xor_mm.gf2_plane_matmul.launches = 0
    xor_mm.xor_reduce.launches = 0
    mc.xor_matmul = counted_xor_matmul
    try:
        for plugin, prof in PL_PROFILES:
            label = f"{plugin} " + " ".join(f"{k}={v}" for k, v in prof.items())
            before = (swar.launches, packed.launches["packed_code"], xm_calls["n"],
                      xor_mm.gf2_plane_matmul.launches, xor_mm.xor_reduce.launches)
            t0 = time.perf_counter()
            ec = registry.instance().factory(plugin, dict(prof))
            check(ec.device.type == "cuda", f"10b {label}: codec on {ec.device}")
            cpu = registry.instance().factory(plugin, dict(prof), device="cpu")
            n = ec.get_chunk_count()
            encoded = []
            for obj in objects:
                enc = ec.encode(set(range(n)), obj)
                want = cpu.encode(set(range(n)), obj)
                for i in range(n):
                    check(np.array_equal(enc[i], want[i]), f"10b {label}: shard {i} of an "
                          "object encodes differently on cuda and cpu")
                encoded.append(enc)
            patterns = []
            for r in range(1, ec.get_coding_chunk_count() + 1):
                for er in itertools.combinations(range(n), r):
                    try:
                        ec.minimum_to_decode(set(er), set(range(n)) - set(er))
                    except Exception:  # noqa: BLE001  (not decodable: skipped)
                        continue
                    patterns.append(set(er))
            for j, er in enumerate(patterns):
                enc = encoded[j % PL_OBJECTS]
                avail = {i: c for i, c in enc.items() if i not in er}
                got = ec.decode(er, dict(avail), len(enc[0]))
                want = cpu.decode(er, dict(avail), len(enc[0]))
                for e in er:
                    check(np.array_equal(got[e], want[e]) and np.array_equal(got[e], enc[e]),
                          f"10b {label}: erasures {sorted(er)} decode differently on cuda "
                          "and cpu, or not to the encoded chunk")
            torch.cuda.synchronize()
            launches = {
                "swar_gf": swar.launches - before[0],
                "packed_code": packed.launches["packed_code"] - before[1],
                "xor_matmul": xm_calls["n"] - before[2],
                "gf2_plane_matmul": xor_mm.gf2_plane_matmul.launches - before[3],
                "xor_reduce": xor_mm.xor_reduce.launches - before[4],
            }
            out[label] = {"patterns": len(patterns), "chunk": len(encoded[0][0]),
                          "seconds": time.perf_counter() - t0, "launches": launches}
            print(f"[10] 10b {label}: {PL_OBJECTS} objects of 4 MiB (chunk "
                  f"{len(encoded[0][0])}) encoded, {len(patterns)} erasure sets decoded, "
                  f"cuda = cpu byte for byte; launches {launches}; "
                  f"{out[label]['seconds']:.2f} s")
    finally:
        mc.xor_matmul = real_xor_matmul
    lib = out["jerasure technique=liberation k=4 m=2 w=7 packetsize=2048"]["launches"]
    check(lib["gf2_plane_matmul"] > 0, "10b: liberation never launched gf2_plane_matmul")
    xor_plugin = next(row for label, row in out.items() if label.startswith("xor "))
    check(xor_plugin["launches"]["xor_reduce"] > 0, "10b: plugin xor never launched xor_reduce")
    out["gf2_plane_matmul_launches"] = xor_mm.gf2_plane_matmul.launches
    out["xor_reduce_launches"] = xor_mm.xor_reduce.launches
    return out


def phase_recovery(torch, swar, packed, dispatch, registry, card) -> dict:
    """10c: recovery through ECBackend on 11 OSDs (pool rbd), five losses,
    64 objects of 4 MiB each; 10d: CLAY repair from fragments on 6 OSDs."""
    from ceph_tpu_torch.codec import matrix_codec as mc
    from ceph_tpu_torch.common.mempool import ledger
    from ceph_tpu_torch.common.options import OPTIONS
    from ceph_tpu_torch.ops.flight_recorder import flight_recorder
    from ceph_tpu_torch.ops.guard import device_guard

    t_phase = time.perf_counter()
    led, fr, guard = ledger(), flight_recorder(), device_guard()
    dec_agg = mc.default_decode_aggregator()
    probe = RuntimeProbe(torch, swar, packed, dispatch, fr, guard, led)
    rng = np.random.default_rng(SEED + 102)
    rbd = BkCluster(3, "rbd", overwrites=True)
    oids = [f"rbd_data.{i:016x}" for i in range(RC_OBJECTS)]
    model = rng.integers(0, 256, (RC_OBJECTS, BK_OBJECT_BYTES), dtype=np.uint8)
    for first in range(0, RC_OBJECTS, BK_QD):
        for i in range(first, first + BK_QD):
            rbd.writefull(oids[i], model[i].tobytes())
        rbd.pump()
    rbd.settled("10c writes", led)
    out: dict = {"losses": {}}
    chunk_bytes = BK_OBJECT_BYTES // BK_K
    dec_agg.configure(window=RC_WINDOW)
    try:
        for lost in RC_LOSSES:
            before_bytes = {}
            for oid in oids:
                for s in lost:
                    coll = rbd.colls[s]
                    before_bytes[(oid, s)] = (rbd.shard(s, oid),
                                              rbd.stores[s].getattrs(coll, oid))
                    rbd.stores[s]._remove(coll, oid)
                rbd.missing[oid] = set(lost)
            rbd.listeners[0].hists.clear()
            before, launches0 = probe.start(), int(dec_agg.perf.get("launches"))
            results = []
            t0 = time.perf_counter()
            for oid in oids:
                rbd.primary.recover_object(oid, set(lost), results.append)
            rbd.drain()
            wall = time.perf_counter() - t0
            torch.cuda.synchronize()
            delta = {key: val - before[key] for key, val in probe.counts().items()}
            dec = int(dec_agg.perf.get("launches")) - launches0
            all_records = [r for r in fr.records() if r["group"] != "#raw"]
            # at the option defaults the device chunk cache serves the
            # rebuild of objects whose chunks the writes seeded
            served = [r for r in all_records if r["group"] == "#cache"]
            records = [r for r in all_records if r["group"] != "#cache"]
            rbd.missing.clear()
            label = f"10c loss {lost}"
            check(results == [0] * RC_OBJECTS, f"{label}: callbacks {collections.Counter(results)}")
            for (oid, s), (data, attrs) in before_bytes.items():
                check(rbd.shard(s, oid) == data, f"{label}: {oid} shard {s} rebuilt wrong")
                check(rbd.stores[s].getattrs(rbd.colls[s], oid) == attrs,
                      f"{label}: {oid} shard {s}'s attrs differ after recovery")
            check(0 < dec < RC_OBJECTS, f"{label}: {dec} decode launches for {RC_OBJECTS} objects")
            check(delta["DECODE_LAUNCHES"] == dec and delta["swar_gf"] == dec,
                  f"{label}: DECODE_LAUNCHES +{delta['DECODE_LAUNCHES']}, swar_gf "
                  f"+{delta['swar_gf']} for {dec} decode launches")
            check(delta["FALLBACK_LAUNCHES"] == 0 and delta["degraded_total"] == 0
                  and not guard.degraded, f"{label}: fallback or degraded: {delta}")
            check(len(records) == dec and not any(
                r["flags"]["fallback"] or r["flags"]["error"] for r in all_records),
                f"{label}: {len(records)} clean flight records for {dec} launches")
            check(all(r["h2d_s"] == 0 and r["kernel_s"] == 0 for r in served),
                  f"{label}: a cache-served record has h2d or kernel time")
            rbd.settled(label, led)
            hist = rbd.listeners[0].hists["ec_decode_latency"]
            row = {
                "logical_MBps": model.nbytes / wall / 1e6,
                "rebuilt_MBps": RC_OBJECTS * len(lost) * chunk_bytes / wall / 1e6,
                "decode_latency_ms": statistics.median(hist) * 1e3,
                "decode_launches": dec,
                "cache_served": len(served),
                "seconds": wall,
                "spans": span_medians(records),
            }
            out["losses"][str(lost)] = row
            print(f"[10] {label}: {RC_OBJECTS} objects recovered exact, attrs too, every "
                  f"callback 0; {row['logical_MBps']:.1f} MB/s logical, "
                  f"{row['rebuilt_MBps']:.1f} MB/s of rebuilt shards (first recover_object to "
                  f"last callback, {wall:.3f} s); ec_decode_latency median "
                  f"{row['decode_latency_ms']:.3f} ms; {dec} decode launches (swar_gf), "
                  f"{len(served)} rebuilds served by the device chunk cache; flight "
                  "spans median per launch (ms): "
                  + ", ".join(f"{k} {v:.4f}" for k, v in row["spans"].items()) + f"; {card}")
    finally:
        dec_agg.configure(window=int(OPTIONS["ec_tpu_decode_aggregate_window"].default))

    # 10d: CLAY repair from fragments
    clay = BkCluster(4, "clay", overwrites=False, profile=CL_PROFILE)
    ec = clay.primary.ec
    check(ec.device.type == "cuda" and ec.get_sub_chunk_count() == 8,
          f"10d: the clay codec is on {ec.device} with {ec.get_sub_chunk_count()} sub-chunks")
    cl_oids = [f"clay.{i}" for i in range(CL_OBJECTS)]
    cl_model = rng.integers(0, 256, (CL_OBJECTS, BK_OBJECT_BYTES), dtype=np.uint8)
    t0 = time.perf_counter()
    for first in range(0, CL_OBJECTS, BK_QD):
        for i in range(first, min(first + BK_QD, CL_OBJECTS)):
            clay.writefull(cl_oids[i], cl_model[i].tobytes())
        clay.pump()
    write_s = time.perf_counter() - t0
    clay.settled("10d writes", led)
    before = {oid: clay.shard(CL_LOST, oid) for oid in cl_oids}
    for oid in cl_oids:
        clay.stores[CL_LOST]._remove(clay.colls[CL_LOST], oid)
        clay.missing[oid] = {CL_LOST}
    helper_bytes = collections.Counter()
    primary = clay.primary
    real_reply = primary.handle_sub_read_reply

    def counted_reply(msg):
        for oid, exts in msg.buffers.items():
            helper_bytes[oid] += sum(len(data) for _off, data in exts)
        return real_reply(msg)

    primary.handle_sub_read_reply = counted_reply
    results = []
    t0 = time.perf_counter()
    try:
        for oid in cl_oids:
            primary.recover_object(oid, {CL_LOST}, results.append)
        clay.drain()
    finally:
        del primary.handle_sub_read_reply
    repair_s = time.perf_counter() - t0
    clay.missing.clear()
    check(results == [0] * CL_OBJECTS, f"10d: callbacks {results}")
    for oid in cl_oids:
        check(clay.shard(CL_LOST, oid) == before[oid], f"10d: {oid} shard {CL_LOST} rebuilt wrong")
    clay.settled("10d", led)
    chunk = len(before[cl_oids[0]])
    chunks_read = [helper_bytes[oid] / chunk for oid in cl_oids]
    check(max(chunks_read) < 4, f"10d: repairs read {max(chunks_read):.3f} chunks an object, "
          "not under 4 (the fragment path did not run)")
    out["clay"] = {"chunks_read": max(chunks_read), "write_s": write_s, "repair_s": repair_s,
                   "repair_MBps": cl_model.nbytes / repair_s / 1e6}
    print(f"[10] 10d: clay k=4 m=2 d=5, {CL_OBJECTS} objects of 4 MiB written in {write_s:.2f} "
          f"s; shard {CL_LOST} lost and repaired exact from fragments, "
          f"{max(chunks_read):.3f} chunks read from helpers an object (k = 4 whole chunks "
          f"without the repair plan), {repair_s:.3f} s, {out['clay']['repair_MBps']:.1f} MB/s "
          f"logical; {card}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[10] phase 10c-d numbers: "
          f"{json.dumps({k: v for k, v in out.items() if k != 'losses'})}")
    return out


# Phase 11's deployments, on phase 9's harness (RS(8,3) reed_sol_van,
# stripe_unit 4096, 11 OSDs, option defaults: the device chunk cache at 32
# MiB and the RMW delta path on).  11a: deep scrub of 100 objects of 4 MiB,
# 4 scrub chunks of CHUNK_MAX = 25, on the append-only pool (the parity
# verify runs on chunks whose hinfo digests travel in the scrub map, and a
# pool with allow_ec_overwrites keeps no hinfo).  11b: RBD small writes on
# a hot image region (a database's or a journal's hot blocks): 4 objects of
# 4 MiB on pool rbd, 256 overwrites of 4-64 KiB inside a 64 KiB region of
# each, at QD1, with the delta path and again without it.  11c: phase 9d's
# hole classes, each read twice from an empty cache.  11d: the drills.
SC_OBJECTS = 100
HOT_OBJECTS = 4
HOT_WRITES = 256
HOT_REGION = 64 << 10
HOT_BYTES = (4 << 10, 64 << 10)


class ScrubCluster(BkCluster):
    """BkCluster with a PG-shaped scrub host on every OSD: exactly the
    attributes osd/scrubber.py's PgScrubber reads.  The scrub messages ride
    the cluster's queue; `request_recovery` runs the backend's
    recover_object for the shards repair marked missing."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        from types import SimpleNamespace

        from ceph_tpu_torch.osd.scrubber import PgScrubber

        cluster = self

        class Host:
            def __init__(self, osd):
                self.osd_id, self.pgid = osd, cluster.pgid
                self.osd = SimpleNamespace(store=cluster.stores[osd])
                self.backend, self.pool = cluster.backends[osd], cluster.pool
                self.peering = SimpleNamespace(osds_missing=lambda oid: {
                    cluster.acting[s] for s in cluster.missing.get(oid, ())})
                self.clog, self.recoveries = [], []
                self.scrubber = PgScrubber(self)

            def whoami(self):
                return self.osd_id

            def whoami_shard(self):
                return self.osd_id

            def epoch(self):
                return 1

            def acting(self):
                return cluster.acting

            def send_scrub(self, osd, msg):
                cluster.queue.append((osd, msg))

            send_scrub_reply = send_scrub

            def clog_error(self, text):
                self.clog.append(text)

            def mark_shard_missing(self, oid, osd):
                cluster.missing.setdefault(oid, set()).add(cluster.acting.index(osd))

            def request_recovery(self, oid):
                def done(err):
                    self.recoveries.append((oid, err))
                    if err == 0:
                        cluster.missing.pop(oid, None)

                self.backend.recover_object(oid, set(cluster.missing.get(oid, ())), done)

        self.hosts = [Host(osd) for osd in range(len(self.backends))]

    def pump(self) -> None:
        from ceph_tpu_torch.msg.messages import MOSDRepScrub

        while True:
            for b in self.backends:
                b.flush_encodes()
            if not self.queue:
                return
            osd, msg = self.queue.pop(0)
            if osd == self.PG_NONE or self.backends[osd].handle_message(msg):
                continue
            scrubber = self.hosts[osd].scrubber
            if isinstance(msg, MOSDRepScrub):
                scrubber.handle_rep_scrub(msg)
            else:
                scrubber.handle_scrub_map(msg)

    def scrub(self, repair: bool = False):
        out: list = []
        check(self.hosts[0].scrubber.start(deep=True, repair=repair, on_done=out.append),
              "a scrub is already running")
        self.pump()
        check(len(out) == 1, "the deep scrub did not finish")
        return out[0]


def phase_scrub_cache(torch, swar, packed, dispatch, card) -> dict:
    """Phase 11: deep scrub through PgScrubber on packed_verify (11a), the
    RMW delta path on packed_delta (11b), cache-served degraded reads (11c)
    and the drills (11d), through the port's ECBackend at option defaults.
    Launch counts are set to 0 just before and read just after."""
    from ceph_tpu_torch.codec import matrix_codec as mc
    from ceph_tpu_torch.common.fault_injector import global_injector
    from ceph_tpu_torch.common.mempool import ledger
    from ceph_tpu_torch.common.options import OPTIONS
    from ceph_tpu_torch.ops.device_cache import device_chunk_cache
    from ceph_tpu_torch.ops.flight_recorder import flight_recorder
    from ceph_tpu_torch.ops.guard import device_guard
    from ceph_tpu_torch.osd import ec_backend
    from ceph_tpu_torch.osd.ec_transaction import HINFO_ATTR
    from ceph_tpu_torch.stripe.hashinfo import HashInfo
    from ceph_tpu_torch.utils.crc32c import crc32c

    t_phase = time.perf_counter()
    led, fr, guard, cache = ledger(), flight_recorder(), device_guard(), device_chunk_cache()
    enc_agg, dec_agg = mc.default_encode_aggregator(), mc.default_decode_aggregator()
    probe = RuntimeProbe(torch, swar, packed, dispatch, fr, guard, led)
    check(cache.max_bytes == int(OPTIONS["ec_tpu_device_cache_bytes"].default)
          and ec_backend.rmw_delta_enabled() == bool(OPTIONS["ec_tpu_rmw_delta"].default),
          "phase 11 runs at the option defaults of the cache and the delta path")
    rng = np.random.default_rng(SEED + 110)
    out: dict = {"spans": {}}
    swar.launches = 0
    for name in PACKED_KERNELS:
        packed.launches[name] = 0

    def moved(before: dict) -> dict:
        torch.cuda.synchronize()
        return {key: val - before[key] for key, val in probe.counts().items()}

    # 11a: deep scrub, 4 chunks of 25 objects, one packed_verify launch each
    sc = ScrubCluster(5, "rgw", overwrites=False)
    ec = sc.primary.ec
    sc_oids = [f"rgw.scrub.{i:03d}" for i in range(SC_OBJECTS)]
    sc_model = rng.integers(0, 256, (SC_OBJECTS, BK_OBJECT_BYTES), dtype=np.uint8)
    for first in range(0, SC_OBJECTS, BK_QD):
        for i in range(first, min(first + BK_QD, SC_OBJECTS)):
            sc.writefull(sc_oids[i], sc_model[i].tobytes())
        sc.pump()
    sc.settled("11a writes", led)
    vagg = sc.primary.verify_aggregator
    submitted: list = []
    real_submit = vagg.submit

    def submit(ec_, codewords):
        ticket = real_submit(ec_, codewords)
        submitted.append((codewords, ticket))
        return ticket

    vagg.submit = submit
    chunks = -(-SC_OBJECTS // 25)
    codeword_bytes = SC_OBJECTS * (BK_K + BK_M) * (BK_OBJECT_BYTES // BK_K)

    def deep_scrub(label: str, repair: bool = False):
        submitted.clear()
        before, v0 = probe.start(), int(vagg.perf.get("launches"))
        t0 = time.perf_counter()
        res = sc.scrub(repair)
        wall = time.perf_counter() - t0
        delta = moved(before)
        launches = int(vagg.perf.get("launches")) - v0
        check(launches == chunks and delta["VERIFY_LAUNCHES"] == chunks
              and delta["packed_verify"] == chunks,
              f"{label}: {launches} verify launches, VERIFY_LAUNCHES +{delta['VERIFY_LAUNCHES']}, "
              f"packed_verify +{delta['packed_verify']}, want {chunks}")
        check([tuple(cw.shape) for cw, _t in submitted] == [SCRUB_SHAPE] * chunks,
              f"{label}: scrub chunks {[tuple(cw.shape) for cw, _t in submitted]}")
        t_oracle = time.perf_counter()
        with ThreadPoolExecutor(len(submitted)) as pool:  # numpy's XORs release the GIL
            oracle = list(pool.map(ec.verify_array_host, [cw for cw, _t in submitted]))
        for (_cw, ticket), want in zip(submitted, oracle):
            check(np.array_equal(np.asarray(ticket), want),
                  f"{label}: a scrub chunk's bitmap != verify_array_host")
        oracle_s = time.perf_counter() - t_oracle
        records = [r for r in fr.records() if r["kind"] == "verify"]
        check(len(records) == chunks and not any(
            r["flags"]["error"] or r["flags"]["fallback"] for r in records),
            f"{label}: {len(records)} clean verify records for {chunks} launches")
        check(delta["FALLBACK_LAUNCHES"] == 0 and not guard.degraded,
              f"{label}: fallback or degraded")
        return res, wall, records, oracle_s

    # one shard's bytes flipped (the digest catches it, repair rebuilds it),
    # one data shard corrupted with its hinfo rewritten to match (only the
    # parity verify sees it: unrepairable), both in one repair scrub
    flip, forged = sc_oids[7], sc_oids[SC_OBJECTS * 3 // 5]
    coll2, coll1 = sc.colls[2], sc.colls[1]
    good2 = sc.shard(2, flip)
    sc.stores[2]._write(coll2, flip, 4099, bytes([good2[4099] ^ 0x5A]))
    good1, hinfo1 = sc.shard(1, forged), sc.stores[1].getattr(coll1, forged, HINFO_ATTR)
    sc.stores[1]._write(coll1, forged, 77, bytes([good1[77] ^ 0x01]))
    hinfo = HashInfo.decode(hinfo1)
    hinfo.cumulative_shard_hashes[1] = crc32c(sc.shard(1, forged), HashInfo.SEED)
    sc.stores[1]._setattr(coll1, forged, HINFO_ATTR, hinfo.encode())
    res = deep_scrub("11a repair", repair=True)[0]
    parity_osds = {sc.acting[s] for s in range(BK_K, BK_K + BK_M)}
    check(res.inconsistent.get(flip) == {2: "data digest mismatch vs hinfo"},
          f"11a: flipped shard reported as {res.inconsistent.get(flip)}")
    check(res.unrepairable == {forged} and res.inconsistent.get(forged)
          and set(res.inconsistent[forged]) <= parity_osds,
          f"11a: forged shard: unrepairable {res.unrepairable}, "
          f"{res.inconsistent.get(forged)}")
    check(res.repaired == 1 and sc.hosts[0].recoveries == [(flip, 0)]
          and sc.shard(2, flip) == good2, f"11a: repair gave {res.repaired}, "
          f"{sc.hosts[0].recoveries}, shard rebuilt {sc.shard(2, flip) == good2}")
    check(any("refusing auto-repair" in e for e in sc.hosts[0].clog),
          "11a: repair did not refuse the unrepairable object")
    print(f"[11] 11a: a flipped byte in shard 2 caught by its digest and repaired through "
          f"recover_object; a forged shard (hinfo rewritten to match) caught only by the "
          f"parity verify on osds {sorted(res.inconsistent[forged])}, unrepairable and refused")
    # the forged shard restored by hand, the rescrub is clean: the timed scrub
    sc.stores[1]._write(coll1, forged, 0, good1)
    sc.stores[1]._setattr(coll1, forged, HINFO_ATTR, hinfo1)
    res, wall, records, oracle_s = deep_scrub("11a rescrub")
    check(res.clean and res.objects_scrubbed == SC_OBJECTS and not res.unrepairable,
          f"11a: rescrub gave {res}")
    out["11a_GBps"] = codeword_bytes / wall / 1e9
    out["11a_seconds"] = wall
    out["spans"]["11a verify"] = span_medians(records)
    print(f"[11] 11a: clean rescrub of {SC_OBJECTS} objects of 4 MiB in {chunks} chunks, one "
          f"packed_verify launch of {SCRUB_SHAPE} each, every bitmap of both scrubs = "
          f"verify_array_host (host oracle {oracle_s:.2f} s, outside the scrub's time); "
          f"{out['11a_GBps']:.3f} GB/s of codewords verified ({wall:.3f} s, scrub maps with "
          f"base64 chunk bytes included); {card}")

    # 11b: the RMW delta path on a hot image region, with and without it
    sw = BK_K * BK_SU
    hot = [f"rbd_data.hot.{i:016x}" for i in range(HOT_OBJECTS)]
    hot_model0 = rng.integers(0, 256, (HOT_OBJECTS, BK_OBJECT_BYTES), dtype=np.uint8)
    region = [int(rng.integers(0, (BK_OBJECT_BYTES - HOT_REGION) // sw)) * sw
              for _ in hot]
    writes = []
    for _ in range(HOT_WRITES):
        i = int(rng.integers(HOT_OBJECTS))
        ln = int(rng.integers(HOT_BYTES[0], HOT_BYTES[1] + 1))
        off = region[i] + int(rng.integers(0, HOT_REGION - ln + 1))
        writes.append((i, off, rng.integers(0, 256, ln, dtype=np.uint8)))
    out["11b"] = {}
    clusters = {}
    try:
        for mode, pool_id in (("delta", 6), ("materialize", 7)):
            ec_backend.configure_rmw_delta(mode == "delta")
            cache.clear()
            c = clusters[mode] = BkCluster(pool_id, "rbd", overwrites=True)
            model = hot_model0.copy()
            for i, oid in enumerate(hot):
                c.writefull(oid, model[i].tobytes())
            c.pump()
            c.settled(f"11b {mode} writes", led)
            resident = cache.perf_dump()["resident_bytes"]
            if mode == "delta":
                check(resident == HOT_OBJECTS * (BK_K + BK_M) * (BK_OBJECT_BYTES // BK_K),
                      f"11b: {resident} bytes resident after seeding the hot objects")
            before, a0 = probe.start(), int(enc_agg.perf.get("launches"))
            updates0 = cache.delta_updates
            tags = []
            t0 = time.perf_counter()
            for i, off, patch in writes:
                model[i, off:off + len(patch)] = patch
                tags.append(c.submit(c.PGTransaction(hot[i]).write(off, patch.tobytes())))
                c.pump()
            wall = time.perf_counter() - t0
            delta = moved(before)
            c.settled(f"11b {mode}", led)
            enc = int(enc_agg.perf.get("launches")) - a0
            deltas = [r for r in fr.records() if r["group"] == "#delta"]
            check(enc + len(deltas) == HOT_WRITES,
                  f"11b {mode}: {enc} materialize and {len(deltas)} delta launches for "
                  f"{HOT_WRITES} writes")
            check(delta["packed_delta"] == len(deltas)
                  and cache.delta_updates - updates0 == BK_M * len(deltas)
                  and delta["swar_gf"] == enc,
                  f"11b {mode}: packed_delta +{delta['packed_delta']}, swar_gf "
                  f"+{delta['swar_gf']}, delta updates +{cache.delta_updates - updates0} for "
                  f"{len(deltas)} delta and {enc} materialize launches")
            check(all(r["h2d_s"] == 0 and r["d2h_s"] == 0 and r["flags"]["delta"]
                      and r["flags"]["cache_hit"] and not r["flags"]["error"] for r in deltas),
                  f"11b {mode}: a delta record has h2d or d2h time, or an error")
            check((len(deltas) > 0) == (mode == "delta"),
                  f"11b {mode}: {len(deltas)} writes took the delta path")
            got = c.read({oid: [(0, BK_OBJECT_BYTES)] for oid in hot})
            for i, oid in enumerate(hot):
                check(got[oid] == (0, [model[i].tobytes()]),
                      f"11b {mode}: {oid} read back != the model")
                shaped = model[i].reshape(BK_OBJECT_BYTES // sw, BK_K, BK_SU)
                parity = ec.encode_array_host(shaped)
                for s in range(BK_K + BK_M):
                    want = shaped[:, s] if s < BK_K else parity[:, s - BK_K]
                    check(c.shard(s, oid) == want.tobytes(),
                          f"11b {mode}: {oid} shard {s} != encode_array_host of the model")
            lat = sorted(c.latency[t] for t in tags)
            row = out["11b"][mode] = {
                "writes_per_s": HOT_WRITES / wall, "p50_ms": lat[len(lat) // 2] * 1e3,
                "p99_ms": lat[int(len(lat) * 0.99)] * 1e3, "delta_writes": len(deltas),
                "materialize_writes": enc}
            if deltas:
                out["spans"]["11b delta"] = span_medians(deltas)
            print(f"[11] 11b {mode}: {HOT_WRITES} overwrites of 4-64 KiB in a 64 KiB hot "
                  f"region of {HOT_OBJECTS} objects at QD1: {row['writes_per_s']:.1f} writes/s, "
                  f"p50 {row['p50_ms']:.3f} ms, p99 {row['p99_ms']:.3f} ms; {len(deltas)} on "
                  f"the delta path (packed_delta, h2d 0 and d2h 0 on every record), {enc} "
                  f"materialized; every byte read back and every shard = encode_array_host; "
                  f"{card}")
            if mode == "delta":
                hot_model = model
    finally:
        ec_backend.configure_rmw_delta(bool(OPTIONS["ec_tpu_rmw_delta"].default))
    c = clusters["delta"]

    # 11c: phase 9d's hole classes on the hot objects, each read twice from
    # an empty cache: the first read decodes and caches the rebuilt rows,
    # the second is served by one D2H an object, with no decode launch
    out["11c"] = {}
    for holes in RT_CLASSES:
        cache.clear()
        saved = list(c.acting)
        for h in holes:
            c.acting[h] = c.PG_NONE
        reader = c.backends[next(o for o in c.acting if o != c.PG_NONE)]
        data_holes = [h for h in holes if h < BK_K]
        rounds = []
        for rnd in range(2):
            before, d0, h0 = probe.start(), int(dec_agg.perf.get("launches")), cache.hits
            t0 = time.perf_counter()
            got = c.read({oid: [(0, BK_OBJECT_BYTES)] for oid in hot}, reader)
            seconds = time.perf_counter() - t0
            delta = moved(before)
            dec = int(dec_agg.perf.get("launches")) - d0
            served = [r for r in fr.records() if r["group"] == "#cache"]
            for i, oid in enumerate(hot):
                check(got[oid] == (0, [hot_model[i].tobytes()]),
                      f"11c {holes} read {rnd}: {oid} != the model")
            if not data_holes:
                ok = dec == 0 and not served
            elif rnd == 0:
                ok = dec > 0 and not served and delta["swar_gf"] == dec
            else:
                ok = (dec == 0 and delta["DECODE_LAUNCHES"] == 0 and delta["swar_gf"] == 0
                      and len(served) == HOT_OBJECTS
                      and cache.hits - h0 == HOT_OBJECTS * len(data_holes)
                      and all(r["h2d_s"] == 0 and r["kernel_s"] == 0 and r["d2h_s"] > 0
                              for r in served))
            check(ok, f"11c {holes} read {rnd}: {dec} decode launches, {len(served)} "
                      f"cache-served records, {cache.hits - h0} hits")
            rounds.append({"GBps": HOT_OBJECTS * BK_OBJECT_BYTES / seconds / 1e9,
                           "decode_launches": dec, "served": len(served),
                           "hits": cache.hits - h0})
            if served:
                out["spans"][f"11c {holes}"] = span_medians(served)
        c.acting[:] = saved
        out["11c"][str(holes)] = rounds
        print(f"[11] 11c: holes {holes}: {HOT_OBJECTS} objects read twice, exact; first "
              f"{rounds[0]['GBps']:.3f} GB/s ({rounds[0]['decode_launches']} decode launches), "
              f"second {rounds[1]['GBps']:.3f} GB/s ({rounds[1]['decode_launches']} decode "
              f"launches, {rounds[1]['served']} served by the cache, {rounds[1]['hits']} "
              f"hits); {card}")
    c.settled("11c", led)

    # 11d: the drills.  (1) `codec.launch` armed on a delta dispatch: the
    # write fails with EIO, the backend goes DEGRADED, the cache is empty,
    # nothing is re-encoded; the probe heals and the next write materializes
    oid, start = hot[0], region[0]
    cache.clear()
    for ln in (HOT_REGION, 4096):  # a materialize that seeds, then a delta on it
        patch = rng.integers(0, 256, ln, dtype=np.uint8)
        hot_model[0, start:start + ln] = patch
        c.submit(c.PGTransaction(oid).write(start, patch.tobytes()))
        c.pump()
    check(any(r["group"] == "#delta" for r in fr.records()[-3:]),
          "11d: the drill's second write did not take the delta path")
    c.settled("11d setup", led)
    shards_before = [c.shard(s, oid) for s in range(BK_K + BK_M)]
    before, a0 = probe.start(), int(enc_agg.perf.get("launches"))
    global_injector().inject("codec.launch", 5, hits=1)
    try:
        c.submit(c.PGTransaction(oid).write(start + 100, b"\x5a" * 300))
        c.pump()
    finally:
        global_injector().clear()
    delta = moved(before)
    failed = [r for r in fr.records() if r["group"] == "#delta"]
    check(c.failures == [(c.submitted, -5)], f"11d: the failed delta gave {c.failures}")
    check(guard.degraded and cache.perf_dump()["entries"] == 0
          and led.current_bytes("device_cache") == 0,
          f"11d: degraded {guard.degraded}, cache {cache.perf_dump()}")
    check(int(enc_agg.perf.get("launches")) == a0 and delta["packed_delta"] == 0
          and delta["swar_gf"] == 0 and len(failed) == 1 and failed[0]["flags"]["error"],
          f"11d: after the failed delta: {delta}, {len(failed)} delta records")
    check([c.shard(s, oid) for s in range(BK_K + BK_M)] == shards_before,
          "11d: a shard changed under the failed write")
    check(guard.maybe_probe() and not guard.degraded, "11d: the cuda probe did not heal")
    c.failed_ok.add(c.submitted)
    a0 = int(enc_agg.perf.get("launches"))
    patch = rng.integers(0, 256, 4096, dtype=np.uint8)
    hot_model[0, start:start + 4096] = patch
    c.submit(c.PGTransaction(oid).write(start, patch.tobytes()))
    c.pump()
    check(int(enc_agg.perf.get("launches")) == a0 + 1, "11d: the write after the heal "
          "did not materialize")
    got = c.read({oid: [(0, BK_OBJECT_BYTES)]})
    check(got[oid] == (0, [hot_model[0].tobytes()]), "11d: read back after the drill != model")
    c.settled("11d delta drill", led)
    print("[11] 11d: codec.launch on a delta dispatch: EIO, DEGRADED, cache and its ledger "
          "bytes 0, nothing re-encoded, shards untouched; the cuda probe healed and the next "
          "write materialized")
    # (2) a failed verify launch aborts the deep scrub
    global_injector().inject("codec.launch", 5, hits=1)
    try:
        submitted.clear()
        res = sc.scrub()
    finally:
        global_injector().clear()
        del vagg.submit
    check(res.aborted and not res.clean
          and any("parity verify reap failed" in e for e in sc.hosts[0].clog),
          f"11d: failed verify gave {res}")
    check(guard.degraded and guard.maybe_probe() and not guard.degraded,
          "11d: the failed verify did not degrade, or the probe did not heal")
    held = {pool: led.current_bytes(pool) for pool in RT_INFLIGHT_POOLS}
    check(not any(held.values()), f"11d: in-flight pools after the aborted scrub: {held}")
    print(f"[11] 11d: codec.launch on a verify launch: the deep scrub aborted after "
          f"{res.objects_scrubbed} objects, never clean; the probe healed")
    # (3) mempool pressure: stage 1 trims the cache and the ledger bytes fall
    for i, oid in enumerate(hot):
        c.writefull(oid, hot_model[i].tobytes())
    c.pump()
    c.settled("11d pressure writes", led)
    cached0, total0 = led.current_bytes("device_cache"), led.total_device_bytes()
    trimmed0 = led.pressure_status()["actions"]["cache_trimmed_bytes"]
    try:
        led.configure(target_bytes=total0)
        status = led.check_pressure()
    finally:
        led.configure(target_bytes=int(OPTIONS["ec_tpu_hbm_target_bytes"].default))
        led.check_pressure()
    trimmed = status["actions"]["cache_trimmed_bytes"] - trimmed0
    cached1 = led.current_bytes("device_cache")
    check(cached0 > 0 and status["stage"] >= 1 and trimmed > 0
          and cached1 == cached0 - trimmed == cache.perf_dump()["resident_bytes"],
          f"11d: pressure at target {total0}: stage {status['stage']}, trimmed {trimmed}, "
          f"device_cache {cached0} -> {cached1}")
    print(f"[11] 11d: pressure (target = the {total0} tracked bytes): stage "
          f"{status['stage']}, the cache trimmed {trimmed} bytes, ledger device_cache "
          f"{cached0} -> {cached1}")

    out["launches"] = {"swar_gf": swar.launches, **packed.launches}
    check(packed.launches["packed_verify"] > 0 and packed.launches["packed_delta"] > 0,
          f"phase 11 launches {out['launches']}")
    out["cache"] = cache.perf_dump()
    for label, spans in out["spans"].items():
        print(f"[11] {label}: flight spans, median per launch (ms): "
              + ", ".join(f"{span} {ms:.4f}" for span, ms in spans.items()) + f"; {card}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[11] phase 11 numbers: {json.dumps({k: v for k, v in out.items() if k != 'spans'})}")
    check(out["seconds"] < 60, f"phase 11 took {out['seconds']:.1f} s, over its 60 s")
    return out


# Phase 12's shapes and deployments.  12a: crc32c at the lengths BlueStore's
# stored forms take (a raw block, compressed forms of any length, ragged
# tails) and 1 to 11264 rows, checked against the host oracle up to
# CRC_ORACLE_BYTES of rows and against the plain version (whose bit planes
# take 32 bytes a row byte) up to CRC_PLAIN_BYTES, which takes in 12c's QD8
# window; the transform at the CPU tests' padded lengths and 65536;
# xor_reduce at phase 3's single-erasure decode and the plugins' k.  12b:
# the bulk shapes and the path's, each kernel's output again held against
# its plain version: a 4 MiB object's shard write is 128 blocks of 4096
# (one store launch), and 8 objects of 11 shards (12c's QD8 window) 11264.
# 12c-12e: phase 9's pool rbd (RS(8,3), stripe unit 4096, 11 OSDs) over
# in-memory BlueStores, 64 objects of 4 MiB.
CRC_LENGTHS = (1, 3, 63, 64, 100, 4095, 4096, 4097, 65536)
CRC_STRIPES = (1, 7, 128, 1408, 11264)
CRC_ORACLE_BYTES = 64 << 20
CRC_PLAIN_BYTES = 48 << 20
XFORM_LPS = (64, 128, 192, 4032, 4096, 4160, 65536, 8192, 262144)
XFORM_STRIPES = (1, 7, 128, 1408)
XFORM_MAX_BYTES = 96 << 20  # rows of a checked transform shape
CRC_PATTERN_LENGTHS = (4096, 4097, 65536)
CRC_PATTERN_STRIPES = (128, 1408)
XOR_KS = (1, 2, 8, 11)
CRC_BULK = (65536, 4096)
CRC_PATH = ((11264, 4096), (128, 4096))
XFORM_BULK = (65536, 4096)
XFORM_PATH = ((128, 4096),)
XFORM_GENERAL = (65536, 4160)  # the general path (Lp % 4096 != 0), timed
XOR_BULK = BULK
XOR_PATH = ((1, 8, 524288),)
BS_OBJECTS = 64
BS_QD = 8
BS_RATIO = 0.875  # Ceph's default bluestore_compression_required_ratio
BS_DRILL_BYTES = 1 << 20


def crc_patterns(rng, S: int, L: int):
    """(name, (S, L) uint8 rows) of the data patterns that make table reads
    broadcast: zero-heavy (7 bytes of 8 zero, every 4th row all zero), all
    zero, and one constant byte."""
    heavy = rng.integers(0, 256, (S, L), dtype=np.uint8)
    heavy[rng.random((S, L)) < 0.875] = 0
    heavy[::4] = 0
    return (("zero-heavy", heavy), ("zeros", np.zeros((S, L), np.uint8)),
            ("constant 0x5a", np.full((S, L), 0x5A, np.uint8)))


def bluestore_kernel_checks(torch, co, dev, xor_mm) -> dict:
    """12a: each kernel against its plain version and its host oracle, byte
    for byte; returns the largest difference of each (0 when exact)."""
    rng = np.random.default_rng(SEED + 120)
    cuda = torch.device("cuda")
    err = {"crc32c": 0, "compress_transform": 0, "xor_reduce": 0}
    cases = 0
    for L in CRC_LENGTHS:
        for S in CRC_STRIPES:
            if S * L > CRC_ORACLE_BYTES:
                continue
            host = rng.integers(0, 256, (S, L + 5), dtype=np.uint8)
            rows = torch.from_numpy(host).to(cuda)
            for label, view, hview in (("dense", rows[:, :L].contiguous(), host[:, :L]),
                                       ("strided+3", rows[:, 3:L + 3], host[:, 3:L + 3])):
                got = co.crc32c_device(view).cpu().numpy()
                want = co.crc32c_host_rows(hview).astype(np.int64)
                err["crc32c"] = max(err["crc32c"], int(np.abs(got - want).max()))
                check(np.array_equal(got, want), f"12a crc32c ({S}, {L}) {label} != crc32c")
                if S * L <= CRC_PLAIN_BYTES:
                    plain = co.crc32c_plain(view).cpu().numpy()
                    err["crc32c"] = max(err["crc32c"], int(np.abs(got - plain).max()))
                    check(np.array_equal(got, plain), f"12a crc32c ({S}, {L}) {label} != plain")
                cases += 1
    # the data patterns whose table reads broadcast (all lanes at one entry)
    for L in CRC_PATTERN_LENGTHS:
        for S in CRC_PATTERN_STRIPES:
            if S * L > CRC_ORACLE_BYTES:
                continue
            for pattern, host in crc_patterns(rng, S, L + 5):
                rows = torch.from_numpy(host).to(cuda)
                for label, view, hview in (("dense", rows[:, :L].contiguous(), host[:, :L]),
                                           ("strided+3", rows[:, 3:L + 3], host[:, 3:L + 3])):
                    got = co.crc32c_device(view).cpu().numpy()
                    want = co.crc32c_host_rows(hview).astype(np.int64)
                    err["crc32c"] = max(err["crc32c"], int(np.abs(got - want).max()))
                    check(np.array_equal(got, want),
                          f"12a crc32c ({S}, {L}) {pattern} {label} != crc32c")
                    if S * L <= CRC_PLAIN_BYTES:
                        plain = co.crc32c_plain(view).cpu().numpy()
                        err["crc32c"] = max(err["crc32c"], int(np.abs(got - plain).max()))
                        check(np.array_equal(got, plain),
                              f"12a crc32c ({S}, {L}) {pattern} {label} != plain")
                    cases += 1
    # the C entry chooses the transform's path by Lp alone: tiles exactly
    # where Lp % 4096 == 0
    lib = dev.build_library()
    for Lp in (64 * 4097, 4096 * 3, 1 << 29):
        check(lib.compress_transform_path(Lp) == (Lp % 4096 == 0),
              f"12a transform path of Lp {Lp}: the C entry says {lib.compress_transform_path(Lp)}")
    for Lp in XFORM_LPS:
        want_path = "tiles" if Lp % 4096 == 0 else "general"
        for S in XFORM_STRIPES:
            if S * Lp > XFORM_MAX_BYTES:
                continue
            host = rng.integers(0, 256, (S, Lp + 64), dtype=np.uint8)
            host[:, (np.arange(Lp + 64) % 64) >= 20] = 0  # zero planes: flags vary
            host[::4] = 0
            rows = torch.from_numpy(host).to(cuda)
            for label, view, hview in (("dense", rows[:, :Lp].contiguous(), host[:, :Lp]),
                                       ("strided+1", rows[:, 1:Lp + 1], host[:, 1:Lp + 1])):
                paths = dict(dev.transform_rows_device.path_launches)
                got = dev.transform_rows_device(view)
                check(dev.transform_rows_device.path_launches[want_path]
                      == paths[want_path] + 1, f"12a transform ({S}, {Lp}) {label}: "
                      f"not one launch on the {want_path} path")
                want = dev.transform_rows(np.ascontiguousarray(hview))
                plain = dev.transform_rows_plain(view)
                for other, name in ((torch.from_numpy(want).to(cuda), "transform_rows"),
                                    (plain, "plain")):
                    diff = int((got.int() - other.int()).abs().max())
                    err["compress_transform"] = max(err["compress_transform"], diff)
                    check(diff == 0, f"12a transform ({S}, {Lp}) {label} != {name}")
                cases += 1
    for k in XOR_KS:
        for shape in ((1, k, 524288), (64, k, 4096), (3, k, 4100), (2, 3, k, 131072)):
            host = rng.integers(0, 256, (*shape[:-2], k + 2, shape[-1] + 3), dtype=np.uint8)
            data = torch.from_numpy(host).to(cuda)
            L = shape[-1]
            for label, view, hview in (
                    ("dense", data[..., :k, :L].contiguous(), host[..., :k, :L]),
                    ("chunk subset", data[..., 1:k + 1, :L], host[..., 1:k + 1, :L]),
                    ("misaligned", data[..., :k, 1:L + 1], host[..., :k, 1:L + 1])):
                got = xor_mm.xor_reduce(view)
                want = torch.from_numpy(np.bitwise_xor.reduce(hview, axis=-2)).to(cuda)
                plain = xor_mm.xor_reduce_plain(view)
                for other, name in ((want, "numpy"), (plain, "plain")):
                    diff = int((got.int() - other.int()).abs().max())
                    err["xor_reduce"] = max(err["xor_reduce"], diff)
                    check(diff == 0, f"12a xor_reduce {tuple(view.shape)} {label} != {name}")
                cases += 1
    torch.cuda.synchronize()
    print(f"[12] 12a: {cases} cases, crc32c at L {CRC_LENGTHS} x S {CRC_STRIPES} (dense and "
          f"a misaligned strided view) and on zero-heavy and constant rows at L "
          f"{CRC_PATTERN_LENGTHS} x S {CRC_PATTERN_STRIPES}, the transform at Lp {XFORM_LPS} "
          f"(tiles where Lp % 4096 == 0, dense and strided+1), xor_reduce at k "
          f"{XOR_KS} (dense, a chunk subset, a misaligned view): every kernel = its plain "
          f"version = its host oracle, byte for byte")
    return err


def bluestore_timing(torch, co, dev, xor_mm, card, err) -> dict:
    """12b: each kernel at the bulk and the path shapes, median of 20 runs
    of 5 calls between CUDA events, beside its bound and its plain version
    (the crc32c plain version, a bit-plane product, at 3 runs of 5).  Each
    kernel's output at each shape is held against its plain version's,
    byte for byte, and the difference goes into `err`."""
    cuda = torch.device("cuda")
    rng = np.random.default_rng(SEED + 121)
    out = {}

    def same(kernel, label, got, plain):
        diff = int((got.long() - plain.long()).abs().max())
        err[kernel] = max(err[kernel], diff)
        check(diff == 0, f"12b {label}: kernel != plain")

    for S, L in (CRC_BULK, *CRC_PATH):
        rows = torch.from_numpy(rng.integers(0, 256, (S, L), dtype=np.uint8)).to(cuda)
        same("crc32c", f"crc32c {S}x{L}", co.crc32c_device(rows), co.crc32c_plain(rows))
        ms = time_ms(torch, lambda: co.crc32c_device(rows))
        plain = time_ms(torch, lambda: co.crc32c_plain(rows), warmup=1, reps=3)
        bound = (S * L + 4 * S) / HBM_BYTES_PER_S * 1e3
        out[f"crc32c {S}x{L}"] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                                  "bound_by": "bytes", "library_ms": None}
    # the same bulk rows, 7 bytes of 8 zero: the parent's byte tables ran
    # such rows faster (broadcast reads); the 5-bit tables take no notice
    gen = torch.Generator(device=cuda)
    gen.manual_seed(SEED + 123)
    S, L = CRC_BULK
    rows = torch.randint(0, 256, (S, L), dtype=torch.uint8, device=cuda, generator=gen)
    rows[torch.rand((S, L), device=cuda, generator=gen) < 0.875] = 0
    same("crc32c", f"crc32c {S}x{L} zero-heavy", co.crc32c_device(rows), co.crc32c_plain(rows))
    out[f"crc32c {S}x{L} zero-heavy"] = {
        "ms": time_ms(torch, lambda: co.crc32c_device(rows)), "plain_ms": None,
        "bound_ms": (S * L + 4 * S) / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None}
    del rows
    for S, Lp in (XFORM_BULK, *XFORM_PATH, XFORM_GENERAL):
        rows = torch.from_numpy(rng.integers(0, 256, (S, Lp), dtype=np.uint8)).to(cuda)
        same("compress_transform", f"compress_transform {S}x{Lp}",
             dev.transform_rows_device(rows), dev.transform_rows_plain(rows))
        ms = time_ms(torch, lambda: dev.transform_rows_device(rows))
        plain = time_ms(torch, lambda: dev.transform_rows_plain(rows))
        floor = time_ms(torch, lambda: rows.view(S, Lp // 64, 64).transpose(1, 2).contiguous())
        bound = (2 * Lp + Lp // 64) * S / HBM_BYTES_PER_S * 1e3
        out[f"compress_transform {S}x{Lp}"] = {
            "ms": ms, "plain_ms": plain, "bound_ms": bound, "bound_by": "bytes",
            "library_ms": None, "transpose_floor_ms": floor}
    for shape in (XOR_BULK, *XOR_PATH):
        S, k, L = shape
        data = torch.from_numpy(rng.integers(0, 256, shape, dtype=np.uint8)).to(cuda)
        same("xor_reduce", f"xor_reduce {S}x{k}x{L}",
             xor_mm.xor_reduce(data), xor_mm.xor_reduce_plain(data))
        ms = time_ms(torch, lambda: xor_mm.xor_reduce(data))
        plain = time_ms(torch, lambda: xor_mm.xor_reduce_plain(data))
        bound = (k + 1) * S * L / HBM_BYTES_PER_S * 1e3
        out[f"xor_reduce {S}x{k}x{L}"] = {"ms": ms, "plain_ms": plain, "bound_ms": bound,
                                         "bound_by": "bytes", "library_ms": None}
    for label, row in out.items():
        extra = (f", the transpose alone (x.view(S, Lp // 64, 64).transpose(1, 2)"
                 f".contiguous(), the floor of its data movement, not the same function) "
                 f"{row['transpose_floor_ms']:.4f} ms" if "transpose_floor_ms" in row else "")
        plain = "not timed" if row["plain_ms"] is None else f"{row['plain_ms']:.4f} ms"
        path = ((" (tiles path)" if dev.build_library().compress_transform_path(
                    int(label.split("x")[-1])) else " (general path)")
                if label.startswith("compress_transform") else "")
        print(f"[12] 12b: {label}{path}: {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
              f"({row['bound_ms'] / row['ms']:.3f} of it), plain {plain}{extra}; {card}")
    return out


def _onode_blocks(store) -> list:
    from ceph_tpu_torch.os.bluestore import Onode

    return [e for (prefix, _key), blob in store.db._data.items() if prefix == "O"
            for e in Onode.decode(blob).blocks.values()]


def phase_bluestore(torch, xor_mm, dispatch, card) -> dict:
    """Phase 12: BlueStore under the EC write path, with the checksum
    service and the device compressor (12a-12e)."""
    from ceph_tpu_torch.common.fault_injector import global_injector
    from ceph_tpu_torch.common.mempool import ledger
    from ceph_tpu_torch.compressor import device as dev
    from ceph_tpu_torch.ops import checksum_offload as co
    from ceph_tpu_torch.ops.flight_recorder import flight_recorder
    from ceph_tpu_torch.ops.guard import device_guard
    from ceph_tpu_torch.os.bluestore import BLOCK, BlueStore, SimulatedCrash
    from ceph_tpu_torch.os.objectstore import StoreError
    from ceph_tpu_torch.os.transaction import Transaction
    from ceph_tpu_torch.osd.ec_backend import ECBackend

    t_phase = time.perf_counter()
    led, fr, guard = ledger(), flight_recorder(), device_guard()
    out: dict = {"errs": bluestore_kernel_checks(torch, co, dev, xor_mm)}
    out["times"] = bluestore_timing(torch, co, dev, xor_mm, card, out["errs"])
    csum_agg, comp_agg = co.default_csum_aggregator(), dev.default_compress_aggregator()
    rng = np.random.default_rng(SEED + 122)
    # QD8 writes other bytes than QD1 (an identical overwrite skips its csums)
    models = {qd: rng.integers(0, 256, (BS_OBJECTS, BK_OBJECT_BYTES), dtype=np.uint8)
              for qd in (1, BS_QD)}
    model = models[BS_QD]
    oids = [f"rbd_data.{i:016x}" for i in range(BS_OBJECTS)]

    fused = collections.Counter()
    real_submit = ECBackend._csum_submit

    def counted_submit(backend, chunk, chunk_off):
        ticket = real_submit(backend, chunk, chunk_off)
        if ticket is not None:
            fused["tickets"] += 1
            fused["blocks"] += len(chunk) // BLOCK
        return ticket

    def launches() -> dict:
        return {"crc32c": co.crc32c_device.launches,
                "compress_transform": dev.transform_rows_device.launches,
                "csum_agg": int(csum_agg.perf.get("launches")),
                "csum_submits": int(csum_agg.perf.get("submits")),
                "compress_agg": int(comp_agg.perf.get("launches")),
                "FALLBACK": dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]}

    def settled(c, label):
        # the fused submissions no store reaps sit in the csum window or in
        # launched groups nothing settles: drain them before the pool check
        csum_agg.drain()
        comp_agg.drain()
        c.settled(label, led)

    def read_all(c, label):
        for first in range(0, BS_OBJECTS, 16):
            got = c.read({oid: [(0, BK_OBJECT_BYTES)] for oid in oids[first:first + 16]})
            for i in range(first, first + 16):
                check(got[oids[i]] == (0, [model[i].tobytes()]),
                      f"{label}: {oids[i]} did not read back")

    # 12c: 64 WRITEFULLs of 4 MiB at QD1 and then QD8 on a fresh cluster of 11
    # BlueStores, the checksum offload off and then on
    images = {}
    co.crc32c_device.launches = 0
    run_launches = {"crc32c": 0}
    ECBackend._csum_submit = counted_submit
    fr.configure(capacity=4096)  # a QD1 pass commits about 11 csum records a write
    try:
        for offload in (False, True):
            c = BkCluster(3, "rbd", overwrites=True,
                          make_store=lambda: BlueStore(None, csum_offload=offload))
            for qd in (1, BS_QD):
                fused.clear()
                before = launches()
                fr.reset()
                t0 = time.perf_counter()
                for first in range(0, BS_OBJECTS, qd):
                    for i in range(first, first + qd):
                        c.writefull(oids[i], models[qd][i].tobytes())
                    c.pump()
                wall = time.perf_counter() - t0
                torch.cuda.synchronize()
                label = f"12c offload {'on' if offload else 'off'} QD{qd}"
                settled(c, label)
                moved = {k: v - before[k] for k, v in launches().items()}
                csum_records = [r for r in fr.records()
                                if r["group"].startswith("csum_aggregator")]
                check(moved["FALLBACK"] == 0 and not guard.degraded, f"{label}: {moved}")
                check(moved["crc32c"] == moved["csum_agg"] == len(csum_records),
                      f"{label}: crc32c {moved['crc32c']} launches, the aggregator "
                      f"{moved['csum_agg']}, {len(csum_records)} flight records")
                check((moved["crc32c"] > 0) == offload and (fused["tickets"] > 0) == offload,
                      f"{label}: {moved['crc32c']} crc32c launches, {fused['tickets']} "
                      "fused submissions")
                store_blocks = (BK_OBJECT_BYTES // BK_K // BLOCK) * (BK_K + BK_M)
                row = {"MBps": model.nbytes / wall / 1e6,
                       "csum_launches_per_write": moved["crc32c"] / BS_OBJECTS,
                       "fused_submissions_per_write": fused["tickets"] / BS_OBJECTS,
                       "fused_blocks_per_write": fused["blocks"] / BS_OBJECTS,
                       "store_blocks_per_write": store_blocks,
                       "rows_per_launch": statistics.median(
                           r["batch"] for r in csum_records) if csum_records else 0,
                       "spans": span_medians(csum_records)}
                out[label] = row
                print(f"[12] {label}: {BS_OBJECTS} WRITEFULLs of 4 MiB, {row['MBps']:.1f} "
                      f"MB/s; crc32c launches a write {row['csum_launches_per_write']:.2f} "
                      f"(median {row['rows_per_launch']} rows a launch); the stores checksum "
                      f"{store_blocks} blocks a write, `_csum_submit` submits "
                      f"{row['fused_blocks_per_write']:.0f} more that no store reads; csum "
                      f"spans (ms) {row['spans']}; {card}")
                if offload:
                    run_launches["crc32c"] += moved["crc32c"]
            before = launches()
            read_all(c, f"12c offload {'on' if offload else 'off'}")
            moved = {k: v - before[k] for k, v in launches().items()}
            check((moved["crc32c"] > 0) == offload,
                  f"12c reads: {moved['crc32c']} crc32c launches with offload {offload}")
            images[offload] = [(s._block_f.getvalue(), dict(s.db._data)) for s in c.stores]
            print(f"[12] 12c offload {'on' if offload else 'off'}: every object read back "
                  f"whole, csum-verified ({moved['crc32c']} crc32c launches)")
            del c
    finally:
        ECBackend._csum_submit = real_submit
        fr.configure(capacity=512)
    check(images[False] == images[True],
          "12c: a shard's block image or KV records differ with the offload off and on")
    out["launches"] = {"crc32c": run_launches["crc32c"]}
    print("[12] 12c: every shard's block image and KV records are the same with the "
          "checksum offload off and on")

    # 12d: device compression at the default required ratio, objects of half
    # random 4 KiB pages and half record pages (64-byte records, 16 nonzero
    # bytes each)
    pages = model.reshape(BS_OBJECTS, -1, BLOCK)
    records = pages.reshape(BS_OBJECTS, -1, BLOCK // 64, 64)
    is_record = rng.random(pages.shape[:2]) < 0.5
    records[..., 16:][is_record] = 0
    records[..., :16][is_record] |= 1  # the 16 record bytes are nonzero
    dev.transform_rows_device.launches = 0
    tiles0 = dev.transform_rows_device.path_launches["tiles"]
    before = launches()
    c = BkCluster(4, "rbd", overwrites=True,
                  make_store=lambda: BlueStore(None, compression="device",
                                               compression_required_ratio=BS_RATIO))
    t0 = time.perf_counter()
    for first in range(0, BS_OBJECTS, BS_QD):
        for i in range(first, first + BS_QD):
            c.writefull(oids[i], model[i].tobytes())
        c.pump()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    settled(c, "12d")
    moved = {k: v - before[k] for k, v in launches().items()}
    out["launches"]["compress_transform"] = moved["compress_transform"]
    check(moved["compress_transform"] == moved["compress_agg"] > 0 and moved["FALLBACK"] == 0,
          f"12d: {moved}")
    tiles = dev.transform_rows_device.path_launches["tiles"] - tiles0
    check(tiles == moved["compress_transform"],
          f"12d: {tiles} of {moved['compress_transform']} transform launches on the tile path")
    blocks = [e for s in c.stores for e in _onode_blocks(s)]
    compressed = sum(1 for e in blocks if e[2])
    stored = sum(e[2] or BLOCK for e in blocks)
    oracle = dev.DeviceCompressor()
    checked = 0
    for s, store in enumerate(c.stores):
        for oid in oids:
            o = store._peek_onode(c.colls[s], oid)
            for bidx, (poff, _crc, clen) in o.blocks.items():
                if clen:
                    image = store.read(c.colls[s], oid, bidx * BLOCK, BLOCK)
                    check(store._block_read(poff, clen) == oracle.compress(image),
                          f"12d: shard {s} {oid} block {bidx}'s blob != the host oracle's")
                    checked += 1
    read_all(c, "12d")
    row = {"MBps": model.nbytes / wall / 1e6, "compressed_share": compressed / len(blocks),
           "stored_over_logical": stored / (len(blocks) * BLOCK),
           "transform_launches": moved["compress_transform"]}
    out["12d"] = row
    print(f"[12] 12d: device compression at ratio {BS_RATIO}, {BS_OBJECTS} objects of 4 MiB "
          f"(half record pages): {row['MBps']:.1f} MB/s, {compressed} of {len(blocks)} "
          f"blocks stored compressed ({row['compressed_share']:.3f}), stored/logical "
          f"{row['stored_over_logical']:.3f}, {row['transform_launches']} transform "
          f"launches; all {checked} blobs = assemble_blob(transform_rows(...)); every "
          f"object read back; {card}")
    del c

    # 12e: the drills.  (1) an on-disk BlueStore: umount and mount, WAL replay
    # after a simulated crash, a flipped byte is EIO with the offload on
    import tempfile

    build_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ceph_tpu_torch",
                             "_build")
    os.makedirs(build_dir, exist_ok=True)
    data = rng.integers(0, 256, BS_DRILL_BYTES, dtype=np.uint8).tobytes()
    with tempfile.TemporaryDirectory(dir=build_dir) as path:
        s = BlueStore(path, csum_offload=True)
        s.mount()
        s.queue_transaction(Transaction().create_collection("c"))
        s.queue_transaction(Transaction().write("c", "o", 0, data))
        s.umount()
        s = BlueStore(path, csum_offload=True)
        s.mount()
        check(s.read("c", "o") == data, "12e: the remounted store did not read back")
        s._crash_point = "after_commit"
        try:
            s.queue_transaction(Transaction().write("c", "o", 5000, b"\x77" * 20000))
            check(False, "12e: the crash point did not fire")
        except SimulatedCrash:
            pass
        s._block_f.close()
        s.db.close()
        expect = bytearray(data)
        expect[5000:25000] = b"\x77" * 20000
        s = BlueStore(path, csum_offload=True)
        s.mount()
        check(s.read("c", "o") == bytes(expect), "12e: WAL replay did not finish the write")
        poff = s._peek_onode("c", "o").blocks[100][0]
        s.umount()
        with open(os.path.join(path, "block"), "r+b") as f:
            f.seek(poff + 1234)
            byte = f.read(1)
            f.seek(poff + 1234)
            f.write(bytes([byte[0] ^ 0x01]))
        s = BlueStore(path, csum_offload=True)
        s.mount()
        l0 = co.crc32c_device.launches
        try:
            s.read("c", "o")
            check(False, "12e: a flipped block byte read back")
        except StoreError as e:
            check(e.errno == -5, f"12e: the flipped byte gave {e}")
        check(co.crc32c_device.launches > l0, "12e: the read verify launched no crc32c")
        s.umount()
    print("[12] 12e: on-disk BlueStore: umount/mount, WAL replay after a simulated crash, "
          "a flipped block byte is EIO through the crc32c kernel")
    # (2) `codec.launch` armed on the stores' csum and compress launches
    for what, kw in (("csum", {"csum_offload": True}), ("compress", {"compression": "device"})):
        c = BkCluster(5, "rbd", overwrites=True, make_store=lambda kw=kw: BlueStore(None, **kw))
        c.writefull(oids[0], model[0].tobytes())
        c.pump()
        before = [(s._block_f.getvalue(), dict(s.db._data)) for s in c.stores]
        fb0 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
        for store in c.stores:
            def armed(txn, on_commit=None, real=store.queue_transaction):
                global_injector().inject("codec.launch", 5)
                return real(txn, on_commit)

            store.queue_transaction = armed
        try:
            tag = c.writefull(oids[0], model[1].tobytes())
            c.pump()
        finally:
            global_injector().clear()
            for store in c.stores:
                del store.queue_transaction
        check(c.failures == [(tag, -5)], f"12e {what}: the write gave {c.failures}")
        check(guard.degraded, f"12e {what}: the backend is not DEGRADED")
        check([(s._block_f.getvalue(), dict(s.db._data)) for s in c.stores] == before,
              f"12e {what}: a shard committed under the failed write")
        check(dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fb0,
              f"12e {what}: a launch fell back to the host")
        check(guard.maybe_probe() and not guard.degraded, f"12e {what}: the probe did not heal")
        c.failed_ok.add(tag)
        c.writefull(oids[0], model[2].tobytes())
        c.pump()
        settled(c, f"12e {what}")
        got = c.read({oids[0]: [(0, BK_OBJECT_BYTES)]})
        check(got[oids[0]] == (0, [model[2].tobytes()]), f"12e {what}: read back != model")
        print(f"[12] 12e: codec.launch armed on the stores' {what} launches: the write failed "
              f"with EIO, no shard committed, DEGRADED, no host recompute; the cuda probe "
              f"healed and the next write committed and read back")
        del c
    # (3) writes torn across their shards: only shard 5's store fails its
    # csum launch, after shards 0-4 committed.  Transient: the next
    # shard's launch probes the card, which heals, so only shard 5 failed
    # it, and the primary sends it the write again inside the same pump.
    # Lasting (the probe fails too): shards 6-10 are refused as well and
    # left out of reads, the write is held, and once the probe heals the
    # guard the primary sends it to shards 5-10 again.  Both commit and
    # read back.
    import ceph_tpu_torch.ops.guard as guard_mod

    c = BkCluster(5, "rbd", overwrites=True,
                  make_store=lambda: BlueStore(None, csum_offload=True))
    c.writefull(oids[0], model[0].tobytes())
    c.pump()
    store = c.stores[5]

    def armed(txn, on_commit=None, real=store.queue_transaction):
        if armed.left:
            armed.left -= 1
            global_injector().inject("codec.launch", 5, hits=1)
        return real(txn, on_commit)

    def failing_probe():
        raise RuntimeError("probe held failing by drill 12e")

    store.queue_transaction = armed
    real_probe, interval = guard_mod._default_probe, guard.probe_interval_ms
    torn_parts = {}
    try:
        armed.left = 1
        tag = c.writefull(oids[0], model[1].tobytes())
        c.pump()
        check(not armed.left and c.commits[tag] == 1 and not c.failures
              and c.primary.sub_write_retries == 1 and not guard.degraded,
              f"12e transient torn write: commits {dict(c.commits)}, failures {c.failures}, "
              f"{c.primary.sub_write_retries} re-sent, degraded {guard.degraded}")
        torn_parts["transient"] = {"re_sent": c.primary.sub_write_retries}
        armed.left = 1
        guard_mod._default_probe = failing_probe
        guard.configure(probe_interval_ms=10**9)
        tag = c.writefull(oids[0], model[2].tobytes())
        c.pump()
        check(not armed.left and guard.degraded and not c.commits[tag] and not c.failures,
              f"12e lasting torn write: commits {dict(c.commits)}, failures {c.failures}")
        (op,) = c.primary.in_flight.values()
        check(op.torn_shards == set(range(5, 11)), f"12e torn: torn shards {op.torn_shards}")
        check(c.primary._available_shards(oids[0]) == set(range(5)),
              "12e torn: a read may take a shard that holds the old version")
        guard_mod._default_probe = real_probe
        guard.configure(probe_interval_ms=1)
        time.sleep(0.01)
        c.pump()
    finally:
        global_injector().clear()
        guard_mod._default_probe = real_probe
        guard.configure(probe_interval_ms=interval)
        del store.queue_transaction
    check(not guard.degraded and c.commits[tag] == 1 and not c.failures,
          f"12e lasting torn write after the heal: commits {dict(c.commits)}")
    check(c.primary.sub_write_retries == 7, f"12e torn: {c.primary.sub_write_retries} re-sent")
    torn_parts["lasting"] = {"re_sent": c.primary.sub_write_retries - 1}
    check(not any(b._sub_write_fences for b in c.backends), "12e torn: a shard stayed fenced")
    settled(c, "12e torn")
    got = c.read({oids[0]: [(0, BK_OBJECT_BYTES)]})
    check(got[oids[0]] == (0, [model[2].tobytes()]), "12e torn: read back != model")
    out["torn"] = torn_parts
    print("[12] 12e: a csum launch failed on shard 5 of 11 after shards 0-4 committed. "
          "Transient (the next launch's probe healed): the write went to shard 5 again in "
          "the same pump and committed. Lasting (probe failing): shards 5-10 refused and "
          "left out of reads, the write held; the cuda probe healed, the write went to "
          "shards 5-10 again, committed and read back")
    del c
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[12] phase 12 numbers: "
          f"{json.dumps({k: v for k, v in out.items() if k not in ('times',)}, default=str)}")
    check(out["seconds"] < 60, f"phase 12 took {out['seconds']:.1f} s, over its 60 s")
    return out


PG_OSDS = 12
PG_NUM = 32  # Ceph's osd_pool_default_pg_num
PG_OBJECTS = 128
PG_OBJECT_BYTES = 4 << 20
PG_QD = 8
PG_OVERWRITES = 256
PG_HOT_OBJECTS = 8
PG_HOT_REGION = 64 << 10
PG_HOT_BYTES = (4 << 10, 64 << 10)
PG_META_OBJECTS = 64
PG_VICTIM = 3
# a short PG log, so that the members CRUSH adds after the out backfill
PG_CONF = {"osd_min_pg_log_entries": 1, "osd_max_pg_log_entries": 2}
PG_POOLS = [
    {"name": "rbd", "kind": "ec", "k": 8, "m": 3, "pg_num": PG_NUM, "stripe_unit": 4096,
     "overwrites": True, "profile": {"technique": "reed_sol_van"}},
    {"name": "rbd_meta", "kind": "rep", "size": 3, "pg_num": PG_NUM},
    # RGW's bucket data on EC, append-only: the pool whose objects keep
    # hinfo, so a deep scrub ships chunk bytes and runs the parity verify
    # (an overwrites pool keeps none); pg_num cut to 8 for the phase's time
    {"name": "rgw_data", "kind": "ec", "k": 8, "m": 3, "pg_num": 8, "stripe_unit": 4096,
     "profile": {"technique": "reed_sol_van"}},
]
PG_RGW_OBJECTS = 16
PG_KERNELS = ("swar_gf", "xor_reduce", "packed_verify", "packed_delta")
# the kernels each part must launch: the encode of every write, the decode
# of every degraded read and rebuild (ECBackend decodes through the decode
# aggregator's decode_array, the SWAR kernel at chunk 4096, single erasures
# included; xor_reduce serves only ErasureCode.decode and m = 1 codes, so it
# is counted here and never reached), verify in a deep scrub, delta on the
# cache-hit overwrites
PG_REACHES = {"13a": ("swar_gf",), "13b": (), "13c": ("swar_gf",), "13d": ("swar_gf",),
              "13e": ("packed_verify",), "13f": ("packed_delta",), "13g": ()}


def load_test_host(name: str):
    """A file of tests/ loaded by path (it imports neither package)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "ceph_tpu"))
    check(not leaked, f"loading tests/{name}.py imported {leaked[:5]}")
    return module


def phase_pg(torch, swar, packed, xor_mm, card) -> dict:
    """Phase 13: client ops through `PG.do_op` on 12 in-process OSD hosts."""
    import asyncio

    return asyncio.run(_phase_pg(torch, swar, packed, xor_mm, card))


async def _phase_pg(torch, swar, packed, xor_mm, card) -> dict:
    from ceph_tpu_torch.ops import dispatch
    from ceph_tpu_torch.ops.guard import device_guard

    pg_host = load_test_host("torch_pg_host")
    guard = device_guard()
    t0 = time.perf_counter()
    c = pg_host.PgCluster("ceph_tpu_torch", PG_OSDS, PG_POOLS, conf=PG_CONF, record=False)
    ticks = await c.settle()
    n_pgs = sum(len(h.pgs) for h in c.hosts)
    print(f"[13] {PG_OSDS} OSD hosts, pools rbd (EC RS(8,3) plugin tpu, stripe_unit 4096, "
          f"allow_ec_overwrites) and rbd_meta (replicated size 3), pg_num {PG_NUM} each, and "
          f"rgw_data (EC RS(8,3), append-only, pg_num 8): {n_pgs} PG instances made and peered "
          f"in {time.perf_counter() - t0:.2f} s ({ticks} ticks)", flush=True)
    rbd = c.osdmap.get_pool("rbd")
    check(all(pg.backend.ec.device.type == "cuda" for h in c.hosts for key, pg in h.pgs.items()
              if key[0] == rbd.id), "13: an rbd PG's codec is not on the card")
    rng = np.random.default_rng(SEED + 130)
    base = rng.integers(0, 256, 2 * PG_OBJECT_BYTES, dtype=np.uint8)
    names = [f"rbd_data.10074b0dc51.{i:016x}" for i in range(PG_OBJECTS)]

    def payload(i: int) -> bytes:
        off = (i * 65537) % PG_OBJECT_BYTES
        return base[off:off + PG_OBJECT_BYTES].tobytes()

    def counts() -> dict:
        return {"swar_gf": swar.launches, "xor_reduce": xor_mm.xor_reduce.launches,
                "packed_verify": packed.launches["packed_verify"],
                "packed_delta": packed.launches["packed_delta"]}

    swar.launches = 0
    xor_mm.xor_reduce.launches = 0
    for name in ("packed_code", "packed_verify", "packed_delta"):
        packed.launches[name] = 0
    fallback0 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
    by_part: dict = {}
    out: dict = {}

    def op(code, **kw):
        return c.osd_op(code, **kw)

    async def run_ops(items, qd: int, pool: str = "rbd") -> list:
        """(oid, ops) at a queue depth of `qd`; every op answered once."""
        replies = []
        for lo in range(0, len(items), qd):
            batch = [c.op(pool, oid, ops) for oid, ops in items[lo:lo + qd]]
            await c.pump()
            for (oid, _ops), rep in zip(items[lo:lo + qd], batch):
                check(len(rep) == 1, f"13: {oid} answered {len(rep)} times")
                replies.append(rep[0])
        return replies

    async def read_all(part: str) -> float:
        t = time.perf_counter()
        reps = await run_ops([(n, [op("READ", off=0, len=0)]) for n in names], PG_QD)
        wall = time.perf_counter() - t
        for i, rep in enumerate(reps):
            check(rep.result == 0 and rep.outdata[0] == payload(i),
                  f"{part}: {names[i]} read back wrong (result {rep.result})")
        return PG_OBJECTS * PG_OBJECT_BYTES / wall / 1e9

    def done(part: str, before: dict) -> None:
        torch.cuda.synchronize()
        now = counts()
        by_part[part] = {k: now[k] - before[k] for k in PG_KERNELS}
        for kernel in PG_REACHES[part]:
            check(by_part[part][kernel] > 0, f"{part}: no {kernel} launch ({by_part[part]})")
        check(not guard.degraded, f"{part}: the device guard is degraded")

    # 13a: WRITEFULLs of 4 MiB RBD data objects at QD1, then QD8
    before = counts()
    half = PG_OBJECTS // 2
    for label, lo, hi, qd in (("QD1", 0, half, 1), ("QD8", half, PG_OBJECTS, PG_QD)):
        t = time.perf_counter()
        reps = await run_ops([(names[i], [op("WRITEFULL", data=payload(i))])
                              for i in range(lo, hi)], qd)
        wall = time.perf_counter() - t
        check(all(r.result == 0 for r in reps), f"13a {label}: a write failed")
        out[f"13a {label} MB/s"] = (hi - lo) * PG_OBJECT_BYTES / wall / 1e6
    done("13a", before)
    print(f"[13] 13a: {PG_OBJECTS} WRITEFULLs of {PG_OBJECT_BYTES >> 10} KiB through PG.do_op: "
          f"{out['13a QD1 MB/s']:.1f} MB/s at QD1, {out['13a QD8 MB/s']:.1f} MB/s at QD8; "
          f"launches {by_part['13a']}; {card}", flush=True)

    # 13b: whole reads, every shard up
    before = counts()
    out["13b GB/s"] = await read_all("13b")
    done("13b", before)
    print(f"[13] 13b: {PG_OBJECTS} whole reads at QD{PG_QD}, every byte exact: "
          f"{out['13b GB/s']:.3f} GB/s; launches {by_part['13b']}; {card}", flush=True)

    # 13c: osd.3 down; re-peering, then degraded reads
    before = counts()
    t = time.perf_counter()
    c.mark_down(PG_VICTIM)
    await c.pump()
    while not c.all_active():
        c.tick()
        await c.pump()
    out["13c s to active"] = time.perf_counter() - t
    await c.settle()
    out["13c GB/s"] = await read_all("13c")
    done("13c", before)
    print(f"[13] 13c: osd.{PG_VICTIM} down: every PG active {out['13c s to active']:.3f} s after "
          f"the map; {PG_OBJECTS} degraded reads, every byte exact: {out['13c GB/s']:.3f} GB/s; "
          f"launches {by_part['13c']}; {card}", flush=True)

    # 13d: osd.3 out; recovery and backfill to clean, then every object read
    before = counts()
    pushed0 = c.push_bytes
    bf0 = sum(h.perf.dump()["backfill_pushes"] for h in c.hosts)
    t = time.perf_counter()
    c.mark_out(PG_VICTIM)
    await c.pump()
    while not c.all_active():
        c.tick()
        await c.pump()
    out["13d s to active"] = time.perf_counter() - t
    ticks = await c.settle()
    out["13d s to clean"] = time.perf_counter() - t
    pushed = c.push_bytes - pushed0
    backfilled = sum(h.perf.dump()["backfill_pushes"] for h in c.hosts) - bf0
    out["13d recovery MB/s"] = pushed / out["13d s to clean"] / 1e6
    check(pushed > 0 and backfilled > 0,
          f"13d: {pushed} bytes pushed, {backfilled} backfill pushes")
    out["13d read GB/s"] = await read_all("13d")
    done("13d", before)
    print(f"[13] 13d: osd.{PG_VICTIM} out: every PG active {out['13d s to active']:.3f} s and "
          f"clean {out['13d s to clean']:.3f} s after the map ({ticks} ticks); {pushed} bytes "
          f"pushed ({int(backfilled)} objects by backfill): {out['13d recovery MB/s']:.1f} MB/s; "
          f"every object read back exact ({out['13d read GB/s']:.3f} GB/s); launches "
          f"{by_part['13d']}; {card}", flush=True)

    # 13e: RGW objects written to the append-only pool, then a deep scrub
    # of its PG with the most objects (the parity verify) and of rbd's
    # (digests and sizes only: an overwrites pool keeps no hinfo)
    before = counts()
    rgw = c.osdmap.get_pool("rgw_data")
    rgw_names = [f"default.4135.1__shadow_.{i:04x}_0" for i in range(PG_RGW_OBJECTS)]
    reps = await run_ops([(n, [op("WRITEFULL", data=payload(PG_OBJECTS + i))])
                          for i, n in enumerate(rgw_names)], PG_QD, pool="rgw_data")
    check(all(r.result == 0 for r in reps), "13e: an rgw_data write failed")
    for pool in (rgw, rbd):
        pg = max((p for p in c.primaries() if p.pool.id == pool.id),
                 key=lambda p: len(p.list_heads()))
        results: list = []
        t = time.perf_counter()
        check(pg.scrub(deep=True, on_done=results.append), "13e: the scrub did not start")
        await c.pump()
        out[f"13e {pool.name} s"] = time.perf_counter() - t
        check(len(results) == 1, "13e: the deep scrub did not finish")
        r = results[0]
        check(r.deep and not r.aborted and r.errors == 0 and r.objects_scrubbed > 0,
              f"13e: deep scrub of {pg.pgid}: {r}")
        print(f"[13] 13e: deep scrub of pg {pg.pgid} ({pool.name}, {r.objects_scrubbed} objects "
              f"of {PG_OBJECT_BYTES >> 10} KiB): clean in {out[f'13e {pool.name} s']:.3f} s; "
              f"launches so far {dict((k, v - before[k]) for k, v in counts().items())}; {card}",
              flush=True)
    done("13e", before)

    # 13f: overwrites of 4-64 KiB in a 64 KiB hot region of 8 objects, QD1
    before = counts()
    model = {i: bytearray(payload(i)) for i in range(PG_HOT_OBJECTS)}
    t = time.perf_counter()
    for _ in range(PG_OVERWRITES):
        i = int(rng.integers(0, PG_HOT_OBJECTS))
        n = int(rng.integers(PG_HOT_BYTES[0], PG_HOT_BYTES[1] + 1))
        off = int(rng.integers(0, PG_HOT_REGION - n + 1))
        patch = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        model[i][off:off + n] = patch
        (rep,) = await run_ops([(names[i], [op("WRITE", off=off, data=patch)])], 1)
        check(rep.result == 0, f"13f: an overwrite failed ({rep.result})")
    out["13f writes/s"] = PG_OVERWRITES / (time.perf_counter() - t)
    reps = await run_ops([(names[i], [op("READ", off=0, len=0)]) for i in model], PG_QD)
    for i, rep in zip(model, reps):
        check(rep.result == 0 and rep.outdata[0] == bytes(model[i]),
              f"13f: {names[i]} read back != the model")
    done("13f", before)
    print(f"[13] 13f: {PG_OVERWRITES} overwrites of 4-64 KiB in a 64 KiB hot region of "
          f"{PG_HOT_OBJECTS} objects at QD1: {out['13f writes/s']:.1f} writes/s; every byte read "
          f"back; launches {by_part['13f']}; {card}", flush=True)

    # 13g: the image metadata on the replicated pool: header and id objects
    # with omap, written and read back
    from ceph_tpu_torch.common.encoding import decode_kv_map, encode_kv_map

    before = counts()
    meta = {f"rbd_header.10074b0dc51.{i:04x}": (rng.integers(0, 256, 4096, dtype=np.uint8)
                                                 .tobytes(), {"size": i.to_bytes(8, "little"),
                                                              "order": b"\x16"})
            for i in range(PG_META_OBJECTS)}
    t = time.perf_counter()
    reps = await run_ops([(oid, [op("WRITEFULL", data=data),
                                 op("OMAPSETVALS", data=encode_kv_map(kv))])
                          for oid, (data, kv) in meta.items()], PG_QD, pool="rbd_meta")
    check(all(r.result == 0 for r in reps), "13g: a metadata write failed")
    reps = await run_ops([(oid, [op("READ", off=0, len=0), op("OMAPGETVALS")])
                          for oid in meta], PG_QD, pool="rbd_meta")
    out["13g ops/s"] = 2 * PG_META_OBJECTS / (time.perf_counter() - t)
    for (oid, (data, kv)), rep in zip(meta.items(), reps):
        check(rep.result == 0 and rep.outdata[0] == data and decode_kv_map(rep.outdata[1]) == kv,
              f"13g: {oid} read back wrong")
    done("13g", before)
    print(f"[13] 13g: {PG_META_OBJECTS} rbd_header objects (4 KiB and omap) written and read "
          f"back on rbd_meta: {out['13g ops/s']:.1f} ops/s; launches {by_part['13g']}; {card}",
          flush=True)

    check(dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fallback0,
          "13: a launch fell back to the host")
    check(not any(h.clog for h in c.hosts), f"13: cluster log errors {[h.clog for h in c.hosts]}")
    totals = {k: sum(part[k] for part in by_part.values()) for k in PG_KERNELS}
    check(totals == counts(), f"13: launches {counts()} != the parts' sum {totals}")
    print(f"[13] launches by part {by_part}; figures {json.dumps(out)}", flush=True)
    return {"launches": totals, "by_part": by_part, "figures": out}


D_OSDS = 12
D_VICTIM = 3
D_OBJECTS = 64  # cut from 128 to keep the whole script near 900 s with phase 17
D_OBJECT_BYTES = 4 << 20
D_QD = 8
D_RGW_OBJECTS = 16
D_OVERWRITES = 256
D_HOT_OBJECTS = 8
# the daemon's options for the phase; everything else at the defaults
D_CONF = {
    "ms_type": "async+posix",
    "osd_objectstore": "bluestore",
    "osd_heartbeat_interval": 0.25,  # Ceph's default 1.0 (cut)
    "osd_heartbeat_grace": 1.5,      # Ceph's default 6.0 (cut)
    "osd_min_pg_log_entries": 1,     # phase 13's short log: the out backfills
    "osd_max_pg_log_entries": 2,
    "ec_tpu_flight_records": 16384,  # a part's launches fit the ring
}
D_SCRUB_INTERVAL = 2.0  # osd_scrub_interval and osd_deep_scrub_interval (cut)
D_KERNELS = ("swar_gf", "packed_verify", "packed_delta", "crc32c")
D_REACHES = {"14a": (), "14b": ("swar_gf",), "14c": ("swar_gf", "crc32c"),
             "14d": ("swar_gf",), "14e": ("swar_gf",), "14f": ("packed_verify",),
             "14g": ("packed_delta",), "14h": (), "14i": ()}


def flight_spans(records: list, wall_s: float) -> dict:
    """A part's flight records: count, each span summed (s), and the
    kernel span's share of the part's wall time."""
    out = {"records": len(records)}
    for span in ("queue_wait_s", "h2d_s", "kernel_s", "d2h_s"):
        out[span] = sum(r.get(span, 0.0) for r in records)
    out["kernel_share"] = out["kernel_s"] / wall_s if wall_s > 0 else 0.0
    return out


def phase_daemon(torch, swar, packed, co, card, device=None) -> dict:
    """Phase 14: client ops over the wire to 12 OSD daemons."""
    import asyncio

    return asyncio.run(_phase_daemon(torch, swar, packed, co, card, device))


async def _phase_daemon(torch, swar, packed, co, card, device) -> dict:
    import asyncio
    import tempfile

    from ceph_tpu_torch.common.encoding import encode_kv_map
    from ceph_tpu_torch.ops import dispatch
    from ceph_tpu_torch.ops.guard import device_guard

    host = load_test_host("torch_daemon_host")
    guard = device_guard()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_osd_")
    c = host.DaemonCluster("ceph_tpu_torch", D_OSDS, PG_POOLS, conf={**D_CONF, **PG_CONF},
                           device=device, stack="posix", keyring=True, root_dir=tmp,
                           store="bluestore", honor_failures=True, admin_sockets=True)
    cl = None
    by_part: dict = {}
    out: dict = {}
    spans: dict = {}

    def counts() -> dict:
        return {"swar_gf": swar.launches, "packed_verify": packed.launches["packed_verify"],
                "packed_delta": packed.launches["packed_delta"],
                "crc32c": co.crc32c_device.launches}

    async def flight(reset: bool = False):
        got = await c.asok(0, "dump_flight", **({"reset": True} if reset else {}))
        return got if reset else got["records"]

    part_t0: dict = {}

    async def begin(part: str) -> dict:
        await flight(reset=True)
        part_t0[part] = time.perf_counter()
        return counts()

    async def done(part: str, before: dict) -> None:
        torch.cuda.synchronize()
        wall = time.perf_counter() - part_t0[part]
        now = counts()
        by_part[part] = {k: now[k] - before[k] for k in D_KERNELS}
        for kernel in D_REACHES[part]:
            check(by_part[part][kernel] > 0, f"{part}: no {kernel} launch ({by_part[part]})")
        spans[part] = flight_spans(await flight(), wall)
        if part != "14i":
            check(not guard.degraded, f"{part}: the device guard is degraded")

    rng = np.random.default_rng(SEED + 140)
    base = rng.integers(0, 256, 2 * D_OBJECT_BYTES, dtype=np.uint8)
    names = [f"rbd_data.10074b0dc52.{i:016x}" for i in range(D_OBJECTS)]

    def payload(i: int) -> bytes:
        off = (i * 65537) % D_OBJECT_BYTES
        return base[off:off + D_OBJECT_BYTES].tobytes()

    def op(code, **kw):
        return cl.osd_op(code, **kw)

    async def run_ops(items, qd: int, pool: str = "rbd") -> list:
        replies = []
        for lo in range(0, len(items), qd):
            replies += await asyncio.gather(*(cl.op(pool, oid, ops)
                                              for oid, ops in items[lo:lo + qd]))
        return replies

    def describe(pool: str, oid: str) -> str:
        """Where an object stands: its PG on every daemon that has it."""
        pgid, primary = cl.target(pool, oid)
        key = (pgid.pool, pgid.ps)
        lines = [f"{oid}: pg {pgid}, primary osd.{primary}; epochs: client "
                 f"{cl.osdmap.epoch}, map service {c.mon.osdmap.epoch}"]
        for o in c.running():
            pg = o.pgs.get(key) or o.strays.get(key)
            if pg is not None:
                p = pg.peering
                lines.append(f"  osd.{o.whoami}{' (stray)' if key in o.strays else ''}: "
                             f"{p.state.value} epoch {o.osdmap.epoch} acting {list(p.acting)} "
                             f"primary {p.primary} clean {pg.is_clean} missing "
                             f"{oid in p.missing.items} backfill {sorted(p.backfill_targets)} "
                             f"exists {pg._object_exists(oid)} log head {pg.pg_log.head}")
        return "\n".join(lines)

    async def read_all(part: str) -> float:
        t = time.perf_counter()
        reps = await run_ops([(n, [op("READ", off=0, len=0)]) for n in names], D_QD)
        wall = time.perf_counter() - t
        for i, rep in enumerate(reps):
            if rep.result != 0 or rep.outdata[0] != payload(i):
                print(f"[14] {part}: read back wrong, result {rep.result}\n"
                      f"{describe('rbd', names[i])}", flush=True)
            check(rep.result == 0 and rep.outdata[0] == payload(i),
                  f"{part}: {names[i]} read back wrong (result {rep.result})")
        return D_OBJECTS * D_OBJECT_BYTES / wall / 1e9

    async def write_all(label: str, lo: int, hi: int, qd: int) -> float:
        t = time.perf_counter()
        reps = await run_ops([(names[i], [op("WRITEFULL", data=payload(i))])
                              for i in range(lo, hi)], qd)
        wall = time.perf_counter() - t
        check(all(r.result == 0 for r in reps), f"{label}: a write failed "
              f"({sorted({r.result for r in reps})})")
        return (hi - lo) * D_OBJECT_BYTES / wall / 1e6

    def spurious_downs() -> list:
        return sorted(o for o in c.mon.down_epochs if o != D_VICTIM)

    swar.launches = 0
    for name in ("packed_code", "packed_verify", "packed_delta"):
        packed.launches[name] = 0
    co.crc32c_device.launches = 0
    fallback0 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
    try:
        # 14a: boot, through MonClient, to every PG active and clean
        before = counts()
        part_t0["14a"] = time.perf_counter()
        out["14a s to clean"] = await c.start(120)
        cl = c.client
        check(all(pg.backend.ec.device.type == "cuda" for o in c.osds
                  for pg in o.pgs.values() if hasattr(pg.backend, "ec")),
              "14a: an EC PG's codec is not on the card")
        await done("14a", before)
        n_pgs = sum(len(o.pgs) for o in c.osds)
        print(f"[14] 14a: {D_OSDS} OSD daemons (BlueStore, async+posix on loopback, cephx) "
              f"booted through MonClient: {n_pgs} PG instances, every PG active and clean "
              f"{out['14a s to clean']:.3f} s after the first start, epoch "
              f"{c.mon.osdmap.epoch}; {card}", flush=True)

        # 14b: WRITEFULLs at QD1 and QD8, then whole reads
        before = await begin("14b")
        half = D_OBJECTS // 2
        out["14b QD1 MB/s"] = await write_all("14b QD1", 0, half, 1)
        out["14b QD8 MB/s"] = await write_all("14b QD8", half, D_OBJECTS, D_QD)
        out["14b read GB/s"] = await read_all("14b")
        await done("14b", before)
        print(f"[14] 14b: {D_OBJECTS} WRITEFULLs of {D_OBJECT_BYTES >> 10} KiB over the "
              f"messenger: {out['14b QD1 MB/s']:.1f} MB/s at QD1, {out['14b QD8 MB/s']:.1f} "
              f"MB/s at QD8; whole reads {out['14b read GB/s']:.3f} GB/s; launches "
              f"{by_part['14b']}; spans {spans['14b']}; {card}", flush=True)

        # 14c: the checksum offload switched on in every daemon, QD8 again
        before = await begin("14c")
        for i in range(D_OSDS):
            await c.asok(i, "injectargs", conf={"bluestore_csum_offload": "true"})
        check(all(o.store._csum_offload for o in c.osds), "14c: an offload stayed off")
        out["14c QD8 MB/s"] = await write_all("14c", 0, D_OBJECTS, D_QD)
        await done("14c", before)
        # back to the option's default (off) for the parts that follow
        for i in range(D_OSDS):
            await c.asok(i, "injectargs", conf={"bluestore_csum_offload": "false"})
        print(f"[14] 14c: bluestore_csum_offload set through 12 admin sockets; {D_OBJECTS} "
              f"WRITEFULLs at QD8: {out['14c QD8 MB/s']:.1f} MB/s; launches {by_part['14c']}; "
              f"spans {spans['14c']}; {card}", flush=True)

        # 14d: osd.3's daemon stopped; its peers report it, the map marks it down
        before = await begin("14d")
        t = time.monotonic()
        await c.stop_osd(D_VICTIM)
        await host.wait_until(lambda: D_VICTIM in c.mon.down_epochs, 30.0, "osd.3 down")
        out["14d s to down"] = c.mon.epoch_times[c.mon.down_epochs[D_VICTIM]] - t
        await host.wait_until(lambda: all(o.osdmap.epoch == c.mon.osdmap.epoch
                                          for o in c.running()), 30.0, "the down epoch")
        out["14d degraded read GB/s"] = await read_all("14d")
        await done("14d", before)
        print(f"[14] 14d: osd.{D_VICTIM} stopped: marked down {out['14d s to down']:.3f} s "
              f"later by its peers' MOSDFailures (grace {D_CONF['osd_heartbeat_grace']} s); "
              f"{D_OBJECTS} degraded reads {out['14d degraded read GB/s']:.3f} GB/s; launches "
              f"{by_part['14d']}; spans {spans['14d']}; {card}", flush=True)

        # 14e: osd.3 out; rebuild to clean
        before = await begin("14e")
        def recovered() -> int:
            return sum(io.get("recovery", {}).get("bytes", 0) for o in c.running()
                       for io in o.io_accountant.dump_pools().values())

        rec0 = recovered()
        waves0 = sum(o.recovery_storm.perf_dump()["waves"] for o in c.running())
        t = time.perf_counter()
        c.mon.mark_out(D_VICTIM)
        await c.wait_clean(120)
        out["14e s to clean"] = time.perf_counter() - t
        rebuilt = recovered() - rec0
        out["14e recovery MB/s"] = rebuilt / out["14e s to clean"] / 1e6
        out["14e waves"] = sum(o.recovery_storm.perf_dump()["waves"]
                               for o in c.running()) - waves0
        out["14e read GB/s"] = await read_all("14e")
        await done("14e", before)
        print(f"[14] 14e: osd.{D_VICTIM} out: clean {out['14e s to clean']:.3f} s after the "
              f"map; {rebuilt} bytes rebuilt ({out['14e recovery MB/s']:.1f} MB/s), "
              f"{out['14e waves']} recovery-storm waves; every object read back "
              f"({out['14e read GB/s']:.3f} GB/s); launches {by_part['14e']}; spans "
              f"{spans['14e']}; {card}", flush=True)

        # 14f: RGW objects, then the daemons' own scrub timers deep-scrub
        before = await begin("14f")
        rgw_names = [f"default.4135.2__shadow_.{i:04x}_0" for i in range(D_RGW_OBJECTS)]
        reps = await run_ops([(n, [op("WRITEFULL", data=payload(i))])
                              for i, n in enumerate(rgw_names)], D_QD, pool="rgw_data")
        check(all(r.result == 0 for r in reps), "14f: an rgw_data write failed")
        rgw = c.mon.osdmap.get_pool("rgw_data")
        pg = max((p for p in c.primaries() if p.pool.id == rgw.id),
                 key=lambda p: len(p.list_heads()))
        daemon = next(o for o in c.running() if o.pgs.get((pg.pool.id, pg.ps)) is pg)
        t = time.perf_counter()
        daemon.conf.set("osd_deep_scrub_interval", D_SCRUB_INTERVAL)
        daemon.conf.set("osd_scrub_interval", D_SCRUB_INTERVAL)
        await host.wait_until(lambda: pg.scrubber.last_result is not None
                              and pg.scrubber.last_result.deep, 60.0, "the timer's deep scrub")
        out["14f s to deep scrub"] = time.perf_counter() - t
        daemon.conf.set("osd_scrub_interval", 0.0)
        daemon.conf.set("osd_deep_scrub_interval", 0.0)
        await host.wait_until(lambda: all(not p.scrubber.active for p in c.primaries()), 60.0,
                              "the timer's scrubs")
        r = pg.scrubber.last_result
        check(not r.aborted and r.errors == 0 and r.objects_scrubbed > 0,
              f"14f: deep scrub of {pg.pgid}: {r}")
        await done("14f", before)
        print(f"[14] 14f: {D_RGW_OBJECTS} rgw_data objects; osd.{daemon.whoami}'s scrub timer "
              f"(2 s) deep-scrubbed pg {pg.pgid} ({r.objects_scrubbed} objects) clean, "
              f"{out['14f s to deep scrub']:.3f} s after the timer was set; launches "
              f"{by_part['14f']}; spans {spans['14f']}; {card}", flush=True)

        # 14g: 256 overwrites of 4-64 KiB in a 64 KiB hot region, QD1
        before = await begin("14g")
        model = {i: bytearray(payload(i)) for i in range(D_HOT_OBJECTS)}
        t = time.perf_counter()
        for _ in range(D_OVERWRITES):
            i = int(rng.integers(0, D_HOT_OBJECTS))
            n = int(rng.integers(PG_HOT_BYTES[0], PG_HOT_BYTES[1] + 1))
            off = int(rng.integers(0, PG_HOT_REGION - n + 1))
            patch = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            model[i][off:off + n] = patch
            rep = await cl.op("rbd", names[i], [op("WRITE", off=off, data=patch)])
            check(rep.result == 0, f"14g: an overwrite failed ({rep.result})")
        out["14g writes/s"] = D_OVERWRITES / (time.perf_counter() - t)
        reps = await run_ops([(names[i], [op("READ", off=0, len=0)]) for i in model], D_QD)
        for i, rep in zip(model, reps):
            check(rep.result == 0 and rep.outdata[0] == bytes(model[i]),
                  f"14g: {names[i]} read back != the model")
        await done("14g", before)
        print(f"[14] 14g: {D_OVERWRITES} overwrites of 4-64 KiB in a 64 KiB hot region of "
              f"{D_HOT_OBJECTS} objects at QD1: {out['14g writes/s']:.1f} writes/s; launches "
              f"{by_part['14g']}; spans {spans['14g']}; {card}", flush=True)

        # 14h: a watch/notify round trip and a COPY_FROM on rbd_meta
        before = await begin("14h")
        hdr = "rbd_header.10074b0dc52"
        rep = await cl.op("rbd_meta", hdr, [op("WRITEFULL", data=b"h" * 4096),
                                             op("OMAPSETVALS", data=encode_kv_map({"s": b"1"}))])
        check(rep.result == 0, "14h: the header write failed")
        watcher = host.make_client(c.m, c.monmap, name="client.77", stack="posix",
                                   auth=c.m.cephx.CephxAuth.for_client(
                                       "client.77", c.keyring.get("client.77")))
        await watcher.connect()
        check((await watcher.watch("rbd_meta", hdr, 1, cb=lambda nid, p: b"ok")).result == 0,
              "14h: the watch failed")
        t = time.perf_counter()
        rep = await cl.op("rbd_meta", hdr, [op("NOTIFY", off=5000, data=b"refresh")])
        out["14h notify ms"] = (time.perf_counter() - t) * 1e3
        acks = json.loads(rep.outdata[0])
        check(rep.result == 0 and acks["acks"] == {"client.77/1": b"ok".hex()}
              and not acks["timeouts"], f"14h: notify answered {rep.result} {acks}")
        await watcher.shutdown()
        t = time.perf_counter()
        rep = await cl.op("rbd_meta", hdr + ".copy", [op("COPY_FROM", name=hdr, off=0)])
        out["14h copy_from ms"] = (time.perf_counter() - t) * 1e3
        check(rep.result == 0, f"14h: COPY_FROM answered {rep.result}")
        rep = await cl.op("rbd_meta", hdr + ".copy", [op("READ", off=0, len=0)])
        check(rep.result == 0 and rep.outdata[0] == b"h" * 4096, "14h: the copy reads wrong")
        await done("14h", before)
        print(f"[14] 14h: watch/notify round trip with one ack {out['14h notify ms']:.3f} ms; "
              f"COPY_FROM of a 4 KiB header {out['14h copy_from ms']:.3f} ms; launches "
              f"{by_part['14h']}; {card}", flush=True)

        # 14i: a launch fault armed through one daemon's admin socket
        before = await begin("14i")
        oid = "rbd_data.drill"
        primary = cl.target("rbd", oid)[1]
        await c.asok(primary, "injectargs", point="codec.launch", error=5, hits=1)
        rep = await cl.op("rbd", oid, [op("WRITEFULL", data=payload(1))])
        status = c.status(primary)
        check(rep.result == -5, f"14i: the faulted write answered {rep.result}, not -EIO")
        check(status["tpu_backend"]["degraded"] and status["tpu_backend"]["fallback_launches"] == 0,
              f"14i: tpu_backend {status['tpu_backend']}")
        await c.asok(primary, "injectargs", clear=True)
        # the guard probes the card on a submitter's path once its probe
        # interval has passed: writes refused with EIO until one heals it
        t = time.perf_counter()
        refused = 0
        while True:
            rep = await cl.op("rbd", oid, [op("WRITEFULL", data=payload(1))])
            if rep.result == 0 or time.perf_counter() - t > 30.0:
                break
            refused += 1
            await asyncio.sleep(0.1)
        out["14i s to heal"] = time.perf_counter() - t
        check(rep.result == 0 and not guard.degraded,
              f"14i: the write after the clear answered {rep.result}")
        rep = await cl.op("rbd", oid, [op("READ", off=0, len=0)])
        check(rep.result == 0 and rep.outdata[0] == payload(1), "14i: the drill object reads wrong")
        await done("14i", before)
        print(f"[14] 14i: codec.launch armed on osd.{primary}: the write answered EIO, "
              f"tpu_backend degraded with fallback_launches 0; the probe healed it "
              f"{out['14i s to heal']:.3f} s after the clear ({refused} writes refused with "
              f"EIO meanwhile), and the write landed; {card}",
              flush=True)

        statuses = [c.status(o.whoami) for o in c.running()]
        check(all(s["tpu_backend"]["fallback_launches"] == 0 for s in statuses),
              "14: a daemon's status blob reads fallback launches")
        check(dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fallback0,
              "14: a launch fell back to the host")
        out["spurious downs"] = spurious_downs()
        out["epochs"] = c.mon.osdmap.epoch
        out["late heartbeat ticks"] = sum(o.heartbeat_stalls for o in c.running())
        clog = [(o.whoami, o.clog) for o in c.running() if o.clog]
        print(f"[14] daemons marked down besides osd.{D_VICTIM}: {out['spurious downs']}; "
              f"{out['epochs']} map epochs; {out['late heartbeat ticks']} heartbeat ticks "
              f"judged no peer (late); cluster-log errors {clog}", flush=True)
    finally:
        await c.stop()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    totals = {k: sum(part[k] for part in by_part.values()) for k in D_KERNELS}
    check(totals == counts(), f"14: launches {counts()} != the parts' sum {totals}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[14] launches by part {by_part}; spans by part {json.dumps(spans)}; figures "
          f"{json.dumps(out)}", flush=True)
    return {"launches": totals, "by_part": by_part, "figures": out, "spans": spans}


M_MONS = 3  # Ceph's documented minimum for a quorum that survives one loss
M_OSDS = 12
M_VICTIM = 3
M_OBJECTS = 32  # on rbd (cut from 64 to keep the whole script near 900 s)
M_OBJECT_BYTES = 4 << 20
M_QD = 8
M_ELECTION_BATCH = 16  # the QD8 writes issued across 15c's election
M_RGW_OBJECTS = 16
M_SCRUB_INTERVAL = 2.0  # osd_scrub_interval and osd_deep_scrub_interval (cut)
# the monitors' and the mgr's options for the phase; the rest at the defaults
M_MON_CONF = {
    "mon_osd_down_out_interval": 3.0,  # Ceph's default 600 (cut)
}
M_KERNELS = ("swar_gf", "packed_verify", "packed_delta", "crc32c")
M_REACHES = {"15a": (), "15b": ("swar_gf",), "15c": ("swar_gf",), "15d": ("swar_gf",),
             "15e": ("crc32c",), "15f": ("packed_verify",), "15g": ()}
# the elections each part may count: the first quorum, then the leader's
# stop and its restart (ROADMAP C21)
M_ELECTIONS = {"15a": 1, "15b": 0, "15c": 2, "15d": 0, "15e": 0, "15f": 0, "15g": 0}
MARKED_DOWN = re.compile(r"osd\.(\d+) marked down")


def phase_mon(torch, swar, packed, co, card, device=None) -> dict:
    """Phase 15: 12 OSD daemons booted, placed, failed, marked out and
    reconfigured by 3 monitors in a Paxos quorum and a mgr."""
    import asyncio

    return asyncio.run(_phase_mon(torch, swar, packed, co, card, device))


async def _phase_mon(torch, swar, packed, co, card, device) -> dict:
    import asyncio
    import tempfile

    from ceph_tpu_torch.ops import dispatch
    from ceph_tpu_torch.ops.guard import device_guard

    host = load_test_host("torch_daemon_host")
    guard = device_guard()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_mon_")
    c = host.DaemonCluster("ceph_tpu_torch", M_OSDS, PG_POOLS, conf={**D_CONF, **PG_CONF},
                           device=device, stack="posix", keyring=True, root_dir=tmp,
                           store="bluestore", admin_sockets=True, mons=M_MONS,
                           mon_conf=M_MON_CONF)
    cl = None
    by_part: dict = {}
    out: dict = {}
    spans: dict = {}
    elections: dict = {}
    downs: dict = {}

    def counts() -> dict:
        return {"swar_gf": swar.launches, "packed_verify": packed.launches["packed_verify"],
                "packed_delta": packed.launches["packed_delta"],
                "crc32c": co.crc32c_device.launches}

    def marked_down() -> list:
        """Every daemon the monitors' cluster log says was marked down."""
        mon = c.leader() or next(m for m in c.monitors if m._tick_task is not None)
        return [int(g.group(1)) for e in mon.logmon.entries
                for g in [MARKED_DOWN.match(e["msg"])] if g]

    async def flight(reset: bool = False):
        got = await c.asok(0, "dump_flight", **({"reset": True} if reset else {}))
        return got if reset else got["records"]

    part_t0: dict = {}
    part_epoch: dict = {}

    async def begin(part: str) -> dict:
        if c.osds[0] is not None and c.osds[0]._running:
            await flight(reset=True)
        part_t0[part] = time.perf_counter()
        part_epoch[part] = c.quorum_epoch()
        return counts()

    async def done(part: str, before: dict) -> None:
        torch.cuda.synchronize()
        wall = time.perf_counter() - part_t0[part]
        now = counts()
        by_part[part] = {k: now[k] - before[k] for k in M_KERNELS}
        for kernel in M_REACHES[part]:
            check(by_part[part][kernel] > 0, f"{part}: no {kernel} launch ({by_part[part]})")
        spans[part] = flight_spans(await flight(), wall)
        c.raise_failed_monitor()
        elections[part] = (c.quorum_epoch() - part_epoch[part]) // 2
        check(elections[part] <= M_ELECTIONS[part], f"{part}: {elections[part]} elections, "
              f"more than the {M_ELECTIONS[part]} expected")
        downs[part] = sorted(set(o for o in marked_down() if o != M_VICTIM))
        check(not downs[part], f"{part}: daemons besides osd.{M_VICTIM} marked down: "
                               f"{downs[part]}")
        if part != "15g":
            check(not guard.degraded, f"{part}: the device guard is degraded")

    rng = np.random.default_rng(SEED + 150)
    base = rng.integers(0, 256, 2 * M_OBJECT_BYTES, dtype=np.uint8)
    names = [f"rbd_data.20a3c1f9e7b.{i:016x}" for i in range(M_OBJECTS)]

    def payload(i: int) -> bytes:
        off = (i * 65537) % M_OBJECT_BYTES
        return base[off:off + M_OBJECT_BYTES].tobytes()

    def op(code, **kw):
        return cl.osd_op(code, **kw)

    async def run_ops(items, qd: int, pool: str = "rbd") -> list:
        replies = []
        for lo in range(0, len(items), qd):
            replies += await asyncio.gather(*(cl.op(pool, oid, ops)
                                              for oid, ops in items[lo:lo + qd]))
        return replies

    def describe(pool: str, oid: str) -> str:
        """Where an object stands: its PG on every daemon that has it, the
        guard, and the daemons' cluster-log errors."""
        pgid, primary = cl.target(pool, oid)
        key = (pgid.pool, pgid.ps)
        lines = [f"{oid}: pg {pgid}, primary osd.{primary}; epochs: client "
                 f"{cl.osdmap.epoch}, monitors {c.osdmap.epoch}; guard degraded "
                 f"{guard.degraded} ({guard.reason!r})"]
        for o in c.running():
            pg = o.pgs.get(key) or o.strays.get(key)
            if pg is not None:
                p = pg.peering
                lines.append(f"  osd.{o.whoami}{' (stray)' if key in o.strays else ''}: "
                             f"{p.state.value} epoch {o.osdmap.epoch} acting {list(p.acting)} "
                             f"primary {p.primary} clean {pg.is_clean} missing "
                             f"{oid in p.missing.items} backfill {sorted(p.backfill_targets)} "
                             f"exists {pg._object_exists(oid)} log head {pg.pg_log.head}")
        lines += [f"  osd.{o.whoami} clog: {o.clog[-6:]}" for o in c.running() if o.clog]
        return "\n".join(lines)

    async def read_back(part: str, idx) -> float:
        t = time.perf_counter()
        reps = await run_ops([(names[i], [op("READ", off=0, len=0)]) for i in idx], M_QD)
        wall = time.perf_counter() - t
        for i, rep in zip(idx, reps):
            if rep.result != 0 or rep.outdata[0] != payload(i):
                print(f"[15] {part}: read back wrong, result {rep.result}\n"
                      f"{describe('rbd', names[i])}", flush=True)
            check(rep.result == 0 and rep.outdata[0] == payload(i),
                  f"{part}: {names[i]} read back wrong (result {rep.result})")
        return len(idx) * M_OBJECT_BYTES / wall / 1e9

    async def write(label: str, idx, qd: int) -> float:
        t = time.perf_counter()
        reps = await run_ops([(names[i], [op("WRITEFULL", data=payload(i))]) for i in idx], qd)
        wall = time.perf_counter() - t
        check(all(r.result == 0 for r in reps), f"{label}: a write failed "
              f"({sorted({r.result for r in reps})})")
        return len(idx) * M_OBJECT_BYTES / wall / 1e6

    async def health_has(code: str, present: bool, timeout: float) -> float:
        """Seconds until `code` is (or is no longer) in `ceph health`."""
        t = time.perf_counter()
        while (code in (await c.health())["checks"]) != present:
            check(time.perf_counter() - t < timeout,
                  f"{code} {'never showed' if present else 'never cleared'} in health")
            await asyncio.sleep(0.05)
        return time.perf_counter() - t

    swar.launches = 0
    for name in ("packed_code", "packed_verify", "packed_delta"):
        packed.launches[name] = 0
    co.crc32c_device.launches = 0
    fallback0 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
    try:
        # 15a: quorum, the mgr, boots through OSDMonitor, pools by command, clean
        before = counts()
        part_t0["15a"] = time.perf_counter()
        part_epoch["15a"] = 1
        out["15a s to clean"] = await c.start(180)
        cl = c.client
        out["15a s to quorum"] = c.t_quorum
        out["15a s to mgr active"] = c.t_mgr
        out["15a s to every OSD up"] = c.t_up
        out["15a s to pools"] = c.t_pools
        check(all(m.device.type == "cuda" and m.osdmon.device.type == "cuda"
                  for m in c.monitors), "15a: a monitor's codec device is not the card")
        check(all(pg.backend.ec.device.type == "cuda" for o in c.osds
                  for pg in o.pgs.values() if hasattr(pg.backend, "ec")),
              "15a: an EC PG's codec is not on the card")
        health = await c.health()
        check(health["status"] == "HEALTH_OK", f"15a: health {health}")
        await done("15a", before)
        n_pgs = sum(len(o.pgs) for o in c.osds)
        print(f"[15] 15a: {M_MONS} monitors in quorum {out['15a s to quorum']:.3f} s after the "
              f"first start; mgr.x active at {out['15a s to mgr active']:.3f} s; {M_OSDS} OSD "
              f"daemons up in the map through OSDMonitor.prepare_boot at "
              f"{out['15a s to every OSD up']:.3f} s; rbd, rbd_meta and rgw_data made by "
              f"commands at {out['15a s to pools']:.3f} s; {n_pgs} PG instances active and "
              f"clean at {out['15a s to clean']:.3f} s; map epoch {c.osdmap.epoch}; "
              f"elections {elections['15a']}; {card}", flush=True)

        # 15b: WRITEFULLs at QD1 and QD8, then whole reads
        before = await begin("15b")
        half = M_OBJECTS // 2
        out["15b QD1 MB/s"] = await write("15b QD1", range(half), 1)
        out["15b QD8 MB/s"] = await write("15b QD8", range(half, M_OBJECTS), M_QD)
        out["15b read GB/s"] = await read_back("15b", range(M_OBJECTS))
        await done("15b", before)
        print(f"[15] 15b: {M_OBJECTS} WRITEFULLs of {M_OBJECT_BYTES >> 10} KiB: "
              f"{out['15b QD1 MB/s']:.1f} MB/s at QD1, {out['15b QD8 MB/s']:.1f} MB/s at QD8; "
              f"whole reads {out['15b read GB/s']:.3f} GB/s; launches {by_part['15b']}; spans "
              f"{spans['15b']}; {card}", flush=True)

        # 15c: the leader monitor stopped under a QD8 write batch, then restarted
        before = await begin("15c")
        leader = c.leader()
        check(leader is not None, "15c: no leader")
        lost = leader.name
        t = time.perf_counter()
        await c.stop_mon(lost)
        batch = asyncio.ensure_future(write("15c", range(M_ELECTION_BATCH), M_QD))
        await host.wait_until(lambda: c.leader() is not None and len(c.leader().quorum) == 2,
                              60.0, "a quorum of 2")
        out["15c s to quorum of 2"] = time.perf_counter() - t
        out["15c s to MON_DOWN"] = out["15c s to quorum of 2"] + await health_has(
            "MON_DOWN", True, 30.0)
        out["15c QD8 MB/s across the election"] = await batch
        out["15c read GB/s"] = await read_back("15c", range(M_ELECTION_BATCH))
        committed = max(m.paxos.last_committed for m in c.monitors if m._tick_task is not None)
        t = time.perf_counter()
        revived = await c.restart_mon(lost)
        await host.wait_until(
            lambda: c.leader() is not None and len(c.leader().quorum) == 3
            and not c.leader().paxos.recovering()
            and revived.paxos.last_committed >= committed
            and len({m.paxos.last_committed for m in c.monitors}) == 1, 60.0,
            "a quorum of 3 with the revived monitor caught up")
        out["15c s to quorum of 3"] = time.perf_counter() - t
        out["15c revived last_committed"] = revived.paxos.last_committed
        await health_has("MON_DOWN", False, 30.0)
        out["15c MON_DOWN cleared s"] = time.perf_counter() - t
        await done("15c", before)
        print(f"[15] 15c: mon.{lost} (the leader) stopped: a quorum of 2 "
              f"{out['15c s to quorum of 2']:.3f} s later, MON_DOWN in health at "
              f"{out['15c s to MON_DOWN']:.3f} s; {M_ELECTION_BATCH} QD8 WRITEFULLs across "
              f"the election all acknowledged and read back "
              f"({out['15c QD8 MB/s across the election']:.1f} MB/s); restarted with an empty "
              f"store: a quorum of 3 again {out['15c s to quorum of 3']:.3f} s later, "
              f"last_committed caught up to {out['15c revived last_committed']} through "
              f"Paxos; elections {elections['15c']}; launches {by_part['15c']}; spans "
              f"{spans['15c']}; {card}", flush=True)

        # 15d: osd.3 stopped: down by its peers' reports, degraded reads, out by the
        # monitor's own down-out timer, rebuilt to clean
        before = await begin("15d")

        def recovered() -> int:
            return sum(io.get("recovery", {}).get("bytes", 0) for o in c.running()
                       for io in o.io_accountant.dump_pools().values())

        rec0 = recovered()
        stamps: dict = {}

        async def watch_map():
            while "out" not in stamps:
                m = c.osdmap
                if "down" not in stamps and not m.is_up(M_VICTIM):
                    stamps["down"] = time.perf_counter()
                if m.osds[M_VICTIM].weight == 0:
                    stamps["out"] = time.perf_counter()
                await asyncio.sleep(0.005)

        watcher = asyncio.ensure_future(watch_map())
        t = time.perf_counter()
        await c.stop_osd(M_VICTIM)
        await host.wait_until(lambda: "down" in stamps, 60.0, "osd.3 marked down")
        out["15d s to down"] = stamps["down"] - t
        await host.wait_until(lambda: all(o.osdmap.epoch >= c.osdmap.epoch
                                          for o in c.running()), 30.0, "the down epoch")
        out["15d degraded read GB/s"] = await read_back("15d", range(M_OBJECTS))
        await host.wait_until(lambda: "out" in stamps, 60.0, "the down-out timer's out")
        await watcher
        out["15d s down to out"] = stamps["out"] - stamps["down"]
        await c.wait_clean(180)
        out["15d s out to clean"] = time.perf_counter() - stamps["out"]
        rebuilt = recovered() - rec0
        out["15d rebuilt bytes"] = rebuilt
        out["15d recovery MB/s"] = rebuilt / out["15d s out to clean"] / 1e6
        out["15d read GB/s"] = await read_back("15d", range(M_OBJECTS))
        await done("15d", before)
        print(f"[15] 15d: osd.{M_VICTIM} stopped: marked down by OSDMonitor.prepare_failure "
              f"{out['15d s to down']:.3f} s later (min_down_reporters 2, grace "
              f"{D_CONF['osd_heartbeat_grace']} s); {M_OBJECTS} degraded reads "
              f"{out['15d degraded read GB/s']:.3f} GB/s; marked out by the monitor's "
              f"down-out timer {out['15d s down to out']:.3f} s after the down (interval "
              f"{M_MON_CONF['mon_osd_down_out_interval']} s); clean "
              f"{out['15d s out to clean']:.3f} s after the out, {rebuilt} bytes rebuilt "
              f"({out['15d recovery MB/s']:.1f} MB/s); elections {elections['15d']}; launches "
              f"{by_part['15d']}; spans {spans['15d']}; {card}", flush=True)

        # 15e: the checksum offload through ConfigMonitor: MConfig to every daemon
        before = await begin("15e")
        t = time.perf_counter()
        await c.config_set("osd", "bluestore_csum_offload", "true")
        await host.wait_until(lambda: all(o.store._csum_offload for o in c.running()), 30.0,
                              "the offload at every daemon")
        out["15e s to config at every daemon"] = time.perf_counter() - t
        out["15e QD8 MB/s"] = await write("15e", range(M_OBJECTS), M_QD)
        out["15e read GB/s"] = await read_back("15e", range(M_OBJECTS))
        await c.command({"prefix": "config rm", "who": "osd", "name": "bluestore_csum_offload"})
        await host.wait_until(lambda: not any(o.store._csum_offload for o in c.running()),
                              30.0, "the offload back off")
        await done("15e", before)
        print(f"[15] 15e: `config set osd bluestore_csum_offload true` reached every daemon "
              f"through MConfig in {out['15e s to config at every daemon']:.3f} s; "
              f"{M_OBJECTS} WRITEFULLs at QD8 {out['15e QD8 MB/s']:.1f} MB/s; launches "
              f"{by_part['15e']}; spans {spans['15e']}; then `config rm`; {card}", flush=True)

        # 15f: RGW objects; the scrub timer set centrally deep-scrubs a PG
        before = await begin("15f")
        rgw_names = [f"default.5921.7__shadow_.{i:04x}_0" for i in range(M_RGW_OBJECTS)]
        reps = await run_ops([(n, [op("WRITEFULL", data=payload(i))])
                              for i, n in enumerate(rgw_names)], M_QD, pool="rgw_data")
        check(all(r.result == 0 for r in reps), "15f: an rgw_data write failed")
        rgw = c.osdmap.get_pool("rgw_data")
        pg = max((p for p in c.primaries() if p.pool.id == rgw.id),
                 key=lambda p: len(p.list_heads()))
        daemon = next(o for o in c.running() if o.pgs.get((pg.pool.id, pg.ps)) is pg)
        t = time.perf_counter()
        await c.config_set("osd", "osd_deep_scrub_interval", M_SCRUB_INTERVAL)
        await c.config_set(f"osd.{daemon.whoami}", "osd_scrub_interval", M_SCRUB_INTERVAL)
        await host.wait_until(lambda: pg.scrubber.last_result is not None
                              and pg.scrubber.last_result.deep, 60.0, "the timer's deep scrub")
        out["15f s to deep scrub"] = time.perf_counter() - t
        await c.command({"prefix": "config rm", "who": f"osd.{daemon.whoami}",
                         "name": "osd_scrub_interval"})
        await c.command({"prefix": "config rm", "who": "osd", "name": "osd_deep_scrub_interval"})
        await host.wait_until(lambda: daemon.conf.get("osd_scrub_interval") == 0.0, 30.0,
                              "the timer off")
        await host.wait_until(lambda: all(not p.scrubber.active for p in c.primaries()), 60.0,
                              "the timer's scrubs")
        r = pg.scrubber.last_result
        check(not r.aborted and r.errors == 0 and r.objects_scrubbed > 0,
              f"15f: deep scrub of {pg.pgid}: {r}")
        await done("15f", before)
        print(f"[15] 15f: {M_RGW_OBJECTS} rgw_data objects; `config set osd "
              f"osd_deep_scrub_interval {M_SCRUB_INTERVAL}` and osd.{daemon.whoami}'s "
              f"osd_scrub_interval through ConfigMonitor: pg {pg.pgid} ({r.objects_scrubbed} "
              f"objects) deep-scrubbed clean {out['15f s to deep scrub']:.3f} s later; "
              f"launches {by_part['15f']}; spans {spans['15f']}; {card}", flush=True)

        # 15g: a launch fault through injectargs; TPU_BACKEND_DEGRADED through the mgr
        before = await begin("15g")
        oid = "rbd_data.mon_drill"
        primary = cl.target("rbd", oid)[1]
        await c.asok(primary, "injectargs", point="codec.launch", error=5, hits=1)
        rep = await cl.op("rbd", oid, [op("WRITEFULL", data=payload(1))])
        check(rep.result == -5, f"15g: the faulted write answered {rep.result}, not -EIO")
        out["15g s to TPU_BACKEND_DEGRADED"] = await health_has(
            "TPU_BACKEND_DEGRADED", True, 30.0)
        detail = (await c.health())["detail"].get("TPU_BACKEND_DEGRADED", [])
        await c.asok(primary, "injectargs", clear=True)
        t = time.perf_counter()
        refused = 0
        while True:
            rep = await cl.op("rbd", oid, [op("WRITEFULL", data=payload(1))])
            if rep.result == 0 or time.perf_counter() - t > 30.0:
                break
            refused += 1
            await asyncio.sleep(0.1)
        check(rep.result == 0 and not guard.degraded,
              f"15g: the write after the clear answered {rep.result}")
        out["15g s to heal"] = time.perf_counter() - t
        out["15g s heal to clear"] = await health_has("TPU_BACKEND_DEGRADED", False, 30.0)
        rep = await cl.op("rbd", oid, [op("READ", off=0, len=0)])
        check(rep.result == 0 and rep.outdata[0] == payload(1), "15g: the drill object reads wrong")
        await done("15g", before)
        print(f"[15] 15g: codec.launch armed on osd.{primary}: EIO; TPU_BACKEND_DEGRADED in "
              f"`ceph health` through the mgr's digest {out['15g s to TPU_BACKEND_DEGRADED']:.3f} s "
              f"after the failed write ({len(detail)} detail lines); the probe healed the guard "
              f"{out['15g s to heal']:.3f} s after the clear ({refused} writes refused), and "
              f"the check cleared {out['15g s heal to clear']:.3f} s after the heal; {card}",
              flush=True)

        statuses = [c.status(o.whoami) for o in c.running()]
        check(all(s["tpu_backend"]["fallback_launches"] == 0 for s in statuses),
              "15: a daemon's status blob reads fallback launches")
        check(dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fallback0,
              "15: a launch fell back to the host")
        out["epochs"] = c.osdmap.epoch
        out["elections"] = elections
        out["lease elections"] = sum(m.lease_elections for m in c.monitors)
        out["late lease ticks"] = sum(m.lease_stalls for m in c.monitors)
        out["late election timers"] = sum(m.elector.late_timeouts for m in c.monitors)
        out["monclient failed passes"] = sum(o.monc.hunt_failures for o in c.running())
        out["late heartbeat ticks"] = sum(o.heartbeat_stalls for o in c.running())
        out["monclient hunts"] = sum(o.monc.hunts for o in c.running())
        print(f"[15] elections by part {elections}; lease elections "
              f"{out['lease elections']}, late lease ticks {out['late lease ticks']}, late "
              f"election timers {out['late election timers']}; daemons "
              f"marked down besides osd.{M_VICTIM}: none; {out['epochs']} map epochs; "
              f"{out['late heartbeat ticks']} heartbeat ticks judged no peer (late); "
              f"{out['monclient hunts']} MonClient hunts "
              f"({out['monclient failed passes']} failed passes)", flush=True)
    finally:
        await c.stop()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    totals = {k: sum(part[k] for part in by_part.values()) for k in M_KERNELS}
    check(totals == counts(), f"15: launches {counts()} != the parts' sum {totals}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[15] launches by part {by_part}; spans by part {json.dumps(spans)}; figures "
          f"{json.dumps(out)}", flush=True)
    return {"launches": totals, "by_part": by_part, "figures": out, "spans": spans}


R_MONS = 3
R_OSDS = 12
R_VICTIM = 3
R_OBJECTS = 32  # on rbd: half at QD1, half at QD8
R_OBJECT_BYTES = 4 << 20  # RBD's default object size
R_QD = 8
R_IMAGE_BYTES = 64 << 20  # the striped image (cut)
R_LIMIT_S = 150.0
R_KERNELS = ("swar_gf", "packed_verify", "packed_delta", "crc32c")
R_REACHES = {"16a": (), "16b": ("swar_gf",), "16c": ("swar_gf",), "16d": (),
             "16e": ("swar_gf",)}
# the scrape's families that must carry a nonzero sample, and the part that
# checks each (the storm controllers count only once an OSD fails)
R_FAMILIES = {"ceph_tpu_ec_dispatch_": "16d", "ceph_tpu_ec_aggregator_": "16d",
              "ceph_tpu_trace_": "16d", "ceph_tpu_recovery_storm_": "16e"}
R_RATE_TOLERANCE = 0.2  # history vs counters: the mgr's 1 s ticks against a part's edges


def phase_client(torch, swar, packed, co, card, device=None) -> dict:
    """Phase 16: the port's librados and the mgr's modules on phase 15's
    cluster."""
    import asyncio

    return asyncio.run(_phase_client(torch, swar, packed, co, card, device))


def mgr_modules(mgr) -> dict:
    """The modules vstart registers, plus the balancer and the autoscaler
    in their default modes (advise, warn), on `mgr`: name -> module."""
    from ceph_tpu_torch import mgr as m
    from ceph_tpu_torch.mgr.balancer import BalancerModule
    from ceph_tpu_torch.mgr.pg_autoscaler import PgAutoscalerModule
    from ceph_tpu_torch.mgr.prometheus import PrometheusModule

    mods = {}
    for module in (PrometheusModule(), m.DashboardModule(), m.TelemetryModule(),
                   m.OrchestratorModule(), m.ProgressModule(), m.IostatModule(),
                   m.MetricsHistoryModule(), m.ClogModule(), BalancerModule(),
                   PgAutoscalerModule()):
        mgr.register_module(module)
        mods[module.NAME] = module
    return mods


async def _phase_client(torch, swar, packed, co, card, device) -> dict:
    import asyncio
    import tempfile
    import urllib.request

    from ceph_tpu_torch.client import Rados, RadosError
    from ceph_tpu_torch.cls import client as cls_client
    from ceph_tpu_torch.common.admin_socket import admin_command
    from ceph_tpu_torch.ops import dispatch
    from ceph_tpu_torch.ops.guard import device_guard
    from ceph_tpu_torch.striper import StripedObject, StripePolicy

    host = load_test_host("torch_daemon_host")
    lint = load_test_host("torch_metrics_lint").lint_exposition
    guard = device_guard()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_client_")
    c = host.DaemonCluster("ceph_tpu_torch", R_OSDS, PG_POOLS, conf={**D_CONF, **PG_CONF},
                           device=device, stack="posix", keyring=True, root_dir=tmp,
                           store="bluestore", admin_sockets=True, mons=R_MONS,
                           mon_conf=M_MON_CONF)
    rados = None
    mods: dict = {}
    by_part: dict = {}
    out: dict = {}
    seen: dict = {"events": set(), "storms": set(), "done": set(), "checks": set(),
                  "last": {}, "storm_last": {}}

    def counts() -> dict:
        return {"swar_gf": swar.launches, "packed_verify": packed.launches["packed_verify"],
                "packed_delta": packed.launches["packed_delta"],
                "crc32c": co.crc32c_device.launches}

    def done(part: str, before: dict) -> None:
        torch.cuda.synchronize()
        now = counts()
        by_part[part] = {k: now[k] - before[k] for k in R_KERNELS}
        for kernel in R_REACHES[part]:
            check(by_part[part][kernel] > 0, f"{part}: no {kernel} launch ({by_part[part]})")
        c.raise_failed_monitor()
        check(c.mgr.failed is None, f"{part}: the mgr stopped on {c.mgr.failed!r}")
        check(not guard.degraded, f"{part}: the device guard is degraded")

    async def mgr_asok(prefix: str, **kw):
        path = c.mgr.conf.get("admin_socket")
        return await asyncio.get_running_loop().run_in_executor(
            None, lambda: admin_command(path, prefix, timeout=30.0, **kw))

    async def scrape() -> dict:
        url = f"http://{mods['prometheus'].addr}/metrics"
        text = await asyncio.get_running_loop().run_in_executor(
            None, lambda: urllib.request.urlopen(url, timeout=30).read().decode())
        return lint(text)  # tests/test_metrics_lint.py's rules

    def nonzero(families: dict, prefix: str) -> bool:
        return any(float(v) != 0.0 for name, fam in families.items() if name.startswith(prefix)
                   for _n, _l, v in fam["samples"])

    def watch_progress() -> None:
        digest = mods["progress"].progress_digest()
        reporters: dict = {}
        for daemon in c.mgr.list_daemons():
            for pgid, evs in (c.mgr.get_daemon_status(daemon).get("progress") or {}).items():
                for ev in evs:
                    reporters.setdefault((pgid, ev.get("kind")), []).append(daemon)
        for ev in digest["events"]:
            key = (ev["pgid"], ev["kind"])
            seen["events"].add(key)
            seen["last"][key] = (ev["objects_done"], ev["objects_total"],
                                 reporters.get(key, []))
            if ev["objects_total"] and ev["objects_done"] >= ev["objects_total"]:
                seen["done"].add(key)
        for ev in digest["storms"]:
            seen["storms"].add(ev["pgid"])
            seen["storm_last"][ev["pgid"]] = (ev["objects_done"], ev["objects_total"])
        seen["checks"].update(code for code in c.mgr.health_checks()
                              if code == "PG_RECOVERY_STALLED" or code.startswith("TPU_"))

    rng = np.random.default_rng(SEED + 160)
    base = rng.integers(0, 256, 2 * R_OBJECT_BYTES, dtype=np.uint8)
    names = [f"rbd_data.5c1e97a3d42.{i:016x}" for i in range(R_OBJECTS)]

    def payload(i: int) -> bytes:
        off = (i * 65537) % R_OBJECT_BYTES
        return base[off:off + R_OBJECT_BYTES].tobytes()

    def describe(oid: str) -> str:
        """Where an object stands for the client and for every daemon: its
        PG, the client's map and connection, the PG on each daemon, and
        the primary's ops in flight."""
        obj = rados.objecter
        om = obj.osdmap
        pool_id = om.get_pool("rbd").id
        pgid, primary = obj._calc_target(pool_id, oid)
        info = om.osds.get(primary)
        conn = obj.msgr._conns.get(info.addr) if info is not None else None
        lines = [f"{oid}: pg {pgid}, the client's primary osd.{primary} at epoch {om.epoch}, "
                 f"the monitors' osd.{c.osdmap.pg_to_up_acting_osds(pool_id, pgid.ps)[3]} "
                 f"at {c.osdmap.epoch}; client connection "
                 f"{None if conn is None else (conn._closed, conn._out_seq, conn._dead_until)}; "
                 f"Objecter resends {obj.perf.get('op_resend')}, timeouts "
                 f"{obj.perf.get('op_timeout')}; guard degraded {guard.degraded}"]
        key = (pgid.pool, pgid.ps)
        for o in c.running():
            pg = o.pgs.get(key) or o.strays.get(key)
            if pg is not None:
                p = pg.peering
                lines.append(f"  osd.{o.whoami}{' (stray)' if key in o.strays else ''}: "
                             f"{p.state.value} epoch {o.osdmap.epoch} acting {list(p.acting)} "
                             f"primary {p.primary} clean {pg.is_clean} missing "
                             f"{oid in p.missing.items} recovering {oid in pg.recovering}")
            if o.whoami == primary:
                lines.append(f"  osd.{o.whoami} ops in flight: {o.op_tracker.dump_in_flight()}")
        return "\n".join(lines)

    async def batch(calls, oids):
        """One QD batch; on a failure, where each object stood, then the
        failure."""
        try:
            return await asyncio.gather(*calls)
        except (TimeoutError, RadosError):
            for oid in oids:
                print(f"[16] {describe(oid)}", flush=True)
            raise

    async def write(io, idx, qd: int) -> float:
        t = time.perf_counter()
        for lo in range(0, len(idx), qd):
            part = idx[lo:lo + qd]
            await batch([io.write_full(names[i], payload(i)) for i in part],
                        [names[i] for i in part])
        return len(idx) * R_OBJECT_BYTES / (time.perf_counter() - t) / 1e6

    async def read_back(io, idx) -> float:
        t = time.perf_counter()
        for lo in range(0, len(idx), R_QD):
            part = idx[lo:lo + R_QD]
            got = await batch([io.read(names[i]) for i in part], [names[i] for i in part])
            for i, blob in zip(part, got):
                check(blob == payload(i), f"16: {names[i]} read back wrong")
        return len(idx) * R_OBJECT_BYTES / (time.perf_counter() - t) / 1e9

    def recovered() -> int:
        return sum(io.get("recovery", {}).get("bytes", 0) for o in c.running()
                   for io in o.io_accountant.dump_pools().values())

    swar.launches = 0
    for name in ("packed_code", "packed_verify", "packed_delta"):
        packed.launches[name] = 0
    co.crc32c_device.launches = 0
    fallback0 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
    try:
        # 16a: the cluster, the mgr's modules, Rados.connect, every PG clean
        before = counts()
        out["16a s to clean"] = await c.start(180)
        mods = mgr_modules(c.mgr)
        c.mgr.conf.set("admin_socket", os.path.join(tmp, "mgr.x.asok"))
        await c.mgr._start_admin_socket()
        await mods["prometheus"].serve("127.0.0.1")
        t = time.perf_counter()
        rados = Rados(c.monmap, name="client.admin", secret=c.keyring.get("client.admin"),
                      stack="posix")
        await rados.connect(30.0)
        out["16a s to connect"] = time.perf_counter() - t
        rbd = await rados.open_ioctx("rbd")
        meta = await rados.open_ioctx("rbd_meta")
        check(all(pg.backend.ec.device.type == "cuda" for o in c.osds
                  for pg in o.pgs.values() if hasattr(pg.backend, "ec")),
              "16a: an EC PG's codec is not on the card")
        done("16a", before)
        print(f"[16] 16a: {R_MONS} monitors, mgr.x with {len(mods)} modules "
              f"({', '.join(sorted(mods))}), {R_OSDS} OSD daemons, every PG clean "
              f"{out['16a s to clean']:.3f} s after the first start; Rados.connect "
              f"{out['16a s to connect']:.3f} s; prometheus at {mods['prometheus'].addr}; "
              f"{card}", flush=True)

        # 16b: WRITEFULLs through IoCtx at QD1 and QD8, read back
        before = counts()
        # the module stamps its samples with time.monotonic()
        launches0, t_b = dispatch.LAUNCHES.snapshot()["launches"], time.monotonic()
        half = R_OBJECTS // 2
        resends0 = rados.objecter.perf.get("op_resend")
        out["16b QD1 MB/s"] = await write(rbd, list(range(half)), 1)
        out["16b QD8 MB/s"] = await write(rbd, list(range(half, R_OBJECTS)), R_QD)
        resends = int(rados.objecter.perf.get("op_resend") - resends0)
        out["16b read GB/s"] = await read_back(rbd, list(range(R_OBJECTS)))
        rbd_id = str(rados.objecter.osdmap.get_pool("rbd").id)

        def rbd_writes() -> int:
            return mods["iostat"].iostat().get(rbd_id, {}).get("write_ops", 0)

        try:
            await host.wait_until(lambda: rbd_writes() >= R_OBJECTS, 30.0, "iostat's rbd writes")
        except TimeoutError:
            pass  # the check below says what was counted
        await asyncio.sleep(2.0)  # later reports may not add a write
        out["16b iostat rbd write ops"] = rbd_writes()
        out["16b Objecter resends"] = resends
        check(out["16b iostat rbd write ops"] == R_OBJECTS,
              f"16b: iostat counts {out['16b iostat rbd write ops']} rbd writes; the client "
              f"issued {R_OBJECTS} and resent {resends}")
        top = await mgr_asok("iostat top")
        check(any(row["client"].startswith("client.admin") for row in top["clients"]),
              f"16b: `iostat top` lists no client.admin: {top}")
        done("16b", before)
        print(f"[16] 16b: {R_OBJECTS} IoCtx.write_full of {R_OBJECT_BYTES >> 10} KiB on rbd: "
              f"{out['16b QD1 MB/s']:.1f} MB/s at QD1, {out['16b QD8 MB/s']:.1f} MB/s at QD8; "
              f"read back byte-exact {out['16b read GB/s']:.3f} GB/s; iostat's rbd write ops "
              f"{out['16b iostat rbd write ops']} of {R_OBJECTS} writes issued, "
              f"{resends} resent; `iostat top` lists "
              f"{sorted({r['client'] for r in top['clients']})}; launches {by_part['16b']}; "
              f"{card}", flush=True)

        # 16c: a striped RBD image, its header's lock and a cls log round trip
        before = counts()
        image = rng.integers(0, 256, R_IMAGE_BYTES, dtype=np.uint8).tobytes()
        so = StripedObject(rbd, "rbd_data.img16", StripePolicy(
            stripe_unit=R_OBJECT_BYTES, stripe_count=1, object_size=R_OBJECT_BYTES))
        t = time.perf_counter()
        await so.write(image, 0)
        out["16c image write MB/s"] = R_IMAGE_BYTES / (time.perf_counter() - t) / 1e6
        t = time.perf_counter()
        back = await so.read(0, 0)
        out["16c image read MB/s"] = R_IMAGE_BYTES / (time.perf_counter() - t) / 1e6
        check(back == image and await so.size() == R_IMAGE_BYTES, "16c: the image reads wrong")
        header = "rbd_header.img16"
        await meta.write_full(header, b"")
        await cls_client.lock(meta, header, "rbd_lock", cookie="auto 16")
        info = await cls_client.get_lock_info(meta, header, "rbd_lock")
        check(info["type"] == "exclusive" and len(info["holders"]) == 1, f"16c: lock {info}")
        await cls_client.unlock(meta, header, "rbd_lock", cookie="auto 16")
        check(not (await cls_client.get_lock_info(meta, header, "rbd_lock"))["holders"],
              "16c: the lock is still held")
        entries = [{"ts": 1700000000.0 + i, "section": "image", "name": "img16",
                    "data": f"resize {i}"} for i in range(4)]
        await meta.exec("rbd_log.img16", "log", "add", json.dumps({"entries": entries}).encode())
        listed = json.loads(await meta.exec("rbd_log.img16", "log", "list", b"{}"))
        check([e["data"] for e in listed["entries"]] == [e["data"] for e in entries],
              f"16c: cls log lists {listed}")
        t_c = time.monotonic()
        launches1 = dispatch.LAUNCHES.snapshot()["launches"]
        done("16c", before)
        print(f"[16] 16c: a {R_IMAGE_BYTES >> 20} MiB image striped over "
              f"{R_IMAGE_BYTES // R_OBJECT_BYTES} objects of {R_OBJECT_BYTES >> 10} KiB: write "
              f"{out['16c image write MB/s']:.1f} MB/s, read back byte-exact "
              f"{out['16c image read MB/s']:.1f} MB/s; cls lock and unlock on {header}; cls log "
              f"add and list ({len(entries)} entries); launches {by_part['16c']}; {card}",
              flush=True)

        # 16d: the scrape, and osd.0's launch history against the counters
        before = counts()
        await asyncio.sleep(2.5)  # the mgr's module ticks past 16c's last reports
        families = await scrape()
        for prefix, part in R_FAMILIES.items():
            check(any(name.startswith(prefix) for name in families),
                  f"16d: the scrape has no {prefix}* family")
            if part == "16d":
                check(nonzero(families, prefix), f"16d: every {prefix}* sample is 0")
        mh = mods["metrics_history"]
        window = time.monotonic() - t_b + 5.0

        def inside(daemon=None) -> list:
            # the 1 s buckets wholly inside 16b-16c
            got = mh.history_get("launches_per_sec", daemon=daemon, window=window)["points"]
            return [v for t, v in got if v is not None and t_b <= t and t + 1.0 <= t_c]

        points, cluster = inside("osd.0"), inside()
        counted = (launches1 - launches0) / (t_c - t_b)
        history = statistics.fmean(points) if points else 0.0
        out["16d counters launches/s"] = counted
        out["16d osd.0 history launches/s"] = history
        out["16d cluster/osd.0 launches"] = (statistics.fmean(cluster) / statistics.fmean(points)
                                             if points and statistics.fmean(points) else None)
        check(abs(history - counted) <= R_RATE_TOLERANCE * counted,
              f"16d: osd.0's launches_per_sec {history:.2f} vs the counters' {counted:.2f}")
        done("16d", before)
        print(f"[16] 16d: scrape of {len(families)} families passes test_metrics_lint's "
              f"rules; osd.0's launches_per_sec over 16b-16c {history:.2f} /s against the "
              f"dispatch counters' {counted:.2f} /s; the cluster series reads "
              f"{out['16d cluster/osd.0 launches']} times osd.0's (every daemon reports the "
              f"process's counters); {card}", flush=True)

        # 16e: osd.3 out by a mon command from Rados, rebuilt to clean, watched by progress
        before = counts()
        prog = mods["progress"]
        completed0, expired0 = prog.completed, prog.expired
        rec0 = recovered()
        t = time.perf_counter()
        rv, rs, _ = await rados.mon_command({"prefix": "osd out", "id": R_VICTIM})
        check(rv == 0, f"16e: osd out answered {rv} {rs}")

        async def watcher():
            while True:
                watch_progress()
                await asyncio.sleep(0.1)

        w = asyncio.ensure_future(watcher())
        try:
            await host.wait_until(lambda: c.osdmap.osds[R_VICTIM].weight == 0, 30.0, "the out")
            await c.wait_clean(180)
            out["16e s out to clean"] = time.perf_counter() - t
            rebuilt = recovered() - rec0
            out["16e rebuilt bytes"] = rebuilt
            out["16e recovery MB/s"] = rebuilt / out["16e s out to clean"] / 1e6
            await host.wait_until(lambda: not prog.events and not prog.storms
                                  and prog.completed > completed0, 30.0,
                                  "progress's events to finish")
        finally:
            w.cancel()
        watch_progress()
        out["16e events"] = len(seen["events"])
        out["16e events done"] = len(seen["done"])
        out["16e storm bars"] = sorted(seen["storms"])
        out["16e completed"] = prog.completed - completed0
        out["16e expired"] = prog.expired - expired0
        out["16e checks raised"] = sorted(seen["checks"])
        # the recoveries last seen below their total (a backfill's or a
        # scrub's vanishing is its completion)
        below = {f"{k[0]}:{k[1]}": v for k, v in seen["last"].items()
                 if k not in seen["done"] and k[1] == "recovery"}
        out["16e events below total"] = below
        out["16e storm bars last"] = seen["storm_last"]
        check(seen["events"] and seen["storms"], f"16e: progress saw events "
              f"{len(seen['events'])}, storm bars {sorted(seen['storms'])}")
        # the out's whole-OSD rebuild: its bar reached done == total, so
        # the module counted it completed when it vanished
        check(all(done >= total > 0 for done, total in seen["storm_last"].values()),
              f"16e: a storm bar vanished below its total: {seen['storm_last']}")
        check(out["16e expired"] == 0 and out["16e completed"] > 0,
              f"16e: progress counted {out['16e completed']} completed, "
              f"{out['16e expired']} expired; events below total {below}")
        check(seen["done"], "16e: no event reached done == total")
        out["16e read GB/s"] = await read_back(rbd, list(range(R_OBJECTS)))
        families = await scrape()
        check(nonzero(families, "ceph_tpu_recovery_storm_"),
              "16e: every ceph_tpu_recovery_storm_* sample is 0")
        ls = await mgr_asok("perf history ls")
        got = await mgr_asok("perf history get", series="launches_per_sec", window="600")
        check(ls and got.get("points"), f"16e: perf history answered {ls} / {got}")
        fallback = mh.history_get("fallback_per_sec", window=600.0, aggregate="max")["points"]
        check(all(not v for _t, v in fallback), f"16e: fallback_per_sec {fallback}")
        done("16e", before)
        detail = {code: c.mgr.health_checks().get(code) for code in seen["checks"]}
        print(f"[16] 16e: `osd out {R_VICTIM}` from Rados: clean "
              f"{out['16e s out to clean']:.3f} s later, {rebuilt} bytes rebuilt "
              f"({out['16e recovery MB/s']:.1f} MB/s); progress: {out['16e events']} events "
              f"({out['16e events done']} reached done == total), storm bars "
              f"{out['16e storm bars']} (last {seen['storm_last']}), "
              f"{out['16e completed']} completed, {out['16e expired']} expired (below total: "
              f"{below}); checks raised {out['16e checks raised']} "
              f"{detail}; `perf history ls` {len(ls.get('series', ls))} series; "
              f"launches {by_part['16e']}; {card}", flush=True)

        statuses = [c.status(o.whoami) for o in c.running()]
        check(all(s["tpu_backend"]["fallback_launches"] == 0 for s in statuses),
              "16: a daemon's status blob reads fallback launches")
        check(dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fallback0,
              "16: a launch fell back to the host")
        check(c.client._tid == 0, "16: an op went through the test host's client")
    finally:
        if rados is not None:
            await rados.shutdown()
        for module in mods.values():
            if hasattr(module, "shutdown"):
                await module.shutdown()
        await c.stop()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    totals = {k: sum(part[k] for part in by_part.values()) for k in R_KERNELS}
    check(totals == counts(), f"16: launches {counts()} != the parts' sum {totals}")
    out["seconds"] = time.perf_counter() - t_phase
    check(out["seconds"] <= R_LIMIT_S, f"16: {out['seconds']:.1f} s, over {R_LIMIT_S} s")
    print(f"[16] launches by part {by_part}; figures {json.dumps(out)}", flush=True)
    return {"launches": totals, "by_part": by_part, "figures": out}


A_MONS = 3
A_OSDS = 12
A_VICTIM = 3
A_ORDER = 22  # RBD's default: 4 MiB objects
A_IMAGE_BYTES = 128 << 20
A_QD = 8
A_OVERWRITES = 256
A_OVERWRITE_BYTES = (4 << 10, 64 << 10)
A_SNAP_WRITES = 8  # writes after the snapshot, 64 KiB each
A_MIRROR_BYTES = 32 << 20
A_MIRROR_WRITES = 16
A_MIRROR_WRITE = 1 << 20
A_S3_OBJECTS = 32  # half at QD1, half at QD8
A_S3_BYTES = 4 << 20
A_RANGED = 32  # ranged reads of A_RANGE_BYTES
A_RANGE_BYTES = 1 << 20
A_MULTIPART_BYTES = 32 << 20
A_PART_BYTES = 8 << 20
A_SWIFT_OBJECTS = 8
A_SWIFT_BYTES = 1 << 20
A_DEGRADED_GETS = 8
A_FS_FILES = 64
A_FS_DIRS = 8
A_FS_BYTES = (256 << 10, 4 << 20)
# RGW's and CephFS's documented defaults (rgw_obj_stripe_size 4 MiB; a file
# layout of stripe_unit = object_size = 4 MiB, stripe_count 1), where the
# reference's classes default to 512 KiB and 64 KiB stripe units
A_STRIPE = 4 << 20
# rbd-mirror's destination: phase 13's rbd shape at pg_num 8 (cut)
A_POOLS = PG_POOLS + [
    {"name": "rbd_peer", "kind": "ec", "k": 8, "m": 3, "pg_num": 8, "stripe_unit": 4096,
     "overwrites": True, "profile": {"technique": "reed_sol_van"}},
]
A_MON_CONF: dict = {}  # Ceph's down-out interval: 17c's degraded GETs decode, none rebuilds
# Ceph's heartbeat interval and grace (phases 14-16 cut them to 0.25 s and
# 1.5 s): every daemon ticks its PGs and reports to the mgr each heartbeat,
# work that grows with the objects stored and that phase 17 does not measure
A_CONF = {**D_CONF, **PG_CONF, "osd_heartbeat_interval": 1.0, "osd_heartbeat_grace": 6.0}
A_LIMIT_S = 400.0
A_KERNELS = ("swar_gf", "packed_verify", "packed_delta", "crc32c")
A_REACHES = {"17a": ("swar_gf",), "17b": ("swar_gf",), "17c": ("swar_gf",),
             "17d": ("swar_gf",)}


async def http_call(addr: str, method: str, path: str, headers: dict | None = None,
                    body: bytes = b"") -> tuple:
    """One HTTP/1.1 request to 127.0.0.1: (status, headers, body)."""
    import asyncio

    host, port = addr.rsplit(":", 1)
    reader, writer = await asyncio.open_connection(host, int(port))
    try:
        head = [f"{method} {path} HTTP/1.1", f"Host: {addr}",
                *(f"{k}: {v}" for k, v in (headers or {}).items()),
                f"Content-Length: {len(body)}"]
        writer.write(("\r\n".join(head) + "\r\n\r\n").encode() + body)
        await writer.drain()
        raw = await reader.read()
    finally:
        writer.close()
    top, _, payload = raw.partition(b"\r\n\r\n")
    lines = top.decode().split("\r\n")
    hdrs = dict(line.split(": ", 1) for line in lines[1:] if ": " in line)
    return int(lines[0].split()[1]), hdrs, payload


def phase_access(torch, swar, packed, co, card, device=None) -> dict:
    """Phase 17: RBD, rbd-mirror, RGW over S3 and Swift, and the `fs`
    library, on phase 16's cluster built anew."""
    import asyncio

    return asyncio.run(_phase_access(torch, swar, packed, co, card, device))


async def _phase_access(torch, swar, packed, co, card, device) -> dict:
    import asyncio
    import tempfile
    from email.utils import formatdate

    from ceph_tpu_torch.client import Rados
    from ceph_tpu_torch.fs import FileSystem
    from ceph_tpu_torch.ops import dispatch
    from ceph_tpu_torch.ops.guard import device_guard
    from ceph_tpu_torch.rbd import RBD, JournaledImage, MirrorDaemon, enable_journaling
    from ceph_tpu_torch.rgw import ObjectGateway, S3Server, SwiftServer
    from ceph_tpu_torch.rgw.http import sign_v2
    from ceph_tpu_torch.striper import StripedObject, StripePolicy

    host = load_test_host("torch_daemon_host")
    guard = device_guard()
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_access_")
    c = host.DaemonCluster("ceph_tpu_torch", A_OSDS, A_POOLS, conf=A_CONF,
                           device=device, stack="posix", keyring=True, root_dir=tmp,
                           store="bluestore", admin_sockets=True, mons=A_MONS,
                           mon_conf=A_MON_CONF)
    rados = s3 = swift = None
    mods: dict = {}
    by_part: dict = {}
    by_step: dict = {}
    out: dict = {}
    rng = np.random.default_rng(SEED + 170)
    stripe = StripePolicy(stripe_unit=A_STRIPE, stripe_count=1, object_size=A_STRIPE)

    def counts() -> dict:
        return {"swar_gf": swar.launches, "packed_verify": packed.launches["packed_verify"],
                "packed_delta": packed.launches["packed_delta"],
                "crc32c": co.crc32c_device.launches}

    def delta(before: dict) -> dict:
        torch.cuda.synchronize()
        now = counts()
        return {k: now[k] - before[k] for k in A_KERNELS}

    def done(part: str, before: dict) -> None:
        by_part[part] = delta(before)
        for kernel in A_REACHES[part]:
            check(by_part[part][kernel] > 0, f"{part}: no {kernel} launch ({by_part[part]})")
        c.raise_failed_monitor()
        check(c.mgr.failed is None, f"{part}: the mgr stopped on {c.mgr.failed!r}")
        check(not guard.degraded, f"{part}: the device guard is degraded")

    def blob(n: int) -> bytes:
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    def mbs(nbytes: int, t0: float) -> float:
        return nbytes / (time.perf_counter() - t0) / 1e6

    async def step(name: str, nbytes: int, coro):
        """Run one step of a part: its MB/s and its launches."""
        before = counts()
        t = time.perf_counter()
        result = await coro
        out[f"{name} MB/s"] = mbs(nbytes, t)
        by_step[name] = {k: v for k, v in delta(before).items()
                         if k in ("swar_gf", "packed_delta")}
        return result

    swar.launches = 0
    for name in ("packed_code", "packed_verify", "packed_delta"):
        packed.launches[name] = 0
    co.crc32c_device.launches = 0
    fallback0 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
    try:
        out["17 s to clean"] = await c.start(180)
        mods = mgr_modules(c.mgr)
        rados = Rados(c.monmap, name="client.admin", secret=c.keyring.get("client.admin"),
                      stack="posix")
        await rados.connect(30.0)
        rbd_io = await rados.open_ioctx("rbd")
        meta_io = await rados.open_ioctx("rbd_meta")
        check(all(pg.backend.ec.device.type == "cuda" for o in c.osds
                  for pg in o.pgs.values() if hasattr(pg.backend, "ec")),
              "17: an EC PG's codec is not on the card")
        print(f"[17] {A_MONS} monitors, mgr.x with {len(mods)} modules, {A_OSDS} OSD "
              f"daemons on BlueStore, pools {[p['name'] for p in A_POOLS]}, every PG clean "
              f"{out['17 s to clean']:.3f} s after the first start; {card}", flush=True)

        # 17a: an RBD image on rbd: whole writes at QD1 and QD8, read back, random
        # overwrites, a snapshot, a clone's copy-up, a flatten, the export
        before = counts()
        rbd = RBD(rbd_io)
        await rbd.create("vol17", A_IMAGE_BYTES, order=A_ORDER)
        img = await rbd.open("vol17")
        ob = 1 << A_ORDER
        offs = list(range(0, A_IMAGE_BYTES, ob))
        model = bytearray(blob(A_IMAGE_BYTES))

        async def qd1():
            for off in offs:
                await img.write(off, bytes(model[off:off + ob]))

        await step("17a write QD1", A_IMAGE_BYTES, qd1())
        model = bytearray(blob(A_IMAGE_BYTES))

        async def qd8():
            for lo in range(0, len(offs), A_QD):
                await asyncio.gather(*(img.write(off, bytes(model[off:off + ob]))
                                       for off in offs[lo:lo + A_QD]))

        await step("17a write QD8", A_IMAGE_BYTES, qd8())

        async def read_all(image):
            parts = []
            for lo in range(0, len(offs), A_QD):
                parts += await asyncio.gather(*(image.read(off, ob) for off in offs[lo:lo + A_QD]))
            return b"".join(parts)

        back = await step("17a read", A_IMAGE_BYTES, read_all(img))
        check(back == bytes(model), "17a: the image reads back wrong")
        touched = []

        def plan(n: int, lo: int, hi: int) -> list:
            sizes = [int(rng.integers(lo, hi + 1)) for _ in range(n)]
            return [(int(rng.integers(0, A_IMAGE_BYTES - size)), blob(size)) for size in sizes]

        async def overwrite(writes: list, qd: int):
            # at most qd in flight, on distinct objects: each batch's
            # writes apply in any order
            batches, objs = [[]], [set()]
            for off, data in writes:
                mine = {o for o, _oo, _n in img._extents(off, len(data))}
                if len(batches[-1]) == qd or mine & objs[-1]:
                    batches.append([])
                    objs.append(set())
                batches[-1].append((off, data))
                objs[-1] |= mine
            for batch in batches:
                await asyncio.gather(*(img.write(off, data) for off, data in batch))
                for off, data in batch:
                    model[off:off + len(data)] = data
                    touched.append((off, len(data)))

        writes = plan(A_OVERWRITES, *A_OVERWRITE_BYTES)
        await step("17a overwrites", sum(len(d) for _o, d in writes), overwrite(writes, A_QD))
        await img.snap_create("s17")
        at_snap = bytes(model)
        await overwrite(plan(A_SNAP_WRITES, 64 << 10, 64 << 10), 1)
        for off, size in touched[-A_SNAP_WRITES:]:
            check(await img.read(off, size, snap_name="s17") == at_snap[off:off + size],
                  f"17a: the snapshot reads wrong at {off}")
            check(await img.read(off, size) == bytes(model[off:off + size]),
                  f"17a: the head reads wrong at {off} after the snapshot")
        await img.snap_protect("s17")
        await rbd.clone("vol17", "s17", "vol17c")
        child = await rbd.open("vol17c")
        child_model = bytearray(at_snap)
        off = int(rng.integers(0, A_IMAGE_BYTES - (64 << 10)))
        data = blob(64 << 10)
        await step("17a copy-up", len(data), child.write(off, data))
        child_model[off:off + len(data)] = data
        await step("17a flatten", A_IMAGE_BYTES, child.flatten())
        exported = await step("17a export", A_IMAGE_BYTES, child.export())
        # the export holds every overwrite (all made before the snapshot); the
        # writes after it were read at the head above
        check(exported == bytes(child_model), "17a: the clone's export differs from the model")
        check(await rbd.children("vol17", "s17") == [], "17a: the flattened clone is a child")
        done("17a", before)
        print(f"[17] 17a: a {A_IMAGE_BYTES >> 20} MiB image at order {A_ORDER} on rbd: write "
              f"{out['17a write QD1 MB/s']:.1f} MB/s at QD1, {out['17a write QD8 MB/s']:.1f} at "
              f"QD8, read back byte-exact {out['17a read MB/s']:.1f}; {A_OVERWRITES} overwrites "
              f"of 4-64 KiB {out['17a overwrites MB/s']:.2f} MB/s; snapshot, {A_SNAP_WRITES} "
              f"writes after it, reads at it byte-exact; clone, copy-up "
              f"{out['17a copy-up MB/s']:.2f} MB/s, flatten {out['17a flatten MB/s']:.1f} MB/s, "
              f"export equal to the model {out['17a export MB/s']:.1f} MB/s; launches by step "
              f"{ {k: v for k, v in by_step.items() if k.startswith('17a')} }; launches "
              f"{by_part['17a']}; {card}", flush=True)

        # 17b: rbd-mirror from rbd into rbd_peer
        before = counts()
        peer_io = await rados.open_ioctx("rbd_peer")
        await rbd.create("mir17", A_MIRROR_BYTES, order=A_ORDER)
        await enable_journaling(rbd, "mir17")
        ji = await JournaledImage.open(rbd, "mir17")
        daemon = MirrorDaemon(rbd_io, peer_io)
        check((await daemon.sync_once())["mir17"] == 0, "17b: the bootstrap pass replayed events")
        mirror_model = bytearray(A_MIRROR_BYTES)
        t = time.perf_counter()
        for _ in range(A_MIRROR_WRITES):
            off = int(rng.integers(0, A_MIRROR_BYTES - A_MIRROR_WRITE))
            data = blob(A_MIRROR_WRITE)
            await ji.write(off, data)
            mirror_model[off:off + A_MIRROR_WRITE] = data
        out["17b journaled write MB/s"] = mbs(A_MIRROR_WRITES * A_MIRROR_WRITE, t)
        t = time.perf_counter()
        replayed = await daemon.sync_once()
        out["17b s last write to equal"] = time.perf_counter() - t
        out["17b replay MB/s"] = A_MIRROR_WRITES * A_MIRROR_WRITE / out["17b s last write to equal"] / 1e6
        check(replayed["mir17"] == A_MIRROR_WRITES, f"17b: replayed {replayed}")
        dst = await RBD(peer_io).open("mir17")
        check(await dst.export() == bytes(mirror_model) == await ji.image.export(),
              "17b: the mirror differs from the source")
        done("17b", before)
        print(f"[17] 17b: a journaled {A_MIRROR_BYTES >> 20} MiB image, {A_MIRROR_WRITES} "
              f"writes of {A_MIRROR_WRITE >> 20} MiB ({out['17b journaled write MB/s']:.1f} MB/s "
              f"with the journal); MirrorDaemon.sync_once replayed {replayed['mir17']} events "
              f"into rbd_peer, equal to the source {out['17b s last write to equal']:.3f} s after "
              f"the last write ({out['17b replay MB/s']:.1f} MB/s); launches {by_part['17b']}; "
              f"{card}", flush=True)

        # 17d: the fs library, metadata on rbd_meta, data on rbd
        before = counts()
        fs = FileSystem(meta_io, rbd_io, layout=stripe)
        await fs.mkfs()
        for d in range(A_FS_DIRS):
            await fs.mkdir(f"/d{d}")
        files = {f"/d{i % A_FS_DIRS}/f{i}": blob(int(rng.integers(A_FS_BYTES[0],
                                                                  A_FS_BYTES[1] + 1)))
                 for i in range(A_FS_FILES)}
        total = sum(len(v) for v in files.values())

        async def fs_write():
            for path, data in files.items():
                await fs.write_file(path, data)

        async def fs_read():
            paths = list(files)
            for lo in range(0, len(paths), A_QD):
                got = await asyncio.gather(*(fs.read_file(p) for p in paths[lo:lo + A_QD]))
                for path, data in zip(paths[lo:lo + A_QD], got):
                    check(data == files[path], f"17d: {path} reads back wrong")

        await step("17d write", total, fs_write())
        listed = [len(await fs.listdir(f"/d{d}")) for d in range(A_FS_DIRS)]
        check(sum(listed) == A_FS_FILES, f"17d: listed {listed}")
        await step("17d read", total, fs_read())
        t = time.perf_counter()
        await fs.mkdir("/moved")
        for path in files:
            await fs.rename(path, "/moved/" + path.replace("/", "_"))
        out["17d renames/s"] = A_FS_FILES / (time.perf_counter() - t)
        left = [len(await fs.listdir(f"/d{d}")) for d in range(A_FS_DIRS)]
        check(len(await fs.listdir("/moved")) == A_FS_FILES and not any(left),
              f"17d: after the renames /moved lists {len(await fs.listdir('/moved'))}, the "
              f"directories {left}")
        for path, data in list(files.items())[:4]:
            check(await fs.read_file("/moved/" + path.replace("/", "_")) == data,
                  f"17d: {path} reads wrong after its rename")
        done("17d", before)
        print(f"[17] 17d: {A_FS_FILES} files of {A_FS_BYTES[0] >> 10} KiB-{A_FS_BYTES[1] >> 20} "
              f"MiB ({total} bytes) in {A_FS_DIRS} directories, metadata on rbd_meta, data on "
              f"rbd: write {out['17d write MB/s']:.1f} MB/s, listed, read back byte-exact "
              f"{out['17d read MB/s']:.1f} MB/s, renamed {out['17d renames/s']:.1f}/s; launches "
              f"{by_part['17d']}; {card}", flush=True)

        # 17c: RGW on rgw_data over S3 (sign_v2) and Swift, then degraded GETs
        before = counts()
        gw_io = await rados.open_ioctx("rgw_data")
        gw = ObjectGateway(gw_io, policy=stripe)
        s3 = S3Server(gw, require_auth=True)
        addr = await s3.serve("127.0.0.1")
        user = await gw.create_user("alice")

        async def s3_call(method, path, body=b""):
            date = formatdate(time.time(), usegmt=True)
            sig = sign_v2(user["secret_key"], method, path.split("?", 1)[0], date)
            status, hdrs, payload = await http_call(addr, method, path, {
                "Date": date, "Authorization": f"AWS {user['access_key']}:{sig}"}, body)
            check(status in (200, 204), f"17c: {method} {path} answered {status} {payload[:200]}")
            return hdrs, payload

        # the reference's bucket index is one JSON object that each PUT reads,
        # changes and writes back, so concurrent PUTs into one bucket lose
        # index entries: QD8 spreads its PUTs over A_QD buckets
        buckets = [f"b17-{q}" for q in range(A_QD)]
        for b in buckets:
            await s3_call("PUT", f"/{b}")
        half = A_S3_OBJECTS // 2
        objects = {f"{buckets[max(0, i - half) % A_QD]}/o{i}": blob(A_S3_BYTES)
                   for i in range(A_S3_OBJECTS)}
        keys = list(objects)

        async def puts(ks, qd):
            for lo in range(0, len(ks), qd):
                await asyncio.gather(*(s3_call("PUT", f"/{k}", objects[k])
                                       for k in ks[lo:lo + qd]))

        await step("17c PUT QD1", half * A_S3_BYTES, puts(keys[:half], 1))
        await step("17c PUT QD8", half * A_S3_BYTES, puts(keys[half:], A_QD))

        async def gets(ks):
            for lo in range(0, len(ks), A_QD):
                got = await asyncio.gather(*(s3_call("GET", f"/{k}") for k in ks[lo:lo + A_QD]))
                for k, (_h, payload) in zip(ks[lo:lo + A_QD], got):
                    check(payload == objects[k], f"17c: GET {k} reads back wrong")

        await step("17c GET", A_S3_OBJECTS * A_S3_BYTES, gets(keys))

        async def ranged():
            # the S3 front end serves no Range header (as the reference's):
            # a ranged GET reads the gateway's striped object at an offset
            picks = [(keys[int(rng.integers(0, len(keys)))],
                      int(rng.integers(0, A_S3_BYTES - A_RANGE_BYTES))) for _ in range(A_RANGED)]
            for lo in range(0, A_RANGED, A_QD):
                got = await asyncio.gather(*(
                    StripedObject(gw_io, f"rgw.obj.{k}", policy=stripe).read(A_RANGE_BYTES, off)
                    for k, off in picks[lo:lo + A_QD]))
                for (k, off), data in zip(picks[lo:lo + A_QD], got):
                    check(data == objects[k][off:off + A_RANGE_BYTES],
                          f"17c: a ranged read of {k} at {off} is wrong")

        await step("17c ranged GET", A_RANGED * A_RANGE_BYTES, ranged())
        parts = [blob(A_PART_BYTES) for _ in range(A_MULTIPART_BYTES // A_PART_BYTES)]

        async def multipart():
            _h, init = await s3_call("POST", f"/{buckets[0]}/big?uploads")
            upload = re.search(rb"<UploadId>(\w+)</UploadId>", init).group(1).decode()
            for n, part in enumerate(parts, 1):
                await s3_call("PUT", f"/{buckets[0]}/big?partNumber={n}&uploadId={upload}", part)
            await s3_call("POST", f"/{buckets[0]}/big?uploadId={upload}")

        await step("17c multipart", A_MULTIPART_BYTES, multipart())
        _h, big = await s3_call("GET", f"/{buckets[0]}/big")
        check(big == b"".join(parts), "17c: the multipart object reads back wrong")
        swift = SwiftServer(gw)
        saddr = await swift.serve("127.0.0.1")
        status, hdrs, _ = await http_call(saddr, "GET", "/auth/v1.0", {
            "X-Auth-User": "alice:swift", "X-Auth-Key": user["secret_key"]})
        check(status == 200, f"17c: Swift's auth answered {status}")
        token = {"X-Auth-Token": hdrs["X-Auth-Token"]}
        status, _, _ = await http_call(saddr, "PUT", "/v1/AUTH_alice/c17", token)
        check(status == 201, f"17c: the container PUT answered {status}")
        sobjects = {f"s{i}": blob(A_SWIFT_BYTES) for i in range(A_SWIFT_OBJECTS)}

        async def swift_puts():
            for k, data in sobjects.items():
                status, _, _ = await http_call(saddr, "PUT", f"/v1/AUTH_alice/c17/{k}", token, data)
                check(status == 201, f"17c: Swift PUT {k} answered {status}")

        async def swift_gets():
            got = await asyncio.gather(*(http_call(saddr, "GET", f"/v1/AUTH_alice/c17/{k}", token)
                                         for k in sobjects))
            for (k, data), (status, _, payload) in zip(sobjects.items(), got):
                check(status == 200 and payload == data, f"17c: Swift GET {k} answered {status}")

        await step("17c Swift PUT", A_SWIFT_OBJECTS * A_SWIFT_BYTES, swift_puts())
        await step("17c Swift GET", A_SWIFT_OBJECTS * A_SWIFT_BYTES, swift_gets())
        # one daemon stopped: GETs of objects with a data shard on it decode
        om = rados.objecter.osdmap
        pool_id = om.get_pool("rgw_data").id

        def data_slots(oid: str) -> list:
            _pool, ps = om.object_to_pg(pool_id, oid)
            return om.pg_to_up_acting_osds(pool_id, ps)[2][:8]

        degraded = [k for k in keys if A_VICTIM in data_slots(f"rgw.obj.{k}.{0:016x}")]
        degraded = degraded[:A_DEGRADED_GETS]
        check(len(degraded) == A_DEGRADED_GETS, f"17c: {len(degraded)} objects on osd.{A_VICTIM}")
        t = time.perf_counter()
        await c.stop_osd(A_VICTIM)
        await host.wait_until(lambda: not c.osdmap.is_up(A_VICTIM), 60.0, "osd.3 marked down")
        out["17c s to down"] = time.perf_counter() - t
        await host.wait_until(lambda: all(o.osdmap.epoch >= c.osdmap.epoch for o in c.running()),
                              30.0, "the down epoch")
        await step("17c degraded GET", A_DEGRADED_GETS * A_S3_BYTES, gets(degraded))
        check(by_step["17c degraded GET"]["swar_gf"] > 0, "17c: the degraded GETs decoded nothing")
        done("17c", before)
        print(f"[17] 17c: S3 over HTTP on 127.0.0.1, sign_v2, bucket data on rgw_data "
              f"(append-only): {A_S3_OBJECTS} PUTs of {A_S3_BYTES >> 20} MiB "
              f"{out['17c PUT QD1 MB/s']:.1f} MB/s at QD1, {out['17c PUT QD8 MB/s']:.1f} at QD8; "
              f"GETs byte-exact {out['17c GET MB/s']:.1f} MB/s; {A_RANGED} ranged reads of "
              f"{A_RANGE_BYTES >> 10} KiB "
              f"{out['17c ranged GET MB/s']:.1f} MB/s; a {A_MULTIPART_BYTES >> 20} MiB multipart "
              f"upload in parts of {A_PART_BYTES >> 20} MiB {out['17c multipart MB/s']:.1f} MB/s; "
              f"Swift: a token, {A_SWIFT_OBJECTS} PUTs {out['17c Swift PUT MB/s']:.1f} MB/s and "
              f"GETs {out['17c Swift GET MB/s']:.1f} MB/s of 1 MiB; osd.{A_VICTIM} stopped, down "
              f"{out['17c s to down']:.3f} s later, {A_DEGRADED_GETS} degraded GETs byte-exact "
              f"{out['17c degraded GET MB/s']:.1f} MB/s; launches by step "
              f"{ {k: v for k, v in by_step.items() if k.startswith('17c')} }; launches "
              f"{by_part['17c']}; {card}", flush=True)

        statuses = [c.status(o.whoami) for o in c.running()]
        check(all(s["tpu_backend"]["fallback_launches"] == 0 for s in statuses),
              "17: a daemon's status blob reads fallback launches")
        check(dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fallback0,
              "17: a launch fell back to the host")
        check(c.client._tid == 0, "17: an op went through the test host's client")
    finally:
        for srv in (s3, swift):
            if srv is not None:
                await srv.shutdown()
        if rados is not None:
            await rados.shutdown()
        for module in mods.values():
            if hasattr(module, "shutdown"):
                await module.shutdown()
        await c.stop()
        import shutil

        shutil.rmtree(tmp, ignore_errors=True)
    totals = {k: sum(part[k] for part in by_part.values()) for k in A_KERNELS}
    check(totals == counts(), f"17: launches {counts()} != the parts' sum {totals}")
    out["seconds"] = time.perf_counter() - t_phase
    check(out["seconds"] <= A_LIMIT_S, f"17: {out['seconds']:.1f} s, over {A_LIMIT_S} s")
    print(f"[17] launches by part {by_part}; by step {by_step}; figures {json.dumps(out)}",
          flush=True)
    return {"launches": totals, "by_part": by_part, "by_step": by_step, "figures": out}


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--parent", metavar="DIR",
                        help="root of an older checkout whose packed kernels phase 7c times "
                             "beside this one's")
    parser.add_argument("--packed-timing-of", metavar="DIR",
                        help="only time the packed kernels of the checkout at DIR and print "
                             "one JSON line (what --parent runs)")
    parser.add_argument("--bluestore-timing-of", metavar="DIR",
                        help="only time the crc32c and transform kernels of the checkout at "
                             "DIR and print one JSON line (what --parent runs)")
    parser.add_argument("--mon-log", metavar="PATH",
                        help="write the monitors' log (subsystem mon, level 10) to PATH")
    parser.add_argument("--only", choices=("14", "15", "16", "17"),
                        help="run phase 1 (the builds) and this phase alone; no contract line")
    args = parser.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on the card",
              file=sys.stderr)
        return 2
    if args.packed_timing_of:
        root = os.path.abspath(args.packed_timing_of)
        sys.path.insert(0, root)
        from ceph_tpu_torch import gf
        from ceph_tpu_torch.ops import packed_gf as packed
        check(packed.__file__.startswith(root + os.sep), f"{packed.__file__} is not under {root}")
        print(json.dumps(packed_compare(torch, packed, gf)))
        return 0
    if args.bluestore_timing_of:
        root = os.path.abspath(args.bluestore_timing_of)
        sys.path.insert(0, root)
        from ceph_tpu_torch.compressor import device as dev
        from ceph_tpu_torch.ops import checksum_offload as co
        for module in (co, dev):
            check(module.__file__.startswith(root + os.sep), f"{module.__file__} is not under {root}")
        print(json.dumps(bluestore_compare(torch, co, dev)))
        return 0
    try:
        from ceph_tpu_torch import gf
        from ceph_tpu_torch.codec import registry
        from ceph_tpu_torch.diag import kern_exp, kern_exp2, kern_exp3, kern_exp4, kern_exp5
        from ceph_tpu_torch.ops import dispatch
        from ceph_tpu_torch.ops import packed_gf as packed
        from ceph_tpu_torch.ops import swar_gf as swar
        from ceph_tpu_torch.ops import xor_mm
        from ceph_tpu_torch.ops._nvcc import nvcc_path
        from ceph_tpu_torch.gf import gf2
        from ceph_tpu_torch.codec.matrix_codec import PLAN_CACHE
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here: {e}", file=sys.stderr)
        return 2
    diag = (kern_exp2, kern_exp3, kern_exp4, kern_exp5)
    if args.mon_log:
        from ceph_tpu_torch.common.log import Log, default_client

        log = default_client()
        log.log = Log(args.mon_log)
        log.subsys.set_log_level("mon", 10)
        atexit.register(log.log.flush)

    def phase(n, fn, *args):
        t0 = time.perf_counter()
        result = fn(*args)
        print(f"[{n}] phase {n}: {time.perf_counter() - t0:.2f} s", flush=True)
        return result

    name, card, infos = phase(1, phase_env, torch, swar, gf, diag, kern_exp, packed, xor_mm,
                              nvcc_path())
    if args.only:
        from ceph_tpu_torch.ops import checksum_offload as co

        alone = {"14": phase_daemon, "15": phase_mon, "16": phase_client,
                 "17": phase_access}[args.only]
        phase(int(args.only), alone, torch, swar, packed, co, card)
        return 0
    max_err = phase(2, phase_kernel_checks, torch, swar, gf, registry)
    launches, xor_launches = phase(3, phase_main_path, torch, swar, registry, gf)
    bulk = phase(4, phase_bulk, torch, swar, registry, gf, card, kern_exp4, kern_exp2,
                 nvcc_path())
    errs = phase("5a", phase_diag_checks, torch, swar, gf, diag)
    diag_launches = phase("5b", phase_diag_mains, torch, swar, diag)
    diag_times = phase("5c", phase_diag_timing, torch, swar, gf, diag, bulk["floor_ms"])
    errs.update(phase("6a", phase_bitmatrix_checks, torch, gf, kern_exp))
    diag_launches.update(phase("6b", phase_bitmatrix_main, torch, swar, kern_exp))
    diag_times.update(phase("6c", phase_bitmatrix_timing, torch, gf, kern_exp))
    errs.update(phase("7a", phase_packed_checks, torch, packed, gf))
    diag_launches.update(phase("7b", phase_packed_path, torch, packed, swar, dispatch,
                               registry, gf))
    diag_times.update(phase("7c", phase_packed_timing, torch, packed, swar, gf))
    for kernel, row in phase("7c", parent_comparison, args.parent).items():
        diag_times[kernel].update(row)
    phase(8, phase_runtime, torch, swar, packed, dispatch, registry, card)
    phase(9, phase_backend, torch, swar, packed, dispatch, registry, card)
    gf2_row = phase("10a", phase_gf2_plane, torch, gf2, xor_mm, PLAN_CACHE, card)
    plugins = phase("10b", phase_plugins, torch, swar, packed, xor_mm, registry, card)
    phase("10c", phase_recovery, torch, swar, packed, dispatch, registry, card)
    scrub_cache = phase(11, phase_scrub_cache, torch, swar, packed, dispatch, card)
    bluestore = phase(12, phase_bluestore, torch, xor_mm, dispatch, card)
    for label, row in phase("12b", bluestore_parent_comparison, args.parent, card).items():
        if label in bluestore["times"]:
            bluestore["times"][label].update(row)
    pg = phase(13, phase_pg, torch, swar, packed, xor_mm, card)
    from ceph_tpu_torch.ops import checksum_offload as co

    daemon = phase(14, phase_daemon, torch, swar, packed, co, card)
    mon = phase(15, phase_mon, torch, swar, packed, co, card)
    client = phase(16, phase_client, torch, swar, packed, co, card)
    access = phase(17, phase_access, torch, swar, packed, co, card)
    fig15, fig16 = mon["figures"], client["figures"]
    print(f"[16] client MB/s in this run: 16b {fig16['16b QD1 MB/s']:.1f} / "
          f"{fig16['16b QD8 MB/s']:.1f} (QD1 / QD8, Rados, ten mgr modules) beside 15b "
          f"{fig15['15b QD1 MB/s']:.1f} / {fig15['15b QD8 MB/s']:.1f} (the test host's "
          f"client, no module); {card}", flush=True)
    for kernel in ("packed_verify", "packed_delta"):
        diag_launches[kernel] = {"7b": diag_launches[kernel],
                                 "11": scrub_cache["launches"][kernel],
                                 "13": pg["launches"][kernel],
                                 "14": daemon["launches"][kernel]}
    diag_launches["packed_verify"]["15"] = mon["launches"]["packed_verify"]
    diag_launches["packed_delta"]["17"] = access["launches"]["packed_delta"]
    swar_by_phase = {"3": launches, "13": pg["launches"]["swar_gf"],
                     "14": daemon["launches"]["swar_gf"], "15": mon["launches"]["swar_gf"],
                     "16": client["launches"]["swar_gf"], "17": access["launches"]["swar_gf"]}
    kernels = [{
        "name": "swar_gf",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/swar_gf.cu",
        "replaces": "ceph_tpu/ops/pallas_gf.py:103",
        "launches": sum(swar_by_phase.values()),
        "launches_by_phase": swar_by_phase,
        "max_abs_err": max_err,
        "ms": bulk["ms"],
        "plain_ms": bulk["plain_ms"],
        "bound_ms": bulk["bound_ms"],
        "bound_by": bulk["bound_by"],
        "library_ms": None,
        "source_sha256": infos["swar_gf"]["source_sha256"],
    }]
    for kernel, source, replaces in (
        ("copy_floor", "copy_floor.cu", "benchmarks/diag/kern_exp4.py:34"),
        ("swar_baked", "swar_baked.cu", "benchmarks/diag/kern_exp2.py:48"),
        ("swar3_baked", "swar3_baked.cu", "benchmarks/diag/kern_exp3.py:41"),
        ("bitmatrix_grouped_int8", "bitmatrix.cu", "benchmarks/diag/kern_exp.py:53"),
        ("bitmatrix_grouped_bf16", "bitmatrix.cu", "benchmarks/diag/kern_exp.py:53"),
        ("bitmatrix_mm_only", "bitmatrix.cu", "benchmarks/diag/kern_exp.py:98"),
        ("bitmatrix_expand_only", "bitmatrix.cu", "benchmarks/diag/kern_exp.py:131"),
        ("packed_code", "packed_gf.cu", "ceph_tpu/ops/packed_gf.py:315"),
        ("packed_verify", "packed_gf.cu", "ceph_tpu/ops/packed_gf.py:375"),
        ("packed_delta", "packed_gf.cu", "ceph_tpu/ops/packed_gf.py:400"),
    ):
        launches = diag_launches[kernel]
        by_path = launches if isinstance(launches, dict) else None
        kernels.append({
            "name": kernel,
            "route": "cuda",
            "source": f"ceph_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": sum(by_path.values()) if by_path else launches,
            **({"launches_by_phase": by_path} if by_path else {}),
            "max_abs_err": errs[kernel],
            **diag_times[kernel],
        })
    kernels.append({
        "name": "gf2_plane_matmul",
        "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf2_plane.cu",
        "replaces": "ceph_tpu/ops/xor_mm.py:79",
        "launches": plugins["gf2_plane_matmul_launches"],
        **gf2_row,
        "source_sha256": infos["gf2_plane"]["source_sha256"],
    })
    times = bluestore["times"]
    for kernel, source, replaces, shape, by_phase in (
        ("xor_reduce", "xor_reduce.cu", "ceph_tpu/ops/xor_mm.py:107",
         "x".join(map(str, XOR_BULK)),
         {"3": xor_launches, "10b": plugins["xor_reduce_launches"]}),
        ("crc32c", "crc32c.cu", "ceph_tpu/ops/checksum_offload.py:118",
         "x".join(map(str, CRC_BULK)), {"12c": bluestore["launches"]["crc32c"],
                                        "14c": daemon["launches"]["crc32c"],
                                        "15e": mon["by_part"]["15e"]["crc32c"]}),
        ("compress_transform", "compress_transform.cu", "ceph_tpu/compressor/device.py:56",
         "x".join(map(str, XFORM_BULK)),
         {"12d": bluestore["launches"]["compress_transform"]}),
    ):
        check(all(n > 0 for n in by_phase.values()), f"{kernel}: main-path launches {by_phase}")
        row = {key: val for key, val in times[f"{kernel} {shape}"].items()
               if key != "transpose_floor_ms"}
        kernels.append({
            "name": kernel,
            "route": "cuda",
            "source": f"ceph_tpu_torch/csrc/{source}",
            "replaces": replaces,
            "launches": sum(by_phase.values()),
            "launches_by_phase": by_phase,
            "max_abs_err": bluestore["errs"][kernel],
            **row,
            "source_sha256": infos[kernel]["source_sha256"],
        })
    print(f"chip_smoke: whole script {time.perf_counter() - T_START:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
