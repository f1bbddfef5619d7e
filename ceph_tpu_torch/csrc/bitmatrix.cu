// The bit-matrix kernels of the kern_exp.py experiment, for Hopper (sm_90a).
// grouped runs on the tensor cores with either operand type (wgmma),
// mm_only too (bf16 mma.sync); expand_only runs on the CUDA cores.
//
// Replaces the three Pallas kernels of benchmarks/diag/kern_exp.py:
//
// grouped      make_grouped (:75-95; body _kernel_grouped :53-72, pallas_call
//              :84).  g stripes per block.  The g·k chunks expand into 8kg
//              0/1 planes, row s·8k + b·k + j = bit b of chunk j of stripe s
//              (bit-major, :58-60).  The planes are multiplied by the
//              (8mg, 8kg) operand, which the caller makes block-diagonal
//              from arrange_dense_matrix(gfm); the sum is kept in float
//              (bf16 operand) or int (int8 operand), as preferred_element_type
//              does at :66, cut to int, `& 1`, and 8 rows are packed
//              LSB-first into each output byte.  The result is GF(2^8) coding
//              by gfm:
//                in (S, k, L) uint8, operand (8mg, 8kg) bf16 or int8
//                out (S, m, L) uint8
// mm_only      make_mm_only (:108-128; body :98-105, pallas_call :117).  The
//              (8m, 8k) bf16 operand times pre-expanded bf16 planes, float
//              sums, cut to int32 and then to uint8.  These are counts, not
//              parity:
//                in (S, 8k, L) bf16, operand (8m, 8k) bf16
//                out (S, 8m, L) uint8
// expand_only  make_expand_only (:137-150; body :131-134, pallas_call :142).
//              The number of set bits over the k bytes of each column:
//                in (S, k, L) uint8, out (S, 1, L) uint8
//
// Domain.  Planes are 0/1, operands are 0/1 (the GF(2) bit-matrix) or any
// int8, and a sum has at most 8kg <= 768 terms, so every partial sum is an
// integer below 2^24: the float sums are exact, in any order, and equal the
// TPU's int32 and float32 sums byte for byte.
//
// Translation.  The TPU grid (S/g, L/tile) becomes a 1-D grid of
// (S/g)·(L/tile) blocks; a block covers `tile` byte columns of g stripes, so
// the script's variant names keep their meaning.  g, k and m are runtime
// arguments, so one library serves every matrix and every variant (mm_only
// has one instance per (8m/8, ceil(8k/16)), grouped's int8 kernel one per
// (k-steps, stage width), its bf16 kernel one per (words, stage width)).
//
// grouped, both operand types (grouped_tc, the body of the two kernels):
// one warpgroup a block.  Each warp stages 256 columns of one stripe
// (every chunk row) through its own 3-stage cp.async ring, then turns each
// 4 chunk rows into words W[t][c] = the bytes of chunks 4t..4t+3 at column c
// (a 4x4 byte transpose, 8 PRMT per 16 bytes), chunks past k as zero.  W's
// columns are stored 0, 8, 1, 9, ... within each 16, so that the words of
// columns gid and gid + 8 are one 8-byte load.  A is made from the words in
// registers; B, the (8m, 8k) diagonal block permuted for the pass's output
// chunks, lies in shared memory as 8-row x 16-byte core matrices (no
// swizzle; 128 bytes apart along K, 256 along N).  M = 64 byte columns (16 of
// each warp).  The epilogue stages each output byte in shared memory and the
// warp writes its rows with coalesced 16-byte stores.
// - g costs nothing: the g stripes of a block are only more columns, and the
//   kernel multiplies the (8m, 8k) diagonal block alone.  The MXU pays for the
//   off-diagonal zero blocks; the plain version still multiplies the whole
//   block-diagonal operand, and chip_smoke.py holds the two equal.
// - Pipelining.  The warps run their rings apart and meet only in the
//   collective products.  m-tile mt's product runs while the lanes pack
//   m-tile mt - 1's sums and load mt + 1's A (two sets of sums and of A,
//   wgmma.wait_group 1).  Every warp runs the same number of rounds; a round
//   past its last stage codes stale bytes and stores nothing.
// - Any tile % 4 == 0: a stage or m-tile past the tile's end is computed on
//   stale bytes and never stored; where L or the tile is not a multiple of
//   16 the copies are 4 bytes wide.  Large k takes chunk groups with the
//   sums kept (not pipelined), and narrower stages where 256 columns do not
//   fit the block's shared memory.
//
// grouped, int8 operand: wgmma m64n32k32, u8 A from registers, s8 B, s32
// sums.  K = 32 planes taken as 4 chunks x 8 bits, N = 32 = the 8 bits of
// each of 4 output chunks (RS(8,3): 2 k-steps, 2 wgmma per 64 columns; m > 4
// takes passes of 4 chunks on blockIdx.y).
// - A from data words by one shift.  In k-step t lane (gid, tig) takes a0 =
//   W[t][c0+gid] >> tig, a1 = W[t][c0+gid+8] >> tig, a2 = W[t][c0+gid] >>
//   (tig+4), a3 = W[t][c0+gid+8] >> (tig+4): the low bit of byte i is then
//   bit tig (or tig+4) of chunk 4t+i, which is A's element (row gid or
//   gid+8, K = 4·tig + i or 16 + 4·tig + i: mma.sync's m16n8k32 layout, which
//   wgmma keeps for each warp's 16 rows), so K index 4b + i is bit b of
//   chunk 4t+i.
// - Parity.  The other 7 bits of each u8 element are garbage.  Every B
//   element is 0 or 1, so each product's low bit is the low bit of A times
//   B, and a sum's parity is the parity of the sum of the planes' bits: the
//   garbage changes the sum, never its low bit.  A sum is at most 255·32 a
//   k-step, below 2^23 for the 24 k-steps of k = 96, so `acc & 1` equals the
//   TPU's `acc & 1` (an s32 sum would keep its parity even if it wrapped).
// - B = imma_operand(arrange_dense_matrix(gfm), k) (kern_exp.py), (8m,
//   32·steps) int8: column 32t + 4b + i holds column b·k + 4t + i of the
//   bit-matrix, zero where 4t + i >= k.  Each block copies its pass's 32
//   rows into shared memory once (stage_b), permuted so that N index n is
//   bit 2(n/8) + n%2 of chunk (n%8)/2.  k > 32 takes groups of at most 8 k-steps; k > 48
//   128-column stages.
// - Epilogue.  Sum 4i + e (e = 0, 1) of lane (gid, tig) is N index 8i +
//   2·tig + e at column gid, 4i + 2 + e the same at column gid + 8, so by the
//   permutation lane tig holds all 8 bits of output chunk tig: PRMT gathers
//   the sums' low bytes, two masks keep their parities, and one multiply by
//   2^0 + 2^6 + 2^12 + 2^18 moves bit pair i from 8i to 2i.  No shuffle.
// grouped, bf16 operand: wgmma m64n32k16, bf16 A from registers, bf16 B,
// f32 sums.  A word W[t] feeds two k16 steps: step 2t + o takes y = W[t] >>
// 8o, whose bytes 0 and 2 are chunks 4t + o and 4t + o + 2, the low and
// high bf16 of each A register.  N = 32 = the 8 bits of each of 4 output
// chunks, as for int8 (RS(8,3): 4 k16 steps with no K padding, 4 HGMMA per
// 64 columns; m > 4 takes passes of 4 chunks on blockIdx.y).
// - A from data words by one LOP3 a register.  mma.sync's m16n8k16 layout
//   (kept by wgmma for each warp's 16 rows) gives lane (gid, tig) K = 2·tig,
//   2·tig + 1 in a0 (row gid) and a1 (row gid + 8), K + 8 in a2 and a3.  a0 =
//   (y & mask_s) ^ base_s with s = tig, a2 the same with s = tig + 4: for s <
//   7 mask_s keeps bits s..6 of each bf16 half and base_s is 0x4300 (128),
//   so the element is 128 + v with v a multiple of 2^s whose bit s is bit s
//   of its chunk; for s = 7 mask_s keeps bit 7 and base_s = 0x4380 (256), so
//   the element is 256, or 128 where bit 7 of the chunk is set (it flips the
//   exponent's low bit).  K index 2(b % 4) + 8(b / 4) + e of step 2t + o is
//   bit b of chunk 4t + o + 2e.  One SHF a word for y, one LOP3 a register.
// - Parity.  B = hgmma_operand(arrange_dense_matrix(gfm), k) (kern_exp.py)
//   puts 2^-b where the bit-matrix has a 1 at bit b, else 0, and 0 at every
//   chunk >= k (A is 128 or more there: the zero must be in B).  A product
//   is then (128 + v)·2^-s = 2^(7-s) + v/2^s for s < 7, an even number plus
//   the plane bit, and 2 or 1 for s = 7, an even number plus the plane bit
//   too.  Every product is a small integer, at most 255, 127, 63, ..., 3, 2
//   for s = 0..7: at most 503 a chunk, so an m-tile's sum is an integer of
//   at most 503k (48,288 for k = 96), and every partial sum below is exact in
//   f32, in any order; its parity is the parity of the planes' bits, the
//   TPU's `acc & 1`.
// - B: each block copies its pass's 32 rows into shared memory once with
//   the int8 kernel's permutation (stage_b), so that lane tig holds all 8
//   bits of output chunk tig.  k > 16 takes groups of at most 4 words;
//   k > 48 64-column stages.
// - Epilogue.  The sums of the two sets (m-tiles mt % 2) start each stage at
//   2^23 and keep adding their m-tiles' products, so that a float's low
//   mantissa bits are an integer's, with no add of 2^23 per sum: with one
//   chunk group (k <= 16) a set adds 8 m-tiles of at most 503·16, so it stays
//   below 2^23 + 2^16 and exact; with chunk groups each m-tile starts anew.
//   The parity of an m-tile's sum is the low bit of its set's float XOR that
//   of the set's previous one (2^23's is 0): gather_byte packs lane tig's
//   8 bits of both, and one XOR leaves the m-tile's byte.  No shuffle.
// mm_only (tensor cores): a memory stream with an MMA inside it.  The
// planes are the A side of mma.sync m16n8k16 (M = 16 columns, K = 16
// planes) and the operand the B side, so the 8m rows are N = 8m/8 tiles
// of n8 with no padding, and the operand's rows lie in memory as the "col"
// B layout wants: each warp loads its B fragments (at most 8 k-steps x 4
// n-tiles x 2 registers) once and keeps them for the whole block.  The
// wrapper pads the operand's columns with zeros to a multiple of 16.  The
// planes stream once through a 3-stage cp.async.cg ring in shared memory,
// 16 B a thread, a stage being 128 columns of every plane (16 KiB for
// 8k = 64); the padded plane rows of every stage are zeroed once and never
// loaded (bf16 garbage could be NaN, and 0 x NaN is NaN).  Rows are padded
// by 16 B so that ldmatrix.x4.trans, which forms the A fragments, and the
// epilogue's byte writes are free of bank conflicts.  Epilogue: each f32
// sum is cut to int (__float2int_rz) and its low byte staged in shared
// memory, then written with coalesced 16-byte stores.
// expand_only (CUDA cores): 16-byte vectors; bytewise popcounts on 32-bit
// words by the 0x55/0x33/0x0f SWAR steps, summed over the k chunks
// (8k <= 255, so no byte carries into the next).
//
// Bound on an H100 SXM at (256, 8, 131072), RS(8,3): bytes for all three.
// grouped moves (k + m)·S·L = 369,098,752 B, 0.1102 ms at 3.35 TB/s; the
// (8m, 8k) product it needs is 5.15e10 multiply-adds, 0.0521 ms at the dense
// int8 tensor rate, 0.1042 ms at the bf16 rate.  Both grouped kernels stay
// near the byte stream: their product is the diagonal block only, at
// wgmma's rate (the legacy mma.sync path's int8 rate held a first design of
// the int8 kernel to about four times the bound), their planes never leave
// registers (one shift per int8 A register, one LOP3 per bf16 one), and
// each warp keeps 2 stages in flight.  N = 32 computes 4/3 of RS(8,3)'s
// bf16 product, 0.139 ms at the nominal peak, above the byte bound; yet on
// an H100 80GB HBM3 at 700 W a build with N = 8 x the pass's chunks
// (m64n24k16 for RS(8,3), one shuffle to finish each byte) took the same
// time as N = 32 (1.002-1.004x), so the multiply-adds do not bind and
// N = 32 is the only width.  The bf16 kernel takes about 1.35x the int8
// one: per m-tile the warpgroup feeds 4 HGMMA with 2 KB of A from
// registers each (int8: 2 IGMMA), and each lane builds 16 A registers by
// LOP3 (int8: 8 by SHF).
// mm_only moves (2·8k + 8m)·S·L = 5.1e9 B, 1.5225 ms, beside 0.104 ms of
// bf16 MMA (0.14 ms with K padded and the M side in whole m16 tiles): the
// ring keeps 2 stages in flight per block to cover memory latency (for
// 8k = 64 a block takes 55,680 B of shared memory, so 4 blocks fit an SM,
// 128 KiB in flight), and the MMA, the cut and the staging hide under the
// stream.  expand_only moves (k + 1)·S·L B,
// 0.0901 ms.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// chunks (g·k) of a grouped block
constexpr int kMaxGroupedWords = 96;
constexpr int kTcThreads = 128;        // one warpgroup: 4 warps, each with its own ring
// columns of one stripe in one ring stage of a warp: 256, or fewer where
// the block's shared memory would not hold 256 (int8: 128 for k > 48;
// bf16: 64 for k > 48)
constexpr int kTcWideCols = 256;
constexpr int kImmaNarrowCols = 128;
constexpr int kHgmmaNarrowCols = 64;
constexpr int kPassChunks = 4;         // output chunks of one pass: N = 32 bits
constexpr int kImmaMaxSteps = 8;       // int8 k-steps (words of 4 chunks) of one chunk group
constexpr int kHgmmaMaxWords = 4;      // bf16 words (4 chunks, two k16 steps) of one chunk group
constexpr int kMmThreads = 128;     // 4 warps, 32 columns of a stage each
constexpr int kMmStageCols = 128;   // columns of every plane in one ring stage
constexpr int kStages = 3;          // ring depth: 2 stages in flight while 1 is read
constexpr int kMmPitch = kMmStageCols + 8;      // bf16 a staged plane row
constexpr int kMmOutPitch = kMmStageCols + 16;  // bytes a staged output row
constexpr int kMaxMmCols = 128;     // 8k columns of the mm_only operand
constexpr int kExpandThreads = 256;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kStages - 2 groups are pending: the oldest stage landed
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
}

// Four 8x8 bf16 matrices, transposed: lanes 8q..8q+7 give the row
// addresses of matrix q, and register q of every lane receives its part.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(s)
               : "memory");
}

// d += a·b, m16n8k16, bf16 inputs, f32 accumulate
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

constexpr size_t mm_only_shared_bytes(int nt, int ks) {
  return (size_t)kStages * 16 * ks * kMmPitch * sizeof(uint16_t) +
         (size_t)8 * nt * kMmOutPitch;
}

// NT = 8m / 8 output n-tiles, KS = ceil(8k / 16) k-steps.  planes (S, cols,
// L) bf16; mat (8·NT, 16·KS) bf16 with the columns from `cols` on zero;
// out (S, 8·NT, L) uint8.
template <int NT, int KS>
__global__ void __launch_bounds__(kMmThreads)
mm_only_kernel(const uint16_t* __restrict__ planes, const uint32_t* __restrict__ mat,
               uint8_t* __restrict__ out, int cols, long long L, int tile, long long tiles) {
  constexpr int kRows = 8 * NT;
  constexpr int kDepth = 16 * KS;
  extern __shared__ __align__(16) uint8_t smem[];
  // [kStages][kDepth][kMmPitch] bf16, then [kRows][kMmOutPitch] bytes
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  uint8_t* staged = smem + kStages * kDepth * kMmPitch * sizeof(uint16_t);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;  // mma's groupID
  const int tig = lane & 3;   // mma's thread in group

  // B fragments for the whole block: b0 = mat[n][k0 + 2·tig .. +1] with
  // n = nt·8 + gid, b1 the same 8 columns on; one 32-bit word each.
  uint32_t b[KS][NT][2];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const uint32_t* row = mat + (nt * 8 + gid) * (kDepth / 2) + ks * 8 + tig;
      b[ks][nt][0] = row[0];
      b[ks][nt][1] = row[4];
    }
  // the padded plane rows: zero in every stage, never loaded
  for (int i = threadIdx.x; i < kStages * (kDepth - cols) * (kMmPitch / 8); i += kMmThreads) {
    const int per_stage = (kDepth - cols) * (kMmPitch / 8);
    const int stage = i / per_stage;
    const int v = i - stage * per_stage;
    reinterpret_cast<uint4*>(ring + (stage * kDepth + cols) * kMmPitch)[v] =
        make_uint4(0u, 0u, 0u, 0u);
  }

  const long long s = blockIdx.x / tiles;
  const long long t = blockIdx.x - s * tiles;
  const uint16_t* src = planes + s * cols * L + t * tile;
  uint8_t* dst = out + s * kRows * L + t * tile;
  const int stages = tile / kMmStageCols;
  auto load = [&](int st) {  // stage st: 128 columns of every plane, 16 B a thread
    uint16_t* slot = ring + (st % kStages) * kDepth * kMmPitch;
    const uint16_t* from = src + st * kMmStageCols;
    for (int i = threadIdx.x; i < cols * (kMmStageCols / 8); i += kMmThreads) {
      const int c = i / (kMmStageCols / 8);
      const int v = i - c * (kMmStageCols / 8);
      cp_async16(slot + c * kMmPitch + v * 8, from + c * L + v * 8);
    }
  };
#pragma unroll 1
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < stages) load(p);
    cp_async_commit();  // possibly empty, so that the group count is the stage count
  }
#pragma unroll 1
  for (int st = 0; st < stages; ++st) {
    cp_async_wait_oldest();
    // stage st has landed for every thread, and every warp is done with
    // the slot the next load overwrites and with the staged output
    __syncthreads();
    if (st + kStages - 1 < stages) load(st + kStages - 1);
    cp_async_commit();

    const uint16_t* slot = ring + (st % kStages) * kDepth * kMmPitch;
    float acc[2][NT][4] = {};
    // ldmatrix.x4.trans of plane rows k0 + 8·(q >> 1) + i, columns
    // c0 + 8·(q & 1): the A fragment {a0a1, a2a3, a4a5, a6a7}
    const int q = lane >> 3;
    const uint16_t* frag =
        slot + ((q >> 1) * 8 + (lane & 7)) * kMmPitch + warp * 32 + (q & 1) * 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        uint32_t a[4];
        ldmatrix_x4_trans(a, frag + ks * 16 * kMmPitch + mt * 16);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[mt][nt], a, b[ks][nt]);
      }
    // d0, d1: column c0 + gid, rows n0 + 2·tig, +1; d2, d3: column + 8.
    // astype(int32) truncates, astype(uint8) keeps the low byte.
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        uint8_t* o = staged + (nt * 8 + 2 * tig) * kMmOutPitch + warp * 32 + mt * 16 + gid;
        o[0] = (uint8_t)__float2int_rz(acc[mt][nt][0]);
        o[kMmOutPitch] = (uint8_t)__float2int_rz(acc[mt][nt][1]);
        o[8] = (uint8_t)__float2int_rz(acc[mt][nt][2]);
        o[kMmOutPitch + 8] = (uint8_t)__float2int_rz(acc[mt][nt][3]);
      }
    __syncthreads();
    uint8_t* to = dst + st * kMmStageCols;
    for (int i = threadIdx.x; i < kRows * (kMmStageCols / 16); i += kMmThreads) {
      const int r = i / (kMmStageCols / 16);
      const int v = i - r * (kMmStageCols / 16);
      *reinterpret_cast<uint4*>(to + r * L + v * 16) =
          *reinterpret_cast<const uint4*>(staged + r * kMmOutPitch + v * 16);
    }
  }
}

// Shared-memory descriptor of a K-major operand without swizzle (CUTLASS's
// GmmaDescriptor, LayoutType::INTERLEAVE): 8-row x 16-byte core matrices
// of 128 contiguous bytes, `lbo` bytes apart along K and `sbo` bytes apart
// along N.
__device__ __forceinline__ uint64_t gmma_desc(const void* smem, int lbo, int sbo) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  return (uint64_t)((s >> 4) & 0x3fff) | ((uint64_t)((lbo >> 4) & 0x3fff) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3fff) << 32);
}

// d (+)= a·B for the warpgroup, m64n32k32: u8 A from registers (each warp's
// 16 rows in mma.sync's m16n8k32 fragment layout), s8 B from shared memory,
// s32 sums (each warp's 16 rows in mma.sync's m16n8 layout, n8 block i in
// d[4i..4i+3]).  accumulate == 0 overwrites d.
__device__ __forceinline__ void wgmma_u8s8(int (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.u8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

// d (+)= a·B for the warpgroup, m64n32k16: bf16 A from registers (each
// warp's 16 rows in mma.sync's m16n8k16 fragment layout), bf16 B from shared
// memory (K-major, not transposed), f32 sums (each warp's 16 rows in
// mma.sync's m16n8 layout, n8 block i in d[4i..4i+3]).  accumulate == 0
// overwrites d.
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], const uint32_t (&a)[4], uint64_t desc,
                                           int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most `pending` committed groups are still in flight
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(pending) : "memory");
}

// Keep the compiler from moving reads or writes of d across the asynchronous
// product (CUTLASS's warpgroup_fence_operand).
__device__ __forceinline__ void pin(int (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

__device__ __forceinline__ void pin(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// One output byte from the sums d of the 4 n8 blocks: block i holds bits 2i
// (d[4i + j]) and 2i + 1 (d[4i + j + 1]), each the low bit of its sum.
__device__ __forceinline__ uint32_t gather_byte(const int (&d)[16], int j) {
  // byte i of x0 (x1): the low byte of d[4i + j] (d[4i + j + 1])
  const uint32_t x0 = __byte_perm(__byte_perm(d[j], d[4 + j], 0x0040),
                                  __byte_perm(d[8 + j], d[12 + j], 0x0040), 0x5410);
  const uint32_t x1 = __byte_perm(__byte_perm(d[j + 1], d[5 + j], 0x0040),
                                  __byte_perm(d[9 + j], d[13 + j], 0x0040), 0x5410);
  // bits 2i, 2i + 1 of the byte at bits 8i, 8i + 1
  const uint32_t e = (x0 & 0x01010101u) | ((x1 << 1) & 0x02020202u);
  // times 2^0 + 2^6 + 2^12 + 2^18: field i lands at 8i + 6n for n = 0..3,
  // at 18 + 2i for n = 3 - i, and no two of the 16 places overlap
  return (e * 0x41041u) >> 18;
}

// Bytes of 4 chunk words x0..x3 (4 columns each) -> o0..o3, o_c holding the
// 4 chunks' bytes of column c.
__device__ __forceinline__ void transpose4(uint32_t x0, uint32_t x1, uint32_t x2, uint32_t x3,
                                           uint32_t* o) {
  const uint32_t a = __byte_perm(x0, x1, 0x5140), b = __byte_perm(x0, x1, 0x7362);
  const uint32_t c = __byte_perm(x2, x3, 0x5140), d = __byte_perm(x2, x3, 0x7362);
  o[0] = __byte_perm(a, c, 0x5410);
  o[1] = __byte_perm(a, c, 0x7632);
  o[2] = __byte_perm(b, d, 0x5410);
  o[3] = __byte_perm(b, d, 0x7632);
}

// A warp's shared memory for stages of `cols` columns and `words` words of
// 4 chunks: its ring, its words, its staged output (the pass's chunks,
// rows padded by 16 bytes).
__host__ __device__ constexpr size_t grouped_warp_bytes(int k, int words, int cols) {
  return (size_t)kStages * k * cols + (size_t)words * cols * 4 + (size_t)kPassChunks * (cols + 16);
}

// The block's shared memory: the operand (`word_bytes` a word), then each warp's.
constexpr size_t grouped_shared_bytes(int k, int words, int cols, int word_bytes) {
  return (size_t)words * word_bytes + kTcThreads / 32 * grouped_warp_bytes(k, words, cols);
}

// B of a pass in shared memory, for both operand types: mat's rows are
// 32·steps bytes, row r bit r % 8 of output chunk r / 8, and `steps` K
// slices of 32 bytes (one int8 k32 step or one bf16 k16 step) are stored
// [steps][4 row groups][2 K halves][8 rows][16 B].  Row n (N index) is bit
// 2(n / 8) + n % 2 of output chunk first + (n % 8) / 2, zero past m: n8
// block i holds bits 2i, 2i + 1 of the 4 chunks, so that lane tig's sums
// are all 8 bits of chunk tig.
__device__ __forceinline__ void stage_b(uint8_t* operand, const uint8_t* mat, int steps,
                                        int first, int m) {
  for (int i = threadIdx.x; i < steps * 64; i += kTcThreads) {
    const int t = i >> 6, n = (i >> 1) & 31, half = i & 1;
    const int chunk = first + ((n & 7) >> 1);
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (chunk < m) {
      const long long row = 8 * chunk + 2 * (n >> 3) + (n & 1);
      v = *reinterpret_cast<const uint4*>(mat + row * (32 * steps) + 32 * t + 16 * half);
    }
    *reinterpret_cast<uint4*>(operand + t * 1024 + (n >> 3) * 256 + half * 128 + (n & 7) * 16) =
        v;
  }
}

// The int8 operand's part of grouped_tc: one k32 step a word, N = 32 (the
// 4 output chunks of a pass), s32 sums.
template <int KS>
struct ImmaOp {
  static constexpr int kWords = KS;            // words of a chunk group
  static constexpr int kWordBytes = 1024;      // B of one word: 32 x 32 bytes
  struct Acc {
    int d[16];
  };
  struct Frag {
    uint32_t a[KS][4];
  };

  __device__ static void stage(uint8_t* operand, const uint8_t* mat, int words, int first,
                               int m) {
    stage_b(operand, mat, words, first, m);
  }
  // w: W[t0][c0 + 2·gid] (columns gid, gid + 8, one 8-byte load); a0 =
  // W[t][c0+gid] >> tig, a1 = W[t][c0+gid+8] >> tig, a2, a3 the same >> (tig + 4)
  __device__ static void load_a(const uint32_t* w, int pitch, int tig, Frag& f) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint2 x = *reinterpret_cast<const uint2*>(w + ks * pitch);
      f.a[ks][0] = x.x >> tig;
      f.a[ks][1] = x.y >> tig;
      f.a[ks][2] = x.x >> (tig + 4);
      f.a[ks][3] = x.y >> (tig + 4);
    }
  }
  // words t0..t0 + KS - 1; accumulate == 0 overwrites the sums
  __device__ static void mma(Acc& acc, const Frag& f, const uint8_t* operand, int t0,
                             int accumulate) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_u8s8(acc.d, f.a[ks], gmma_desc(operand + (t0 + ks) * kWordBytes, 128, 256),
                 accumulate || ks > 0);
  }
  __device__ static void pin_sums(Acc& acc) { pin(acc.d); }
  static constexpr int kFirstAccumulate = 0;  // a chain's first product overwrites the sums
  __device__ static void start(Acc&) {}
  // o: the staged byte of column gid in row 0; lane tig's sums are the 8
  // bits of the pass's output chunk tig
  __device__ static void emit(const Acc& acc, uint32_t&, uint8_t* o, int pitch, int tig,
                              int live) {
    if (tig < live) {
      o += tig * pitch;
      o[0] = (uint8_t)gather_byte(acc.d, 0);  // column gid
      o[8] = (uint8_t)gather_byte(acc.d, 2);  // column gid + 8
    }
  }
};

// The bf16 operand's part of grouped_tc: two k16 steps a word (o = 0:
// chunks 4w, 4w + 2; o = 1: chunks 4w + 1, 4w + 3), N = 32 (the 4 output
// chunks of a pass), f32 sums.
template <int KS>
struct HgmmaOp {
  static constexpr int kWords = KS;
  static constexpr int kStepBytes = 1024;            // B of one k16 step: 32 x 16 bf16
  static constexpr int kWordBytes = 2 * kStepBytes;
  struct Acc {
    float d[16];
  };
  struct Frag {
    uint32_t a[2 * KS][4];
  };

  // mat (hgmma_operand, 32·words bf16 a row): 2·words k16 steps
  __device__ static void stage(uint8_t* operand, const uint8_t* mat, int words, int first,
                               int m) {
    stage_b(operand, mat, 2 * words, first, m);
  }
  // w: W[t0][c0 + 2·gid].  Step 2t + o takes y = W[t] >> 8o: bytes 0 and 2
  // are chunks 4t + o and 4t + o + 2, the low and high bf16 of a register.
  // Register a0 (a1: column gid + 8) holds K = 2·tig, 2·tig + 1, bit s = tig
  // of the two chunks, a2 (a3) K + 8, bit s = tig + 4: the bf16 pair
  // (y & mask_s) ^ base_s, mask_s keeping bits s..6 of each half on base
  // 0x4300 (128), or, for s = 7, bit 7 flipping base 0x4380 (256) to 128.
  __device__ static void load_a(const uint32_t* w, int pitch, int tig, Frag& f) {
    const uint32_t lo_mask = ((0x7Fu >> tig) << tig) * 0x00010001u;
    const uint32_t hi_mask =
        tig == 3 ? 0x00800080u : ((0x7Fu >> (tig + 4)) << (tig + 4)) * 0x00010001u;
    const uint32_t hi_base = tig == 3 ? 0x43804380u : 0x43004300u;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint2 x = *reinterpret_cast<const uint2*>(w + ks * pitch);
#pragma unroll
      for (int o = 0; o < 2; ++o) {
        const uint32_t y0 = x.x >> (8 * o), y1 = x.y >> (8 * o);
        f.a[2 * ks + o][0] = (y0 & lo_mask) ^ 0x43004300u;
        f.a[2 * ks + o][1] = (y1 & lo_mask) ^ 0x43004300u;
        f.a[2 * ks + o][2] = (y0 & hi_mask) ^ hi_base;
        f.a[2 * ks + o][3] = (y1 & hi_mask) ^ hi_base;
      }
    }
  }
  __device__ static void mma(Acc& acc, const Frag& f, const uint8_t* operand, int t0,
                             int accumulate) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
#pragma unroll
      for (int o = 0; o < 2; ++o)
        wgmma_bf16(acc.d, f.a[2 * ks + o],
                   gmma_desc(operand + (2 * (t0 + ks) + o) * kStepBytes, 128, 256),
                   accumulate || ks > 0 || o > 0);
  }
  __device__ static void pin_sums(Acc& acc) { pin(acc.d); }
  // The sums of a chain start at 2^23 and every product accumulates.
  static constexpr int kFirstAccumulate = 1;
  __device__ static void start(Acc& acc) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc.d[i] = 8388608.f;
  }
  // acc: the chain's sums, 2^23 + an integer below 2^23, so the float's low
  // mantissa bits are the integer's; prev: the parities packed at the
  // chain's previous m-tile (0 at its start).  gather_byte packs lane tig's
  // 8 bits of chunk tig, and the XOR with prev leaves this m-tile's.
  __device__ static void emit(const Acc& acc, uint32_t& prev, uint8_t* o, int pitch, int tig,
                              int live) {
    int u[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) u[i] = __float_as_int(acc.d[i]);
    // byte 0: column gid, byte 1: column gid + 8 (gather_byte's bits above
    // 7 are not the byte's)
    const uint32_t carried = __byte_perm(gather_byte(u, 0), gather_byte(u, 2), 0x0040);
    const uint32_t x = carried ^ prev;
    prev = carried;
    if (tig < live) {
      o += tig * pitch;
      o[0] = (uint8_t)x;
      o[8] = (uint8_t)(x >> 8);
    }
  }
};

// The body of both tensor-core grouped kernels.  Op::kWords words (4 chunks
// each) a chunk group, `groups` groups, stages of COLS columns; the
// kPassChunks output chunks from kPassChunks·blockIdx.y on.  data (S, k, L)
// uint8; mat the operand Op takes; out (S, m, L) uint8.  vec16: L and tile
// are multiples of 16.  Each warp runs its own ring over its own stages (the
// block's stages warp, warp + 4, ...); the warps meet only in the
// warpgroup's products, one m64 tile = 16 columns of each warp at a time.
template <class Op, int COLS>
__device__ __forceinline__ void grouped_tc(uint8_t* smem, const uint8_t* __restrict__ data,
                                           const uint8_t* __restrict__ mat,
                                           uint8_t* __restrict__ out, int k, int m, int g,
                                           int groups, long long L, int tile, long long tiles,
                                           int vec16) {
  constexpr int KS = Op::kWords;
  constexpr int kCols = COLS;
  constexpr int kTiles = COLS / 16;   // m-tiles of a stage
  constexpr int kPitch = COLS + 16;   // bytes a staged output row
  constexpr int kWarps = kTcThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int gid = lane >> 2;  // mma's groupID
  const int tig = lane & 3;   // mma's thread in group
  const int steps = KS * groups;  // words of all chunk groups
  // the operand, then the warps': [kStages][k][kCols] bytes, [steps][kCols]
  // words, [kPassChunks][kPitch] bytes
  uint8_t* operand = smem;
  uint8_t* ring =
      smem + steps * Op::kWordBytes + warp * grouped_warp_bytes(k, steps, COLS);
  uint32_t* words = reinterpret_cast<uint32_t*>(ring + kStages * k * kCols);
  uint8_t* staged = reinterpret_cast<uint8_t*>(words + steps * kCols);
  const int first = kPassChunks * blockIdx.y;  // the pass's first output chunk
  const int live = min(kPassChunks, m - first);

  Op::stage(operand, mat, steps, first, m);
  // the product reads shared memory through the async proxy
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  __syncthreads();

  const long long grp = blockIdx.x / tiles;
  const long long tt = blockIdx.x - grp * tiles;
  const int per_stripe = (tile + kCols - 1) / kCols;
  const int stages = g * per_stripe;
  // every warp runs the same number of rounds (the products are
  // collective); a round past the warp's last stage codes stale bytes and
  // stores nothing
  const int rounds = (stages + kWarps - 1) / kWarps;
  struct Stage {
    long long stripe, col0;
    int cols;
  };
  auto stage = [&](int j) {  // the warp's stage j: `cols` columns of a stripe from col0
    const int q = warp + j * kWarps;
    const int s = q / per_stripe;
    const int st = q - s * per_stripe;
    return Stage{grp * g + s, tt * tile + (long long)st * kCols, min(kCols, tile - st * kCols)};
  };
  auto valid = [&](int j) { return warp + j * kWarps < stages; };
  auto load = [&](int j) {
    const Stage sg = stage(j);
    const uint8_t* from = data + sg.stripe * k * L + sg.col0;
    uint8_t* slot = ring + (j % kStages) * k * kCols;
    if (vec16) {
      for (int i = lane; i < k * (kCols / 16); i += 32) {
        const int c = i / (kCols / 16);
        const int v = i - c * (kCols / 16);
        if (v * 16 < sg.cols) cp_async16(slot + c * kCols + v * 16, from + c * L + v * 16);
      }
    } else {
      for (int i = lane; i < k * (kCols / 4); i += 32) {
        const int c = i / (kCols / 4);
        const int v = i - c * (kCols / 4);
        if (v * 4 < sg.cols) cp_async4(slot + c * kCols + v * 4, from + c * L + v * 4);
      }
    }
  };
  // slot -> words: W[t][c] = bytes of chunks 4t..4t+3 at column c (chunks
  // past k zero), columns stored 0, 8, 1, 9, ... 7, 15 within each 16
  auto transpose = [&](int j) {
    const uint8_t* slot = ring + (j % kStages) * k * kCols;
    const int kt = (k + 3) / 4;
    for (int i = lane; i < kt * (kCols / 16); i += 32) {
      const int t = i / (kCols / 16);
      const int v = i - t * (kCols / 16);
      uint4 r[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        r[e] = 4 * t + e < k
                   ? *reinterpret_cast<const uint4*>(slot + (4 * t + e) * kCols + v * 16)
                   : make_uint4(0u, 0u, 0u, 0u);
      uint32_t o[16];
      transpose4(r[0].x, r[1].x, r[2].x, r[3].x, o);
      transpose4(r[0].y, r[1].y, r[2].y, r[3].y, o + 4);
      transpose4(r[0].z, r[1].z, r[2].z, r[3].z, o + 8);
      transpose4(r[0].w, r[1].w, r[2].w, r[3].w, o + 12);
      uint4* w = reinterpret_cast<uint4*>(words + t * kCols + v * 16);
      w[0] = make_uint4(o[0], o[8], o[1], o[9]);
      w[1] = make_uint4(o[2], o[10], o[3], o[11]);
      w[2] = make_uint4(o[4], o[12], o[5], o[13]);
      w[3] = make_uint4(o[6], o[14], o[7], o[15]);
    }
  };
  // A of m-tile mt, words t0..t0 + KS - 1
  auto load_a = [&](int mt, int t0, typename Op::Frag& f) {
    Op::load_a(words + t0 * kCols + mt * 16 + 2 * gid, kCols, tig, f);
  };
  auto emit = [&](const typename Op::Acc& acc, uint32_t& prev, int mt) {
    Op::emit(acc, prev, staged + mt * 16 + gid, kPitch, tig, live);
  };

#pragma unroll 1
  for (int p = 0; p < kStages - 1; ++p) {
    if (p < rounds && valid(p)) load(p);
    cp_async_commit();  // possibly empty, so that the group count is the stage count
  }
#pragma unroll 1
  for (int j = 0; j < rounds; ++j) {
    cp_async_wait_oldest();
    // stage j has landed for every lane; every lane is done with the words,
    // the staged output and the slot the next load overwrites
    __syncwarp();
    if (j + kStages - 1 < rounds && valid(j + kStages - 1)) load(j + kStages - 1);
    cp_async_commit();
    transpose(j);
    __syncwarp();
    if (groups == 1) {
      // m-tile mt's product runs while the lanes pack m-tile mt - 1's sums
      // and load m-tile mt + 1's A
      typename Op::Acc d[2];
      typename Op::Frag a[2];
      uint32_t prev[2] = {0u, 0u};  // the two chains' (m-tiles mt % 2) last parities
      Op::start(d[0]);
      Op::start(d[1]);
      load_a(0, 0, a[0]);
#pragma unroll
      for (int mt = 0; mt < kTiles; ++mt) {
        Op::pin_sums(d[mt & 1]);
        wgmma_fence();
        Op::mma(d[mt & 1], a[mt & 1], operand, 0, Op::kFirstAccumulate);
        wgmma_commit();
        if (mt > 0) {
          wgmma_wait<1>();
          Op::pin_sums(d[(mt - 1) & 1]);
          emit(d[(mt - 1) & 1], prev[(mt - 1) & 1], mt - 1);
        }
        if (mt + 1 < kTiles) load_a(mt + 1, 0, a[(mt + 1) & 1]);
      }
      wgmma_wait<0>();
      Op::pin_sums(d[(kTiles - 1) & 1]);
      emit(d[(kTiles - 1) & 1], prev[(kTiles - 1) & 1], kTiles - 1);
    } else {
      // the sums kept over the chunk groups, one group at a time
#pragma unroll 1
      for (int mt = 0; mt < kTiles; ++mt) {
        typename Op::Acc d;
        uint32_t prev = 0u;
        Op::start(d);
#pragma unroll 1
        for (int gr = 0; gr < groups; ++gr) {
          typename Op::Frag a;
          load_a(mt, gr * KS, a);
          Op::pin_sums(d);
          wgmma_fence();
          Op::mma(d, a, operand, gr * KS, gr > 0 || Op::kFirstAccumulate);
          wgmma_commit();
          wgmma_wait<0>();
          Op::pin_sums(d);
        }
        emit(d, prev, mt);
      }
    }
    __syncwarp();
    if (!valid(j)) continue;
    const Stage sg = stage(j);
    uint8_t* to = out + (sg.stripe * m + first) * L + sg.col0;
    if (vec16) {
      for (int i = lane; i < live * (kCols / 16); i += 32) {
        const int r = i / (kCols / 16);
        const int v = i - r * (kCols / 16);
        if (v * 16 < sg.cols)
          *reinterpret_cast<uint4*>(to + r * L + v * 16) =
              *reinterpret_cast<const uint4*>(staged + r * kPitch + v * 16);
      }
    } else {
      for (int i = lane; i < live * (kCols / 4); i += 32) {
        const int r = i / (kCols / 4);
        const int v = i - r * (kCols / 4);
        if (v * 4 < sg.cols)
          *reinterpret_cast<uint32_t*>(to + r * L + v * 4) =
              *reinterpret_cast<const uint32_t*>(staged + r * kPitch + v * 4);
      }
    }
  }
}

// KS k-steps (words of 4 chunks) a chunk group, stages of COLS columns:
// grouped_tc with the int8 operand (imma_operand, (8m, 32·KS·groups)).
template <int KS, int COLS>
__global__ void __launch_bounds__(kTcThreads)
grouped_imma_kernel(const uint8_t* __restrict__ data, const uint8_t* __restrict__ mat,
                    uint8_t* __restrict__ out, int k, int m, int g, int groups, long long L,
                    int tile, long long tiles, int vec16) {
  extern __shared__ __align__(1024) uint8_t smem[];
  grouped_tc<ImmaOp<KS>, COLS>(smem, data, mat, out, k, m, g, groups, L, tile, tiles, vec16);
}

// KS words a chunk group, stages of COLS columns: grouped_tc with the bf16
// operand (hgmma_operand, (8m, 32·KS·groups) bf16).
template <int KS, int COLS>
__global__ void __launch_bounds__(kTcThreads)
grouped_hgmma_kernel(const uint8_t* __restrict__ data, const uint8_t* __restrict__ mat,
                     uint8_t* __restrict__ out, int k, int m, int g, int groups, long long L,
                     int tile, long long tiles, int vec16) {
  extern __shared__ __align__(1024) uint8_t smem[];
  grouped_tc<HgmmaOp<KS>, COLS>(smem, data, mat, out, k, m, g, groups, L, tile, tiles, vec16);
}

__device__ __forceinline__ uint32_t byte_popcounts(uint32_t x) {
  x = x - ((x >> 1) & 0x55555555u);
  x = (x & 0x33333333u) + ((x >> 2) & 0x33333333u);
  return (x + (x >> 4)) & 0x0f0f0f0fu;
}

__global__ void __launch_bounds__(kExpandThreads)
expand_only_kernel(const uint4* __restrict__ data, uint4* __restrict__ out, int k,
                   long long vecs, int tile_vecs, long long tiles) {
  const long long s = blockIdx.x / tiles;
  const long long t = blockIdx.x - s * tiles;
  const uint4* src = data + s * k * vecs + t * tile_vecs;
  uint4* dst = out + s * vecs + t * tile_vecs;
#pragma unroll 1
  for (int v = threadIdx.x; v < tile_vecs; v += kExpandThreads) {
    uint4 sum = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 4
    for (int j = 0; j < k; ++j) {
      const uint4 w = src[(long long)j * vecs + v];
      sum.x += byte_popcounts(w.x);
      sum.y += byte_popcounts(w.y);
      sum.z += byte_popcounts(w.z);
      sum.w += byte_popcounts(w.w);
    }
    dst[v] = sum;
  }
}

// The grid of (stripes / per_block)·(L / tile) blocks, or 0 when the TPU
// grid would be empty or leave output unwritten.
long long grid_blocks(long long stripes, int per_block, long long L, int tile, int align) {
  if (stripes <= 0 || per_block <= 0 || stripes % per_block != 0) return 0;
  if (tile <= 0 || tile % align != 0 || L < tile || L % tile != 0) return 0;
  const long long blocks = stripes / per_block * (L / tile);
  return blocks > 0x7fffffffLL ? 0 : blocks;
}

using GroupedKernel = void (*)(const uint8_t*, const uint8_t*, uint8_t*, int, int, int, int,
                               long long, int, long long, int);

// The shared memory a block may opt in to on the current device.
cudaError_t shared_limit(int* limit) {
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  return cudaDeviceGetAttribute(limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
}

// Launch a tensor-core grouped kernel on (blocks, passes) with `shared`
// bytes; returns cudaGetLastError() after the launch.
int launch_grouped(GroupedKernel kernel, size_t shared, long long blocks, int passes,
                   const void* data, void* out, const void* mat, int k, int m, int g, int groups,
                   long long L, int tile, void* stream) {
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
  if (err != cudaSuccess) return (int)err;
  const int vec16 = L % 16 == 0 && tile % 16 == 0;
  kernel<<<dim3((unsigned)blocks, (unsigned)passes), kTcThreads, shared,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<const uint8_t*>(mat),
      static_cast<uint8_t*>(out), k, m, g, groups, L, tile, L / tile, vec16);
  return (int)cudaGetLastError();
}

}  // namespace

// data: (stripes, k, L) uint8; mat: imma_operand (kern_exp.py), (8m,
// 32·steps) int8 with steps = KS·groups of grouped_imma_kernel, row-major;
// out: (stripes, m, L) uint8.  All 16-byte aligned.  stripes % g == 0,
// tile % 4 == 0, L % tile == 0, L >= tile, g·k <= 96, any m >= 1.  Returns
// cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without launching; does not synchronise.
extern "C" int bitmatrix_grouped_imma_launch(const void* data, void* out, const void* mat,
                                             long long stripes, int k, int m, long long L,
                                             int g, int tile, void* stream) {
  const long long blocks = grid_blocks(stripes, g, L, tile, 4);
  if (blocks == 0 || k <= 0 || m <= 0 || g * k > kMaxGroupedWords)
    return (int)cudaErrorInvalidValue;
  // chunk groups of at most kImmaMaxSteps k-steps, as even as they go;
  // passes of kPassChunks output chunks
  const int kt = (k + 3) / 4;
  const int groups = (kt + kImmaMaxSteps - 1) / kImmaMaxSteps;
  const int ks = (kt + groups - 1) / groups;
  const int passes = (m + kPassChunks - 1) / kPassChunks;
  if (passes > 65535) return (int)cudaErrorInvalidValue;
#define GROUPED_IMMA_ROW(COLS)                                                            \
  {grouped_imma_kernel<1, COLS>, grouped_imma_kernel<2, COLS>,                            \
   grouped_imma_kernel<3, COLS>, grouped_imma_kernel<4, COLS>,                            \
   grouped_imma_kernel<5, COLS>, grouped_imma_kernel<6, COLS>,                            \
   grouped_imma_kernel<7, COLS>, grouped_imma_kernel<8, COLS>}
  static const GroupedKernel kernels[2][kImmaMaxSteps] = {GROUPED_IMMA_ROW(kTcWideCols),
                                                          GROUPED_IMMA_ROW(kImmaNarrowCols)};
#undef GROUPED_IMMA_ROW
  int limit = 0;
  const cudaError_t err = shared_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  constexpr int kWordBytes = ImmaOp<1>::kWordBytes;
  const bool wide = grouped_shared_bytes(k, ks * groups, kTcWideCols, kWordBytes) <= (size_t)limit;
  const size_t shared =
      grouped_shared_bytes(k, ks * groups, wide ? kTcWideCols : kImmaNarrowCols, kWordBytes);
  return launch_grouped(kernels[wide ? 0 : 1][ks - 1], shared, blocks, passes, data, out, mat, k,
                        m, g, groups, L, tile, stream);
}

// data, out and shapes as bitmatrix_grouped_imma_launch's; mat:
// hgmma_operand (kern_exp.py), (8m, 32·words) bf16 with words = KS·groups
// of grouped_hgmma_kernel, row-major.  Returns as above.
extern "C" int bitmatrix_grouped_hgmma_launch(const void* data, void* out, const void* mat,
                                              long long stripes, int k, int m, long long L,
                                              int g, int tile, void* stream) {
  const long long blocks = grid_blocks(stripes, g, L, tile, 4);
  if (blocks == 0 || k <= 0 || m <= 0 || g * k > kMaxGroupedWords)
    return (int)cudaErrorInvalidValue;
  // chunk groups of at most kHgmmaMaxWords words, as even as they go;
  // passes of kPassChunks output chunks
  const int kt = (k + 3) / 4;
  const int groups = (kt + kHgmmaMaxWords - 1) / kHgmmaMaxWords;
  const int ks = (kt + groups - 1) / groups;
  const int passes = (m + kPassChunks - 1) / kPassChunks;
  if (passes > 65535) return (int)cudaErrorInvalidValue;
  static const GroupedKernel wide_kernels[kHgmmaMaxWords] = {
      grouped_hgmma_kernel<1, kTcWideCols>, grouped_hgmma_kernel<2, kTcWideCols>,
      grouped_hgmma_kernel<3, kTcWideCols>, grouped_hgmma_kernel<4, kTcWideCols>};
  int limit = 0;
  const cudaError_t err = shared_limit(&limit);
  if (err != cudaSuccess) return (int)err;
  constexpr int kWordBytes = HgmmaOp<1>::kWordBytes;
  const bool wide = grouped_shared_bytes(k, ks * groups, kTcWideCols, kWordBytes) <= (size_t)limit;
  // 256-column stages hold every k <= 48, so narrow ones come with
  // kHgmmaMaxWords words a group
  if (!wide && ks != kHgmmaMaxWords) return (int)cudaErrorInvalidValue;
  const size_t shared =
      grouped_shared_bytes(k, ks * groups, wide ? kTcWideCols : kHgmmaNarrowCols, kWordBytes);
  return launch_grouped(
      wide ? wide_kernels[ks - 1] : grouped_hgmma_kernel<kHgmmaMaxWords, kHgmmaNarrowCols>,
      shared, blocks, passes, data, out, mat, k, m, g, groups, L, tile, stream);
}

// planes: (stripes, cols, L) bf16 with cols = 8k <= 128; mat: (rows,
// 16·ceil(cols/16)) bf16, its columns from `cols` on zero, with rows = 8m in
// {8, 16, 24, 32}; out: (stripes, rows, L) uint8.  tile % 128 == 0,
// L % tile == 0, L >= tile.  Returns as above.
extern "C" int bitmatrix_mm_only_launch(const void* planes, void* out, const void* mat,
                                        long long stripes, int cols, int rows, long long L,
                                        int tile, void* stream) {
  const long long blocks = grid_blocks(stripes, 1, L, tile, kMmStageCols);
  if (blocks == 0 || cols <= 0 || cols > kMaxMmCols || rows % 8 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int nt = rows / 8;
  const int ks = (cols + 15) / 16;
  if (nt < 1 || nt > 4) return (int)cudaErrorInvalidValue;
  using Kernel = void (*)(const uint16_t*, const uint32_t*, uint8_t*, int, long long, int,
                          long long);
#define MM_ONLY_ROW(NT)                                                                   \
  {mm_only_kernel<NT, 1>, mm_only_kernel<NT, 2>, mm_only_kernel<NT, 3>,                   \
   mm_only_kernel<NT, 4>, mm_only_kernel<NT, 5>, mm_only_kernel<NT, 6>,                   \
   mm_only_kernel<NT, 7>, mm_only_kernel<NT, 8>}
  static const Kernel kernels[4][8] = {MM_ONLY_ROW(1), MM_ONLY_ROW(2), MM_ONLY_ROW(3),
                                       MM_ONLY_ROW(4)};
#undef MM_ONLY_ROW
  const Kernel kernel = kernels[nt - 1][ks - 1];
  const size_t shared = mm_only_shared_bytes(nt, ks);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)shared);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)blocks, kMmThreads, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(planes), static_cast<const uint32_t*>(mat),
      static_cast<uint8_t*>(out), cols, L, tile, L / tile);
  return (int)cudaGetLastError();
}

// data: (stripes, k, L) uint8 with k <= 31; out: (stripes, 1, L) uint8.
// tile % 16 == 0, L % tile == 0, L >= tile.  Returns as above.
extern "C" int bitmatrix_expand_only_launch(const void* data, void* out, long long stripes,
                                            int k, long long L, int tile, void* stream) {
  const long long blocks = grid_blocks(stripes, 1, L, tile, 16);
  if (blocks == 0 || k <= 0 || k > 31) return (int)cudaErrorInvalidValue;
  expand_only_kernel<<<(unsigned)blocks, kExpandThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(data), static_cast<uint4*>(out), k, L / 16, tile / 16,
      L / tile);
  return (int)cudaGetLastError();
}
