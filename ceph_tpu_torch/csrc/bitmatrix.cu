// The bit-matrix kernels of the kern_exp.py experiment, for Hopper (sm_90a).
// mm_only runs on the tensor cores (bf16 mma.sync); grouped and expand_only
// still run on the CUDA cores.
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
// the script's variant names keep their meaning.  The operand is a runtime
// argument read as given, zero blocks included, as the MXU multiplies them;
// g, k and m are runtime arguments, so one library serves every matrix and
// every variant (mm_only has one instance per (8m/8, ceil(8k/16))).
//
// grouped (CUDA cores): a thread covers 4 consecutive byte columns (one
// 32-bit word of each of the g·k chunks).  It stages its g·k words in its
// own column of shared memory, then computes 8 output rows at a time (the
// 8 bits of one output byte, 32 accumulators): for each plane it extracts
// the 4 column bits once and multiply-adds them into the 8 rows, reading
// the operand with warp-uniform loads.  The product does 8mg·8kg
// multiply-adds per column, g times what the coding needs.
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
// (8m, 8k) product it needs is 5.15e10 multiply-adds, 0.1042 ms at the
// dense bf16 tensor rate.  On the CUDA cores that product takes 1.5·g ms
// (5.15e10·g multiply-adds at the float32 rate of 33.5e12 per second):
// far above the bound; the tensor cores are the work of a later redesign.
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

constexpr int kGroupedThreads = 128;
// A grouped thread stages g·k 32-bit words; at most 48 KiB for the block.
constexpr int kMaxGroupedWords = 96;
constexpr int kMmThreads = 128;     // 4 warps, 32 columns of a stage each
constexpr int kMmStageCols = 128;   // columns of every plane in one ring stage
constexpr int kMmStages = 3;        // ring depth: 2 stages in flight while 1 is read
constexpr int kMmPitch = kMmStageCols + 8;      // bf16 a staged plane row
constexpr int kMmOutPitch = kMmStageCols + 16;  // bytes a staged output row
constexpr int kMaxMmCols = 128;     // 8k columns of the mm_only operand
constexpr int kExpandThreads = 256;

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits) {
  return __uint_as_float(bits << 16);
}

struct Bf16Operand {
  using Raw = uint16_t;
  using Acc = float;
  static __device__ __forceinline__ float value(uint16_t v) { return bf16_bits_to_float(v); }
  // the TPU kernel's acc.astype(int32) & 1: a truncating cast
  static __device__ __forceinline__ uint32_t parity(float acc) { return (uint32_t)(int)acc & 1u; }
};

struct Int8Operand {
  using Raw = int8_t;
  using Acc = int;
  static __device__ __forceinline__ int value(int8_t v) { return v; }
  static __device__ __forceinline__ uint32_t parity(int acc) { return (uint32_t)acc & 1u; }
};

template <class Op>
__global__ void __launch_bounds__(kGroupedThreads)
grouped_kernel(const uint32_t* __restrict__ data, const typename Op::Raw* __restrict__ mat,
               uint32_t* __restrict__ out, int k, int m, int g, long long words,
               int tile_words, long long tiles) {
  using Acc = typename Op::Acc;
  extern __shared__ uint32_t staged[];  // [g·k][kGroupedThreads]: a column per thread
  const long long grp = blockIdx.x / tiles;
  const long long t = blockIdx.x - grp * tiles;
  const int cols = 8 * k * g;
  const int rows = 8 * m * g;
  const uint32_t* src = data + grp * g * k * words + t * tile_words;
  uint32_t* dst = out + grp * g * m * words + t * tile_words;
  uint32_t* mine = staged + threadIdx.x;
#pragma unroll 1
  for (int v = threadIdx.x; v < tile_words; v += kGroupedThreads) {
#pragma unroll 1
    for (int c = 0; c < g * k; ++c) mine[c * kGroupedThreads] = src[(long long)c * words + v];
    // rows r0..r0+7 are the bits of output chunk (r0/8) % m of stripe r0/(8m)
#pragma unroll 1
    for (int r0 = 0; r0 < rows; r0 += 8) {
      Acc acc[8][4];
#pragma unroll
      for (int rr = 0; rr < 8; ++rr)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[rr][q] = 0;
      const typename Op::Raw* base = mat + (long long)r0 * cols;
#pragma unroll 1
      for (int s = 0; s < g; ++s) {
#pragma unroll 1
        for (int j = 0; j < k; ++j) {
          const uint32_t w = mine[(s * k + j) * kGroupedThreads];
          const typename Op::Raw* col = base + s * 8 * k + j;  // plane b: col[b·k]
#pragma unroll
          for (int b = 0; b < 8; ++b) {
            Acc p[4];
#pragma unroll
            for (int q = 0; q < 4; ++q) p[q] = (Acc)((w >> (8 * q + b)) & 1u);
#pragma unroll
            for (int rr = 0; rr < 8; ++rr) {
              const Acc a = Op::value(col[rr * cols + b * k]);
#pragma unroll
              for (int q = 0; q < 4; ++q) acc[rr][q] += a * p[q];
            }
          }
        }
      }
      uint32_t packed = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int rr = 0; rr < 8; ++rr) packed |= Op::parity(acc[rr][q]) << (8 * q + rr);
      dst[(long long)(r0 / 8) * words + v] = packed;
    }
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most kMmStages - 2 groups are pending: the oldest stage landed
__device__ __forceinline__ void cp_async_wait_oldest() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kMmStages - 2) : "memory");
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
  return (size_t)kMmStages * 16 * ks * kMmPitch * sizeof(uint16_t) +
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
  // [kMmStages][kDepth][kMmPitch] bf16, then [kRows][kMmOutPitch] bytes
  uint16_t* ring = reinterpret_cast<uint16_t*>(smem);
  uint8_t* staged = smem + kMmStages * kDepth * kMmPitch * sizeof(uint16_t);
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
  for (int i = threadIdx.x; i < kMmStages * (kDepth - cols) * (kMmPitch / 8); i += kMmThreads) {
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
    uint16_t* slot = ring + (st % kMmStages) * kDepth * kMmPitch;
    const uint16_t* from = src + st * kMmStageCols;
    for (int i = threadIdx.x; i < cols * (kMmStageCols / 8); i += kMmThreads) {
      const int c = i / (kMmStageCols / 8);
      const int v = i - c * (kMmStageCols / 8);
      cp_async16(slot + c * kMmPitch + v * 8, from + c * L + v * 8);
    }
  };
#pragma unroll 1
  for (int p = 0; p < kMmStages - 1; ++p) {
    if (p < stages) load(p);
    cp_async_commit();  // possibly empty, so that the group count is the stage count
  }
#pragma unroll 1
  for (int st = 0; st < stages; ++st) {
    cp_async_wait_oldest();
    // stage st has landed for every thread, and every warp is done with
    // the slot the next load overwrites and with the staged output
    __syncthreads();
    if (st + kMmStages - 1 < stages) load(st + kMmStages - 1);
    cp_async_commit();

    const uint16_t* slot = ring + (st % kMmStages) * kDepth * kMmPitch;
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

}  // namespace

// data: (stripes, k, L) uint8; mat: (8mg, 8kg) bf16 (int8_operand == 0) or
// int8, row-major; out: (stripes, m, L) uint8.  All 16-byte aligned.
// stripes % g == 0, tile % 4 == 0, L % tile == 0, L >= tile, g·k <= 96.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue without launching; does not synchronise.
extern "C" int bitmatrix_grouped_launch(const void* data, void* out, const void* mat,
                                        long long stripes, int k, int m, long long L,
                                        int g, int tile, int int8_operand, void* stream) {
  const long long blocks = grid_blocks(stripes, g, L, tile, 4);
  if (blocks == 0 || k <= 0 || m <= 0 || g * k > kMaxGroupedWords)
    return (int)cudaErrorInvalidValue;
  const size_t shared = (size_t)g * k * kGroupedThreads * sizeof(uint32_t);
  auto st = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const uint32_t*>(data);
  auto dst = static_cast<uint32_t*>(out);
  if (int8_operand)
    grouped_kernel<Int8Operand><<<(unsigned)blocks, kGroupedThreads, shared, st>>>(
        in, static_cast<const int8_t*>(mat), dst, k, m, g, L / 4, tile / 4, L / tile);
  else
    grouped_kernel<Bf16Operand><<<(unsigned)blocks, kGroupedThreads, shared, st>>>(
        in, static_cast<const uint16_t*>(mat), dst, k, m, g, L / 4, tile / 4, L / tile);
  return (int)cudaGetLastError();
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
