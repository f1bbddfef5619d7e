// The bit-matrix kernels of the kern_exp.py experiment, for Hopper (sm_90a),
// on the CUDA cores.
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
// the script's variant names keep their meaning.  The MXU product of the
// TPU is a loop of CUDA-core multiply-adds here: no tensor cores, no TMA,
// no cp.async.  The operand is a runtime argument read as given, zero
// blocks included, as the MXU multiplies them; g, k and m are runtime
// arguments, so one library serves every matrix and every variant.
//
// grouped: a thread covers 4 consecutive byte columns (one 32-bit word of
// each of the g·k chunks).  It stages its g·k words in its own column of
// shared memory, then computes 8 output rows at a time (the 8 bits of one
// output byte, 32 accumulators): for each plane it extracts the 4 column
// bits once and multiply-adds them into the 8 rows, reading the operand
// with warp-uniform loads.  The product does 8mg·8kg multiply-adds per
// column, g times what the coding needs.
// mm_only: a thread covers 4 columns and keeps all 8m rows in registers
// (8m <= 32), reading 8 bytes of planes per plane row; the operand is
// staged transposed in shared memory as float, 4 rows per 16-byte read.
// expand_only: 16-byte vectors; bytewise popcounts on 32-bit words by the
// 0x55/0x33/0x0f SWAR steps, summed over the k chunks (8k <= 255, so no
// byte carries into the next).
//
// Bound on an H100 SXM at (256, 8, 131072), RS(8,3): bytes for all three.
// grouped moves (k + m)·S·L = 369,098,752 B, 0.1102 ms at 3.35 TB/s; the
// (8m, 8k) product it needs is 5.15e10 multiply-adds, 0.1042 ms at the
// dense bf16 tensor rate.  mm_only moves (2·8k + 8m)·S·L B, 1.5225 ms.
// expand_only moves (k + 1)·S·L B, 0.0901 ms.  On the CUDA cores the
// grouped and mm_only products are far above their bounds (5.15e10·g
// multiply-adds at the float32 rate of 33.5e12 per second take 1.5·g ms);
// the tensor cores are the work of a later redesign.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroupedThreads = 128;
// A grouped thread stages g·k 32-bit words; at most 48 KiB for the block.
constexpr int kMaxGroupedWords = 96;
constexpr int kMmThreads = 128;
constexpr int kMaxMmCols = 128;  // 8k columns of the mm_only operand
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

template <int ROWS>
__global__ void __launch_bounds__(kMmThreads)
mm_only_kernel(const uint2* __restrict__ planes, const uint16_t* __restrict__ mat,
               uint32_t* __restrict__ out, int cols, long long quads, int tile_quads,
               long long tiles) {
  __shared__ float4 mt[kMaxMmCols * ROWS / 4];  // operand transposed: [c][ROWS] floats
  float* mtf = reinterpret_cast<float*>(mt);
  for (int i = threadIdx.x; i < ROWS * cols; i += kMmThreads) {
    const int r = i / cols;
    const int c = i - r * cols;
    mtf[c * ROWS + r] = bf16_bits_to_float(mat[i]);
  }
  __syncthreads();
  const long long s = blockIdx.x / tiles;
  const long long t = blockIdx.x - s * tiles;
  const uint2* src = planes + s * cols * quads + t * tile_quads;
  uint32_t* dst = out + s * ROWS * quads + t * tile_quads;
#pragma unroll 1
  for (int v = threadIdx.x; v < tile_quads; v += kMmThreads) {
    float acc[ROWS][4];
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;
#pragma unroll 2
    for (int c = 0; c < cols; ++c) {
      const uint2 x = src[(long long)c * quads + v];  // 4 bf16 columns of plane c
      const float p[4] = {bf16_bits_to_float(x.x & 0xffffu), bf16_bits_to_float(x.x >> 16),
                          bf16_bits_to_float(x.y & 0xffffu), bf16_bits_to_float(x.y >> 16)};
#pragma unroll
      for (int r4 = 0; r4 < ROWS / 4; ++r4) {
        const float4 a = mt[c * (ROWS / 4) + r4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[4 * r4 + 0][q] += a.x * p[q];
          acc[4 * r4 + 1][q] += a.y * p[q];
          acc[4 * r4 + 2][q] += a.z * p[q];
          acc[4 * r4 + 3][q] += a.w * p[q];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      uint32_t packed = 0;
      // astype(int32) truncates, astype(uint8) keeps the low byte
#pragma unroll
      for (int q = 0; q < 4; ++q) packed |= ((uint32_t)(int)acc[r][q] & 0xffu) << (8 * q);
      dst[(long long)r * quads + v] = packed;
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

// planes: (stripes, cols, L) bf16 with cols = 8k <= 128; mat: (rows, cols)
// bf16 with rows = 8m in {8, 16, 24, 32}; out: (stripes, rows, L) uint8.
// tile % 4 == 0, L % tile == 0, L >= tile.  Returns as above.
extern "C" int bitmatrix_mm_only_launch(const void* planes, void* out, const void* mat,
                                        long long stripes, int cols, int rows, long long L,
                                        int tile, void* stream) {
  const long long blocks = grid_blocks(stripes, 1, L, tile, 4);
  if (blocks == 0 || cols <= 0 || cols > kMaxMmCols) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  auto in = static_cast<const uint2*>(planes);
  auto a = static_cast<const uint16_t*>(mat);
  auto dst = static_cast<uint32_t*>(out);
  switch (rows) {
#define MM_ONLY_CASE(R)                                                              \
  case R:                                                                            \
    mm_only_kernel<R><<<(unsigned)blocks, kMmThreads, 0, st>>>(in, a, dst, cols, L / 4, \
                                                               tile / 4, L / tile);  \
    break;
    MM_ONLY_CASE(8)
    MM_ONLY_CASE(16)
    MM_ONLY_CASE(24)
    MM_ONLY_CASE(32)
#undef MM_ONLY_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
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
