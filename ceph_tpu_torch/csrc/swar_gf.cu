// Fused SWAR bitsliced GF(2^8) coding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ceph_tpu/ops/pallas_gf.py::_swar_kernel
// (launched by _gf_code_swar through pl.pallas_call).  Same function:
//   in  (S, k, L) uint8, L a multiple of 16 (the codec gives multiples of 128)
//   out (S, m, L) uint8
// where bit r of output byte i is the XOR, over the set entries of row 8i+r
// of expand_matrix(gf_matrix), of bit b of the matching byte of chunk j.
//
// Arithmetic.  The TPU kernel XORs the bit-planes (w >> b) & 0x01010101 of
// 32-bit words that a schedule, baked in at trace time, names for each
// output bit-row.  By linearity that XOR is the bytewise parity of
//     t_r = XOR_j (w_j & M[8i+r][j])          (one LOP3 per word)
// where M[o][j] is the 8-bit mask of the planes of chunk j that feed bit-row
// o, repeated in the 4 bytes of the word.  So the work per word does not
// depend on how dense the matrix is, and the matrix is a runtime operand:
// one library serves every encode matrix and every decode matrix of the
// coder LRU (an nvcc build costs seconds; the LRU holds 2516 patterns).
//
// One joint parity fold per output byte-row.  Instead of folding each of
// the 8 accumulators t_0..t_7 to its bytewise parity and placing it, the 8
// are merged pairwise in three levels, s = 4, 2, 1:
//     merge_s(a, b) = ((a ^ (a >> s)) & lo_s) | ((b ^ (b << s)) & ~lo_s)
// with lo_4 = 0x0F0F0F0F, lo_2 = 0x33333333, lo_1 = 0x55555555, pairing
// (r, r+4) at s = 4, (r, r+2) at s = 2 and (0, 1) at s = 1, so that bit r of
// each byte of the one word left is the parity of t_r's byte.  The first
// level is linear in the chunk words, so it is moved into the accumulate:
// with ws = w with the nibbles of each byte swapped,
//     merge_4(t_p, t_{p+4}) = XOR_j ((w_j & A[p][j]) ^ (ws_j & B[p][j]))
// where A takes the low nibble of M[p] and the high nibble of M[p+4], and B
// the high nibble of M[p] and the low nibble of M[p+4], each moved to the
// other half (ops/swar_gf.py::schedule_masks builds them).  That is still
// 2 LOP3 per (pair, chunk), 8 per (output row, chunk) as before, plus 3 ops
// per chunk word for ws, and leaves 4 accumulators per output row instead
// of 8 and 3 merges (of 5 ops) instead of 7.
//
// Per 32-bit word position, for RS(8,3): 8·m·k = 192 LOP3, 3·k = 24 for the
// nibble swaps, 3·5·m = 45 for the fold: 261 integer ops (its first version:
// 384: a parity fold of 7 ops and a placement of 2 for each of the 24
// bit-rows).  On the ALU pipe that is fewer still: a left shift issues as
// IMAD.SHL on the FMA pipe.  The accumulate is written as explicit LOP3s
// (xor_and): left to itself nvcc reassociates the XOR chain into an AND,
// an AND-XOR and an XOR per pair, 32 LOP3 per chunk word where 25 do.
//
// Layout on the card:
//   * The output rows are cut into passes of at most 4 rows, as evenly as
//     possible (m = 6: two passes of 3), one pass per blockIdx.z.  A block
//     copies its pass's operand, (k, rows, 8) uint32 (768 B for RS(8,3)),
//     into shared memory once; the masks one chunk needs for one output row
//     are 8 contiguous words, read as two 16-byte loads that every lane makes
//     at the same address (a broadcast, no bank conflict), one load per four
//     masks.
//   * A thread codes one 16-byte vector (4 words) of each stripe it visits:
//     the k chunks are loaded 4 at a time (LDG.128, neighbouring threads on
//     neighbouring addresses), the next 4 (or the next stripe's first 4)
//     in flight while it codes these, and it stores 16 bytes for each row of
//     the pass.  A 2-D block (vectors x stripes, 256 threads) and a 2-D grid
//     (vector blocks x stripe blocks, one wave of resident blocks) give each
//     thread its vector and its first stripe with no integer division; it
//     then steps through the stripes by pointer increments.
//   * 4 accumulators of 4 words per output row: 64 registers at 4 rows a
//     pass.  __launch_bounds__ holds every instance to 128 registers (2
//     blocks an SM); ptxas gives 112/114/128/128 for 1-4 rows, no spills.
//
// Bound on an H100 SXM (published peaks: 3.35 TB/s HBM3; INT32 at 64
// lanes per SM x 132 SMs x 1.98 GHz = 16.7 T ops/s).  For RS(8,3) encode at
// the bulk shape (256, 8, 131072):
//   * memory: (k + m)·S·L = 369,098,752 B -> 0.1102 ms, which binds;
//   * integer ALU, counted on what the function needs (Horner's ring program
//     over the packed bytes, 103 ops per word position, as chip_smoke.py
//     counts it): 0.0517 ms.
// This kernel's own work is above the memory bound: the SASS of its 4-chunk
// loop is 508 instructions for 4 chunks x 4 words, 400 of them LOP3 and 16
// SHF on the ALU pipe (26 a chunk word, 208 a word for k = 8, about 0.104
// ms at the INT32 peak before the fold).  So it is bound by its integer
// issue, as the baked kernels of csrc/swar_baked.cu are; PERF.md has its
// times on an H100.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 2;  // __launch_bounds__: at most 128 registers
constexpr int kMaxRowsPerPass = 4;
constexpr int kGroup = 4;    // chunk vectors loaded together
constexpr int kMaxK = 384;   // one pass's operand, 32·rows·k B, within 48 KB

// acc ^ (w & m) as one LOP3.  Written out because nvcc otherwise
// reassociates the XOR chain of the accumulate into AND, AND-XOR and XOR,
// three ops where two do.
__device__ __forceinline__ uint32_t xor_and(uint32_t acc, uint32_t w, uint32_t m) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0x78;" : "=r"(d) : "r"(acc), "r"(w), "r"(m));
  return d;
}

// (a & c) | (b & ~c) as one LOP3.
__device__ __forceinline__ uint32_t select(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("lop3.b32 %0, %1, %2, %3, 0xE4;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__device__ __forceinline__ uint32_t nibble_swap(uint32_t w) {
  return select(w >> 4, w << 4, 0x0F0F0F0Fu);
}

// One butterfly level: each 2s-bit field takes, in its low s bits, a's field
// folded in half and, in its high s bits, b's.
template <int S, uint32_t LO>
__device__ __forceinline__ uint32_t merge(uint32_t a, uint32_t b) {
  return select(a ^ (a >> S), b ^ (b << S), LO);
}

// Levels s = 2 and s = 1 of the fold; y_p = merge_4(t_p, t_{p+4}).
__device__ __forceinline__ uint32_t fold(uint32_t y0, uint32_t y1, uint32_t y2,
                                         uint32_t y3) {
  return merge<1, 0x55555555u>(merge<2, 0x33333333u>(y0, y2),
                               merge<2, 0x33333333u>(y1, y3));
}

__device__ __forceinline__ void xor_pair(uint4& acc, const uint4& w,
                                         const uint4& ws, uint32_t a,
                                         uint32_t b) {
  acc.x = xor_and(xor_and(acc.x, w.x, a), ws.x, b);
  acc.y = xor_and(xor_and(acc.y, w.y, a), ws.y, b);
  acc.z = xor_and(xor_and(acc.z, w.z, a), ws.z, b);
  acc.w = xor_and(xor_and(acc.w, w.w, a), ws.w, b);
}

// Fold one chunk's vector into the accumulators of the pass's MG rows; `op`
// is the chunk's (MG, 8) masks in shared memory, (A_p, B_p) for p = 0..3.
template <int MG>
__device__ __forceinline__ void accumulate(uint4 (&acc)[4 * MG], const uint4& w,
                                           const uint4* op) {
  const uint4 ws = make_uint4(nibble_swap(w.x), nibble_swap(w.y),
                              nibble_swap(w.z), nibble_swap(w.w));
#pragma unroll
  for (int i = 0; i < MG; ++i) {
    const uint4 lo = op[2 * i];
    const uint4 hi = op[2 * i + 1];
    xor_pair(acc[4 * i + 0], w, ws, lo.x, lo.y);
    xor_pair(acc[4 * i + 1], w, ws, lo.z, lo.w);
    xor_pair(acc[4 * i + 2], w, ws, hi.x, hi.y);
    xor_pair(acc[4 * i + 3], w, ws, hi.z, hi.w);
  }
}

__device__ __forceinline__ void load_group(uint4 (&w)[kGroup], const uint4* in,
                                           int vecs) {
#pragma unroll
  for (int u = 0; u < kGroup; ++u) w[u] = __ldg(in + (long long)u * vecs);
}

// One pass (blockIdx.z) of MG output rows.  ops: (passes, k, MG, 8) uint32.
// A thread codes vector v of the stripes s, s + sstride, ...; while it
// codes one group of 4 chunks it has the next group in flight (the next
// stripe's first group after the last).
template <int MG>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
swar_gf_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
               const uint4* __restrict__ ops, int k, int m, int vecs,
               long long stripes) {
  extern __shared__ uint4 sops[];
  const int per = 2 * MG * k;
  const uint4* pass_ops = ops + (long long)blockIdx.z * per;
  for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < per; i += kThreads)
    sops[i] = pass_ops[i];
  __syncthreads();
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  long long s = (long long)blockIdx.y * blockDim.y + threadIdx.y;
  if (v >= vecs || s >= stripes) return;
  const int row0 = blockIdx.z * MG;
  const int rows = m - row0 < MG ? m - row0 : MG;
  const int kg = k - k % kGroup;  // chunks in whole groups
  const long long sstride = (long long)gridDim.y * blockDim.y;
  const long long in_step = sstride * k * vecs;
  const long long out_step = sstride * m * vecs;
  const uint4* in = data + s * k * vecs + v;
  uint4* dst = out + (s * m + row0) * vecs + v;
  uint4 w[kGroup];
  if (kg > 0) load_group(w, in, vecs);
  for (;;) {
    const bool more = s + sstride < stripes;
    uint4 acc[4 * MG];
#pragma unroll
    for (int q = 0; q < 4 * MG; ++q) acc[q] = make_uint4(0u, 0u, 0u, 0u);
    const uint4* p = in;
    const uint4* op = sops;
#pragma unroll 1
    for (int j = 0; j < kg; j += kGroup) {
      uint4 next[kGroup];
      const bool last = j + kGroup >= kg;
      if (!last || more)
        load_group(next, last ? in + in_step : p + (long long)kGroup * vecs, vecs);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) accumulate<MG>(acc, w[u], op + u * 2 * MG);
#pragma unroll
      for (int u = 0; u < kGroup; ++u) w[u] = next[u];
      p += (long long)kGroup * vecs;
      op += kGroup * 2 * MG;
    }
#pragma unroll 1
    for (int j = kg; j < k; ++j) {
      accumulate<MG>(acc, __ldg(p), op);
      p += vecs;
      op += 2 * MG;
    }
#pragma unroll
    for (int i = 0; i < MG; ++i) {
      if (i < rows) {
        const uint4* y = acc + 4 * i;
        dst[(long long)i * vecs] = make_uint4(
            fold(y[0].x, y[1].x, y[2].x, y[3].x),
            fold(y[0].y, y[1].y, y[2].y, y[3].y),
            fold(y[0].z, y[1].z, y[2].z, y[3].z),
            fold(y[0].w, y[1].w, y[2].w, y[3].w));
      }
    }
    if (!more) break;
    s += sstride;
    in += in_step;
    dst += out_step;
  }
}

template <int MG>
cudaError_t launch(const void* data, void* out, const void* ops, int k, int m,
                   int passes, int vecs, long long stripes, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  // Vectors across the block's x (a power of two up to 256), stripes
  // across its y, so short chunks still fill the block.  The grid covers
  // every vector once; its stripe blocks are as many as make one wave of
  // resident blocks (at least one), and each thread walks its stripes.
  int bx = 1;
  while (bx < kThreads && bx < vecs) bx <<= 1;
  const int by = kThreads / bx;
  const long long gx = (vecs + bx - 1) / bx;
  long long gy = (long long)kBlocksPerSm * sms / (gx * passes);
  const long long need = (stripes + by - 1) / by;
  if (gy > need) gy = need;
  if (gy > 65535) gy = 65535;
  if (gy < 1) gy = 1;
  const size_t smem = (size_t)2 * MG * k * sizeof(uint4);
  swar_gf_kernel<MG><<<dim3((unsigned)gx, (unsigned)gy, (unsigned)passes),
                       dim3(bx, by), smem, stream>>>(
      static_cast<const uint4*>(data), static_cast<uint4*>(out),
      static_cast<const uint4*>(ops), k, m, vecs, stripes);
  return cudaGetLastError();
}

}  // namespace

// data: (stripes, k, L) uint8; out: (stripes, m, L) uint8; ops: the
// (passes, k, rows, 8) uint32 operand of ops/swar_gf.py::schedule_masks,
// passes = ceil(m / 4), rows = ceil(m / passes).  All device pointers
// 16-byte aligned, L % 16 == 0, 1 <= k <= 384, L / 16 <= 2^30.  Returns
// cudaGetLastError() after the launch (0 on success); does not synchronise.
extern "C" int swar_gf_launch(const void* data, void* out, const void* ops,
                              long long stripes, int k, int m, long long L,
                              void* stream) {
  if (k < 1 || k > kMaxK || m < 1 || stripes < 0 || L < 0 || (L % 16) != 0 ||
      L / 16 > (1LL << 30))
    return (int)cudaErrorInvalidValue;
  const int vecs = (int)(L / 16);
  if (stripes == 0 || vecs == 0) return 0;
  const int passes = (m + kMaxRowsPerPass - 1) / kMaxRowsPerPass;
  if (passes > 65535) return (int)cudaErrorInvalidValue;
  const int mg = (m + passes - 1) / passes;
  auto st = static_cast<cudaStream_t>(stream);
  switch (mg) {
    case 1: return (int)launch<1>(data, out, ops, k, m, passes, vecs, stripes, st);
    case 2: return (int)launch<2>(data, out, ops, k, m, passes, vecs, stripes, st);
    case 3: return (int)launch<3>(data, out, ops, k, m, passes, vecs, stripes, st);
    default: return (int)launch<4>(data, out, ops, k, m, passes, vecs, stripes, st);
  }
}
