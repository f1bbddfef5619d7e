// Fused SWAR bitsliced GF(2^8) coding for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ceph_tpu/ops/pallas_gf.py::_swar_kernel
// (launched by _gf_code_swar through pl.pallas_call).  Same function:
//   in  (S, k, L) uint8, L a multiple of 16 (the codec gives multiples of 128)
//   out (S, m, L) uint8
// where bit r of output byte i is the XOR, over the set entries of row 8i+r
// of expand_matrix(gf_matrix), of bit b of the matching byte of chunk j.
//
// Translation.  The TPU kernel bitcasts a (R, C) uint8 tile to int32 and
// XORs the bit-planes (w >> b) & 0x01010101 that a schedule, baked in at
// trace time, names for each output bit-row.  Here:
//   * each thread loads 16 bytes (one uint4, 4 words) of each of the k
//     chunks at one offset, neighbouring threads on neighbouring addresses,
//     and stores 16 bytes for each of the m outputs;
//   * the grid covers (stripes x L/16 vectors) with a grid-stride loop;
//   * the schedule is a runtime operand, not code: one library serves
//     every encode matrix and every decode matrix of the coder LRU.  It is
//     an (8m', k) uint32 array `rep` whose entry [o][j] is the 8-bit mask of
//     the planes of chunk j that feed output bit-row o, repeated in the 4
//     bytes of the word (m' is m rounded up to whole passes, the extra rows
//     zero).
//   * The XOR of the selected planes is computed without a per-plane
//     branch: by linearity,
//         XOR_{b in mask} ((w >> b) & 0x01010101) == bytewise_parity(w & rep)
//     and the parity can wait until every chunk is folded in:
//         t_o = XOR_j (w_j & rep[o][j])          (one LOP3 per word)
//         out_i = OR_r (bytewise_parity(t_{8i+r}) << r)
//     so the work per word does not depend on how dense the matrix is.
//
// Bound on an H100 SXM (published peaks: 3.35 TB/s HBM3; INT32 at 64
// lanes per SM x 132 SMs x 1.98 GHz = 16.7 T ops/s, half the 128 fp32
// lanes behind the 67 TFLOP/s float32 figure).  For RS(8,3) encode at the
// bulk shape (256, 8, 131072):
//   * memory: (k + m) * S * L = 11 * 256 * 131072 B = 369 MB
//     -> 369e6 / 3.35e12 = 0.110 ms.
//   * integer ALU, counted on what the function needs: Horner's ring
//     program over the packed bytes (ops/packed_gf.py, 47 program ops for
//     Vandermonde RS(8,3): 33 XORs + 14 multiply-by-x, each of the latter 5
//     SWAR ops) is 103 ops per 32-bit word position of the 8 chunks, on 32
//     input bytes -> 0.86e9 ops / 16.7e12 = 0.052 ms.
//   The memory bound binds (chip_smoke.py computes both from the run's
//   shapes).  This kernel does far more integer work than the function
//   needs: 8m*k LOP3 + 8m*8 parity-fold and placement ops per word (24*8 +
//   24*8 = 384, whatever the density, so Cauchy costs the same) -> 0.193
//   ms at the INT32 peak, above the memory bound; the TPU kernel's own
//   schedule (401 ones: 377 XORs + 120 plane cuts + 42 row placements =
//   539 ops per word) would be more still.  Beside the ALU work, each
//   thread loads one cached schedule word per (row, chunk) per 16 bytes.
// What the design does about it: nothing yet beyond coalesced 16-byte
// accesses and a branch-free, density-independent inner loop.  Faster
// designs — the packed plane program of ops/packed_gf.py (47 ops for
// RS(8,3)), a schedule specialised into LOP3 chains, shared-memory
// staging — are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxRowsPerPass = 4;  // output byte-rows held in registers

__device__ __forceinline__ uint32_t byte_parity(uint32_t x) {
  x ^= x >> 4;
  x ^= x >> 2;
  x ^= x >> 1;
  return x & 0x01010101u;
}

// One pass covers output byte-rows [g, g + MG) for every (stripe, vector)
// position: 8*MG uint4 accumulators stay in registers.
template <int MG>
__global__ void __launch_bounds__(kThreads)
swar_gf_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
               const uint32_t* __restrict__ rep, int k, int m,
               long long vecs, long long total) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < total; t += stride) {
    const long long s = t / vecs;
    const long long v = t - s * vecs;
    const uint4* in = data + s * k * vecs + v;
    uint4* dst = out + s * m * vecs + v;
    for (int g = 0; g < m; g += MG) {
      const uint32_t* rg = rep + (size_t)g * 8 * k;
      uint4 acc[8 * MG];
#pragma unroll
      for (int q = 0; q < 8 * MG; ++q) acc[q] = make_uint4(0u, 0u, 0u, 0u);
      for (int j = 0; j < k; ++j) {
        const uint4 w = __ldg(in + (long long)j * vecs);
#pragma unroll
        for (int q = 0; q < 8 * MG; ++q) {
          const uint32_t msk = __ldg(rg + q * k + j);
          acc[q].x ^= w.x & msk;
          acc[q].y ^= w.y & msk;
          acc[q].z ^= w.z & msk;
          acc[q].w ^= w.w & msk;
        }
      }
#pragma unroll
      for (int i = 0; i < MG; ++i) {
        if (g + i < m) {
          uint4 res = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            const uint4 a = acc[8 * i + r];
            res.x |= byte_parity(a.x) << r;
            res.y |= byte_parity(a.y) << r;
            res.z |= byte_parity(a.z) << r;
            res.w |= byte_parity(a.w) << r;
          }
          dst[(long long)(g + i) * vecs] = res;
        }
      }
    }
  }
}

template <int MG>
cudaError_t launch(const uint4* data, uint4* out, const uint32_t* rep, int k,
                   int m, long long vecs, long long total,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  long long blocks = (total + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 16;
  if (blocks > cap) blocks = cap;
  swar_gf_kernel<MG><<<(unsigned)blocks, kThreads, 0, stream>>>(
      data, out, rep, k, m, vecs, total);
  return cudaGetLastError();
}

}  // namespace

// data: (stripes, k, L) uint8; out: (stripes, m, L) uint8; rep: the
// (8 * ceil(m / MG) * MG, k) uint32 schedule with MG = min(m, 4).  All
// device pointers 16-byte aligned, L % 16 == 0.  Returns cudaGetLastError()
// after the launch (0 on success); does not synchronise.
extern "C" int swar_gf_launch(const void* data, void* out, const void* rep,
                              long long stripes, int k, int m, long long L,
                              void* stream) {
  if (k < 1 || m < 1 || stripes < 0 || L < 0 || (L % 16) != 0)
    return (int)cudaErrorInvalidValue;
  const long long vecs = L / 16;
  const long long total = stripes * vecs;
  if (total == 0) return 0;
  const auto* d = static_cast<const uint4*>(data);
  auto* o = static_cast<uint4*>(out);
  const auto* r = static_cast<const uint32_t*>(rep);
  auto st = static_cast<cudaStream_t>(stream);
  const int mg = m < kMaxRowsPerPass ? m : kMaxRowsPerPass;
  switch (mg) {
    case 1: return (int)launch<1>(d, o, r, k, m, vecs, total, st);
    case 2: return (int)launch<2>(d, o, r, k, m, vecs, total, st);
    case 3: return (int)launch<3>(d, o, r, k, m, vecs, total, st);
    default: return (int)launch<4>(d, o, r, k, m, vecs, total, st);
  }
}
