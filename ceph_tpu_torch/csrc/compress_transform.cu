// The device compressor's transform for Hopper (sm_90a).
//
// Replaces the XLA-jitted program ceph_tpu/compressor/device.py::
// transform_rows_device (:56-70).  Same function, on each row s of S:
//   in   Lp bytes (Lp % 64 == 0), read as R = Lp / 64 rows of 64 bytes
//   out  Lp + R bytes: t[p R + r] = in[r 64 + p] (the stride-64 byte-plane
//        transpose, plane p = byte p of every 64-byte row), then for each
//        64-byte cell c of t the flag t[64 c .. 64 c + 63] != 0 (0 or 1)
// The cells are aligned in the transposed stream, not in the planes: where
// R % 64 != 0 (Lp % 4096 != 0) a cell straddles two planes.
//
// Layout.  One block a row (a grid-stride loop over rows).  The block
// stages the row in shared memory with a pitch of 65 bytes for each
// 64-byte row, so that 32 lanes reading one plane at 32 consecutive rows
// hit different banks; the load is coalesced, 16 bytes a thread where the
// row and its stride are 16-byte aligned, else a byte a thread.  Then each
// warp takes whole cells of the output: lane l writes bytes 64 c + l and
// 64 c + 32 + l (coalesced), each gathered from shared memory by its
// (plane, row), and the cell's flag is __any_sync over the 64 bytes,
// written by lane 0.  So any Lp is one launch: a cell is produced whole by
// one warp wherever it falls in the planes.  A row too long for shared
// memory (Lp > 3576 * 64) is not staged: the warps gather its bytes from
// device memory (kStaged = false), uncoalesced but the same function.
//
// Bound on an H100 SXM (3.35 TB/s): every input byte read once and every
// output byte written once, (2 Lp + Lp / 64) S bytes; 161.5 us at
// (65536, 4096).  The kernel moves exactly those bytes; its time beside
// the bound is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPitch = 65;
constexpr long long kMaxStagedLp = 3576LL * 64;  // 3576 * 65 bytes <= 232448

template <bool kStaged, bool kVec16>
__global__ void __launch_bounds__(kThreads)
transform_kernel(const uint8_t* __restrict__ in, long long S, int Lp, long long row_stride,
                 uint8_t* __restrict__ out) {
  extern __shared__ uint8_t row_smem[];
  const int R = Lp / 64;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = kThreads / 32;
  for (long long s = blockIdx.x; s < S; s += gridDim.x) {
    const uint8_t* src = in + s * row_stride;
    if (kStaged && kVec16) {
      const uint4* v = reinterpret_cast<const uint4*>(src);
      for (int j = threadIdx.x; j < Lp / 16; j += kThreads) {
        const uint4 x = __ldg(v + j);
        uint8_t* dst = row_smem + (j >> 2) * kPitch + (j & 3) * 16;
        const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int b = 0; b < 16; ++b) dst[b] = (uint8_t)(w[b >> 2] >> (8 * (b & 3)));
      }
    } else if (kStaged) {
      for (int i = threadIdx.x; i < Lp; i += kThreads)
        row_smem[(i >> 6) * kPitch + (i & 63)] = __ldg(src + i);
    }
    __syncthreads();
    uint8_t* dst = out + s * (long long)(Lp + R);
    for (int c = warp; c < R; c += warps) {
      const int q0 = 64 * c + lane, q1 = q0 + 32;
      const uint8_t b0 = kStaged ? row_smem[(q0 % R) * kPitch + q0 / R]
                                 : __ldg(src + (q0 % R) * 64 + q0 / R);
      const uint8_t b1 = kStaged ? row_smem[(q1 % R) * kPitch + q1 / R]
                                 : __ldg(src + (q1 % R) * 64 + q1 / R);
      dst[q0] = b0;
      dst[q1] = b1;
      const bool any = __any_sync(0xFFFFFFFFu, (b0 | b1) != 0);
      if (lane == 0) dst[Lp + c] = any ? 1 : 0;
    }
    __syncthreads();  // the next row overwrites the staged one
  }
}

template <bool kStaged, bool kVec16>
cudaError_t launch(const void* in, long long S, long long Lp, long long row_stride, void* out,
                   cudaStream_t stream) {
  const size_t smem = kStaged ? (size_t)(Lp / 64) * kPitch : 0;
  cudaError_t err;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(transform_kernel<kStaged, kVec16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, transform_kernel<kStaged, kVec16>, kThreads, smem);
  if (err != cudaSuccess) return err;
  long long grid = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > S) grid = S;
  transform_kernel<kStaged, kVec16><<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(in), S, Lp, row_stride, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// in: S rows of Lp bytes (Lp a positive multiple of 64, below 2^30), row s at
// in + s * row_stride; out: dense (S, Lp + Lp / 64) on the device.  Returns
// cudaGetLastError() after the launch (0 on success); does not synchronise.
extern "C" int compress_transform_launch(const void* in, long long S, long long Lp,
                                         long long row_stride, void* out, void* stream) {
  if (S < 0 || Lp < 64 || Lp % 64 || Lp > 0x3FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (Lp > kMaxStagedLp) return (int)launch<false, false>(in, S, Lp, row_stride, out, st);
  const bool vec16 = (reinterpret_cast<uintptr_t>(in) % 16 == 0) && (row_stride % 16 == 0);
  if (vec16) return (int)launch<true, true>(in, S, Lp, row_stride, out, st);
  return (int)launch<true, false>(in, S, Lp, row_stride, out, st);
}
