// GF(2) XOR product at plane granularity for Hopper (sm_90a).
//
// Replaces the XLA-jitted program ceph_tpu/ops/xor_mm.py::gf2_plane_matmul
// (:79-104), the coding step of jerasure's bit-matrix techniques
// (liberation, blaum_roth, liber8tion).  Same function:
//   planes (S, Q, P) uint8, P a multiple of 4 (jerasure's packetsize)
//   B      (R, Q) 0/1, a runtime operand (every decode pattern is a new B)
//   out    (S, R, P) uint8, out[s, r, :] = XOR of planes[s, q, :] over the
//          q with B[r, q] = 1
// The TPU program expands every byte into 8 bit-planes and runs the 0/1
// product on the MXU; on this card the function is what it says: a
// bytewise XOR of whole packets, no bit expansion and no product.
//
// Operand.  B arrives as a row list built on the host
// (ops/xor_mm.py::_row_list): row_start[R + 1] int32, then for each set
// entry the BYTE OFFSET of its plane inside a stripe (int64).  Offsets, and
// not the q indices, so the kernel reads any strided (S, Q, P) view in
// place: byte (s, q, p) is at in + s * stride_s + offs(q) + p, the last
// axis dense.  A block copies the row list into shared memory once
// (R = 2w <= 16 rows and nnz <= k*w*R for jerasure's codes: a few KiB).
//
// Layout.  One flat index over the output's vectors, (s, r, v) with v a
// VEC-byte vector of the packet (VEC = 16 when P, the strides, the offsets
// and the base are multiples of 16; else 4, P's only guarantee), and a
// grid-stride loop over it: neighbouring threads on neighbouring vectors of
// one output row, each XOR-accumulating its row's planes with 16-byte (or
// 4-byte) loads and storing once.  Any P, any S, any R: no tile geometry.
//
// Bound on an H100 SXM (3.35 TB/s HBM3; INT32 at 64 lanes x 132 SMs x
// 1.98 GHz).  Bytes: every input plane read once and every output packet
// written once, (Q + R) * S * P; ops: nnz(B) * S * P / 4 32-bit XORs.  At
// liberation k = 7, w = 7, P = 2048, S = 2048 (Q = 49, R = 14, nnz = 104)
// that is 264 MB -> 0.079 ms against 0.026 ms of XORs: bytes bind.  This
// kernel reads a plane once for each row that selects it (about 2 for the
// encode matrix); the repeats of one stripe's planes are near in time and
// hit L2 (50 MB), so the device-memory traffic stays near the bound's.
// Its time beside the bound is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ uint4 vxor(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint32_t vxor(uint32_t a, uint32_t b) { return a ^ b; }

template <typename V> __device__ __forceinline__ V vzero();
template <> __device__ __forceinline__ uint4 vzero<uint4>() { return make_uint4(0, 0, 0, 0); }
template <> __device__ __forceinline__ uint32_t vzero<uint32_t>() { return 0u; }

__device__ __forceinline__ uint4 vload(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ uint32_t vload(const uint32_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

template <typename V>
__global__ void __launch_bounds__(kThreads)
gf2_plane_kernel(const uint8_t* __restrict__ in, V* __restrict__ out,
                 const int* __restrict__ row_start, const long long* __restrict__ offs,
                 int R, int nnz, long long stride_s, long long vecs, long long total) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_offs = reinterpret_cast<long long*>(smem);
  int* s_start = reinterpret_cast<int*>(s_offs + nnz);
  for (int i = threadIdx.x; i < nnz; i += blockDim.x) s_offs[i] = offs[i];
  for (int i = threadIdx.x; i <= R; i += blockDim.x) s_start[i] = row_start[i];
  __syncthreads();
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x; item < total;
       item += step) {
    const long long sr = item / vecs;
    const long long v = item - sr * vecs;
    const long long s = sr / R;
    const int r = (int)(sr - s * R);
    const uint8_t* src = in + s * stride_s + v * (long long)sizeof(V);
    V acc = vzero<V>();
    const int end = s_start[r + 1];
    for (int e = s_start[r]; e < end; ++e)
      acc = vxor(acc, vload(reinterpret_cast<const V*>(src + s_offs[e])));
    out[item] = acc;  // out is dense (S, R, P): vector (s, r, v) is number item
  }
}

template <typename V>
cudaError_t launch(const void* in, void* out, const void* row_start, const void* offs,
                   long long stripes, int R, int nnz, long long stride_s, long long P,
                   cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long vecs = P / (long long)sizeof(V);
  const long long total = stripes * R * vecs;
  long long grid = (total + kThreads - 1) / kThreads;
  const long long wave = (long long)kBlocksPerSm * sms;
  if (grid > wave) grid = wave;
  const size_t smem = (size_t)nnz * sizeof(long long) + (size_t)(R + 1) * sizeof(int);
  gf2_plane_kernel<V><<<(unsigned)grid, kThreads, smem, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<V*>(out),
      static_cast<const int*>(row_start), static_cast<const long long*>(offs), R, nnz,
      stride_s, vecs, total);
  return cudaGetLastError();
}

}  // namespace

// in: the (stripes, Q, P) planes, byte (s, q, p) at in + s * stride_s +
// offs(q) + p; out: dense (stripes, R, P); row_start: R + 1 int32 on the
// device; offs: nnz int64 byte offsets on the device, row r's planes at
// offs[row_start[r] .. row_start[r + 1]).  vec is 16 or 4: P, stride_s,
// every offset and both base addresses are multiples of it.  The row list
// must fit 48 KiB of shared memory.  Returns cudaGetLastError() after the
// launch (0 on success); does not synchronise.
extern "C" int gf2_plane_launch(const void* in, void* out, const void* row_start,
                                const void* offs, long long stripes, int R, int nnz,
                                long long stride_s, long long P, int vec, void* stream) {
  if (stripes < 0 || R < 0 || nnz < 0 || P < 0 || (vec != 16 && vec != 4) || P % vec ||
      stride_s % vec ||
      (size_t)nnz * sizeof(long long) + (size_t)(R + 1) * sizeof(int) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (stripes == 0 || R == 0 || P == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (vec == 16)
    return (int)launch<uint4>(in, out, row_start, offs, stripes, R, nnz, stride_s, P, st);
  return (int)launch<uint32_t>(in, out, row_start, offs, stripes, R, nnz, stride_s, P, st);
}
