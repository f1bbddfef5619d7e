// XOR fold of k chunks for Hopper (sm_90a).
//
// Replaces the XLA-jitted program ceph_tpu/ops/xor_mm.py::xor_reduce
// (:107-117), Ceph's region_xor (isa/xor_op.cc): the m = 1 parity, the
// single-erasure decode of codecs whose first parity row is all ones, and
// the `xor` plugin.  Same function:
//   in   (S, k, L) uint8 chunks, byte (s, j, b) at in + s stride_s +
//        j stride_k + b (a strided view is read in place), 1 <= k <= 255
//   out  (S, L) uint8 dense, out[s, b] = XOR over j of in[s, j, b]
//
// Layout.  One flat index over the output's vectors (s, v), v a VEC-byte
// vector of a chunk (VEC = 16 when L, both strides and the base are
// multiples of 16; else 4 when they are multiples of 4; else 1), and a
// grid-stride loop over it: neighbouring threads on neighbouring vectors of
// one output row, each reading its vector of every chunk once and storing
// once.  One launch for any lead shape, k and alignment.
//
// Bound on an H100 SXM (3.35 TB/s): every chunk read once and the output
// written once, (k + 1) S L bytes; 90.1 us at (256, 8, 131072).  k XORs a
// vector are far below the INT32 rate, so bytes bind.  The time beside the
// bound is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlocksPerSm = 8;

__device__ __forceinline__ uint4 vxor(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}
__device__ __forceinline__ uint32_t vxor(uint32_t a, uint32_t b) { return a ^ b; }
__device__ __forceinline__ uint8_t vxor(uint8_t a, uint8_t b) { return a ^ b; }

__device__ __forceinline__ uint4 vload(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ uint32_t vload(const uint32_t* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}
__device__ __forceinline__ uint8_t vload(const uint8_t* p) { return __ldg(p); }

template <typename V>
__global__ void __launch_bounds__(kThreads)
xor_reduce_kernel(const uint8_t* __restrict__ in, V* __restrict__ out, int k,
                  long long stride_s, long long stride_k, long long vecs, long long total) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x; item < total;
       item += step) {
    const long long s = item / vecs;
    const long long v = item - s * vecs;
    const uint8_t* src = in + s * stride_s + v * (long long)sizeof(V);
    V acc = vload(reinterpret_cast<const V*>(src));
    for (int j = 1; j < k; ++j)
      acc = vxor(acc, vload(reinterpret_cast<const V*>(src + j * stride_k)));
    out[item] = acc;  // out is dense (S, L): vector (s, v) is number item
  }
}

template <typename V>
cudaError_t launch(const void* in, void* out, long long S, int k, long long L,
                   long long stride_s, long long stride_k, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long vecs = L / (long long)sizeof(V);
  const long long total = S * vecs;
  long long grid = (total + kThreads - 1) / kThreads;
  const long long wave = (long long)kBlocksPerSm * sms;
  if (grid > wave) grid = wave;
  xor_reduce_kernel<V><<<(unsigned)grid, kThreads, 0, stream>>>(
      static_cast<const uint8_t*>(in), static_cast<V*>(out), k, stride_s, stride_k, vecs,
      total);
  return cudaGetLastError();
}

}  // namespace

// in: (S, k, L) chunks, byte (s, j, b) at in + s * stride_s + j * stride_k
// + b; out: dense (S, L) on the device; vec is 16, 4 or 1: L, both strides
// and both base addresses are multiples of it.  Returns cudaGetLastError()
// after the launch (0 on success); does not synchronise.
extern "C" int xor_reduce_launch(const void* in, void* out, long long S, int k, long long L,
                                 long long stride_s, long long stride_k, int vec,
                                 void* stream) {
  if (S < 0 || k < 1 || k > 255 || L < 0 || (vec != 16 && vec != 4 && vec != 1) || L % vec ||
      stride_s % vec || stride_k % vec)
    return (int)cudaErrorInvalidValue;
  if (S == 0 || L == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  if (vec == 16) return (int)launch<uint4>(in, out, S, k, L, stride_s, stride_k, st);
  if (vec == 4) return (int)launch<uint32_t>(in, out, S, k, L, stride_s, stride_k, st);
  return (int)launch<uint8_t>(in, out, S, k, L, stride_s, stride_k, st);
}
