// crc32c of every row of a batch, for Hopper (sm_90a).
//
// Replaces the XLA-jitted program ceph_tpu/ops/checksum_offload.py::
// crc32c_device (:118-137), which checksums BlueStore's blocks as one
// (32, 8L) x (8L, S) GF(2) product on the MXU.  Same function:
//   in   S rows of L bytes, row s at in + s * row_stride, any alignment
//   out  (S,) int64, the crc32c (Castagnoli, reflected 0x82F63B78, init and
//        final XOR 0xFFFFFFFF) of each row, as utils/crc32c.crc32c gives it
// The card has no use for the bit-matrix product; this is the table CRC.
//
// Arithmetic.  Let lin(x) be the CRC register after x from the zero state
// with no final XOR.  crc32c(x) = lin(x) ^ crc32c(0^L) (the constant is the
// `zero_const` argument), lin is GF(2)-linear, and leading zero bytes do
// not change it.  So each row is read as a run of aligned 16-byte vectors
// from align_down(row) to align_up(row + L), the bytes outside the row
// masked to zero, left-padded with zero vectors to a multiple of 32.  That
// appends z = align_up(row + L) - (row + L) < 16 zero bytes, which the
// operator U_z (the inverse of "z zero bytes") takes back at the end.
//
// Layout.  One warp a row.  Lane i takes vectors i, i + 32, i + 64, ... with
// coalesced 16-byte loads (a warp reads 512 contiguous bytes at a time) and
// keeps acc = S512(acc) ^ L16(v): L16 is the register after the 16 bytes of
// v from zero (16 byte tables), S512 the shift by 512 zero bytes.  Then
// lin(row) = XOR over lanes of shift(acc_i, 16 (31 - i)), a 5-step
// __shfl_down tree whose step d shifts the left partial by 16 d bytes.
// Every operator is a 32x32 GF(2) matrix applied as four 256-entry byte
// tables; all of them are built once on the host
// (ops/checksum_offload.py::kernel_tables) and the 40 the loop and the tree
// use are staged in shared memory (40 KiB) by each block.
//
// Bound on an H100 SXM (3.35 TB/s): every input byte read once and 4
// bytes a row written, (S L + 4 S) bytes; 80.2 us at (65536, 4096).  The
// loop does 20 shared-memory table reads a 16-byte vector (about 1.25 a
// byte): at 32 a clock an SM that is 8.4e12 a second over the card, about
// as long as the bytes take, so the kernel sits near the byte bound when
// the table reads do not conflict.  Its time beside the bound is in
// PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kSharedTables = 40;  // L16 (16), S512 (4), S16..S256 (20)
constexpr int kL16 = 0, kS512 = 16, kFold = 20, kUnshift = 40;

__device__ __forceinline__ uint32_t apply(const uint32_t* t, uint32_t c) {
  return t[c & 0xFF] ^ t[256 + ((c >> 8) & 0xFF)] ^ t[512 + ((c >> 16) & 0xFF)] ^
         t[768 + (c >> 24)];
}

__device__ __forceinline__ uint32_t word_l16(const uint32_t* t, uint32_t w, int p) {
  return t[(p + 0) * 256 + (w & 0xFF)] ^ t[(p + 1) * 256 + ((w >> 8) & 0xFF)] ^
         t[(p + 2) * 256 + ((w >> 16) & 0xFF)] ^ t[(p + 3) * 256 + (w >> 24)];
}

// keep the bytes p of word w (positions 4w .. 4w+3 of the vector) with lo <= p < hi
__device__ __forceinline__ uint32_t keep(int w, int lo, int hi) {
  uint32_t m = 0;
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    const int p = 4 * w + b;
    if (p >= lo && p < hi) m |= 0xFFu << (8 * b);
  }
  return m;
}

__global__ void __launch_bounds__(kThreads)
crc32c_kernel(const uint8_t* __restrict__ in, long long S, long long L, long long row_stride,
              const uint32_t* __restrict__ tables, uint32_t zero_const,
              long long* __restrict__ out) {
  __shared__ uint32_t t[kSharedTables * 256];
  for (int i = threadIdx.x; i < kSharedTables * 256; i += kThreads) t[i] = tables[i];
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const long long step = (long long)gridDim.x * kWarps;
  for (long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); row < S;
       row += step) {
    const uintptr_t base = reinterpret_cast<uintptr_t>(in + row * row_stride);
    const uintptr_t end = base + (uintptr_t)L;
    const uintptr_t abase = base & ~(uintptr_t)15;
    const long long nvec = (long long)(((end + 15) & ~(uintptr_t)15) - abase) >> 4;
    const int head = (int)(base - abase);                 // masked bytes in vector 0
    const int tail = (int)(((end + 15) & ~(uintptr_t)15) - end);  // z, masked at the end
    const long long pad = (32 - nvec % 32) % 32;          // leading zero vectors
    const uint4* vecs = reinterpret_cast<const uint4*>(abase);
    uint32_t acc = 0;
    for (long long j = lane; j < nvec + pad; j += 32) {
      acc = apply(t + kS512 * 256, acc);
      const long long a = j - pad;
      if (a < 0) continue;
      uint4 v = __ldg(vecs + a);
      if (a == 0 || a == nvec - 1) {
        const int lo = a == 0 ? head : 0, hi = a == nvec - 1 ? 16 - tail : 16;
        v.x &= keep(0, lo, hi);
        v.y &= keep(1, lo, hi);
        v.z &= keep(2, lo, hi);
        v.w &= keep(3, lo, hi);
      }
      acc ^= word_l16(t, v.x, 0) ^ word_l16(t, v.y, 4) ^ word_l16(t, v.z, 8) ^
             word_l16(t, v.w, 12);
    }
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      const int d = 1 << l;
      const uint32_t right = __shfl_down_sync(0xFFFFFFFFu, acc, d);
      if ((lane & (2 * d - 1)) == 0) acc = apply(t + (kFold + 4 * l) * 256, acc) ^ right;
    }
    if (lane == 0) {
      const uint32_t* u = tables + (kUnshift + 4 * tail) * 256;
      const uint32_t lin = __ldg(u + (acc & 0xFF)) ^ __ldg(u + 256 + ((acc >> 8) & 0xFF)) ^
                           __ldg(u + 512 + ((acc >> 16) & 0xFF)) ^ __ldg(u + 768 + (acc >> 24));
      out[row] = (long long)(lin ^ zero_const);
    }
  }
}

}  // namespace

// in: S rows of L >= 1 bytes, row s at in + s * row_stride (any alignment;
// the aligned 16-byte words that hold a row's bytes are read whole, and
// the bytes outside the row are masked); tables: the (104, 256) uint32
// operand of ops/checksum_offload.py::kernel_tables on the device;
// zero_const: crc32c of L zero bytes; out: (S,) int64 on the device.
// Returns cudaGetLastError() after the launch (0 on success); does not
// synchronise.
extern "C" int crc32c_launch(const void* in, long long S, long long L, long long row_stride,
                             const void* tables, uint32_t zero_const, void* out,
                             void* stream) {
  if (S < 0 || L < 1) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crc32c_kernel, kThreads, 0);
  if (err != cudaSuccess) return (int)err;
  long long grid = (S + kWarps - 1) / kWarps;
  const long long wave = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  if (grid > wave) grid = wave;
  crc32c_kernel<<<(unsigned)grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), S, L, row_stride,
      static_cast<const uint32_t*>(tables), zero_const, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}
