// crc32c of every row of a batch, for Hopper (sm_90a).
//
// Replaces the XLA-jitted program ceph_tpu/ops/checksum_offload.py::
// crc32c_device (:118-137), which checksums BlueStore's blocks as one
// (32, 8L) x (8L, S) GF(2) product on the MXU.  Same function:
//   in   S rows of L bytes, row s at in + s * row_stride, any alignment
//   out  (S,) int64, the crc32c (Castagnoli, reflected 0x82F63B78, init and
//        final XOR 0xFFFFFFFF) of each row, as utils/crc32c.crc32c gives it
// The card has no use for the bit-matrix product (32 MACs an input bit);
// this is the table CRC.
//
// Arithmetic.  Let lin(x) be the CRC register after x from the zero state
// with no final XOR.  crc32c(x) = lin(x) ^ crc32c(0^L) (the constant is the
// `zero_const` argument), lin is GF(2)-linear, and leading zero bytes do
// not change it.  So each row is read as a run of aligned 16-byte vectors
// from align_down(row) to align_up(row + L), the bytes outside the row
// masked to zero, left-padded with zero vectors to a multiple of 64.  That
// appends z = align_up(row + L) - (row + L) < 16 zero bytes, which the
// operator U_z (the inverse of "z zero bytes") takes back at the end.
//
// Layout.  One warp a row, 1 KiB a warp step.  Lane i takes vectors 2i and
// 2i + 1 of every 64 (a 32-byte piece; the warp's loads cover 1 KiB
// contiguously), the next piece's loads in flight while this one is folded
// in, and keeps acc = S1024(acc) ^ L32(piece): L32 is the register after
// the piece's 32 bytes from zero, S1024 the shift by 1024 zero bytes.  Then
// lane i shifts its acc by the 32 (31 - i) bytes that follow its last piece
// in the row (F_i), one redux.sync XORs the lanes, and U_z takes the tail
// back.  The head and tail masks touch only lane `lead`'s first piece and
// lane 31's last, outside the loop's common path.
//
// Tables.  Every operator is a 32x32 GF(2) matrix, applied as the XOR of
// tables indexed by fields of its input.  A field of 5 bits indexes 32
// words, which sit in the 32 distinct banks of shared memory: 32 lanes
// reading one such table at any indices are one wavefront (equal indices
// broadcast), so the reads never conflict whatever the data, with one copy
// of each table.  L32 is 52 of them (256 bits), S1024 7 (32 bits): 7.4 KiB.
// F_i differs from lane to lane, so it is 8 nibble tables laid out once per
// lane (entry e of table t for lane l at word (t * 16 + e) * 32 + l, each
// lane in its own bank; 16 KiB); U_z is 16 x 8 nibble tables read at one
// index by lane 0 (8 KiB).  A lookup is a shift (a funnel shift where the
// field straddles two words), one LOP3 ((x & mask) | base) and an LDS
// with the table as its immediate offset; a 1 KiB warp step is 59 of them
// and about 110 other instructions.  Each block copies the tables into
// shared memory from the operand of ops/checksum_offload.py::kernel_tables
// at its start; one block of 32 warps an SM at the bulk shapes (blocks of 8
// to 32 warps spread a few rows over more SMs).  Byte tables (the first
// version) read about 3 words of the busiest bank a lookup on random
// bytes; nibble tables, one copy a lane, were conflict-free but read 40
// tables a 512 bytes to these 29.5, and were slower (PERF.md).
//
// Bound on an H100 SXM (3.35 TB/s): every input byte read once and 4
// bytes a row written, (S L + 4 S) bytes; 80.2 us at (65536, 4096).  The
// step's instructions, not the bytes, hold the kernel: its time beside the
// bound is in PERF.md.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxWarps = 32;       // a block's warps at the bulk shapes
constexpr int kMinWarps = 8;        // ... and at least, for a few rows
constexpr int kV = 2;                 // vectors a lane takes a step
constexpr int kChunk = 32 * kV;       // vectors a warp step
constexpr int kW = 5;                 // bits a field of L32 and S1024
constexpr int kNL = (128 * kV + kW - 1) / kW;  // 52 L32 tables
constexpr int kNS = (32 + kW - 1) / kW;        // 7 S1024 tables
// operand words: L32, S1024, F (32 lanes x 8 x 16), U (16 x 8 x 16)
constexpr int kOpS = kNL << kW, kOpF = kOpS + (kNS << kW), kOpU = kOpF + 32 * 8 * 16;
constexpr int kOpWords = kOpU + 16 * 8 * 16;  // 8032
// shared image, bytes from a 2048-aligned base: F (lane-private), L32, S1024, U
constexpr int kImgF = 0, kImgL = 8 * 2048, kImgS = kImgL + 128 * kNL;
constexpr int kImgU = kImgS + 128 * kNS;
constexpr int kAlign = 2048;
constexpr size_t kSmemBytes = kImgU + 16 * 8 * 16 * 4 + kAlign;

__device__ __forceinline__ uint32_t lds(uint32_t addr) {
  uint32_t r;
  asm volatile("ld.shared.b32 %0, [%1];" : "=r"(r) : "r"(addr));
  return r;
}

// The entry of table kI (kStride bytes apart from base) for the kBits-bit
// field kI of the little-endian words w, the field moved to bit kTo of the
// address (base has zeros there).
template <int kBits, int kTo, int kStride, int kI, int kWords>
__device__ __forceinline__ uint32_t look(const uint32_t (&w)[kWords], uint32_t base) {
  constexpr int bit = kI * kBits, word = bit / 32, off = bit % 32;
  constexpr uint32_t mask = ((1u << kBits) - 1) << kTo;
  uint32_t x;
  if constexpr (off + kBits > 32 && word + 1 < kWords)
    x = __funnelshift_r(w[word], w[word + 1], off - kTo);
  else if constexpr (off >= kTo)
    x = w[word] >> (off - kTo);
  else
    x = w[word] << (kTo - off);
  return lds(((x & mask) | base) + kI * kStride);
}

// XOR of the lookups kLo .. kHi - 1, as a balanced tree of 3-input XORs
template <int kBits, int kTo, int kStride, int kLo, int kHi, int kWords>
__device__ __forceinline__ uint32_t xor_tables(const uint32_t (&w)[kWords], uint32_t base) {
  constexpr int n = kHi - kLo;
  if constexpr (n == 1) {
    return look<kBits, kTo, kStride, kLo>(w, base);
  } else if constexpr (n == 2) {
    return look<kBits, kTo, kStride, kLo>(w, base) ^ look<kBits, kTo, kStride, kLo + 1>(w, base);
  } else {
    constexpr int a = kLo + n / 3, b = kLo + 2 * n / 3;
    return xor_tables<kBits, kTo, kStride, kLo, a>(w, base) ^
           xor_tables<kBits, kTo, kStride, a, b>(w, base) ^
           xor_tables<kBits, kTo, kStride, b, kHi>(w, base);
  }
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

__device__ __forceinline__ uint4 keep4(int lo, int hi) {
  return make_uint4(keep(0, lo, hi), keep(1, lo, hi), keep(2, lo, hi), keep(3, lo, hi));
}

__device__ __forceinline__ uint4 and4(uint4 a, uint4 m) {
  return make_uint4(a.x & m.x, a.y & m.y, a.z & m.z, a.w & m.w);
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
crc32c_kernel(const uint8_t* __restrict__ in, long long S, long long L, long long row_stride,
              const uint32_t* __restrict__ op, uint32_t zero_const,
              long long* __restrict__ out) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = static_cast<uint32_t>(__cvta_generic_to_shared(smem_raw));
  const uint32_t pad = (kAlign - (raw & (kAlign - 1))) & (kAlign - 1);
  uint32_t* image = reinterpret_cast<uint32_t*>(smem_raw + pad);
  const uint4* op4 = reinterpret_cast<const uint4*>(op);
  uint4* image4 = reinterpret_cast<uint4*>(image);
  const int lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  // F, one copy a lane: lane l's entries 4q .. 4q + 3 of table t
  for (int i = threadIdx.x; i < 32 * 8 * 4; i += blockDim.x) {
    const int t = i >> 7, q = (i >> 5) & 3, l = i & 31;
    const uint4 x = __ldg(op4 + kOpF / 4 + (l * 8 + t) * 4 + q);
    uint32_t* dst = image + kImgF / 4 + (t * 16 + 4 * q) * 32 + l;
    dst[0] = x.x;
    dst[32] = x.y;
    dst[64] = x.z;
    dst[96] = x.w;
  }
  for (int i = threadIdx.x; i < kOpF / 4; i += blockDim.x) image4[kImgL / 16 + i] = __ldg(op4 + i);
  for (int i = threadIdx.x; i < 16 * 8 * 16 / 4; i += blockDim.x)
    image4[kImgU / 16 + i] = __ldg(op4 + kOpU / 4 + i);
  __syncthreads();
  const uint32_t base = raw + pad, fbase = base + kImgF + 4 * lane;
  const long long stride = (long long)gridDim.x * warps;
  for (long long row = (long long)blockIdx.x * warps + (threadIdx.x >> 5); row < S;
       row += stride) {
    const uintptr_t start = reinterpret_cast<uintptr_t>(in + row * row_stride);
    const uintptr_t end = start + (uintptr_t)L;
    const uintptr_t abase = start & ~(uintptr_t)15;
    const long long nvec = (long long)(((end + 15) & ~(uintptr_t)15) - abase) >> 4;
    const int head = (int)(start - abase);                 // masked bytes in vector 0
    const int tail = (int)(((end + 15) & ~(uintptr_t)15) - end);  // z, masked at the end
    const int lead = (int)((kChunk - nvec % kChunk) % kChunk);    // leading zero vectors
    const int steps = (int)((nvec + lead) / kChunk);
    // vector a = kV lane + k - lead at step 0; the row's last vector is lane
    // 31's last at the last step
    const uint4* p = reinterpret_cast<const uint4*>(abase) + (kV * lane - lead);
    const uint4 last = lane == 31 ? keep4(0, 16 - tail) : make_uint4(~0u, ~0u, ~0u, ~0u);
    uint4 v[kV];
#pragma unroll
    for (int k = 0; k < kV; ++k) {
      const int a = kV * lane + k - lead;
      v[k] = a < 0 ? make_uint4(0, 0, 0, 0) : __ldg(p + k);
      if (a == 0) v[k] = and4(v[k], keep4(head, 16));
    }
    if (steps == 1) v[kV - 1] = and4(v[kV - 1], last);
    uint32_t acc = 0;
    for (int s = 0; s < steps; ++s) {
      uint4 next[kV] = {};
      if (s + 1 < steps) {  // lanes before the row read it only at step 0
        p += kChunk;
#pragma unroll
        for (int k = 0; k < kV; ++k) next[k] = __ldg(p + k);
        if (s + 2 == steps) next[kV - 1] = and4(next[kV - 1], last);
      }
      const uint32_t w[4 * kV] = {v[0].x, v[0].y, v[0].z, v[0].w,
                                  v[1].x, v[1].y, v[1].z, v[1].w};
      const uint32_t a1[1] = {acc};
      acc = xor_tables<kW, 2, 128, 0, kNS>(a1, base + kImgS) ^
            xor_tables<kW, 2, 128, 0, kNL>(w, base + kImgL);
#pragma unroll
      for (int k = 0; k < kV; ++k) v[k] = next[k];
    }
    const uint32_t a1[1] = {acc};
    const uint32_t lin = __reduce_xor_sync(0xFFFFFFFFu, xor_tables<4, 7, 2048, 0, 8>(a1, fbase));
    if (lane == 0) {
      const uint32_t* u = image + kImgU / 4 + tail * 128;
      uint32_t r = 0;
#pragma unroll
      for (int k = 0; k < 8; ++k) r ^= u[k * 16 + ((lin >> (4 * k)) & 15)];
      out[row] = (long long)(r ^ zero_const);
    }
  }
}

// the SMs of the current device, checked once that a block of kMaxWarps fits one
cudaError_t sm_count(int* sms) {
  static int cached[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!cached[dev]) {
    int per_sm = 0;
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, crc32c_kernel,
                                                          kMaxWarps * 32, kSmemBytes);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    cached[dev] = *sms;
  }
  *sms = cached[dev];
  return cudaSuccess;
}

}  // namespace

// in: S rows of L bytes, 1 <= L < 2^40, row s at in + s * row_stride (any
// alignment; the aligned 16-byte words that hold a row's bytes are read
// whole, and the bytes outside the row are masked); op: the (8032,) uint32
// operand of ops/checksum_offload.py::kernel_tables on the device;
// zero_const: crc32c of L zero bytes; out: (S,) int64 on the device.
// Returns cudaGetLastError() after the launch (0 on success); does not
// synchronise.
extern "C" int crc32c_launch(const void* in, long long S, long long L, long long row_stride,
                             const void* op, uint32_t zero_const, void* out, void* stream) {
  static_assert(kOpWords == 8032, "operand layout of ops/checksum_offload.py");
  static_assert(kV == 2, "the step's word list takes two vectors");
  if (S < 0 || L < 1 || L >= (1LL << 40)) return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  int sms = 0;
  const cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  // kMaxWarps warps an SM, in one block at the bulk shapes; a few rows are
  // spread over more SMs in blocks of fewer warps (at least kMinWarps)
  long long warps = (S + sms - 1) / sms;
  warps = warps < kMinWarps ? kMinWarps : warps > kMaxWarps ? kMaxWarps : warps;
  long long grid = (S + warps - 1) / warps;
  const long long wave = (long long)sms * (kMaxWarps / warps);
  if (grid > wave) grid = wave;
  crc32c_kernel<<<(unsigned)grid, (unsigned)(warps * 32), kSmemBytes,
                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(in), S, L, row_stride, static_cast<const uint32_t*>(op),
      zero_const, static_cast<long long*>(out));
  return (int)cudaGetLastError();
}
