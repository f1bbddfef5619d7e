// Baked-schedule SWAR GF(2^8) coding for Hopper (sm_90a), on words of 4
// consecutive bytes.
//
// Replaces the TPU kernel experiment benchmarks/diag/kern_exp2.py::make_swar
// (:69-99; kernel body _kernel_swar :48-66, launched by pl.pallas_call at
// :83).  Same function as csrc/swar_gf.cu:
//   in  (S, k, L) uint8, L a multiple of 32
//   out (S, m, L) uint8, the GF(2^8) product of the (m, k) matrix and the
//       k chunks of each stripe.
// This file is compiled only behind a prelude that
// ceph_tpu_torch/diag/swar_program.py generates from one matrix: kK, kM,
// and `swar_program`, the TPU kernel's XOR schedule written out as straight
// line code over one 32-bit word of each chunk (cut the needed planes
// (x >> b) & 0x01010101, XOR-chain each output bit-row, shift and OR it
// into place).  One library per matrix, as the TPU compiles once per matrix.
//
// Translation.  The TPU script bitcasts the input outside the kernel to
// (S, k, 8, L/32) int32, so word (a, w) holds bytes 4(a·L/32 + w) .. +3 of
// its chunk, and gives each program the block (1, k, 8, wt): 8 segments of
// wt words.  Here one CUDA block of 256 threads covers that same block
// (blockIdx.x = stripe · (L/32/wt) + block column) and walks its 8·wt words
// as 16-byte vectors of 4 words, neighbouring threads on neighbouring
// addresses.  The bitcast costs nothing: the words are the bytes as stored.
//
// Bound on an H100 SXM (published peaks: 3.35 TB/s HBM3; INT32 at 64 lanes
// per SM x 132 SMs x 1.98 GHz = 16.7 T ops/s).  For RS(8,3) encode at the
// bulk shape (256, 8, 131072):
//   * memory: (k + m)·S·L = 369,098,752 B -> 0.1102 ms, which binds;
//   * integer ALU, counted on what the function needs (Horner's ring
//     program over the packed bytes, 103 ops per word position of the 8
//     chunks, as chip_smoke.py counts it): 0.0517 ms.
// This kernel's own work is the TPU schedule: for Vandermonde RS(8,3), 120
// cut ops, 377 XORs and 42 placement ops = 539 per word as written, 0.271
// ms at the INT32 peak.  nvcc folds XOR pairs and AND-XOR into 3-input
// LOP3s: the SASS of this kernel for that matrix is 1248 instructions for
// the 4 words of a vector, 312 per word, 184 of them LOP3 and 56 shifts
// (cuobjdump, sm_90a, printed by chip_smoke.py phase 1; 80 registers, no
// spills), about 0.157 ms at the INT32 peak.  That is above the memory
// bound, so the kernel is bound by its own integer issue.  The design bets
// that specialisation beats swar_gf's 384 density-independent ops plus its
// schedule loads; PERF.md has the times on an H100.

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t lane(const uint4& v, int c) {
  return c == 0 ? v.x : c == 1 ? v.y : c == 2 ? v.z : v.w;
}

__device__ __forceinline__ void set_lane(uint4& v, int c, uint32_t u) {
  if (c == 0) v.x = u;
  else if (c == 1) v.y = u;
  else if (c == 2) v.z = u;
  else v.w = u;
}

__global__ void __launch_bounds__(kThreads)
swar_baked_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
                  long long vecs, long long row_vecs, int seg,
                  long long blocks_per_stripe) {
  const long long s = blockIdx.x / blocks_per_stripe;
  const long long col = blockIdx.x - s * blocks_per_stripe;
  const uint4* src = data + s * kK * vecs;
  uint4* dst = out + s * kM * vecs;
#pragma unroll 1
  for (int v = threadIdx.x; v < 8 * seg; v += kThreads) {
    const int a = v / seg;
    const long long off = a * row_vecs + col * seg + (v - a * seg);
    uint4 in[kK];
#pragma unroll
    for (int j = 0; j < kK; ++j) in[j] = src[(long long)j * vecs + off];
    uint4 res[kM];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t x[kK], y[kM];
#pragma unroll
      for (int j = 0; j < kK; ++j) x[j] = lane(in[j], c);
      swar_program(x, y);
#pragma unroll
      for (int i = 0; i < kM; ++i) set_lane(res[i], c, y[i]);
    }
#pragma unroll
    for (int i = 0; i < kM; ++i) dst[(long long)i * vecs + off] = res[i];
  }
}

}  // namespace

// data: (stripes, kK, L) uint8; out: (stripes, kM, L) uint8; both 16-byte
// aligned.  L % 32 == 0, wt % 4 == 0, (L / 32) % wt == 0.  Returns
// cudaGetLastError() after the launch (0 on success); does not synchronise.
extern "C" int swar_baked_launch(const void* data, void* out,
                                 long long stripes, long long L, int wt,
                                 void* stream) {
  if (stripes < 0 || L < 0 || wt < 4 || wt % 4 != 0 || L % 32 != 0 ||
      (L / 32) % wt != 0)
    return (int)cudaErrorInvalidValue;
  const long long per = L / 32 / wt;
  const long long blocks = stripes * per;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swar_baked_kernel<<<(unsigned)blocks, kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(data), static_cast<uint4*>(out), L / 16,
      L / 128, wt / 4, per);
  return (int)cudaGetLastError();
}
