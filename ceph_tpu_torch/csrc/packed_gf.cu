// Packed-plane GF(2^8) coding for Hopper (sm_90a): the plane programs of
// ceph_tpu/ops/packed_gf.py as three kernels with the program a runtime
// operand.
//
// Replaces the XLA-jitted device programs (no pl.pallas_call) of
// ceph_tpu/ops/packed_gf.py:
//   packed_code_kernel    _packed_code_impl / _packed_code / _packed_code_into
//                         (:315-372): (S, k, L) uint8 -> (S, m, L), any L >= 1
//   packed_verify_kernel  _packed_verify_impl / _packed_verify (:375-397):
//                         (S, k+m, L) codewords -> (S,) mismatch bitmap
//   packed_delta_kernel   _packed_delta / _packed_delta_flat (:400-443):
//                         parity ^ P(old ^ new)
//
// Arithmetic.  A plane program is a straight-line list of ops over byte
// registers: registers 0..k-1 are the input chunks, and each op makes one
// register, an XOR of two or xtime(a) = (a << 1) ^ ((a >> 7) * 0x1d) on
// each byte.  Both are bytewise, so 4 bytes of a chunk are coded at once in
// a 32-bit word (SWAR): xtime is ((w << 1) & 0xfefefefe) ^
// (((w >> 7) & 0x01010101) * red).
//
// The program is a runtime operand (ops/packed_gf.py::lower_program), as
// swar_gf.cu's schedule is, so one library serves every encode matrix and
// every decode matrix of the coder LRU; a library per matrix would cost an
// nvcc run of seconds for each decode pattern.  Its form: rows of
// (kind, dst slot, a slot, b slot), then the input chunks' slots (k) and
// the output rows' slots (m), -1 for an unused chunk or an all-zero row.
// A slot holds a live register; the host assigns slots by liveness and
// reuses dead ones (RS(8,3)'s 47-op ring program: 11 slots; its decode for
// erasures 0..2: 48; RS(12,4) decode: 88), and picks the block's threads:
// 128, or 64 or 32 where the slots would not fit shared memory
// (ops/packed_gf.py::block_threads; a codec's plan takes the construction
// that fits the most threads, kernel_program).  An op's `a` of -1 is the
// accumulator, the result of the op before, kept in registers; a dst of -1
// is not stored (only the next op reads it, as its accumulator).
//
// Layout on the card:
//   * A block stages the program into shared memory once, with each slot
//     index turned into its offset.  A register array indexed at run time
//     would be local memory, so the slots live in shared memory too:
//     slot-major, 16 bytes a thread (a warp's access to one slot is 512
//     contiguous bytes, no bank conflict).
//   * A thread codes one 16-byte vector (4 words) of a stripe's rows: it
//     loads the k chunk vectors (4 at a time, all in flight), runs the
//     program (each op: its row from shared memory by broadcast, at most 2
//     slot reads and 1 slot write of 16 bytes, and 4 word ops or 4 xtimes),
//     and stores, compares or folds the m outputs.  A 2-D block (vectors x
//     stripes) and a 2-D grid (vector blocks x stripe blocks) give each
//     thread its vector and stripe with no integer division; stripes past
//     the grid are reached by a stride.
//   * Rows are given by address and stripe stride, one entry each (k + m
//     for code and verify, 2k + 2m for the delta: old, new, parity in,
//     parity out), so a strided view of codewords and the delta's separate
//     per-shard buffers are read in place.  A row whose address and stride
//     are 16-byte aligned is read and written by 16-byte vectors; any other
//     row, and the last vector of a row whose length is not a multiple of
//     16, byte by byte (the bytes past L read as 0 and are not written).
//   * Verify: bit i of a thread's byte is set if output row i differs from
//     the stored row in its vector; a nonzero byte is ORed into the
//     stripe's byte of the zeroed bitmap with one atomicOr on the 32-bit
//     word that holds it (a clean codeword makes none).
//
// Bound on an H100 SXM (3.35 TB/s HBM3; INT32 at 16.7 T ops/s).  For
// RS(8,3) encode at (256, 8, 131072): (k + m)·S·L = 369,098,752 bytes ->
// 0.1102 ms, which binds over the program's ops (33 XOR + 14 xtime of 5 ops
// = 103 a word, 0.0517 ms).  Beside the bytes, this kernel's own work is
// its slot traffic in shared memory: for RS(8,3), 16 bytes each for the 8
// input stores, the program's 41 slot reads and 8 stores (its other 39
// first operands come from the accumulator) and the 3 output reads, about
// 960 bytes a vector against 176 bytes of HBM, with shared memory about 9x
// the HBM rate an SM; and the 47 op rows, read by broadcast.  PERF.md has
// its times.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxRows = 192;       // ops/packed_gf.py::MAX_ROWS
constexpr int kMaxOps = 4096;       // ops/packed_gf.py::MAX_OPS
constexpr int kGroup = 4;           // chunk vectors loaded together
constexpr int kSmemLimit = 232448;  // ops/packed_gf.py::SMEM_LIMIT

enum Mode { kCode = 0, kVerify = 1, kDelta = 2 };

struct Row {
  const uint8_t* ptr;
  long long sstride;  // bytes from one stripe's row to the next's
};

struct Params {
  Row rows[kMaxRows];
  const int4* ops;        // (nops) {kind, dst, a, b}
  const int* maps;        // in slots (k), then out slots (m)
  unsigned int* flags;    // verify: the (stripes,) uint8 bitmap, zeroed, as words
  long long stripes;
  long long L;
  int nops, k, m, vecs, full, red;  // vecs = ceil(L / 16), full = L / 16
};

__device__ __forceinline__ uint32_t xtime(uint32_t w, uint32_t red) {
  return ((w << 1) & 0xfefefefeu) ^ (((w >> 7) & 0x01010101u) * red);
}

__device__ __forceinline__ uint4 xor4(const uint4& a, const uint4& b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

__device__ __forceinline__ bool aligned(const Row& r) {
  return ((reinterpret_cast<uintptr_t>(r.ptr) | static_cast<uintptr_t>(r.sstride)) & 15) == 0;
}

// Vector v of stripe s of row r; bytes past L read as 0.
__device__ __forceinline__ uint4 load16(const Row& r, long long s, int v, const Params& p) {
  const uint8_t* q = r.ptr + s * r.sstride + 16LL * v;
  if (v < p.full && aligned(r)) return __ldg(reinterpret_cast<const uint4*>(q));
  const long long n = p.L - 16LL * v;  // bytes of this vector in the row
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < n) w[b >> 2] |= static_cast<uint32_t>(__ldg(q + b)) << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(const Row& r, long long s, int v, const uint4& x,
                                        const Params& p) {
  uint8_t* q = const_cast<uint8_t*>(r.ptr) + s * r.sstride + 16LL * v;
  if (v < p.full && aligned(r)) {
    *reinterpret_cast<uint4*>(q) = x;
    return;
  }
  const long long n = p.L - 16LL * v;
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < n) q[b] = static_cast<uint8_t>(w[b >> 2] >> (8 * (b & 3)));
}

template <int MODE>
__device__ __forceinline__ void packed_body(const Params& p) {
  extern __shared__ int4 smem[];
  int4* sops = smem;
  int* smaps = reinterpret_cast<int*>(smem + p.nops);
  const int nmaps = p.k + p.m;
  uint4* slots = reinterpret_cast<uint4*>(smem + p.nops + (nmaps + 3) / 4);
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  // stage the program, each slot index as its offset from the thread's base
  for (int i = tid; i < p.nops; i += nthreads) {
    int4 op = p.ops[i];
    op.y = op.y < 0 ? -1 : op.y * nthreads;
    op.z = op.z < 0 ? -1 : op.z * nthreads;
    op.w = op.w * nthreads;
    sops[i] = op;
  }
  for (int i = tid; i < nmaps; i += nthreads) {
    const int x = p.maps[i];
    smaps[i] = x < 0 ? -1 : x * nthreads;
  }
  __syncthreads();
  const int v = blockIdx.x * blockDim.x + threadIdx.x;
  if (v >= p.vecs) return;
  uint4* my = slots + tid;
  const uint32_t red = static_cast<uint32_t>(p.red);
  const long long sstep = static_cast<long long>(gridDim.y) * blockDim.y;
  for (long long s = static_cast<long long>(blockIdx.y) * blockDim.y + threadIdx.y;
       s < p.stripes; s += sstep) {
    // the k chunk vectors into their slots (the delta: old ^ new)
    for (int j0 = 0; j0 < p.k; j0 += kGroup) {
      uint4 w[kGroup];
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int j = j0 + u;
        if (j < p.k && smaps[j] >= 0) {
          w[u] = load16(p.rows[j], s, v, p);
          if (MODE == kDelta) w[u] = xor4(w[u], load16(p.rows[p.k + j], s, v, p));
        }
      }
#pragma unroll
      for (int u = 0; u < kGroup; ++u) {
        const int j = j0 + u;
        if (j < p.k && smaps[j] >= 0) my[smaps[j]] = w[u];
      }
    }
    // the program
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll 1
    for (int i = 0; i < p.nops; ++i) {
      const int4 op = sops[i];
      const uint4 a = op.z < 0 ? acc : my[op.z];
      if (op.x == 0) {
        acc = xor4(a, my[op.w]);
      } else {
        acc = make_uint4(xtime(a.x, red), xtime(a.y, red), xtime(a.z, red), xtime(a.w, red));
      }
      if (op.y >= 0) my[op.y] = acc;
    }
    // the m outputs: stored, compared or folded into the old parity
    const int* out_slots = smaps + p.k;
    unsigned int bits = 0;
    for (int i = 0; i < p.m; ++i) {
      const int sl = out_slots[i];
      uint4 r = sl < 0 ? make_uint4(0u, 0u, 0u, 0u) : my[sl];
      if (MODE == kCode) {
        store16(p.rows[p.k + i], s, v, r, p);
      } else if (MODE == kVerify) {
        const uint4 d = xor4(r, load16(p.rows[p.k + i], s, v, p));
        if (d.x | d.y | d.z | d.w) bits |= 1u << i;
      } else {
        r = xor4(r, load16(p.rows[2 * p.k + i], s, v, p));
        store16(p.rows[2 * p.k + p.m + i], s, v, r, p);
      }
    }
    if (MODE == kVerify && bits) atomicOr(p.flags + (s >> 2), bits << (8 * (s & 3)));
  }
}

__global__ void packed_code_kernel(const __grid_constant__ Params p) { packed_body<kCode>(p); }
__global__ void packed_verify_kernel(const __grid_constant__ Params p) { packed_body<kVerify>(p); }
__global__ void packed_delta_kernel(const __grid_constant__ Params p) { packed_body<kDelta>(p); }

}  // namespace

// mode 0 code, 1 verify, 2 delta.  rows: host array of nrows (address,
// stripe stride) int64 pairs, in the order above (code and verify: k + m,
// delta: 2k + 2m).  prog: the device operand of
// ops/packed_gf.py::LoweredProgram (nops rows of 4 int32, then k + m slot
// indices), with nslots slots.  threads: a block's, 32, 64 or 128, with
// the slots in shared memory (ops/packed_gf.py::block_threads).  red: the
// xtime reduction byte.  flags: verify's uint8 bitmap of
// ceil(stripes / 4) * 4 bytes, zeroed, 4-byte aligned.  Returns
// cudaGetLastError() after the launch (0 on success); does not synchronise.
extern "C" int packed_gf_launch(int mode, const long long* rows, int nrows, const void* prog,
                                int nops, int nslots, int threads, int k, int m,
                                long long stripes, long long L, int red, void* flags,
                                void* stream) {
  const int want = mode == kDelta ? 2 * (k + m) : k + m;
  if (mode < kCode || mode > kDelta || k < 1 || m < 1 || nrows != want ||
      nrows > kMaxRows || nops < 0 || nops > kMaxOps || nslots < 0 ||
      (threads != 32 && threads != 64 && threads != 128) || stripes < 0 || L < 0 ||
      L / 16 >= (1LL << 30) ||
      (mode == kVerify && (flags == nullptr || (reinterpret_cast<uintptr_t>(flags) & 3) ||
                           m > 8)))
    return (int)cudaErrorInvalidValue;
  if (stripes == 0 || L == 0) return 0;
  Params p;
  for (int i = 0; i < nrows; ++i) {
    p.rows[i].ptr = reinterpret_cast<const uint8_t*>(rows[2 * i]);
    p.rows[i].sstride = rows[2 * i + 1];
  }
  p.ops = static_cast<const int4*>(prog);
  p.maps = static_cast<const int*>(prog) + 4 * nops;
  p.flags = static_cast<unsigned int*>(flags);
  p.stripes = stripes;
  p.L = L;
  p.nops = nops;
  p.k = k;
  p.m = m;
  p.vecs = (int)((L + 15) / 16);
  p.full = (int)(L / 16);
  p.red = red;
  // Shared memory: the op rows and slot maps, then the slots (RS(8,3)
  // encode: 128 threads x 11 slots x 16 B = 22 KB).  Shared memory a
  // resident warp needs is set by the slots, whatever the block.
  const size_t head = (size_t)16 * (nops + (k + m + 3) / 4);
  const size_t smem = head + (size_t)16 * nslots * threads;
  if (smem > (size_t)kSmemLimit) return (int)cudaErrorInvalidValue;
  int bx = 1;
  while (bx < threads && bx < p.vecs) bx <<= 1;
  const int by = threads / bx;
  const long long gx = (p.vecs + bx - 1) / bx;
  long long gy = (stripes + by - 1) / by;
  if (gy > 65535) gy = 65535;
  if (gx > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  auto st = static_cast<cudaStream_t>(stream);
  void (*kernel)(Params) = mode == kCode ? packed_code_kernel
                           : mode == kVerify ? packed_verify_kernel : packed_delta_kernel;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<dim3((unsigned)gx, (unsigned)gy), dim3(bx, by), smem, st>>>(p);
  return (int)cudaGetLastError();
}
