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
// every decode matrix of the coder LRU.  Its form: rows of (kind, dst slot,
// a slot, b slot), then the input chunks' slots (k) and the output rows'
// slots (m), -1 for an unused chunk or an all-zero row.  A slot holds a live
// register; the host assigns slots by liveness and reuses dead ones
// (RS(8,3)'s 47-op ring program: 11 slots).  An op's `a` of -1 is the
// accumulator, the result of the op before, kept in a register; a dst of -1
// is not stored.  A program has any number of ops; a launch has up to 512
// rows (the delta of k + m = 256: 2k + 2m).
//
// What bounds it: bytes.  RS(8,3) encode at (256, 8, 131072) moves
// (k + m)·S·L = 369,098,752 bytes, 0.1102 ms at 3.35 TB/s, against 103
// integer ops a word for the program (0.0517 ms at the INT32 rate); the
// scrub verify of (3200, 11, 4096) reads 144,179,200 bytes, 0.0430 ms.  To
// move bytes at that rate a thread must keep its rows' loads in flight and
// an SM must hold many warps, while each op of the program waits on its
// slot reads in shared memory.  What the design does about it:
//
//   * Slots in shared memory.  A register array indexed at run time would be
//     local memory, so a thread's live registers are slots of 16 bytes in
//     shared memory, slot-major (a warp's access to one slot is 512
//     contiguous bytes, no bank conflict): RS(8,3)'s 11 slots take 22 KB a
//     block of 128 threads, so 9 blocks (36 warps) are resident an SM.  Op
//     rows are staged as int4 with each slot index turned into its offset,
//     in tiles of kTileOps rows: a program of one tile once a block, a
//     longer one (any length: Cauchy(200,56)'s 46216 ops) tile by tile for
//     each work item, with a barrier on each side.
//   * Loads in flight.  A thread's k input rows go straight into their slots
//     by cp.async.cg (16 bytes; a ragged last vector zero-filled by the
//     copy's source size; a row off 16-byte alignment byte by byte), all k
//     in flight, then one wait.  The delta's new rows, and the verify's
//     stored rows or the delta's old parity at the end, are loaded 4 at a
//     time into registers.  (A second set of slots that the next item's rows
//     were copied into while the program ran, and the stored rows copied by
//     cp.async beside the inputs, were built and measured slower: each costs
//     blocks an SM.  PERF.md, PR 11.)
//   * The grid.  A launch takes kWaves = 2 times the resident blocks (SMs x
//     blocks an SM, from the occupancy calculator, cached for each kernel,
//     threads and shared memory), at most one a work item; each block walks
//     its items.  An item is one tile of `threads` 16-byte vectors of one
//     stripe (code, delta: spread round-robin, stripe-major) or one whole
//     stripe (verify).  Twice the resident blocks was measured faster than
//     once (the second wave evens out SMs that finish early) and as fast as
//     three or four times.  The scrub chunk: 9 blocks of 128 threads are
//     resident on each of 132 SMs, so its 3200 stripes go to 2376 blocks,
//     1.35 a block, the second wave taking stripes as blocks finish.  All
//     threads of a block walk the same items, so the barriers inside the
//     walk are reached by all; a thread past a row's last vector skips its
//     loads and stores, not the loop.
//   * Verify owns whole stripes.  A thread ORs its mismatch bits over the
//     stripe's tiles; at the stripe's end a warp ORs them with
//     __reduce_or_sync, lane 0 writes its warp's word, and thread 0 stores
//     the stripe's byte.  Every byte of the bitmap is written once, so it
//     needs no zeroing and no atomic.
//   * Rows are given by address and stripe stride (expanded from the
//     caller's group descriptors), so strided views and the delta's flat
//     per-shard buffers are read in place.  A row whose address and stride
//     are 16-byte aligned is read and written by 16-byte vectors; any other
//     row, and the last vector of a row whose length is not a multiple of
//     16, byte by byte (the bytes past L read as 0 and are not written).
//   * A stripe longer than a block's vectors (S = 2, L = 131075: 65 tiles of
//     128 vectors) is walked by its block tile by tile: right, not fast; it
//     is not the scrub's shape.
//
// Kernel parameters hold the row table, up to 512 rows (8 KB): that needs
// CUDA 12.1's 32,764-byte parameter limit.  Params is templated on its row
// capacity (32 or 512) so a small launch does not carry 8 KB.

#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

static_assert(CUDART_VERSION >= 12010, "the 512-row kernel parameters need CUDA 12.1 or later");

namespace {

constexpr int kSmallRows = 32;    // rows of the small parameter block
constexpr int kMaxRows = 512;     // ops/packed_gf.py::MAX_ROWS
constexpr int kTileOps = 1024;    // ops/packed_gf.py::TILE_OPS: 16 KB of op rows
constexpr int kWaves = 2;         // a launch's blocks: kWaves x the resident ones
constexpr int kGroup = 4;         // rows loaded into registers together
constexpr int kSmemLimit = 232448;  // ops/packed_gf.py::SMEM_LIMIT

enum Mode { kCode = 0, kVerify = 1, kDelta = 2 };

struct Row {
  const uint8_t* ptr;
  long long sstride;  // bytes from one stripe's row to the next's
};

template <int R>
struct Params {
  Row rows[R];
  const int4* ops;   // (nops) {kind, dst, a, b}
  const int* maps;   // in slots (k), then out slots (m)
  uint8_t* flags;    // verify: the (stripes,) bitmap
  long long stripes, L;
  long long step_s;  // code, delta: whole stripes of the grid's stride
  int step_t;        // code, delta: tiles of the grid's stride past them
  int nops, k, m, nslots, head, vecs, full, tiles, red;
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

// The n bytes at q (at most 16) as a vector; bytes past them read as 0.
__device__ __forceinline__ uint4 load_bytes(const uint8_t* q, long long n) {
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (b < n) w[b >> 2] |= static_cast<uint32_t>(__ldg(q + b)) << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int R>
__device__ __forceinline__ uint4 load16(const Row& r, long long s, int v, const Params<R>& p) {
  const uint8_t* q = r.ptr + s * r.sstride + 16LL * v;
  if (v < p.full && aligned(r)) return __ldg(reinterpret_cast<const uint4*>(q));
  return load_bytes(q, p.L - 16LL * v);
}

// Vector v of stripe s of row r into shared memory at dst: by cp.async where
// the row is aligned (a ragged last vector zero-filled past L), else byte by
// byte and stored.
template <int R>
__device__ __forceinline__ void fetch16(uint4* dst, const Row& r, long long s, int v,
                                        const Params<R>& p) {
  const uint8_t* q = r.ptr + s * r.sstride + 16LL * v;
  if (aligned(r)) {
    const long long n = p.L - 16LL * v;
    const int bytes = n < 16 ? static_cast<int>(n) : 16;
    const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(dst));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(q),
                 "r"(bytes)
                 : "memory");
  } else {
    *dst = load_bytes(q, p.L - 16LL * v);
  }
}

// Closes this thread's cp.async copies so far and waits for all of them.
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

template <int R>
__device__ __forceinline__ void store16(const Row& r, long long s, int v, const uint4& x,
                                        const Params<R>& p) {
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

__device__ __forceinline__ uint4 xtime4(const uint4& x, uint32_t red) {
  return make_uint4(xtime(x.x, red), xtime(x.y, red), xtime(x.z, red), xtime(x.w, red));
}

// Op rows [i0, i0 + n) into shared memory, each slot index turned into its
// offset from a thread's first slot (-1: the accumulator, or no store).
__device__ __forceinline__ void stage_ops(int4* sops, const int4* ops, int i0, int n, int T) {
  for (int i = threadIdx.x; i < n; i += T) {
    const int4 op = ops[i0 + i];
    sops[i] = make_int4(op.x, op.y < 0 ? -1 : op.y * T, op.z < 0 ? -1 : op.z * T, op.w * T);
  }
}

// Runs op rows [0, n) on a thread's slots from accumulator acc; returns it.
__device__ __forceinline__ uint4 run_ops(const int4* sops, int n, uint4* my, uint4 acc,
                                         uint32_t red) {
#pragma unroll 1
  for (int i = 0; i < n; ++i) {
    const int4 op = sops[i];
    const uint4 x = op.z < 0 ? acc : my[op.z];
    acc = op.x == 0 ? xor4(x, my[op.w]) : xtime4(x, red);
    if (op.y >= 0) my[op.y] = acc;
  }
  return acc;
}

template <int MODE, int R>
__device__ __forceinline__ void packed_body(const Params<R>& p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int T = blockDim.x;
  const int tid = threadIdx.x;
  const bool tiled = p.nops > kTileOps;
  int4* sops = reinterpret_cast<int4*>(smem);
  int* smaps = reinterpret_cast<int*>(sops + (tiled ? kTileOps : p.nops));
  unsigned* sred = reinterpret_cast<unsigned*>(smaps + p.k + p.m);  // 2 x 4 warps
  uint4* my = reinterpret_cast<uint4*>(smem + p.head) + tid;
  const int k = p.k, m = p.m;
  const uint32_t red = static_cast<uint32_t>(p.red);
  for (int i = tid; i < k + m; i += T) {
    const int x = p.maps[i];
    smaps[i] = x < 0 ? -1 : x * T;
  }
  if (!tiled) stage_ops(sops, p.ops, 0, p.nops, T);
  __syncthreads();
  const int* out_slots = smaps + k;
  // the block's walk: verify, whole stripes (s, then its tiles); code and
  // delta, one tile an item, the grid's stride apart
  const int G = gridDim.x;
  long long s = MODE == kVerify ? blockIdx.x : blockIdx.x / p.tiles;
  int t = MODE == kVerify ? 0 : blockIdx.x % p.tiles;
  unsigned bits = 0;
  int parity = 0;
  while (s < p.stripes) {
    const int v = t * T + tid;
    const bool live = v < p.vecs;
    // the k inputs into their slots by cp.async, all in flight (the delta:
    // old by cp.async, then new loaded kGroup at a time and XORed in)
    if (live) {
      for (int j = 0; j < k; ++j)
        if (smaps[j] >= 0) fetch16(my + smaps[j], p.rows[j], s, v, p);
      if (MODE == kDelta) {
        for (int j0 = 0; j0 < k; j0 += kGroup) {
          uint4 w[kGroup];
#pragma unroll
          for (int u = 0; u < kGroup; ++u)
            if (j0 + u < k && smaps[j0 + u] >= 0) w[u] = load16(p.rows[k + j0 + u], s, v, p);
          if (j0 == 0) wait_copies();  // with the first new rows in flight
#pragma unroll
          for (int u = 0; u < kGroup; ++u) {
            const int j = j0 + u;
            if (j < k && smaps[j] >= 0) my[smaps[j]] = xor4(my[smaps[j]], w[u]);
          }
        }
      } else {
        wait_copies();
      }
    }
    // the program
    if (!tiled) {
      run_ops(sops, p.nops, my, make_uint4(0u, 0u, 0u, 0u), red);
    } else {
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      for (int i0 = 0; i0 < p.nops; i0 += kTileOps) {
        const int n = p.nops - i0 < kTileOps ? p.nops - i0 : kTileOps;
        __syncthreads();
        stage_ops(sops, p.ops, i0, n, T);
        __syncthreads();
        acc = run_ops(sops, n, my, acc, red);
      }
    }
    // the m outputs: stored, or compared with (folded into) the stored rows
    // (the old parity), loaded kGroup at a time
    if (live) {
      for (int i0 = 0; i0 < m; i0 += kGroup) {
        uint4 w[kGroup];
        if (MODE != kCode) {
#pragma unroll
          for (int u = 0; u < kGroup; ++u)
            if (i0 + u < m) w[u] = load16(p.rows[(MODE == kDelta ? 2 * k : k) + i0 + u], s, v, p);
        }
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          const int i = i0 + u;
          if (i >= m) break;
          const int sl = out_slots[i];
          uint4 r = sl < 0 ? make_uint4(0u, 0u, 0u, 0u) : my[sl];
          if (MODE == kCode) {
            store16(p.rows[k + i], s, v, r, p);
          } else if (MODE == kVerify) {
            const uint4 d = xor4(r, w[u]);
            if (d.x | d.y | d.z | d.w) bits |= 1u << i;
          } else {
            store16(p.rows[2 * k + m + i], s, v, xor4(r, w[u]), p);
          }
        }
      }
    }
    if (MODE == kVerify && t == p.tiles - 1) {  // the stripe's byte, once
      const unsigned w = __reduce_or_sync(0xffffffffu, bits);
      if ((tid & 31) == 0) sred[4 * parity + (tid >> 5)] = w;
      __syncthreads();
      if (tid == 0) {
        unsigned all = 0;
        for (int i = 0; i < (T >> 5); ++i) all |= sred[4 * parity + i];
        p.flags[s] = static_cast<uint8_t>(all);
      }
      bits = 0;
      parity ^= 1;  // the next stripe's words go to the other half
    }
    if (MODE == kVerify) {
      if (++t == p.tiles) { t = 0; s += G; }
    } else {
      s += p.step_s;
      t += p.step_t;
      if (t >= p.tiles) { t -= p.tiles; ++s; }
    }
  }
}

#define PACKED_KERNEL(NAME, MODE) \
  template <int R>                \
  __global__ void NAME(const __grid_constant__ Params<R> p) { packed_body<MODE, R>(p); }

PACKED_KERNEL(packed_code_kernel, kCode)
PACKED_KERNEL(packed_verify_kernel, kVerify)
PACKED_KERNEL(packed_delta_kernel, kDelta)

template <int R>
const void* kernel_of(int mode) {
  if (mode == kCode) return (const void*)packed_code_kernel<R>;
  if (mode == kVerify) return (const void*)packed_verify_kernel<R>;
  return (const void*)packed_delta_kernel<R>;
}

// Resident blocks an SM of `kernel` at (threads, smem) on the current device,
// and its SMs; each kernel's shared-memory ceiling is raised once a device.
struct Resident {
  const void* kernel;
  int device, threads, smem, blocks, sms;
};
std::mutex g_lock;
Resident g_resident[256];
int g_nresident = 0;

int resident(const void* kernel, int threads, int smem, int* blocks, int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  std::lock_guard<std::mutex> guard(g_lock);
  bool raised = false;
  for (int i = 0; i < g_nresident; ++i) {
    const Resident& r = g_resident[i];
    if (r.kernel == kernel && r.device == device) {
      raised = true;
      if (r.threads == threads && r.smem == smem) {
        *blocks = r.blocks;
        *sms = r.sms;
        return 0;
      }
    }
  }
  if (!raised) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit);
    if (err != cudaSuccess) return (int)err;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (*blocks < 1) return (int)cudaErrorInvalidConfiguration;
  if (g_nresident < 256) g_resident[g_nresident++] = {kernel, device, threads, smem, *blocks, *sms};
  return 0;
}

long long shared_bytes(int nops, int k, int m, int slots, int threads) {
  const int tile = nops < kTileOps ? nops : kTileOps;
  const long long head = (16LL * tile + 4LL * (k + m) + 32 + 15) / 16 * 16;
  return head + 16LL * slots * threads;
}

template <int R>
int launch(int mode, const long long* groups, int ngroups, const void* prog,
           int nops, int nslots, int threads, int k, int m, long long stripes,
           long long L, int red, void* flags, void* stream, int* grid_out) {
  Params<R> p;
  int row = 0;
  for (int g = 0; g < ngroups; ++g) {
    const long long* d = groups + 4 * g;  // base, stripe stride, row stride, rows
    for (long long i = 0; i < d[3]; ++i, ++row) {
      p.rows[row].ptr = reinterpret_cast<const uint8_t*>(d[0] + i * d[2]);
      p.rows[row].sstride = d[1];
    }
  }
  p.ops = static_cast<const int4*>(prog);
  p.maps = static_cast<const int*>(prog) + 4 * nops;
  p.flags = static_cast<uint8_t*>(flags);
  p.stripes = stripes;
  p.L = L;
  p.nops = nops;
  p.k = k;
  p.m = m;
  p.nslots = nslots;
  p.vecs = (int)((L + 15) / 16);
  p.full = (int)(L / 16);
  p.tiles = (p.vecs + threads - 1) / threads;
  p.red = red;
  const long long smem = shared_bytes(nops, k, m, nslots, threads);
  if (smem > kSmemLimit) return (int)cudaErrorInvalidValue;
  p.head = (int)(smem - 16LL * nslots * threads);
  const void* kernel = kernel_of<R>(mode);
  int blocks = 0, sms = 0;
  int err = resident(kernel, threads, (int)smem, &blocks, &sms);
  if (err != 0) return err;
  const long long items = mode == kVerify ? stripes : stripes * p.tiles;
  const long long cap = (long long)kWaves * blocks * sms;
  const long long grid = items < cap ? items : cap;
  p.step_s = grid / p.tiles;
  p.step_t = (int)(grid % p.tiles);
  if (grid_out != nullptr) {
    grid_out[0] = (int)grid;
    grid_out[1] = blocks;
  }
  void* args[] = {&p};
  err = (int)cudaLaunchKernel(kernel, dim3((unsigned)grid), dim3(threads), args, (size_t)smem,
                              static_cast<cudaStream_t>(stream));
  if (err != 0) return err;
  return (int)cudaGetLastError();
}

}  // namespace

// mode 0 code, 1 verify, 2 delta.  groups: host array of ngroups
// descriptors of 4 int64 (base address, stripe stride, row stride, rows),
// expanded in order into the row table: code and verify k + m rows (data,
// then output or stored parity), delta 2k + 2m (old, new, old parity, new
// parity); at most 512.  prog: the device operand of
// ops/packed_gf.py::LoweredProgram (nops rows of 4 int32, then k + m slot
// indices), with nslots slots.  threads: a block's, 32, 64 or 128
// (ops/packed_gf.py::block_threads).  red: the xtime reduction byte.
// flags: verify's (stripes,) uint8 bitmap, every byte written.  grid: if
// not null, receives the launch's blocks and the resident blocks an SM.  Returns
// cudaGetLastError() after the launch (0 on success); does not synchronise.
extern "C" int packed_gf_launch(int mode, const long long* groups, int ngroups, const void* prog,
                                int nops, int nslots, int threads, int k, int m,
                                long long stripes, long long L, int red, void* flags,
                                void* stream, int* grid) {
  if (mode < kCode || mode > kDelta || ngroups < 1 || k < 1 || m < 1 || nops < 0 ||
      nslots < 0 || (threads != 32 && threads != 64 && threads != 128) || stripes < 0 || L < 0 ||
      L / 16 >= (1LL << 30) || (mode == kVerify && (flags == nullptr || m > 8)))
    return (int)cudaErrorInvalidValue;
  long long nrows = 0;
  for (int g = 0; g < ngroups; ++g) {
    if (groups[4 * g + 3] < 0) return (int)cudaErrorInvalidValue;
    nrows += groups[4 * g + 3];
  }
  if (nrows != (mode == kDelta ? 2LL * (k + m) : (long long)(k + m)) || nrows > kMaxRows)
    return (int)cudaErrorInvalidValue;
  if (stripes == 0 || L == 0) return 0;
  return nrows <= kSmallRows
             ? launch<kSmallRows>(mode, groups, ngroups, prog, nops,
                                  nslots, threads, k, m, stripes, L, red, flags, stream, grid)
             : launch<kMaxRows>(mode, groups, ngroups, prog, nops,
                                nslots, threads, k, m, stripes, L, red, flags, stream, grid);
}
