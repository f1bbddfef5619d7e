// The device compressor's transform for Hopper (sm_90a).
//
// Replaces the XLA-jitted program ceph_tpu/compressor/device.py::
// transform_rows_device (:56-70).  Same function, on each row s of S:
//   in   Lp bytes (Lp % 64 == 0), read as R = Lp / 64 rows of 64 bytes
//   out  Lp + R bytes: t[p R + r] = in[r 64 + p] (the stride-64 byte-plane
//        transpose, plane p = byte p of every 64-byte row), then for each
//        64-byte cell c of t the flag t[64 c .. 64 c + 63] != 0 (0 or 1)
//
// Two paths, chosen by Lp alone (compress_transform_path below).
//
// Tiles, Lp % 4096 == 0 (every block BlueStore submits).  With m = Lp /
// 4096, tile (s, j) is the 64-byte rows 64 j .. 64 j + 63 of row s, a 64x64
// byte matrix; its plane p is output cell p m + j, whole (no cell straddles
// two planes), with its flag at Lp + p m + j.  One warp a tile, tiles
// walked by a persistent grid of warps with no division a tile:
//   - stage: 16-byte cp.async copies into a per-warp buffer, row r at word
//     16 r + 8 (r >> 4) (a skew of 32 bytes each 16 rows), double-buffered
//     so the next tile's copy is in flight while this one is transposed;
//     rows not 16-byte aligned (a strided view) are staged byte by byte;
//   - transpose: lane (q, rq) = (lane >> 2, lane & 3) reads the 32-bit
//     words of its 16 rows 16 rq .. 16 rq + 15 at word column w = q + 8 u
//     (u = 0, 1), 32 lanes on 32 banks, and turns each 4x4 byte block into
//     its 4 columns with 8 __byte_perm;
//   - store: each of its 8 planes p = 4 w + c as one 16-byte store of rows
//     16 rq .. 16 rq + 15 (4 lanes write a plane's 64 bytes);
//   - flags: a bit a plane and lane, OR-ed over the 4 lanes of a plane by
//     two shuffles, written as 4-byte words where the flags are contiguous
//     (m = 1: a row's 64) and as bytes otherwise.
//
// General, other Lp (cells straddle planes where R % 64 != 0).  One block
// a row (a grid-stride loop over rows).  The block stages the row in
// shared memory with a pitch of 65 bytes for each 64-byte row, so that 32
// lanes reading one plane at 32 consecutive rows hit different banks; the
// load is coalesced, 16 bytes a thread where the row and its stride are
// 16-byte aligned, else a byte a thread.  Then each warp takes whole cells
// of the output: lane l writes bytes 64 c + l and 64 c + 32 + l
// (coalesced), each gathered from shared memory by its (plane, row), and
// the cell's flag is __any_sync over the 64 bytes, written by lane 0.  A
// row too long for shared memory (Lp > 3576 * 64) is not staged: the warps
// gather its bytes from device memory (kStaged = false).
//
// Bound on an H100 SXM (3.35 TB/s): every input byte read once and every
// output byte written once, (2 Lp + Lp / 64) S bytes; 161.5 us at
// (65536, 4096).  The tile path moves exactly those bytes with about 150
// warp instructions a 4 KiB tile, so the bytes bound it; its time beside
// the bound, and the general path's, are in PERF.md.

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

// ---- tiles (Lp % 4096 == 0) ----

constexpr int kTileWarps = 8;
constexpr int kTileThreads = kTileWarps * 32;
constexpr int kBufWords = 4 * 264;  // 4 groups of 16 rows, 256 + 8 words apart
constexpr size_t kTileSmem = (size_t)kTileWarps * 2 * kBufWords * 4;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most one group is pending: the current tile's has landed
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// copy the 4 KiB tile at src (64 rows of 64 bytes) into buf: 16-byte chunk
// g of row r at word 16 r + 8 (r >> 4) + 4 g
template <bool kVec16>
__device__ __forceinline__ void stage_tile(uint32_t* buf, const uint8_t* src, int lane) {
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int idx = 32 * k + lane, r = idx >> 2, g = idx & 3;
    uint32_t* dst = buf + 16 * r + 8 * (r >> 4) + 4 * g;
    const uint8_t* from = src + 64 * r + 16 * g;
    if (kVec16) {
      cp_async16(dst, from);
    } else {
      uint32_t w[4];
#pragma unroll
      for (int x = 0; x < 4; ++x)
        w[x] = (uint32_t)__ldg(from + 4 * x) | ((uint32_t)__ldg(from + 4 * x + 1) << 8) |
               ((uint32_t)__ldg(from + 4 * x + 2) << 16) |
               ((uint32_t)__ldg(from + 4 * x + 3) << 24);
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// rows a0..a3 (4 bytes each) -> columns c0..c3 (byte t of c_c = byte c of a_t)
__device__ __forceinline__ void transpose4(uint32_t a0, uint32_t a1, uint32_t a2, uint32_t a3,
                                           uint32_t& c0, uint32_t& c1, uint32_t& c2,
                                           uint32_t& c3) {
  const uint32_t t0 = __byte_perm(a0, a1, 0x5140), t1 = __byte_perm(a0, a1, 0x7362);
  const uint32_t t2 = __byte_perm(a2, a3, 0x5140), t3 = __byte_perm(a2, a3, 0x7362);
  c0 = __byte_perm(t0, t2, 0x5410);
  c1 = __byte_perm(t0, t2, 0x7632);
  c2 = __byte_perm(t1, t3, 0x5410);
  c3 = __byte_perm(t1, t3, 0x7632);
}

template <bool kVec16>
__global__ void __launch_bounds__(kTileThreads, 3)
transform_tiles_kernel(const uint8_t* __restrict__ in, long long S, int m, long long row_stride,
                       uint8_t* __restrict__ out) {
  extern __shared__ uint4 tile_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t* bufs = reinterpret_cast<uint32_t*>(tile_smem) + warp * 2 * kBufWords;
  const long long Lp = 4096LL * m, out_stride = Lp + 64LL * m;
  const long long tiles = S * m, W = (long long)gridDim.x * kTileWarps;
  long long t = (long long)blockIdx.x * kTileWarps + warp;
  if (t >= tiles) return;
  // (s, j) of this tile and of the next, stepped by W tiles without dividing
  const long long ds = W / m;
  const int dj = (int)(W % m);
  long long s = t / m;
  int j = (int)(t % m);
  stage_tile<kVec16>(bufs, in + s * row_stride + 4096LL * j, lane);
  cp_async_commit();
  const int rq = lane & 3, q = lane >> 2;
  for (int b = 0; t < tiles; t += W, b ^= 1) {
    long long ns = s + ds;
    int nj = j + dj;
    if (nj >= m) {
      nj -= m;
      ++ns;
    }
    if (t + W < tiles)
      stage_tile<kVec16>(bufs + (b ^ 1) * kBufWords, in + ns * row_stride + 4096LL * nj, lane);
    cp_async_commit();
    cp_async_wait_one();
    __syncwarp();
    const uint32_t* rd = bufs + b * kBufWords + 264 * rq + q;
    uint8_t* dst = out + s * out_stride + 64LL * j + 16 * rq;
    uint32_t bits = 0;
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      uint32_t a[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) a[i] = rd[16 * i + 8 * u];
      uint32_t col[4][4];  // [c][block of 4 rows]
#pragma unroll
      for (int k = 0; k < 4; ++k)
        transpose4(a[4 * k], a[4 * k + 1], a[4 * k + 2], a[4 * k + 3], col[0][k], col[1][k],
                   col[2][k], col[3][k]);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int p = 4 * (q + 8 * u) + c;
        const uint4 v = make_uint4(col[c][0], col[c][1], col[c][2], col[c][3]);
        *reinterpret_cast<uint4*>(dst + 64LL * m * p) = v;
        bits |= (uint32_t)((v.x | v.y | v.z | v.w) != 0) << (4 * u + c);
      }
    }
    __syncwarp();  // every lane has read buf b before the next stage refills it
    bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, 1);
    bits |= __shfl_xor_sync(0xFFFFFFFFu, bits, 2);
    if (rq < 2) {  // lane (q, u = rq) writes the flags of planes 32 u + 4 q + c
      const uint32_t nib = (bits >> (4 * rq)) & 15u;
      uint8_t* flags = out + s * out_stride + Lp + j + (long long)m * (32 * rq + 4 * q);
      if (m == 1) {
        *reinterpret_cast<uint32_t*>(flags) = (nib * 0x204081u) & 0x01010101u;
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c) flags[(long long)m * c] = (uint8_t)((nib >> c) & 1u);
      }
    }
    s = ns;
    j = nj;
  }
}

template <bool kVec16>
cudaError_t launch_tiles(const void* in, long long S, long long Lp, long long row_stride,
                         void* out, cudaStream_t stream) {
  static int sms[64], per_sm[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!sms[dev]) {
    err = cudaFuncSetAttribute(transform_tiles_kernel<kVec16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTileSmem);
    if (err != cudaSuccess) return err;
    int n = 0, b = 0;
    err = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, transform_tiles_kernel<kVec16>,
                                                        kTileThreads, kTileSmem);
    if (err != cudaSuccess) return err;
    per_sm[dev] = b > 0 ? b : 1;
    sms[dev] = n;
  }
  const int m = (int)(Lp / 4096);
  const long long tiles = S * m;
  long long grid = (tiles + kTileWarps - 1) / kTileWarps;
  const long long wave = (long long)per_sm[dev] * sms[dev];
  if (grid > wave) grid = wave;
  transform_tiles_kernel<kVec16><<<(unsigned)grid, kTileThreads, kTileSmem, stream>>>(
      static_cast<const uint8_t*>(in), S, m, row_stride, static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

}  // namespace

// 1 where rows of Lp bytes take the tile path, 0 where they take the
// general one: the choice is made by Lp alone, here (the wrapper counts its
// launches by path through this function).
extern "C" int compress_transform_path(long long Lp) { return Lp > 0 && Lp % 4096 == 0; }

// in: S rows of Lp bytes (Lp a positive multiple of 64, below 2^30), row s at
// in + s * row_stride; out: dense (S, Lp + Lp / 64) on the device.  Returns
// cudaGetLastError() after the launch (0 on success); does not synchronise.
extern "C" int compress_transform_launch(const void* in, long long S, long long Lp,
                                         long long row_stride, void* out, void* stream) {
  if (S < 0 || Lp < 64 || Lp % 64 || Lp > 0x3FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  if (S == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const bool vec16 = (reinterpret_cast<uintptr_t>(in) % 16 == 0) && (row_stride % 16 == 0);
  if (compress_transform_path(Lp)) {
    if (vec16) return (int)launch_tiles<true>(in, S, Lp, row_stride, out, st);
    return (int)launch_tiles<false>(in, S, Lp, row_stride, out, st);
  }
  if (Lp > kMaxStagedLp) return (int)launch<false, false>(in, S, Lp, row_stride, out, st);
  if (vec16) return (int)launch<true, true>(in, S, Lp, row_stride, out, st);
  return (int)launch<true, false>(in, S, Lp, row_stride, out, st);
}
