// The copy floor of RS(k, 3) encode, for Hopper (sm_90a).
//
// Replaces the TPU kernel experiment benchmarks/diag/kern_exp4.py::make_copy
// (:38-52; kernel body _copy_kernel :34-35, launched by pl.pallas_call at
// :43).  Same function:
//   in  (S, k, L) uint8, 3 <= k <= 16, L a multiple of `tile`
//   out (S, 3, L) uint8 = in[:, :3]
// The TPU block (1, k, tile) DMAs all k chunks into VMEM and writes 3, so
// the kernel moves exactly the bytes RS(k, 3) encode moves: its time is the
// floor a coding kernel of that shape can reach on the card.
//
// Translation.  The TPU grid (S, L // tile) becomes a 1-D grid of S * L/tile
// blocks of 256 threads; a block covers one (stripe, tile) and each thread
// moves 16-byte vectors, neighbouring threads on neighbouring addresses.
// To move what the TPU block moves, every byte of all k chunks is loaded:
// nvcc deletes loads whose values are unused, so chunks 3..k-1 are folded
// by XOR into a value that goes into chunk 0 of the output only when it
// shares a set bit with the runtime mask `fold_mask`, which the wrapper
// passes as 0.  A guard on a plain runtime flag is not enough: nvcc
// unswitches the loop on it and the flag-off copy of the loop loads only
// chunks 0..2 (its SASS showed 11 = 8 + 3 16-byte loads); a guard that
// depends on the loaded bytes cannot be hoisted.  k is a template
// argument, so the SASS of copy_floor_kernel<8> shows the 8 LDG.E.128 per
// vector (chip_smoke.py phase 1 counts them).
//
// Bound on an H100 SXM: bytes.  (k + 3)·S·L moved; at the bulk shape
// (256, 8, 131072) that is 11 · 256 · 131072 = 369,098,752 B, at 3.35 TB/s
// 0.1102 ms.  The function needs no arithmetic (the ALU side is 0; the
// fold and its guard are about 25 integer ops per 16-byte vector for k = 8,
// far under the memory side).
// The design does nothing beyond coalesced 16-byte accesses.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

template <int K>
__global__ void __launch_bounds__(kThreads)
copy_floor_kernel(const uint4* __restrict__ data, uint4* __restrict__ out,
                  long long vecs, int tile_vecs, long long tiles,
                  unsigned fold_mask) {
  const long long s = blockIdx.x / tiles;
  const long long t = blockIdx.x - s * tiles;
  const uint4* src = data + s * K * vecs + t * tile_vecs;
  uint4* dst = out + s * 3 * vecs + t * tile_vecs;
#pragma unroll 1
  for (int v = threadIdx.x; v < tile_vecs; v += kThreads) {
    uint4 w[K];
#pragma unroll
    for (int j = 0; j < K; ++j) w[j] = src[(long long)j * vecs + v];
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int j = 3; j < K; ++j) {
      acc.x ^= w[j].x;
      acc.y ^= w[j].y;
      acc.z ^= w[j].z;
      acc.w ^= w[j].w;
    }
    if (((acc.x | acc.y | acc.z | acc.w) & fold_mask) != 0u) {
      w[0].x ^= acc.x;
      w[0].y ^= acc.y;
      w[0].z ^= acc.z;
      w[0].w ^= acc.w;
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) dst[(long long)j * vecs + v] = w[j];
  }
}

template <int K>
cudaError_t launch(const void* data, void* out, long long blocks,
                   long long vecs, int tile_vecs, long long tiles,
                   unsigned fold_mask, cudaStream_t stream) {
  copy_floor_kernel<K><<<(unsigned)blocks, kThreads, 0, stream>>>(
      static_cast<const uint4*>(data), static_cast<uint4*>(out), vecs,
      tile_vecs, tiles, fold_mask);
  return cudaGetLastError();
}

}  // namespace

// data: (stripes, k, L) uint8; out: (stripes, 3, L) uint8; both 16-byte
// aligned.  tile % 16 == 0 and L % tile == 0.  fold_mask must be 0 for
// out to equal data[:, :3].  Returns cudaGetLastError() after the launch (0 on
// success); does not synchronise.
extern "C" int copy_floor_launch(const void* data, void* out,
                                 long long stripes, int k, long long L,
                                 int tile, unsigned fold_mask,
                                 void* stream) {
  if (stripes < 0 || L < 0 || tile < 16 || tile % 16 != 0 || L % tile != 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = L / tile;
  const long long blocks = stripes * tiles;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long vecs = L / 16;
  const int tile_vecs = tile / 16;
  auto st = static_cast<cudaStream_t>(stream);
  switch (k) {
#define COPY_FLOOR_CASE(K) \
  case K:                  \
    return (int)launch<K>(data, out, blocks, vecs, tile_vecs, tiles, fold_mask, st);
    COPY_FLOOR_CASE(3)
    COPY_FLOOR_CASE(4)
    COPY_FLOOR_CASE(5)
    COPY_FLOOR_CASE(6)
    COPY_FLOOR_CASE(7)
    COPY_FLOOR_CASE(8)
    COPY_FLOOR_CASE(9)
    COPY_FLOOR_CASE(10)
    COPY_FLOOR_CASE(11)
    COPY_FLOOR_CASE(12)
    COPY_FLOOR_CASE(13)
    COPY_FLOOR_CASE(14)
    COPY_FLOOR_CASE(15)
    COPY_FLOOR_CASE(16)
#undef COPY_FLOOR_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
