// Baked-schedule SWAR GF(2^8) coding for Hopper (sm_90a), on words of 4
// bytes strided by the tile width, with each chunk's tile staged in shared
// memory.
//
// Replaces the TPU kernel experiment benchmarks/diag/kern_exp3.py::make_swar3
// (:63-96; kernel body _kernel_swar3 :41-60, launched by pl.pallas_call at
// :76).  Same function as csrc/swar_gf.cu:
//   in  (S, k, L) uint8, L a multiple of rows·cols
//   out (S, m, L) uint8, the GF(2^8) product of the (m, k) matrix and the
//       k chunks of each stripe.
// This file is compiled only behind a prelude that
// ceph_tpu_torch/diag/swar_program.py generates from one matrix: kK, kM,
// kSlabBytes, the byte-perm selectors kPerm*, and `swar_program` (the TPU
// kernel's XOR schedule as straight-line code over one 32-bit word of each
// chunk).  One library per matrix; rows and cols are runtime arguments.
//
// Translation.  The TPU kernel takes each chunk's (rows, cols) uint8 tile
// into VMEM and reinterprets it with pltpu.bitcast along the sublane axis:
// word (r, c) is the bytes of rows 4r..4r+3 of column c, row 4r+p in byte
// p.  Here one CUDA block of 128 threads takes one (stripe, tile):
//   * it stages the tile of every chunk in shared memory with cp.async
//     (the counterpart of the VMEM block), slab_rows rows at a time
//     through a ring of two slabs of kSlabBytes per chunk, so the next
//     slab's copy overlaps this slab's arithmetic;
//   * each thread takes 4 rows x 4 columns of a slab, reads the 4 row
//     words of each chunk from shared memory and turns them into the 4
//     column words with a 4x4 byte transpose (__byte_perm), which is the
//     TPU's grouping;
//   * it runs swar_program on each column word, transposes the 4 output
//     words back to rows, and stores them to global memory, neighbouring
//     threads on neighbouring 4-byte addresses.
// The function is bytewise, so any consistent grouping gives the same
// bytes; the transpose is kept because it is what the TPU kernel does, and
// its cost is part of what this experiment measures.
//
// Bound on an H100 SXM: as csrc/swar_baked.cu.  For RS(8,3) encode at the
// bulk shape (256, 8, 131072): memory (k + m)·S·L = 369,098,752 B at 3.35
// TB/s = 0.1102 ms binds; the ring program's integer ALU side is 0.0517 ms.
// The kernel's own work is the TPU schedule (539 ops per word as written
// for Vandermonde RS(8,3)) plus 8 PRMT per 4 words per chunk on the way in
// and per output on the way out, and 4 shared-memory loads per 4 words per
// chunk.

namespace {

constexpr int kThreads = 128;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one committed group (the newest) is still in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// 4x4 byte transpose: byte q of a[p] becomes byte p of w[q].
__device__ __forceinline__ void transpose4(const uint32_t (&a)[4], uint32_t (&w)[4]) {
  const uint32_t t0 = __byte_perm(a[0], a[1], kPermLo);
  const uint32_t t1 = __byte_perm(a[2], a[3], kPermLo);
  const uint32_t t2 = __byte_perm(a[0], a[1], kPermHi);
  const uint32_t t3 = __byte_perm(a[2], a[3], kPermHi);
  w[0] = __byte_perm(t0, t1, kPermEven);
  w[1] = __byte_perm(t0, t1, kPermOdd);
  w[2] = __byte_perm(t2, t3, kPermEven);
  w[3] = __byte_perm(t2, t3, kPermOdd);
}

// Issue the copies of `bytes` bytes of every chunk, from src (chunk j at
// src + j·L), into buf[j].
__device__ __forceinline__ void load_slab(uint8_t (*buf)[kSlabBytes],
                                          const uint8_t* src, long long L,
                                          int bytes) {
  const int vecs = bytes / 16;
  for (int c = threadIdx.x; c < kK * vecs; c += kThreads) {
    const int j = c / vecs;
    const int o = (c - j * vecs) * 16;
    cp_async16(&buf[j][o], src + j * L + o);
  }
}

__global__ void __launch_bounds__(kThreads)
swar3_baked_kernel(const uint8_t* __restrict__ data, uint8_t* __restrict__ out,
                   long long L, int rows, int cols, int slab_rows,
                   long long tiles) {
  __shared__ __align__(16) uint8_t stage[2][kK][kSlabBytes];
  const long long s = blockIdx.x / tiles;
  const long long t = blockIdx.x - s * tiles;
  const long long tile = (long long)rows * cols;
  const uint8_t* src = data + s * kK * L + t * tile;
  uint8_t* dst = out + s * kM * L + t * tile;
  const int slab = slab_rows * cols;
  const int nslabs = rows / slab_rows;
  const int quads = cols / 4;
  const int units = (slab_rows / 4) * quads;

  load_slab(stage[0], src, L, slab);
  cp_async_commit();
  for (int n = 0; n < nslabs; ++n) {
    if (n + 1 < nslabs)
      load_slab(stage[(n + 1) & 1], src + (long long)(n + 1) * slab, L, slab);
    cp_async_commit();  // possibly empty, so that wait_group 1 means slab n
    cp_async_wait_one();
    __syncthreads();
    const uint8_t* buf = &stage[n & 1][0][0];
    for (int u = threadIdx.x; u < units; u += kThreads) {
      const int g = u / quads;
      const int c = (u - g * quads) * 4;
      uint32_t w[4][kK];  // w[q][j]: the word of column c + q in chunk j
#pragma unroll
      for (int j = 0; j < kK; ++j) {
        uint32_t a[4], tw[4];
#pragma unroll
        for (int p = 0; p < 4; ++p)
          a[p] = *reinterpret_cast<const uint32_t*>(
              buf + j * kSlabBytes + (4 * g + p) * cols + c);
        transpose4(a, tw);
#pragma unroll
        for (int q = 0; q < 4; ++q) w[q][j] = tw[q];
      }
      uint32_t y[4][kM];
#pragma unroll
      for (int q = 0; q < 4; ++q) swar_program(w[q], y[q]);
      uint8_t* o = dst + (long long)n * slab + 4 * g * cols + c;
#pragma unroll
      for (int i = 0; i < kM; ++i) {
        const uint32_t colw[4] = {y[0][i], y[1][i], y[2][i], y[3][i]};
        uint32_t roww[4];
        transpose4(colw, roww);
#pragma unroll
        for (int p = 0; p < 4; ++p)
          *reinterpret_cast<uint32_t*>(o + i * L + p * cols) = roww[p];
      }
    }
    __syncthreads();  // every read of stage[n & 1] is done before slab n + 2 lands there
  }
}

}  // namespace

// data: (stripes, kK, L) uint8; out: (stripes, kM, L) uint8; both 16-byte
// aligned.  rows, cols and slab_rows multiples of 4, rows % slab_rows == 0,
// slab_rows·cols <= kSlabBytes, L % (rows·cols) == 0.  Returns
// cudaGetLastError() after the launch (0 on success); does not synchronise.
extern "C" int swar3_baked_launch(const void* data, void* out,
                                  long long stripes, long long L, int rows,
                                  int cols, int slab_rows, void* stream) {
  if (stripes < 0 || L < 0 || rows < 4 || rows % 4 != 0 || cols < 4 ||
      cols % 4 != 0 || slab_rows < 4 || slab_rows % 4 != 0 ||
      rows % slab_rows != 0 || slab_rows * cols > kSlabBytes ||
      L % ((long long)rows * cols) != 0)
    return (int)cudaErrorInvalidValue;
  const long long tiles = L / ((long long)rows * cols);
  const long long blocks = stripes * tiles;
  if (blocks == 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  swar3_baked_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(data), static_cast<uint8_t*>(out), L, rows,
      cols, slab_rows, tiles);
  return (int)cudaGetLastError();
}
