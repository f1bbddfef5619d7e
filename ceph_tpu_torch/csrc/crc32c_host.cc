// crc32c (Castagnoli) on the host — the hinfo digest of the port's EC path.
//
// A copy of native/crc32c.cc.  Ceph keeps per-shard cumulative crc32c
// digests in the `hinfo` xattr (src/osd/ECUtil.h:101-160) and computes them
// on the CPU next to the coding loop; so does the port.  SSE4.2 hardware
// crc32 when available (runtime-probed), with a software slicing-by-8
// fallback; exported with a plain C ABI for the ctypes binding in
// ceph_tpu_torch/utils/crc32c.py, which builds it at first use with
// `g++ -O3 -msse4.2 -shared -fPIC` into ceph_tpu_torch/_build/.
//
// This is a host library, not a device kernel.

#include <cstddef>
#include <cstdint>

#if defined(__x86_64__) || defined(_M_X64)
#include <cpuid.h>
#include <nmmintrin.h>
#define HAVE_X86 1
#endif

namespace {

constexpr uint32_t kPoly = 0x82f63b78u;  // reflected Castagnoli

uint32_t g_table[8][256];
bool g_table_ready = false;

void build_tables() {
  for (int i = 0; i < 256; i++) {
    uint32_t c = static_cast<uint32_t>(i);
    for (int j = 0; j < 8; j++) {
      c = (c & 1) ? (c >> 1) ^ kPoly : c >> 1;
    }
    g_table[0][i] = c;
  }
  for (int i = 0; i < 256; i++) {
    uint32_t c = g_table[0][i];
    for (int s = 1; s < 8; s++) {
      c = g_table[0][c & 0xff] ^ (c >> 8);
      g_table[s][i] = c;
    }
  }
  g_table_ready = true;
}

uint32_t crc32c_sw(uint32_t crc, const uint8_t* data, size_t len) {
  if (!g_table_ready) build_tables();
  crc = ~crc;
  // Slicing-by-8 over aligned 8-byte blocks.
  while (len >= 8) {
    uint64_t word;
    __builtin_memcpy(&word, data, 8);
    word ^= crc;
    crc = g_table[7][word & 0xff] ^ g_table[6][(word >> 8) & 0xff] ^
          g_table[5][(word >> 16) & 0xff] ^ g_table[4][(word >> 24) & 0xff] ^
          g_table[3][(word >> 32) & 0xff] ^ g_table[2][(word >> 40) & 0xff] ^
          g_table[1][(word >> 48) & 0xff] ^ g_table[0][(word >> 56) & 0xff];
    data += 8;
    len -= 8;
  }
  while (len--) {
    crc = g_table[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
  }
  return ~crc;
}

#ifdef HAVE_X86
bool have_sse42() {
  unsigned eax, ebx, ecx, edx;
  if (!__get_cpuid(1, &eax, &ebx, &ecx, &edx)) return false;
  return (ecx & bit_SSE4_2) != 0;
}

uint32_t crc32c_hw(uint32_t crc, const uint8_t* data, size_t len) {
  uint64_t c = ~crc;
  while (len >= 8) {
    uint64_t word;
    __builtin_memcpy(&word, data, 8);
    c = _mm_crc32_u64(c, word);
    data += 8;
    len -= 8;
  }
  uint32_t c32 = static_cast<uint32_t>(c);
  while (len--) {
    c32 = _mm_crc32_u8(c32, *data++);
  }
  return ~c32;
}
#endif

}  // namespace

extern "C" {

// Cumulative crc32c: pass the previous digest to chain blocks, matching the
// reference's append-only per-shard digests (ECUtil.h `HashInfo`).
uint32_t ceph_tpu_crc32c(uint32_t crc, const uint8_t* data, size_t len) {
#ifdef HAVE_X86
  static const bool hw = have_sse42();
  if (hw) return crc32c_hw(crc, data, len);
#endif
  return crc32c_sw(crc, data, len);
}

int ceph_tpu_crc32c_hw_available() {
#ifdef HAVE_X86
  return have_sse42() ? 1 : 0;
#else
  return 0;
#endif
}

}  // extern "C"
