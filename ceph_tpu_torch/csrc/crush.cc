// CRUSH hashing + straw2 selection on the host, for ceph_tpu_torch/crush/.
//
// A copy of native/crush.cc; only this comment differs.  Ceph keeps CRUSH
// in C (src/crush/mapper.c) because placement is branchy integer hashing,
// a CPU workload.  This file implements the same fixed-point math as
// ceph_tpu_torch/crush/crush.py; the Python side hands over its log2 table
// at init (crush/native.py) so both languages pick identical winners.
// ceph_tpu_torch/utils/native.py builds it with csrc/crc32c_host.cc at
// first use into ceph_tpu_torch/_build/.

#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t kHashSeed = 1315423911u;

// Jenkins 96-bit mix (public domain lookup2 mixing step).
inline void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a -= b; a -= c; a ^= c >> 13;
  b -= c; b -= a; b ^= a << 8;
  c -= a; c -= b; c ^= b >> 13;
  a -= b; a -= c; a ^= c >> 12;
  b -= c; b -= a; b ^= a << 16;
  c -= a; c -= b; c ^= b >> 5;
  a -= b; a -= c; a ^= c >> 3;
  b -= c; b -= a; b ^= a << 10;
  c -= a; c -= b; c ^= b >> 15;
}

int32_t g_ln16[65536];
bool g_ln16_set = false;

}  // namespace

extern "C" {

uint32_t ceph_tpu_crush_hash32(uint32_t a) {
  uint32_t h = kHashSeed ^ a;
  uint32_t x = 231232, y = 1232;
  mix(a, x, h);
  mix(y, a, h);
  return h;
}

uint32_t ceph_tpu_crush_hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = kHashSeed ^ a ^ b;
  uint32_t x = 231232, y = 1232;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
  return h;
}

uint32_t ceph_tpu_crush_hash32_3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = kHashSeed ^ a ^ b ^ c;
  uint32_t x = 231232, y = 1232;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  return h;
}

// Install the Python-generated fixed-point log2 table (65536 entries).
void ceph_tpu_crush_set_ln_table(const int32_t* table) {
  std::memcpy(g_ln16, table, sizeof(g_ln16));
  g_ln16_set = true;
}

int ceph_tpu_crush_ln_table_set(void) { return g_ln16_set ? 1 : 0; }

// straw2 winner among n items: largest ln(hash16)/weight draw
// (mapper.c bucket_straw2_choose semantics; fixed-point as in Python).
// Returns CRUSH_ITEM_NONE (0x7fffffff) when no item has positive weight.
int32_t ceph_tpu_straw2_choose(uint32_t x, uint32_t r, const int32_t* items,
                               const int32_t* weights, int32_t n) {
  int32_t best_item = 0x7fffffff;
  int64_t best_draw = 0;
  bool have_best = false;
  for (int32_t i = 0; i < n; i++) {
    if (weights[i] <= 0) continue;
    uint32_t u =
        ceph_tpu_crush_hash32_3(x, static_cast<uint32_t>(items[i]), r) & 0xffff;
    // multiply, not <<: left-shifting a negative int64 is UB pre-C++20
    int64_t draw = (static_cast<int64_t>(g_ln16[u]) * 65536) / weights[i];
    if (!have_best || draw > best_draw) {
      have_best = true;
      best_draw = draw;
      best_item = items[i];
    }
  }
  return best_item;
}

}  // extern "C"
