// libec_native.so — the native erasure-coding region engine, built as a
// dlopen-able plugin with Ceph's entry-point ABI.
//
// A copy of native/ec_native.cc; only this comment differs.  The port's
// ceph_tpu_torch/codec/plugins/native.py builds it at first use into a
// directory of its own under ceph_tpu_torch/_build/ and loads it through
// codec/registry.py::load_dynamic.
//
// Ceph's src/erasure-code/ErasureCodePlugin.cc loads `libec_<name>.so`
// with RTLD_NOW, requires `__erasure_code_version` (mismatch -> -EXDEV,
// :134-143) and `__erasure_code_init` (:145-163); the isa plugin's compute
// core is isa-l's `ec_encode_data` over split nibble tables
// (src/erasure-code/isa/ErasureCodeIsa.cc:129) with `region_xor` fast paths
// (isa/xor_op.cc).  This engine mirrors that compute model:
//
// - per-coefficient 2x16 nibble tables (the PSHUFB formulation isa-l's
//   assembly uses): mul(c, x) = LO[c][x & 15] ^ HI[c][x >> 4];
// - `ec_tables_apply` is the generic rows x cols region product serving
//   both encode (rows=m over the k data chunks) and decode (rows=#erased
//   over the k survivors) — the host computes the matrices, the engine
//   does the byte crunching, exactly the isa split;
// - GF(2^8) over 0x11d, matching ceph_tpu_torch/gf/tables.py and isa-l
//   ec_base;
// - `ec_gf_invert_matrix` mirrors isa-l's gf_invert_matrix (returns -1 on
//   a singular matrix, ErasureCodeIsa.cc:275-278);
// - vectorized with GCC vector extensions (pshufb on SSSE3), scalar
//   fallback elsewhere.

#include <cstdint>
#include <cstdlib>
#include <cstring>

#define EC_NATIVE_VERSION "ceph-tpu-ec-1.0"

static const unsigned GF_POLY = 0x11d;

static uint8_t gf_mul_table[256][256];
static bool tables_ready = false;

static void build_gf_tables() {
  if (tables_ready) return;
  // log/exp by repeated multiplication by alpha=2 (gf/tables.py twin)
  int log_t[256];
  uint8_t exp_t[512];
  unsigned x = 1;
  for (int i = 0; i < 255; i++) {
    exp_t[i] = (uint8_t)x;
    exp_t[i + 255] = (uint8_t)x;
    log_t[x] = i;
    x <<= 1;
    if (x & 0x100) x ^= GF_POLY;
  }
  log_t[0] = -1;
  for (int a = 0; a < 256; a++)
    for (int b = 0; b < 256; b++)
      gf_mul_table[a][b] =
          (a && b) ? exp_t[log_t[a] + log_t[b]] : 0;
  tables_ready = true;
}

static inline uint8_t gf_mul(uint8_t a, uint8_t b) { return gf_mul_table[a][b]; }

extern "C" {

// ---- plugin entry points (ErasureCodePlugin.cc ABI) ------------------------

const char *__erasure_code_version(void) { return EC_NATIVE_VERSION; }

int __erasure_code_init(const char *plugin_name, const char *directory) {
  (void)plugin_name;
  (void)directory;
  build_gf_tables();
  return 0;
}

// ---- coding tables ---------------------------------------------------------

struct ec_tables {
  int rows;
  int cols;
  // per (row, col) coefficient: 16B low-nibble + 16B high-nibble products
  uint8_t *nibbles;  // rows * cols * 32
  uint8_t *matrix;   // rows * cols raw coefficients
};

void *ec_tables_new(int rows, int cols, const uint8_t *matrix) {
  build_gf_tables();
  ec_tables *t = new ec_tables;
  t->rows = rows;
  t->cols = cols;
  t->nibbles = (uint8_t *)malloc((size_t)rows * cols * 32);
  t->matrix = (uint8_t *)malloc((size_t)rows * cols);
  memcpy(t->matrix, matrix, (size_t)rows * cols);
  for (int r = 0; r < rows; r++) {
    for (int c = 0; c < cols; c++) {
      uint8_t coef = matrix[r * cols + c];
      uint8_t *lo = t->nibbles + ((size_t)r * cols + c) * 32;
      uint8_t *hi = lo + 16;
      for (int i = 0; i < 16; i++) {
        lo[i] = gf_mul(coef, (uint8_t)i);
        hi[i] = gf_mul(coef, (uint8_t)(i << 4));
      }
    }
  }
  return t;
}

void ec_tables_free(void *handle) {
  ec_tables *t = (ec_tables *)handle;
  free(t->nibbles);
  free(t->matrix);
  delete t;
}

#if defined(__SSSE3__)
typedef uint8_t v16 __attribute__((vector_size(16)));

static inline void region_mul_xor(const uint8_t *lo, const uint8_t *hi,
                                  const uint8_t *in, uint8_t *out, size_t len) {
  v16 vlo, vhi;
  memcpy(&vlo, lo, 16);
  memcpy(&vhi, hi, 16);
  const v16 mask = {15, 15, 15, 15, 15, 15, 15, 15,
                    15, 15, 15, 15, 15, 15, 15, 15};
  size_t i = 0;
  for (; i + 16 <= len; i += 16) {
    v16 x;
    memcpy(&x, in + i, 16);
    v16 lo_idx = x & mask;
    v16 hi_idx = (x >> 4) & mask;
    v16 prod = __builtin_shuffle(vlo, lo_idx) ^ __builtin_shuffle(vhi, hi_idx);
    v16 acc;
    memcpy(&acc, out + i, 16);
    acc ^= prod;
    memcpy(out + i, &acc, 16);
  }
  for (; i < len; i++)
    out[i] ^= lo[in[i] & 15] ^ hi[in[i] >> 4];
}
#else
static inline void region_mul_xor(const uint8_t *lo, const uint8_t *hi,
                                  const uint8_t *in, uint8_t *out, size_t len) {
  for (size_t i = 0; i < len; i++)
    out[i] ^= lo[in[i] & 15] ^ hi[in[i] >> 4];
}
#endif

// out[r] = sum_c matrix[r][c] * in[c]  over GF(2^8), region-wise
// (the ec_encode_data shape: serves encode AND decode).
void ec_tables_apply(void *handle, const uint8_t *const *in,
                     uint8_t *const *out, size_t len) {
  ec_tables *t = (ec_tables *)handle;
  for (int r = 0; r < t->rows; r++) {
    memset(out[r], 0, len);
    for (int c = 0; c < t->cols; c++) {
      uint8_t coef = t->matrix[r * t->cols + c];
      if (coef == 0) continue;
      const uint8_t *nib = t->nibbles + ((size_t)r * t->cols + c) * 32;
      if (coef == 1) {
        // XOR fast path (region_xor, isa/xor_op.cc)
        const uint8_t *src = in[c];
        uint8_t *dst = out[r];
        size_t i = 0;
        for (; i + 8 <= len; i += 8) {
          uint64_t a, b;
          memcpy(&a, dst + i, 8);
          memcpy(&b, src + i, 8);
          a ^= b;
          memcpy(dst + i, &a, 8);
        }
        for (; i < len; i++) dst[i] ^= src[i];
      } else {
        region_mul_xor(nib, nib + 16, in[c], out[r], len);
      }
    }
  }
}

// ---- matrix inversion (isa-l gf_invert_matrix twin) ------------------------

int ec_gf_invert_matrix(const uint8_t *in, uint8_t *out, int n) {
  build_gf_tables();
  // Gauss-Jordan over GF(2^8) on [A | I]
  uint8_t *a = (uint8_t *)malloc((size_t)n * n);
  memcpy(a, in, (size_t)n * n);
  for (int i = 0; i < n; i++)
    for (int j = 0; j < n; j++) out[i * n + j] = (i == j);
  for (int col = 0; col < n; col++) {
    int pivot = -1;
    for (int r = col; r < n; r++)
      if (a[r * n + col]) { pivot = r; break; }
    if (pivot < 0) { free(a); return -1; }  // singular
    if (pivot != col) {
      for (int j = 0; j < n; j++) {
        uint8_t tmp = a[col * n + j];
        a[col * n + j] = a[pivot * n + j];
        a[pivot * n + j] = tmp;
        tmp = out[col * n + j];
        out[col * n + j] = out[pivot * n + j];
        out[pivot * n + j] = tmp;
      }
    }
    // normalize the pivot row: multiply by inverse of pivot
    uint8_t piv = a[col * n + col];
    uint8_t inv = 1;
    for (int x = 1; x < 256; x++)
      if (gf_mul(piv, (uint8_t)x) == 1) { inv = (uint8_t)x; break; }
    for (int j = 0; j < n; j++) {
      a[col * n + j] = gf_mul(a[col * n + j], inv);
      out[col * n + j] = gf_mul(out[col * n + j], inv);
    }
    for (int r = 0; r < n; r++) {
      if (r == col) continue;
      uint8_t f = a[r * n + col];
      if (!f) continue;
      for (int j = 0; j < n; j++) {
        a[r * n + j] ^= gf_mul(f, a[col * n + j]);
        out[r * n + j] ^= gf_mul(f, out[col * n + j]);
      }
    }
  }
  free(a);
  return 0;
}

// ---- plain region xor (m==1 encode fast path) ------------------------------

void ec_region_xor(const uint8_t *const *in, int n, uint8_t *out, size_t len) {
  memset(out, 0, len);
  for (int c = 0; c < n; c++) {
    const uint8_t *src = in[c];
    size_t i = 0;
    for (; i + 8 <= len; i += 8) {
      uint64_t a, b;
      memcpy(&a, out + i, 8);
      memcpy(&b, src + i, 8);
      a ^= b;
      memcpy(out + i, &a, 8);
    }
    for (; i < len; i++) out[i] ^= src[i];
  }
}

}  // extern "C"
