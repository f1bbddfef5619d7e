"""GF(2^8) arithmetic core — log/exp/mul tables over the polynomial 0x11d.

A copy of `ceph_tpu/gf/tables.py`, kept in the port so that it imports
nothing of the JAX package.  It mirrors the field conventions of Intel
ISA-L's `ec_base` (the math underneath Ceph's `isa` erasure-code plugin,
src/erasure-code/isa/ErasureCodeIsa.cc:129 `ec_encode_data`, :291 `gf_mul`):
GF(2^8) generated by the primitive polynomial x^8 + x^4 + x^3 + x^2 + 1
(0x11d) with alpha = 2 as the primitive element.  jerasure/gf-complete use the
same default polynomial for w=8, so one field core serves both plugin-compat
families.

Everything here is host-side numpy: table construction happens once at import and
is cheap.  Device-side GF math never touches these tables — it goes through the
bitsliced GF(2) expansion (gf/bitslice.py), so the card only ever does XORs.
"""

from __future__ import annotations

import numpy as np

# Primitive polynomial for GF(2^8): x^8 + x^4 + x^3 + x^2 + 1.
GF_POLY = 0x11D
GF_ORDER = 256


def _build_log_exp() -> tuple[np.ndarray, np.ndarray]:
    """Build log/antilog tables by repeated multiplication by alpha=2."""
    gflog = np.zeros(GF_ORDER, dtype=np.int32)
    gfexp = np.zeros(2 * (GF_ORDER - 1), dtype=np.uint8)
    x = 1
    for i in range(GF_ORDER - 1):
        gfexp[i] = x
        gfexp[i + GF_ORDER - 1] = x  # doubled so exp[log a + log b] needs no mod
        gflog[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    gflog[0] = -1  # log(0) is undefined; sentinel
    return gflog, gfexp


GF_LOG, GF_EXP = _build_log_exp()


def _build_mul_table() -> np.ndarray:
    """Dense 256x256 multiplication table for vectorized host math."""
    a = np.arange(GF_ORDER, dtype=np.int32)
    la = GF_LOG[a]
    table = GF_EXP[(la[:, None] + la[None, :]) % (GF_ORDER - 1)].astype(np.uint8)
    table[0, :] = 0
    table[:, 0] = 0
    return table


GF_MUL_TABLE = _build_mul_table()

# Inverse table: inv[a] * a == 1 for a != 0; inv[0] = 0 (sentinel, never used).
GF_INV_TABLE = np.zeros(GF_ORDER, dtype=np.uint8)
GF_INV_TABLE[1:] = GF_EXP[(GF_ORDER - 1 - GF_LOG[np.arange(1, GF_ORDER)]) % (GF_ORDER - 1)]


def gf_mul(a: int, b: int) -> int:
    """Scalar GF(2^8) multiply (ISA-L `gf_mul` semantics)."""
    return int(GF_MUL_TABLE[a & 0xFF, b & 0xFF])


def gf_inv(a: int) -> int:
    """Scalar GF(2^8) inverse (ISA-L `gf_inv` semantics). a must be nonzero."""
    if a == 0:
        raise ZeroDivisionError("gf_inv(0)")
    return int(GF_INV_TABLE[a & 0xFF])


def gf_pow(a: int, n: int) -> int:
    """a**n in GF(2^8)."""
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(int(GF_LOG[a]) * n) % (GF_ORDER - 1)])


def gf_mul_slow(a: int, b: int) -> int:
    """First-principles carry-less multiply mod GF_POLY.

    Used only by tests to validate the tables against the definition of the
    field — never on any hot path.
    """
    r = 0
    a &= 0xFF
    b &= 0xFF
    while b:
        if b & 1:
            r ^= a
        b >>= 1
        a <<= 1
        if a & 0x100:
            a ^= GF_POLY
    return r


def gf_mul_vec(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Elementwise GF(2^8) multiply of uint8 arrays (broadcasting)."""
    return GF_MUL_TABLE[np.asarray(a, dtype=np.uint8), np.asarray(b, dtype=np.uint8)]


def gf_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix product of uint8 matrices a @ b.

    Accumulation is XOR; products come from the dense mul table.  Shapes follow
    numpy matmul rules for 2-D inputs.
    """
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    assert a.ndim == 2 and b.ndim == 2 and a.shape[1] == b.shape[0]
    # products[i, l, j] = a[i, l] * b[l, j]; XOR-reduce over l.
    products = GF_MUL_TABLE[a[:, :, None], b[None, :, :]]
    return np.bitwise_xor.reduce(products, axis=1)


def gf_matvec(a: np.ndarray, x: np.ndarray) -> np.ndarray:
    """GF(2^8) matrix @ vector-of-byte-rows: (m,k) @ (k,L) -> (m,L)."""
    return gf_matmul(a, x)
