"""GF(2) bit-matrix machinery for the packetized RAID-6 code family.

The port's own copy of `ceph_tpu/gf/gf2.py` (pure numpy).  The jerasure
liberation / blaum_roth / liber8tion techniques (Ceph's
src/erasure-code/jerasure/ErasureCodeJerasure.h:169-253) are pure GF(2)
bit-matrix codes: each chunk is w packets, and coding rows XOR whole
packets selected by a (m*w, k*w) 0/1 matrix.  Their generator functions
live in the jerasure submodule (liberation.c), which the JAX package does
not vendor, so its constructions are re-derived from the published code
definitions; these are byte-identical copies of them.

Conventions: column-vector, LSB/packet-0 first.  Block X_j (w x w) is data
drive j's contribution to the Q (second coding) drive; the P drive is
always the XOR of all data drives (identity blocks).
"""

from __future__ import annotations

import numpy as np


def gf2_inv(mat: np.ndarray) -> np.ndarray | None:
    """Invert a square 0/1 matrix over GF(2); None if singular.

    Bit-packed Gauss-Jordan: rows are Python ints (arbitrary width), so a
    row XOR is one integer op.
    """
    mat = np.asarray(mat, dtype=np.uint8) & 1
    n = mat.shape[0]
    if mat.shape != (n, n):
        raise ValueError(f"not square: {mat.shape}")
    # row i packed as int: bits 0..n-1 = mat row, bits n..2n-1 = identity
    rows = [
        int.from_bytes(np.packbits(mat[i], bitorder="little").tobytes(), "little")
        | (1 << (n + i))
        for i in range(n)
    ]
    for col in range(n):
        pivot = next(
            (r for r in range(col, n) if rows[r] & (1 << col)), None
        )
        if pivot is None:
            return None
        rows[col], rows[pivot] = rows[pivot], rows[col]
        for r in range(n):
            if r != col and rows[r] & (1 << col):
                rows[r] ^= rows[col]
    out = np.zeros((n, n), dtype=np.uint8)
    for i in range(n):
        inv_bits = rows[i] >> n
        for j in range(n):
            out[i, j] = (inv_bits >> j) & 1
    return out


def gf2_matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return (a.astype(np.int64) @ b.astype(np.int64) % 2).astype(np.uint8)


def is_prime(n: int) -> bool:
    if n < 2:
        return False
    return all(n % d for d in range(2, int(n**0.5) + 1))


def _raid6_bitmatrix(x_blocks: list[np.ndarray], w: int) -> np.ndarray:
    """Assemble [I I ... I; X_0 X_1 ... X_{k-1}] — a (2w, kw) coding matrix."""
    k = len(x_blocks)
    bm = np.zeros((2 * w, k * w), dtype=np.uint8)
    eye = np.eye(w, dtype=np.uint8)
    for j, X in enumerate(x_blocks):
        bm[:w, j * w : (j + 1) * w] = eye
        bm[w:, j * w : (j + 1) * w] = X
    return bm


def liberation_bitmatrix(k: int, w: int) -> np.ndarray:
    """Liberation code Q blocks (Plank's liberation_coding_bitmatrix,
    jerasure lib; ErasureCodeJerasure.cc:450-454 call site): w prime > 2,
    k <= w.  X_j is the cyclic shift-by-j permutation, plus for j > 0 one
    extra bit at row (j*(w-1)/2) mod w — the minimum-density construction
    from the Liberation-codes paper."""
    if not is_prime(w) or w <= 2:
        raise ValueError(f"liberation requires prime w > 2, got {w}")
    if k > w:
        raise ValueError(f"liberation requires k <= w, got k={k} w={w}")
    blocks = []
    for j in range(k):
        X = np.zeros((w, w), dtype=np.uint8)
        for i in range(w):
            X[i, (j + i) % w] = 1
        if j > 0:
            i = (j * ((w - 1) // 2)) % w
            X[i, (i + j - 1) % w] = 1
        blocks.append(X)
    return _raid6_bitmatrix(blocks, w)


def blaum_roth_bitmatrix(k: int, w: int) -> np.ndarray:
    """Blaum-Roth code: w + 1 prime (w == 7 tolerated for legacy profiles,
    ErasureCodeJerasure.cc:459-472).  Arithmetic in the polynomial ring
    GF(2)[x] / M_p(x), M_p = 1 + x + ... + x^{p-1}, p = w + 1; data drive
    j's Q block is multiplication by x^j, i.e. T^j where T is the
    mult-by-x matrix (x^w folds to 1 + x + ... + x^{w-1})."""
    p = w + 1
    if w != 7 and (w <= 2 or not is_prime(p)):
        raise ValueError(f"blaum_roth requires w+1 prime, got w={w}")
    if k > w:
        raise ValueError(f"blaum_roth requires k <= w, got k={k} w={w}")
    T = np.zeros((w, w), dtype=np.uint8)
    for c in range(w - 1):
        T[c + 1, c] = 1
    T[:, w - 1] = 1
    blocks = []
    X = np.eye(w, dtype=np.uint8)
    for _ in range(k):
        blocks.append(X)
        X = gf2_matmul(T, X)
    return _raid6_bitmatrix(blocks, w)


def liber8tion_bitmatrix(k: int) -> np.ndarray:
    """w = 8, m = 2, k <= 8 RAID-6 bit-matrix (the liber8tion envelope,
    ErasureCodeJerasure.cc:511-514).

    The published minimum-density matrices are in the jerasure submodule
    (liberation.c liber8tion_coding_bitmatrix), which the JAX package does
    not vendor, so byte-parity with upstream is unverifiable; this
    re-design fills the same (k, 2, w=8) envelope with GF(2^8)
    multiplication bit-matrices X_j = M(g^j) — distinct field elements, so
    every X_i and X_i ^ X_j = M(g^i + g^j) is invertible and the RAID-6
    MDS guarantee holds identically (denser matrix, same contract)."""
    w = 8
    if k > w:
        raise ValueError(f"liber8tion requires k <= 8, got k={k}")
    from .bitslice import coeff_bitmatrix
    from .tables import gf_pow

    blocks = [coeff_bitmatrix(gf_pow(2, j)) for j in range(k)]
    return _raid6_bitmatrix(blocks, w)
