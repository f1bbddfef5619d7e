"""Coding-matrix construction and inversion over GF(2^8).

A copy of `ceph_tpu/gf/matrix.py`, kept in the port so that it imports
nothing of the JAX package.  Host-side (numpy) mirrors of the matrix
conventions Ceph's plugins use, so the codec's chunks are byte-identical to
theirs:

- ISA-L family (Ceph src/erasure-code/isa/ErasureCodeIsa.cc:
  :385 `gf_gen_rs_matrix`, :387 `gf_gen_cauchy1_matrix`, :275 `gf_invert_matrix`,
  decode-matrix assembly :255-297).
- jerasure family (Ceph src/erasure-code/jerasure/
  ErasureCodeJerasure.h:81-253 techniques; matrices re-derived from the published
  jerasure 2.x algorithms).

All matrices are systematic: the full (k+m, k) "distribution" matrix has the
identity on top; `coding_rows` views just the (m, k) parity part that the device
kernels consume.
"""

from __future__ import annotations

import numpy as np

from .tables import GF_INV_TABLE, GF_MUL_TABLE, gf_inv, gf_matmul, gf_pow


def identity(k: int) -> np.ndarray:
    return np.eye(k, dtype=np.uint8)


# ---------------------------------------------------------------------------
# ISA-L conventions
# ---------------------------------------------------------------------------

def isa_rs_vandermonde_matrix(k: int, m: int) -> np.ndarray:
    """ISA-L `gf_gen_rs_matrix(a, k+m, k)` — (k+m, k) systematic matrix.

    Parity row i (0-based within the parity block) is the geometric progression
    of g = 2^i: [1, g, g^2, ..., g^(k-1)].  Row 0 is therefore all-ones, which
    is what enables the reference's XOR fast paths (ErasureCodeIsa.cc:125-131,
    :206-216).  NOT guaranteed MDS for large (k, m) — hence the reference's
    safety caps (ErasureCodeIsa.cc:331-361), enforced by the codec layer.
    """
    a = np.zeros((k + m, k), dtype=np.uint8)
    a[:k] = identity(k)
    gen = 1
    for i in range(m):
        p = 1
        for j in range(k):
            a[k + i, j] = p
            p = GF_MUL_TABLE[p, gen]
        gen = GF_MUL_TABLE[gen, 2]
    return a


def isa_cauchy_matrix(k: int, m: int) -> np.ndarray:
    """ISA-L `gf_gen_cauchy1_matrix(a, k+m, k)` — (k+m, k) systematic matrix.

    Parity entry for absolute row i in [k, k+m) and column j is 1/(i ^ j).
    Always MDS (a true Cauchy matrix: rows indexed by {k..k+m-1}, columns by
    {0..k-1}, disjoint sets).
    """
    a = np.zeros((k + m, k), dtype=np.uint8)
    a[:k] = identity(k)
    for i in range(k, k + m):
        for j in range(k):
            a[i, j] = GF_INV_TABLE[i ^ j]
    return a


def gf_invert_matrix(mat: np.ndarray) -> np.ndarray | None:
    """Invert a square GF(2^8) matrix by Gauss-Jordan elimination.

    Returns None when singular — the analog of ISA-L `gf_invert_matrix`
    returning -1, which the reference surfaces as a decode failure
    (ErasureCodeIsa.cc:275-278).  The inverse of a matrix over a field is
    unique, so byte-parity with ISA-L does not depend on pivoting order.
    """
    n = mat.shape[0]
    assert mat.shape == (n, n)
    work = mat.astype(np.uint8).copy()
    out = identity(n)
    for i in range(n):
        if work[i, i] == 0:
            pivots = np.nonzero(work[i + 1:, i])[0]
            if pivots.size == 0:
                return None
            j = i + 1 + int(pivots[0])
            work[[i, j]] = work[[j, i]]
            out[[i, j]] = out[[j, i]]
        inv_piv = gf_inv(int(work[i, i]))
        work[i] = GF_MUL_TABLE[work[i], inv_piv]
        out[i] = GF_MUL_TABLE[out[i], inv_piv]
        # Eliminate column i from every other row.
        factors = work[:, i].copy()
        factors[i] = 0
        out ^= GF_MUL_TABLE[factors[:, None], out[i][None, :]]
        work ^= GF_MUL_TABLE[factors[:, None], work[i][None, :]]
    return out


def isa_decode_matrix(
    encode_coeff: np.ndarray, erasures: list[int], k: int
) -> tuple[np.ndarray, list[int]] | None:
    """Build the (nerrs, k) decode matrix exactly as the reference does.

    Mirrors ErasureCodeIsa.cc:233-297: pick the first k surviving rows
    (`decode_index`), invert that square submatrix of the distribution matrix,
    then each erased data row e takes row e of the inverse, and each erased
    parity row e takes encode_coeff[e] @ inverse.

    Returns (decode_matrix, decode_index) or None when the survivor submatrix
    is singular (possible for non-MDS Vandermonde corners).
    """
    km = encode_coeff.shape[0]
    erased = set(erasures)
    decode_index: list[int] = []
    r = 0
    for _ in range(k):
        while r in erased:
            r += 1
        if r >= km:
            return None
        decode_index.append(r)
        r += 1
    b = encode_coeff[decode_index, :]  # (k, k) survivor rows
    d = gf_invert_matrix(b)
    if d is None:
        return None
    nerrs = len(erasures)
    c = np.zeros((nerrs, k), dtype=np.uint8)
    for p, e in enumerate(erasures):
        if e < k:
            c[p] = d[e]
        else:
            # parity row e regenerated from survivors: coeff_e @ B^-1
            c[p] = gf_matmul(encode_coeff[e][None, :], d)[0]
    return c, decode_index


# ---------------------------------------------------------------------------
# jerasure conventions
# ---------------------------------------------------------------------------

def _extended_vandermonde(rows: int, cols: int) -> np.ndarray:
    """jerasure `reed_sol_extended_vandermonde_matrix(rows, cols, 8)`.

    Row 0 = e_0, last row = e_{cols-1}, middle rows i = [1, i, i^2, ...].
    """
    v = np.zeros((rows, cols), dtype=np.uint8)
    v[0, 0] = 1
    v[rows - 1, cols - 1] = 1
    for i in range(1, rows - 1):
        p = 1
        for j in range(cols):
            v[i, j] = p
            p = GF_MUL_TABLE[p, i]
    return v


def jerasure_vandermonde_matrix(k: int, m: int) -> np.ndarray:
    """jerasure `reed_sol_vandermonde_coding_matrix(k, m, 8)` + identity top.

    Re-derivation of `reed_sol_big_vandermonde_distribution_matrix`: start from
    the extended Vandermonde (k+m, k) matrix, apply **column** operations to
    make the top k x k block the identity (column ops preserve MDS-ness), then
    scale columns so row k is all ones, restoring the identity by scaling the
    corresponding data rows.  This yields a true MDS systematic matrix whose
    first parity row is all ones (the property the reference's RAID-6 and
    single-parity XOR paths rely on).
    """
    rows, cols = k + m, k
    dist = _extended_vandermonde(rows, cols)
    # Column-reduce the top block to the identity.
    for i in range(1, cols):
        # Ensure pivot dist[i, i] is nonzero by swapping *rows* below if needed
        # (rows >= i never touch the already-fixed identity rows above).
        if dist[i, i] == 0:
            nz = np.nonzero(dist[i + 1:, i])[0]
            assert nz.size, "extended Vandermonde cannot be systematized"
            j = i + 1 + int(nz[0])
            dist[[i, j]] = dist[[j, i]]
        if dist[i, i] != 1:
            inv = gf_inv(int(dist[i, i]))
            dist[:, i] = GF_MUL_TABLE[dist[:, i], inv]
        row = dist[i].copy()
        for j in range(cols):
            if j != i and row[j] != 0:
                dist[:, j] ^= GF_MUL_TABLE[row[j], dist[:, i]]
    # Make row k (first parity row) all ones: scale column j by 1/dist[k, j],
    # then restore the identity block by scaling data row j back.
    for j in range(cols):
        t = int(dist[k, j])
        assert t != 0, "MDS violation: zero in first parity row"
        if t != 1:
            inv = gf_inv(t)
            dist[:, j] = GF_MUL_TABLE[dist[:, j], inv]
            dist[j, :] = GF_MUL_TABLE[dist[j, :], t]
    return dist


def jerasure_r6_matrix(k: int) -> np.ndarray:
    """jerasure `reed_sol_r6_coding_matrix(k, 8)` (m == 2, RAID-6).

    Parity row 0 all ones (P), row 1 = powers of 2 (Q).
    """
    a = np.zeros((k + 2, k), dtype=np.uint8)
    a[:k] = identity(k)
    a[k, :] = 1
    p = 1
    for j in range(k):
        a[k + 1, j] = p
        p = GF_MUL_TABLE[p, 2]
    return a


def jerasure_cauchy_orig_matrix(k: int, m: int) -> np.ndarray:
    """jerasure `cauchy_original_coding_matrix(k, m, 8)` + identity top.

    coeff[i][j] = 1 / (i ^ (m + j)) for parity row i in [0, m).
    """
    assert k + m <= 256
    a = np.zeros((k + m, k), dtype=np.uint8)
    a[:k] = identity(k)
    for i in range(m):
        for j in range(k):
            a[k + i, j] = GF_INV_TABLE[i ^ (m + j)]
    return a


_BITCOUNT_TABLE: np.ndarray | None = None


def _bitcount_gf(x: int) -> int:
    """Number of ones in the 8x8 GF(2) bit-matrix of multiply-by-x.

    jerasure's `cauchy_n_ones` equivalent, used by cauchy_good to pick light
    coefficients; a 256-entry table built once from the companion expansion.
    """
    global _BITCOUNT_TABLE
    if _BITCOUNT_TABLE is None:
        from .bitslice import coeff_bitmatrix

        _BITCOUNT_TABLE = np.array(
            [coeff_bitmatrix(c).sum() for c in range(256)], dtype=np.int32
        )
    return int(_BITCOUNT_TABLE[x])


def jerasure_cauchy_good_matrix(k: int, m: int) -> np.ndarray:
    """jerasure `cauchy_good_general_coding_matrix(k, m, 8)` + identity top.

    cauchy_orig improved (jerasure `cauchy_improve_coding_matrix` semantics):
    divide each column j by its row-0 entry so parity row 0 is all ones, then
    for each later parity row, try scaling the whole row by the inverse of each
    of its elements and keep the scaling that minimizes the total number of
    ones in the row's GF(2) bit-matrices (ties keep the earlier candidate).
    """
    a = jerasure_cauchy_orig_matrix(k, m)
    coding = a[k:]
    # Column normalization: make parity row 0 all ones.
    for j in range(k):
        t = int(coding[0, j])
        if t != 1:
            coding[:, j] = GF_MUL_TABLE[coding[:, j], gf_inv(t)]
    # Row lightening for rows 1..m-1.
    for i in range(1, m):
        best = coding[i].copy()
        best_ones = sum(_bitcount_gf(int(x)) for x in best)
        for j in range(k):
            cand = GF_MUL_TABLE[coding[i], gf_inv(int(coding[i, j]))]
            ones = sum(_bitcount_gf(int(x)) for x in cand)
            if ones < best_ones:
                best, best_ones = cand, ones
        coding[i] = best
    a[k:] = coding
    return a


def vandermonde_mds_check(k: int, m: int, matrix: np.ndarray) -> bool:
    """Exhaustively verify every m-erasure pattern is decodable.

    The reference caps ISA Vandermonde at (k<=21, m=4)/(k<=32, m<=3)
    (ErasureCodeIsa.cc:331-361); this is the direct check used by tests to
    validate those envelopes for our matrices.
    """
    import itertools

    km = k + m
    for erasures in itertools.combinations(range(km), m):
        res = isa_decode_matrix(matrix, list(erasures), k)
        if res is None:
            return False
    return True
