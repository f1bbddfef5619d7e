"""Bitsliced GF(2^8) — expand GF coding matrices into GF(2) bit-matrices.

A copy of `ceph_tpu/gf/bitslice.py`, kept in the port so that it imports
nothing of the JAX package.  Multiplying a byte by a constant c in GF(2^8) is
a *linear map over GF(2)* on the byte's 8 bits.  So an (m, k) GF coding
matrix expands into an (8m, 8k) 0/1 matrix B, and encoding becomes

    parity_bits = (B @ data_bits) mod 2

i.e. an integer matmul followed by a parity reduction, or equally an XOR
schedule over bit-planes (ops/swar_gf.py).  It is the same linearization
jerasure's "bitmatrix" techniques use on CPU (Ceph
src/erasure-code/jerasure/ErasureCodeJerasure.h:120-167).

Bit conventions: bit b of a byte is (x >> b) & 1 (LSB-first).  Column j of the
8x8 block for coefficient c holds the bits of c * 2^j, because multiplying the
basis byte 2^j by c yields that column's contribution.
"""

from __future__ import annotations

import numpy as np

from .tables import GF_MUL_TABLE


def coeff_bitmatrix(c: int) -> np.ndarray:
    """(8, 8) 0/1 matrix M_c with M_c[i, j] = bit i of (c * 2^j in GF(2^8)).

    Satisfies: bits(c * x) = M_c @ bits(x) mod 2 for every byte x.
    """
    cols = GF_MUL_TABLE[c, (1 << np.arange(8)).astype(np.uint8)]  # c * 2^j
    return ((cols[None, :] >> np.arange(8)[:, None]) & 1).astype(np.uint8)


def expand_matrix(gf_matrix: np.ndarray) -> np.ndarray:
    """Expand an (m, k) GF(2^8) matrix into its (8m, 8k) GF(2) bit-matrix."""
    gf_matrix = np.asarray(gf_matrix, dtype=np.uint8)
    m, k = gf_matrix.shape
    out = np.zeros((8 * m, 8 * k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            c = int(gf_matrix[i, j])
            if c:
                out[8 * i:8 * i + 8, 8 * j:8 * j + 8] = coeff_bitmatrix(c)
    return out


def bitslice_bytes(data: np.ndarray) -> np.ndarray:
    """Host reference: (k, L) uint8 -> (8k, L) 0/1 bit-planes (LSB-first)."""
    data = np.asarray(data, dtype=np.uint8)
    k, L = data.shape
    planes = (data[:, None, :] >> np.arange(8, dtype=np.uint8)[None, :, None]) & 1
    return planes.reshape(8 * k, L)


def unbitslice_bytes(planes: np.ndarray) -> np.ndarray:
    """Host reference: (8m, L) 0/1 planes -> (m, L) uint8 bytes."""
    planes = np.asarray(planes, dtype=np.uint8)
    m8, L = planes.shape
    assert m8 % 8 == 0
    p = planes.reshape(m8 // 8, 8, L)
    weights = (1 << np.arange(8, dtype=np.uint16))[None, :, None]
    return (p.astype(np.uint16) * weights).sum(axis=1).astype(np.uint8)


def xor_matmul_host(bit_matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Host reference of the device kernel: GF coding via bitsliced XOR-matmul.

    bit_matrix: (8m, 8k) 0/1; data: (k, L) uint8 -> (m, L) uint8.
    Used by tests as the oracle for the jnp/Pallas implementations.
    """
    planes = bitslice_bytes(data)
    out_planes = (bit_matrix.astype(np.int32) @ planes.astype(np.int32)) & 1
    return unbitslice_bytes(out_planes.astype(np.uint8))


# Host-oracle working-set bound: the int32 plane expansion below costs
# ~40x its input slice, so stripe batches process in slices of at most
# this many input bytes (~8 MiB slice -> ~320 MiB transient), keeping
# an oracle check of a bulk batch within host memory.
_HOST_BATCH_SLICE_BYTES = 8 << 20


def xor_matmul_host_batch(bit_matrix: np.ndarray, data: np.ndarray) -> np.ndarray:
    """Batched host oracle: (..., k, L) uint8 -> (..., m, L) uint8.

    Pure numpy end to end: the oracle the tests and chip_smoke.py hold
    the device paths against.  Bit-for-bit
    identical to xor_matmul_host applied per stripe: same LSB-first
    plane layout, same GF(2) matmul-and-mask reduction.
    """
    data = np.asarray(data, dtype=np.uint8)
    lead = data.shape[:-2]
    k, L = data.shape[-2:]
    flat = data.reshape(-1, k, L)
    m = bit_matrix.shape[0] // 8
    stripes = flat.shape[0]
    per_stripe = max(1, k * L)
    step = max(1, _HOST_BATCH_SLICE_BYTES // per_stripe)
    bm32 = bit_matrix.astype(np.int32)
    weights = (1 << np.arange(8, dtype=np.uint16))[None, None, :, None]
    out = np.empty((stripes, m, L), dtype=np.uint8)
    for s0 in range(0, stripes, step):
        part = flat[s0 : s0 + step]
        # (s, k, 8, L) -> (s, 8k, L): chunk-major, bit-minor like
        # bitslice_bytes
        planes = (
            (part[:, :, None, :]
             >> np.arange(8, dtype=np.uint8)[None, None, :, None])
            & 1
        ).reshape(part.shape[0], 8 * k, L)
        out_planes = (bm32 @ planes.astype(np.int32)) & 1
        p = out_planes.reshape(part.shape[0], m, 8, L).astype(np.uint16)
        out[s0 : s0 + step] = (p * weights).sum(axis=2).astype(np.uint8)
    return out.reshape(*lead, m, L)
