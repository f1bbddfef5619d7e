"""GF(2^8) math core: tables, coding matrices, bitsliced GF(2) expansion.

Pure numpy copies of `ceph_tpu/gf/`; the names below are the ones the
port's codec path and its oracles use.
"""

from .tables import GF_MUL_TABLE, GF_POLY, gf_inv, gf_matmul
from .matrix import (
    gf_invert_matrix,
    isa_cauchy_matrix,
    isa_decode_matrix,
    isa_rs_vandermonde_matrix,
)
from .bitslice import expand_matrix, xor_matmul_host_batch

__all__ = [
    "GF_MUL_TABLE", "GF_POLY", "gf_inv", "gf_matmul", "gf_invert_matrix",
    "isa_cauchy_matrix", "isa_decode_matrix", "isa_rs_vandermonde_matrix",
    "expand_matrix", "xor_matmul_host_batch",
]
