"""`tpu` Reed-Solomon codec — ISA-L-compatible techniques on the card.

The port of `ceph_tpu/codec/rs.py`, the re-design of Ceph's `isa` plugin
(src/erasure-code/isa/ErasureCodeIsa.{h,cc}).  Same math contract —
techniques `reed_sol_van` (Vandermonde, default) and `cauchy`
(gf_gen_cauchy1), defaults k=7/m=3, Vandermonde MDS safety envelope
(ErasureCodeIsa.cc:331-361), XOR paths for m==1 and single erasures
(:125-131, :196-216), decode plans in an LRU keyed by the same
"+survivor...-erasure..." signature strings (:227-303) — with the hot loop
in the hand CUDA kernel (ops/swar_gf.py); the shared machinery lives in
MatrixCodecMixin.

Chunks are byte-identical to the JAX package's and to ISA-L's: the
distribution matrices are the same, m==1 encodes as the same pure XOR, and
decode inverts the same survivor submatrix.
"""

from __future__ import annotations

import numpy as np
import torch

from ..common.errs import EINVAL
from ..gf import isa_cauchy_matrix, isa_rs_vandermonde_matrix
from .base import ErasureCode
from .interface import EcError, Profile
from .matrix_codec import MatrixCodecMixin, load_kernels

VANDERMONDE = "reed_sol_van"
CAUCHY = "cauchy"


class ErasureCodeTpuRs(MatrixCodecMixin, ErasureCode):
    """RS(k, m) over GF(2^8), ISA-L-compatible, on an explicit device."""

    DEFAULT_K = "7"  # ErasureCodeIsa.cc:46
    DEFAULT_M = "3"  # ErasureCodeIsa.cc:47

    def __init__(
        self,
        technique: str = VANDERMONDE,
        *,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(device)
        if technique not in (VANDERMONDE, CAUCHY):
            raise EcError(EINVAL, f"unknown technique {technique}")
        self.technique = technique
        self.k = 0
        self.m = 0
        self._given_matrix: np.ndarray | None = None

    @classmethod
    def from_distribution_matrix(
        cls,
        mat: np.ndarray,
        k: int,
        m: int,
        *,
        device: str | torch.device | None = None,
    ) -> "ErasureCodeTpuRs":
        """A codec that codes with a given (k+m, k) uint8 distribution
        matrix, such as `ceph_tpu`'s `distribution_matrix()`: the state a
        store carries from the JAX package to the port (stored chunks are
        plain uint8 in both).  The matrix must be systematic; the
        Vandermonde envelope is not applied, since the matrix is given."""
        ec = cls(device=device)
        ec._given_matrix = np.array(mat, dtype=np.uint8)
        ec.init({"k": str(k), "m": str(m)})
        return ec

    # -- init ---------------------------------------------------------------

    def parse(self, profile: Profile) -> None:
        super().parse(profile)
        self.invalidate_matrix()
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.sanity_check_k_m(self.k, self.m)
        if self.technique == VANDERMONDE and self._given_matrix is None:
            # MDS safety envelope, ErasureCodeIsa.cc:331-361.
            if self.k > 32:
                raise EcError(EINVAL, f"Vandermonde: k={self.k} must be <= 32")
            if self.m > 4:
                raise EcError(EINVAL, f"Vandermonde: m={self.m} must be <= 4 for MDS")
            if self.m == 4 and self.k > 21:
                raise EcError(EINVAL, f"Vandermonde: k={self.k} must be <= 21 with m=4")

    def init(self, profile: Profile) -> None:
        self.parse(profile)
        # Build the encode matrix now (reference `prepare()`, ErasureCodeIsa.cc:369).
        self.distribution_matrix()
        load_kernels(self.device)
        self._profile = dict(profile)

    # -- geometry / matrix --------------------------------------------------

    def build_matrix(self) -> np.ndarray:
        if self._given_matrix is not None:
            return self._given_matrix
        if self.technique == VANDERMONDE:
            coeff = isa_rs_vandermonde_matrix(self.k, self.m)
        else:
            coeff = isa_cauchy_matrix(self.k, self.m)
        if self.m == 1:
            # The reference encodes m==1 as a pure region XOR regardless of
            # technique (ErasureCodeIsa.cc:125-127), so the parity actually
            # stored is the all-ones row; the distribution matrix must say so
            # or decode-by-inversion would disagree with the stored parity.
            coeff[self.k :] = 1
        return coeff

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k
