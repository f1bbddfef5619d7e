"""jerasure-compatible codec family on the port's kernels.

The port of `ceph_tpu/codec/jerasure.py` (Ceph's `jerasure` plugin,
src/erasure-code/jerasure/ErasureCodeJerasure.{h,cc}; techniques at
ErasureCodeJerasure.h:81-253), with the same profile surface: k/m/w plus
per-technique knobs.

- The GF(2^8) matrix techniques reduce to a coding matrix (gf/matrix.py
  reproduces the published jerasure constructions) and run on
  `MatrixCodecMixin`'s tiers, as plugin `tpu` does: the SWAR kernel
  (csrc/swar_gf.cu) for chunk lengths that are a multiple of 128, the
  packed plane program (csrc/packed_gf.cu) for other bulk lengths, the
  bitsliced matmul for small ones.
    reed_sol_van     Vandermonde-derived systematic MDS (default k=7, m=3)
    reed_sol_r6_op   RAID-6 optimized (m must be 2): P = XOR row, Q = 2^j
    cauchy_orig      original Cauchy construction
    cauchy_good      cauchy_orig scaled to minimize bit-matrix ones
  w is fixed at 8 (the GF(2^8) core, the reference default); w=16/32
  profiles are rejected with EINVAL.  packetsize is accepted and kept in
  the profile; it does not change these techniques' bytes.
- liberation, blaum_roth and liber8tion are packetized GF(2) BIT-MATRIX
  codes (RAID-6, m = 2): a chunk is S super-packets of w packets of
  `packetsize` bytes, and a coding packet is the XOR of the data packets
  its (2w, kw) matrix row selects.  `ErasureCodeJerasureBitmatrix` runs
  every encode and every decode as one `gf2_plane_matmul` launch over
  (S, k*w, packetsize) planes (csrc/gf2_plane.cu on the card): the packet
  loop of jerasure_schedule_encode becomes the batch axis.  Its matrices
  are gf/gf2.py's, copies of the JAX package's re-derived constructions.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..common.errs import EINVAL, EIO
from ..gf.gf2 import blaum_roth_bitmatrix, liber8tion_bitmatrix, liberation_bitmatrix
from ..gf.matrix import (
    jerasure_cauchy_good_matrix,
    jerasure_cauchy_orig_matrix,
    jerasure_r6_matrix,
    jerasure_vandermonde_matrix,
)
from ..ops import xor_mm
from ..ops.xor_mm import gf2_plane_matmul
from .base import ErasureCode
from .interface import EcError, Profile
from .matrix_codec import PLAN_CACHE, MatrixCodecMixin, load_kernels

TECHNIQUES = ("reed_sol_van", "reed_sol_r6_op", "cauchy_orig", "cauchy_good")
BITMATRIX_TECHNIQUES = ("liberation", "blaum_roth", "liber8tion")


class ErasureCodeJerasure(MatrixCodecMixin, ErasureCode):
    """jerasure techniques as GF(2^8) matrix codecs on an explicit device."""

    DEFAULT_K = "7"   # ErasureCodeJerasure.h reed_sol_van defaults
    DEFAULT_M = "3"
    DEFAULT_W = "8"

    def __init__(
        self, technique: str = "reed_sol_van", *, device: str | torch.device | None = None
    ) -> None:
        super().__init__(device)
        if technique not in TECHNIQUES:
            raise EcError(EINVAL, f"unknown jerasure technique {technique}")
        self.technique = technique
        self.k = 0
        self.m = 0
        self.w = 8

    def parse(self, profile: Profile) -> None:
        super().parse(profile)
        self.invalidate_matrix()
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.w = self.to_int("w", profile, self.DEFAULT_W)
        if self.w != 8:
            raise EcError(EINVAL, f"w={self.w} not supported (GF(2^8) core); use w=8")
        self.sanity_check_k_m(self.k, self.m)
        if self.technique == "reed_sol_r6_op" and self.m != 2:
            # reed_sol_r6 is RAID-6 only (jerasure reed_sol_r6_encode contract).
            raise EcError(EINVAL, f"reed_sol_r6_op requires m=2, got m={self.m}")
        if self.k + self.m > 256:
            # w=8 field bound (jerasure requires k+m <= 2^w).
            raise EcError(EINVAL, f"k+m={self.k + self.m} must be <= 256 with w=8")
        # packetsize accepted for profile compatibility (default 2048,
        # ErasureCodeJerasure.h:141); no effect on these techniques' bytes.
        self.to_int("packetsize", profile, "2048")

    def init(self, profile: Profile) -> None:
        super().init(profile)
        load_kernels(self.device)

    def build_matrix(self) -> np.ndarray:
        if self.technique == "reed_sol_van":
            return jerasure_vandermonde_matrix(self.k, self.m)
        if self.technique == "reed_sol_r6_op":
            return jerasure_r6_matrix(self.k)
        if self.technique == "cauchy_orig":
            return jerasure_cauchy_orig_matrix(self.k, self.m)
        return jerasure_cauchy_good_matrix(self.k, self.m)

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k


class ErasureCodeJerasureBitmatrix(ErasureCode):
    """liberation / blaum_roth / liber8tion — packetized GF(2) bit-matrix
    RAID-6 codes on the plane-granular XOR kernel.

    Chunk layout (jerasure bit-matrix convention): a chunk of S*w*packetsize
    bytes is S super-packets of w packets each; coding row r of
    super-packet s is the XOR of the data packets its matrix row selects.
    Ceph walks the packets in a C loop with a precomputed XOR schedule
    (jerasure_schedule_encode); here all S super-packets for all rows go
    in one gf2_plane_matmul launch, with S the batch axis.
    """

    DEFAULT_PACKETSIZE = "2048"  # ErasureCodeJerasure.h:141

    def __init__(self, technique: str, *, device: str | torch.device | None = None) -> None:
        super().__init__(device)
        if technique not in BITMATRIX_TECHNIQUES:
            raise EcError(EINVAL, f"unknown bitmatrix technique {technique}")
        self.technique = technique
        self.k = 0
        self.m = 0
        self.w = 0
        self.packetsize = 0
        self._bitmatrix: np.ndarray | None = None

    # defaults per Ceph's class declarations (ErasureCodeJerasure.h)
    def _defaults(self) -> tuple[str, str, str]:
        if self.technique == "liber8tion":
            return "2", "2", "8"
        return "2", "2", "7"

    def parse(self, profile: Profile) -> None:
        super().parse(profile)
        dk, dm, dw = self._defaults()
        self.k = self.to_int("k", profile, dk)
        self.m = self.to_int("m", profile, dm)
        self.w = self.to_int("w", profile, dw)
        self.packetsize = self.to_int("packetsize", profile, self.DEFAULT_PACKETSIZE)
        self.sanity_check_k_m(self.k, self.m)
        if self.m != 2:
            raise EcError(
                EINVAL, f"{self.technique} is RAID-6 only: m must be 2, got {self.m}"
            )
        if self.k > self.w:
            raise EcError(
                EINVAL, f"k={self.k} must be <= w={self.w} ({self.technique})"
            )
        if self.packetsize <= 0 or self.packetsize % 4:
            # check_packetsize: multiple of sizeof(int)
            raise EcError(
                EINVAL, f"packetsize={self.packetsize} must be a positive multiple of 4"
            )
        try:
            if self.technique == "liberation":
                self._bitmatrix = liberation_bitmatrix(self.k, self.w)
            elif self.technique == "blaum_roth":
                self._bitmatrix = blaum_roth_bitmatrix(self.k, self.w)
            else:
                if self.w != 8:
                    raise ValueError(f"liber8tion requires w=8, got w={self.w}")
                self._bitmatrix = liber8tion_bitmatrix(self.k)
                # The published minimum-density liber8tion matrices live in
                # the jerasure submodule, which the JAX package does not
                # vendor; it fills the same (k, m=2, w=8) envelope with a
                # re-derived MDS bit-matrix, and so does the port.  Same
                # fault tolerance, different parity bytes — so chunks
                # written by upstream jerasure under this profile name are
                # NOT byte-interchangeable.  Say so where profile users see it.
                from ..common.log import dout

                dout(
                    "codec",
                    1,
                    "jerasure technique=liber8tion uses a re-derived MDS "
                    "bit-matrix (published minimum-density matrices not "
                    "vendored); parity bytes are not interchangeable with "
                    "upstream jerasure liber8tion chunks",
                )
        except ValueError as e:
            raise EcError(EINVAL, str(e))

    def init(self, profile: Profile) -> None:
        super().init(profile)
        if self.device.type == "cuda":
            xor_mm.build_library()

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    def get_alignment(self) -> int:
        # chunks must be whole super-packets; keep the 128-byte alignment too
        return math.lcm(self.w * self.packetsize, self.ALIGNMENT)

    # -- coding ------------------------------------------------------------

    def _planes(self, arrays: list[np.ndarray]) -> torch.Tensor:
        """n chunks of S*w*packetsize bytes -> (S, n*w, packetsize) planes
        on the codec's device: the chunks go to the device as one (n,
        S*w*P) stack, and its (S, n, w, P) permute is made dense there by
        the reshape (a view, read in place by the kernel, when n or S is
        1)."""
        w, P = self.w, self.packetsize
        stacked = np.stack([np.asarray(a, dtype=np.uint8) for a in arrays])
        S = stacked.shape[1] // (w * P)
        dev = torch.from_numpy(stacked).to(self.device)
        return dev.view(len(arrays), S, w, P).permute(1, 0, 2, 3).reshape(
            S, len(arrays) * w, P
        )

    def _unplanes(self, planes: torch.Tensor, n: int) -> np.ndarray:
        """(S, n*w, P) -> (n, S*w*P) chunk bytes on the host."""
        S, _, P = planes.shape
        host = planes.cpu().numpy()
        return host.reshape(S, n, self.w, P).transpose(1, 0, 2, 3).reshape(n, -1)

    def _check_size(self, size: int) -> None:
        if size % (self.w * self.packetsize):
            raise EcError(
                EINVAL,
                f"chunk size {size} not a multiple of w*packetsize "
                f"{self.w * self.packetsize}",
            )

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        k, m = self.k, self.m
        raw_of = self.chunk_index
        self._check_size(len(chunks[raw_of(0)]))
        planes = self._planes([chunks[raw_of(i)] for i in range(k)])
        out = self._unplanes(gf2_plane_matmul(self._bitmatrix, planes), m)
        for i in range(m):
            np.copyto(chunks[raw_of(k + i)], out[i])

    def decode_chunks(
        self,
        want_to_read: set[int],
        chunks,
        decoded: dict[int, np.ndarray],
    ) -> None:
        k, m, w = self.k, self.m, self.w
        raw_of = self.chunk_index
        erasures = [i for i in range(k + m) if raw_of(i) not in chunks]
        if not erasures:
            return
        if len(erasures) > m:
            raise EcError(EIO, f"{len(erasures)} erasures > m={m}")
        self._check_size(len(next(iter(chunks.values()))))
        dec, decode_index = PLAN_CACHE.gf2_decode_plan(
            self._bitmatrix, k, w, erasures
        )
        planes = self._planes([decoded[raw_of(i)] for i in decode_index])
        out = self._unplanes(gf2_plane_matmul(dec, planes), len(erasures))
        for p, e in enumerate(erasures):
            np.copyto(decoded[raw_of(e)], out[p])
