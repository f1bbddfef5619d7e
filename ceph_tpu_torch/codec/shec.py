"""SHEC — Shingled Erasure Code, trading storage for recovery efficiency.

The port of `ceph_tpu/codec/shec.py` (Ceph's `shec` plugin,
src/erasure-code/shec/ErasureCodeShec.{h,cc}): a (k, m, c) code whose
parity rows are a jerasure Vandermonde matrix with entries zeroed outside
overlapping "shingle" windows (shec_reedsolomon_coding_matrix), so each
parity covers only a slice of the data and single-chunk repair reads
~k*c/m chunks instead of k.  Tolerates any c erasures (not MDS for more).

- technique `multiple` (default) picks the (m1, c1)/(m2, c2) two-band split
  minimizing Ceph's recovery-efficiency metric
  (shec_calc_recovery_efficiency1); `single` uses one band.
- Encode runs on `MatrixCodecMixin`'s tiers on the codec's device.
- Decode searches parity subsets for the smallest invertible recovery
  system (shec_make_decoding_matrix's minimum-dup search, memoized under a
  lock) and solves it with one launch of a decode-LRU coder
  (`PLAN_CACHE.lru_coder`) on the codec's device; erased parities are
  re-encoded from the recovered data on the host (`gf_matmul`), as the
  JAX package does.
- minimum_to_decode reports exactly the chunks that search reads.

Parameter envelope (ErasureCodeShec.cc:280-345): k<=12, k+m<=20, c<=m<=k;
defaults (k, m, c) = (4, 3, 2), w=8 (16/32 fall back like Ceph's).
"""

from __future__ import annotations

import itertools
from typing import Mapping

import numpy as np
import torch

from ..common.errs import EINVAL, EIO
from ..common.lockdep import make_lock
from ..gf import gf_invert_matrix, gf_matmul
from ..gf.matrix import jerasure_vandermonde_matrix
from .base import ErasureCode
from .interface import EcError, Profile
from .matrix_codec import PLAN_CACHE, MatrixCodecMixin, load_kernels

SINGLE = "single"
MULTIPLE = "multiple"


def _recovery_efficiency(k: int, m1: int, m2: int, c1: int, c2: int) -> float:
    """shec_calc_recovery_efficiency1 (ErasureCodeShec.cc:424-463)."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [10**8] * k
    r_e1 = 0.0
    for band_m, band_c in ((m1, c1), (m2, c2)):
        for rr in range(band_m):
            start = (rr * k) // band_m % k
            end = ((rr + band_c) * k) // band_m % k
            width = ((rr + band_c) * k) // band_m - (rr * k) // band_m
            cc = start
            first = True
            while first or cc != end:
                first = False
                r_eff_k[cc] = min(r_eff_k[cc], width)
                cc = (cc + 1) % k
            r_e1 += width
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


def shec_coding_matrix(k: int, m: int, c: int, technique: str) -> np.ndarray:
    """(m, k) shingled coding rows (shec_reedsolomon_coding_matrix)."""
    if technique == SINGLE:
        m1, c1 = 0, 0
    else:
        best = None
        for c1_try in range(c // 2 + 1):
            for m1_try in range(m + 1):
                c2, m2 = c - c1_try, m - m1_try
                if m1_try < c1_try or m2 < c2:
                    continue
                if (m1_try == 0) != (c1_try == 0) or (m2 == 0) != (c2 == 0):
                    continue
                r = _recovery_efficiency(k, m1_try, m2, c1_try, c2)
                if best is None or r < best[0] - 1e-12:
                    best = (r, c1_try, m1_try)
        assert best is not None, "no valid shingle split"
        c1, m1 = best[1], best[2]
    m2, c2 = m - m1, c - c1
    coding = jerasure_vandermonde_matrix(k, m)[k:].copy()
    for band, (band_m, band_c, row_off) in enumerate(((m1, c1, 0), (m2, c2, m1))):
        for rr in range(band_m):
            end = (rr * k) // band_m % k
            start = ((rr + band_c) * k) // band_m % k
            cc = start
            while cc != end:
                coding[row_off + rr, cc] = 0
                cc = (cc + 1) % k
    return coding


class ErasureCodeShec(MatrixCodecMixin, ErasureCode):
    """Shingled erasure code; encode via the matrix mixin, custom decode."""

    def __init__(
        self, technique: str = MULTIPLE, *, device: str | torch.device | None = None
    ) -> None:
        super().__init__(device)
        if technique not in (SINGLE, MULTIPLE):
            raise EcError(EINVAL, f"technique={technique} must be single|multiple")
        self.technique = technique
        self.k = 0
        self.m = 0
        self.c = 0
        self.w = 8
        self._decode_search_cache: dict[tuple, tuple] = {}
        self._lock = make_lock("shec_decode_cache")

    # -- init ---------------------------------------------------------------

    def parse(self, profile: Profile) -> None:
        super().parse(profile)
        self.invalidate_matrix()
        self._decode_search_cache.clear()
        has = [key in profile and profile[key] for key in ("k", "m", "c")]
        if not any(has):
            self.k, self.m, self.c = 4, 3, 2
            profile.update({"k": "4", "m": "3", "c": "2"})
        elif not all(has):
            raise EcError(EINVAL, "(k, m, c) must all be chosen or none")
        else:
            self.k = self.to_int("k", profile, "4")
            self.m = self.to_int("m", profile, "3")
            self.c = self.to_int("c", profile, "2")
        k, m, c = self.k, self.m, self.c
        if k <= 0 or m <= 0 or c <= 0:
            raise EcError(EINVAL, f"(k, m, c)=({k}, {m}, {c}) must be positive")
        if m < c:
            raise EcError(EINVAL, f"c={c} must be <= m={m}")
        if k > 12:
            raise EcError(EINVAL, f"k={k} must be <= 12")
        if k + m > 20:
            raise EcError(EINVAL, f"k+m={k + m} must be <= 20")
        if k < m:
            raise EcError(EINVAL, f"m={m} must be <= k={k}")
        # w: Ceph falls back to its default on any invalid value
        # (:355-371); the field core is GF(2^8), so every profile runs w=8.
        self.w = 8

    def init(self, profile: Profile) -> None:
        self.parse(profile)
        self.distribution_matrix()
        load_kernels(self.device)
        self._profile = dict(profile)

    def build_matrix(self) -> np.ndarray:
        coding = shec_coding_matrix(self.k, self.m, self.c, self.technique)
        return np.concatenate([np.eye(self.k, dtype=np.uint8), coding])

    def get_chunk_count(self) -> int:
        return self.k + self.m

    def get_data_chunk_count(self) -> int:
        return self.k

    # -- decode search (shec_make_decoding_matrix semantics) ----------------

    def _search(self, want: tuple[int, ...], avails: tuple[int, ...]):
        """Find (rows, columns, inverse) for the smallest recovery system.

        rows: global chunk ids supplying the equations; columns: data chunk
        ids being solved; inverse: GF inverse of the system matrix.  Mirrors
        Ceph's 2^m parity-subset scan with the min-dup/min-parity tie
        rules, and derives `minimum` the same way.
        """
        key = (want, avails)
        with self._lock:
            if key in self._decode_search_cache:
                return self._decode_search_cache[key]
        k, m = self.k, self.m
        matrix = self.distribution_matrix()[k:]
        want_x = list(want)
        # Wanting an erased parity drags in its data columns.
        for i in range(m):
            if want_x[k + i] and not avails[k + i]:
                for j in range(k):
                    if matrix[i, j]:
                        want_x[j] = 1
        best = None  # (dup, ek, rows, columns)
        minp = k + 1
        mindup = k + 1
        for parities in itertools.chain.from_iterable(
            itertools.combinations(range(m), n) for n in range(m + 1)
        ):
            ek = len(parities)
            if ek > minp:
                continue
            if not all(avails[k + p] for p in parities):
                continue
            rows = set()
            columns = set()
            for j in range(k):
                if want_x[j] and not avails[j]:
                    columns.add(j)
            for p in parities:
                rows.add(k + p)
                for j in range(k):
                    if matrix[p, j]:
                        columns.add(j)
                        if avails[j]:
                            rows.add(j)
            if len(rows) != len(columns):
                continue
            dup = len(rows)
            if dup == 0:
                best = (0, ek, [], [])
                mindup = 0
                break
            if dup < mindup:
                row_list = sorted(rows)
                col_list = sorted(columns)
                sysmat = np.zeros((dup, dup), dtype=np.uint8)
                for i, r in enumerate(row_list):
                    for j, col in enumerate(col_list):
                        if r < k:
                            sysmat[i, j] = 1 if r == col else 0
                        else:
                            sysmat[i, j] = matrix[r - k, col]
                inv = gf_invert_matrix(sysmat)
                if inv is None:
                    continue
                mindup = dup
                minp = ek
                best = (dup, ek, row_list, col_list, inv)
        if best is None or mindup == k + 1:
            result = None
        else:
            if best[0] == 0:
                rows_l, cols_l, inv = [], [], None
            else:
                rows_l, cols_l, inv = best[2], best[3], best[4]
            # minimum chunks (the tail of shec_make_decoding_matrix).
            minimum = set(rows_l)
            for i in range(k):
                if want_x[i] and avails[i]:
                    minimum.add(i)
            for i in range(m):
                if want[k + i] and avails[k + i] and (k + i) not in minimum:
                    if any(matrix[i, j] and not want_x[j] for j in range(k)):
                        minimum.add(k + i)
            result = (rows_l, cols_l, inv, sorted(minimum))
        with self._lock:
            self._decode_search_cache[key] = result
        return result

    # -- interface overrides ------------------------------------------------

    def _minimum_to_decode(self, want_to_read: set[int], available: set[int]) -> set[int]:
        n = self.k + self.m
        if want_to_read <= available:
            return set(want_to_read)
        want = tuple(1 if i in want_to_read else 0 for i in range(n))
        avails = tuple(1 if i in available else 0 for i in range(n))
        res = self._search(want, avails)
        if res is None:
            raise EcError(EIO, f"cannot recover {want_to_read} from {available}")
        return set(res[3])

    def decode_chunks(
        self,
        want_to_read: set[int],
        chunks: Mapping[int, np.ndarray],
        decoded: dict[int, np.ndarray],
    ) -> None:
        k, m = self.k, self.m
        n = k + m
        avail_set = set(chunks)
        want = tuple(1 if i in want_to_read else 0 for i in range(n))
        avails = tuple(1 if i in avail_set else 0 for i in range(n))
        res = self._search(want, avails)
        if res is None:
            raise EcError(EIO, f"cannot recover {want_to_read} from {avail_set}")
        rows, cols, inv, _minimum = res
        if inv is not None and rows:
            sources = np.stack(
                [np.asarray(decoded[r], dtype=np.uint8) for r in rows]
            )
            # One launch solves the whole system; the inverse is a runtime
            # operand of the kernel.  Decode-time matrices go through the
            # bounded LRU, not the per-geometry encode cache.
            coder = PLAN_CACHE.lru_coder(inv, self.device)
            solved = coder(self._to_device(sources)).cpu().numpy()
            for i, col in enumerate(cols):
                if not avails[col]:
                    np.copyto(decoded[col], solved[i])
        # Re-encode erased parity from (now complete) data.
        matrix = self.distribution_matrix()[k:]
        erased_parity = [
            i for i in range(m) if want[k + i] and not avails[k + i]
        ]
        if erased_parity:
            data = np.stack(
                [np.asarray(decoded[j], dtype=np.uint8) for j in range(k)]
            )
            parity = gf_matmul(matrix[erased_parity], data)
            for idx, i in enumerate(erased_parity):
                np.copyto(decoded[k + i], parity[idx])
