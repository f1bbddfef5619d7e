"""Generic GF(2^8) matrix-codec machinery: the RS encode/decode path.

The port of the part of `ceph_tpu/codec/matrix_codec.py` that the `tpu`
plugin's encode, decode, deep-scrub verify and RMW delta run:
`_DeviceCoder`, the plan cache and `MatrixCodecMixin`.  Any systematic code
defined by a (k+m, k) distribution matrix gets its chunk-level and
device-level paths from the mixin; concrete codecs supply geometry +
`build_matrix()`.

Caching mirrors Ceph's two-level table cache
(src/erasure-code/isa/ErasureCodeIsaTableCache.{h,cc}): encode coders per
matrix, decode coders in a signature-keyed LRU (capacity 2516, "sufficient up
to (12,4)", ErasureCodeIsaTableCache.h:48), verify plans per encode matrix.  A
cached coder holds the SWAR kernel's schedule operand, the packed plane
program (its device operand cached per device) and the bit-matrix on its
device; every key includes the device.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch

from ..common.errs import EINVAL, EIO
from ..gf import expand_matrix, isa_decode_matrix, xor_matmul_host_batch
from ..ops.dispatch import lead_stripes, record_launch
from ..ops.packed_gf import (
    PACKED_MIN_BYTES,
    PackedPlan,
    PackedVerifyPlan,
    packed_code_host,
    packed_delta_flat,
    packed_delta_host,
    packed_verify_host,
)
from ..ops.swar_gf import CodingPlan, pick_geometry
from ..ops.xor_mm import xor_matmul, xor_reduce
from .interface import EcError

DECODE_LRU_CAPACITY = 2516


def dense_aligned(data: torch.Tensor) -> torch.Tensor:
    """`data` itself when it is contiguous and its base address is 16-byte
    aligned, else a fresh dense copy (a new allocation is aligned).  A
    slice of a tensor, such as `cw[:, :8]` or `buf[1:]`, may be neither,
    and the kernel tier takes only dense, aligned input."""
    if data.is_contiguous() and data.data_ptr() % 16 == 0:
        return data
    return data.clone(memory_format=torch.contiguous_format)


class _DeviceCoder:
    """One cached coding operator on one device, three tiers, taken in the
    reference's order (matrix_codec.py:152-162):

    - chunk length a multiple of 128 (`pick_geometry`): the SWAR kernel
      wrapper on the input made dense and aligned (`dense_aligned`), which
      launches csrc/swar_gf.cu for a CUDA tensor and runs its plain version
      for a CPU tensor;
    - any other length, at least PACKED_MIN_BYTES of input: `PackedPlan`,
      the packed plane program (csrc/packed_gf.cu for a CUDA tensor, read
      in place by its strides; its plain version for a CPU tensor), which
      writes into `out` when that fits;
    - smaller inputs: `xor_matmul` on the bit-matrix.

    Every tier counts one dispatch on `ops/dispatch.py`'s counters; a
    decode-kind coder also on DECODE_LAUNCHES.
    """

    __slots__ = ("bm", "plan", "packed", "decode")

    def __init__(self, gf_rows: np.ndarray, device: torch.device, decode: bool = False):
        self.plan = CodingPlan(gf_rows, device=device, decode=decode)
        self.packed = PackedPlan(gf_rows, decode=decode)
        self.bm = torch.from_numpy(expand_matrix(gf_rows)).to(device)
        self.decode = decode

    def __call__(self, data: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        if pick_geometry(data.shape[-1]) is not None:
            return self.plan(dense_aligned(data))
        if data.numel() >= PACKED_MIN_BYTES:
            return self.packed(data, out=out)
        record_launch(lead_stripes(data.shape), data.numel(), decode=self.decode)
        return xor_matmul(self.bm, data)


class _GlobalPlanCache:
    """Process-wide encode/decode coder cache keyed by device and matrix
    content."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._encode_coders: dict[tuple, _DeviceCoder] = {}
        self._decode: OrderedDict[tuple, tuple[np.ndarray, list[int]]] = OrderedDict()
        self._decode_coders: OrderedDict[tuple, _DeviceCoder] = OrderedDict()
        self._verify_plans: dict[tuple, PackedVerifyPlan] = {}

    def encode_coder(self, coding_rows: np.ndarray, device: torch.device) -> _DeviceCoder:
        """Cached coding operator for an encode matrix on `device`; unbounded
        like the reference's per-(k,m) encode tables."""
        key = (str(device), coding_rows.shape, coding_rows.tobytes())
        with self._lock:
            coder = self._encode_coders.get(key)
        if coder is not None:
            return coder
        coder = _DeviceCoder(coding_rows, device)  # built outside the lock
        with self._lock:
            return self._encode_coders.setdefault(key, coder)

    def verify_coder(self, coding_rows: np.ndarray, device: torch.device) -> PackedVerifyPlan:
        """Cached compare-only verify plan for an encode matrix's parity rows
        on `device` (the deep-scrub kernel); unbounded like the encode
        coders."""
        key = (str(device), coding_rows.shape, coding_rows.tobytes())
        with self._lock:
            plan = self._verify_plans.get(key)
        if plan is not None:
            return plan
        plan = PackedVerifyPlan(coding_rows)
        with self._lock:
            return self._verify_plans.setdefault(key, plan)

    def decode_plan(
        self, dist_matrix: np.ndarray, erasures: list[int], k: int
    ) -> tuple[np.ndarray, list[int]]:
        """(GF decode matrix, decode_index) for an erasure pattern,
        LRU-cached, so a coder rebuild after a coder-LRU eviction is not a
        second Gaussian inversion."""
        return self._decode_entry(
            self._decode_key(dist_matrix, erasures, k), dist_matrix, erasures, k
        )

    def _decode_entry(
        self, key: tuple, dist_matrix: np.ndarray, erasures: list[int], k: int
    ) -> tuple[np.ndarray, list[int]]:
        with self._lock:
            cached = self._decode.get(key)
            if cached is not None:
                self._decode.move_to_end(key)
                return cached
        entry = isa_decode_matrix(dist_matrix, erasures, k)
        if entry is None:
            raise EcError(EIO, f"singular decode matrix for erasures {erasures}")
        with self._lock:
            self._decode[key] = entry
            self._decode.move_to_end(key)
            while len(self._decode) > DECODE_LRU_CAPACITY:
                self._decode.popitem(last=False)
        return entry

    def _decode_key(
        self, dist_matrix: np.ndarray, erasures: list[int], k: int
    ) -> tuple:
        """Reference signature format, ErasureCodeIsa.cc:233-248 (the
        survivor part uses the first-k-non-erased rows)."""
        km = dist_matrix.shape[0]
        erased = set(erasures)
        survivors: list[int] = []
        r = 0
        for _ in range(k):
            while r in erased:
                r += 1
            if r >= km:
                raise EcError(EIO, f"not enough survivors for erasures {erasures}")
            survivors.append(r)
            r += 1
        sig = "".join(f"+{r}" for r in survivors) + "".join(
            f"-{e}" for e in erasures
        )
        return (dist_matrix.shape, dist_matrix.tobytes(), sig)

    def decode_coder(
        self,
        dist_matrix: np.ndarray,
        erasures: list[int],
        k: int,
        device: torch.device,
    ) -> tuple[_DeviceCoder, list[int]]:
        """Cached coding operator + survivor index for an erasure pattern."""
        key = self._decode_key(dist_matrix, erasures, k)
        c, decode_index = self._decode_entry(key, dist_matrix, erasures, k)
        ckey = (str(device), *key)
        with self._lock:
            coder = self._decode_coders.get(ckey)
            if coder is not None:
                self._decode_coders.move_to_end(ckey)
                return coder, decode_index
        coder = _DeviceCoder(c, device, decode=True)  # built outside the lock
        with self._lock:
            self._decode_coders[ckey] = coder
            self._decode_coders.move_to_end(ckey)
            while len(self._decode_coders) > DECODE_LRU_CAPACITY:
                self._decode_coders.popitem(last=False)
        return coder, decode_index


PLAN_CACHE = _GlobalPlanCache()


class MatrixCodecMixin:
    """Chunk-level + device-level coding for matrix-defined codecs.

    Host contract: the concrete class provides `self.k`, `self.m`,
    `self.device`, `chunk_index()` (from ErasureCode) and
    `build_matrix() -> (k+m, k)` systematic uint8 distribution matrix.
    """

    _dist_matrix: np.ndarray | None = None

    def build_matrix(self) -> np.ndarray:  # pragma: no cover - abstract
        raise NotImplementedError

    def invalidate_matrix(self) -> None:
        """Drop the cached distribution matrix; call on (re)parse so a
        second init() with new geometry cannot serve the stale matrix."""
        self._dist_matrix = None

    def distribution_matrix(self) -> np.ndarray:
        if self._dist_matrix is None:
            mat = np.asarray(self.build_matrix(), dtype=np.uint8)
            k, m = self.k, self.m
            if mat.shape != (k + m, k):
                raise EcError(EINVAL, f"distribution matrix shape {mat.shape} != {(k + m, k)}")
            if not np.array_equal(mat[:k], np.eye(k, dtype=np.uint8)):
                raise EcError(EINVAL, "distribution matrix must be systematic")
            self._dist_matrix = mat
        return self._dist_matrix

    def _xor_row_available(self) -> bool:
        """True when parity row 0 is all ones (enables XOR fast paths)."""
        mat = self.distribution_matrix()
        return bool((mat[self.k] == 1).all())

    def _to_device(self, data) -> torch.Tensor:
        """A uint8 tensor on the codec's device (host arrays are copied)."""
        if isinstance(data, torch.Tensor):
            if data.dtype != torch.uint8:
                raise TypeError(f"chunks must be uint8, got {data.dtype}")
            return data.to(self.device)
        arr = np.asarray(data, dtype=np.uint8)
        if not (arr.flags.c_contiguous and arr.flags.writeable):
            arr = np.array(arr, order="C")
        return torch.from_numpy(arr).to(self.device)

    # -- device-native bulk paths ------------------------------------------

    def encode_array(self, data, out: torch.Tensor | None = None) -> torch.Tensor:
        """(..., k, L) uint8 -> (..., m, L) parity, on the codec's device.

        Dispatches through the cached _DeviceCoder, so on CUDA this IS a
        hand kernel (SWAR for L a multiple of 128, else the packed program
        for bulk input) — the analog of the reference plugin's
        `ec_encode_data` hot call (isa/ErasureCodeIsa.cc:83-91).  `out`: a
        dead buffer of the parity's shape that the packed tier writes into
        (ignored by the other paths)."""
        mat = self.distribution_matrix()
        arr = self._to_device(data)
        if self.m == 1 and self._xor_row_available():
            record_launch(lead_stripes(arr.shape), arr.numel())
            return xor_reduce(arr)[..., None, :]
        return PLAN_CACHE.encode_coder(mat[self.k :], self.device)(arr, out=out)

    def decode_array(
        self, erasures: list[int], survivors, out: torch.Tensor | None = None
    ) -> torch.Tensor:
        """survivors (..., k, L) in decode_index order -> (..., nerrs, L).

        The decode twin of encode_array: dispatches through the cached
        erasure-pattern _DeviceCoder; `out` as for encode_array."""
        coder, _ = PLAN_CACHE.decode_coder(
            self.distribution_matrix(), list(erasures), self.k, self.device
        )
        return coder(self._to_device(survivors), out=out)

    def verify_array(self, codewords) -> torch.Tensor:
        """(..., k+m, L) uint8 codewords (data rows in encode order, then the
        stored parity rows) -> (...,) uint8 per-stripe mismatch bitmap, bit
        j set iff stored parity row j differs from the recompute.  The
        deep-scrub compare-only path: one launch of the verify kernel."""
        mat = self.distribution_matrix()
        return PLAN_CACHE.verify_coder(mat[self.k :], self.device)(
            self._to_device(codewords)
        )

    def verify_array_host(self, codewords) -> np.ndarray:
        """Byte-identical HOST oracle of verify_array (pure numpy)."""
        mat = self.distribution_matrix()
        return packed_verify_host(mat[self.k :], np.asarray(codewords, dtype=np.uint8))

    def encode_array_host(self, data) -> np.ndarray:
        """Byte-identical HOST oracle of encode_array, pure numpy: the same
        xor fast-path gate, then the packed plane program the device's
        packed tier runs (`packed_code_host`)."""
        mat = self.distribution_matrix()
        arr = np.asarray(data, dtype=np.uint8)
        if self.m == 1 and self._xor_row_available():
            return np.bitwise_xor.reduce(arr, axis=-2)[..., None, :]
        return packed_code_host(mat[self.k :], arr)

    def encode_delta_device(self, old_bufs, new_bufs, parity_bufs, chunk: int) -> torch.Tensor:
        """RMW parity delta on the device: k + k + m FLAT per-shard buffers
        (each a shard's (stripes * chunk,) bytes, as the chunk cache holds
        them) -> (stripes, m, chunk) NEW parity in one launch.  The code is
        GF(2)-linear, so parity_new = parity_old ^ Encode(old ^ new), with
        Encode the packed program of `encode_array`'s packed tier.  Counts
        one dispatch."""
        mat = self.distribution_matrix()
        bufs = [self._to_device(b) for b in (*old_bufs, *new_bufs, *parity_bufs)]
        k = self.k
        record_launch(bufs[0].numel() // int(chunk), sum(b.numel() for b in bufs))
        plan = PLAN_CACHE.encode_coder(mat[k:], self.device).packed
        return packed_delta_flat(
            plan.operand_for(bufs[0]), bufs[:k], bufs[k : 2 * k], bufs[2 * k :], int(chunk)
        )

    def encode_delta_host(self, old_data, new_data, old_parity) -> np.ndarray:
        """Byte-identical HOST oracle of encode_delta_device (pure numpy):
        (S, k, L) old/new data + (S, m, L) old parity -> (S, m, L) new
        parity."""
        mat = self.distribution_matrix()
        return packed_delta_host(mat[self.k :], old_data, new_data, old_parity)

    def decode_array_host(self, erasures: list[int], survivors) -> np.ndarray:
        """Byte-identical HOST oracle of decode_array (pure numpy), from the
        same isa_decode_matrix Gaussian the cached coder was built from."""
        c, _ = PLAN_CACHE.decode_plan(self.distribution_matrix(), list(erasures), self.k)
        return xor_matmul_host_batch(
            expand_matrix(c), np.asarray(survivors, dtype=np.uint8)
        )

    def decode_index(self, erasures: list[int]) -> list[int]:
        _, idx = PLAN_CACHE.decode_plan(self.distribution_matrix(), erasures, self.k)
        return idx

    # -- chunk-level interface ---------------------------------------------

    @staticmethod
    def _as_u8(buf) -> np.ndarray:
        """Normalize one chunk buffer to uint8 without copying when
        avoidable: contiguous uint8 arrays pass through untouched, raw byte
        containers map zero-copy via frombuffer, and everything else goes
        through np.asarray."""
        if type(buf) is np.ndarray and buf.dtype == np.uint8:
            return buf
        if isinstance(buf, (bytes, bytearray, memoryview)):
            return np.frombuffer(buf, dtype=np.uint8)
        return np.asarray(buf, dtype=np.uint8)

    def _gather(self, chunks: Mapping[int, np.ndarray]) -> np.ndarray:
        """Stack the k data chunks in encode order."""
        return np.stack(
            [self._as_u8(chunks[self.chunk_index(i)]) for i in range(self.k)]
        )

    def _scatter(self, chunks: Mapping[int, np.ndarray], parity: np.ndarray) -> None:
        for i in range(self.m):
            np.copyto(chunks[self.chunk_index(self.k + i)], parity[i])

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        self._scatter(chunks, self.encode_array(self._gather(chunks)).cpu().numpy())

    def _use_xor_decode(self, erasures: list[int]) -> bool:
        """Single-erasure XOR path: first k+1 chunks + all-ones parity row 0
        (generalizes ErasureCodeIsa.cc:196-216)."""
        return (
            len(erasures) == 1
            and erasures[0] < self.k + 1
            and self._xor_row_available()
        )

    def decode_chunks(
        self,
        want_to_read: set[int],
        chunks: Mapping[int, np.ndarray],
        decoded: dict[int, np.ndarray],
    ) -> None:
        k, m = self.k, self.m
        raw_of = self.chunk_index
        erasures = [i for i in range(k + m) if raw_of(i) not in chunks]
        if not erasures:
            return
        if len(erasures) > m:
            raise EcError(EIO, f"{len(erasures)} erasures > m={m}")
        if self._use_xor_decode(erasures):
            sources = [i for i in range(k + m) if raw_of(i) in chunks][:k]
            stack = np.stack([self._as_u8(decoded[raw_of(i)]) for i in sources])
            rec = xor_reduce(self._to_device(stack)).cpu().numpy()
            np.copyto(decoded[raw_of(erasures[0])], rec)
            return
        idx = self.decode_index(erasures)
        survivors = np.stack([self._as_u8(decoded[raw_of(i)]) for i in idx])
        rec = self.decode_array(erasures, survivors).cpu().numpy()
        for p, e in enumerate(erasures):
            np.copyto(decoded[raw_of(e)], rec[p])
