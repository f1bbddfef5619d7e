"""Native-engine RS codec — the isa-style host SIMD path.

The port of `ceph_tpu/codec/native_codec.py`, the mirror of Ceph's `isa`
plugin's division of labor (src/erasure-code/isa/ErasureCodeIsa.cc): the
host class does matrices and caches, the native library does the byte
crunching.  The host side is ErasureCodeTpuRs's geometry and matrix
logic (the same math, so chunks are byte-identical to the `tpu`
plugin's), and the chunk path's region loops run in `libec_native.so`
(csrc/ec_native.cc, the ec_encode_data / region_xor twin), loaded
through the registry's dlopen path as Ceph loads `libec_isa.so`.

Decode tables are cached per erasure signature in a bounded LRU holding
native table handles (ErasureCodeIsaTableCache's decode LRU, capacity
2516, ErasureCodeIsaTableCache.h:48).

The chunk path (`encode_chunks` / `decode_chunks`) runs on the host
whatever the device; the array path (`encode_array` / `decode_array`) is
ErasureCodeTpuRs's, on the codec's `device`: the hand `swar_gf` kernel
on `cuda`, its plain version on `cpu`.
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch

from ..common.errs import EINVAL, EIO
from ..gf import isa_decode_matrix
from .interface import EcError
from .matrix_codec import DECODE_LRU_CAPACITY
from .rs import ErasureCodeTpuRs


def _check_regions(inputs: list[np.ndarray], length: int, count: int) -> None:
    """The C engine reads `count` regions of `length` bytes by pointer:
    chunks of another length would have it read past their ends."""
    if len(inputs) != count or any(i.nbytes != length for i in inputs):
        raise EcError(EINVAL, f"regions of {[i.nbytes for i in inputs]} bytes, "
                              f"want {count} of {length}")


class _NativeTables:
    """RAII over an ec_tables handle."""

    def __init__(self, lib, rows: int, cols: int, matrix: np.ndarray):
        self._lib = lib
        self.rows = rows
        self.cols = cols
        self._handle = lib.ec_tables_new(
            rows, cols, np.ascontiguousarray(matrix, dtype=np.uint8).tobytes()
        )

    def apply(self, inputs: list[np.ndarray], length: int) -> list[np.ndarray]:
        _check_regions(inputs, length, self.cols)
        outs = [np.empty(length, dtype=np.uint8) for _ in range(self.rows)]
        in_arr = (ctypes.c_void_p * self.cols)(*[i.ctypes.data for i in inputs])
        out_arr = (ctypes.c_void_p * self.rows)(*[o.ctypes.data for o in outs])
        self._lib.ec_tables_apply(self._handle, in_arr, out_arr, length)
        return outs

    def __del__(self):
        try:
            self._lib.ec_tables_free(self._handle)
        except Exception:
            pass


class ErasureCodeNative(ErasureCodeTpuRs):
    """RS(k, m) with native (C++) region coding — plugin `native`."""

    def __init__(
        self,
        lib: ctypes.CDLL,
        technique: str = "reed_sol_van",
        *,
        device: str | torch.device | None = None,
    ) -> None:
        super().__init__(technique=technique, device=device)
        self._lib = lib
        self._encode_tables: _NativeTables | None = None
        self._decode_lru: OrderedDict[str, tuple[_NativeTables, list[int]]] = (
            OrderedDict()
        )

    def invalidate_matrix(self) -> None:
        super().invalidate_matrix()
        self._encode_tables = None
        self._decode_lru = OrderedDict()

    # -- hot paths through the native engine ---------------------------------

    def _get_encode_tables(self) -> _NativeTables:
        if self._encode_tables is None:
            mat = self.distribution_matrix()
            self._encode_tables = _NativeTables(self._lib, self.m, self.k, mat[self.k :])
        return self._encode_tables

    def _region_xor(self, data: list[np.ndarray]) -> np.ndarray:
        _check_regions(data, data[0].nbytes, len(data))
        out = np.empty(len(data[0]), dtype=np.uint8)
        in_arr = (ctypes.c_void_p * len(data))(*[d.ctypes.data for d in data])
        self._lib.ec_region_xor(in_arr, len(data), out.ctypes.data, len(out))
        return out

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        k, m = self.k, self.m
        data = [
            np.ascontiguousarray(chunks[self.chunk_index(i)], dtype=np.uint8)
            for i in range(k)
        ]
        if m == 1 and self._xor_row_available():
            # region_xor fast path (ErasureCodeIsa.cc:125-131)
            np.copyto(chunks[self.chunk_index(k)], self._region_xor(data))
            return
        parity = self._get_encode_tables().apply(data, len(data[0]))
        for i in range(m):
            np.copyto(chunks[self.chunk_index(k + i)], parity[i])

    def _decode_tables(self, erasures: list[int]) -> tuple[_NativeTables, list[int]]:
        # the signature string of Ceph's "+avail-erased" keys
        # (ErasureCodeIsa.cc:227-240)
        sig = "-" + ",".join(map(str, sorted(erasures)))
        cached = self._decode_lru.get(sig)
        if cached is not None:
            self._decode_lru.move_to_end(sig)
            return cached
        plan = isa_decode_matrix(self.distribution_matrix(), erasures, self.k)
        if plan is None:
            raise EcError(EIO, f"cannot invert decode matrix for {erasures}")
        c_matrix, index = plan
        tables = _NativeTables(self._lib, len(erasures), self.k, c_matrix)
        self._decode_lru[sig] = (tables, index)
        while len(self._decode_lru) > DECODE_LRU_CAPACITY:
            self._decode_lru.popitem(last=False)
        return tables, index

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
            data = [
                np.ascontiguousarray(decoded[raw_of(i)], dtype=np.uint8) for i in sources
            ]
            np.copyto(decoded[raw_of(erasures[0])], self._region_xor(data))
            return
        tables, index = self._decode_tables(erasures)
        survivors = [
            np.ascontiguousarray(decoded[raw_of(i)], dtype=np.uint8) for i in index
        ]
        rec = tables.apply(survivors, len(survivors[0]))
        for p, e in enumerate(erasures):
            np.copyto(decoded[raw_of(e)], rec[p])
