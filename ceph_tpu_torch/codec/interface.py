"""The codec contract — mirror of Ceph's `ErasureCodeInterface`.

A copy of `ceph_tpu/codec/interface.py` (Ceph
src/erasure-code/ErasureCodeInterface.h: systematic codes; object split into
k data + m coding chunks; byte B of the object lives in chunk B/chunk_size at
offset B%chunk_size, :39-58).  Ceph returns negative errnos; this Python
surface raises `EcError` carrying the same errno.

Chunks are numpy uint8 arrays (the bufferlist analog); profiles are
dict[str, str] exactly like `ErasureCodeProfile` (:155).
"""

from __future__ import annotations

import abc
import errno as _errno
from typing import Mapping

import numpy as np

Profile = dict[str, str]


class EcError(Exception):
    """Codec error carrying a negative errno (reference error convention)."""

    def __init__(self, err: int, msg: str = ""):
        self.errno = -abs(err)
        super().__init__(f"{msg} (errno {self.errno}, {_errno.errorcode.get(abs(err), '?')})")


class ErasureCodeInterface(abc.ABC):
    """Abstract codec contract (ErasureCodeInterface.h:170)."""

    @abc.abstractmethod
    def init(self, profile: Profile) -> None:
        """Initialize from profile; must populate get_profile() (:188)."""

    @abc.abstractmethod
    def get_profile(self) -> Profile:
        """The profile captured at init (:196)."""

    @abc.abstractmethod
    def get_chunk_count(self) -> int:
        """k + m (:227)."""

    @abc.abstractmethod
    def get_data_chunk_count(self) -> int:
        """k (:237)."""

    def get_coding_chunk_count(self) -> int:
        """m (:249)."""
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        """>1 only for array codes like CLAY (:259)."""
        return 1

    @abc.abstractmethod
    def get_chunk_size(self, object_size: int) -> int:
        """Chunk size for an object, padded to codec alignment (:278)."""

    @abc.abstractmethod
    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> dict[int, list[tuple[int, int]]]:
        """Chunks (with per-shard subchunk (offset, count) runs) needed to
        satisfy a read (:297).  Raises EcError(EIO) when undecodable."""

    @abc.abstractmethod
    def minimum_to_decode_with_cost(
        self, want_to_read: set[int], available: Mapping[int, int]
    ) -> set[int]:
        """Cost-aware variant (:326)."""

    @abc.abstractmethod
    def encode(self, want_to_encode: set[int], data: bytes | np.ndarray) -> dict[int, np.ndarray]:
        """Split + pad + encode an object; returns requested chunks (:365)."""

    @abc.abstractmethod
    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        """In-place parity computation over pre-sized chunk buffers (:370)."""

    @abc.abstractmethod
    def decode(
        self,
        want_to_read: set[int],
        chunks: Mapping[int, np.ndarray],
        chunk_size: int = 0,
    ) -> dict[int, np.ndarray]:
        """Recover wanted chunks from available ones (:407)."""

    @abc.abstractmethod
    def decode_chunks(
        self,
        want_to_read: set[int],
        chunks: Mapping[int, np.ndarray],
        decoded: dict[int, np.ndarray],
    ) -> None:
        """In-place reconstruction into pre-filled buffers (:411)."""

    @abc.abstractmethod
    def get_chunk_mapping(self) -> list[int]:
        """Chunk remapping vector (:448)."""

    @abc.abstractmethod
    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> np.ndarray:
        """Concatenate decoded data chunks back into the object (:460)."""
