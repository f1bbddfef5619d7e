"""Codec base class — mirror of `ErasureCode` (the default scaffolding).

The port of `ceph_tpu/codec/base.py` (Ceph src/erasure-code/ErasureCode.{h,cc}).
Provides the shared machinery every codec inherits: chunk-size/padding
contract (encode_prepare, :150-185), default encode = prepare + encode_chunks
(:187-203), default decode = fill-missing + decode_chunks (:205-241),
first-k-available minimum_to_decode (:102-119), `mapping=` chunk remapping
(:260-279), and profile parsing helpers (:281-329).

Deltas from Ceph, the same as the JAX package's:
- SIMD_ALIGN=32 (ErasureCode.cc:42) generalizes to `ALIGNMENT` = 128, so
  every chunk from `encode()` is a multiple of 128 bytes, which is the gate
  of the hand kernel in ops/swar_gf.py.  get_chunk_size keeps the exact
  pad-up contract of ErasureCodeIsa.cc:65-79.
- Buffers are numpy uint8 arrays; the zero-fill that `encode_prepare` does
  with aligned bufferptrs becomes plain array padding.

The port adds an explicit `torch.device` on every codec: `cuda` unless the
caller asks for `cpu`.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..common.errs import EINVAL, EIO
from ..ops.guard import DeviceError
from .interface import EcError, ErasureCodeInterface, Profile


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The codec's device: `cuda` unless the caller names another.

    Raises when CUDA is asked for (or defaulted to) and there is none; it
    never picks the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError(
            "ceph_tpu_torch: CUDA is not available; pass device='cpu' "
            "to run the plain PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"ceph_tpu_torch: unsupported device {dev}")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ErasureCode(ErasureCodeInterface):
    # The reference's SIMD_ALIGN=32 analog, kept at the JAX package's 128.
    ALIGNMENT = 128

    def __init__(self, device: str | torch.device | None = None) -> None:
        self.device = resolve_device(device)
        self._profile: Profile = {}
        self.chunk_mapping: list[int] = []

    # -- profile helpers (ErasureCode.cc:281-329) ---------------------------

    @staticmethod
    def to_int(name: str, profile: Profile, default: str) -> int:
        if not profile.get(name):
            profile[name] = default
        try:
            return int(profile[name])
        except ValueError as e:
            raise EcError(EINVAL, f"could not convert {name}={profile[name]} to int") from e

    @staticmethod
    def to_bool(name: str, profile: Profile, default: str) -> bool:
        if not profile.get(name):
            profile[name] = default
        return profile[name] in ("yes", "true")

    @staticmethod
    def to_string(name: str, profile: Profile, default: str) -> str:
        if not profile.get(name):
            profile[name] = default
        return profile[name]

    @staticmethod
    def sanity_check_k_m(k: int, m: int) -> None:
        """ErasureCode.cc:84-95."""
        if k < 2:
            raise EcError(EINVAL, f"k={k} must be >= 2")
        if m < 1:
            raise EcError(EINVAL, f"m={m} must be >= 1")

    # -- init / profile -----------------------------------------------------

    def init(self, profile: Profile) -> None:
        self.parse(profile)
        # Own copy, like the reference's by-value profile member — makes the
        # registry's round-trip check meaningful (ErasureCodePlugin.cc:108-113).
        self._profile = dict(profile)

    def parse(self, profile: Profile) -> None:
        """Base parse: chunk remapping via `mapping=` (ErasureCode.cc:260-279).

        The mapping string has one char per chunk position; 'D' positions take
        data chunks in order, the rest take coding chunks in order.
        """
        mapping = profile.get("mapping")
        if mapping:
            data_pos = [i for i, c in enumerate(mapping) if c == "D"]
            coding_pos = [i for i, c in enumerate(mapping) if c != "D"]
            self.chunk_mapping = data_pos + coding_pos

    def get_profile(self) -> Profile:
        return self._profile

    def get_chunk_mapping(self) -> list[int]:
        return self.chunk_mapping

    def chunk_index(self, i: int) -> int:
        """ErasureCode.cc:97-100."""
        return self.chunk_mapping[i] if len(self.chunk_mapping) > i else i

    # -- geometry -----------------------------------------------------------

    def get_alignment(self) -> int:
        return self.ALIGNMENT

    def get_chunk_size(self, object_size: int) -> int:
        """ceil(object/k) padded up to alignment (ErasureCodeIsa.cc:65-79)."""
        k = self.get_data_chunk_count()
        chunk_size = (object_size + k - 1) // k
        align = self.get_alignment()
        modulo = chunk_size % align
        if modulo:
            chunk_size += align - modulo
        return chunk_size

    # -- minimum_to_decode (ErasureCode.cc:102-148) -------------------------

    def _minimum_to_decode(self, want_to_read: set[int], available: set[int]) -> set[int]:
        if want_to_read <= available:
            return set(want_to_read)
        k = self.get_data_chunk_count()
        if len(available) < k:
            raise EcError(EIO, f"need {k} chunks, only {len(available)} available")
        return set(sorted(available)[:k])

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> dict[int, list[tuple[int, int]]]:
        shards = self._minimum_to_decode(want_to_read, available)
        sub = [(0, self.get_sub_chunk_count())]
        return {s: list(sub) for s in sorted(shards)}

    def minimum_to_decode_with_cost(
        self, want_to_read: set[int], available: Mapping[int, int]
    ) -> set[int]:
        return self._minimum_to_decode(want_to_read, set(available))

    # -- encode path (ErasureCode.cc:150-203) -------------------------------

    def encode_prepare(self, raw: np.ndarray) -> dict[int, np.ndarray]:
        """Pad/split an object into k aligned data chunks + m zeroed parity
        buffers, honoring chunk_index remapping (ErasureCode.cc:150-185)."""
        k = self.get_data_chunk_count()
        m = self.get_coding_chunk_count()
        blocksize = self.get_chunk_size(raw.size)
        padded = np.zeros(k * blocksize, dtype=np.uint8)
        padded[: raw.size] = raw
        chunks: dict[int, np.ndarray] = {}
        for i in range(k):
            chunks[self.chunk_index(i)] = padded[i * blocksize : (i + 1) * blocksize]
        for i in range(k, k + m):
            chunks[self.chunk_index(i)] = np.zeros(blocksize, dtype=np.uint8)
        return chunks

    def encode(self, want_to_encode: set[int], data: bytes | np.ndarray) -> dict[int, np.ndarray]:
        raw = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8).ravel()
        chunks = self.encode_prepare(raw)
        self.encode_chunks(chunks)
        # Out-of-range ids in want_to_encode are filtered, like the
        # reference's erase-non-wanted loop (ErasureCode.cc:198-201).
        return {i: chunks[i] for i in want_to_encode if i in chunks}

    # -- decode path (ErasureCode.cc:205-248) -------------------------------

    def _decode(
        self, want_to_read: set[int], chunks: Mapping[int, np.ndarray]
    ) -> dict[int, np.ndarray]:
        have = set(chunks)
        if want_to_read <= have:
            return {i: np.asarray(chunks[i]) for i in want_to_read}
        if not chunks:
            raise EcError(EIO, "no chunks available to decode from")
        k = self.get_data_chunk_count()
        m = self.get_coding_chunk_count()
        blocksize = len(next(iter(chunks.values())))
        decoded: dict[int, np.ndarray] = {}
        for i in range(k + m):
            if i in chunks:
                decoded[i] = np.asarray(chunks[i], dtype=np.uint8)
            else:
                decoded[i] = np.zeros(blocksize, dtype=np.uint8)
        self.decode_chunks(want_to_read, chunks, decoded)
        return {i: decoded[i] for i in want_to_read}

    def decode(
        self,
        want_to_read: set[int],
        chunks: Mapping[int, np.ndarray],
        chunk_size: int = 0,
    ) -> dict[int, np.ndarray]:
        return self._decode(want_to_read, chunks)

    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> np.ndarray:
        """ErasureCode.cc:331-347."""
        k = self.get_data_chunk_count()
        want = {self.chunk_index(i) for i in range(k)}
        decoded = self._decode(want, chunks)
        return np.concatenate([decoded[self.chunk_index(i)] for i in range(k)])
