"""Trivial XOR example plugin of the port (k data + 1 parity).

The port of `ceph_tpu/codec/plugins/xor.py`, the mirror of Ceph's example
codec used by registry tests (src/test/erasure-code/ErasureCodeExample.h).
The parity and the one-erasure decode are the port's `xor_reduce` on the
codec's device.
"""

import numpy as np
import torch

from ceph_tpu_torch.codec.base import ErasureCode
from ceph_tpu_torch.codec.interface import Profile
from ceph_tpu_torch.codec.registry import EC_VERSION, ErasureCodePlugin
from ceph_tpu_torch.ops.xor_mm import xor_reduce

__erasure_code_version__ = EC_VERSION


class ErasureCodeXorExample(ErasureCode):
    def __init__(self, device: str | torch.device | None = None) -> None:
        super().__init__(device)
        self.k = 2

    def parse(self, profile: Profile) -> None:
        super().parse(profile)
        self.k = self.to_int("k", profile, "2")
        self.sanity_check_k_m(self.k, 1)

    def get_chunk_count(self) -> int:
        return self.k + 1

    def get_data_chunk_count(self) -> int:
        return self.k

    def _xor(self, arrays: list) -> np.ndarray:
        stack = np.stack([np.asarray(a, dtype=np.uint8) for a in arrays])
        return xor_reduce(torch.from_numpy(stack).to(self.device)).cpu().numpy()

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        parity = self._xor([chunks[self.chunk_index(i)] for i in range(self.k)])
        np.copyto(chunks[self.chunk_index(self.k)], parity)

    def decode_chunks(self, want_to_read, chunks, decoded) -> None:
        raw_of = self.chunk_index
        erasures = [i for i in range(self.k + 1) if raw_of(i) not in chunks]
        if not erasures:
            return
        assert len(erasures) == 1, "XOR codec tolerates exactly one erasure"
        sources = [i for i in range(self.k + 1) if raw_of(i) in chunks][: self.k]
        np.copyto(decoded[raw_of(erasures[0])], self._xor([decoded[raw_of(i)] for i in sources]))


def _factory(profile, device):
    ec = ErasureCodeXorExample(device)
    ec.init(profile)
    return ec


def __erasure_code_init__(registry):
    registry.add("xor", ErasureCodePlugin("xor", _factory))
