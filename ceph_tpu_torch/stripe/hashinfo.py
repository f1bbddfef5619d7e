"""HashInfo — per-shard cumulative crc32c digests.

The port of `ceph_tpu/stripe/hashinfo.py`, a mirror of
src/osd/ECUtil.h:101-160: one cumulative crc32c per shard plus the total
logical chunk size, persisted alongside the object (Ceph keeps it in the
`hinfo_key` xattr, ECUtil.cc:238) and verified on
every shard read (ECBackend.cc:1023-1156 `handle_sub_read`).  Digests chain
on append, so append-only writes update in O(appended bytes).
"""

from __future__ import annotations

import json

import numpy as np

from ..utils.crc32c import crc32c


class HashInfo:
    SEED = 0xFFFFFFFF  # reference seeds per-shard digests with -1

    def __init__(self, num_chunks: int):
        self.cumulative_shard_hashes = [self.SEED & 0xFFFFFFFF] * num_chunks
        self.total_chunk_size = 0

    def append(self, old_size: int, to_append: dict[int, bytes | np.ndarray]) -> None:
        """Chain `to_append[shard]` onto each shard digest.

        old_size is the shard-local offset the append starts at; like the
        reference, appends must be sequential (ECUtil.h append asserts)."""
        assert old_size == self.total_chunk_size, (old_size, self.total_chunk_size)
        sizes = {len(v) for v in to_append.values()}
        assert len(sizes) == 1, "all shards must append equally"
        size = sizes.pop()
        for shard, buf in to_append.items():
            self.cumulative_shard_hashes[shard] = crc32c(
                buf if isinstance(buf, (bytes, bytearray)) else np.asarray(buf),
                self.cumulative_shard_hashes[shard],
            )
        self.total_chunk_size += size

    def get_chunk_hash(self, shard: int) -> int:
        return self.cumulative_shard_hashes[shard]

    def get_total_chunk_size(self) -> int:
        return self.total_chunk_size

    def verify_chunk(self, shard: int, data: bytes | np.ndarray) -> bool:
        """Whole-shard verification: digest of data from seed must match."""
        got = crc32c(
            data if isinstance(data, (bytes, bytearray)) else np.asarray(data),
            self.SEED,
        )
        return got == self.cumulative_shard_hashes[shard]

    # -- persistence (the xattr analog) -------------------------------------

    def encode(self) -> bytes:
        return json.dumps(
            {
                "v": 1,
                "hashes": self.cumulative_shard_hashes,
                "size": self.total_chunk_size,
            }
        ).encode()

    @classmethod
    def decode(cls, blob: bytes) -> "HashInfo":
        obj = json.loads(blob.decode())
        hi = cls(len(obj["hashes"]))
        hi.cumulative_shard_hashes = [int(x) & 0xFFFFFFFF for x in obj["hashes"]]
        hi.total_chunk_size = int(obj["size"])
        return hi
