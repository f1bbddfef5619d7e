"""Wire frames — mirror of src/msg/async/frames_v2.h.

Reference: msgr2 frames (src/msg/async/frames_v2.h:35)
carry up to 4 segments behind a fixed preamble holding the tag, segment
count and lengths, crc32c-protected; segment payloads get their own
crc32c in an epilogue.  CRC mode is mirrored here (secure/AES-GCM mode is
out of scope; the hook point is `ms_crc_data`).

Frame layout:
  preamble (28 B): magic "CT" | version u8 | tag u8 | flags u8 | pad u8 |
                   4 x seg_len u32 | preamble crc32c u32
  segments:        seg_count x raw bytes
  epilogue:        seg_count x crc32c u32   (omitted when flags bit 0 unset)
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

from ..utils.crc32c import crc32c

MAGIC = b"CT"
VERSION = 2

# frame tags (frames_v2.h Tag enum analog)
TAG_HELLO = 1
TAG_MESSAGE = 2
TAG_ACK = 3
TAG_KEEPALIVE = 4

FLAG_CRC_DATA = 1

_PREAMBLE = struct.Struct("<2sBBBB4II")  # magic, ver, tag, flags, pad, lens, crc
PREAMBLE_SIZE = _PREAMBLE.size
MAX_SEGMENTS = 4


class FrameError(Exception):
    pass


@dataclass
class Frame:
    tag: int
    segments: list[bytes]

    def pack(self, crc_data: bool = True) -> bytes:
        if len(self.segments) > MAX_SEGMENTS:
            raise FrameError(f"{len(self.segments)} segments > {MAX_SEGMENTS}")
        lens = [len(s) for s in self.segments] + [0] * (
            MAX_SEGMENTS - len(self.segments)
        )
        flags = FLAG_CRC_DATA if crc_data else 0
        head = struct.pack(
            "<2sBBBB4I", MAGIC, VERSION, self.tag, flags, len(self.segments), *lens
        )
        out = [head, struct.pack("<I", crc32c(head))]
        out.extend(self.segments)
        if crc_data:
            for s in self.segments:
                out.append(struct.pack("<I", crc32c(s)))
        return b"".join(out)


def preamble_info(buf: bytes) -> tuple[int, int, list[int]]:
    """Parse+verify a preamble -> (tag, flags, segment lengths)."""
    if len(buf) < PREAMBLE_SIZE:
        raise FrameError("short preamble")
    magic, ver, tag, flags, seg_count, l0, l1, l2, l3 = struct.unpack(
        "<2sBBBB4I", buf[: PREAMBLE_SIZE - 4]
    )
    (crc,) = struct.unpack("<I", buf[PREAMBLE_SIZE - 4 : PREAMBLE_SIZE])
    if magic != MAGIC:
        raise FrameError(f"bad magic {magic!r}")
    if ver != VERSION:
        raise FrameError(f"bad version {ver}")
    if crc32c(buf[: PREAMBLE_SIZE - 4]) != crc:
        raise FrameError("preamble crc mismatch")
    if seg_count > MAX_SEGMENTS:
        raise FrameError(f"bad segment count {seg_count}")
    return tag, flags, [l0, l1, l2, l3][:seg_count]


async def read_frame(reader) -> Frame:
    """Read one frame from an asyncio StreamReader, verifying CRCs."""
    head = await reader.readexactly(PREAMBLE_SIZE)
    tag, flags, seg_lens = preamble_info(head)
    segments = [await reader.readexactly(n) if n else b"" for n in seg_lens]
    if flags & FLAG_CRC_DATA:
        for i, seg in enumerate(segments):
            (crc,) = struct.unpack("<I", await reader.readexactly(4))
            if crc32c(seg) != crc:
                raise FrameError(f"segment {i} crc mismatch")
    return Frame(tag, segments)


def frame_from_bytes(buf: bytes) -> Frame:
    """Parse one complete frame from a byte string (the secure/compressed
    on-wire path decrypts whole records, then parses here).  Truncated
    input raises FrameError, never struct.error."""
    tag, flags, seg_lens = preamble_info(buf[:PREAMBLE_SIZE])
    need = PREAMBLE_SIZE + sum(seg_lens)
    if flags & FLAG_CRC_DATA:
        need += 4 * len(seg_lens)
    if len(buf) < need:
        raise FrameError(f"frame body truncated ({len(buf)} < {need})")
    off = PREAMBLE_SIZE
    segments = []
    for n in seg_lens:
        segments.append(buf[off : off + n])
        off += n
    if flags & FLAG_CRC_DATA:
        for i, seg in enumerate(segments):
            (crc,) = struct.unpack_from("<I", buf, off)
            off += 4
            if crc32c(seg) != crc:
                raise FrameError(f"segment {i} crc mismatch")
    return Frame(tag, segments)
