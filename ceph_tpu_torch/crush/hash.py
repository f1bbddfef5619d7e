"""Jenkins-style 32-bit hashing for CRUSH — analog of src/crush/hash.c.

The reference's rjenkins1 hash family (crush_hash32_*) is Robert Jenkins'
public 96-bit mix specialized to 1-3 word inputs.  This implementation is
written from the published algorithm; what matters for the framework is
determinism and avalanche, and that every copy of it (the JAX package's,
this port's) produces identical values.
"""

from __future__ import annotations

M32 = 0xFFFFFFFF

# Arbitrary seed constant folded into every hash (hash.c crush_hash_seed).
HASH_SEED = 1315423911


def _mix(a: int, b: int, c: int) -> tuple[int, int, int]:
    """Jenkins 96-bit mix (public domain lookup2 mixing step)."""
    a = (a - b) & M32; a = (a - c) & M32; a ^= c >> 13
    b = (b - c) & M32; b = (b - a) & M32; b = (b ^ (a << 8)) & M32
    c = (c - a) & M32; c = (c - b) & M32; c ^= b >> 13
    a = (a - b) & M32; a = (a - c) & M32; a ^= c >> 12
    b = (b - c) & M32; b = (b - a) & M32; b = (b ^ (a << 16)) & M32
    c = (c - a) & M32; c = (c - b) & M32; c ^= b >> 5
    a = (a - b) & M32; a = (a - c) & M32; a ^= c >> 3
    b = (b - c) & M32; b = (b - a) & M32; b = (b ^ (a << 10)) & M32
    c = (c - a) & M32; c = (c - b) & M32; c ^= b >> 15
    return a, b, c


def crush_hash32(a: int) -> int:
    a &= M32
    h = (HASH_SEED ^ a) & M32
    x, y = 231232, 1232
    a2, _, h = _mix(a, x, h)
    _, _, h = _mix(y, a2, h)
    return h


def crush_hash32_2(a: int, b: int) -> int:
    a &= M32
    b &= M32
    h = (HASH_SEED ^ a ^ b) & M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    x, a, h = _mix(x, a, h)
    b, y, h = _mix(b, y, h)
    return h


def crush_hash32_3(a: int, b: int, c: int) -> int:
    a &= M32
    b &= M32
    c &= M32
    h = (HASH_SEED ^ a ^ b ^ c) & M32
    x, y = 231232, 1232
    a, b, h = _mix(a, b, h)
    c, x, h = _mix(c, x, h)
    y, a, h = _mix(y, a, h)
    b, x, h = _mix(b, x, h)
    return h


def str_hash(s: str | bytes) -> int:
    """Object-name hash (ceph_str_hash_rjenkins analog): fold the bytes
    through the word hash 4 bytes at a time."""
    if isinstance(s, str):
        s = s.encode("utf-8")
    h = crush_hash32(len(s))
    for i in range(0, len(s), 4):
        word = int.from_bytes(s[i : i + 4].ljust(4, b"\x00"), "little")
        h = crush_hash32_2(h, word)
    return h
