"""Compressor registry (src/compressor/Compressor.{h,cc}).

The port's copy of `ceph_tpu/compressor/registry.py`, whole.  `zstd` imports
`zstandard` only when it is built, so the module loads without it.

`Compressor::create(cct, alg)` analog: get_compressor(name) returns a
cached instance implementing compress/decompress over bytes.  Unknown
names raise (Ceph returns a null CompressorRef and callers
error out) — no silent fallback to a different algorithm, since both
sides of a wire or a disk format must agree.
"""

from __future__ import annotations

import zlib


class Compressor:
    """One algorithm (CompressionPlugin instance)."""

    name = "none"

    def compress(self, data: bytes) -> bytes:
        return bytes(data)

    def decompress(self, data: bytes) -> bytes:
        return bytes(data)


class ZlibCompressor(Compressor):
    name = "zlib"

    def compress(self, data: bytes) -> bytes:
        return zlib.compress(data)

    def decompress(self, data: bytes) -> bytes:
        return zlib.decompress(data)


class ZstdCompressor(Compressor):
    name = "zstd"

    def __init__(self):
        import zstandard

        self._c = zstandard.ZstdCompressor()
        self._d = zstandard.ZstdDecompressor()

    def compress(self, data: bytes) -> bytes:
        return self._c.compress(data)

    def decompress(self, data: bytes) -> bytes:
        return self._d.decompress(data)


class CompressorRegistry:
    """Named get-or-create cache (Compressor::create's static registry)."""

    _PLUGINS = {
        "none": Compressor,
        "zlib": ZlibCompressor,
        "zstd": ZstdCompressor,
    }

    def __init__(self):
        self._instances: dict[str, Compressor] = {}

    def get(self, name: str) -> Compressor:
        inst = self._instances.get(name)
        if inst is not None:
            return inst
        cls = self._PLUGINS.get(name)
        if cls is None and name == "device":
            # the device plugin self-registers on import; loaded lazily
            # so the registry does not import torch and the offload runtime
            from . import device  # noqa: F401

            cls = self._PLUGINS.get(name)
        if cls is None:
            raise ValueError(
                f"unknown compressor {name!r} (have {sorted(self._PLUGINS)})"
            )
        inst = self._instances[name] = cls()
        return inst


_REGISTRY = CompressorRegistry()


def get_compressor(name: str) -> Compressor:
    return _REGISTRY.get(name)
