"""Compressor plugin family — mirror of src/compressor.

The port's copy of `ceph_tpu/compressor/__init__.py`.  Ceph's third
dlopen plugin family beside erasure-code and the object classes: `Compressor::create(type)` resolves a named algorithm
plugin (zlib/snappy/lz4/zstd/brotli) used by BlueStore blob compression
and msgr2 on-wire compression.  Same shape here: a registry of named
compressors (zlib and zstd from the environment, plus passthrough
"none"), consumed by the BlueStore block path.  The `device` plugin
(compressor/device.py) is imported only when it is first asked for.
"""

from .registry import Compressor, CompressorRegistry, get_compressor

__all__ = ["Compressor", "CompressorRegistry", "get_compressor"]
