"""Device compressor plugin — the compress service of the offload runtime.

The port of `ceph_tpu/compressor/device.py`.  A registry plugin
(`bluestore_compression_algorithm = device`) whose transform is chosen for
the device, not for entropy coding: a byte-plane transpose (stride 64 —
each plane gathers byte p of every 64-byte row, so columnar or
record-structured block images concentrate their zero bytes into whole
planes) followed by zero-run elision at 64-byte cell granularity over the
transposed stream.  The batched form (`compress_batch`) runs as ONE launch
per aggregation window through the shared offload runtime
(`CompressAggregator`, background lane).

- `transform_rows` is the numpy host oracle (and the single-block
  `compress` path, as in the reference).
- `transform_rows_plain` is the same transform in plain torch.
- `transform_rows_device` is the kernel wrapper: a CUDA tensor launches
  csrc/compress_transform.cu (`transform_rows_device.launches` counts, and
  `.path_launches` by the path its C entry chose) or raises; a
  CPU tensor takes `transform_rows_plain`.

A failed or refused transform launch raises EcError(EIO) at the reap; the
store transaction that needed it fails whole, and nothing is recomputed on
the host (ROADMAP fault C8).

Stored blob format (self-framing, verified on decompress):

    b"TZD1" | <u32 LE orig_len> | cell bitmap (LSB-first) | nonzero cells

BlueStore's required-ratio gate is unchanged: a block image is stored
in this form only when the blob beats
``bluestore_compression_required_ratio`` — high-entropy blocks fail the
ratio and land raw, exactly like zlib/zstd.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from pathlib import Path

import numpy as np
import torch

from ..ops import _nvcc
from .registry import Compressor

MAGIC = b"TZD1"
TR = 64    # transpose stride: plane p = byte p of each TR-byte row
CELL = 64  # zero-elision granularity over the transposed stream

# Below this many total bytes a batch skips the offload runtime (host
# transform directly): dispatch + window latency beats the win.
COMPRESS_OFFLOAD_MIN_BYTES = 32 * 1024

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "compress_transform.cu"


def _padded_len(n: int) -> int:
    return -(-max(n, 1) // TR) * TR


def transform_rows(rows: np.ndarray) -> np.ndarray:
    """The host-oracle transform: (S, Lp) uint8 (Lp % 64 == 0)
    -> (S, Lp + Lp//CELL) uint8 — transposed bytes followed by the 0/1
    nonzero-cell flags.  The kernel computes the same array."""
    S, Lp = rows.shape
    t = rows.reshape(S, Lp // TR, TR).transpose(0, 2, 1).reshape(S, Lp)
    flags = t.reshape(S, Lp // CELL, CELL).any(axis=2).astype(np.uint8)
    return np.concatenate([t, flags], axis=1)


def transform_rows_plain(rows: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the transform, on the rows' device."""
    S, Lp = rows.shape
    t = rows.reshape(S, Lp // TR, TR).transpose(1, 2).reshape(S, Lp)
    flags = (t.reshape(S, Lp // CELL, CELL) != 0).any(dim=2).to(torch.uint8)
    return torch.cat([t, flags], dim=1)


_LIB: ctypes.CDLL | None = None
_LAUNCH_LOCK = threading.Lock()
build_info: dict = {}


def build_library() -> ctypes.CDLL:
    """Compile csrc/compress_transform.cu for sm_90a into the build
    directory (once per source content) and load it.  A failed build
    raises."""
    global _LIB
    if _LIB is None:
        built = _nvcc.build("compress_transform", SOURCE, {
            "compress_transform_launch": [
                ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong, ctypes.c_longlong,
                ctypes.c_void_p, ctypes.c_void_p,
            ],
            "compress_transform_path": [ctypes.c_longlong],
        })
        build_info.update(built.info)
        _LIB = built.lib
    return _LIB


def transform_rows_device(rows: torch.Tensor) -> torch.Tensor:
    """One batched launch of the transform: (S, Lp) uint8 -> (S, Lp +
    Lp//CELL) uint8 on the rows' device.  A CPU tensor takes
    `transform_rows_plain`; a CUDA tensor launches
    csrc/compress_transform.cu on the current stream or raises.  Rows are
    read in place by their stride."""
    from ..ops.dispatch import record_launch

    if rows.dtype != torch.uint8 or rows.dim() != 2 or rows.shape[1] % TR:
        raise ValueError(f"transform_rows_device: want (S, 64k) uint8, got {rows.dtype} "
                         f"{tuple(rows.shape)}")
    S, Lp = rows.shape
    record_launch(S, S * Lp)
    if rows.device.type == "cpu":
        return transform_rows_plain(rows)
    if rows.device.type != "cuda":
        raise ValueError(f"transform_rows_device: unsupported device {rows.device}")
    if Lp >= 1 << 30:
        raise ValueError(f"transform_rows_device: rows of {Lp} bytes, the kernel takes "
                         "fewer than 2^30")
    out = torch.empty((S, Lp + Lp // CELL), dtype=torch.uint8, device=rows.device)
    if S == 0 or Lp == 0:
        return out
    if rows.stride(1) != 1:
        rows = rows.contiguous()
    lib = build_library()
    # the C entry's choice by Lp alone: "tiles" (64x64-byte tiles transposed
    # in registers, one warp a tile) or "general" (one block a row)
    path = "tiles" if lib.compress_transform_path(Lp) else "general"
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.compress_transform_launch(rows.data_ptr(), S, Lp,
                                            rows.stride(0) if S > 1 else Lp,
                                            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"transform_rows_device: kernel launch failed (cudaError {err})")
    with _LAUNCH_LOCK:
        transform_rows_device.launches += 1
        transform_rows_device.path_launches[path] += 1
    return out


transform_rows_device.launches = 0  # kernel launches (plain-version calls excluded)
transform_rows_device.path_launches = {"tiles": 0, "general": 0}


def assemble_blob(transformed: np.ndarray, orig_len: int) -> bytes:
    """(Lp + Lp//CELL,) transform output row -> the stored blob."""
    Lp = _padded_len(orig_len)
    ncells = Lp // CELL
    t = transformed[:Lp]
    mask = transformed[Lp : Lp + ncells].astype(bool)
    bitmap = np.packbits(mask, bitorder="little").tobytes()
    payload = np.ascontiguousarray(t).reshape(ncells, CELL)[mask].tobytes()
    return MAGIC + struct.pack("<I", orig_len) + bitmap + payload


class DeviceCompressor(Compressor):
    name = "device"

    def compress(self, data: bytes) -> bytes:
        data = bytes(data)
        Lp = _padded_len(len(data))
        row = np.zeros((1, Lp), dtype=np.uint8)
        row[0, : len(data)] = np.frombuffer(data, dtype=np.uint8)
        return assemble_blob(transform_rows(row)[0], len(data))

    def decompress(self, data: bytes) -> bytes:
        blob = bytes(data)
        if blob[:4] != MAGIC or len(blob) < 8:
            raise ValueError("not a device-compressor blob")
        (orig_len,) = struct.unpack_from("<I", blob, 4)
        Lp = _padded_len(orig_len)
        ncells = Lp // CELL
        nbitmap = (ncells + 7) // 8
        mask = np.unpackbits(
            np.frombuffer(blob[8 : 8 + nbitmap], dtype=np.uint8),
            bitorder="little",
        )[:ncells].astype(bool)
        payload = np.frombuffer(blob[8 + nbitmap :], dtype=np.uint8)
        if payload.size != int(mask.sum()) * CELL:
            raise ValueError("device-compressor blob truncated")
        cells = np.zeros((ncells, CELL), dtype=np.uint8)
        if payload.size:
            cells[mask] = payload.reshape(-1, CELL)
        # inverse transpose: flat transposed stream -> original order
        out = (
            cells.reshape(Lp)
            .reshape(TR, Lp // TR)
            .transpose()
            .reshape(Lp)
        )
        return out.tobytes()[:orig_len]

    def compress_batch(self, blocks: list[bytes], device=None) -> list[bytes]:
        """Compress many block images with their transforms batched into
        shared offload-runtime launches on `device` (None: cuda;
        same-length groups coalesce across concurrent callers through the
        aggregation window); small batches take the host transform, as in
        the reference.  A failed launch raises EcError(EIO)."""
        if not blocks:
            return []
        total = sum(len(b) for b in blocks)
        if total < COMPRESS_OFFLOAD_MIN_BYTES:
            return [self.compress(b) for b in blocks]
        agg = default_compress_aggregator()
        by_len: dict[int, list[int]] = {}
        for i, b in enumerate(blocks):
            by_len.setdefault(len(b), []).append(i)
        out: list[bytes] = [b""] * len(blocks)
        tickets = []
        for n, idxs in by_len.items():
            Lp = _padded_len(n)
            rows = np.zeros((len(idxs), Lp), dtype=np.uint8)
            for r, i in enumerate(idxs):
                rows[r, :n] = np.frombuffer(blocks[i], dtype=np.uint8)
            tickets.append((n, idxs, agg.submit_rows(rows, device)))
        for n, idxs, ticket in tickets:
            transformed = ticket.result()
            for r, i in enumerate(idxs):
                out[i] = assemble_blob(transformed[r], n)
        return out


# registry entry: resolved by get_compressor("device") exactly like the
# zlib/zstd plugins (BlueStore's bluestore_compression_algorithm knob)
from .registry import CompressorRegistry  # noqa: E402

CompressorRegistry._PLUGINS.setdefault("device", DeviceCompressor)


from ..ops.offload_runtime import (  # noqa: E402
    AggTicket,
    LaunchAggregator,
    _AggGroup,
    register_service,
)


class CompressAggregator(LaunchAggregator):
    """Cross-block / cross-object compressor-transform aggregation:
    same-padded-length block images submitted inside one window ride ONE
    kernel launch (background lane).  Tickets resolve to (stripes, Lp +
    Lp//CELL) transform rows; `assemble_blob` turns each row into the
    stored form.  Groups are keyed by device too."""

    PERF_NAME = "compress_aggregator"
    WHAT = "compress"
    SCHED_CLASS = "background"
    MEM_POOL = "offload_inflight"

    def submit_rows(self, rows: np.ndarray, device=None) -> AggTicket:
        """Queue one (S, Lp) uint8 padded block batch (Lp % 64 == 0) for
        `device` (None: cuda)."""
        from ..codec.base import resolve_device

        shaped = np.ascontiguousarray(rows, dtype=np.uint8)
        if shaped.ndim != 2 or shaped.shape[1] % TR:
            raise ValueError(f"expected (S, 64k) rows, got {shaped.shape}")
        dev = resolve_device(device)
        return self._submit(
            ("#compress", str(dev), shaped.shape[1]), dev, None, shaped[:, None, :]
        )

    def _dispatch(self, g: _AggGroup, data: np.ndarray, donate):
        S = data.shape[0]
        return transform_rows_device(torch.from_numpy(data.reshape(S, -1)).to(g.ec))

    def _out_shape(self, g: _AggGroup, data_shape) -> tuple:
        Lp = data_shape[1] * data_shape[2]
        return (data_shape[0], Lp + Lp // CELL)

    def _donate_ok(self, g: _AggGroup, data_shape) -> bool:
        return False  # output shape differs from input; no buffer reuse


_DEFAULT_COMPRESS_AGGREGATOR: CompressAggregator | None = None


def default_compress_aggregator() -> CompressAggregator:
    """Process-wide compressor aggregator shared by every BlueStore in
    the process (one per OSD harness), so concurrent writers' block
    transforms coalesce exactly like their encodes do."""
    global _DEFAULT_COMPRESS_AGGREGATOR
    if _DEFAULT_COMPRESS_AGGREGATOR is None:
        from ..common.options import OPTIONS

        _DEFAULT_COMPRESS_AGGREGATOR = CompressAggregator(
            window=int(OPTIONS["bluestore_csum_offload_window"].default),
            max_bytes=int(
                OPTIONS["bluestore_csum_offload_max_bytes"].default
            ),
        )
    return _DEFAULT_COMPRESS_AGGREGATOR


register_service(
    "compress", default_compress_aggregator, lane="background",
    oracle="compressor/device.transform_rows",
    doc="batched byte-plane transpose + zero-run elision compressor",
)
