"""Generic GF(2^8) matrix-codec machinery shared by every matrix technique.

The port of `ceph_tpu/codec/matrix_codec.py`: `_DeviceCoder`, the plan
cache (with its hit/miss totals, the raw-matrix decode coders of SHEC's
searched inverses and the GF(2) decode plans of jerasure's bit-matrix
techniques, all in one decode LRU), the host decode-plan memo,
`MatrixCodecMixin`, the EC aggregators of the offload runtime
(`EncodeAggregator`, `DecodeAggregator`, `VerifyAggregator` and their
process-wide `default_*_aggregator` services) and `EncodePipeline`.  Any
systematic code defined by a (k+m, k) distribution matrix gets its
chunk-level and device-level paths from the mixin; concrete codecs supply
geometry + `build_matrix()`.

Caching mirrors Ceph's two-level table cache
(src/erasure-code/isa/ErasureCodeIsaTableCache.{h,cc}): encode coders per
matrix, decode coders in a signature-keyed LRU (capacity 2516, "sufficient up
to (12,4)", ErasureCodeIsaTableCache.h:48), verify plans per encode matrix.  A
cached coder holds the SWAR kernel's schedule operand, the packed plane
program (its device operand cached per device) and the bit-matrix on its
device; every key includes the device.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import Mapping

import numpy as np
import torch

from ..common.errs import EINVAL, EIO
from ..common.lockdep import make_lock
from ..gf import expand_matrix, isa_decode_matrix, xor_matmul_host_batch
from ..gf.gf2 import gf2_inv, gf2_matmul
from ..ops.dispatch import lead_stripes, record_launch
from ..ops.packed_gf import (
    PACKED_MIN_BYTES,
    PackedPlan,
    PackedVerifyPlan,
    packed_code_host,
    packed_delta_flat,
    packed_delta_host,
    packed_verify_host,
)
from ..ops import packed_gf, swar_gf
from ..ops.offload_runtime import (
    AggTicket,
    LaunchAggregator,
    _AggGroup,
    completion_event,
    register_service,
)
from ..ops.swar_gf import CodingPlan, pick_geometry
from ..ops.xor_mm import xor_matmul, xor_reduce
from .interface import EcError

DECODE_LRU_CAPACITY = 2516

# Host-oracle decode-plan memo (decode_array_host): expanded bit-matrices
# keyed by (distribution matrix, erasure pattern), bounded like the decode
# LRU but kept apart from PLAN_CACHE, so the host oracle never builds a
# device operand.
_HOST_DECODE_CAPACITY = 256
_HOST_DECODE_PLANS: "OrderedDict[tuple, np.ndarray]" = OrderedDict()
_HOST_DECODE_LOCK = make_lock("host_decode")


def dense_aligned(data: torch.Tensor) -> torch.Tensor:
    """`data` itself when it is contiguous and its base address is 16-byte
    aligned, else a fresh dense copy (a new allocation is aligned).  A
    slice of a tensor, such as `cw[:, :8]` or `buf[1:]`, may be neither,
    and the kernel tier takes only dense, aligned input."""
    if data.is_contiguous() and data.data_ptr() % 16 == 0:
        return data
    return data.clone(memory_format=torch.contiguous_format)


def load_kernels(device: torch.device) -> None:
    """Build (once per process) and load the hand kernels a coder on
    `device` runs: nothing for the CPU, `csrc/swar_gf.cu` and
    `csrc/packed_gf.cu` for CUDA.  A CUDA codec calls it when it is made,
    so an nvcc build never runs inside a guarded dispatch, where it would
    count against the launch deadline and degrade the backend; a build
    error raises to the caller."""
    if device.type == "cuda":
        swar_gf.build_library()
        packed_gf.build_library()


class _DeviceCoder:
    """One cached coding operator on one device, three tiers, taken in the
    reference's order (matrix_codec.py:152-162):

    - chunk length a multiple of 128 (`pick_geometry`): the SWAR kernel
      wrapper on the input made dense and aligned (`dense_aligned`), which
      launches csrc/swar_gf.cu for a CUDA tensor and runs its plain version
      for a CPU tensor;
    - any other length, at least PACKED_MIN_BYTES of input: `PackedPlan`,
      the packed plane program (csrc/packed_gf.cu for a CUDA tensor, read
      in place by its strides; its plain version for a CPU tensor), which
      writes into `out` when that fits;
    - smaller inputs: `xor_matmul` on the bit-matrix.

    Every tier counts one dispatch on `ops/dispatch.py`'s counters; a
    decode-kind coder also on DECODE_LAUNCHES.
    """

    __slots__ = ("bm", "plan", "packed", "decode")

    def __init__(
        self,
        gf_rows: np.ndarray,
        device: torch.device,
        decode: bool = False,
        bm: torch.Tensor | None = None,
    ):
        self.plan = CodingPlan(gf_rows, device=device, decode=decode)
        self.packed = PackedPlan(gf_rows, decode=decode)
        if bm is None:
            bm = torch.from_numpy(expand_matrix(gf_rows)).to(device)
        self.bm = bm
        self.decode = decode

    @staticmethod
    def tier(shape) -> str:
        """The tier an input of this (..., k, L) shape runs on: "swar",
        "packed" or "xor_matmul"."""
        if pick_geometry(shape[-1]) is not None:
            return "swar"
        if int(np.prod(shape)) >= PACKED_MIN_BYTES:
            return "packed"
        return "xor_matmul"

    def __call__(self, data: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
        tier = self.tier(data.shape)
        if tier == "swar":
            return self.plan(dense_aligned(data))
        if tier == "packed":
            return self.packed(data, out=out)
        record_launch(lead_stripes(data.shape), data.numel(), decode=self.decode)
        return xor_matmul(self.bm, data)


class _GlobalPlanCache:
    """Process-wide encode/decode coder cache keyed by device and matrix
    content."""

    def __init__(self) -> None:
        self._lock = make_lock("plan_cache")
        self._encode_coders: dict[tuple, _DeviceCoder] = {}
        self._decode: OrderedDict[tuple, tuple[np.ndarray, list[int]]] = OrderedDict()
        self._decode_coders: OrderedDict[tuple, _DeviceCoder] = OrderedDict()
        self._verify_plans: dict[tuple, PackedVerifyPlan] = {}
        # coder lookup hit/miss totals (encode, decode and verify), as the
        # reference counts them
        self._hits = 0
        self._misses = 0

    def stats(self) -> dict[str, int]:
        """Coder-cache hit/miss totals (encode + decode + verify lookups)."""
        with self._lock:
            return {"hits": self._hits, "misses": self._misses}

    def reset_stats(self) -> None:
        with self._lock:
            self._hits = 0
            self._misses = 0

    def encode_coder(self, coding_rows: np.ndarray, device: torch.device) -> _DeviceCoder:
        """Cached coding operator for an encode matrix on `device`; unbounded
        like the reference's per-(k,m) encode tables."""
        key = (str(device), coding_rows.shape, coding_rows.tobytes())
        with self._lock:
            coder = self._encode_coders.get(key)
            if coder is not None:
                self._hits += 1
            else:
                self._misses += 1
        if coder is not None:
            return coder
        coder = _DeviceCoder(coding_rows, device)  # built outside the lock
        with self._lock:
            return self._encode_coders.setdefault(key, coder)

    def verify_coder(self, coding_rows: np.ndarray, device: torch.device) -> PackedVerifyPlan:
        """Cached compare-only verify plan for an encode matrix's parity rows
        on `device` (the deep-scrub kernel); unbounded like the encode
        coders."""
        key = (str(device), coding_rows.shape, coding_rows.tobytes())
        with self._lock:
            plan = self._verify_plans.get(key)
            if plan is not None:
                self._hits += 1
                return plan
            self._misses += 1
        plan = PackedVerifyPlan(coding_rows)
        with self._lock:
            return self._verify_plans.setdefault(key, plan)

    def decode_plan(
        self, dist_matrix: np.ndarray, erasures: list[int], k: int
    ) -> tuple[np.ndarray, list[int]]:
        """(GF decode matrix, decode_index) for an erasure pattern,
        LRU-cached, so a coder rebuild after a coder-LRU eviction is not a
        second Gaussian inversion."""
        return self._decode_entry(
            self._decode_key(dist_matrix, erasures, k), dist_matrix, erasures, k
        )

    def _lru_put(self, key, value) -> None:
        with self._lock:
            self._decode[key] = value
            self._decode.move_to_end(key)
            while len(self._decode) > DECODE_LRU_CAPACITY:
                self._decode.popitem(last=False)

    def lru_coder(self, matrix: np.ndarray, device: torch.device) -> _DeviceCoder:
        """Coding operator on `device` for a decode-time matrix, bounded by
        the decode LRU (SHEC's searched inverses and other raw-matrix
        decode paths)."""
        key = (str(device), matrix.shape, matrix.tobytes(), "#raw")
        with self._lock:
            coder = self._decode_coders.get(key)
            if coder is not None:
                self._hits += 1
                self._decode_coders.move_to_end(key)
                return coder
            self._misses += 1
        bm = self.lru_bit_matrix(matrix, device)
        coder = _DeviceCoder(matrix, device, decode=True, bm=bm)  # built outside the lock
        with self._lock:
            self._decode_coders[key] = coder
            self._decode_coders.move_to_end(key)
            while len(self._decode_coders) > DECODE_LRU_CAPACITY:
                self._decode_coders.popitem(last=False)
        return coder

    def lru_bit_matrix(self, matrix: np.ndarray, device: torch.device) -> torch.Tensor:
        """Bit-matrix on `device` for a decode-time matrix, bounded by the
        decode LRU, stored beside the signature-keyed plans so the decode
        tables stay within DECODE_LRU_CAPACITY, as Ceph's cache does."""
        key = (str(device), matrix.shape, matrix.tobytes(), "#raw")
        with self._lock:
            cached = self._decode.get(key)
            if cached is not None:
                self._decode.move_to_end(key)
                return cached[0]
        bm = torch.from_numpy(expand_matrix(matrix)).to(device)
        self._lru_put(key, (bm, []))
        return bm

    def gf2_decode_plan(
        self, bitmatrix: np.ndarray, k: int, w: int, erasures: list[int]
    ) -> tuple[np.ndarray, list[int]]:
        """Decode plan for a packetized GF(2) bit-matrix RAID-6 code
        (liberation family): (decode matrix (len(erasures)*w, k*w),
        decode_index), host numpy.  Shares the one decode LRU."""
        n = k + bitmatrix.shape[0] // w
        erased = set(erasures)
        decode_index = [c for c in range(n) if c not in erased][:k]
        if len(decode_index) < k:
            raise EcError(EIO, f"not enough survivors for erasures {erasures}")
        key = (bitmatrix.shape, bitmatrix.tobytes(), "#gf2", tuple(erasures))
        with self._lock:
            cached = self._decode.get(key)
            if cached is not None:
                self._decode.move_to_end(key)
                return cached
        # full generator: data identity rows then the coding rows (the
        # bitmatrix already carries both the P-identity and Q blocks)
        full = np.zeros((n * w, k * w), dtype=np.uint8)
        full[: k * w] = np.eye(k * w, dtype=np.uint8)
        full[k * w :] = bitmatrix
        survivors = np.vstack([full[c * w : (c + 1) * w] for c in decode_index])
        inv = gf2_inv(survivors)
        if inv is None:
            raise EcError(EIO, f"singular decode matrix for erasures {erasures}")
        erased_rows = np.vstack([full[c * w : (c + 1) * w] for c in erasures])
        plan = (gf2_matmul(erased_rows, inv), decode_index)
        self._lru_put(key, plan)
        return plan

    def _decode_entry(
        self, key: tuple, dist_matrix: np.ndarray, erasures: list[int], k: int
    ) -> tuple[np.ndarray, list[int]]:
        with self._lock:
            cached = self._decode.get(key)
            if cached is not None:
                self._decode.move_to_end(key)
                return cached
        entry = isa_decode_matrix(dist_matrix, erasures, k)
        if entry is None:
            raise EcError(EIO, f"singular decode matrix for erasures {erasures}")
        self._lru_put(key, entry)
        return entry

    def _decode_key(
        self, dist_matrix: np.ndarray, erasures: list[int], k: int
    ) -> tuple:
        """Reference signature format, ErasureCodeIsa.cc:233-248 (the
        survivor part uses the first-k-non-erased rows)."""
        km = dist_matrix.shape[0]
        erased = set(erasures)
        survivors: list[int] = []
        r = 0
        for _ in range(k):
            while r in erased:
                r += 1
            if r >= km:
                raise EcError(EIO, f"not enough survivors for erasures {erasures}")
            survivors.append(r)
            r += 1
        sig = "".join(f"+{r}" for r in survivors) + "".join(
            f"-{e}" for e in erasures
        )
        return (dist_matrix.shape, dist_matrix.tobytes(), sig)

    def decode_coder(
        self,
        dist_matrix: np.ndarray,
        erasures: list[int],
        k: int,
        device: torch.device,
    ) -> tuple[_DeviceCoder, list[int]]:
        """Cached coding operator + survivor index for an erasure pattern."""
        key = self._decode_key(dist_matrix, erasures, k)
        c, decode_index = self._decode_entry(key, dist_matrix, erasures, k)
        ckey = (str(device), *key)
        with self._lock:
            coder = self._decode_coders.get(ckey)
            if coder is not None:
                self._hits += 1
                self._decode_coders.move_to_end(ckey)
                return coder, decode_index
            self._misses += 1
        coder = _DeviceCoder(c, device, decode=True)  # built outside the lock
        with self._lock:
            self._decode_coders[ckey] = coder
            self._decode_coders.move_to_end(ckey)
            while len(self._decode_coders) > DECODE_LRU_CAPACITY:
                self._decode_coders.popitem(last=False)
        return coder, decode_index


PLAN_CACHE = _GlobalPlanCache()


class EncodeAggregator(LaunchAggregator):
    """Cross-write launch aggregation: concurrent stripe encodes of one
    (matrix, chunk-size) geometry coalesce into one padded device launch
    (knobs `ec_tpu_aggregate_window` / `ec_tpu_aggregate_max_bytes`)."""

    PERF_NAME = "ec_aggregator"
    WHAT = "encode"

    def submit(self, ec: "MatrixCodecMixin", shaped: np.ndarray) -> AggTicket:
        """Queue one (stripes, k, L) uint8 encode; returns its ticket."""
        return self._submit(
            (ec.distribution_matrix().tobytes(), shaped.shape[-1]), ec, None, shaped
        )

    def _dispatch(self, g: _AggGroup, data: np.ndarray, donate):
        return g.ec.encode_array(data, out=donate)

    def _out_shape(self, g: _AggGroup, data_shape) -> tuple:
        return (
            data_shape[0],
            g.ec.get_chunk_count() - data_shape[1],
            data_shape[2],
        )

    def _donate_ok(self, g: _AggGroup, data_shape) -> bool:
        check = getattr(g.ec, "encode_donatable", None)
        return bool(check(data_shape)) if check is not None else False


class DecodeAggregator(LaunchAggregator):
    """Cross-op DECODE launch aggregation — the recovery/degraded-read
    twin of EncodeAggregator (knobs `ec_tpu_decode_aggregate_window` /
    `ec_tpu_decode_aggregate_max_bytes`).

    Submissions are (stripes, k, L) survivor batches in decode_index
    order, keyed by the cached decode-plan signature + chunk length: the
    common case during recovery/backfill is ONE erasure pattern repeating
    across every object in the PG, so per-object decodes coalesce into
    one padded launch exactly like concurrent writes do on the encode
    side.  Tickets resolve to (stripes, len(erasures), L) reconstructed
    chunks, rows in erasure order; a failed launch is sticky on its group
    and reported at every co-rider's reap."""

    PERF_NAME = "ec_decode_aggregator"
    WHAT = "decode"
    SCHED_CLASS = "recovery"

    def submit(
        self, ec: "MatrixCodecMixin", erasures: list[int], survivors: np.ndarray
    ) -> AggTicket:
        """Queue one (stripes, k, L) uint8 survivor batch (decode_index
        order); returns its ticket.  Co-riders share a group only when
        their decode-plan signature matches, so every ticket in a group
        agrees on the erasure row order."""
        erasures = list(erasures)
        key = PLAN_CACHE._decode_key(
            ec.distribution_matrix(), erasures, ec.k
        ) + (survivors.shape[-1],)
        return self._submit(key, ec, tuple(erasures), survivors)

    def _dispatch(self, g: _AggGroup, data: np.ndarray, donate):
        return g.ec.decode_array(list(g.ctx), data, out=donate)

    def _out_shape(self, g: _AggGroup, data_shape) -> tuple:
        return (data_shape[0], len(g.ctx), data_shape[2])

    def _donate_ok(self, g: _AggGroup, data_shape) -> bool:
        check = getattr(g.ec, "decode_donatable", None)
        return bool(check(list(g.ctx), data_shape)) if check is not None else False


class VerifyAggregator(LaunchAggregator):
    """Cross-object VERIFY launch aggregation: deep-scrub parity
    recomputes from one (matrix, chunk-length) geometry coalesce into one
    compare-only device launch (knobs `ec_tpu_verify_aggregate_window` /
    `ec_tpu_verify_aggregate_max_bytes`).

    Submissions are (stripes, k+m, L) full-codeword batches — data rows
    in encode order followed by the stored parity rows — and tickets
    resolve to a (stripes,) uint8 per-stripe mismatch bitmap (bit j set
    = parity row j inconsistent).  Padding stripes are all-zero
    codewords, whose recomputed parity is zero = their stored parity,
    so a padded launch's bitmap is exact.  Launches dispatch under the
    `background` QoS lane: a scrub chunk's verify never preempts a
    queued client encode."""

    PERF_NAME = "ec_verify_aggregator"
    WHAT = "verify"
    SCHED_CLASS = "background"
    MEM_POOL = "verify"

    def submit(self, ec: "MatrixCodecMixin", codewords: np.ndarray) -> AggTicket:
        """Queue one (stripes, k+m, L) uint8 codeword batch; the ticket
        resolves to its (stripes,) mismatch bitmap."""
        return self._submit(
            (ec.distribution_matrix().tobytes(), "#verify",
             codewords.shape[-1]),
            ec, None, codewords,
        )

    def _dispatch(self, g: _AggGroup, data: np.ndarray, donate):
        return g.ec.verify_array(data)

    def _out_shape(self, g: _AggGroup, data_shape) -> tuple:
        return (data_shape[0],)

    def _donate_ok(self, g: _AggGroup, data_shape) -> bool:
        return False  # the bitmap output is tiny; pooling buys nothing


_DEFAULT_AGGREGATOR: EncodeAggregator | None = None


def default_encode_aggregator() -> EncodeAggregator:
    """Process-wide aggregator shared by every caller that isn't handed
    its own — the sharing is what coalesces encodes ACROSS PGs.  Built
    from the option-table defaults (common/options.py)."""
    global _DEFAULT_AGGREGATOR
    if _DEFAULT_AGGREGATOR is None:
        from ..common.options import OPTIONS

        _DEFAULT_AGGREGATOR = EncodeAggregator(
            window=int(OPTIONS["ec_tpu_aggregate_window"].default),
            max_bytes=int(OPTIONS["ec_tpu_aggregate_max_bytes"].default),
        )
    return _DEFAULT_AGGREGATOR


_DEFAULT_DECODE_AGGREGATOR: DecodeAggregator | None = None


def default_decode_aggregator() -> DecodeAggregator:
    """Process-wide decode aggregator, so recovery/degraded-read decodes
    coalesce ACROSS PGs on one OSD (the backfill case: one erasure
    pattern, many objects)."""
    global _DEFAULT_DECODE_AGGREGATOR
    if _DEFAULT_DECODE_AGGREGATOR is None:
        from ..common.options import OPTIONS

        _DEFAULT_DECODE_AGGREGATOR = DecodeAggregator(
            window=int(OPTIONS["ec_tpu_decode_aggregate_window"].default),
            max_bytes=int(OPTIONS["ec_tpu_decode_aggregate_max_bytes"].default),
        )
    return _DEFAULT_DECODE_AGGREGATOR


_DEFAULT_VERIFY_AGGREGATOR: VerifyAggregator | None = None


def default_verify_aggregator() -> VerifyAggregator:
    """Process-wide verify aggregator shared by every scrubber, so
    concurrent deep scrubs of different PGs coalesce their parity
    recomputes into shared compare-only launches.  The default window is
    open (unlike encode/decode): scrub is a throughput workload with no
    commit barrier, so batching is pure win — the scrubber's per-chunk
    reap is the flush."""
    global _DEFAULT_VERIFY_AGGREGATOR
    if _DEFAULT_VERIFY_AGGREGATOR is None:
        from ..common.options import OPTIONS

        _DEFAULT_VERIFY_AGGREGATOR = VerifyAggregator(
            window=int(OPTIONS["ec_tpu_verify_aggregate_window"].default),
            max_bytes=int(OPTIONS["ec_tpu_verify_aggregate_max_bytes"].default),
        )
    return _DEFAULT_VERIFY_AGGREGATOR


# The EC trio are the offload runtime's service entries: same singletons,
# same knobs, same perf names as the reference's.
register_service(
    "encode", default_encode_aggregator, lane="client",
    oracle="MatrixCodecMixin.encode_array_host",
    doc="EC stripe encode (parity generation)",
)
register_service(
    "decode", default_decode_aggregator, lane="recovery",
    oracle="MatrixCodecMixin.decode_array_host",
    doc="EC reconstruct decode (recovery / degraded reads)",
)
register_service(
    "verify", default_verify_aggregator, lane="background",
    oracle="MatrixCodecMixin.verify_array_host",
    doc="EC deep-scrub compare-only verify",
)


class EncodePipeline:
    """Asynchronous chunk-encode hand-off — the completion queue behind
    the synchronous `encode_chunks` interface.

    `submit` copies the stripe to the device and LAUNCHES the encode
    (kernel launches are asynchronous: the call returns while the device
    works; the host-to-device copy of pageable memory blocks), and records
    a CUDA event after it, so consecutive submissions overlap compute with
    the host-side gather of the next batch.  Completions copy parity back
    into the caller's chunk buffers exactly like `encode_chunks`; `poll()`
    reaps only launches whose event has fired (non-blocking), `flush()`
    drains everything.  `depth` bounds device-side in-flight work the way
    an AIO queue depth does.
    """

    def __init__(self, codec: "MatrixCodecMixin", depth: int = 4):
        self.codec = codec
        self.depth = max(1, depth)
        self._tickets = 0
        # in-flight: (ticket, caller chunk dict, device parity, its event)
        self._inflight: list[tuple] = []
        # tickets completed inside submit's backpressure path: the next
        # poll()/flush() reports them — a completed ticket is NEVER lost
        self._reaped: list[int] = []

    def submit(self, chunks: Mapping[int, np.ndarray]) -> int:
        """Launch one stripe's encode; returns its ticket.  Blocks only
        when `depth` launches are already in flight (backpressure)."""
        parity_dev = self.codec.encode_array(self.codec._gather(chunks))
        self._tickets += 1
        self._inflight.append(
            (self._tickets, chunks, parity_dev, completion_event(parity_dev))
        )
        while len(self._inflight) > self.depth:
            self._reaped += self._complete(*self._inflight.pop(0))
        return self._tickets

    def _complete(self, ticket: int, chunks, parity_dev, event) -> list[int]:
        parity = parity_dev.cpu().numpy()  # blocks until the launch finishes
        self.codec._scatter(chunks, parity)
        return [ticket]

    def poll(self) -> list[int]:
        """Reap FINISHED launches without blocking (completion queue)."""
        done, self._reaped = self._reaped, []
        while self._inflight:
            event = self._inflight[0][3]
            # no event means unknown readiness, so NOT ready: popping
            # would block in _complete and silently defeat the
            # non-blocking contract (a CPU tensor is reaped by flush)
            if event is None or not event.query():
                break  # still computing; keep submission order
            done += self._complete(*self._inflight.pop(0))
        return done

    def flush(self) -> list[int]:
        """Drain every in-flight encode (the barrier before a commit)."""
        done, self._reaped = self._reaped, []
        while self._inflight:
            done += self._complete(*self._inflight.pop(0))
        return done


class MatrixCodecMixin:
    """Chunk-level + device-level coding for matrix-defined codecs.

    Host contract: the concrete class provides `self.k`, `self.m`,
    `self.device`, `chunk_index()` (from ErasureCode) and
    `build_matrix() -> (k+m, k)` systematic uint8 distribution matrix.
    """

    _dist_matrix: np.ndarray | None = None

    def build_matrix(self) -> np.ndarray:  # pragma: no cover - abstract
        raise NotImplementedError

    def invalidate_matrix(self) -> None:
        """Drop the cached distribution matrix; call on (re)parse so a
        second init() with new geometry cannot serve the stale matrix."""
        self._dist_matrix = None

    def distribution_matrix(self) -> np.ndarray:
        if self._dist_matrix is None:
            mat = np.asarray(self.build_matrix(), dtype=np.uint8)
            k, m = self.k, self.m
            if mat.shape != (k + m, k):
                raise EcError(EINVAL, f"distribution matrix shape {mat.shape} != {(k + m, k)}")
            if not np.array_equal(mat[:k], np.eye(k, dtype=np.uint8)):
                raise EcError(EINVAL, "distribution matrix must be systematic")
            self._dist_matrix = mat
        return self._dist_matrix

    def _xor_row_available(self) -> bool:
        """True when parity row 0 is all ones (enables XOR fast paths)."""
        mat = self.distribution_matrix()
        return bool((mat[self.k] == 1).all())

    def _to_device(self, data) -> torch.Tensor:
        """A uint8 tensor on the codec's device (host arrays are copied)."""
        if isinstance(data, torch.Tensor):
            if data.dtype != torch.uint8:
                raise TypeError(f"chunks must be uint8, got {data.dtype}")
            return data.to(self.device)
        arr = np.asarray(data, dtype=np.uint8)
        if not (arr.flags.c_contiguous and arr.flags.writeable):
            arr = np.array(arr, order="C")
        return torch.from_numpy(arr).to(self.device)

    # -- device-native bulk paths ------------------------------------------

    def encode_array(self, data, out: torch.Tensor | None = None) -> torch.Tensor:
        """(..., k, L) uint8 -> (..., m, L) parity, on the codec's device.

        Dispatches through the cached _DeviceCoder, so on CUDA this IS a
        hand kernel (SWAR for L a multiple of 128, else the packed program
        for bulk input) — the analog of the reference plugin's
        `ec_encode_data` hot call (isa/ErasureCodeIsa.cc:83-91).  `out`: a
        dead buffer of the parity's shape that the packed tier writes into
        (ignored by the other paths)."""
        mat = self.distribution_matrix()
        arr = self._to_device(data)
        if self.m == 1 and self._xor_row_available():
            record_launch(lead_stripes(arr.shape), arr.numel())
            return xor_reduce(arr)[..., None, :]
        return PLAN_CACHE.encode_coder(mat[self.k :], self.device)(arr, out=out)

    def encode_donatable(self, data_shape) -> bool:
        """True when encode_array(data, out=...) at this input shape will
        actually write into a donated parity buffer — i.e. the dispatch
        lands on the packed tier.  The EncodeAggregator gates its donation
        pool on this so it never hoards dead device memory for paths
        (xor_reduce, SWAR, xor_matmul) that ignore `out`.  The size test
        and the coder lookup come in the reference's order, so the plan
        cache counts the same hits and misses."""
        mat = self.distribution_matrix()
        if self.m == 1 and self._xor_row_available():
            return False
        if int(np.prod(data_shape)) < PACKED_MIN_BYTES:
            return False
        coder = PLAN_CACHE.encode_coder(mat[self.k :], self.device)
        return coder.tier(data_shape) == "packed"

    def decode_array(
        self, erasures: list[int], survivors, out: torch.Tensor | None = None
    ) -> torch.Tensor:
        """survivors (..., k, L) in decode_index order -> (..., nerrs, L).

        The decode twin of encode_array: dispatches through the cached
        erasure-pattern _DeviceCoder; `out` as for encode_array."""
        coder, _ = PLAN_CACHE.decode_coder(
            self.distribution_matrix(), list(erasures), self.k, self.device
        )
        return coder(self._to_device(survivors), out=out)

    def decode_donatable(self, erasures: list[int], data_shape) -> bool:
        """True when decode_array(erasures, data, out=...) at this input
        shape will actually write into a donated output buffer — the
        decode twin of encode_donatable, gating the DecodeAggregator's
        pool."""
        if int(np.prod(data_shape)) < PACKED_MIN_BYTES:
            return False
        coder, _ = PLAN_CACHE.decode_coder(
            self.distribution_matrix(), list(erasures), self.k, self.device
        )
        return coder.tier(data_shape) == "packed"

    def verify_array(self, codewords) -> torch.Tensor:
        """(..., k+m, L) uint8 codewords (data rows in encode order, then the
        stored parity rows) -> (...,) uint8 per-stripe mismatch bitmap, bit
        j set iff stored parity row j differs from the recompute.  The
        deep-scrub compare-only path: one launch of the verify kernel."""
        mat = self.distribution_matrix()
        return PLAN_CACHE.verify_coder(mat[self.k :], self.device)(
            self._to_device(codewords)
        )

    def verify_array_host(self, codewords) -> np.ndarray:
        """Byte-identical HOST oracle of verify_array (pure numpy)."""
        mat = self.distribution_matrix()
        return packed_verify_host(mat[self.k :], np.asarray(codewords, dtype=np.uint8))

    def encode_array_host(self, data) -> np.ndarray:
        """Byte-identical HOST oracle of encode_array, pure numpy: the same
        xor fast-path gate, then the packed plane program the device's
        packed tier runs (`packed_code_host`)."""
        mat = self.distribution_matrix()
        arr = np.asarray(data, dtype=np.uint8)
        if self.m == 1 and self._xor_row_available():
            return np.bitwise_xor.reduce(arr, axis=-2)[..., None, :]
        return packed_code_host(mat[self.k :], arr)

    def encode_delta_device(self, old_bufs, new_bufs, parity_bufs, chunk: int) -> torch.Tensor:
        """RMW parity delta on the device: k + k + m FLAT per-shard buffers
        (each a shard's (stripes * chunk,) bytes, as the chunk cache holds
        them) -> (stripes, m, chunk) NEW parity in one launch.  The code is
        GF(2)-linear, so parity_new = parity_old ^ Encode(old ^ new), with
        Encode the packed program of `encode_array`'s packed tier.  Counts
        one dispatch."""
        mat = self.distribution_matrix()
        bufs = [self._to_device(b) for b in (*old_bufs, *new_bufs, *parity_bufs)]
        k = self.k
        record_launch(bufs[0].numel() // int(chunk), sum(b.numel() for b in bufs))
        plan = PLAN_CACHE.encode_coder(mat[k:], self.device).packed
        return packed_delta_flat(
            plan.operand_for(bufs[0]), bufs[:k], bufs[k : 2 * k], bufs[2 * k :], int(chunk)
        )

    def encode_delta_host(self, old_data, new_data, old_parity) -> np.ndarray:
        """Byte-identical HOST oracle of encode_delta_device (pure numpy):
        (S, k, L) old/new data + (S, m, L) old parity -> (S, m, L) new
        parity."""
        mat = self.distribution_matrix()
        return packed_delta_host(mat[self.k :], old_data, new_data, old_parity)

    def decode_array_host(self, erasures: list[int], survivors) -> np.ndarray:
        """Byte-identical HOST oracle of decode_array (pure numpy), from the
        same isa_decode_matrix Gaussian the cached coder was built from.
        Plans are memoized host-side (`_HOST_DECODE_PLANS`): a recovery
        repeats one erasure pattern across many launches and must not pay
        the O(k^3) inversion each time."""
        dist = self.distribution_matrix()
        key = (dist.shape, dist.tobytes(), tuple(erasures))
        with _HOST_DECODE_LOCK:
            bm = _HOST_DECODE_PLANS.get(key)
            if bm is not None:
                _HOST_DECODE_PLANS.move_to_end(key)
        if bm is None:
            plan = isa_decode_matrix(dist, list(erasures), self.k)
            if plan is None:
                raise EcError(EIO, f"singular decode matrix for erasures {erasures}")
            bm = expand_matrix(plan[0])
            with _HOST_DECODE_LOCK:
                _HOST_DECODE_PLANS[key] = bm
                _HOST_DECODE_PLANS.move_to_end(key)
                while len(_HOST_DECODE_PLANS) > _HOST_DECODE_CAPACITY:
                    _HOST_DECODE_PLANS.popitem(last=False)
        return xor_matmul_host_batch(bm, np.asarray(survivors, dtype=np.uint8))

    def decode_index(self, erasures: list[int]) -> list[int]:
        _, idx = PLAN_CACHE.decode_plan(self.distribution_matrix(), erasures, self.k)
        return idx

    # -- chunk-level interface ---------------------------------------------

    @staticmethod
    def _as_u8(buf) -> np.ndarray:
        """Normalize one chunk buffer to uint8 without copying when
        avoidable: contiguous uint8 arrays pass through untouched, raw byte
        containers map zero-copy via frombuffer, and everything else goes
        through np.asarray."""
        if type(buf) is np.ndarray and buf.dtype == np.uint8:
            return buf
        if isinstance(buf, (bytes, bytearray, memoryview)):
            return np.frombuffer(buf, dtype=np.uint8)
        return np.asarray(buf, dtype=np.uint8)

    def _gather(self, chunks: Mapping[int, np.ndarray]) -> np.ndarray:
        """Stack the k data chunks in encode order."""
        return np.stack(
            [self._as_u8(chunks[self.chunk_index(i)]) for i in range(self.k)]
        )

    def _scatter(self, chunks: Mapping[int, np.ndarray], parity: np.ndarray) -> None:
        for i in range(self.m):
            np.copyto(chunks[self.chunk_index(self.k + i)], parity[i])

    def encode_chunks(self, chunks: dict[int, np.ndarray]) -> None:
        self._scatter(chunks, self.encode_array(self._gather(chunks)).cpu().numpy())

    def _use_xor_decode(self, erasures: list[int]) -> bool:
        """Single-erasure XOR path: first k+1 chunks + all-ones parity row 0
        (generalizes ErasureCodeIsa.cc:196-216)."""
        return (
            len(erasures) == 1
            and erasures[0] < self.k + 1
            and self._xor_row_available()
        )

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
            stack = np.stack([self._as_u8(decoded[raw_of(i)]) for i in sources])
            rec = xor_reduce(self._to_device(stack)).cpu().numpy()
            np.copyto(decoded[raw_of(erasures[0])], rec)
            return
        idx = self.decode_index(erasures)
        survivors = np.stack([self._as_u8(decoded[raw_of(i)]) for i in idx])
        rec = self.decode_array(erasures, survivors).cpu().numpy()
        for p, e in enumerate(erasures):
            np.copyto(decoded[raw_of(e)], rec[p])
