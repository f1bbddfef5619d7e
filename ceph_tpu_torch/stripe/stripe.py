"""Stripe math + batched stripe coding — mirror of `ECUtil`.

The port of `ceph_tpu/stripe/stripe.py`'s offset algebra and its client
encode, read-decode and recovery-decode launches (Ceph's
src/osd/ECUtil.{h,cc}).
`StripeInfo` reproduces stripe_info_t's offset algebra (stripe_width = k x
chunk_size; byte B of the logical object lives in chunk (B / chunk_size) %
k of stripe B / stripe_width, ErasureCodeInterface.h:39-58).  The codec
launches replace Ceph's per-stripe hot loop (`ECUtil::encode` calling
ec->encode once per stripe, ECUtil.cc:123-162) with ONE device launch over
the whole stripe batch: the object reshapes to (stripes, k, chunk_size)
and the kernel treats stripes as the batch axis.

What changes for CUDA: a direct (unaggregated) launch returns a CUDA
tensor, which has neither the jax array's `is_ready` nor `__array__`.  The
pending handle records `offload_runtime.completion_event` at launch,
polls that event in `ready()` and copies with `.cpu()` in `result()`; it
never synchronizes the device, so a launch overlaps the commits of the
writes before it.  An aggregator ticket keeps its own event.

The device chunk cache (ops/device_cache.py) serves a repeated
reconstruction with one D2H copy and no launch, and the RMW delta launch
(`encode_delta_launch`) updates cached parity on the device.  Where the
reference falls back to the materialize path after a delta launch that
FAILED, the port fails the write: a fault raises EcError(EIO).
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from ..codec.interface import EcError, ErasureCodeInterface
from ..codec.matrix_codec import MatrixCodecMixin
from ..common.errs import EINVAL, EIO
from ..ops.offload_runtime import completion_event


def _matrix_fast_path(ec: ErasureCodeInterface) -> bool:
    """Single-launch device path applies to matrix codecs whose raw chunk
    order is the logical order (no `mapping=` remap); remapped codecs go
    through their own chunk-level interface, which is mapping-aware."""
    return isinstance(ec, MatrixCodecMixin) and not ec.get_chunk_mapping()


def _launch_event(handle):
    """The completion event of a direct launch's CUDA tensor, recorded on
    the launching thread's current stream; None for a ticket (it keeps
    its own) or a CPU tensor (computed when its dispatch returned)."""
    return completion_event(handle) if isinstance(handle, torch.Tensor) else None


def _handle_ready(handle, event) -> bool:
    if isinstance(handle, torch.Tensor):
        return True if event is None else bool(event.query())
    is_ready = getattr(handle, "is_ready", None)
    return True if is_ready is None else bool(is_ready())


def _to_host(handle) -> np.ndarray:
    """Materialize a launch's output as host bytes: a device tensor by
    `.cpu()` (a copy on the current stream, ordered after the launch), a
    ticket or array through `np.asarray`."""
    if isinstance(handle, torch.Tensor):
        return handle.cpu().numpy()
    return np.asarray(handle)


class StripeInfo:
    """stripe_info_t: logical <-> chunk offset algebra (ECUtil.h:27-80)."""

    def __init__(self, stripe_width: int, chunk_size: int):
        assert stripe_width % chunk_size == 0
        self.stripe_width = stripe_width
        self.chunk_size = chunk_size
        self.k = stripe_width // chunk_size

    def logical_to_prev_chunk_offset(self, offset: int) -> int:
        return (offset // self.stripe_width) * self.chunk_size

    def logical_to_next_chunk_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.chunk_size

    def logical_to_prev_stripe_offset(self, offset: int) -> int:
        return offset - offset % self.stripe_width

    def logical_to_next_stripe_offset(self, offset: int) -> int:
        return -(-offset // self.stripe_width) * self.stripe_width

    def aligned_logical_offset_to_chunk_offset(self, offset: int) -> int:
        assert offset % self.stripe_width == 0
        return (offset // self.stripe_width) * self.chunk_size

    def aligned_chunk_offset_to_logical_offset(self, offset: int) -> int:
        assert offset % self.chunk_size == 0
        return (offset // self.chunk_size) * self.stripe_width

    def offset_len_to_stripe_bounds(self, offset: int, length: int) -> tuple[int, int]:
        """Smallest stripe-aligned (offset, length) covering the range."""
        start = self.logical_to_prev_stripe_offset(offset)
        end = self.logical_to_next_stripe_offset(offset + length)
        return start, end - start

    def logical_to_chunk_position(self, offset: int) -> tuple[int, int, int]:
        """(stripe index, chunk index within stripe, offset within chunk)."""
        stripe, within = divmod(offset, self.stripe_width)
        chunk, off = divmod(within, self.chunk_size)
        return stripe, chunk, off


class PendingEncode:
    """A LAUNCHED stripe encode whose device work may still be running.

    On the matrix fast path the parity is a live CUDA tensor (the launch
    returned while the card works) or an aggregator ticket; `ready()`
    polls completion without blocking and `result()` materializes the
    per-shard chunk dict, blocking only until this launch finishes.  This
    is the device-side half of the AIO-style encode pipeline the reference
    gets from queued librados AIO in front of `ec_encode_data`
    (ECBackend.h:536-555 pipeline invariants)."""

    def __init__(self, shaped: np.ndarray, parity, k: int, m: int, want: set[int]):
        self._shaped = shaped
        self._parity = parity  # device tensor or ticket (fast path), or None
        self._event = _launch_event(parity)
        self._k, self._m = k, m
        self._want = want
        self._result: dict[int, np.ndarray] | None = None
        # the span active at LAUNCH time (codec/tracing.py active_span);
        # the reap may run from an event-loop callback with no scope, so
        # the D2H side must remember where it belongs in the trace
        from ..codec.tracing import active_span

        self._span = active_span()

    def ready(self) -> bool:
        if self._result is not None:
            return True
        return _handle_ready(self._parity, self._event)

    def launched(self) -> bool:
        """False while the parity sits in an EncodeAggregator window (the
        device hasn't been asked yet — only a flush will make it ready).
        Plain device tensors are launched by construction."""
        if self._result is not None:
            return True
        return bool(getattr(self._parity, "launched", True))

    def result(self) -> dict[int, np.ndarray]:
        if self._result is None:
            from ..codec.tracing import wait_span

            with wait_span(self._span):
                try:
                    parity = _to_host(self._parity)  # blocks until launch done
                except EcError:
                    raise
                except Exception as e:
                    # a direct launch's device error (the delta path's,
                    # which no aggregator settles) fails the write with EIO
                    # and marks the backend DEGRADED, as a failed
                    # aggregated launch does
                    from ..ops.guard import device_guard

                    device_guard().mark_degraded(f"encode reap failed: {e!r}")
                    raise EcError(EIO, f"encode launch failed: {e!r}") from e
            self._span = None
            out: dict[int, np.ndarray] = {}
            for i in range(self._k):
                out[i] = np.ascontiguousarray(self._shaped[:, i, :]).reshape(-1)
            for i in range(self._m):
                out[self._k + i] = np.ascontiguousarray(parity[:, i, :]).reshape(-1)
            self._result = {i: out[i] for i in self._want}
            self._parity = self._shaped = self._event = None
        return self._result


def encode_launch(
    sinfo: StripeInfo,
    ec: ErasureCodeInterface,
    data: bytes | np.ndarray,
    want: set[int] | None = None,
    aggregator=None,
) -> PendingEncode:
    """Launch a batched stripe encode WITHOUT materializing the parity.

    Matrix codecs dispatch one device launch and return immediately with a
    live handle; layered/array codecs (lrc, clay) compute eagerly (their
    chunk-level interfaces materialize internally) and the PendingEncode is
    born ready.

    With an `aggregator` (codec.matrix_codec.EncodeAggregator), the stripe
    batch is SUBMITTED instead of launched: concurrent small encodes from
    different writes coalesce into one padded device dispatch when the
    aggregation window fills or a barrier flushes (the PendingEncode's
    handle is the aggregator ticket, same poll/materialize surface)."""
    raw = np.frombuffer(data, dtype=np.uint8) if isinstance(data, (bytes, bytearray)) else np.asarray(data, dtype=np.uint8).ravel()
    if raw.size % sinfo.stripe_width:
        raise EcError(EINVAL, f"length {raw.size} not stripe aligned")
    k = ec.get_data_chunk_count()
    n = ec.get_chunk_count()
    m = n - k
    assert k == sinfo.k
    stripes = raw.size // sinfo.stripe_width
    shaped = raw.reshape(stripes, k, sinfo.chunk_size)
    if want is None:
        want = set(range(n))
    if _matrix_fast_path(ec) and m > 0:
        if aggregator is not None:
            return PendingEncode(shaped, aggregator.submit(ec, shaped), k, m, want)
        return PendingEncode(shaped, ec.encode_array(shaped), k, m, want)
    shards = [np.empty((stripes, sinfo.chunk_size), dtype=np.uint8) for _ in range(n)]
    for s in range(stripes):
        chunks = ec.encode(set(range(n)), shaped[s].reshape(-1))
        for i in range(n):
            shards[i][s] = chunks[i]
    pend = PendingEncode(shaped, None, 0, 0, want)
    pend._result = {i: shards[i].reshape(-1) for i in want}
    return pend


def encode(
    sinfo: StripeInfo,
    ec: ErasureCodeInterface,
    data: bytes | np.ndarray,
    want: set[int] | None = None,
) -> dict[int, np.ndarray]:
    """Batched stripe encode: object -> per-shard concatenated chunks.

    `data` length must be a multiple of stripe_width (the caller pads, as
    ECTransaction does before encode_and_write).  Matrix codecs take the
    single-launch path; layered/array codecs (lrc, clay) fall back to
    per-stripe encode_chunks, still one python loop over stripes but device
    work batched inside each codec.
    """
    return encode_launch(sinfo, ec, data, want).result()


def encode_delta_launch(
    sinfo: StripeInfo,
    ec: ErasureCodeInterface,
    data: bytes | np.ndarray,
    cache,
    cache_obj,
    old_gen,
    new_gen,
    cache_off: int,
    want: set[int] | None = None,
) -> PendingEncode | None:
    """RMW encode via the on-device delta path, or None when the path does
    not apply — the caller then encodes on the materialize path
    (``encode_launch``), which is byte-identical by construction (the same
    plane program on both paths).

    Applies when the device chunk cache holds EVERY shard of the region —
    the k pre-write data chunks AND the m parity chunks — at the op's
    pre-write generation ``old_gen``.  Then:

    - the NEW data chunks commit to the cache at ``new_gen`` (the only
      host bytes that move; counted as cache insertions, and the next
      RMW's read leg wants them resident anyway),
    - ONE launch of ``packed_delta`` computes parity_new = parity_old ^
      Encode(data_old ^ data_new) on the device
      (MatrixCodecMixin.encode_delta_device),
    - the new parity replaces the cached parity at ``new_gen``
      (DeviceChunkCache.replace — no copy from the host),
    - and the committed flight record (group ``#delta``, flags ``delta``
      + ``cache_hit``) shows h2d_s == 0 and d2h_s == 0: the launch itself
      staged nothing through the host.

    None (the materialize path) for a miss, a disabled cache, a put the
    cache refuses, or a DEGRADED backend.  A FAULT — the ``codec.launch``
    fault point, a DeviceTimeout, a CUDA error, a put that failed — raises
    EcError(EIO): the write fails, and is not encoded again on the
    materialize path.  A fault of the device marks the backend DEGRADED,
    which clears the cache."""
    if cache is None or old_gen is None or new_gen is None:
        return None
    raw = (
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray))
        else np.asarray(data, dtype=np.uint8).ravel()
    )
    if raw.size % sinfo.stripe_width:
        return None
    k = ec.get_data_chunk_count()
    n = ec.get_chunk_count()
    m = n - k
    if not (_matrix_fast_path(ec) and m > 0) or k != sinfo.k:
        return None
    from ..ops.guard import device_guard

    if device_guard().degraded:
        return None
    stripes = raw.size // sinfo.stripe_width
    shard_len = stripes * sinfo.chunk_size
    shaped = raw.reshape(stripes, k, sinfo.chunk_size)
    if want is None:
        want = set(range(n))
    resident = cache.get_resident_many(
        cache_obj, range(n), old_gen, off=cache_off, length=shard_len
    )
    if resident is None:
        return None
    import time

    from ..common.fault_injector import faultpoint
    from ..ops.flight_recorder import flight_recorder, new_record

    def _fit(buf):
        return buf[:shard_len] if int(buf.numel()) > shard_len else buf

    fr = flight_recorder()
    rec = new_record(
        "encode", group="#delta", tickets=1, stripes=stripes,
        batch=stripes, nbytes=raw.size,
    )
    rec["flags"]["delta"] = True
    rec["flags"]["cache_hit"] = True
    try:
        with fr.active_scope(rec):
            # commit the new data chunks first: their device buffers are
            # operands of the launch.  A put the cache refuses takes the
            # materialize path; one that fails raises (strict)
            new_bufs = []
            for i in range(k):
                if not cache.put(
                    cache_obj, i, new_gen, shaped[:, i, :], off=cache_off,
                    device=ec.device, strict=True,
                ):
                    return None
                buf = cache.get(cache_obj, i, new_gen, off=cache_off)
                if buf is None:
                    return None
                new_bufs.append(_fit(buf))
            t0 = time.monotonic()
            rec["dispatch_ts"] = t0
            faultpoint("codec.launch")
            parity = device_guard().call(
                lambda: ec.encode_delta_device(
                    [_fit(resident[i]) for i in range(k)],
                    new_bufs,
                    [_fit(resident[k + i]) for i in range(m)],
                    sinfo.chunk_size,
                ),
                what="delta dispatch",
            )
            # the generation bumps in place: the delta output never leaves
            # the device — each parity row re-enters the cache at new_gen
            # with no copy from the host (the next cache-hit RMW deltas
            # again)
            for i in range(m):
                cache.replace(
                    cache_obj, k + i, new_gen,
                    parity[:, i, :].reshape(-1), off=cache_off,
                )
            # the dispatch is async: kernel_s is the synchronous enqueue
            # slice; h2d_s and d2h_s stay 0 — this launch staged nothing
            rec["kernel_s"] = time.monotonic() - t0
            rec["complete_ts"] = time.monotonic()
            fr.commit(rec)
            return PendingEncode(shaped, parity, k, m, want)
    except Exception as e:
        # no fallback: a delta launch that failed fails its write (the
        # reference re-encodes on the materialize path).  The failure is
        # on the timeline; one that is the device's (not the inputs', as
        # the aggregators judge it) marks DEGRADED, which clears the cache
        rec["flags"]["error"] = True
        fr.commit(rec)
        if not isinstance(e, (ValueError, TypeError, EcError)):
            device_guard().mark_degraded(f"delta dispatch failed: {e!r}")
        raise EcError(EIO, f"delta encode launch failed: {e!r}") from e


class PendingDecode:
    """A LAUNCHED (or aggregator-windowed) batched stripe decode whose
    device work may still be running — the decode twin of PendingEncode.

    `handle` is a live device tensor or a DecodeAggregator ticket;
    `assemble(rec)` turns the materialized (stripes, nerrs, chunk) rows
    into the caller's result shape.  Codecs without a device fast path
    decode eagerly and the PendingDecode is born ready (`result=`)."""

    def __init__(self, handle, assemble, result=None):
        self._handle = handle
        self._assemble = assemble
        self._result = result
        self._event = _launch_event(handle)
        # the span active at LAUNCH time, so a reap from an event-loop
        # callback attributes its wait to the right place in the trace
        from ..codec.tracing import active_span

        self._span = active_span() if handle is not None else None

    def ready(self) -> bool:
        if self._result is not None:
            return True
        return _handle_ready(self._handle, self._event)

    def launched(self) -> bool:
        """False while the decode still sits in a DecodeAggregator window
        (only a flush will make it ready)."""
        if self._result is not None:
            return True
        return bool(getattr(self._handle, "launched", True))

    def result(self):
        if self._result is None:
            from ..codec.tracing import wait_span

            with wait_span(self._span):
                rec = _to_host(self._handle)  # blocks until launch done
            self._result = self._assemble(rec)
            self._handle = self._assemble = self._span = self._event = None
        return self._result


def _cache_on(chunk_cache, cache_key) -> bool:
    return (
        chunk_cache is not None
        and chunk_cache.enabled
        and cache_key is not None
        and cache_key[1] is not None
    )


def decode_concat_launch(
    sinfo: StripeInfo,
    ec: ErasureCodeInterface,
    shards: Mapping[int, np.ndarray],
    aggregator=None,
    chunk_cache=None,
    cache_key: tuple | None = None,
    cache_off: int = 0,
) -> PendingDecode:
    """Launch a batched client-read decode WITHOUT materializing the
    reconstruction; resolves to the logical bytes.  With an `aggregator`
    (codec.matrix_codec.DecodeAggregator) the survivor batch is SUBMITTED
    instead of launched, so concurrent same-erasure-pattern degraded
    reads coalesce into one padded device dispatch.

    With a `chunk_cache` (ops/device_cache.DeviceChunkCache) and a
    `cache_key` = (object token, generation), the missing data chunks are
    consulted on the device FIRST — a full hit serves the reconstruction
    with one D2H copy and NO launch, NO H2D — and a miss's reconstructed
    rows are cached at materialize time for the next read of the same
    generation."""
    lengths = {len(v) for v in shards.values()}
    if len(lengths) != 1:
        raise EcError(EINVAL, "shards must have equal length")
    shard_len = lengths.pop()
    if shard_len % sinfo.chunk_size:
        raise EcError(EINVAL, f"shard length {shard_len} not chunk aligned")
    stripes = shard_len // sinfo.chunk_size
    k = ec.get_data_chunk_count()
    n = ec.get_chunk_count()
    have = {
        i: np.asarray(v, dtype=np.uint8).reshape(stripes, sinfo.chunk_size)
        for i, v in shards.items()
    }
    # Logical data chunk i lives at raw position chunk_index(i).
    chunk_index = getattr(ec, "chunk_index", lambda i: i)
    data_raw = [chunk_index(i) for i in range(k)]
    data = np.empty((stripes, k, sinfo.chunk_size), dtype=np.uint8)
    missing_raw = [r for r in data_raw if r not in have]
    for i, r in enumerate(data_raw):
        if r in have:
            data[:, i, :] = have[r]
    if not missing_raw:
        return PendingDecode(None, None, result=data.reshape(-1))
    use_cache = _cache_on(chunk_cache, cache_key)
    if use_cache:
        cached = chunk_cache.fetch_many(
            cache_key[0], missing_raw, cache_key[1], off=cache_off,
            length=shard_len, kind="decode", stripes=stripes,
        )
        if cached is not None:
            for i, r in enumerate(data_raw):
                if r not in have:
                    data[:, i, :] = cached[r][:shard_len].reshape(
                        stripes, sinfo.chunk_size
                    )
            return PendingDecode(None, None, result=data.reshape(-1))
    # The decode plan needs the full erasure set (every shard we don't
    # have), not just the wanted data shards.
    erasures = [i for i in range(n) if i not in have]
    if _matrix_fast_path(ec):
        idx = ec.decode_index(erasures)
        if any(i not in have for i in idx):
            raise EcError(EIO, f"missing survivor shards {idx}")
        survivors = np.stack([have[i] for i in idx], axis=1)  # (S, k, cs)
        if aggregator is not None:
            handle = aggregator.submit(ec, erasures, survivors)
        else:
            handle = ec.decode_array(erasures, survivors)

        def _assemble(rec: np.ndarray) -> np.ndarray:
            if use_cache:
                # cache every reconstructed row (data AND parity) so the
                # next same-generation degraded read / recovery decode of
                # this object skips its H2D leg entirely
                for p, e in enumerate(erasures):
                    chunk_cache.put(
                        cache_key[0], e, cache_key[1],
                        rec[:, p, :], off=cache_off, device=ec.device,
                    )
            for p, e in enumerate(erasures):
                if e < k:
                    data[:, e, :] = rec[:, p, :]
            return data.reshape(-1)

        return PendingDecode(handle, _assemble)
    for s in range(stripes):
        decoded = ec.decode(
            set(missing_raw), {i: buf[s] for i, buf in have.items()}
        )
        for i, r in enumerate(data_raw):
            if r in decoded:
                data[s, i, :] = decoded[r]
    return PendingDecode(None, None, result=data.reshape(-1))


def decode_concat(
    sinfo: StripeInfo,
    ec: ErasureCodeInterface,
    shards: Mapping[int, np.ndarray],
) -> np.ndarray:
    """Batched client-read decode: per-shard chunk streams -> logical bytes
    (mirror of ECUtil::decode's concat overload, ECUtil.cc:12-48)."""
    return decode_concat_launch(sinfo, ec, shards).result()


def decode_shards_launch(
    sinfo: StripeInfo,
    ec: ErasureCodeInterface,
    shards: Mapping[int, np.ndarray],
    need: set[int],
    aggregator=None,
    chunk_cache=None,
    cache_key: tuple | None = None,
) -> PendingDecode:
    """Launch a recovery decode WITHOUT materializing the rebuilt shards;
    resolves to {shard: stream} for `need`.  Matrix codecs take one batched
    launch: with an `aggregator` the survivor batch is SUBMITTED, so
    per-object decodes during recovery and backfill — where ONE erasure
    pattern repeats across every object in the PG — coalesce into one
    padded device launch when the window fills or a barrier flushes
    (ECBackend.flush_decodes / any ticket reap).  Other codecs (jerasure's
    bit-matrix techniques, LRC, CLAY read whole) decode stripe by stripe
    through `ec.decode`, eagerly, and the PendingDecode is born ready.
    With a `chunk_cache` and a `cache_key` the missing shards are consulted
    on the device first (whole shards, offset 0), and a launch's rebuilt
    rows are cached, as in `decode_concat_launch`."""
    lengths = {len(v) for v in shards.values()}
    if len(lengths) != 1:
        raise EcError(EINVAL, "shards must have equal length")
    shard_len = lengths.pop()
    stripes = shard_len // sinfo.chunk_size
    have = {
        i: np.asarray(v, dtype=np.uint8).reshape(stripes, sinfo.chunk_size)
        for i, v in shards.items()
    }
    missing = sorted(i for i in need if i not in have)
    out = {i: have[i].reshape(-1) for i in need if i in have}
    if not missing:
        return PendingDecode(None, None, result=out)
    use_cache = _cache_on(chunk_cache, cache_key)
    if use_cache:
        # whole-shard consult (off 0): a recovery decode right after a
        # full-extent degraded read of the same generation rides the cache
        cached = chunk_cache.fetch_many(
            cache_key[0], missing, cache_key[1], off=0, length=shard_len,
            kind="decode", stripes=stripes,
        )
        if cached is not None:
            for e in missing:
                out[e] = cached[e][:shard_len]
            return PendingDecode(None, None, result=out)
    if _matrix_fast_path(ec):
        erasures = [i for i in range(ec.get_chunk_count()) if i not in have]
        idx = ec.decode_index(erasures)
        if any(i not in have for i in idx):
            raise EcError(EIO, f"missing survivor shards {idx}")
        survivors = np.stack([have[i] for i in idx], axis=1)
        if aggregator is not None:
            handle = aggregator.submit(ec, erasures, survivors)
        else:
            handle = ec.decode_array(erasures, survivors)

        def _assemble(rec: np.ndarray) -> dict[int, np.ndarray]:
            if use_cache:
                for p, e in enumerate(erasures):
                    chunk_cache.put(
                        cache_key[0], e, cache_key[1],
                        rec[:, p, :], off=0, device=ec.device,
                    )
            for p, e in enumerate(erasures):
                if e in need:
                    out[e] = np.ascontiguousarray(rec[:, p, :]).reshape(-1)
            return out

        return PendingDecode(handle, _assemble)
    rebuilt = {e: np.empty((stripes, sinfo.chunk_size), dtype=np.uint8) for e in missing}
    for s in range(stripes):
        decoded = ec.decode(
            set(missing), {i: buf[s] for i, buf in have.items()}
        )
        for e in missing:
            rebuilt[e][s] = decoded[e]
    for e in missing:
        out[e] = rebuilt[e].reshape(-1)
    return PendingDecode(None, None, result=out)


def decode_shards(
    sinfo: StripeInfo,
    ec: ErasureCodeInterface,
    shards: Mapping[int, np.ndarray],
    need: set[int],
) -> dict[int, np.ndarray]:
    """Recovery decode: rebuild whole target shards (data or parity) from
    surviving shard streams (ECUtil::decode's per-shard overload,
    ECUtil.cc:50-121)."""
    return decode_shards_launch(sinfo, ec, shards, need).result()
