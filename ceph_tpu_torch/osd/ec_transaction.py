"""ECTransaction — logical object mutation -> k+m per-shard transactions.

The port of `ceph_tpu/osd/ec_transaction.py` (Ceph's
src/osd/ECTransaction.{h,cc}).  `WritePlan`
(ECTransaction.h:26-33) captures which stripe-aligned extents must be read
(partial-stripe overwrites) and which will be written; `generate_transactions`
(ECTransaction.cc:109) turns the logical write into one ObjectStore
transaction per shard, writing each shard's chunk at
`logical_to_prev_chunk_offset(offset)` with SEQUENTIAL_WRITE|APPEND_ONLY
alloc hints (ECTransaction.cc:37-95), and appending to the per-shard
cumulative HashInfo.

Device-first delta: Ceph encodes stripe-by-stripe inside `ECUtil::encode`
(ECUtil.cc:123-162); here the whole write extent is encoded in ONE batched
device launch via stripe.encode_launch, so a 1 MiB append is a single
(stripes, k, chunk) kernel call instead of 256 4 KiB loops.

Write rules mirror the reference's pool semantics:
- Without EC overwrites, writes must be stripe-width-aligned appends (or a
  full rewrite from 0) — RADOS enforces `required_alignment = stripe_width`
  for EC pools — and HashInfo digests chain on each append.
- With FLAG_EC_OVERWRITES, arbitrary extents go through read-modify-write:
  partial stripes are read (plan.to_read), merged, re-encoded; cumulative
  hinfo can no longer be maintained and is dropped (the reference likewise
  bypasses hinfo on overwrite pools).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

import numpy as np

from ..codec.interface import EcError, ErasureCodeInterface
from ..common.errs import EINVAL
from ..os.transaction import Transaction
from ..stripe import HashInfo, StripeInfo
from ..stripe import stripe as stripe_mod

# Attr names on every shard object (reference: OI_ATTR "_", hinfo_key).
OI_ATTR = "_"
HINFO_ATTR = "hinfo_key"


@dataclass
class ObjectInfo:
    """object_info_t subset: logical size + version stamp."""

    size: int = 0
    version: int = 0

    def encode(self) -> bytes:
        return json.dumps({"size": self.size, "version": self.version}).encode()

    @classmethod
    def decode(cls, blob: bytes) -> "ObjectInfo":
        obj = json.loads(blob.decode())
        return cls(size=int(obj["size"]), version=int(obj["version"]))


@dataclass
class PGTransaction:
    """Logical mutation of one object (PGTransaction analog, the unit
    PrimaryLogPG hands to the backend)."""

    oid: str
    writes: list[tuple[int, bytes]] = field(default_factory=list)
    truncate: int | None = None
    delete: bool = False
    attrs: dict[str, bytes | None] = field(default_factory=dict)  # None = rm
    # Snapshot clone-on-write (PrimaryLogPG::make_writeable): before the
    # mutation applies, the current head is cloned to this oid — per shard
    # for EC, whole-object for replicated — atomically with the write.
    pre_clone: str | None = None
    # Extra whole-object deletions riding this txn (snap-trimmed clones).
    also_delete: list[str] = field(default_factory=list)
    # omap mutations (replicated pools only; the PG rejects omap ops on
    # EC pools with -EOPNOTSUPP as the reference does)
    omap_set: dict[str, bytes] = field(default_factory=dict)
    omap_rm: list[str] = field(default_factory=list)
    omap_clear: bool = False

    def write(self, off: int, data: bytes) -> "PGTransaction":
        self.writes.append((off, bytes(data)))
        return self


@dataclass
class WritePlan:
    """ECTransaction.h:26-33."""

    to_read: list[tuple[int, int]] = field(default_factory=list)  # stripe-aligned
    will_write: list[tuple[int, int]] = field(default_factory=list)
    new_size: int = 0
    invalidates_hinfo: bool = False


def _merge_ranges(ranges: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for off, ln in sorted(ranges):
        if out and off <= out[-1][0] + out[-1][1]:
            prev_off, prev_ln = out[-1]
            out[-1] = (prev_off, max(prev_ln, off + ln - prev_off))
        else:
            out.append((off, ln))
    return out


def get_write_plan(
    sinfo: StripeInfo,
    pgt: PGTransaction,
    obj_size: int,
    allows_overwrites: bool,
) -> WritePlan:
    """Stripe-aligned read/write sets for the mutation
    (ECTransaction get_write_plan, incl. unaligned truncate handling)."""
    plan = WritePlan(new_size=obj_size)
    sw = sinfo.stripe_width
    if pgt.delete:
        plan.new_size = 0
        return plan
    padded_size = sinfo.logical_to_next_stripe_offset(obj_size)
    write_ranges: list[tuple[int, int]] = []
    read_ranges: list[tuple[int, int]] = []
    for off, data in pgt.writes:
        end = off + len(data)
        plan.new_size = max(plan.new_size, end)
        if end == off:
            # a zero-length write changes no byte, so it reads and writes
            # no stripe; the reference plans the stripe before `off` as a
            # partial tail and reads it at a negative offset on an empty
            # object, a sub-read no shard can be sent (ROADMAP C27)
            continue
        start_aligned = sinfo.logical_to_prev_stripe_offset(off)
        end_aligned = sinfo.logical_to_next_stripe_offset(end)
        if not allows_overwrites:
            if off % sw != 0 or (off != padded_size and off != 0):
                raise EcError(
                    EINVAL,
                    f"EC pool without overwrites requires stripe-aligned "
                    f"append at {padded_size}, got offset {off}",
                )
            if off == 0 and obj_size > 0 and end_aligned < padded_size:
                # A shrinking WRITEFULL is still a full replacement when the
                # accompanying truncate discards the old tail.
                if not (pgt.truncate is not None and pgt.truncate <= end):
                    raise EcError(EINVAL, "full rewrite must cover the object")
        else:
            plan.invalidates_hinfo = True
            # Partial head/tail stripes that already exist must be read.
            for stripe_off in (start_aligned, end_aligned - sw):
                covered = off <= stripe_off and end >= stripe_off + sw
                exists = stripe_off < padded_size
                if exists and not covered:
                    read_ranges.append((stripe_off, sw))
        write_ranges.append((start_aligned, end_aligned - start_aligned))
    if pgt.truncate is not None:
        # The PG pre-resolves truncate to the sequential final size
        # (write-then-truncate caps; WRITEFULL replaces exactly).
        t = pgt.truncate
        plan.new_size = t
        if t < obj_size and t % sw != 0:
            # Unaligned truncate: the surviving partial stripe is re-encoded
            # with a zeroed tail (ECTransaction's truncate handling).
            stripe_off = sinfo.logical_to_prev_stripe_offset(t)
            read_ranges.append((stripe_off, sw))
            write_ranges.append((stripe_off, sw))
            plan.invalidates_hinfo = True
        elif t < obj_size:
            plan.invalidates_hinfo = True
    plan.to_read = _merge_ranges(read_ranges)
    plan.will_write = _merge_ranges(write_ranges)
    return plan


@dataclass
class EncodeStage:
    """A write's LAUNCHED encode: merged logical bytes (host-side, ready at
    launch — what the extent cache pins) plus one PendingEncode per
    contiguous region whose device work may still be in flight.  The
    launch/finish split is the AIO hand-off of the reference's RMW
    pipeline (ECBackend.h:536-555): the next op's reads overlap this op's
    device encode."""

    merged: dict[int, bytearray]
    pending: dict[int, "stripe_mod.PendingEncode"]

    def ready(self) -> bool:
        return all(p.ready() for p in self.pending.values())

    def launched(self) -> bool:
        """False while any region's encode still sits in an aggregation
        window (a flush, not time, will make it ready)."""
        return all(p.launched() for p in self.pending.values())


def merge_writes(
    pgt: PGTransaction,
    plan: WritePlan,
    obj_size: int,
    read_data: dict[int, bytes],
) -> dict[int, bytearray]:
    """The RMW merge: per contiguous will_write region, the committed
    pre-write bytes (read_data) overlaid with the mutation's writes,
    zero-filled past an in-region truncate.  Shared by the materialize
    path (launch_encode) and the on-device delta path
    (launch_encode_delta) so both encode exactly the same logical
    bytes."""
    merged: dict[int, bytearray] = {}
    if pgt.delete:
        return merged
    for off, ln in plan.will_write:
        buf = bytearray(ln)
        # old bytes (RMW) first
        for r_off, r_data in read_data.items():
            r_end = r_off + len(r_data)
            lo, hi = max(off, r_off), min(off + ln, r_end)
            if lo < hi:
                buf[lo - off : hi - off] = r_data[lo - r_off : hi - r_off]
        merged[off] = buf
    for w_off, w_data in pgt.writes:
        for off, buf in merged.items():
            lo, hi = max(w_off, off), min(w_off + len(w_data), off + len(buf))
            if lo < hi:
                buf[lo - off : hi - off] = w_data[lo - w_off : hi - w_off]
    if pgt.truncate is not None and pgt.truncate < obj_size:
        t = pgt.truncate
        for off, buf in merged.items():
            if off <= t < off + len(buf):
                buf[t - off :] = b"\x00" * (off + len(buf) - t)
    return merged


def launch_encode(
    pgt: PGTransaction,
    plan: WritePlan,
    sinfo: StripeInfo,
    ec: ErasureCodeInterface,
    obj_size: int,
    read_data: dict[int, bytes],
    aggregator=None,
) -> EncodeStage:
    """Merge RMW inputs with the new bytes and LAUNCH the device encodes
    (one batched launch per contiguous region) without materializing
    parity — phase one of generate_transactions.  An `aggregator` routes
    the launches through the cross-write aggregation window (ECBackend
    passes its shared EncodeAggregator; the sync composition below does
    not)."""
    merged = merge_writes(pgt, plan, obj_size, read_data)
    if pgt.delete:
        return EncodeStage(merged=merged, pending={})
    pending = {
        off: stripe_mod.encode_launch(
            sinfo, ec, bytes(merged[off]), aggregator=aggregator
        )
        for off in sorted(merged)
    }
    return EncodeStage(merged=merged, pending=pending)


def launch_encode_delta(
    pgt: PGTransaction,
    plan: WritePlan,
    sinfo: StripeInfo,
    ec: ErasureCodeInterface,
    obj_size: int,
    read_data: dict[int, bytes],
    cache,
    cache_obj,
    old_gen,
    new_gen,
) -> EncodeStage | None:
    """Phase one via the on-device RMW delta path, or None when it does
    not apply to EVERY region — mixed materialize/delta stages are not
    worth the bookkeeping, and the all-or-nothing verdict keeps the
    materialize path trivially correct (the caller invalidates the object
    and launches through `launch_encode`, dropping any half-committed
    new-generation cache entries).  A failed delta launch raises
    EcError(EIO) (stripe.encode_delta_launch)."""
    merged = merge_writes(pgt, plan, obj_size, read_data)
    if pgt.delete or not merged:
        return None
    pending: dict[int, "stripe_mod.PendingEncode"] = {}
    for off in sorted(merged):
        pend = stripe_mod.encode_delta_launch(
            sinfo, ec, bytes(merged[off]), cache, cache_obj,
            old_gen, new_gen,
            sinfo.aligned_logical_offset_to_chunk_offset(off),
        )
        if pend is None:
            return None
        pending[off] = pend
    return EncodeStage(merged=merged, pending=pending)


def finish_transactions(
    stage: EncodeStage,
    pgt: PGTransaction,
    plan: WritePlan,
    sinfo: StripeInfo,
    ec: ErasureCodeInterface,
    shard_colls: dict[int, str],
    obj_size: int,
    hinfo: HashInfo | None,
    version: int,
    chunk_cache=None,
    cache_obj=None,
    cache_generation=None,
    csum_submit=None,
) -> tuple[dict[int, Transaction], HashInfo | None, dict[int, bytes]]:
    """Phase two: materialize the launched encodes (blocking only until
    THIS op's launches finish) and build the per-shard Transactions +
    hinfo chain.  Must run in submit (tid) order per object — the hinfo
    chain consumes the materialized parity bytes.

    With ``chunk_cache``/``cache_obj``/``cache_generation`` set (the
    ECBackend passes them when the RMW delta path is armed and this op
    took the MATERIALIZE path), every region's k+m shard chunks seed the
    device cache at the write's generation, from the host bytes — the
    residency the NEXT cache-hit RMW deltas against (a delta-path op skips
    this: its launch already committed data and parity in place).

    With ``csum_submit`` set (the store advertises csum offload), each
    freshly materialized shard chunk's per-block checksums are submitted
    into the SAME offload launch window the encode was reaped in —
    ``csum_submit(chunk, chunk_off)`` returns a ticket (or None) that
    rides the shard Transaction as the write's ``csums`` hint.  As in the
    reference, the hint does not survive `Transaction.tobytes`, so a
    shard store that receives the transaction as a message computes its
    own checksums (ROADMAP §C records the dead launches)."""
    n = ec.get_chunk_count()
    txns = {s: Transaction() for s in range(n)}

    if pgt.pre_clone is not None:
        # Clone each shard's pre-write state (data + attrs incl. hinfo)
        # in the same transaction as the write — the EC shape of
        # make_writeable's clone (per-shard objects clone per-shard).
        for s, txn in txns.items():
            txn.clone(shard_colls[s], pgt.oid, pgt.pre_clone)
    for extra in pgt.also_delete:
        for s, txn in txns.items():
            txn.remove(shard_colls[s], extra)

    if pgt.delete:
        for s, txn in txns.items():
            txn.remove(shard_colls[s], pgt.oid)
        return txns, None, {}

    merged = stage.merged
    old_padded = sinfo.logical_to_next_stripe_offset(obj_size)

    # Emit per-shard chunk writes at the mapped chunk offset
    # (ECTransaction.cc:74-93), reaping each region's launch.
    region_appends: dict[int, dict[int, bytes]] = {}
    for off in sorted(merged):
        shards = stage.pending[off].result()
        chunk_off = sinfo.aligned_logical_offset_to_chunk_offset(off)
        region_appends[off] = {}
        for s in range(n):
            chunk = np.ascontiguousarray(shards[s]).tobytes()
            csums = (
                csum_submit(chunk, chunk_off)
                if csum_submit is not None
                else None
            )
            txns[s].write(
                shard_colls[s], pgt.oid, chunk_off, chunk, csums=csums
            )
            region_appends[off][s] = chunk
            if chunk_cache is not None:
                chunk_cache.put(
                    cache_obj, s, cache_generation, chunk, off=chunk_off,
                    device=ec.device,
                )

    # Cumulative hinfo: appends chain onto the existing digests; a full
    # rewrite from 0 restarts the chain (stale digests would flag every
    # subsequent read as corrupt); anything else drops hinfo.
    new_hinfo = None if plan.invalidates_hinfo else hinfo
    if not plan.invalidates_hinfo and merged:
        offs = sorted(merged)
        if obj_size == 0 or offs[0] >= old_padded:
            new_hinfo = hinfo if hinfo is not None else HashInfo(n)
        elif offs[0] == 0 and len(merged[0]) >= old_padded:
            new_hinfo = HashInfo(n)  # full rewrite: fresh chain
        else:
            new_hinfo = None
        if new_hinfo is not None:
            for off in offs:
                new_hinfo.append(new_hinfo.get_total_chunk_size(), region_appends[off])

    # Shard-object truncate for shrinking truncates (chunk-aligned tail).
    if pgt.truncate is not None and pgt.truncate < obj_size:
        shard_size = sinfo.logical_to_next_chunk_offset(pgt.truncate)
        for s, txn in txns.items():
            txn.truncate(shard_colls[s], pgt.oid, shard_size)

    oi = ObjectInfo(size=plan.new_size, version=version)
    for s, txn in txns.items():
        txn.setattr(shard_colls[s], pgt.oid, OI_ATTR, oi.encode())
        if new_hinfo is not None:
            txn.setattr(shard_colls[s], pgt.oid, HINFO_ATTR, new_hinfo.encode())
        elif hinfo is not None:
            txn.rmattr(shard_colls[s], pgt.oid, HINFO_ATTR)
        for name, val in pgt.attrs.items():
            if val is None:
                txn.rmattr(shard_colls[s], pgt.oid, name)
            else:
                txn.setattr(shard_colls[s], pgt.oid, name, val)
    return txns, new_hinfo, {off: bytes(buf) for off, buf in merged.items()}


def generate_transactions(
    pgt: PGTransaction,
    plan: WritePlan,
    sinfo: StripeInfo,
    ec: ErasureCodeInterface,
    shard_colls: dict[int, str],
    obj_size: int,
    read_data: dict[int, bytes],
    hinfo: HashInfo | None,
    version: int,
) -> tuple[dict[int, Transaction], HashInfo | None, dict[int, bytes]]:
    """Build one Transaction per shard (ECTransaction::generate_transactions,
    ECTransaction.cc:109) — the synchronous launch+finish composition.
    `read_data` maps stripe-aligned offsets from plan.to_read to their
    current logical bytes (RMW input).

    Returns (shard -> Transaction, updated hinfo or None when dropped,
    merged logical bytes per will_write range — what the extent cache pins
    so overlapping writes see exactly what was encoded)."""
    stage = launch_encode(pgt, plan, sinfo, ec, obj_size, read_data)
    return finish_transactions(
        stage, pgt, plan, sinfo, ec, shard_colls, obj_size, hinfo, version
    )
