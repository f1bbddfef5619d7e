"""Scrub — mirror of src/osd/scrubber/ (PgScrubber + scrub_backend).

The port of `ceph_tpu/osd/scrubber.py`.  Reference structure:

- The primary drives a chunky scrub FSM (src/osd/scrubber/
  scrub_machine.cc): objects are scrubbed in bounded chunks, each chunk
  gathering a **scrub map** (oid → size/digest/attr digests) from every
  acting shard (MOSDRepScrub → MOSDRepScrubMap), then comparing them in
  the scrub backend (src/osd/scrubber/scrub_backend.cc
  select_auth_object / compare_smaps).
- Shallow scrub compares sizes/metadata; **deep scrub** reads the data
  and compares content digests.  For EC pools each shard's chunk digest
  is checked against the `hinfo` cumulative crc32c it persisted at write
  time (ECBackend::be_deep_scrub, ECBackend.cc:2518), and the whole
  chunk's codewords are recomputed on the device in one compare-only
  `packed_verify` launch through the backend's VerifyAggregator.
- Inconsistencies raise cluster-log errors and feed `repair`: the bad
  shard is marked missing and the standard recovery path rebuilds it.

The scrub map is JSON (the reference's wire format: a deep EC map carries
each shard's chunk bytes as base64); the comparison semantics follow the
reference.

The scrubber's host is the port's PG (`osd/pg.py`), which owns one
PgScrubber and routes MOSDRepScrub / MOSDRepScrubMap to it.  It reads
only these attributes of its host, so any object that has them serves as
well (the CPU tests' single-PG hosts):

- ``pgid`` (a PgId with ``with_shard``), ``whoami()``, ``whoami_shard()``,
  ``epoch()`` and ``acting()``;
- ``osd.store`` (the shard's ObjectStore; ``osd.cluster_log`` optional),
  ``backend`` (the ECBackend: ``ec``, ``sinfo``, ``verify_aggregator``)
  and ``pool.type``;
- ``send_scrub(osd, MOSDRepScrub)`` and ``send_scrub_reply(osd,
  MOSDRepScrubMap)``;
- ``clog_error(text)``, ``mark_shard_missing(oid, osd)`` and
  ``request_recovery(oid)`` (the host runs ``ECBackend.recover_object``);
- ``peering.osds_missing(oid)``.

Where the reference lets the digest compare "stand alone" after a verify
submit or reap that failed, the port aborts that deep scrub (``aborted``,
the error on ``clog_error``): a deep scrub whose parity verify did not run
never reports clean.
"""

from __future__ import annotations

import base64
import json
import time
from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..common.log import dout
from ..msg.messages import MOSDRepScrub, MOSDRepScrubMap
from ..os.objectstore import StoreError
from ..stripe import HashInfo
from .ec_transaction import HINFO_ATTR, OI_ATTR, ObjectInfo
from .osdmap import PG_NONE, POOL_TYPE_ERASURE
from .pg_backend import shard_coll


@dataclass
class ScrubResult:
    """Summary the reference reports via `pg <pgid> query` / clog."""

    deep: bool = False
    objects_scrubbed: int = 0
    errors: int = 0
    # oid -> {shard/osd: reason}
    inconsistent: dict[str, dict[int, str]] = field(default_factory=dict)
    repaired: int = 0
    aborted: bool = False
    # oids whose parity equation is broken but whose corrupt shard could
    # NOT be localized (every shard passed its digest-vs-hinfo check):
    # repair must not trust any shard — re-encoding parity from a
    # possibly-corrupt data shard would make the damage permanent and
    # silent, so these stay inconsistent for the operator
    unrepairable: set[str] = field(default_factory=set)

    @property
    def clean(self) -> bool:
        return self.errors == 0 and not self.aborted


CHUNK_MAX = 25  # objects per scrub chunk (osd_scrub_chunk_max)


class PgScrubber:
    """Primary-side scrub state machine for one PG (PgScrubber analog)."""

    def __init__(self, pg):
        self.pg = pg
        self._tid = 0
        self.active = False
        # in-flight chunk state
        self._maps: dict[int, dict] = {}  # osd -> scrub map (parsed)
        self._pending: set[int] = set()
        self._result: ScrubResult | None = None
        self._cursor = ""
        self._deep = False
        self._repair = False
        self._on_done: Callable[[ScrubResult], None] | None = None
        self.last_result: ScrubResult | None = None
        self._chunk_range: tuple[str, str] = ("", "")
        self._chunk_started: float = 0.0
        # client writes queued while their object's chunk is being
        # scrubbed (write_blocked_by_scrub)
        self.waiting_writes: list[Callable[[], None]] = []
        self.gather_timeout = 10.0  # seconds before an unanswered chunk aborts
        # object total snapshotted at start() so progress can render
        # done/total
        self._total_objects = 0

    # -- lifecycle guards ------------------------------------------------------

    def reset(self) -> None:
        """Interval change / abort (PgScrubber::on_new_interval): drop the
        in-flight scrub so the PG can scrub again later."""
        if not self.active:
            return
        self.active = False
        self._pending.clear()
        self._maps.clear()
        res = self._result or ScrubResult()
        res.aborted = True
        self._flush_waiting_writes()
        if self._on_done is not None:
            on_done, self._on_done = self._on_done, None
            on_done(res)

    def tick(self, now: float) -> None:
        """Abort a scrub that stopped making progress — a shard that never
        answered, or an in-flight chunk wedged by an error (a crashed
        replica or a raised compare must not disable scrubbing forever)."""
        if self.active and now - self._chunk_started > self.gather_timeout:
            dout(
                "osd", 1,
                f"pg {self.pg.pgid} scrub: no map from {sorted(self._pending)} "
                f"after {self.gather_timeout}s; aborting",
            )
            self.reset()

    def write_blocked(self, oid: str) -> bool:
        """write_blocked_by_scrub: writes to an object inside the chunk
        being gathered wait until the chunk completes, so shard maps are
        built against a stable view."""
        if not self.active:
            return False
        start, end = self._chunk_range
        return oid >= start and (not end or oid < end)

    def _flush_waiting_writes(self) -> None:
        waiting, self.waiting_writes = self.waiting_writes, []
        for cb in waiting:
            cb()

    # -- shard-side map building ----------------------------------------------

    def build_scrub_map(
        self, shard: int, deep: bool, start: str, end: str
    ) -> dict[str, dict]:
        """What one shard reports for its objects in [start, end)
        (build_scrub_map_chunk).  For EC shards the deep digest is the
        local chunk crc checked against hinfo (be_deep_scrub)."""
        from ..utils.crc32c import crc32c

        store = self.pg.osd.store
        coll = shard_coll(self.pg.pgid, shard)
        out: dict[str, dict] = {}
        try:
            oids = sorted(store.list_objects(coll))
        except StoreError:
            return out
        for oid in oids:
            if oid < start or (end and oid >= end):
                continue
            entry: dict = {"size": store.stat(coll, oid)}
            attrs = store.getattrs(coll, oid)
            if OI_ATTR in attrs:
                oi = ObjectInfo.decode(attrs[OI_ATTR])
                entry["oi_size"] = oi.size
                entry["version"] = oi.version
            if deep:
                data = store.read(coll, oid, 0, 0)
                entry["digest"] = crc32c(data, HashInfo.SEED)
                if HINFO_ATTR in attrs:
                    hinfo = HashInfo.decode(attrs[HINFO_ATTR])
                    entry["hinfo_digest"] = hinfo.get_chunk_hash(shard)
                    entry["hinfo_size"] = hinfo.get_total_chunk_size()
                    # EC deep scrub ships the shard chunk bytes to the
                    # primary: the device verify recomputes parity across
                    # all k+m shards in one compare-only launch, which the
                    # digest-vs-hinfo check alone cannot do (a shard whose
                    # hinfo was rewritten consistently with its corrupt
                    # bytes passes the digest check but breaks the parity
                    # equation).  Only for codecs that CAN consume them.
                    if self._ec_codec()[0] is not None:
                        entry["data"] = base64.b64encode(data).decode()
                else:
                    # replicated deep scrub covers omap too (be_deep_scrub
                    # omap_digest): crc over the canonical KV encoding
                    from ..common.encoding import encode_kv_map

                    try:
                        omap = store.omap_get(coll, oid)
                    except StoreError:
                        omap = {}
                    if omap:
                        entry["omap_digest"] = crc32c(
                            encode_kv_map(omap), HashInfo.SEED
                        )
            out[oid] = entry
        return out

    def handle_rep_scrub(self, msg: MOSDRepScrub) -> None:
        """Replica side: build + return our map."""
        smap = self.build_scrub_map(
            self.pg.whoami_shard(), msg.deep, msg.chunk_start, msg.chunk_end
        )
        self.pg.send_scrub_reply(
            msg.from_osd,
            MOSDRepScrubMap(
                pgid=msg.pgid,
                epoch=self.pg.epoch(),
                from_osd=self.pg.whoami(),
                scrub_tid=msg.scrub_tid,
                scrub_map=json.dumps(smap).encode(),
            ),
        )

    # -- primary FSM -----------------------------------------------------------

    def start(
        self,
        deep: bool = False,
        repair: bool = False,
        on_done: Callable[[ScrubResult], None] | None = None,
    ) -> bool:
        """Kick a scrub (PgScrubber::initiate_regular_scrub).  Returns
        False if one is already running."""
        if self.active:
            return False
        self.active = True
        self._deep = deep
        self._repair = repair
        self._on_done = on_done
        self._result = ScrubResult(deep=deep)
        self._cursor = ""
        self._total_objects = len(self._list_local())
        self._next_chunk()
        return True

    def progress(self) -> dict | None:
        """Scrub progress event for the OSD status blob.  None when no
        scrub is running."""
        if not self.active or self._result is None:
            return None
        return {
            "kind": "deep-scrub" if self._deep else "scrub",
            "objects_done": self._result.objects_scrubbed,
            "objects_total": max(
                self._total_objects, self._result.objects_scrubbed
            ),
            "bytes_done": 0,
            "bytes_total": 0,
        }

    def _next_chunk(self) -> None:
        """Select the next object range and gather maps (NewChunk state)."""
        self._tid += 1
        self._maps = {}
        self._chunk_started = time.monotonic()
        acting = self.pg.acting()
        self._pending = set()
        start = self._cursor
        # Chunk bound: Nth object past the cursor on OUR shard (all shards
        # hold the same object names for a PG, EC included).
        local = sorted(o for o in self._list_local() if o >= start)
        end = local[CHUNK_MAX] if len(local) > CHUNK_MAX else ""
        self._chunk_range = (start, end)
        for shard, osd in enumerate(acting):
            if osd == PG_NONE:
                continue
            self._pending.add(osd)
        for shard, osd in enumerate(acting):
            if osd == PG_NONE:
                continue
            msg = MOSDRepScrub(
                pgid=self.pg.pgid.with_shard(shard),
                epoch=self.pg.epoch(),
                from_osd=self.pg.whoami(),
                deep=self._deep,
                scrub_tid=self._tid,
                chunk_start=start,
                chunk_end=end,
            )
            self.pg.send_scrub(osd, msg)

    def _list_local(self) -> list[str]:
        store = self.pg.osd.store
        coll = shard_coll(self.pg.pgid, self.pg.whoami_shard())
        try:
            return store.list_objects(coll)
        except StoreError:
            return []

    def handle_scrub_map(self, msg: MOSDRepScrubMap) -> None:
        if not self.active or msg.scrub_tid != self._tid:
            return
        self._maps[msg.from_osd] = json.loads(msg.scrub_map.decode())
        self._pending.discard(msg.from_osd)
        if not self._pending:
            self._compare_chunk()

    def _compare_chunk(self) -> None:
        """scrub_backend compare_smaps over the gathered maps."""
        res = self._result
        acting = self.pg.acting()
        is_ec = self.pg.pool.type == POOL_TYPE_ERASURE
        all_oids = sorted({o for m in self._maps.values() for o in m})
        # Deep EC chunks verify parity on the device: SUBMIT the whole
        # chunk's codewords as one verify ticket first, run the host
        # metadata/digest compares while the launch is in flight, then reap
        # the bitmaps below.  A submit or reap that fails aborts the scrub.
        verify = None
        if self._deep and is_ec and all_oids:
            try:
                verify = self._submit_ec_verify(all_oids, acting)
            except Exception as e:
                self._abort_verify("submit", e)
                return
        host_bad: dict[str, dict[int, str]] = {}
        for oid in all_oids:
            res.objects_scrubbed += 1
            if is_ec:
                host_bad[oid] = self._compare_ec_object(oid, acting)
            else:
                host_bad[oid] = self._compare_replicated_object(oid, acting)
        if verify is not None:
            try:
                self._reap_ec_verify(verify, host_bad, acting)
            except Exception as e:
                self._abort_verify("reap", e)
                return
        for oid, bad in host_bad.items():
            if bad:
                res.errors += len(bad)
                res.inconsistent[oid] = bad
                self.pg.clog_error(
                    f"pg {self.pg.pgid} scrub: {oid} inconsistent on "
                    + ", ".join(f"osd.{o} ({why})" for o, why in bad.items())
                )
        start, end = self._chunk_range
        # Advance (or finish) BEFORE releasing blocked writes: a write
        # flushed while the old chunk range is still current would re-block
        # against it and strand forever on the final chunk.
        if end:
            self._cursor = end
            self._next_chunk()
        else:
            self._finish()
        self._flush_waiting_writes()

    def _abort_verify(self, stage: str, err: Exception) -> None:
        """A verify launch that failed ends this deep scrub: `aborted`, the
        error on the cluster log, no repair.  The reference lets the digest
        compare stand alone here; the port does not report a deep scrub
        whose parity verify never ran."""
        self.pg.clog_error(
            f"pg {self.pg.pgid} deep-scrub: parity verify {stage} failed "
            f"({err!r}); scrub aborted"
        )
        self.reset()

    # -- device-offloaded EC parity verify ---------------------------------------

    def _ec_codec(self):
        """The PG backend's matrix codec + stripe info, or (None, None)
        when the pool's codec has no device verify path (non-matrix
        plugins): the host digest compare then stands alone, as in the
        reference."""
        backend = getattr(self.pg, "backend", None)
        ec = getattr(backend, "ec", None)
        sinfo = getattr(backend, "sinfo", None)
        if ec is None or sinfo is None or not hasattr(ec, "verify_array"):
            return None, None
        return ec, sinfo

    def _submit_ec_verify(self, oids: list[str], acting: list[int]):
        """Stack every verifiable object's shard chunks into one
        (stripes, k+m, L) codeword batch and SUBMIT it to the backend's
        VerifyAggregator — one ticket per scrub chunk, so the whole chunk's
        parity recompute rides one compare-only launch.  Returns (ticket,
        spans, ec) or None when nothing is verifiable; spans maps oid ->
        (start, stripes) into the batch.  A failed submit raises.

        An object is verifiable when every acting shard answered with
        chunk bytes of one common length; anything else (missing shard,
        truncated shard, no hinfo) is already the host compare's business.
        Ragged final chunks zero-pad to the chunk size on data AND parity
        rows — the code is linear, encode(0) == 0, so padding preserves the
        parity equation exactly."""
        ec, sinfo = self._ec_codec()
        if ec is None:
            return None
        k, m = ec.k, ec.m
        n = k + m
        if len(acting) < n or any(osd == PG_NONE for osd in acting[:n]):
            return None
        L = sinfo.chunk_size
        raw_of = ec.chunk_index
        batches: list[np.ndarray] = []
        spans: dict[str, tuple[int, int]] = {}
        start = 0
        for oid in oids:
            rows: list[bytes] = []
            for i in range(n):
                entry = self._maps.get(acting[raw_of(i)], {}).get(oid)
                blob = entry.get("data") if entry else None
                if blob is None:
                    rows = []
                    break
                rows.append(base64.b64decode(blob))
            if not rows or len({len(r) for r in rows}) != 1 or not len(rows[0]):
                continue
            shard_len = len(rows[0])
            stripes = -(-shard_len // L)
            padded = np.zeros((n, stripes * L), dtype=np.uint8)
            for i, r in enumerate(rows):
                padded[i, :shard_len] = np.frombuffer(r, dtype=np.uint8)
            # (n, stripes*L) -> (stripes, n, L): each stripe's rows stay in
            # encode order, matching verify_array's contract
            batches.append(padded.reshape(n, stripes, L).transpose(1, 0, 2))
            spans[oid] = (start, stripes)
            start += stripes
        if not batches:
            return None
        agg = getattr(self.pg.backend, "verify_aggregator", None)
        if agg is None:
            from ..codec.matrix_codec import default_verify_aggregator

            agg = default_verify_aggregator()
        ticket = agg.submit(ec, np.ascontiguousarray(np.concatenate(batches)))
        return ticket, spans, ec

    def _reap_ec_verify(
        self,
        verify,
        host_bad: dict[str, dict[int, str]],
        acting: list[int],
    ) -> None:
        """Reap the chunk's mismatch bitmaps and merge attributions into
        the host compare's verdict.  A nonzero per-object bitmap whose
        shards all passed the digest check is the case the offload exists
        for: the parity equation is broken even though every shard is
        self-consistent — attribute the mismatched parity row(s).  A reap
        that fails (a failed launch raises EIO) raises."""
        ticket, spans, ec = verify
        bitmap = np.asarray(ticket)
        raw_of = ec.chunk_index
        for oid, (start, stripes) in spans.items():
            bits = int(np.bitwise_or.reduce(bitmap[start : start + stripes]))
            if not bits or host_bad.get(oid):
                # clean, or the digest compare already attributed the
                # corrupt shard (don't double-report one object)
                continue
            # the equation is broken but every shard passed its own digest
            # check: the bitmap proves damage, not WHICH shard.  Report it
            # on the mismatched parity row(s) for visibility, but flag the
            # object unrepairable — auto-repair re-encodes parity from the
            # data shards, and if the corrupt shard is a data shard that
            # would cement the corruption.
            self._result.unrepairable.add(oid)
            bad = host_bad.setdefault(oid, {})
            for j in range(ec.m):
                if bits >> j & 1:
                    bad[acting[raw_of(ec.k + j)]] = (
                        f"ec parity recompute mismatch (row {j}; corrupt "
                        "shard not localized — not auto-repairable)"
                    )

    def _compare_ec_object(self, oid: str, acting: list[int]) -> dict[int, str]:
        """EC comparison: every acting shard must hold the object, sized
        per hinfo (a truncated shard is as lost as an absent one), with
        consistent object-info metadata; deep adds the chunk-digest check
        against the hinfo crc persisted at write time (be_deep_scrub)."""
        bad: dict[int, str] = {}
        # Shallow metadata authority: the modal (oi_size, version) pair.
        # Ties break deterministically — highest version first, then the
        # copy held by the lowest shard — so two runs over the same maps
        # always blame the same side.
        metas_by_shard = [
            (shard, (e["oi_size"], e.get("version")))
            for shard, e in (
                (shard, self._maps.get(osd, {}).get(oid))
                for shard, osd in enumerate(acting)
                if osd != PG_NONE
            )
            if e is not None and "oi_size" in e
        ]
        counts: dict[tuple, int] = {}
        for _shard, meta in metas_by_shard:
            counts[meta] = counts.get(meta, 0) + 1
        auth_meta = None
        best_key: tuple | None = None
        for _shard, meta in sorted(metas_by_shard):
            version = meta[1] if meta[1] is not None else -1
            key = (counts[meta], version)
            if best_key is None or key > best_key:  # strict: ties keep
                best_key = key                      # the lowest shard
                auth_meta = meta
        for shard, osd in enumerate(acting):
            if osd == PG_NONE:
                continue
            entry = self._maps.get(osd, {}).get(oid)
            if entry is None:
                if not self._object_expected_missing(oid, osd):
                    bad[osd] = "missing"
                continue
            if "hinfo_size" in entry and entry.get("size") != entry["hinfo_size"]:
                bad[osd] = "shard size mismatch vs hinfo"
                continue
            if (
                auth_meta is not None
                and "oi_size" in entry
                and (entry["oi_size"], entry.get("version")) != auth_meta
            ):
                bad[osd] = "object info mismatch vs authoritative copy"
                continue
            if self._deep and "hinfo_digest" in entry:
                if entry.get("digest") != entry["hinfo_digest"]:
                    bad[osd] = "data digest mismatch vs hinfo"
        return bad

    def _compare_replicated_object(
        self, oid: str, acting: list[int]
    ) -> dict[int, str]:
        """Replicated comparison: majority digest wins (select_auth_object
        picks a trusted authoritative copy; majority is our stand-in).
        With size=2 an exact tie is undecidable; the deterministic fallback
        here (lowest-osd copy) can pick the corrupt side, as the reference
        also warns."""
        bad: dict[int, str] = {}
        entries = {
            osd: self._maps.get(osd, {}).get(oid)
            for osd in acting
            if osd != PG_NONE
        }
        digests = [
            (e.get("digest"), e.get("size"), e.get("omap_digest"))
            for osd, e in sorted(entries.items())
            if e is not None
        ]
        if not digests:
            return bad
        auth = max(dict.fromkeys(digests), key=digests.count)
        for osd, e in entries.items():
            if e is None:
                if not self._object_expected_missing(oid, osd):
                    bad[osd] = "missing"
            elif (e.get("digest"), e.get("size"), e.get("omap_digest")) != auth:
                if e.get("omap_digest") != auth[2]:
                    bad[osd] = "omap digest mismatch vs authoritative copy"
                else:
                    bad[osd] = "digest/size mismatch vs authoritative copy"
        return bad

    def _object_expected_missing(self, oid: str, osd: int) -> bool:
        """An object mid-recovery is not a scrub error."""
        return osd in self.pg.peering.osds_missing(oid)

    def _finish(self) -> None:
        res = self._result
        self.active = False
        self.last_result = res
        if self._repair and res.inconsistent:
            for oid, bad in res.inconsistent.items():
                if oid in res.unrepairable:
                    # the corrupt shard was never localized: rebuilding the
                    # flagged parity shards would re-encode from a
                    # possibly-corrupt data shard and hide the damage
                    self.pg.clog_error(
                        f"pg {self.pg.pgid} repair: {oid} parity "
                        "mismatch with no localized shard; refusing "
                        "auto-repair (restore the object from a replica "
                        "or backup)"
                    )
                    continue
                for osd in bad:
                    self.pg.mark_shard_missing(oid, osd)
                res.repaired += 1
                self.pg.request_recovery(oid)
        if res.repaired:
            # the repair side of the scrub timeline: the error entries
            # above raised it, this closes it (hosts without a cluster log
            # drop it)
            clog = getattr(
                getattr(self.pg, "osd", None), "cluster_log", None
            )
            if clog is not None:
                clog(
                    "info",
                    f"pg {self.pg.pgid} repair: {res.repaired} object(s) "
                    "re-queued for recovery (shards rebuilt)",
                    code="OSD_SCRUB_ERRORS",
                )
        dout(
            "osd",
            5,
            f"pg {self.pg.pgid} {'deep-' if res.deep else ''}scrub: "
            f"{res.objects_scrubbed} objects, {res.errors} errors",
        )
        if self._on_done is not None:
            self._on_done(res)
