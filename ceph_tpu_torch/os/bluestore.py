"""BlueStore-lite — block-oriented object store: allocator + WAL + checksums.

The port's copy of `ceph_tpu/os/bluestore.py`: the same block file, KV
records and onode encoding, so a store written by either package mounts in
the other.  What differs: the checksum and compressor offloads run on a
device (`device`, None: cuda, resolved at the first launch; a store that
offloads nothing never touches it), and a failed or refused offload launch
fails the transaction or read that needed it with EcError(EIO) instead of
being recomputed on the host (ROADMAP fault C8).

The re-design of Ceph's production storage engine
(src/os/bluestore/BlueStore.cc; 19.6k LoC there, scoped
here to the triad that defines the design):

- **Raw block space + extent allocator.**  Object data lives in a single
  flat block file carved into `BLOCK` (4 KiB) units handed out by a
  bitmap allocator (src/os/bluestore/BitmapAllocator.h).  There is no
  per-object file: an object is an onode (metadata record in the KV DB)
  pointing at physical extents.  The free list is rebuilt at mount by
  scanning onodes + pending WAL — the authoritative-metadata recovery
  BlueStore's FreelistManager formalizes.
- **Two write paths** (BlueStore::_do_write big/small split):
  *COW direct* — writes that allocate (new blocks, or large overwrites)
  go to freshly allocated blocks, fsync'd BEFORE the metadata commit;
  a crash leaves the new blocks unreferenced and the old state intact.
  *Deferred WAL* — small overwrites of already-allocated blocks ride the
  metadata commit as WAL records (bluestore_deferred_transaction_t) and
  are applied to the block file after commit; mount replays unapplied
  records (idempotent whole-slot images — BLOCK bytes raw, or the
  block's clen-byte compressed form).
- **Per-block checksums** (BlueStore csum_type=crc32c, per csum-block):
  every stored block carries a crc32c in the onode extent map computed
  over the STORED form (compressed or raw), verified on every read
  before any decompression; a flipped bit in the block file surfaces
  as EIO instead of silent corruption.
- **Blob compression** (BlueStore _do_alloc_write compression): with
  bluestore_compression_algorithm set, a block image is stored
  compressed when it beats bluestore_compression_required_ratio; the
  onode entry records the stored length.
- **Metadata in the KV DB** (RocksDB in Ceph, FileKV here):
  onodes, collections, and WAL records commit in ONE atomic batch
  (KeyValueDB::Transaction) — the transaction's commit point.

Logical layout: block index `i` of an object maps to one physical block
slot; the in-memory map is {block_index: (phys_off, crc, clen)} — clen 0
for a raw BLOCK, else the compressed stored length — and serializes as
runs.  Every write replaces a block's WHOLE stored image (read-modify-
write at block granularity), so WAL replay needs no byte-level merging.
Bytes at logical offsets >= the object size are undefined-on-disk but
never observable: reads clamp to size and overlays treat them as zeros
(hole semantics).
"""

from __future__ import annotations

import json
import os
import struct
from dataclasses import dataclass, field

from ..utils.crc32c import crc32c
from .kv import FileKV, KeyValueDB, MemKV
from .objectstore import ObjectStore, StoreError
from .transaction import OP_WRITE, Transaction

BLOCK = 4096
# Overwrites up to this many bytes take the deferred-WAL path
# (bluestore_prefer_deferred_size).
DEFERRED_MAX = 64 * 1024
# Initial block-file capacity; grows on demand (Ceph sizes the
# device up front; a dev-store grows like BlueStore-on-file).
INITIAL_BLOCKS = 1024

_ONODE = "O"  # onode records:      key "<coll>\x00<oid>"
_COLL = "C"   # collection markers: key "<coll>"
_WAL = "W"    # deferred writes:    key "<seq:016x>", value u64 poff + image


class SimulatedCrash(RuntimeError):
    """Raised by the crash-injection test seam (_crash_point)."""


@dataclass
class Onode:
    size: int = 0
    # logical block index -> (physical byte offset, crc32c of STORED
    # bytes, stored length).  clen == 0 means a raw BLOCK; clen > 0 means
    # the slot holds clen bytes compressed with the store's algorithm
    # (BlueStore blob compression, scoped to one block per blob).
    blocks: dict[int, tuple[int, int, int]] = field(default_factory=dict)
    xattrs: dict[str, bytes] = field(default_factory=dict)
    omap: dict[str, bytes] = field(default_factory=dict)

    def encode(self) -> bytes:
        runs = []
        for bidx in sorted(self.blocks):
            poff, crc, clen = self.blocks[bidx]
            if runs and runs[-1][0] + len(runs[-1][2]) == bidx and runs[-1][1] + len(
                runs[-1][2]
            ) * BLOCK == poff:
                runs[-1][2].append(crc)
                runs[-1][3].append(clen)
            else:
                runs.append([bidx, poff, [crc], [clen]])
        return json.dumps(
            {
                "size": self.size,
                "runs": runs,
                "xattrs": {k: v.hex() for k, v in self.xattrs.items()},
                "omap": {k: v.hex() for k, v in self.omap.items()},
            }
        ).encode()

    @classmethod
    def decode(cls, blob: bytes) -> "Onode":
        info = json.loads(blob.decode())
        o = cls(size=info["size"])
        for run in info["runs"]:
            bidx, poff, crcs = run[0], run[1], run[2]
            clens = run[3] if len(run) > 3 else [0] * len(crcs)
            for i, crc in enumerate(crcs):
                o.blocks[bidx + i] = (poff + i * BLOCK, crc, clens[i])
        o.xattrs = {k: bytes.fromhex(v) for k, v in info["xattrs"].items()}
        o.omap = {k: bytes.fromhex(v) for k, v in info["omap"].items()}
        return o


class BitmapAllocator:
    """Free-block bitmap (BitmapAllocator): first-fit run allocation."""

    def __init__(self, n_blocks: int):
        self.free = [True] * n_blocks
        self._hint = 0

    def grow(self, n_blocks: int) -> None:
        self.free.extend([True] * n_blocks)

    def mark_used(self, block: int) -> None:
        while block >= len(self.free):  # device grown by a previous life
            self.grow(INITIAL_BLOCKS)
        self.free[block] = False

    def release(self, block: int) -> None:
        self.free[block] = True
        self._hint = min(self._hint, block)

    def allocate(self, count: int) -> list[int] | None:
        """`count` block indices (not necessarily contiguous), or None."""
        out = []
        i = self._hint
        n = len(self.free)
        scanned_from_start = self._hint == 0
        while len(out) < count:
            if i >= n:
                if scanned_from_start:
                    return None
                i, n = 0, self._hint  # wrap to the region before the hint
                scanned_from_start = True
                continue
            if self.free[i]:
                out.append(i)
            i += 1
        for b in out:
            self.free[b] = False
        self._hint = out[-1] + 1 if out else self._hint
        return out

    def num_free(self) -> int:
        return sum(self.free)


def make_store(conf, device=None) -> ObjectStore:
    """Instantiate the configured backend (`osd_objectstore` +
    `osd_data`), the ceph-osd --mkfs/boot store selection.  `conf` is any
    mapping with `.get`; `device` is where a BlueStore's offloads run."""
    from .filestore import FileStore
    from .memstore import MemStore

    kind = conf.get("osd_objectstore")
    data = conf.get("osd_data")
    if kind == "bluestore":
        return BlueStore(
            data or None,
            compression=conf.get("bluestore_compression_algorithm"),
            compression_required_ratio=conf.get(
                "bluestore_compression_required_ratio"
            ),
            csum_offload=bool(conf.get("bluestore_csum_offload")),
            device=device,
        )
    if kind == "filestore":
        if not data:
            raise ValueError("filestore requires osd_data")
        return FileStore(data)
    return MemStore()


class BlueStore(ObjectStore):
    """dir/ holds `block` (flat data file) and `kv` (FileKV metadata)."""

    def __init__(
        self,
        path: str | None = None,
        compression: str = "none",
        compression_required_ratio: float = 0.875,
        csum_offload: bool = False,
        device=None,
    ):
        from ..compressor import get_compressor

        self.path = path
        # blob compression (BlueStore _do_alloc_write compression path):
        # a block is stored compressed only when it shrinks below the
        # required ratio; csums always cover the stored form
        self._compressor = get_compressor(compression or "none")
        self._required_ratio = compression_required_ratio
        # device checksum offload (bluestore_csum_offload): large writes
        # and read-verify sweeps batch their per-block crc32c through the
        # shared offload runtime instead of the host table loop
        self._csum_offload = bool(csum_offload)
        # where the checksum and compressor offloads launch (None: cuda)
        self._device = device
        # identical-content overwrites whose stored form was provably
        # unchanged (store-form + csum + block write all elided)
        self.csum_compute_skips = 0
        # blocks whose stored csum came from an EC-transaction-fused
        # digest (computed in the encode's launch window, not here)
        self.csum_fused_blocks = 0
        self.db: KeyValueDB = MemKV() if path is None else None  # set at mount
        self._block_f = None
        self.alloc = BitmapAllocator(INITIAL_BLOCKS)
        self._onodes: dict[tuple[str, str], Onode] = {}  # cache (loaded lazily)
        self._colls: set[str] = set()
        self._obj_count: dict[str, int] = {}
        self._wal_seq = 0
        # per-transaction staging
        self._batch: list[tuple[int, str, str, bytes]] = []
        self._dirty: set[tuple[str, str]] = set()
        self._direct: list[tuple[int, bytes]] = []   # (poff, image) pre-commit
        self._deferred: list[tuple[int, bytes]] = [] # (poff, image) post-commit
        # staged images readable before they hit the block file (so e.g. a
        # clone after a write in the same transaction sees the new bytes)
        self._staged: dict[int, bytes] = {}
        # frees take effect only after the commit point: a failed staging
        # must never let a still-referenced block be re-allocated
        self._to_release: list[int] = []
        # objects deleted in the staged txn: their (not yet batch-applied)
        # KV records must not resurrect through the db.get fallback
        self._staged_rm: set[tuple[str, str]] = set()
        self._crash_point: str | None = None  # crash-injection test seam

    def _store_form(self, image: bytes) -> tuple[bytes, int]:
        """(stored bytes, clen) for a full-block image: the compressed
        form when the algorithm is on AND it beats the required ratio
        (bluestore_compression_required_ratio), else the raw block
        (clen 0)."""
        if self._compressor.name == "none":
            return image, 0
        comp = self._compressor.compress(image)
        if len(comp) <= int(BLOCK * self._required_ratio):
            return comp, len(comp)
        return image, 0

    def set_csum_offload(self, enabled: bool) -> None:
        """Runtime observer target for `bluestore_csum_offload`."""
        self._csum_offload = bool(enabled)

    def _store_forms(self, images: list[bytes]) -> list[tuple[bytes, int]]:
        """Batched `_store_form`: compressors exposing `compress_batch`
        (the device plugin) get ONE call for the whole block range so
        their transforms coalesce into shared offload launches; the
        required-ratio gate is applied per block exactly as in the
        scalar path."""
        if not images:
            return []
        if self._compressor.name == "none":
            return [(img, 0) for img in images]
        batch = getattr(self._compressor, "compress_batch", None)
        if batch is not None:
            comps = batch(images, device=self._device)
        else:
            comps = [self._compressor.compress(img) for img in images]
        limit = int(BLOCK * self._required_ratio)
        return [
            (comp, len(comp)) if len(comp) <= limit else (img, 0)
            for img, comp in zip(images, comps)
        ]

    def _csum_batch(self, stored: list[bytes]) -> list[int]:
        """crc32c over a batch of stored forms — one offload-runtime
        submission per stored-length group when the knob is armed, else
        the host table loop (byte-identical either way).  A failed or
        refused launch raises EcError(EIO)."""
        if self._csum_offload:
            from ..ops.checksum_offload import checksum_blocks

            return checksum_blocks(stored, offload=True, device=self._device)
        return [crc32c(s) for s in stored]

    # -- mount / umount --------------------------------------------------------

    def mount(self) -> None:
        if self.path is None:
            if self._block_f is None:
                import io

                self._block_f = io.BytesIO()
                self.db = MemKV()
            return
        os.makedirs(self.path, exist_ok=True)
        self.db = FileKV(os.path.join(self.path, "kv"))
        bpath = os.path.join(self.path, "block")
        if not os.path.exists(bpath):
            with open(bpath, "wb") as f:
                f.truncate(INITIAL_BLOCKS * BLOCK)
        self._block_f = open(bpath, "r+b")
        n_blocks = os.path.getsize(bpath) // BLOCK
        self.alloc = BitmapAllocator(n_blocks)
        self._colls = {k for k, _ in self.db.iterate(_COLL)}
        self._obj_count = dict.fromkeys(self._colls, 0)
        # Authoritative free list: every block referenced by an onode is
        # used (FreelistManager rebuild).
        for key, blob in self.db.iterate(_ONODE):
            coll = key.partition("\x00")[0]
            self._obj_count[coll] = self._obj_count.get(coll, 0) + 1
            o = Onode.decode(blob)
            for poff, _crc, _cl in o.blocks.values():
                self.alloc.mark_used(poff // BLOCK)
        # Replay deferred writes that committed but may not have reached
        # the block file (BlueStore::_deferred_replay).  Idempotent: each
        # record is a full-block image.
        replayed = []
        for key, val in list(self.db.iterate(_WAL)):
            (poff,) = struct.unpack_from("<Q", val)
            image = val[8:]
            self.alloc.mark_used(poff // BLOCK)
            self._block_write(poff, image)
            self._wal_seq = max(self._wal_seq, int(key, 16) + 1)
            replayed.append(key)
        self._block_sync()
        self.db.apply_batch([(2, _WAL, key, b"") for key in replayed])

    def umount(self) -> None:
        if self._block_f is not None and self.path is not None:
            self._block_f.close()
            self._block_f = None
        if self.db is not None and self.path is not None:
            self.db.close()
        self._onodes.clear()

    # -- block file ------------------------------------------------------------

    def _block_write(self, poff: int, data: bytes) -> None:
        self._block_f.seek(poff)
        self._block_f.write(data)

    def _block_read(self, poff: int, length: int) -> bytes:
        self._block_f.seek(poff)
        return self._block_f.read(length)

    def _block_sync(self) -> None:
        if self.path is not None:
            self._block_f.flush()
            os.fsync(self._block_f.fileno())

    def _ensure_capacity(self, nblocks: int) -> list[int]:
        got = self.alloc.allocate(nblocks)
        if got is not None:
            return got
        grow = max(INITIAL_BLOCKS, nblocks)
        old = len(self.alloc.free)
        self.alloc.grow(grow)
        if self.path is not None:
            self._block_f.seek(0, 2)
        # extend the file lazily; writes past EOF grow it
        got = self.alloc.allocate(nblocks)
        assert got is not None, (old, grow, nblocks)
        return got

    # -- onode access ----------------------------------------------------------

    @staticmethod
    def _okey(coll: str, oid: str) -> str:
        return f"{coll}\x00{oid}"

    def _get_onode(self, coll: str, oid: str, create: bool = False) -> Onode:
        if coll not in self._colls:
            raise StoreError(2, f"no collection {coll}")
        ck = (coll, oid)
        o = self._onodes.get(ck)
        if o is None and ck not in self._staged_rm:
            blob = self.db.get(_ONODE, self._okey(coll, oid))
            if blob is not None:
                o = Onode.decode(blob)
                self._onodes[ck] = o
        if o is None:
            if not create:
                raise StoreError(2, f"no object {coll}/{oid}")
            o = Onode()
            self._onodes[ck] = o
            self._staged_rm.discard(ck)
            self._obj_count[coll] = self._obj_count.get(coll, 0) + 1
        self._dirty.add(ck)
        return o

    # -- transaction application ----------------------------------------------

    def queue_transaction(self, txn: Transaction, on_commit=None) -> None:
        """Stage every op, then commit in BlueStore's order: direct data →
        fsync → one atomic KV batch (the commit point) → deferred WAL
        application → WAL cleanup (BlueStore::_txc_state_proc)."""
        if txn.ops:
            # same pre-apply seam as the base class: an injected write
            # fault fails the transaction whole, before staging
            self._faultpoint("os.write", txn.ops[0].coll, txn.ops[0].oid)
        self._batch, self._dirty = [], set()
        self._direct, self._deferred = [], []
        self._staged, self._to_release = {}, []
        self._staged_rm = set()
        colls_snap, counts_snap = set(self._colls), dict(self._obj_count)
        try:
            for op in txn.ops:
                self._apply_op(op)
        except Exception:
            self._colls, self._obj_count = colls_snap, counts_snap
            # caller bug (ObjectStore "failure is not an option"): drop the
            # staged txn; committed state is untouched.  Blocks allocated
            # during staging stay marked used (leaked until the next mount's
            # free-list rebuild) — safe over clever.
            self._reload_dirty()
            raise
        for poff, image in self._direct:
            self._block_write(poff, image)
        if self._direct:
            self._block_sync()
        for ck in self._dirty:
            coll, oid = ck
            o = self._onodes.get(ck)
            if o is not None:
                self._batch.append((1, _ONODE, self._okey(coll, oid), o.encode()))
        wal_keys = []
        for poff, image in self._deferred:
            key = f"{self._wal_seq:016x}"
            self._wal_seq += 1
            wal_keys.append(key)
            self._batch.append((1, _WAL, key, struct.pack("<Q", poff) + image))
        self.db.apply_batch(self._batch)  # ← commit point
        if self._crash_point == "after_commit":
            # test seam: a power cut between the KV commit and the deferred
            # block-file application — mount-time WAL replay must finish the
            # job (the crash window BlueStore's deferred_replay covers)
            raise SimulatedCrash("after_commit")
        for poff, image in self._deferred:
            self._block_write(poff, image)
        if self._deferred:
            self._block_sync()
            # one atomic (single-fsync) cleanup record, not N appends
            self.db.apply_batch([(2, _WAL, key, b"") for key in wal_keys])
        for blk in self._to_release:
            self.alloc.release(blk)
        self._batch, self._dirty = [], set()
        self._direct, self._deferred = [], []
        self._staged, self._to_release = {}, []
        self._staged_rm = set()
        if on_commit is not None:
            on_commit()

    def _reload_dirty(self) -> None:
        for ck in self._dirty:
            self._onodes.pop(ck, None)
        self._dirty.clear()
        self._batch, self._direct, self._deferred = [], [], []
        self._staged, self._to_release = {}, []
        self._staged_rm = set()

    # -- primitives ------------------------------------------------------------

    def _touch(self, coll: str, oid: str) -> None:
        self._get_onode(coll, oid, create=True)

    def _logical_block(self, o: Onode, bidx: int) -> bytes:
        """Stored content of logical block `bidx`, crc-verified; zeros for
        holes.  Bytes beyond o.size are NOT masked here (callers clamp)."""
        ent = o.blocks.get(bidx)
        if ent is None:
            return b"\x00" * BLOCK
        poff, crc, clen = ent
        stored = self._staged.get(poff)
        if stored is None:
            # _block_read returns at most the requested bytes; a short raw
            # read (lazily-grown file) zero-pads, a short compressed read
            # is caught by the crc below
            stored = self._block_read(poff, clen or BLOCK)
            if not clen and len(stored) < BLOCK:
                stored = stored + b"\x00" * (BLOCK - len(stored))  # lazy file
        # csum covers the STORED bytes (compressed or raw), so corruption
        # is caught before decompression can amplify it
        if crc32c(stored) != crc:
            raise StoreError(5, f"csum mismatch at block {bidx} (poff {poff})")
        if clen:
            return self._compressor.decompress(stored)
        return stored

    def _valid_block(self, o: Onode, bidx: int) -> bytes:
        """Block content with bytes at logical offsets >= size zeroed —
        the overlay source for read-modify-write."""
        data = self._logical_block(o, bidx)
        end = o.size - bidx * BLOCK
        if end <= 0:
            return b"\x00" * BLOCK
        if end < BLOCK:
            return data[:end] + b"\x00" * (BLOCK - end)
        return data

    def _write(
        self, coll: str, oid: str, off: int, data: bytes, csums=None
    ) -> None:
        """`csums` (EC-transaction fusion): per-BLOCK crc32c of `data`,
        precomputed in the encode's offload launch window — an AggTicket
        or uint32 array, trusted only for block-aligned writes whose
        stored form stays raw (stored bytes == image bytes)."""
        if not data:
            self._get_onode(coll, oid, create=True)
            return
        o = self._get_onode(coll, oid, create=True)
        b0, b1 = off // BLOCK, (off + len(data) - 1) // BLOCK
        # Assemble full-block images for the affected range, keeping the
        # pre-overlay content of live blocks for the unchanged-skip check.
        images: dict[int, bytearray] = {}
        orig: dict[int, bytes] = {}
        for b in range(b0, b1 + 1):
            prev = self._valid_block(o, b)
            if b in o.blocks:
                orig[b] = prev
            images[b] = bytearray(prev)
        cur = off
        dpos = 0
        while dpos < len(data):
            b = cur // BLOCK
            boff = cur % BLOCK
            n = min(BLOCK - boff, len(data) - dpos)
            images[b][boff : boff + n] = data[dpos : dpos + n]
            cur += n
            dpos += n
        # Identical-content overwrite: a live block entirely below the
        # current size whose image is unchanged keeps its stored form,
        # csum, and physical slot — nothing to recompute or rewrite.
        # (Blocks straddling o.size are never skipped: their stored tail
        # bytes may be stale, and a size extension would expose them.)
        skip = {
            b
            for b in images
            if b in orig
            and (b + 1) * BLOCK <= o.size
            and bytes(images[b]) == orig[b]
        }
        self.csum_compute_skips += len(skip)
        todo = [b for b in sorted(images) if b not in skip]
        all_mapped = all(b in o.blocks for b in images)
        # One batched store-form + one batched csum pass for the whole
        # range (the device compressor / csum service coalesce these
        # into shared offload launches when armed).
        forms = self._store_forms([bytes(images[b]) for b in todo])
        crcs = [0] * len(todo)
        pre = None
        if csums is not None and off % BLOCK == 0 and len(data) % BLOCK == 0:
            pre = csums.result() if hasattr(csums, "result") else csums
        need = []
        for i, b in enumerate(todo):
            if pre is not None and forms[i][1] == 0:
                # raw-stored fully-overwritten block: the fused digest
                # covers exactly the stored bytes
                crcs[i] = int(pre[b - b0])
                self.csum_fused_blocks += 1
            else:
                need.append(i)
        if need:
            digs = self._csum_batch([forms[i][0] for i in need])
            for i, dig in zip(need, digs):
                crcs[i] = dig
        if all_mapped and len(data) <= DEFERRED_MAX:
            # deferred WAL overwrite in place
            for i, b in enumerate(todo):
                poff = o.blocks[b][0]
                stored, clen = forms[i]
                o.blocks[b] = (poff, crcs[i], clen)
                self._deferred.append((poff, stored))
                self._staged[poff] = stored
        else:
            # COW: fresh blocks for the (non-skipped) affected range
            newblocks = self._ensure_capacity(len(todo))
            for i, (b, nb) in enumerate(zip(todo, newblocks)):
                old = o.blocks.get(b)
                if old is not None:
                    self._to_release.append(old[0] // BLOCK)
                stored, clen = forms[i]
                o.blocks[b] = (nb * BLOCK, crcs[i], clen)
                self._direct.append((nb * BLOCK, stored))
                self._staged[nb * BLOCK] = stored
        o.size = max(o.size, off + len(data))

    def _apply_op(self, op) -> None:
        # thread the fused-csum hint through to _write; every other op
        # takes the shared application loop
        if op.code == OP_WRITE and getattr(op, "csums", None) is not None:
            self._write(op.coll, op.oid, op.off, op.data, csums=op.csums)
            return
        super()._apply_op(op)

    def _truncate(self, coll: str, oid: str, size: int) -> None:
        o = self._get_onode(coll, oid, create=True)
        if size < o.size:
            keep = (size + BLOCK - 1) // BLOCK
            for b in [b for b in o.blocks if b >= keep]:
                self._to_release.append(o.blocks.pop(b)[0] // BLOCK)
            o.size = size
            # Scrub the kept partial block: a later size extension that
            # never rewrites this block (truncate up, or a write landing in
            # a different block) must read zeros here, not pre-truncate
            # bytes.
            tail = size % BLOCK
            b = size // BLOCK
            if tail and b in o.blocks:
                image = self._logical_block(o, b)[:tail] + b"\x00" * (BLOCK - tail)
                poff = o.blocks[b][0]
                stored, clen = self._store_form(image)
                o.blocks[b] = (poff, crc32c(stored), clen)
                self._deferred.append((poff, stored))
                self._staged[poff] = stored
        o.size = size

    def _remove(self, coll: str, oid: str) -> None:
        """Idempotent like MemStore/FileStore: recovery's push handler and
        the objectstore tool remove-before-recreate unconditionally."""
        if coll not in self._colls:
            raise StoreError(2, f"no collection {coll}")
        ck = (coll, oid)
        try:
            o = self._get_onode(coll, oid)
        except StoreError:
            return
        for poff, _crc, _cl in o.blocks.values():
            self._to_release.append(poff // BLOCK)
        self._onodes.pop(ck, None)
        self._dirty.discard(ck)
        self._staged_rm.add(ck)
        self._obj_count[coll] -= 1
        self._batch.append((2, _ONODE, self._okey(coll, oid), b""))

    def _setattr(self, coll: str, oid: str, name: str, value: bytes) -> None:
        self._get_onode(coll, oid, create=True).xattrs[name] = bytes(value)

    def _rmattr(self, coll: str, oid: str, name: str) -> None:
        self._get_onode(coll, oid).xattrs.pop(name, None)

    def _omap_set(self, coll: str, oid: str, keys: dict[str, bytes]) -> None:
        o = self._get_onode(coll, oid, create=True)
        for k, v in keys.items():
            o.omap[k] = bytes(v)

    def _omap_rm(self, coll: str, oid: str, keys) -> None:
        o = self._get_onode(coll, oid)
        for k in keys:
            o.omap.pop(k, None)

    def _mkcoll(self, coll: str) -> None:
        if coll in self._colls:
            raise StoreError(17, f"collection {coll} exists")  # EEXIST
        self._colls.add(coll)
        self._obj_count.setdefault(coll, 0)
        self._batch.append((1, _COLL, coll, b""))

    def _rmcoll(self, coll: str) -> None:
        if coll not in self._colls:
            raise StoreError(2, f"no collection {coll}")
        for oid in self.list_objects(coll):
            self._remove(coll, oid)
        self._colls.discard(coll)
        self._obj_count.pop(coll, None)
        self._batch.append((2, _COLL, coll, b""))

    def _clone(self, coll: str, src: str, dst: str) -> None:
        data = self.read(coll, src, 0, 0)
        # reset target, then write through the normal (COW) path
        d = self._get_onode(coll, dst, create=True)
        for poff, _crc, _cl in d.blocks.values():
            self._to_release.append(poff // BLOCK)
        d.blocks.clear()
        d.size = 0
        src_o = self._get_onode(coll, src)
        d.xattrs = dict(src_o.xattrs)
        d.omap = dict(src_o.omap)
        if data:
            self._write(coll, dst, 0, data)

    # -- reads -----------------------------------------------------------------

    def read(self, coll: str, oid: str, off: int = 0, length: int = 0) -> bytes:
        self._faultpoint("os.read", coll, oid)
        o = self._peek_onode(coll, oid)
        end = o.size if length == 0 else min(off + length, o.size)
        if off >= end:
            return b""
        b_first, b_last = off // BLOCK, (end - 1) // BLOCK
        blocks = self._logical_blocks(o, b_first, b_last)
        parts = []
        cur = off
        for b in range(b_first, b_last + 1):
            lo = cur - b * BLOCK
            hi = min(BLOCK, end - b * BLOCK)
            parts.append(blocks[b - b_first][lo:hi])
            cur = (b + 1) * BLOCK
        return b"".join(parts)

    def _logical_blocks(
        self, o: Onode, b_first: int, b_last: int
    ) -> list[bytes]:
        """`_logical_block` over a contiguous range with ONE batched
        verification-csum pass: when csum offload is armed the whole
        range's stored forms ride the offload runtime (grouped by stored
        length) instead of one host crc per block.  Holes read zeros;
        a digest mismatch raises the same EIO as the scalar path."""
        out: list[bytes | None] = [None] * (b_last - b_first + 1)
        mapped: list[tuple[int, int, int, int, int, bytes]] = []
        for b in range(b_first, b_last + 1):
            ent = o.blocks.get(b)
            if ent is None:
                out[b - b_first] = b"\x00" * BLOCK
                continue
            poff, crc, clen = ent
            stored = self._staged.get(poff)
            if stored is None:
                stored = self._block_read(poff, clen or BLOCK)
                if not clen and len(stored) < BLOCK:
                    stored = stored + b"\x00" * (BLOCK - len(stored))
            mapped.append((b - b_first, b, poff, crc, clen, stored))
        if mapped:
            digs = self._csum_batch([m[5] for m in mapped])
            for (idx, bidx, poff, crc, clen, stored), dig in zip(mapped, digs):
                if dig != crc:
                    raise StoreError(
                        5, f"csum mismatch at block {bidx} (poff {poff})"
                    )
                out[idx] = (
                    self._compressor.decompress(stored) if clen else stored
                )
        return out

    def _peek_onode(self, coll: str, oid: str) -> Onode:
        """Read-side onode lookup: no create, no dirty-marking."""
        if coll not in self._colls:
            raise StoreError(2, f"no collection {coll}")
        ck = (coll, oid)
        o = self._onodes.get(ck)
        if o is None:
            if ck in self._staged_rm:
                raise StoreError(2, f"no object {coll}/{oid}")
            blob = self.db.get(_ONODE, self._okey(coll, oid))
            if blob is None:
                raise StoreError(2, f"no object {coll}/{oid}")
            o = Onode.decode(blob)
            self._onodes[ck] = o
        return o

    def stat(self, coll: str, oid: str) -> int:
        return self._peek_onode(coll, oid).size

    def getattr(self, coll: str, oid: str, name: str) -> bytes:
        o = self._peek_onode(coll, oid)
        if name not in o.xattrs:
            raise StoreError(61, f"no attr {name}")  # ENODATA
        return o.xattrs[name]

    def getattrs(self, coll: str, oid: str) -> dict[str, bytes]:
        return dict(self._peek_onode(coll, oid).xattrs)

    def omap_get(self, coll: str, oid: str) -> dict[str, bytes]:
        return dict(self._peek_onode(coll, oid).omap)

    def list_objects(self, coll: str) -> list[str]:
        if coll not in self._colls:
            raise StoreError(2, f"no collection {coll}")
        out = set()
        prefix = f"{coll}\x00"
        for key, _ in self.db.iterate(_ONODE):
            if key.startswith(prefix):
                out.add(key[len(prefix):])
        for (c, oid) in self._onodes:
            if c == coll:
                out.add(oid)
        # cached-but-removed are impossible: _remove drops the cache entry
        return sorted(out)

    def count_objects(self, coll: str) -> int:
        if coll not in self._colls:
            raise StoreError(2, f"no collection {coll}")
        return self._obj_count.get(coll, 0)

    def list_collections(self) -> list[str]:
        return sorted(self._colls)
