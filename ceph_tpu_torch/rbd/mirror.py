"""RBD image journaling + mirroring — mirror of src/journal + src/tools/rbd_mirror.

The reference's rbd journaling feature writes every image mutation into a
per-image journal (src/journal/Journaler; librbd/journal/) BEFORE the
image data, so a peer cluster's `rbd-mirror` daemon can replay the event
stream and converge an exact copy (tools/rbd_mirror/ImageReplayer).  This
module keeps that architecture:

- **Journal**: one append-only RADOS object per image
  (`rbd_journal.<image_id>`), length-prefixed binary records
  `seq u64 | type u8 | off u64 | len u32 | payload` — WRITE carries the
  bytes (journaling's double-write cost, as in the reference), RESIZE
  and SNAP carry their parameters.  A torn tail (crash mid-append) is
  detected by the length prefix and ignored, like Journaler's
  commit-position recovery.
- **Write-ahead**: JournaledImage appends the event before touching data
  objects; replay is idempotent (whole-event overwrite), so an image
  crash between journal append and data write converges on replay.
- **Mirror daemon**: MirrorDaemon replays events past its persisted
  position (`rbd_mirror_position.<image_id>` in the DESTINATION pool —
  the replayer owns its progress, ImageReplayer's commit position) onto
  the peer image, bootstrapping it on first sight.  `sync_once` is one
  replay pass; `run` polls continuously.
- **Promote/demote**: the image header's `primary` flag (mirroring's
  exclusive-primary model scoped down); a demoted image refuses writes.

The port's copy of `ceph_tpu/rbd/mirror.py`.  Where it differs:

- ROADMAP C26: the applied, committed and replayed positions and the
  journal read as 0 or empty only when their object does not exist or
  holds no JSON (`client/absent.py`), and the journal's trim and the
  commit records are written with no catch.  The reference catches every
  exception there, so an EIO on the journal and the commit record made
  `_next_seq` start the sequence again at 1, and the replayer then skips
  the new events as already replayed.
- `MirrorDaemon.run` sleeps 0.2 s between passes and retries a failed
  pass; it judges no peer (it marks nothing down and takes nothing over),
  so the rule for the daemons' periodic judges (a late tick judges no
  one) does not apply to it.  A device error, which only a daemon in the
  same process can raise, is not retried: it ends the loop and reaches
  its caller (`ops.guard.is_device_error`), as in the mgr.
"""

from __future__ import annotations

import asyncio
import json
import struct

from ..client.absent import parse_json, unless_absent
from ..common.errs import EINVAL, ENOENT
from ..common.log import dout
from ..ops.guard import is_device_error
from .rbd import RBD, Image, RbdError

_REC = struct.Struct("<QBQI")  # seq, type, off, payload len
EV_WRITE = 1
EV_RESIZE = 2
EV_SNAP_CREATE = 3
EV_SNAP_REMOVE = 4


def journal_oid(image_id: str) -> str:
    return f"rbd_journal.{image_id}"


def position_oid(image_id: str) -> str:
    return f"rbd_mirror_position.{image_id}"


def commit_oid(image_id: str) -> str:
    """Peer-committed position, recorded in the SOURCE pool so the
    primary can trim its journal (Journaler's client commit records)."""
    return f"rbd_journal_commit.{image_id}"


def pack_event(seq: int, ev_type: int, off: int, payload: bytes) -> bytes:
    return _REC.pack(seq, ev_type, off, len(payload)) + payload


def iter_events(blob: bytes):
    """Yield (seq, type, off, payload); stops at a torn tail."""
    pos = 0
    while pos + _REC.size <= len(blob):
        seq, ev_type, off, ln = _REC.unpack_from(blob, pos)
        end = pos + _REC.size + ln
        if end > len(blob):
            break  # torn append: never acked, drop
        yield seq, ev_type, off, blob[pos + _REC.size : end]
        pos = end


def applied_oid(image_id: str) -> str:
    """The primary's own replay position (librbd's journal commit
    position: events past it were journaled but maybe never applied)."""
    return f"rbd_journal_applied.{image_id}"


async def apply_event(img: Image, ev_type: int, off: int, payload: bytes) -> None:
    """Apply one journal event to an image, idempotently — shared by the
    mirror replayer and the primary's own crash recovery."""
    if ev_type == EV_WRITE:
        if off + len(payload) > img.size:
            await img.resize(off + len(payload))
        await img.write(off, payload)
    elif ev_type == EV_RESIZE:
        await img.resize(off)
    elif ev_type == EV_SNAP_CREATE:
        name = payload.decode()
        if not any(s["name"] == name for s in img.header["snaps"]):
            await img.snap_create(name)
    elif ev_type == EV_SNAP_REMOVE:
        name = payload.decode()
        if any(s["name"] == name for s in img.header["snaps"]):
            await img.snap_remove(name)


class JournaledImage:
    """Write-ahead journaling wrapper over an open Image (librbd's
    journaling feature: ImageCtx->journal interposed on the write path)."""

    def __init__(self, image: Image):
        self.image = image
        self.ioctx = image.ioctx
        self._seq = None  # lazily discovered from the journal tail

    @classmethod
    async def open(cls, rbd: RBD, name: str) -> "JournaledImage":
        img = await rbd.open(name)
        if not img.header.get("journaling"):
            raise RbdError(EINVAL, f"image {name!r} has journaling disabled")
        ji = cls(img)
        await ji._recover()
        return ji

    async def _recover(self) -> None:
        """Replay our own journal past the applied position (librbd's
        open-time journal replay): an event appended before a crash that
        never reached the data objects applies now — the write-ahead
        promise on the PRIMARY side.  Replay is idempotent full-event
        application, so re-running already-applied events is safe."""
        raw = await unless_absent(self.ioctx.read(applied_oid(self.image.id)))
        applied = parse_json(raw, {}).get("applied", 0)
        blob = await unless_absent(self.ioctx.read(journal_oid(self.image.id)))
        if blob is None:
            return
        last = applied
        for seq, ev_type, off, payload in iter_events(blob):
            if seq <= applied:
                continue
            await apply_event(self.image, ev_type, off, payload)
            last = seq
        if last != applied:
            await self.ioctx.write_full(
                applied_oid(self.image.id),
                json.dumps({"applied": last}).encode(),
            )

    async def _committed(self) -> int:
        raw = await unless_absent(self.ioctx.read(commit_oid(self.image.id)))
        return parse_json(raw, {}).get("committed", 0)

    async def _next_seq(self) -> int:
        if self._seq is None:
            # sequences stay monotonic across trims: the floor is the
            # peer-committed position, not just what the journal holds
            self._seq = await self._committed()
            blob = await unless_absent(self.ioctx.read(journal_oid(self.image.id)))
            for seq, *_rest in iter_events(blob or b""):
                self._seq = max(self._seq, seq)
        self._seq += 1
        return self._seq

    def _require_primary(self) -> None:
        if not self.image.header.get("primary", True):
            raise RbdError(EINVAL, f"image {self.image.name!r} is not primary")

    async def _append(self, ev_type: int, off: int, payload: bytes) -> None:
        seq = await self._next_seq()
        oid = journal_oid(self.image.id)
        # Trim when every existing event is peer-committed (Journaler's
        # segment expiry): the replayer skips seq <= its position, and
        # sequences never reset, so a reset journal object is safe.
        committed = await self._committed()
        if committed >= seq - 1:
            await self.ioctx.write_full(oid, b"")
        await self.ioctx.append(oid, pack_event(seq, ev_type, off, payload))

    # -- journaled mutations ---------------------------------------------------
    #
    # Validation runs BEFORE the journal append: a rejected mutation must
    # never reach the event stream, or the replica would apply something
    # the primary refused (divergence).

    async def write(self, off: int, data: bytes) -> None:
        self._require_primary()
        if off + len(data) > self.image.size:
            raise RbdError(EINVAL, "write past end of image")
        await self._append(EV_WRITE, off, bytes(data))  # journal FIRST
        await self.image.write(off, data)

    async def resize(self, new_size: int) -> None:
        self._require_primary()
        await self._append(EV_RESIZE, new_size, b"")
        await self.image.resize(new_size)

    async def snap_create(self, name: str) -> None:
        self._require_primary()
        if any(s["name"] == name for s in self.image.header["snaps"]):
            raise RbdError(EINVAL, f"snapshot {name!r} exists")
        await self._append(EV_SNAP_CREATE, 0, name.encode())
        await self.image.snap_create(name)

    async def snap_remove(self, name: str) -> None:
        self._require_primary()
        if not any(s["name"] == name for s in self.image.header["snaps"]):
            raise RbdError(ENOENT, f"snapshot {name!r} not found")
        await self._append(EV_SNAP_REMOVE, 0, name.encode())
        await self.image.snap_remove(name)

    # -- reads pass through ----------------------------------------------------

    async def read(self, off: int, length: int, snap_name=None) -> bytes:
        return await self.image.read(off, length, snap_name)

    async def demote(self) -> None:
        """Primary -> replica (rbd mirror image demote)."""
        self.image.header["primary"] = False
        await self.image._save_header()


async def enable_journaling(rbd: RBD, name: str) -> None:
    """`rbd feature enable <image> journaling`."""
    img = await rbd.open(name)
    img.header["journaling"] = True
    img.header.setdefault("primary", True)
    await img._save_header()


class MirrorDaemon:
    """One-direction image replayer (rbd-mirror's ImageReplayer, scoped to
    a (source pool, destination pool) pair)."""

    def __init__(self, src_ioctx, dst_ioctx):
        self.src = src_ioctx
        self.dst = dst_ioctx
        self.src_rbd = RBD(src_ioctx)
        self.dst_rbd = RBD(dst_ioctx)
        self._running = False
        self.sync_errors = 0  # failed sync passes (visible, not silent)

    async def _position(self, image_id: str) -> int:
        raw = await unless_absent(self.dst.read(position_oid(image_id)))
        return parse_json(raw, {}).get("replayed", 0)

    async def _save_position(self, image_id: str, seq: int) -> None:
        await self.dst.write_full(
            position_oid(image_id), json.dumps({"replayed": seq}).encode()
        )

    async def _bootstrap(self, name: str, src_img: Image) -> Image:
        """First sight of a journaled image: create the non-primary peer
        and FULL-SYNC the current contents (ImageReplayer bootstrap's
        image sync) — bytes written before journaling was enabled exist
        only in the data objects, never in the event stream."""
        try:
            return await self.dst_rbd.open(name)
        except RbdError as e:
            if e.errno != -ENOENT:
                raise
        # snapshot the journal position FIRST: events landing during the
        # copy are both (maybe) in the copy and replayed after — replay
        # is idempotent whole-event overwrite, so that converges
        base_seq = 0
        blob = await unless_absent(self.src.read(journal_oid(src_img.id)))
        for seq, *_rest in iter_events(blob or b""):
            base_seq = max(base_seq, seq)
        await self.dst_rbd.create(name, src_img.size, order=src_img.order)
        dst_img = await self.dst_rbd.open(name)
        dst_img.header["primary"] = False
        dst_img.header["journaling"] = True
        await dst_img._save_header()

        async def copy_state(size: int, snap_name: str | None) -> None:
            if dst_img.size != size:
                await dst_img.resize(size)
            step = 1 << src_img.order
            for off in range(0, size, step):
                chunk = await src_img.read(
                    off, min(step, size - off), snap_name=snap_name
                )
                if chunk.strip(b"\x00"):
                    await dst_img.write(off, chunk)

        # snapshot history syncs oldest-first (deep-copy's snap sync),
        # then the head
        for s in sorted(src_img.header["snaps"], key=lambda s: s["id"]):
            await copy_state(s.get("size", src_img.size), s["name"])
            await dst_img.snap_create(s["name"])
        await copy_state(src_img.size, None)
        await self._save_position(src_img.id, base_seq)
        if base_seq:
            # the copy covers everything up to base_seq: record the commit
            # so the primary can trim those events
            await self.src.write_full(
                commit_oid(src_img.id),
                json.dumps({"committed": base_seq}).encode(),
            )
        return dst_img

    async def sync_image(self, name: str) -> int:
        """Replay this image's journal events past our position onto the
        peer; returns the number of events applied."""
        src_img = await self.src_rbd.open(name)
        if not src_img.header.get("journaling"):
            return 0
        dst_img = await self._bootstrap(name, src_img)
        if dst_img.header.get("primary", True):
            # a promoted replica owns its own history now: replaying stale
            # source events would clobber post-failover writes
            # (ImageReplayer refuses primary images)
            return 0
        pos = await self._position(src_img.id)
        blob = await unless_absent(self.src.read(journal_oid(src_img.id)))
        if blob is None:
            return 0
        applied = 0
        last = pos
        for seq, ev_type, off, payload in iter_events(blob):
            if seq <= pos:
                continue
            await apply_event(dst_img, ev_type, off, payload)
            applied += 1
            last = seq
        if applied:
            await self._save_position(src_img.id, last)
            # record the commit in the SOURCE pool so the primary can trim
            # its journal (Journaler client commit position)
            await self.src.write_full(
                commit_oid(src_img.id),
                json.dumps({"committed": last}).encode(),
            )
        return applied

    async def sync_once(self) -> dict[str, int]:
        """One replay pass over every journaled source image."""
        out = {}
        for name in await self.src_rbd.list():
            out[name] = await self.sync_image(name)
        return out

    async def run(self, interval: float = 0.2) -> None:
        """Continuous replay (the daemon loop)."""
        self._running = True
        while self._running:
            try:
                await self.sync_once()
            except Exception as e:
                if is_device_error(e):
                    raise
                # source hiccup: retry next tick — logged + counted so a
                # permanently-failing daemon loop is not invisible
                self.sync_errors += 1
                dout("rbd", 1, f"rbd-mirror: sync pass failed: {e!r}")
            await asyncio.sleep(interval)

    def stop(self) -> None:
        self._running = False


async def promote(rbd: RBD, name: str, fence: bool = False) -> None:
    """`rbd mirror image promote` on the replica after failover.

    With `fence`, every OTHER exclusive-lock holder of the image is
    first BLOCKLISTED (osdmap blocklist) and its lock broken — the
    reference's promotion fencing.  Enforcement begins as each OSD
    applies the blocklist epoch (map propagation, the same eventual
    semantics the reference has); the lock break cuts off lock-gated
    I/O immediately, and the committed blocklist guarantees the zombie's
    client instance can never re-acquire or write once the epoch lands.
    The promoting client's own instance is never fenced."""
    img = await rbd.open(name)
    if fence:
        rados = rbd.ioctx.rados
        me = rados.objecter.reqid_name
        fenced = []
        for holder in await img.lock_owners():
            if holder["entity"] == me:
                continue  # never fence the promoting instance itself
            rv, rs, _ = await rados.mon_command(
                {"prefix": "osd blocklist add", "entity": holder["entity"]}
            )
            if rv:
                raise RbdError(-rv, f"fencing {holder['entity']} failed: {rs}")
            fenced.append(holder)
        # wait for the blocklist epoch to reach our own map before
        # breaking locks: break-then-propagate would reopen the window
        # the fence exists to close
        deadline = asyncio.get_event_loop().time() + 10.0
        while fenced and not all(
            h["entity"] in rados.objecter.osdmap.blocklist for h in fenced
        ):
            if asyncio.get_event_loop().time() > deadline:
                raise RbdError(110, "blocklist epoch did not propagate")
            await asyncio.sleep(0.05)
            await rados.objecter.monc.resubscribe()
        for holder in fenced:
            await img.break_lock(holder["entity"], holder["cookie"])
    img.header["primary"] = True
    await img._save_header()
