"""RBD — block images over RADOS, mirror of src/librbd.

Reference structure mirrored (librbd is 110k LoC; this is the core
data-path slice — SURVEY.md §2.7 "Access layers"):

- An image is a **header object** `rbd_header.<id>` holding size/order/
  snapshot metadata (librbd's ImageCtx reads the same from its header),
  plus data objects `rbd_data.<id>.<objno>` each covering `2^order`
  bytes (librbd/io/ObjectRequest.cc object mapping; order default 22 =
  4 MiB).
- I/O maps logical extents onto data objects (io/ImageRequest.cc →
  Striper math with stripe_count=1, the rbd default layout).
- **Snapshots are SERVER-SIDE**, exactly like librbd's: snap ids come
  from the pool's self-managed snap counter (rados
  selfmanaged_snap_create → OSDMonitor), every data write carries the
  image's SnapContext, and the OSD clones on first-write-after-snap
  (PrimaryLogPG::make_writeable → SnapSet clones).  Snapshot reads pass
  the snap id; rollback/trim use the OSD's ROLLBACK and snap-trim ops.
  Nothing is copied client-side.
- The image directory object `rbd_directory` maps names → ids
  (librbd's rbd_directory omap).

Single-writer images (the reference guards multi-client access with its
exclusive-lock feature; that is the assumed mode here).

The port's copy of `ceph_tpu/rbd/rbd.py`.  Where it differs (ROADMAP
C26): the directory and children objects read as empty only when they
do not exist or hold no JSON, and the removes and trims of `remove` and
`resize` pass over only a missing object (`client/absent.py`); the
reference catches every exception there, so an EIO from a degraded read
made the next `create` store a directory without the earlier images.
Every other error reaches the caller as `RadosError`.  Nothing here
touches the device: the kernels run in the OSDs.
"""

from __future__ import annotations

import json
import secrets

from ..client.absent import parse_json, unless_absent
from ..client.rados import RadosError
from ..cls import client as cls_client
from ..common.errs import EBUSY, EEXIST, EINVAL, ENOENT

DIRECTORY_OID = "rbd_directory"
CHILDREN_OID = "rbd_children"  # parent "<id>@<snap_id>" -> [child ids]
DEFAULT_ORDER = 22  # 4 MiB objects


class RbdError(Exception):
    def __init__(self, err: int, msg: str = ""):
        self.errno = -abs(err)
        super().__init__(f"{msg} (errno {self.errno})")


class RBD:
    """Pool-level image operations (librbd::RBD)."""

    def __init__(self, ioctx):
        self.ioctx = ioctx

    async def _read_directory(self) -> dict[str, str]:
        return parse_json(await unless_absent(self.ioctx.read(DIRECTORY_OID)), {})

    async def _write_directory(self, d: dict[str, str]) -> None:
        await self.ioctx.write_full(DIRECTORY_OID, json.dumps(d).encode())

    async def create(self, name: str, size: int, order: int = DEFAULT_ORDER) -> None:
        """rbd create (librbd::create)."""
        if not 12 <= order <= 26:
            raise RbdError(EINVAL, f"order {order} out of range")
        directory = await self._read_directory()
        if name in directory:
            raise RbdError(EEXIST, f"image {name!r} exists")
        image_id = secrets.token_hex(8)
        header = {
            "id": image_id,
            "size": size,
            "max_size": size,  # high-water mark for cleanup after shrinks
            "order": order,
            "snaps": [],  # [{"id": int, "name": str, "size": int}]
        }
        await self.ioctx.write_full(
            f"rbd_header.{image_id}", json.dumps(header).encode()
        )
        directory[name] = image_id
        await self._write_directory(directory)

    async def list(self) -> list[str]:
        return sorted(await self._read_directory())

    async def _read_children(self) -> dict[str, list[str]]:
        return parse_json(await unless_absent(self.ioctx.read(CHILDREN_OID)), {})

    async def _write_children(self, d: dict[str, list[str]]) -> None:
        await self.ioctx.write_full(
            CHILDREN_OID, json.dumps({k: v for k, v in d.items() if v}).encode()
        )

    async def clone(
        self, parent_name: str, snap_name: str, child_name: str,
        order: int | None = None,
    ) -> None:
        """rbd clone (librbd::clone): a copy-on-write child of a
        PROTECTED parent snapshot.  The child starts as pure metadata —
        reads fall through to the parent's snap until copy-up."""
        parent = await self.open(parent_name)
        snap = parent._snap_by_name(snap_name)
        if not snap.get("protected"):
            raise RbdError(EINVAL, f"snapshot {snap_name!r} is not protected")
        directory = await self._read_directory()
        if child_name in directory:
            raise RbdError(EEXIST, f"image {child_name!r} exists")
        child_id = secrets.token_hex(8)
        overlap = snap.get("size", parent.size)
        header = {
            "id": child_id,
            "size": overlap,
            "max_size": overlap,
            "order": order if order is not None else parent.order,
            "snaps": [],
            "parent": {
                "image_id": parent.id,
                "image_name": parent_name,
                "snap_id": snap["id"],
                "snap_name": snap_name,
                "overlap": overlap,
            },
        }
        await self.ioctx.write_full(
            f"rbd_header.{child_id}", json.dumps(header).encode()
        )
        directory[child_name] = child_id
        await self._write_directory(directory)
        children = await self._read_children()
        children.setdefault(f"{parent.id}@{snap['id']}", []).append(child_id)
        await self._write_children(children)

    async def children(self, parent_name: str, snap_name: str) -> list[str]:
        """rbd children: names of clones of this snapshot."""
        parent = await self.open(parent_name)
        snap = parent._snap_by_name(snap_name)
        ids = (await self._read_children()).get(
            f"{parent.id}@{snap['id']}", []
        )
        directory = await self._read_directory()
        by_id = {v: k for k, v in directory.items()}
        return sorted(by_id.get(i, i) for i in ids)

    async def remove(self, name: str) -> None:
        directory = await self._read_directory()
        image_id = directory.get(name)
        if image_id is None:
            raise RbdError(ENOENT, f"image {name!r} not found")
        img = await self.open(name)
        if any(s.get("protected") for s in img.header["snaps"]):
            raise RbdError(
                EBUSY, f"image {name!r} has protected snapshots"
            )
        if img.header.get("parent"):
            # a clone: unregister from the parent's children first
            p = img.header["parent"]
            children = await self._read_children()
            key = f"{p['image_id']}@{p['snap_id']}"
            children[key] = [
                c for c in children.get(key, []) if c != image_id
            ]
            await self._write_children(children)
        span = max(img.size, img.header.get("max_size", img.size))
        objects = (span + img.object_bytes - 1) // img.object_bytes
        for objno in range(objects):
            oid = img._data_oid(objno)
            # trim every snapshot's clone, then the head (the last trim
            # garbage-collects a whiteout head automatically)
            for s in img.header["snaps"]:
                await unless_absent(self.ioctx.snap_trim(oid, s["id"]))
            await unless_absent(self.ioctx.remove(oid))
        await self.ioctx.remove(f"rbd_header.{image_id}")
        del directory[name]
        await self._write_directory(directory)

    async def open(self, name: str) -> "Image":
        directory = await self._read_directory()
        image_id = directory.get(name)
        if image_id is None:
            raise RbdError(ENOENT, f"image {name!r} not found")
        img = Image(self.ioctx, name, image_id)
        await img._load_header()
        return img


class Image:
    """One open image (librbd::Image / ImageCtx)."""

    def __init__(self, ioctx, name: str, image_id: str):
        self.ioctx = ioctx
        self.name = name
        self.id = image_id
        self.header: dict = {}
        self._lock_cookie: str | None = None  # our exclusive-lock hold

    # -- header ----------------------------------------------------------------

    @property
    def _header_oid(self) -> str:
        return f"rbd_header.{self.id}"

    async def _load_header(self) -> None:
        raw = await self.ioctx.read(self._header_oid)
        self.header = json.loads(raw.decode())

    async def _save_header(self) -> None:
        await self.ioctx.write_full(self._header_oid, json.dumps(self.header).encode())

    # -- exclusive lock (librbd ManagedLock over cls_lock) ---------------------

    LOCK_NAME = "rbd_lock"  # the lock name librbd registers on the header

    async def lock_acquire(self, cookie: str | None = None) -> None:
        """Acquire the image's exclusive lock (rbd_lock on the header
        object via the lock object class — the reference's ManagedLock /
        exclusive_lock feature).  -EBUSY propagates as RbdError when
        another client owns the image.

        The default cookie is RANDOM per open image (librbd generates
        unique cookies the same way): cls_lock keys holders on (entity,
        cookie), and two same-named clients sharing a fixed cookie would
        both "own" the exclusive lock as renewals of one hold."""
        if cookie is None:
            cookie = self._lock_cookie or f"auto {secrets.token_hex(8)}"
        try:
            await cls_client.lock(
                self.ioctx, self._header_oid, self.LOCK_NAME, cookie=cookie,
                description=f"rbd image {self.name}",
            )
        except RadosError as e:
            # -EBUSY is contention; anything else (header gone, I/O
            # error) must not be misreported as "locked"
            what = (
                f"image {self.name!r} is locked"
                if e.errno == -EBUSY
                else f"image {self.name!r} lock_acquire failed"
            )
            raise RbdError(-e.errno, what) from e
        self._lock_cookie = cookie

    async def lock_release(self, cookie: str | None = None) -> None:
        try:
            await cls_client.unlock(
                self.ioctx, self._header_oid, self.LOCK_NAME,
                cookie=cookie if cookie is not None else (self._lock_cookie or ""),
            )
        except RadosError as e:
            raise RbdError(-e.errno, f"image {self.name!r} unlock failed") from e
        self._lock_cookie = None

    async def lock_owners(self) -> list[dict]:
        """Current holders (rbd lock ls): [{entity, cookie, description}]."""
        try:
            info = await cls_client.get_lock_info(
                self.ioctx, self._header_oid, self.LOCK_NAME
            )
        except RadosError as e:
            raise RbdError(-e.errno, f"image {self.name!r} lock query failed") from e
        return [
            {"entity": h[0], "cookie": h[1], "description": h[2]}
            for h in info["holders"]
        ]

    async def break_lock(self, entity: str, cookie: str) -> None:
        """Forcibly remove another client's hold (rbd lock rm — the
        failover path rbd-mirror promotion uses when the old primary's
        owner died)."""
        try:
            await cls_client.break_lock(
                self.ioctx, self._header_oid, self.LOCK_NAME, entity,
                cookie=cookie,
            )
        except RadosError as e:
            raise RbdError(-e.errno, f"image {self.name!r} break_lock failed") from e

    @property
    def size(self) -> int:
        return self.header["size"]

    @property
    def order(self) -> int:
        return self.header["order"]

    @property
    def object_bytes(self) -> int:
        return 1 << self.order

    def _data_oid(self, objno: int) -> str:
        return f"rbd_data.{self.id}.{objno:016x}"

    def _extents(self, off: int, length: int):
        """Logical range -> [(objno, obj_off, len)] (stripe_count=1)."""
        out = []
        ob = self.object_bytes
        while length > 0:
            objno = off // ob
            obj_off = off % ob
            take = min(ob - obj_off, length)
            out.append((objno, obj_off, take))
            off += take
            length -= take
        return out

    def _snapc(self) -> tuple[int, list[int]]:
        """This image's SnapContext, passed PER CALL (never armed on the
        shared IoCtx: concurrent ops must not race each other's context —
        ImageCtx::snapc rides every individual write in the reference)."""
        ids = sorted((s["id"] for s in self.header["snaps"]), reverse=True)
        return (ids[0] if ids else 0, ids)

    # -- I/O -------------------------------------------------------------------

    async def write(self, off: int, data: bytes) -> None:
        if off + len(data) > self.size:
            raise RbdError(EINVAL, "write past end of image")
        snapc = self._snapc()
        cursor = 0
        has_parent = self.header.get("parent") is not None
        for objno, obj_off, ln in self._extents(off, len(data)):
            if has_parent:
                await self._copy_up(objno)
            await self.ioctx.write(
                self._data_oid(objno),
                data[cursor : cursor + ln],
                obj_off,
                snapc=snapc,
            )
            cursor += ln

    async def read(self, off: int, length: int, snap_name: str | None = None) -> bytes:
        if off >= self.size:
            return b""
        length = min(length, self.size - off)
        snap_id = 0
        if snap_name is not None:
            snap_id = self._snap_by_name(snap_name)["id"]
        parts = []
        for objno, obj_off, ln in self._extents(off, length):
            data = await self._read_object(objno, snap_id)
            parts.append(data[obj_off : obj_off + ln].ljust(ln, b"\x00"))
        return b"".join(parts)

    async def _read_object(self, objno: int, snap_id: int) -> bytes:
        """Block reads zero-fill absent objects/holes; an absent object
        of a CLONE falls through to the parent snapshot within the
        overlap (ObjectRequest's read-from-parent semantics)."""
        from ..client.rados import RadosError

        try:
            return await self.ioctx.read(self._data_oid(objno), snap=snap_id)
        except RadosError as e:
            if e.errno != -ENOENT:
                raise
            return await self._read_parent_object(objno)

    async def _parent(self) -> "Image | None":
        p = self.header.get("parent")
        if p is None:
            return None
        if getattr(self, "_parent_img", None) is None:
            self._parent_img = Image(
                self.ioctx, p.get("image_name", ""), p["image_id"]
            )
            await self._parent_img._load_header()
        return self._parent_img

    async def _read_parent_object(self, objno: int) -> bytes:
        """The child's view of one object as served by the parent snap,
        clipped to the overlap (zeros past it)."""
        p = self.header.get("parent")
        if p is None:
            return b""
        start = objno * self.object_bytes
        if start >= p["overlap"]:
            return b""
        parent = await self._parent()
        data = await parent.read(
            start,
            min(self.object_bytes, p["overlap"] - start),
            snap_name=p["snap_name"],
        )
        return data

    async def _copy_up(self, objno: int) -> None:
        """First write to a parent-backed object copies the parent's
        bytes into the child (ObjectRequest copy-up), so the write lands
        on a child-owned object and the parent stays untouched."""
        from ..client.rados import RadosError

        oid = self._data_oid(objno)
        try:
            await self.ioctx.stat(oid)
            return  # child already owns the object
        except RadosError as e:
            if e.errno != -ENOENT:
                raise
        base = await self._read_parent_object(objno)
        if base.rstrip(b"\x00"):
            await self.ioctx.write(oid, base, 0, snapc=self._snapc())

    async def resize(self, new_size: int) -> None:
        """librbd::resize; shrinking drops whole objects past the end.
        Deletions/truncates carry the SnapContext, so the OSD preserves
        snapshot clones (whiteout heads) before discarding bytes."""
        old = self.size
        if new_size < old:
            snapc = self._snapc()
            ob = self.object_bytes
            first_dead = (new_size + ob - 1) // ob
            last = (old - 1) // ob if old else 0
            for objno in range(first_dead, last + 1):
                await unless_absent(self.ioctx.remove(self._data_oid(objno), snapc=snapc))
            if new_size % ob:
                await unless_absent(self.ioctx.truncate(
                    self._data_oid(new_size // ob), new_size % ob, snapc=snapc
                ))
        self.header["size"] = new_size
        self.header["max_size"] = max(self.header.get("max_size", old), new_size)
        parent = self.header.get("parent")
        if parent is not None and new_size < parent["overlap"]:
            # shrinking a clone shrinks what the parent still backs
            # (librbd trims the parent overlap on resize)
            parent["overlap"] = new_size
        await self._save_header()

    # -- snapshots ---------------------------------------------------------------

    def _snap_by_name(self, name: str) -> dict:
        for snap in self.header["snaps"]:
            if snap["name"] == name:
                return snap
        raise RbdError(ENOENT, f"snapshot {name!r} not found")

    async def snap_create(self, name: str) -> None:
        """librbd snap_create: allocate a pool snap id (durable via paxos)
        and record it; the OSDs clone lazily as the head is modified."""
        if any(s["name"] == name for s in self.header["snaps"]):
            raise RbdError(EEXIST, f"snapshot {name!r} exists")
        pool = self.ioctx.rados.objecter.osdmap.pools[self.ioctx.pool_id]
        snap_id = await self.ioctx.rados.selfmanaged_snap_create(pool.name)
        self.header["snaps"].append(
            {"id": snap_id, "name": name, "size": self.size}
        )
        await self._save_header()

    async def snap_list(self) -> list[str]:
        return [s["name"] for s in self.header["snaps"]]

    async def snap_rollback(self, name: str) -> None:
        """librbd snap_rollback: every data object reverts server-side to
        its state at the snap (OSD ROLLBACK op); objects born after the
        snap are deleted (they did not exist then).  Deletions carry the
        SnapContext so newer snapshots keep their content."""
        from ..client.rados import RadosError

        snap = self._snap_by_name(name)
        span = max(self.size, self.header.get("max_size", self.size))
        objects = (span + self.object_bytes - 1) // self.object_bytes
        snapc = self._snapc()
        for objno in range(objects):
            oid = self._data_oid(objno)
            try:
                await self.ioctx.stat(oid, snap=snap["id"])
            except RadosError as e:
                if e.errno != -ENOENT:
                    raise
                # absent at the snap: must be absent after rollback
                try:
                    await self.ioctx.remove(oid, snapc=snapc)
                except RadosError as e2:
                    if e2.errno != -ENOENT:
                        raise
                continue
            await self.ioctx.rollback(oid, snap["id"], snapc=snapc)
        self.header["size"] = snap.get("size", self.size)
        await self._save_header()

    async def export(self, snap_name: str | None = None) -> bytes:
        """rbd export: the full image (or a snapshot's view) as bytes,
        read in object-size chunks (rbd export's sequential reader)."""
        out = bytearray()
        off = 0
        while off < self.size:
            take = min(self.object_bytes, self.size - off)
            out += await self.read(off, take, snap_name=snap_name)
            off += take
        return bytes(out)

    async def import_bytes(self, data: bytes) -> None:
        """rbd import payload: write the blob from offset 0 (the caller
        created the image at len(data))."""
        off = 0
        while off < len(data):
            take = min(self.object_bytes, len(data) - off)
            await self.write(off, data[off : off + take])
            off += take

    async def snap_protect(self, name: str) -> None:
        """rbd snap protect: required before cloning; a protected snap
        cannot be removed (librbd snap_protect)."""
        snap = self._snap_by_name(name)
        snap["protected"] = True
        await self._save_header()

    async def snap_unprotect(self, name: str) -> None:
        """rbd snap unprotect: refused while clones of the snap exist
        (librbd snap_unprotect scans rbd_children)."""
        snap = self._snap_by_name(name)
        rbd = RBD(self.ioctx)
        if (await rbd._read_children()).get(f"{self.id}@{snap['id']}"):
            raise RbdError(EBUSY, f"snapshot {name!r} has clones")
        snap["protected"] = False
        await self._save_header()

    async def snap_is_protected(self, name: str) -> bool:
        return bool(self._snap_by_name(name).get("protected"))

    async def flatten(self) -> None:
        """rbd flatten: copy every parent-backed object into the child,
        then sever the parent link (librbd flatten; the child becomes a
        standalone image and the snap can be unprotected)."""
        p = self.header.get("parent")
        if p is None:
            raise RbdError(EINVAL, f"image {self.name!r} has no parent")
        objects = (p["overlap"] + self.object_bytes - 1) // self.object_bytes
        for objno in range(objects):
            await self._copy_up(objno)
        rbd = RBD(self.ioctx)
        children = await rbd._read_children()
        key = f"{p['image_id']}@{p['snap_id']}"
        children[key] = [c for c in children.get(key, []) if c != self.id]
        await rbd._write_children(children)
        del self.header["parent"]
        self._parent_img = None
        await self._save_header()

    async def snap_remove(self, name: str) -> None:
        """librbd snap_remove: per-object server-side snap trim — the OSD
        drops the snap from each clone's coverage and deletes clones no
        snapshot references anymore (the snap-trimmer, scoped to this
        image's objects)."""
        from ..client.rados import RadosError

        snap = self._snap_by_name(name)
        if snap.get("protected"):
            raise RbdError(EBUSY, f"snapshot {name!r} is protected")
        span = max(self.size, self.header.get("max_size", self.size))
        objects = (span + self.object_bytes - 1) // self.object_bytes
        for objno in range(objects):
            try:
                await self.ioctx.snap_trim(self._data_oid(objno), snap["id"])
            except RadosError as e:
                if e.errno != -ENOENT:
                    raise
        self.header["snaps"] = [
            s for s in self.header["snaps"] if s["name"] != name
        ]
        await self._save_header()
