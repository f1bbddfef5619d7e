"""FileSystem — the CephFS data model over RADOS (src/mds + src/client,
SURVEY.md §2.7).

The reference splits CephFS into metadata (MDS daemons journaling dirs/
inodes into a metadata pool) and data (file contents striped into a data
pool by the client, using the inode-number-derived object names
`<ino>.<objno>`).  This module keeps that split as a library:

- **Metadata pool**: one object per directory, `dir.<ino>`, holding the
  dentry map name → inode record {ino, type, size, mtime, layout} —
  the shape of the reference's CDir/CDentry/CInode stored in dirfrag
  objects (mds/CDir.cc commit path).  The root is `dir.1` (MDS_INO_ROOT).
- **Data pool**: file content striped via the striper with the file's
  layout (client/Inode file_layout_t), objects named `<ino:x>.<objno>` —
  matching the reference's data-object naming
  (client/Client.cc file object naming via file_to_extents).
- An inode allocator object hands out inos (the MDS's inotable).

Single-MDS-equivalent consistency: operations are read-modify-write on
one directory object (the reference serializes through the MDS journal;
here the library is the sole metadata writer — multi-writer coordination
is future work and noted as such).

The port's copy of `ceph_tpu/fs/fs.py`.  Where it differs (ROADMAP C26):
a directory object reads as ENOENT only when it does not exist, and
`rmdir` passes over only a missing directory object
(`client/absent.py`); the reference turns every error of that read into
"not found".  Every other error reaches the caller as `RadosError`.
"""

from __future__ import annotations

import json
import time

from ..client.absent import unless_absent
from ..common.errs import EEXIST, EINVAL, ENOENT
from ..striper import StripedObject, StripePolicy

ROOT_INO = 1  # MDS_INO_ROOT
INOTABLE_OID = "mds_inotable"


class FsError(Exception):
    def __init__(self, err: int, msg: str = ""):
        self.errno = -abs(err)
        super().__init__(f"{msg} (errno {self.errno})")


class FileSystem:
    """libcephfs-style surface (src/libcephfs.cc API shape) over a
    metadata IoCtx + data IoCtx pair."""

    def __init__(self, meta_ioctx, data_ioctx, layout: StripePolicy | None = None):
        self.meta = meta_ioctx
        self.data = data_ioctx
        self.layout = layout or StripePolicy(
            stripe_unit=64 * 1024, stripe_count=2, object_size=1 << 20
        )

    # -- bootstrap -------------------------------------------------------------

    async def mkfs(self) -> None:
        """Create the root directory + inode table (ceph fs new /
        MDS mkfs)."""
        await self.meta.write_full(INOTABLE_OID, json.dumps({"next": 2}).encode())
        await self._store_dir(ROOT_INO, {})

    async def _alloc_ino(self) -> int:
        table = json.loads((await self.meta.read(INOTABLE_OID)).decode())
        ino = table["next"]
        table["next"] = ino + 1
        await self.meta.write_full(INOTABLE_OID, json.dumps(table).encode())
        return ino

    # -- directory objects -----------------------------------------------------

    async def _load_dir(self, ino: int) -> dict:
        raw = await unless_absent(self.meta.read(f"dir.{ino}"))
        if raw is None:
            raise FsError(ENOENT, f"directory inode {ino} not found")
        return json.loads(raw.decode() or "{}")

    async def _store_dir(self, ino: int, entries: dict) -> None:
        await self.meta.write_full(f"dir.{ino}", json.dumps(entries).encode())

    # -- path walking (Server::rdlock_path_xlock_dentry analog) ----------------

    @staticmethod
    def _split(path: str) -> list[str]:
        return [p for p in path.strip("/").split("/") if p]

    async def _walk(self, path: str) -> tuple[int, dict]:
        """Resolve a directory path -> (dir ino, entries)."""
        ino = ROOT_INO
        entries = await self._load_dir(ino)
        for name in self._split(path):
            ent = entries.get(name)
            if ent is None:
                raise FsError(ENOENT, f"no such directory: {name}")
            if ent["type"] != "dir":
                raise FsError(EINVAL, f"{name} is not a directory")
            ino = ent["ino"]
            entries = await self._load_dir(ino)
        return ino, entries

    async def _walk_parent(self, path: str) -> tuple[int, dict, str]:
        parts = self._split(path)
        if not parts:
            raise FsError(EINVAL, "path resolves to root")
        parent = "/".join(parts[:-1])
        ino, entries = await self._walk(parent)
        return ino, entries, parts[-1]

    # -- namespace ops ---------------------------------------------------------

    async def mkdir(self, path: str) -> None:
        dino, entries, name = await self._walk_parent(path)
        if name in entries:
            raise FsError(EEXIST, f"{path} exists")
        ino = await self._alloc_ino()
        await self._store_dir(ino, {})
        entries[name] = {"type": "dir", "ino": ino, "mtime": time.time()}
        await self._store_dir(dino, entries)

    async def listdir(self, path: str = "/") -> list[str]:
        _ino, entries = await self._walk(path)
        return sorted(entries)

    async def stat(self, path: str) -> dict:
        if not self._split(path):
            return {"type": "dir", "ino": ROOT_INO, "size": 0}
        _dino, entries, name = await self._walk_parent(path)
        ent = entries.get(name)
        if ent is None:
            raise FsError(ENOENT, path)
        return dict(ent)

    async def rename(self, src: str, dst: str) -> None:
        """Server::handle_client_rename (same-or-cross directory).
        POSIX replace semantics: an existing destination FILE is
        replaced (its data objects removed); renaming over a directory
        fails (the MDS requires an empty dir target; we reject outright)."""
        sparts, dparts = self._split(src), self._split(dst)
        if dparts[: len(sparts)] == sparts:
            # moving a directory into its own subtree would detach it into
            # an unreachable cycle (POSIX/MDS: EINVAL)
            raise FsError(EINVAL, f"cannot move {src} inside itself")
        sdino, sentries, sname = await self._walk_parent(src)
        if sname not in sentries:
            raise FsError(ENOENT, src)
        ddino, dentries, dname = await self._walk_parent(dst)
        if sdino == ddino:
            dentries = sentries
        existing = dentries.get(dname)
        if existing is not None:
            if existing["type"] == "dir":
                raise FsError(EINVAL, f"{dst} is a directory")
            await self._file_data(existing["ino"]).remove()
        ent = sentries.pop(sname)
        dentries[dname] = ent
        await self._store_dir(sdino, sentries)
        if sdino != ddino:
            await self._store_dir(ddino, dentries)

    async def rmdir(self, path: str) -> None:
        dino, entries, name = await self._walk_parent(path)
        ent = entries.get(name)
        if ent is None:
            raise FsError(ENOENT, path)
        if ent["type"] != "dir":
            raise FsError(EINVAL, f"{path} is not a directory")
        victim = await self._load_dir(ent["ino"])
        if victim:
            raise FsError(EINVAL, f"{path} not empty")
        await unless_absent(self.meta.remove(f"dir.{ent['ino']}"))
        del entries[name]
        await self._store_dir(dino, entries)

    # -- file ops --------------------------------------------------------------

    def _file_data(self, ino: int) -> StripedObject:
        # data objects "<ino hex>.<objno>" (Client file_to_extents naming)
        return StripedObject(self.data, f"{ino:x}", policy=self.layout)

    async def write_file(self, path: str, data: bytes, off: int = 0) -> None:
        """create-or-open + write (Client::ll_write path, collapsed)."""
        dino, entries, name = await self._walk_parent(path)
        ent = entries.get(name)
        if ent is None:
            ino = await self._alloc_ino()
            ent = {"type": "file", "ino": ino, "size": 0, "mtime": time.time()}
        elif ent["type"] != "file":
            raise FsError(EINVAL, f"{path} is a directory")
        await self._file_data(ent["ino"]).write(data, off)
        ent["size"] = max(ent["size"], off + len(data))
        ent["mtime"] = time.time()
        entries[name] = ent
        await self._store_dir(dino, entries)

    async def read_file(self, path: str, length: int = 0, off: int = 0) -> bytes:
        st = await self.stat(path)
        if st["type"] != "file":
            raise FsError(EINVAL, f"{path} is a directory")
        return await self._file_data(st["ino"]).read(length, off)

    async def truncate_file(self, path: str, size: int) -> None:
        dino, entries, name = await self._walk_parent(path)
        ent = entries.get(name)
        if ent is None or ent["type"] != "file":
            raise FsError(ENOENT, path)
        await self._file_data(ent["ino"]).truncate(size)
        ent["size"] = size
        await self._store_dir(dino, entries)

    async def unlink(self, path: str) -> None:
        dino, entries, name = await self._walk_parent(path)
        ent = entries.get(name)
        if ent is None:
            raise FsError(ENOENT, path)
        if ent["type"] != "file":
            raise FsError(EINVAL, f"{path} is a directory; use rmdir")
        await self._file_data(ent["ino"]).remove()
        del entries[name]
        await self._store_dir(dino, entries)
