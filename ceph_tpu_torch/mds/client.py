"""CephFS client against a live MDS — mirror of src/client/Client.cc.

Metadata ops go to the MDS over MClientRequest/MClientReply; file DATA
I/O goes straight to the data pool through the striper using the layout
the MDS handed back (Client.cc file_to_extents → Objecter) — the MDS is
never in the data path.  Capabilities gate file access: open() acquires
them, a revoke push (MClientCaps REVOKE, when another client wants a
conflicting open) invalidates the handle, and the next use raises so the
caller re-opens (the reference's cap-wait loop, surfaced as an explicit
error in this async library).

The port's copy of `ceph_tpu/mds/client.py`.  Where it differs: `secret=`
runs cephx on the client's sessions (the MDS's and the monitors'), and
`layout=` names the layout of the files this client creates (the MDS
checks it; without one the MDS's own applies, as in the reference).  A
file's truncate and purge go through the striper, which takes only a
missing object for absent (ROADMAP C26).
"""

from __future__ import annotations

import asyncio
import json

from ..common.errs import EAGAIN, EEXIST
from ..msg.messages import MClientCaps, MClientReply, MClientRequest, MMDSMap
from ..msg.messenger import Connection, Dispatcher, Messenger
from ..striper import StripedObject, StripePolicy


class FsClientError(Exception):
    def __init__(self, err: int, msg: str = ""):
        self.errno = -abs(err)
        super().__init__(f"{msg} (errno {self.errno})")


class FileHandle:
    """An open file: inode record + held caps (the Fh/Inode pair)."""

    def __init__(self, client: "CephFSClient", path: str, entry: dict, caps: str):
        self.client = client
        self.path = path
        self.entry = entry
        self.caps = caps
        self.valid = True
        self._inflight = 0
        self._idle = asyncio.Event()
        self._idle.set()

    def _require(self, need: str) -> None:
        if not self.valid:
            raise FsClientError(
                EAGAIN, f"{self.path}: caps revoked; re-open the file"
            )
        if need == "w" and self.caps != "w":
            raise FsClientError(EAGAIN, f"{self.path}: no write caps")

    def _data(self) -> StripedObject:
        lay = self.entry["layout"]
        return StripedObject(
            self.client.data,
            f"{self.entry['ino']:x}",
            StripePolicy(
                stripe_unit=lay["stripe_unit"],
                stripe_count=lay["stripe_count"],
                object_size=lay["object_size"],
            ),
        )

    def _op_started(self) -> None:
        self._inflight += 1
        self._idle.clear()

    def _op_done(self) -> None:
        self._inflight -= 1
        if self._inflight == 0:
            self._idle.set()

    async def write(self, data: bytes, off: int = 0) -> None:
        self._require("w")
        self._op_started()
        try:
            await self._data().write(data, off)
            new_size = max(self.entry.get("size", 0), off + len(data))
            if new_size != self.entry.get("size", 0):
                # ino-addressed: a concurrent rename must not land this on
                # a different file that now occupies our old path
                rep = await self.client._request(
                    "setattr",
                    {
                        "path": self.path,
                        "ino": self.entry["ino"],
                        "size": new_size,
                    },
                )
                self.entry = rep["entry"]
        finally:
            self._op_done()

    async def read(self, length: int = 0, off: int = 0) -> bytes:
        self._require("r")
        size = self.entry.get("size", 0)
        if off >= size:
            return b""
        length = min(length or size - off, size - off)
        return await self._data().read(length, off)

    async def truncate(self, size: int) -> None:
        """Shrink/extend: data objects truncate first, then the inode size
        (Client::ll_truncate ordering — stale striped bytes must never
        reappear on a later extension)."""
        self._require("w")
        self._op_started()
        try:
            await self._data().truncate(size)
            rep = await self.client._request(
                "setattr",
                {"path": self.path, "ino": self.entry["ino"], "size": size},
            )
            self.entry = rep["entry"]
        finally:
            self._op_done()

    async def close(self) -> None:
        if self.valid:
            self.valid = False
            ino = self.entry["ino"]
            held = self.client._handles.get(ino)
            if held is not None:
                try:
                    held.remove(self)
                except ValueError:
                    pass
                if not held:
                    del self.client._handles[ino]
            await self.client._release_caps(ino)


class CephFSClient(Dispatcher):
    """libcephfs-like handle to the fs: active MDS + a data pool.

    Two addressing modes: a fixed `mds_addr` (embedded/single-MDS use),
    or `monmap=` — the client subscribes to the mdsmap, resolves rank 0
    from the FSMap, and RE-resolves on failover, retrying the op against
    the promoted standby (Client::handle_mds_map + request resend)."""

    def __init__(
        self, mds_addr: str = "", data_ioctx=None, name: str = "client.fs",
        stack: str = "posix", monmap=None, fs_name: str = "",
        layout: StripePolicy | None = None, secret: bytes | None = None,
    ):
        self.mds_addr = mds_addr
        self.fs_name = fs_name  # "" = the first filesystem in the fsmap
        self.data = data_ioctx
        self.monmap = monmap
        # per-instance identity for MDS request dedup: (client_id, tid)
        # is stable across retries, so a resent non-idempotent op replays
        # the MDS's recorded result instead of re-executing (the
        # reference's session-scoped completed_requests)
        import secrets

        self.client_id = f"{name}.{secrets.token_hex(4)}"
        self.layout = layout
        self.monc = None
        self._mdsmap_epoch = 0
        self._mds_changed = asyncio.Event()
        self._stack = stack
        self._auth = None
        if secret is not None:
            from ..auth.cephx import CephxAuth

            self._auth = CephxAuth.for_client(name, secret)
        self.msgr = Messenger(name, stack=stack, auth=self._auth)
        self.msgr.add_dispatcher_head(self)
        self._tid = 0
        self._replies: dict[int, asyncio.Future] = {}
        self._handles: dict[int, list[FileHandle]] = {}  # ino -> open fhs

    async def connect(self, timeout: float = 10.0) -> None:
        """Mon mode: subscribe to the mdsmap and wait for an active MDS."""
        if self.monmap is None:
            return
        from ..mon.client import MonClient

        self.monc = MonClient(
            self.msgr.name + ".monc", self.monmap,
            msgr=Messenger(self.msgr.name + ".monc", stack=self._stack, auth=self._auth),
        )
        self.monc.msgr.add_dispatcher_tail(self)
        deadline = asyncio.get_event_loop().time() + timeout
        while not self.mds_addr:
            await self.monc.subscribe("mdsmap")
            if asyncio.get_event_loop().time() > deadline:
                raise FsClientError(EAGAIN, "no active MDS in the fsmap")
            try:
                await asyncio.wait_for(self._mds_changed.wait(), 0.5)
            except asyncio.TimeoutError:
                pass
            self._mds_changed.clear()

    async def shutdown(self) -> None:
        if self.monc is not None:
            await self.monc.msgr.shutdown()
            self.monc = None
        await self.msgr.shutdown()

    # -- dispatch --------------------------------------------------------------

    def ms_dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, MMDSMap):
            if msg.epoch > self._mdsmap_epoch:
                self._mdsmap_epoch = msg.epoch
                fss = msg.filesystems()
                if self.fs_name:
                    fs = fss.get(self.fs_name, {})
                else:
                    fs = fss[sorted(fss)[0]] if fss else {}
                addr = fs.get("active_addr", "")
                if addr != self.mds_addr:
                    self.mds_addr = addr
                    if addr:
                        self._mds_changed.set()
            return True
        if isinstance(msg, MClientReply):
            fut = self._replies.pop(msg.tid, None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return True
        if isinstance(msg, MClientCaps) and msg.op == MClientCaps.REVOKE:
            # the MDS wants these caps back: invalidate local handles, then
            # ack only after their in-flight data ops DRAIN — acking while
            # a write coroutine is suspended mid-striper would let our
            # bytes land after the new holder's grant (Client::handle_caps
            # flush-before-ack)
            handles = self._handles.pop(msg.ino, [])
            for fh in handles:
                fh.valid = False
            ack = MClientCaps(
                op=MClientCaps.ACK, ino=msg.ino, caps="", tid=msg.tid
            )

            async def _drain_then_ack() -> None:
                for fh in handles:
                    await fh._idle.wait()
                try:
                    await conn.send_message(ack)
                except ConnectionError:
                    pass

            asyncio.get_event_loop().create_task(_drain_then_ack())
            return True
        return False

    async def _request(self, op: str, args: dict, timeout: float = 10.0) -> dict:
        """One metadata op with failover retry in mon mode: a dead or
        not-yet-active MDS (-EAGAIN / connection loss / reply timeout)
        re-resolves rank 0 from the mdsmap and resends (Client request
        resend on mds_map, Client.cc).

        The reqid (client_id, tid) is allocated ONCE and reused on every
        retry — a fresh tid per attempt would defeat the MDS's completed-
        request dedup and re-execute non-idempotent ops (mkdir/create/
        unlink/rename), surfacing spurious EEXIST/ENOENT after failover."""
        deadline = asyncio.get_event_loop().time() + timeout
        attempt = 0
        self._tid += 1
        tid = self._tid
        while True:
            fut: asyncio.Future = asyncio.get_event_loop().create_future()
            self._replies[tid] = fut
            msg = MClientRequest(
                tid=tid, op=op, args=json.dumps(args).encode(),
                client=self.client_id,
            )
            reply: MClientReply | None = None
            try:
                await self.msgr.send_to(self.mds_addr, msg)
                step = 10.0 if self.monc is None else 1.0
                left = deadline - asyncio.get_event_loop().time()
                reply = await asyncio.wait_for(fut, max(min(step, left), 0.05))
            except (ConnectionError, asyncio.TimeoutError, OSError):
                reply = None
            finally:
                self._replies.pop(tid, None)
            if reply is not None and reply.result != -EAGAIN:
                if reply.result < 0:
                    raise FsClientError(reply.result, f"{op} {args}")
                return json.loads(reply.payload.decode() or "{}")
            if self.monc is None or asyncio.get_event_loop().time() > deadline:
                err = reply.result if reply is not None else EAGAIN
                raise FsClientError(err, f"{op} {args}: mds unavailable")
            # wait for a newer fsmap (or just retry after a beat)
            attempt += 1
            try:
                await self.monc.subscribe("mdsmap", self._mdsmap_epoch + 1)
            except ConnectionError:
                pass
            try:
                await asyncio.wait_for(self._mds_changed.wait(), 0.5)
            except asyncio.TimeoutError:
                pass
            self._mds_changed.clear()

    async def _release_caps(self, ino: int) -> None:
        rel = MClientCaps(op=MClientCaps.RELEASE, ino=ino, caps="", tid=0)
        try:
            await self.msgr.get_connection(self.mds_addr).send_message(rel)
        except ConnectionError:
            pass

    # -- namespace -------------------------------------------------------------

    async def mkdir(self, path: str) -> None:
        await self._request("mkdir", {"path": path})

    async def listdir(self, path: str = "/") -> list[str]:
        return (await self._request("readdir", {"path": path}))["entries"]

    async def listdir_plus(self, path: str = "/") -> dict[str, dict]:
        """readdirplus: name -> entry stat record in one round trip
        (Client::readdirplus; saves the per-entry lookup storm)."""
        return (await self._request("readdirplus", {"path": path}))["entries"]

    async def stat(self, path: str) -> dict:
        return (await self._request("lookup", {"path": path}))["entry"]

    async def rename(self, src: str, dst: str) -> None:
        rep = await self._request("rename", {"src": src, "dst": dst})
        replaced = rep.get("replaced")
        if replaced and replaced.get("type") == "file":
            await self._purge(replaced)

    async def symlink(self, target: str, path: str) -> None:
        """ceph_symlink: create `path` pointing at `target`."""
        await self._request("symlink", {"path": path, "target": target})

    async def readlink(self, path: str) -> str:
        return (await self._request("readlink", {"path": path}))["target"]

    async def rmdir(self, path: str) -> None:
        await self._request("rmdir", {"path": path})

    async def unlink(self, path: str) -> None:
        rep = await self._request("unlink", {"path": path})
        await self._purge(rep["entry"])

    async def _purge(self, entry: dict) -> None:
        """Delete a file's data objects (the client-driven purge the
        reference delegates to the MDS PurgeQueue; same pool effect)."""
        lay = entry.get("layout")
        if not lay:
            return
        await StripedObject(
            self.data,
            f"{entry['ino']:x}",
            StripePolicy(
                stripe_unit=lay["stripe_unit"],
                stripe_count=lay["stripe_count"],
                object_size=lay["object_size"],
            ),
        ).remove()

    # -- files -----------------------------------------------------------------

    async def create(self, path: str) -> FileHandle:
        args = {"path": path, "caps": "w"}
        if self.layout is not None:
            lay = self.layout
            args["layout"] = {"stripe_unit": lay.stripe_unit,
                              "stripe_count": lay.stripe_count,
                              "object_size": lay.object_size}
        rep = await self._request("create", args)
        fh = FileHandle(self, path, rep["entry"], rep["caps"])
        self._handles.setdefault(rep["entry"]["ino"], []).append(fh)
        return fh

    async def open(self, path: str, mode: str = "r") -> FileHandle:
        rep = await self._request("open", {"path": path, "caps": mode})
        fh = FileHandle(self, path, rep["entry"], rep["caps"])
        self._handles.setdefault(rep["entry"]["ino"], []).append(fh)
        return fh

    # -- convenience (whole-file ops) ------------------------------------------

    async def write_file(self, path: str, data: bytes) -> None:
        try:
            fh = await self.create(path)
        except FsClientError as e:
            if e.errno != -EEXIST:
                raise
            fh = await self.open(path, "w")
        try:
            if len(data) < fh.entry.get("size", 0):
                await fh.truncate(len(data))
            if data:
                await fh.write(data, 0)
        finally:
            await fh.close()

    async def read_file(self, path: str) -> bytes:
        fh = await self.open(path, "r")
        try:
            return await fh.read()
        finally:
            await fh.close()
