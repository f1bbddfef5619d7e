"""librados-style client API — mirror of src/librados / src/include/rados.

The reference's C++ `librados::Rados` / `IoCtx` surface
(src/include/rados/librados.hpp), async-native: connect,
mon commands, pool-scoped I/O contexts with object read/write/stat/
xattr/remove, all flowing through the Objecter op engine exactly as the
reference's IoCtxImpl does (src/librados/IoCtxImpl.cc → Objecter).

The port's copy of `ceph_tpu/client/rados.py`.
"""

from __future__ import annotations

import json

from ..common.errs import ENOENT
from ..mon.monmap import MonMap
from ..msg.messages import OSDOp
from .objecter import Objecter


class RadosError(Exception):
    def __init__(self, err: int, msg: str = ""):
        self.errno = -abs(err)
        super().__init__(f"{msg} (errno {self.errno})")


def _check(result: int, what: str) -> None:
    if result < 0:
        raise RadosError(result, what)


class Rados:
    """Cluster handle (librados::Rados)."""

    def __init__(
        self,
        monmap: MonMap,
        name: str = "client.admin",
        secret: bytes | None = None,  # cephx key (rados_conf key equivalent)
        secure: bool = False,
        compress: bool = False,
        stack: str = "posix",  # ms_type (msg/stack.py)
    ):
        self.name = name
        auth = None
        if secret is not None:
            from ..auth.cephx import CephxAuth

            auth = CephxAuth.for_client(name, secret)
        self.objecter = Objecter(
            name, monmap, auth=auth, secure=secure, compress=compress,
            stack=stack,
        )
        self._connected = False

    async def connect(self, timeout: float = 5.0) -> None:
        await self.objecter.start(timeout)
        self._connected = True

    async def shutdown(self) -> None:
        await self.objecter.stop()
        self._connected = False

    async def mon_command(self, cmd: dict, timeout: float = 5.0):
        """JSON command to the mon cluster (rados_mon_command)."""
        return await self.objecter.monc.command(cmd, timeout)

    async def pool_create(
        self, name: str, pool_type: str = "replicated", profile: str = "", **kw
    ) -> None:
        cmd = {"prefix": "osd pool create", "pool": name, "pool_type": pool_type}
        if profile:
            cmd["erasure_code_profile"] = profile
        cmd.update(kw)
        retval, rs, _ = await self.mon_command(cmd)
        _check(retval, rs)

    async def pool_list(self) -> list[str]:
        retval, rs, outbl = await self.mon_command({"prefix": "osd pool ls"})
        _check(retval, rs)
        return json.loads(outbl.decode() or "[]")

    async def selfmanaged_snap_create(self, pool_name: str) -> int:
        """Allocate a self-managed snapshot id (rados_ioctx_
        selfmanaged_snap_create): durable via paxos before first use."""
        retval, rs, outbl = await self.mon_command(
            {"prefix": "osd pool selfmanaged-snap-create", "pool": pool_name}
        )
        _check(retval, rs)
        return int(json.loads(outbl.decode())["snap_id"])

    async def open_ioctx(self, pool_name: str, timeout: float = 5.0) -> "IoCtx":
        """Pool handle (rados_ioctx_create); waits for the pool to appear
        in our map (pool creation is a paxos round away)."""
        import asyncio
        import time

        deadline = time.monotonic() + timeout
        while True:
            pool = self.objecter.osdmap.get_pool(pool_name)
            if pool is not None:
                return IoCtx(self, pool.id)
            if time.monotonic() > deadline:
                raise RadosError(ENOENT, f"pool {pool_name!r} not found")
            await asyncio.sleep(0.05)
            await self.objecter.monc.resubscribe()


class IoCtx:
    """Pool-scoped I/O context (librados::IoCtx).

    Snapshots follow librados' self-managed model: the caller sets a
    SnapContext (`set_snap_context`) that rides every write so the OSD
    clones on first-write-after-snap; reads address a snapshot with the
    `snap=` parameter (rados_ioctx_snap_set_read)."""

    def __init__(self, rados: Rados, pool_id: int):
        self.rados = rados
        self.pool_id = pool_id
        self.snap_seq = 0
        self.snaps: list[int] = []  # descending, newest first

    def set_snap_context(self, snap_seq: int, snaps: list[int]) -> None:
        """rados_ioctx_selfmanaged_snap_set_write_ctx."""
        self.snap_seq = snap_seq
        self.snaps = sorted(snaps, reverse=True)

    async def _op(
        self,
        oid: str,
        ops: list[OSDOp],
        timeout: float = 10.0,
        snap: int = 0,
        snapc: tuple[int, list[int]] | None = None,
    ):
        # A per-call snapc (librados' write_op snapc) overrides the handle's
        # ambient context — concurrent writers on one shared IoCtx must not
        # race each other's SnapContext.
        seq, snaps = snapc if snapc is not None else (self.snap_seq, self.snaps)
        return await self.rados.objecter.op_submit(
            self.pool_id,
            oid,
            ops,
            timeout=timeout,
            snap_seq=seq,
            snaps=snaps,
            snap_id=snap,
        )

    # -- writes ---------------------------------------------------------------

    async def write(self, oid: str, data: bytes, off: int = 0, snapc=None) -> None:
        rep = await self._op(
            oid, [OSDOp(op=OSDOp.WRITE, off=off, data=bytes(data))], snapc=snapc
        )
        _check(rep.result, f"write {oid}")

    async def write_full(self, oid: str, data: bytes, snapc=None) -> None:
        rep = await self._op(
            oid, [OSDOp(op=OSDOp.WRITEFULL, data=bytes(data))], snapc=snapc
        )
        _check(rep.result, f"write_full {oid}")

    async def append(self, oid: str, data: bytes, snapc=None) -> None:
        rep = await self._op(
            oid, [OSDOp(op=OSDOp.APPEND, data=bytes(data))], snapc=snapc
        )
        _check(rep.result, f"append {oid}")

    async def zero(self, oid: str, off: int, length: int, snapc=None) -> None:
        """rados_write zero extent (CEPH_OSD_OP_ZERO): reads as zeros."""
        rep = await self._op(
            oid, [OSDOp(op=OSDOp.ZERO, off=off, len=length)], snapc=snapc
        )
        _check(rep.result, f"zero {oid}")

    async def writesame(
        self, oid: str, data: bytes, off: int, length: int, snapc=None
    ) -> None:
        """rados_writesame: tile `data` across [off, off+length)."""
        rep = await self._op(
            oid,
            [OSDOp(op=OSDOp.WRITESAME, off=off, len=length, data=bytes(data))],
            snapc=snapc,
        )
        _check(rep.result, f"writesame {oid}")

    async def truncate(self, oid: str, size: int, snapc=None) -> None:
        rep = await self._op(
            oid, [OSDOp(op=OSDOp.TRUNCATE, off=size)], snapc=snapc
        )
        _check(rep.result, f"truncate {oid}")

    async def remove(self, oid: str, snapc=None) -> None:
        rep = await self._op(oid, [OSDOp(op=OSDOp.DELETE)], snapc=snapc)
        _check(rep.result, f"remove {oid}")

    async def setxattr(self, oid: str, name: str, value: bytes) -> None:
        rep = await self._op(
            oid, [OSDOp(op=OSDOp.SETXATTR, name=name, data=bytes(value))]
        )
        _check(rep.result, f"setxattr {oid}:{name}")

    async def rmxattr(self, oid: str, name: str) -> None:
        rep = await self._op(oid, [OSDOp(op=OSDOp.RMXATTR, name=name)])
        _check(rep.result, f"rmxattr {oid}:{name}")

    CMPXATTR_OPS = {"eq": 1, "ne": 2, "gt": 3, "gte": 4, "lt": 5, "lte": 6}

    def cmpxattr_op(self, name: str, value: bytes, op: str = "eq") -> OSDOp:
        """Build a CMPXATTR guard sub-op for a compound `operate` call:
        the transaction aborts with -ECANCELED unless the xattr compares
        true (rados_cmpxattr / ObjectOperation::cmpxattr)."""
        return OSDOp(
            op=OSDOp.CMPXATTR, name=name, data=bytes(value),
            off=self.CMPXATTR_OPS[op],
        )

    async def cmpxattr(
        self, oid: str, name: str, value: bytes, op: str = "eq"
    ) -> None:
        rep = await self._op(oid, [self.cmpxattr_op(name, value, op)])
        _check(rep.result, f"cmpxattr {oid}:{name}")

    async def operate(self, oid: str, ops: list[OSDOp], snapc=None):
        """Compound object operation, applied ATOMICALLY in order — the
        ObjectWriteOperation/ObjectReadOperation surface.  Returns the
        reply's per-op outdata list; raises on a nonzero result (a failed
        guard aborts the whole compound with -ECANCELED)."""
        rep = await self._op(oid, ops, snapc=snapc)
        _check(rep.result, f"operate {oid}")
        return list(rep.outdata)

    # -- omap (rados_omap_* / ObjectOperation omap ops; replicated pools
    # only — EC pools answer -EOPNOTSUPP exactly like the reference) -----------

    async def omap_set(self, oid: str, kv: dict[str, bytes]) -> None:
        from ..common.encoding import encode_kv_map

        rep = await self._op(
            oid, [OSDOp(op=OSDOp.OMAPSETVALS, data=encode_kv_map(kv))]
        )
        _check(rep.result, f"omap_set {oid}")

    async def omap_get_vals(self, oid: str) -> dict[str, bytes]:
        from ..common.encoding import decode_kv_map

        rep = await self._op(oid, [OSDOp(op=OSDOp.OMAPGETVALS)])
        _check(rep.result, f"omap_get_vals {oid}")
        return decode_kv_map(rep.outdata[0])

    async def omap_get_keys(self, oid: str) -> list[str]:
        from ..common.encoding import decode_str_list

        rep = await self._op(oid, [OSDOp(op=OSDOp.OMAPGETKEYS)])
        _check(rep.result, f"omap_get_keys {oid}")
        return decode_str_list(rep.outdata[0])

    async def omap_rm_keys(self, oid: str, keys: list[str]) -> None:
        from ..common.encoding import encode_str_list

        rep = await self._op(
            oid, [OSDOp(op=OSDOp.OMAPRMKEYS, data=encode_str_list(keys))]
        )
        _check(rep.result, f"omap_rm_keys {oid}")

    async def omap_clear(self, oid: str) -> None:
        rep = await self._op(oid, [OSDOp(op=OSDOp.OMAPCLEAR)])
        _check(rep.result, f"omap_clear {oid}")

    # -- snapshots -------------------------------------------------------------

    async def rollback(self, oid: str, snap_id: int, snapc=None) -> None:
        """rados_ioctx_selfmanaged_snap_rollback: head := state at snap.
        Rollback is a write: the snapc clones the pre-rollback head for
        any newer snapshot first."""
        rep = await self._op(
            oid, [OSDOp(op=OSDOp.ROLLBACK, off=snap_id)], snapc=snapc
        )
        _check(rep.result, f"rollback {oid}@{snap_id}")

    async def list_snaps(self, oid: str) -> dict:
        """The object's SnapSet ({'seq', 'clones'}; rados listsnaps)."""
        rep = await self._op(oid, [OSDOp(op=OSDOp.LIST_SNAPS)])
        _check(rep.result, f"list_snaps {oid}")
        return json.loads(rep.outdata[0].decode())

    async def snap_trim(self, oid: str, snap_id: int) -> None:
        """Remove one snap from the object, deleting its clone when no
        snap references it (the snap-trimmer's per-object step)."""
        rep = await self._op(oid, [OSDOp(op=OSDOp.DELETE)], snap=snap_id)
        _check(rep.result, f"snap_trim {oid}@{snap_id}")

    # -- copy-from -------------------------------------------------------------

    async def copy_from(
        self, oid: str, src_oid: str, src_snap: int = 0, snapc=None
    ) -> None:
        """Server-side object copy (rados_copy_from / CEPH_OSD_OP_COPY_FROM):
        bytes move OSD->OSD, never through this client.  A write-class op:
        the snap context rides along so the destination's pre-copy head
        clones for new snapshots like any other mutation."""
        rep = await self._op(
            oid, [OSDOp(op=OSDOp.COPY_FROM, name=src_oid, off=src_snap)],
            snapc=snapc,
        )
        _check(rep.result, f"copy_from {src_oid} -> {oid}")

    # -- object classes --------------------------------------------------------

    async def exec(self, oid: str, cls: str, method: str, data: bytes = b"") -> bytes:
        """Run an object-class method server-side (rados_exec /
        CEPH_OSD_OP_CALL): returns the method's output bytes; negative
        method results raise."""
        rep = await self._op(
            oid, [OSDOp(op=OSDOp.CALL, name=f"{cls}.{method}", data=bytes(data))]
        )
        _check(rep.result, f"exec {cls}.{method} on {oid}")
        return rep.outdata[0]

    # -- cache tiering ---------------------------------------------------------

    async def cache_flush(self, oid: str) -> None:
        """Write a dirty cache-tier object back to its base pool
        (rados cache-flush / CEPH_OSD_OP_CACHE_FLUSH)."""
        rep = await self._op(oid, [OSDOp(op=OSDOp.CACHE_FLUSH)])
        _check(rep.result, f"cache_flush {oid}")

    async def cache_evict(self, oid: str) -> None:
        """Drop a clean object from the cache tier (rados cache-evict);
        -EBUSY while dirty."""
        rep = await self._op(oid, [OSDOp(op=OSDOp.CACHE_EVICT)])
        _check(rep.result, f"cache_evict {oid}")

    # -- watch / notify --------------------------------------------------------

    async def watch(self, oid: str, callback) -> int:
        """Register a watch (rados_watch2): `callback(notify_id, payload)`
        runs on every notify; its return bytes (if any) ride the ack back
        to the notifier.  Returns the watch cookie."""
        obj = self.rados.objecter
        obj._next_cookie += 1  # process-wide: no collisions across handles
        cookie = obj._next_cookie
        obj._watches[(self.pool_id, oid, cookie)] = callback
        rep = await self._op(oid, [OSDOp(op=OSDOp.WATCH, off=cookie, len=1)])
        if rep.result < 0:
            obj._watches.pop((self.pool_id, oid, cookie), None)
        _check(rep.result, f"watch {oid}")
        return cookie

    async def unwatch(self, oid: str, cookie: int) -> None:
        rep = await self._op(oid, [OSDOp(op=OSDOp.WATCH, off=cookie, len=0)])
        self.rados.objecter._watches.pop((self.pool_id, oid, cookie), None)
        _check(rep.result, f"unwatch {oid}")

    async def list_watchers(self, oid: str) -> list[dict]:
        """rados listwatchers: [{watcher, cookie}] on the object's head."""
        import json as _json

        rep = await self._op(oid, [OSDOp(op=OSDOp.LIST_WATCHERS)])
        _check(rep.result, f"list_watchers {oid}")
        return _json.loads(rep.outdata[0].decode() or "[]")

    async def notify(
        self, oid: str, payload: bytes = b"", timeout_ms: int = 3000
    ) -> dict:
        """rados_notify2: returns {'acks': {cookie: reply-bytes-hex},
        'timeouts': [cookies that never acked]}."""
        rep = await self._op(
            oid,
            [OSDOp(op=OSDOp.NOTIFY, off=timeout_ms, data=bytes(payload))],
            timeout=max(10.0, timeout_ms / 1000 + 5),
        )
        _check(rep.result, f"notify {oid}")
        return json.loads(rep.outdata[0].decode())

    # -- reads ----------------------------------------------------------------

    async def read(
        self, oid: str, length: int = 0, off: int = 0, snap: int = 0
    ) -> bytes:
        rep = await self._op(
            oid, [OSDOp(op=OSDOp.READ, off=off, len=length)], snap=snap
        )
        _check(rep.result, f"read {oid}")
        return rep.outdata[0] if rep.outdata else b""

    async def stat(self, oid: str, snap: int = 0) -> int:
        """Object size (rados_stat)."""
        rep = await self._op(oid, [OSDOp(op=OSDOp.STAT)], snap=snap)
        _check(rep.result, f"stat {oid}")
        return int.from_bytes(rep.outdata[0], "little")

    async def getxattr(self, oid: str, name: str) -> bytes:
        rep = await self._op(oid, [OSDOp(op=OSDOp.GETXATTR, name=name)])
        _check(rep.result, f"getxattr {oid}:{name}")
        return rep.outdata[0]

    async def list_objects(self) -> list[str]:
        """Pool-wide object enumeration (rados ls): PGLS against every
        PG's primary, in parallel (Objecter pg-targeted NLIST ops)."""
        import asyncio

        pool = self.rados.objecter.osdmap.get_pool(self.pool_id)
        replies = await asyncio.gather(
            *(
                self.rados.objecter.op_submit(
                    self.pool_id, "", [OSDOp(op=OSDOp.PGLS)], ps=ps
                )
                for ps in range(pool.pg_num)
            )
        )
        out: set[str] = set()
        for ps, rep in enumerate(replies):
            _check(rep.result, f"pgls {self.pool_id}.{ps}")
            out.update(json.loads(rep.outdata[0].decode()))
        return sorted(out)
