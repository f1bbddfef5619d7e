"""PGBackend — per-PG storage strategy boundary.

The port of `ceph_tpu/osd/pg_backend.py` (Ceph's src/osd/PGBackend.{h,cc}):
`build_pg_backend` instantiates the codec through the plugin registry
(PGBackend.cc:570-607, plugin name from `profile["plugin"]`) on the
caller's device, `cuda` unless it asks for `cpu`.  The Listener is the
PG's callback surface (PGBackend::Listener): identity, acting set, version
allocation, log append, missing tracking, and the transport hook.
`PGBackend._apply_pushes` writes recovery pushes.  `ReplicatedBackend`
(src/osd/ReplicatedBackend.cc) serves replicated pools: it applies and
fans out each transaction as MOSDRepOp and recovers by whole-object push
and pull, on the host, as the JAX package's does.
"""

from __future__ import annotations

import abc
from typing import Callable

from ..codec.interface import EcError
from ..codec.registry import ErasureCodePluginRegistry
from ..common.errs import EINVAL, EIO
from ..msg.message import Message
from ..msg.messages import (
    MOSDPGPull,
    MOSDPGPush,
    MOSDPGPushReply,
    MOSDRepOp,
    MOSDRepOpReply,
    PgId,
    PushOp,
    ReqId,
)
from ..os.objectstore import ObjectStore, StoreError
from ..os.transaction import Transaction
from ..osd.osdmap import PG_NONE, PgPool
from ..stripe import StripeInfo
from .pg_log import LogEntry, LOG_DELETE, LOG_MODIFY


def shard_coll(pgid: PgId, shard: int) -> str:
    """Collection name for a PG shard — coll_t(spg_t(pgid, shard)) analog
    (see ECTransaction.cc:79-95 writing to per-shard collections);
    shard < 0 is the replicated whole-PG collection."""
    base = f"{pgid.pool}.{pgid.ps}"
    return base if shard < 0 else f"{base}s{shard}"


class PGListener(abc.ABC):
    """PGBackend::Listener — what the PG provides its backend."""

    pgid: PgId

    @abc.abstractmethod
    def whoami(self) -> int:
        """This OSD's id."""

    @abc.abstractmethod
    def whoami_shard(self) -> int:
        """This OSD's shard index in the acting set (-1 replicated)."""

    @abc.abstractmethod
    def acting(self) -> list[int]:
        """shard -> osd id (PG_NONE holes for down shards)."""

    @abc.abstractmethod
    def epoch(self) -> int:
        """Current map epoch."""

    @abc.abstractmethod
    def next_version(self) -> Eversion:
        """Allocate the next log version (primary)."""

    @abc.abstractmethod
    def send_shard(self, osd: int, msg: Message) -> None:
        """Transport hook; must loop back when osd == whoami()
        (the primary sends to itself, ECBackend.h:336-338)."""

    def append_log(self, entry: LogEntry) -> None:
        """Shard-side log append."""

    def get_shard_missing(self, oid: str) -> set[int]:
        """Shard indices known to be missing this object."""
        return set()

    def shard_data_source(self, shard: int, oid: str) -> int:
        """The osd that can serve `shard`'s bytes for `oid`, or PG_NONE.

        Default: the acting member, when it is placed and not missing
        the object.  The PG overrides
        this with stray-shard redirection: when CRUSH slot-fill
        reshuffles an EC acting set, a surviving member's chunks live
        under its OLD shard coll (positional shard identity), and the
        last-clean holder of a slot keeps serving reconstruction reads
        for objects still missing on the new member."""
        acting = self.acting()
        osd = acting[shard] if shard < len(acting) else PG_NONE
        if osd == PG_NONE or shard in self.get_shard_missing(oid):
            return PG_NONE
        return osd

    def on_local_recover(self, oid: str) -> None:
        pass

    def on_global_recover(self, oid: str) -> None:
        pass

    def clog_error(self, msg: str) -> None:
        pass

    def perf_hist(self, name: str, value: float) -> None:
        """Sample a daemon latency histogram (PGs forward to the OSD's
        PerfCounters; standalone harnesses drop the sample)."""


def side_effect_log_entries(listener: PGListener, pgt) -> list:
    """PG-log entries for a transaction's side-effect objects: the snap
    clone it creates and the trimmed clones it deletes.  Without these a
    replica that missed the write would recover the head but never the
    clone (the reference logs clones from make_writeable the same way)."""
    out = []
    if getattr(pgt, "pre_clone", None):
        out.append(
            LogEntry(
                op=LOG_MODIFY,
                oid=pgt.pre_clone,
                version=listener.next_version(),
                reqid=("", 0),
            )
        )
    for extra in getattr(pgt, "also_delete", ()):
        out.append(
            LogEntry(
                op=LOG_DELETE,
                oid=extra,
                version=listener.next_version(),
                reqid=("", 0),
            )
        )
    return out


class PGBackend(abc.ABC):
    def __init__(self, listener: PGListener, store: ObjectStore):
        self.listener = listener
        self.store = store

    @abc.abstractmethod
    def handle_message(self, msg: Message) -> bool:
        """Dispatch a backend sub-op; True if consumed."""

    @abc.abstractmethod
    def submit_transaction(self, pgt, reqid: ReqId, on_commit: Callable[[], None]) -> int:
        ...

    @abc.abstractmethod
    def objects_read_and_reconstruct(
        self, reads, on_complete: Callable[[dict], None], **kw
    ) -> None:
        ...

    @abc.abstractmethod
    def recover_object(
        self, oid: str, missing_on: set[int], on_complete: Callable[[int], None]
    ) -> None:
        ...

    def flush_encodes(self) -> None:
        """Drain any launched-but-undispatched device encodes (EC encode
        pipeline); a no-op for backends without one."""

    def _apply_pushes(self, coll: str, pushes: list[PushOp]) -> list[str]:
        """Write pushed objects + attrs locally (shared by EC shard pushes
        and replicated whole-object pushes); returns the recovered oids."""
        txn = Transaction()
        oids: list[str] = []
        for push in pushes:
            oids.append(push.oid)
            txn.remove(coll, push.oid)
            txn.touch(coll, push.oid)
            txn.write(coll, push.oid, 0, push.data)
            for name, val in push.attrs.items():
                txn.setattr(coll, push.oid, name, val)
            omap = getattr(push, "omap", None)
            if omap:
                txn.omap_setkeys(coll, push.oid, dict(omap))
        self.store.queue_transaction(txn)
        for oid in oids:
            self.listener.on_local_recover(oid)
        return oids


class ReplicatedBackend(PGBackend):
    """Primary-copy replication (src/osd/ReplicatedBackend.cc): the primary
    applies the transaction locally and fans the same transaction to every
    replica via MOSDRepOp; recovery is whole-object push (with pull when the
    primary itself is missing the object)."""

    def __init__(self, listener: PGListener, store: ObjectStore):
        super().__init__(listener, store)
        self._tid = 0
        self.in_flight: dict[int, tuple[set[int], Callable[[], None]]] = {}
        self.pulling: dict[str, tuple[set[int], Callable[[int], None]]] = {}
        self.pushing: dict[str, tuple[set[int], Callable[[int], None]]] = {}

    def _coll(self) -> str:
        return shard_coll(self.listener.pgid, -1)

    def handle_message(self, msg: Message) -> bool:
        if isinstance(msg, MOSDRepOp):
            self._handle_rep_op(msg)
        elif isinstance(msg, MOSDRepOpReply):
            self._handle_rep_op_reply(msg)
        elif isinstance(msg, MOSDPGPull):
            self._handle_pull(msg)
        elif isinstance(msg, MOSDPGPush):
            self._handle_push(msg)
        elif isinstance(msg, MOSDPGPushReply):
            self._handle_push_reply(msg)
        else:
            return False
        return True

    # -- writes ---------------------------------------------------------------

    def submit_transaction(self, pgt, reqid: ReqId, on_commit: Callable[[], None]) -> int:
        from .ec_transaction import ObjectInfo, OI_ATTR

        self._tid += 1
        tid = self._tid
        coll = self._coll()
        txn = Transaction()
        size = 0
        try:
            size = self.store.stat(coll, pgt.oid)
        except StoreError:
            pass
        version = self.listener.next_version()
        if getattr(pgt, "pre_clone", None) is not None:
            # make_writeable: preserve the pre-write head as the snap clone,
            # atomically with the mutation (PrimaryLogPG::make_writeable).
            txn.clone(coll, pgt.oid, pgt.pre_clone)
        for extra in getattr(pgt, "also_delete", ()):
            txn.remove(coll, extra)  # trimmed snap clones
        if pgt.delete:
            txn.remove(coll, pgt.oid)
        else:
            txn.touch(coll, pgt.oid)
            for off, data in pgt.writes:
                txn.write(coll, pgt.oid, off, data)
                size = max(size, off + len(data))
            if pgt.truncate is not None:
                txn.truncate(coll, pgt.oid, pgt.truncate)
                size = pgt.truncate  # PG pre-resolved the sequential size
            txn.setattr(
                coll, pgt.oid, OI_ATTR,
                ObjectInfo(size=size, version=version.version).encode(),
            )
            for name, val in pgt.attrs.items():
                if val is None:
                    txn.rmattr(coll, pgt.oid, name)
                else:
                    txn.setattr(coll, pgt.oid, name, val)
            if getattr(pgt, "omap_clear", False):
                txn.omap_clear(coll, pgt.oid)
            if getattr(pgt, "omap_rm", None):
                txn.omap_rmkeys(coll, pgt.oid, list(pgt.omap_rm))
            if getattr(pgt, "omap_set", None):
                txn.omap_setkeys(coll, pgt.oid, dict(pgt.omap_set))
        blob = txn.tobytes()
        entry = LogEntry(
            op=LOG_DELETE if pgt.delete else LOG_MODIFY,
            oid=pgt.oid,
            version=version,
            reqid=reqid.key(),
        )
        log_bytes = [entry.tobytes()] + [
            e.tobytes() for e in side_effect_log_entries(self.listener, pgt)
        ]
        targets = {o for o in self.listener.acting() if o != PG_NONE}
        self.in_flight[tid] = (set(targets), on_commit)
        for osd in targets:
            self.listener.send_shard(
                osd,
                MOSDRepOp(
                    pgid=self.listener.pgid,
                    from_osd=self.listener.whoami(),
                    tid=tid,
                    reqid=reqid,
                    txn=blob,
                    log_entries=log_bytes,
                ),
            )
        return tid

    def _handle_rep_op(self, msg: MOSDRepOp) -> None:
        for raw in msg.log_entries:
            self.listener.append_log(LogEntry.frombytes(raw))
        self.store.queue_transaction(Transaction.frombytes(msg.txn))
        self.listener.send_shard(
            msg.from_osd,
            MOSDRepOpReply(
                pgid=msg.pgid,
                from_osd=self.listener.whoami(),
                tid=msg.tid,
            ),
        )

    def _handle_rep_op_reply(self, msg: MOSDRepOpReply) -> None:
        entry = self.in_flight.get(msg.tid)
        if entry is None:
            return
        pending, on_commit = entry
        pending.discard(msg.from_osd)
        if not pending:
            del self.in_flight[msg.tid]
            on_commit()

    # -- reads ----------------------------------------------------------------

    def objects_read_and_reconstruct(
        self, reads, on_complete: Callable[[dict], None], **kw
    ) -> None:
        """Replicated reads are local to the primary."""
        coll = self._coll()
        results: dict[str, tuple[int, list[bytes]]] = {}
        for oid, extents in reads.items():
            try:
                bufs = [self.store.read(coll, oid, off, ln) for off, ln in extents]
                results[oid] = (0, bufs)
            except StoreError as e:
                results[oid] = (e.errno, [])
        on_complete(results)

    # -- recovery -------------------------------------------------------------

    def recover_object(
        self, oid: str, missing_on: set[int], on_complete: Callable[[int], None]
    ) -> None:
        """missing_on holds OSD ids (not shards) for replicated pools."""
        coll = self._coll()
        if self.store.exists(coll, oid):
            self._push_object(oid, missing_on, on_complete)
            return
        # Primary is missing the object: pull from a replica first
        # (ReplicatedBackend::prepare_pull analog).
        sources = (
            {o for o in self.listener.acting() if o != PG_NONE}
            - missing_on
            - {self.listener.whoami()}
        )
        if not sources:
            on_complete(-EIO)
            return
        self.pulling[oid] = (missing_on, on_complete)
        self.listener.send_shard(
            min(sources),
            MOSDPGPull(
                pgid=self.listener.pgid,
                oid=oid,
                epoch=self.listener.epoch(),
                from_osd=self.listener.whoami(),
            ),
        )

    def _push_object(
        self, oid: str, targets: set[int], on_complete: Callable[[int], None]
    ) -> None:
        from .ec_transaction import ObjectInfo, OI_ATTR

        coll = self._coll()
        data = self.store.read(coll, oid, 0, 0)
        attrs = self.store.getattrs(coll, oid)
        omap = self.store.omap_get(coll, oid)
        version = 0
        if OI_ATTR in attrs:
            version = ObjectInfo.decode(attrs[OI_ATTR]).version
        self.pushing[oid] = (set(targets), on_complete)
        for osd in targets:
            self.listener.send_shard(
                osd,
                MOSDPGPush(
                    pgid=self.listener.pgid,
                    pushes=[PushOp(oid=oid, data=data, attrs=attrs,
                                   version=version, omap=omap)],
                    epoch=self.listener.epoch(),
                    from_osd=self.listener.whoami(),
                ),
            )

    def _handle_pull(self, msg: MOSDPGPull) -> None:
        from .ec_transaction import ObjectInfo, OI_ATTR

        coll = self._coll()
        data = self.store.read(coll, msg.oid, 0, 0)
        attrs = self.store.getattrs(coll, msg.oid)
        omap = self.store.omap_get(coll, msg.oid)
        version = 0
        if OI_ATTR in attrs:
            version = ObjectInfo.decode(attrs[OI_ATTR]).version
        self.listener.send_shard(
            msg.from_osd,
            MOSDPGPush(
                pgid=msg.pgid,
                pushes=[PushOp(oid=msg.oid, data=data, attrs=attrs,
                               version=version, omap=omap)],
                epoch=self.listener.epoch(),
                from_osd=self.listener.whoami(),
            ),
        )

    def _handle_push(self, msg: MOSDPGPush) -> None:
        oids = self._apply_pushes(self._coll(), msg.pushes)
        for oid in oids:
            pull = self.pulling.pop(oid, None)
            if pull is not None:
                # pull satisfied; continue with pushes to the real targets
                targets, on_complete = pull
                self._push_object(oid, targets, on_complete)
        self.listener.send_shard(
            msg.from_osd,
            MOSDPGPushReply(
                pgid=msg.pgid,
                oids=oids,
                epoch=self.listener.epoch(),
                from_osd=self.listener.whoami(),
            ),
        )

    def _handle_push_reply(self, msg: MOSDPGPushReply) -> None:
        for oid in msg.oids:
            entry = self.pushing.get(oid)
            if entry is None:
                continue
            pending, on_complete = entry
            pending.discard(msg.from_osd)
            if not pending:
                del self.pushing[oid]
                self.listener.on_global_recover(oid)
                on_complete(0)


def build_pg_backend(
    pool: PgPool,
    profiles: dict[str, dict[str, str]],
    listener: PGListener,
    store: ObjectStore,
    device=None,
) -> PGBackend:
    """PGBackend.cc:570-607: Replicated vs EC selection + codec factory.
    An EC pool's codec is made on `device` (None: `cuda`, which raises
    with no GPU); a replicated pool runs no kernel and ignores it."""
    from ..osd.osdmap import FLAG_EC_OVERWRITES, POOL_TYPE_ERASURE
    from .ec_backend import ECBackend

    if pool.type != POOL_TYPE_ERASURE:
        return ReplicatedBackend(listener, store)
    profile = dict(profiles[pool.erasure_code_profile])
    plugin = profile.get("plugin", "tpu")
    ec = ErasureCodePluginRegistry.instance().factory(
        plugin, profile, device=device
    )
    k = ec.get_data_chunk_count()
    stripe_width = pool.stripe_width or k * 4096
    chunk_size = ec.get_chunk_size(stripe_width)
    if chunk_size * k != stripe_width:
        # mirror the mon's stripe_unit == chunk_size validation
        # (OSDMonitor.cc:7437-7455)
        raise EcError(
            EINVAL,
            f"stripe_width {stripe_width} not compatible with codec chunk "
            f"size {chunk_size} (k={k})",
        )
    sinfo = StripeInfo(stripe_width, chunk_size)
    return ECBackend(
        listener,
        store,
        ec,
        sinfo,
        allows_overwrites=bool(pool.flags & FLAG_EC_OVERWRITES),
        fast_read=pool.fast_read,
    )
