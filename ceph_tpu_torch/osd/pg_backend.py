"""PGBackend — per-PG storage strategy boundary.

The port of `ceph_tpu/osd/pg_backend.py` (Ceph's src/osd/PGBackend.{h,cc}):
`build_pg_backend` instantiates the codec through the plugin registry
(PGBackend.cc:570-607, plugin name from `profile["plugin"]`) on the
caller's device, `cuda` unless it asks for `cpu`.  The Listener is the
PG's callback surface (PGBackend::Listener): identity, acting set, version
allocation, log append, missing tracking, and the transport hook.
`PGBackend._apply_pushes` writes recovery pushes.  The replicated backend
comes with the OSD daemons; until then a replicated pool raises
EOPNOTSUPP.
"""

from __future__ import annotations

import abc
from typing import Callable

from ..codec.interface import EcError
from ..codec.registry import ErasureCodePluginRegistry
from ..common.errs import EINVAL, EOPNOTSUPP
from ..msg.message import Message
from ..msg.messages import PgId, PushOp, ReqId
from ..os.objectstore import ObjectStore
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


def build_pg_backend(
    pool: PgPool,
    profiles: dict[str, dict[str, str]],
    listener: PGListener,
    store: ObjectStore,
    device=None,
) -> PGBackend:
    """PGBackend.cc:570-607: EC selection + codec factory.  The codec is
    made on `device` (None: `cuda`, which raises with no GPU); a
    replicated pool raises EOPNOTSUPP until its backend is ported."""
    from ..osd.osdmap import FLAG_EC_OVERWRITES, POOL_TYPE_ERASURE
    from .ec_backend import ECBackend

    if pool.type != POOL_TYPE_ERASURE:
        raise EcError(EOPNOTSUPP, "replicated pools are not ported yet")
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
