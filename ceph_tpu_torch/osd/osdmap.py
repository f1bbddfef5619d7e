"""OSDMap — mirror of src/osd/OSDMap.{h,cc}.

The port of `ceph_tpu/osd/osdmap.py`, with its field orders and encoding.
The epoch-versioned cluster map: OSD states (up/down, in/out via
reweight), pools with their CRUSH rule + EC profile, and the
object→PG→OSDs mapping pipeline (src/osd/OSDMap.cc:2604
`_pg_to_raw_osds` → crush_do_rule; :2857 `pg_to_up_acting_osds`).
Erasure-coded pools use an `indep` rule so down shards appear as PG_NONE
holes with stable shard identity — ECBackend depends on that.

Maps are Encodable and propagate as either full maps or Incrementals
(OSDMap::Incremental), exactly like the mon→OSD flow in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ..common.encoding import Decoder, Encodable, Encoder
from ..crush import CRUSH_ITEM_NONE, CrushWrapper, crush_hash32_2, str_hash
from ..crush.crush import WEIGHT_ONE

PG_NONE = CRUSH_ITEM_NONE  # missing shard sentinel (CRUSH_ITEM_NONE)

POOL_TYPE_REPLICATED = 1
POOL_TYPE_ERASURE = 3

FLAG_EC_OVERWRITES = 1 << 0  # pool flag (osd_types.h:1222)
FLAG_FULL_QUOTA = 1 << 1     # pool hit its quota (pg_pool_t FLAG_FULL_QUOTA)


def advance_map(current: "OSDMap", msg) -> "OSDMap":
    """Apply an MOSDMap's full maps / incrementals in epoch order
    (the shared OSD::handle_osd_map / Objecter::handle_osd_map advance
    loop).  Epochs at or below `current.epoch` are skipped; an
    incremental with a gap waits for a full map."""
    out = current
    fulls = {int(e): blob for e, blob in msg.maps.items()}
    incs = {int(e): blob for e, blob in msg.incrementals.items()}
    for epoch in sorted(set(fulls) | set(incs)):
        if epoch <= out.epoch:
            continue
        if epoch in incs and out.epoch == epoch - 1:
            out = Incremental.frombytes(incs[epoch]).apply_to(out)
        elif epoch in fulls:
            out = OSDMap.frombytes(fulls[epoch])
    return out


@dataclass
class OsdInfo:
    """Per-OSD state (OSDMap osd_state/osd_weight/osd_addrs)."""

    up: bool = False
    addr: str = ""  # host:port of the OSD's messenger
    weight: int = WEIGHT_ONE  # reweight 0..0x10000; 0 == out
    last_up_epoch: int = 0
    last_down_epoch: int = 0

    @property
    def in_(self) -> bool:
        return self.weight > 0


@dataclass
class PgPool:
    """pg_pool_t analog (src/osd/osd_types.h)."""

    id: int
    name: str
    type: int = POOL_TYPE_REPLICATED
    size: int = 3  # k+m for EC
    min_size: int = 2
    pg_num: int = 8
    crush_rule: int = 0
    erasure_code_profile: str = ""
    stripe_width: int = 0  # k * stripe_unit for EC (OSDMonitor.cc:7715)
    flags: int = 0
    fast_read: bool = False
    snap_seq: int = 0  # self-managed snap id allocator (pg_pool_t::snap_seq)
    # Cache tiering (pg_pool_t tier_of/read_tier/cache_mode,
    # src/osd/osd_types.h; administered via `osd tier ...`,
    # src/mon/OSDMonitor.cc prepare_command tier block):
    tier_of: int = -1  # base pool this pool is a cache tier FOR
    tiers: list[int] = field(default_factory=list)  # cache pools over this one
    read_tier: int = -1  # overlay: clients redirect ops here (set-overlay)
    cache_mode: str = "none"  # none | writeback | readonly
    target_max_objects: int = 0  # tier agent flush/evict threshold (0 = off)
    # pool quotas (pg_pool_t quota_max_*; `osd pool set-quota`); the mon
    # flips FLAG_FULL_QUOTA from the mgr's PGMap digest when exceeded
    quota_max_bytes: int = 0
    quota_max_objects: int = 0
    # application tag (pg_pool_t application_metadata; `osd pool
    # application enable` — rbd/cephfs/rgw claim their pools)
    application: str = ""

    def is_erasure(self) -> bool:
        return self.type == POOL_TYPE_ERASURE

    def is_cache_tier(self) -> bool:
        return self.tier_of >= 0 and self.cache_mode != "none"

    def raw_pg_to_pps(self, ps: int) -> int:
        """Placement seed: pool id folded into the pg seed
        (OSDMap raw_pg_to_pps)."""
        return crush_hash32_2(ps, self.id)


class OSDMap(Encodable):
    def __init__(self) -> None:
        self.epoch = 0
        self.fsid = ""
        self.osds: dict[int, OsdInfo] = {}
        self.pools: dict[int, PgPool] = {}
        self.pool_name_to_id: dict[str, int] = {}
        self.erasure_code_profiles: dict[str, dict[str, str]] = {}
        self.crush = CrushWrapper()
        # fenced client instance ids (osdmap blocklist; OSDMap.h
        # blocklist): OSDs refuse their ops — the fencing rbd-mirror /
        # cephfs eviction build on
        self.blocklist: set[str] = set()
        self._reweights_cache: dict[int, int] | None = None

    # -- queries -------------------------------------------------------------

    def get_pool(self, name_or_id: str | int) -> PgPool | None:
        if isinstance(name_or_id, int):
            return self.pools.get(name_or_id)
        pid = self.pool_name_to_id.get(name_or_id)
        return None if pid is None else self.pools[pid]

    def is_up(self, osd: int) -> bool:
        info = self.osds.get(osd)
        return bool(info and info.up)

    def object_to_pg(self, pool_id: int, name: str) -> tuple[int, int]:
        """(pool, ps) placement group for an object name
        (object_locator_to_pg: rjenkins str hash mod pg_num)."""
        pool = self.pools[pool_id]
        ps = str_hash(name) % pool.pg_num
        return (pool_id, ps)

    def _reweights(self) -> dict[int, int]:
        if self._reweights_cache is None:
            self._reweights_cache = {
                o: info.weight for o, info in self.osds.items()
            }
        return self._reweights_cache

    def pg_to_raw_osds(self, pool_id: int, ps: int) -> list[int]:
        """CRUSH mapping with reweight rejection (OSDMap.cc:2604)."""
        pool = self.pools[pool_id]
        reweights = self._reweights()
        pps = pool.raw_pg_to_pps(ps)
        raw = self.crush.do_rule(pool.crush_rule, pps, pool.size, reweights)
        if not pool.is_erasure():
            return [o for o in raw if o != PG_NONE]
        # indep rules already emit stable holes; pad to size
        raw = raw + [PG_NONE] * (pool.size - len(raw))
        return raw[: pool.size]

    def pg_to_up_acting_osds(
        self, pool_id: int, ps: int
    ) -> tuple[list[int], int, list[int], int]:
        """(up, up_primary, acting, acting_primary)
        (OSDMap.cc:2857).  Down OSDs are holes in up; acting == up here
        (no pg_temp — recovery backfills through map changes instead)."""
        pool = self.pools[pool_id]
        raw = self.pg_to_raw_osds(pool_id, ps)
        if pool.is_erasure():
            up = [o if o != PG_NONE and self.is_up(o) else PG_NONE for o in raw]
        else:
            up = [o for o in raw if o != PG_NONE and self.is_up(o)]
        primary = next((o for o in up if o != PG_NONE), PG_NONE)
        return up, primary, list(up), primary

    def num_up_osds(self) -> int:
        return sum(1 for i in self.osds.values() if i.up)

    # -- mutations (the mon applies these; OSDs only consume) ----------------

    def add_osd(self, osd: int, addr: str = "", up: bool = True) -> None:
        self.osds[osd] = OsdInfo(up=up, addr=addr)
        self._reweights_cache = None

    def set_osd_state(self, osd: int, up: bool, addr: str | None = None) -> None:
        self._reweights_cache = None
        info = self.osds.setdefault(osd, OsdInfo())
        info.up = up
        if addr is not None:
            info.addr = addr
        if up:
            info.last_up_epoch = self.epoch
        else:
            info.last_down_epoch = self.epoch

    def set_osd_weight(self, osd: int, weight: int) -> None:
        self.osds.setdefault(osd, OsdInfo()).weight = weight
        self._reweights_cache = None

    def create_pool(
        self,
        name: str,
        type: int = POOL_TYPE_REPLICATED,
        size: int = 3,
        min_size: int | None = None,
        pg_num: int = 8,
        crush_rule: int = 0,
        erasure_code_profile: str = "",
        stripe_width: int = 0,
        flags: int = 0,
        fast_read: bool = False,
    ) -> PgPool:
        if name in self.pool_name_to_id:
            raise ValueError(f"pool {name} exists")
        pid = max(self.pools, default=0) + 1
        pool = PgPool(
            id=pid,
            name=name,
            type=type,
            size=size,
            min_size=min_size if min_size is not None else max(size - 1, 1),
            pg_num=pg_num,
            crush_rule=crush_rule,
            erasure_code_profile=erasure_code_profile,
            stripe_width=stripe_width,
            flags=flags,
            fast_read=fast_read,
        )
        self.pools[pid] = pool
        self.pool_name_to_id[name] = pid
        return pool

    # -- encoding ------------------------------------------------------------

    def encode(self, enc: Encoder) -> None:
        # v2 appends the per-pool tiering map AFTER the v1 payload (and
        # v3 the quota map), so older decoders skip the trailers via the
        # frame length (the reference's rolling-upgrade convention,
        # src/include/encoding.h ENCODE_START).
        enc.start(5, 1)
        enc.u32(self.epoch)
        enc.string(self.fsid)
        enc.map_(
            self.osds,
            lambda e, k: e.u32(k),
            lambda e, v: (
                e.boolean(v.up),
                e.string(v.addr),
                e.u32(v.weight),
                e.u32(v.last_up_epoch),
                e.u32(v.last_down_epoch),
            ),
        )
        enc.map_(
            self.pools,
            lambda e, k: e.u32(k),
            lambda e, p: (
                e.string(p.name),
                e.u32(p.type),
                e.u32(p.size),
                e.u32(p.min_size),
                e.u32(p.pg_num),
                e.u32(p.crush_rule),
                e.string(p.erasure_code_profile),
                e.u32(p.stripe_width),
                e.u32(p.flags),
                e.boolean(p.fast_read),
                e.u64(p.snap_seq),
            ),
        )
        enc.map_(
            self.erasure_code_profiles,
            lambda e, k: e.string(k),
            lambda e, prof: e.map_(
                prof, lambda e2, k2: e2.string(k2), lambda e2, v2: e2.string(v2)
            ),
        )
        self.crush.encode(enc)
        # --- v2 trailer: cache tiering ----------------------------------
        tiered = {
            pid: p
            for pid, p in self.pools.items()
            if p.tier_of >= 0 or p.tiers or p.read_tier >= 0
            or p.cache_mode != "none" or p.target_max_objects
        }
        enc.map_(
            tiered,
            lambda e, k: e.u32(k),
            lambda e, p: (
                e.i64(p.tier_of),
                e.list_(p.tiers, lambda e2, t: e2.u32(t)),
                e.i64(p.read_tier),
                e.string(p.cache_mode),
                e.u64(p.target_max_objects),
            ),
        )
        # --- v3 trailer: pool quotas ------------------------------------
        quotas = {
            pid: p
            for pid, p in self.pools.items()
            if p.quota_max_bytes or p.quota_max_objects
        }
        enc.map_(
            quotas,
            lambda e, k: e.u32(k),
            lambda e, p: (
                e.u64(p.quota_max_bytes),
                e.u64(p.quota_max_objects),
            ),
        )
        # --- v4 trailer: client blocklist ---------------------------------
        enc.list_(sorted(self.blocklist), lambda e, c: e.string(c))
        # --- v5 trailer: pool application tags ----------------------------
        apps = {pid: p.application for pid, p in self.pools.items() if p.application}
        enc.map_(apps, lambda e, k: e.u32(k), lambda e, a: e.string(a))
        enc.finish()

    @classmethod
    def decode(cls, dec: Decoder) -> "OSDMap":
        m = cls()
        struct_v = dec.start(5)
        m.epoch = dec.u32()
        m.fsid = dec.string()
        m.osds = dec.map_(
            lambda d: d.u32(),
            lambda d: OsdInfo(
                up=d.boolean(),
                addr=d.string(),
                weight=d.u32(),
                last_up_epoch=d.u32(),
                last_down_epoch=d.u32(),
            ),
        )
        pools = dec.map_(
            lambda d: d.u32(),
            lambda d: dict(
                name=d.string(),
                type=d.u32(),
                size=d.u32(),
                min_size=d.u32(),
                pg_num=d.u32(),
                crush_rule=d.u32(),
                erasure_code_profile=d.string(),
                stripe_width=d.u32(),
                flags=d.u32(),
                fast_read=d.boolean(),
                snap_seq=d.u64(),
            ),
        )
        for pid, kw in pools.items():
            m.pools[pid] = PgPool(id=pid, **kw)
            m.pool_name_to_id[kw["name"]] = pid
        m.erasure_code_profiles = dec.map_(
            lambda d: d.string(),
            lambda d: d.map_(lambda d2: d2.string(), lambda d2: d2.string()),
        )
        m.crush = CrushWrapper.decode(dec)
        if struct_v >= 2:  # noqa: SIM102 — versioned trailers read in order
            tiered = dec.map_(
                lambda d: d.u32(),
                lambda d: dict(
                    tier_of=d.i64(),
                    tiers=d.list_(lambda d2: d2.u32()),
                    read_tier=d.i64(),
                    cache_mode=d.string(),
                    target_max_objects=d.u64(),
                ),
            )
            for pid, kw in tiered.items():
                p = m.pools.get(pid)
                if p is not None:
                    for attr, val in kw.items():
                        setattr(p, attr, val)
        if struct_v >= 3:
            quotas = dec.map_(
                lambda d: d.u32(),
                lambda d: (d.u64(), d.u64()),
            )
            for pid, (qb, qo) in quotas.items():
                p = m.pools.get(pid)
                if p is not None:
                    p.quota_max_bytes, p.quota_max_objects = qb, qo
        if struct_v >= 4:
            m.blocklist = set(dec.list_(lambda d: d.string()))
        if struct_v >= 5:
            apps = dec.map_(lambda d: d.u32(), lambda d: d.string())
            for pid, app in apps.items():
                if pid in m.pools:
                    m.pools[pid].application = app
        dec.finish()
        return m


@dataclass
class Incremental(Encodable):
    """OSDMap::Incremental — the delta the mon publishes per epoch.

    Carries only state changes; structural changes (pools, crush, EC
    profiles) ride a full-map re-encode for simplicity, which the
    reference also supports (full map epochs).
    """

    epoch: int = 0
    new_up: dict[int, str] = field(default_factory=dict)  # osd -> addr
    new_down: list[int] = field(default_factory=list)
    new_weights: dict[int, int] = field(default_factory=dict)
    full_map: bytes = b""  # non-empty => decode and replace wholesale

    def encode(self, enc: Encoder) -> None:
        enc.start(1, 1)
        enc.u32(self.epoch)
        enc.map_(self.new_up, lambda e, k: e.u32(k), lambda e, v: e.string(v))
        enc.list_(self.new_down, lambda e, v: e.u32(v))
        enc.map_(self.new_weights, lambda e, k: e.u32(k), lambda e, v: e.u32(v))
        enc.bytes_(self.full_map)
        enc.finish()

    @classmethod
    def decode(cls, dec: Decoder) -> "Incremental":
        dec.start(1)
        inc = cls(
            epoch=dec.u32(),
            new_up=dec.map_(lambda d: d.u32(), lambda d: d.string()),
            new_down=dec.list_(lambda d: d.u32()),
            new_weights=dec.map_(lambda d: d.u32(), lambda d: d.u32()),
            full_map=dec.bytes_(),
        )
        dec.finish()
        return inc

    def apply_to(self, osdmap: OSDMap) -> OSDMap:
        """OSDMap::apply_incremental; deltas must be the successor epoch
        (the reference asserts inc.epoch == epoch + 1)."""
        if self.full_map:
            new_map = OSDMap.frombytes(self.full_map)
            if new_map.epoch < osdmap.epoch:
                raise ValueError(
                    f"stale full map epoch {new_map.epoch} < current {osdmap.epoch}"
                )
            return new_map
        if self.epoch != osdmap.epoch + 1:
            raise ValueError(
                f"incremental epoch {self.epoch} != map epoch {osdmap.epoch} + 1"
            )
        osdmap.epoch = self.epoch
        for osd, addr in self.new_up.items():
            osdmap.set_osd_state(osd, True, addr)
        for osd in self.new_down:
            osdmap.set_osd_state(osd, False)
        for osd, w in self.new_weights.items():
            osdmap.set_osd_weight(osd, w)
        return osdmap
