"""Pool definitions — the port of part of `ceph_tpu/osd/osdmap.py`.

`PgPool` (pg_pool_t, src/osd/osd_types.h) with the reference's fields and
defaults, the missing-shard sentinel `PG_NONE` (CRUSH_ITEM_NONE) and the
pool type and flag constants the EC backend reads.  The OSDMap itself,
CRUSH placement and `raw_pg_to_pps` come with the OSD daemons.
"""

from __future__ import annotations

from dataclasses import dataclass, field

PG_NONE = 0x7FFFFFFF  # missing shard sentinel (CRUSH_ITEM_NONE)

POOL_TYPE_REPLICATED = 1
POOL_TYPE_ERASURE = 3

FLAG_EC_OVERWRITES = 1 << 0  # pool flag (osd_types.h:1222)


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
