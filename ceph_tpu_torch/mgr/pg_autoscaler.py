"""pg_autoscaler mgr module — mirror of src/pybind/mgr/pg_autoscaler.

The reference recommends (and in `on` mode applies) per-pool pg_num so
each OSD carries about `mon_target_pg_per_osd` PGs, rounding to powers
of two and only acting when the ideal differs from the actual by >3x
(module.py _get_pool_pg_targets).  This module reproduces that math.

Mode semantics: the default is **warn** (recommendations surface as a
health check); `on` applies `osd pool set pg_num` — which this
framework restricts to empty pools, since PG splitting (the reference's
data-migration machinery behind pg_num changes) is not implemented.

The port's copy of `ceph_tpu/mgr/pg_autoscaler.py`.
"""

from __future__ import annotations

from ..common.log import dout
from .modules import MgrModule

TARGET_PG_PER_OSD = 100  # mon_target_pg_per_osd


def _nearest_power_of_two(n: float) -> int:
    if n <= 1:
        return 1
    lo = 1 << (int(n).bit_length() - 1)
    hi = lo << 1
    return hi if n - lo > hi - n else lo


class PgAutoscalerModule(MgrModule):
    NAME = "pg_autoscaler"

    def __init__(self, mode: str = "warn"):
        super().__init__()
        self.mode = mode  # "warn" | "on" | "off"
        self.last_recommendations: dict[str, dict] = {}

    def recommend(self) -> dict[str, dict]:
        """pool -> {current, ideal, should_adjust}
        (pg_autoscaler _get_pool_pg_targets)."""
        osdmap = self.mgr.osdmap
        n_osds = max(
            1, sum(1 for i in osdmap.osds.values() if i.up and i.in_)
        )
        pools = list(osdmap.pools.values())
        out: dict[str, dict] = {}
        if not pools:
            return out
        # Without utilization stats, pools split the PG budget evenly
        # (the reference biases by stored bytes; equal-share is the
        # zero-data prior it also starts from).
        budget = n_osds * TARGET_PG_PER_OSD
        for pool in pools:
            replication = pool.size
            ideal_raw = budget / max(1, replication) / len(pools)
            ideal = max(1, _nearest_power_of_two(ideal_raw))
            current = pool.pg_num
            # only flag >3x divergence (the reference's threshold)
            should = ideal > current * 3 or current > ideal * 3
            out[pool.name] = {
                "current": current,
                "ideal": ideal,
                "should_adjust": should,
            }
        return out

    async def tick(self) -> None:
        recs = self.recommend()
        self.last_recommendations = recs
        flagged = {
            name: r for name, r in recs.items() if r["should_adjust"]
        }
        if not flagged:
            self.clear_health_check("POOL_PG_NUM")
            return
        summary = ", ".join(
            f"{name}: {r['current']} -> {r['ideal']}" for name, r in flagged.items()
        )
        if self.mode != "on":
            self.set_health_check(
                "POOL_PG_NUM", "warning", f"pg_num suboptimal ({summary})"
            )
            return
        skipped = []
        for name, r in flagged.items():
            # The mon interlock requires `yes_i_really_mean_it` as the
            # caller's assertion that the pool is EMPTY (pg_num changes remap
            # every object with no PG-split migration).  Only assert it when
            # the OSD status reports actually verify emptiness; pools that
            # cannot be verified degrade to the warn-mode health check.
            if not self._pool_verified_empty(name):
                dout(
                    "mgr",
                    4,
                    f"pg_autoscaler: {name} not verifiably empty; not applying",
                )
                skipped.append(f"{name}: {r['current']} -> {r['ideal']}")
                continue
            rv, rs, _ = await self.mgr.mon_command(
                {
                    "prefix": "osd pool set",
                    "pool": name,
                    "var": "pg_num",
                    "val": str(r["ideal"]),
                    "yes_i_really_mean_it": True,
                }
            )
            if rv != 0:
                dout("mgr", 1, f"pg_autoscaler: {name} pg_num set refused: {rs}")
                skipped.append(f"{name}: {r['current']} -> {r['ideal']}")
        if skipped:
            self.set_health_check(
                "POOL_PG_NUM",
                "warning",
                f"pg_num suboptimal, not auto-applied ({', '.join(skipped)})",
            )
        else:
            self.clear_health_check("POOL_PG_NUM")

    def _pool_verified_empty(self, pool_name: str) -> bool:
        """True only when every up+in OSD has reported a status blob and all
        of them show zero objects for the pool.  An OSD that has not yet
        reported (or predates pool_objects) makes the pool unverifiable."""
        osdmap = self.mgr.osdmap
        pool = next(
            (p for p in osdmap.pools.values() if p.name == pool_name), None
        )
        if pool is None:
            return False
        pid = str(pool.id)
        if not any(i.up and i.in_ for i in osdmap.osds.values()):
            # No up+in OSD is reporting at all — nothing can vouch that the
            # pool is empty, so treat it as unverifiable rather than letting
            # the loop below pass vacuously.
            return False
        for osd_id, info in osdmap.osds.items():
            if not (info.up and info.in_):
                # A down/out OSD may still hold this pool's only copies of
                # data that no reporting OSD sees — unverifiable, not empty.
                return False
            status = self.mgr.get_daemon_status(f"osd.{osd_id}")
            counts = status.get("pool_objects")
            if counts is None:
                return False
            if counts.get(pid, 0) != 0:
                return False
        return True
