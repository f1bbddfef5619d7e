"""balancer mgr module — mirror of src/pybind/mgr/balancer.

The reference's balancer evens PG distribution across OSDs, in
`crush-compat` mode by adjusting per-OSD reweights and in `upmap` mode
with explicit pg-upmap entries.  This module implements the
crush-compat strategy: score the current PG distribution, and when the
spread exceeds the threshold, nudge overloaded OSDs' reweights down via
`osd reweight` mon commands (Module.optimize / do_crush_compat).

The port's copy of `ceph_tpu/mgr/balancer.py`.
"""

from __future__ import annotations

from ..common.log import dout
from ..crush.crush import WEIGHT_ONE
from ..osd.osdmap import PG_NONE
from .modules import MgrModule


class BalancerModule(MgrModule):
    NAME = "balancer"

    def __init__(self, threshold: float = 1.2, max_adjustments: int = 2):
        super().__init__()
        self.mode = "crush-compat"
        self.active_mode = False  # like `balancer on` (default off: advise)
        self.threshold = threshold  # max/mean PG ratio triggering a move
        self.max_adjustments = max_adjustments  # per tick (upmap_max_optimizations)
        self.last_plan: list[dict] = []
        self.map_errors = 0  # unmappable PGs skipped (visible, not silent)

    # -- scoring ---------------------------------------------------------------

    def pg_counts(self) -> dict[int, int]:
        """PGs per OSD over all pools (Module.calc_pg_upmaps input)."""
        osdmap = self.mgr.osdmap
        counts = {o: 0 for o, info in osdmap.osds.items() if info.up and info.in_}
        for pool in osdmap.pools.values():
            for ps in range(pool.pg_num):
                try:
                    _u, _up, acting, _p = osdmap.pg_to_up_acting_osds(pool.id, ps)
                except Exception as e:
                    # CRUSH can legitimately fail to map a PG mid-churn,
                    # but the failure must leave a trace:
                    # balancing on a silently partial count set would
                    # "even out" load that is actually unmapped
                    self.map_errors += 1
                    dout("mgr", 4,
                         f"balancer: pg {pool.id}.{ps} unmappable: {e!r}")
                    continue
                for osd in acting:
                    if osd != PG_NONE and osd in counts:
                        counts[osd] += 1
        return counts

    def score(self) -> float:
        """max/mean ratio; 1.0 = perfectly even (Module.calc_eval)."""
        counts = self.pg_counts()
        if not counts or sum(counts.values()) == 0:
            return 1.0
        mean = sum(counts.values()) / len(counts)
        return max(counts.values()) / mean if mean else 1.0

    # -- planning --------------------------------------------------------------

    def optimize(self) -> list[dict]:
        """Build a reweight plan without executing it (`balancer eval` +
        `balancer optimize`)."""
        counts = self.pg_counts()
        plan: list[dict] = []
        if len(counts) < 2:
            return plan
        mean = sum(counts.values()) / len(counts)
        if mean == 0:
            return plan
        osdmap = self.mgr.osdmap
        over = sorted(
            (o for o, c in counts.items() if c / mean > self.threshold),
            key=lambda o: -counts[o],
        )
        for osd in over[: self.max_adjustments]:
            cur = osdmap.osds[osd].weight / WEIGHT_ONE
            # proportional nudge toward the mean, floored (do_crush_compat's
            # step-scaled adjustment)
            new = max(0.5, round(cur * mean / counts[osd], 2))
            if new < cur:
                plan.append({"osd": osd, "from": cur, "to": new})
        return plan

    async def tick(self) -> None:
        self.last_plan = self.optimize()
        if not self.last_plan:
            self.clear_health_check("BALANCER_UNEVEN")
            return
        summary = ", ".join(
            f"osd.{p['osd']} {p['from']:.2f}->{p['to']:.2f}" for p in self.last_plan
        )
        if not self.active_mode:
            self.set_health_check(
                "BALANCER_UNEVEN", "warning", f"pg distribution uneven; plan: {summary}"
            )
            return
        for p in self.last_plan:
            rv, rs, _ = await self.mgr.mon_command(
                {"prefix": "osd reweight", "id": p["osd"], "weight": p["to"]}
            )
            if rv != 0:
                dout("mgr", 1, f"balancer: reweight osd.{p['osd']} failed: {rs}")
        dout("mgr", 5, f"balancer: applied {summary}")
