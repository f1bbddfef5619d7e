"""ROADMAP C37 on the CPU: the metrics-history module's decode trend,
the reference's module beside the port's on one synthetic daemon.

Client encodes keep the launch rate up while a burst of degraded reads
ends: decode GB/s falls to nothing because decode load fell, not because
the device got slower.  The reference gates decode on all launches and
raises TPU_THROUGHPUT_REGRESSION; the port gates it on decode's own
launches and stays quiet.  While decode launches go on at their cadence
and their bytes collapse, both raise it, with decode in its figures.
"""

import time

import pytest

from ceph_tpu.mgr.metrics_history import MetricsHistoryModule as RefModule
from ceph_tpu_torch.mgr.metrics_history import MetricsHistoryModule as PortModule

GB = 10**9
DT = 0.05
PINS = dict(window_sec=0.2, baseline_sec=0.4, regression_ratio=0.5,
            occupancy_ratio=0.5, queue_wait_factor=5.0, min_launch_rate=1.0,
            resolutions="0.05,0.5")


class _Mgr:
    """One OSD whose cumulative dispatch counters the test advances."""

    def __init__(self):
        self.conf = None
        self.modules = []
        self.daemons = {}
        self.perf = {"osd.0": {
            "ec_dispatch.bytes": 0, "ec_dispatch.decode_bytes": 0,
            "ec_dispatch.launches": 0, "ec_dispatch.decode_launches": 0,
            "ec_dispatch.fallback_launches": 0, "op": 0,
            "ec_dispatch.device_occupancy": 0.8,
            "ec_dispatch.flight_mean_queue_wait_ms": 0.1,
        }}

    def list_daemons(self):
        return sorted(self.perf)

    def get_daemon_perf(self, daemon):
        return self.perf.get(daemon, {})

    def get_daemon_status(self, daemon):
        return {"slow_ops": {"count": 0}}


def _run(module_cls, decode_after: tuple[float, int], rounds_after: int = 10) -> dict:
    """16 rounds of encodes at 2 GB/s (10 launches a round) and decodes
    at 1 GB/s (4 launches a round), then `rounds_after` rounds with the
    encodes unchanged and decode at `decode_after` (GB/s, launches a
    round); returns the raise transitions' figures."""
    mod, mgr = module_cls(**PINS), _Mgr()
    mod.mgr = mgr
    p = mgr.perf["osd.0"]
    mod.tick()
    raises = []
    for i in range(16 + rounds_after):
        dec_gbps, dec_launches = (1.0, 4) if i < 16 else decode_after
        time.sleep(DT)
        p["ec_dispatch.bytes"] += int(2.0 * GB * DT)
        p["ec_dispatch.decode_bytes"] += int(dec_gbps * GB * DT)
        p["ec_dispatch.decode_launches"] += dec_launches
        p["ec_dispatch.launches"] += 10 + dec_launches
        p["op"] += 10
        fired = mod.sentinels_fired
        mod.tick()
        if mod.sentinels_fired > fired:
            raises.append(dict(mod.sentinels.get("TPU_THROUGHPUT_REGRESSION", {})
                               .get("data", {})))
    return {"fired": mod.sentinels_fired, "raises": raises}


def test_an_ended_decode_burst_raises_in_the_reference_and_not_in_the_port():
    ref = _run(RefModule, decode_after=(0.0, 0))
    port = _run(PortModule, decode_after=(0.0, 0))
    assert ref["fired"] >= 1 and any("decode" in r for r in ref["raises"]), ref
    assert port["fired"] == 0, port


@pytest.mark.parametrize("module_cls", [RefModule, PortModule], ids=["jax", "torch"])
def test_a_decode_collapse_under_its_own_cadence_raises_in_both(module_cls):
    out = _run(module_cls, decode_after=(0.02, 4))
    assert out["fired"] >= 1 and any("decode" in r for r in out["raises"]), out
