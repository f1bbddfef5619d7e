"""ROADMAP C38 on the CPU: the metrics-history module's encode trend,
the reference's module beside the port's on one synthetic daemon.

The dispatch counters' `bytes` and `launches` total every dispatch:
decodes, scrub verifies and the offload services' checksum and
compression launches included.  A recovery (decode), deep-scrub (verify)
or checksum (csum) burst of large batches ends while small client writes
keep the launch rate up: the total GB/s falls to a sliver because the
large batches stopped, not because the device got slower.  The reference
judges encode on the totals and raises TPU_THROUGHPUT_REGRESSION; the
port judges it on encode's own bytes and launches and stays quiet.
While encode launches go on at their cadence and their bytes collapse,
both raise it, with encode in its figures; beside a steady burst only
the port does, since the burst's bytes hide it in the totals.  A daemon
that reports no decode, verify or offload counters is judged by the
reference's rule (the reference's own cases, run on the port by
`tests/test_torch_mgr_modules.py`).
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
# burst kind: (its bytes counter, its launches counter), as an OSD reports them
BURSTS = {
    "decode": ("ec_dispatch.decode_bytes", "ec_dispatch.decode_launches"),
    "verify": ("ec_dispatch.verify_bytes", "ec_dispatch.verify_launches"),
    "csum": ("offload.csum.launch_bytes", "offload.csum.launches"),
    "compress": ("offload.compress.launch_bytes", "offload.compress.launches"),
}


def _histogram(total: int) -> dict:
    """A `launch_bytes` histogram as `PerfHistogram.dump()` gives it."""
    return {"histogram": {"buckets": [["+Inf", 0]], "sum": total, "count": 0}}


class _Mgr:
    """One OSD whose cumulative dispatch counters the test advances."""

    def __init__(self):
        self.conf = None
        self.modules = []
        self.daemons = {}
        self.perf = {"osd.0": {
            "ec_dispatch.bytes": 0, "ec_dispatch.launches": 0,
            **{b: 0 for b, _ in BURSTS.values()}, **{n: 0 for _, n in BURSTS.values()},
            "offload.csum.launch_bytes": _histogram(0),
            "offload.compress.launch_bytes": _histogram(0),
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


def _run(module_cls, burst: str, encode_after: tuple[float, int],
         burst_after: tuple[float, int], rounds_after: int = 10) -> dict:
    """16 rounds of client encodes at 0.1 GB/s (10 launches a round) and
    a `burst` (a key of BURSTS) at 2 GB/s (4 launches a round), then
    `rounds_after` rounds with encode at `encode_after` and the burst at
    `burst_after` (GB/s, launches a round).  The totals carry both, as
    `ops/dispatch.py::record_launch` counts them.  Returns the raise
    transitions' figures."""
    mod, mgr = module_cls(**PINS), _Mgr()
    mod.mgr = mgr
    p = mgr.perf["osd.0"]
    mod.tick()
    raises = []
    for i in range(16 + rounds_after):
        (enc_gbps, enc_launches), (b_gbps, b_launches) = (
            ((0.1, 10), (2.0, 4)) if i < 16 else (encode_after, burst_after))
        time.sleep(DT)
        enc_bytes, b_bytes = int(enc_gbps * GB * DT), int(b_gbps * GB * DT)
        p["ec_dispatch.bytes"] += enc_bytes + b_bytes
        p["ec_dispatch.launches"] += enc_launches + b_launches
        bytes_key, launches_key = BURSTS[burst]
        if isinstance(p[bytes_key], dict):
            p[bytes_key] = _histogram(p[bytes_key]["histogram"]["sum"] + b_bytes)
        else:
            p[bytes_key] += b_bytes
        p[launches_key] += b_launches
        p["op"] += enc_launches
        fired = mod.sentinels_fired
        mod.tick()
        if mod.sentinels_fired > fired:
            raises.append(dict(mod.sentinels.get("TPU_THROUGHPUT_REGRESSION", {})
                               .get("data", {})))
    return {"fired": mod.sentinels_fired, "raises": raises}


@pytest.mark.parametrize("burst", sorted(BURSTS))
def test_an_ended_burst_of_large_batches_raises_in_the_reference_and_not_in_the_port(burst):
    ended = dict(burst=burst, encode_after=(0.1, 10), burst_after=(0.0, 0))
    ref = _run(RefModule, **ended)
    port = _run(PortModule, **ended)
    assert ref["fired"] >= 1 and any("encode" in r for r in ref["raises"]), ref
    assert port["fired"] == 0, port


@pytest.mark.parametrize("burst", sorted(BURSTS))
@pytest.mark.parametrize("module_cls", [RefModule, PortModule], ids=["jax", "torch"])
def test_an_encode_collapse_under_its_own_cadence_raises_in_both(module_cls, burst):
    out = _run(module_cls, burst, encode_after=(0.002, 10), burst_after=(0.0, 0))
    assert out["fired"] >= 1 and any("encode" in r for r in out["raises"]), out


@pytest.mark.parametrize("burst", sorted(BURSTS))
def test_an_encode_collapse_beside_a_steady_burst_raises_in_the_port_only(burst):
    """The burst's bytes hide the collapse in the reference's totals."""
    steady = dict(burst=burst, encode_after=(0.002, 10), burst_after=(2.0, 4))
    ref = _run(RefModule, **steady)
    port = _run(PortModule, **steady)
    assert ref["fired"] == 0, ref
    assert port["fired"] >= 1 and any("encode" in r for r in port["raises"]), port
