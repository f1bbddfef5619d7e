"""The port's offline tools (`ceph_tpu_torch/tools/`: `ec_tool`,
`ec_benchmark`, `ec_corpus`, `bench_sweep`, `bluestore_tool`,
`trace_export`) run the reference's own cases, on the CPU.

The cases are the reference's text with its imports pointed at the port
(`torch_ported.load`): every class of `tests/test_tools.py`,
`tests/test_corpus.py`, `test_bluestore.py::TestBluestoreTool`, the
classes of `test_flight_recorder.py` and `test_mempool.py`'s
`test_trace_export_emits_hbm_counter_track`.  The tools and the codecs
default to cuda; `cpu_tools` makes their default the CPU for a test's
length, as `--device cpu` would, and `cpu_daemons` does so for the OSD
and the monitor of `TestDumpFlightAsok`.

Reference cases that do not run on the port, and the port test of the
same check:

- `TestTraceExport::test_live_run_exports_valid_chrome_trace` arms a
  `codec.launch` fault and asserts that the failed launch landed on a
  "host fallback" lane.  The port recomputes nothing on the host
  (`ops/guard.py`): the launch fails with EIO and its record is flagged
  `error`.  `test_live_run_exports_valid_chrome_trace_without_fallback`
  makes the same live run and holds the trace to the same contract, with
  the failed launch on the device lane, flagged.
- `TestAggregatedLaunchRecords::test_injected_launch_fault_flags_fallback`
  and `test_guard_timeout_flags_timeout_then_bypass` assert the host
  recompute's `fallback` and `degraded_bypass` flags, for the same
  reason; the port's failed and refused launches are held to their
  `error` flag and their EIO in `tests/test_torch_aggregator.py`
  (`test_guard_drill_eio_then_probe_heals`,
  `test_guard_timeout_flags_timeout_then_refuses`).
- `TestAggregatedLaunchRecords`' `setup_method` makes its codec with no
  device before any fixture runs; the port's subclass makes it in a
  fixture after `cpu_tools`.
"""

import numpy as np
import pytest

from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)
from torch_ported import collect, cpu_daemons, cpu_tools, load  # noqa: F401 (fixture)

from ceph_tpu_torch.codec import ErasureCodeTpuRs
from ceph_tpu_torch.codec.matrix_codec import DecodeAggregator, EncodeAggregator
from ceph_tpu_torch.codec.interface import EcError
from ceph_tpu_torch.common.fault_injector import global_injector
from ceph_tpu_torch.ops.flight_recorder import flight_recorder
from ceph_tpu_torch.ops.guard import device_guard
from ceph_tpu_torch.stripe import StripeInfo
from ceph_tpu_torch.stripe import stripe as stripe_mod
from ceph_tpu_torch.tools.trace_export import export_chrome_trace, validate_chrome_trace

pytestmark = pytest.mark.usefixtures("cpu_tools", "cpu_daemons")

_tools = load("test_tools")
collect(_tools, ["TestEcTool", "TestBenchmark", "TestRepairWorkload", "TestBaselineSweep"],
        globals())
workfile = _tools.workfile

collect(load("test_corpus"), ["test_corpus_check", "test_corpus_detects_byte_change"], globals())
collect(load("test_bluestore"), ["TestBluestoreTool"], globals())

_flight = load("test_flight_recorder")
_clean_state = _flight._clean_state  # the reference's autouse reset, for its cases here
collect(_flight, ["TestRingBuffer", "TestDumpFlightAsok"], globals())


class TestTraceExport_torch(_flight.TestTraceExport):
    # asserts a host-fallback lane, which the port never makes (module docstring)
    test_live_run_exports_valid_chrome_trace = None


class TestAggregatedLaunchRecords_torch(_flight.TestAggregatedLaunchRecords):
    # assert the host recompute's flags (module docstring)
    test_injected_launch_fault_flags_fallback = None
    test_guard_timeout_flags_timeout_then_bypass = None

    def setup_method(self):
        """The reference's setup makes its codec with no device, and an
        xunit setup runs before any fixture: it runs in `_setup`, after
        `cpu_tools`."""

    @pytest.fixture(autouse=True)
    def _setup(self, cpu_tools):
        _flight.TestAggregatedLaunchRecords.setup_method(self)


class TestSurfacing_torch:
    test_trace_export_emits_hbm_counter_track = (
        load("test_mempool").TestSurfacing.test_trace_export_emits_hbm_counter_track
    )


def test_live_run_exports_valid_chrome_trace_without_fallback():
    """The live run of the reference's case: aggregated encodes, an
    aggregated decode and a launch failed by a `codec.launch` fault.
    The trace passes the contract validator, the stage sub-spans and
    queue_wait render as slices, and the failed launch sits on the device
    lane flagged `error`, its op failed with EIO, with no fallback lane."""
    ec = ErasureCodeTpuRs()
    ec.init({"k": "4", "m": "2"})
    sinfo = StripeInfo(4 * 512, 512)
    agg = EncodeAggregator(window=2)
    dagg = DecodeAggregator(window=0)
    rng = np.random.default_rng(1)
    tickets = [agg.submit(ec, rng.integers(0, 256, (2, 4, 512), dtype=np.uint8))
               for _ in range(4)]
    for t in tickets:
        t.result()
    data = _flight.payload(sinfo, 2, seed=11)
    shards = stripe_mod.encode(sinfo, ec, data)
    have = {i: shards[i] for i in range(6) if i != 1}
    stripe_mod.decode_shards_launch(sinfo, ec, have, {1}, aggregator=dagg).result()
    global_injector().inject("codec.launch", 5, hits=1)
    with pytest.raises(EcError) as err:
        stripe_mod.encode_launch(sinfo, ec, _flight.payload(sinfo, 1, seed=12),
                                 aggregator=agg).result()
    assert err.value.errno == -5
    device_guard().mark_healthy()
    records = flight_recorder().records()
    assert len(records) >= 3
    trace = export_chrome_trace(records)
    validate_chrome_trace(trace)
    names = {e["name"] for e in trace["traceEvents"]}
    # a CPU launch's plain version runs inside its dispatch, so the
    # reaper's wait is under a microsecond: a kernel slice renders for
    # exactly the encode records whose wait rounds to 1 us or more
    assert {"encode:h2d", "encode:d2h"} <= names
    kernels = [e for e in trace["traceEvents"] if e["name"] == "encode:kernel"]
    assert len(kernels) == sum(1 for r in records
                               if r["kind"] == "encode" and round(r["kernel_s"] * 1e6) > 0)
    assert any(n.startswith("decode") for n in names)
    assert "queue_wait" in names
    lanes = {e["tid"] for e in trace["traceEvents"]}
    assert "host fallback" not in lanes
    failed = [e for e in trace["traceEvents"]
              if e["pid"] == "devices" and "error" in e.get("args", {}).get("flags", "")]
    assert failed and {e["tid"] for e in failed} == {"device x1"}
