"""The port's offload runtime helpers on the CPU (ceph_tpu_torch.common and
ceph_tpu_torch.ops: options, lockdep, perf counters, throttle, the mempool
ledger, the dmClock scheduler, the flight recorder, the launch scheduler,
the device guard and the dispatch gauges), each pinned to the JAX package's
copy: the same inputs give the same results, exactly."""

import ast
import gc
import os
import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

from ceph_tpu.codec import matrix_codec as jmc
from ceph_tpu.common import options as joptions
from ceph_tpu.common.mempool import MempoolLedger as JLedger
from ceph_tpu.common.perf_counters import PerfCountersBuilder as JBuilder
from ceph_tpu.ops import dispatch as jdispatch
from ceph_tpu.ops import flight_recorder as jflight
from ceph_tpu.ops import launch_scheduler as jlaunch
from ceph_tpu.ops import offload_runtime as jruntime
from ceph_tpu.osd import scheduler as jsched

from ceph_tpu_torch.codec import matrix_codec, registry
from ceph_tpu_torch.codec.matrix_codec import EncodeAggregator
from ceph_tpu_torch.common import lockdep, options
from ceph_tpu_torch.common.fault_injector import InjectedFailure, faultpoint, global_injector
from ceph_tpu_torch.common.mempool import MempoolLedger, ledger, track_buffer
from ceph_tpu_torch.common.perf_counters import PerfCountersBuilder, PerfCountersCollection
from ceph_tpu_torch.common.throttle import Throttle
from ceph_tpu_torch.ops import dispatch, flight_recorder, guard, launch_scheduler, offload_runtime
from ceph_tpu_torch.ops.offload_runtime import DonationPool, _PadBuckets
from ceph_tpu_torch.osd import scheduler

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

# the reference's services that the port has not ported yet: none since A7
UNPORTED_SERVICES = ()


@pytest.fixture(autouse=True)
def _clean_state():
    flight_recorder.flight_recorder().reset()
    yield
    global_injector().clear()
    g = guard.device_guard()
    g.mark_healthy()
    g.configure(timeout_ms=20000, probe_interval_ms=2000)
    flight_recorder.flight_recorder().reset()


def _cpu_codec(k=4, m=2):
    return registry.instance().factory("tpu", {"k": str(k), "m": str(m)}, device="cpu")


# -- options ---------------------------------------------------------------------------


def test_option_table_is_the_runtime_slice():
    names = set(options.OPTIONS)
    assert len(names) == 38
    for lane in ("client", "recovery", "background"):
        for knob in ("res", "wgt", "lim"):
            assert f"ec_tpu_sched_{lane}_{knob}" in names
    assert {"ec_tpu_pipeline_depth", "ec_tpu_inflight_max_bytes", "ec_tpu_launch_timeout_ms",
            "ec_tpu_hbm_target_bytes", "ec_tpu_verify_aggregate_window",
            "ec_tpu_device_cache_bytes", "ec_tpu_rmw_delta"} <= names
    assert {"osd_objectstore", "osd_data", "bluestore_compression_algorithm",
            "bluestore_compression_required_ratio", "bluestore_csum_offload",
            "bluestore_csum_offload_window", "bluestore_csum_offload_max_bytes"} <= names
    assert {"osd_recovery_max_active", "osd_recovery_push_retry_sec", "osd_max_backfills",
            "osd_min_pg_log_entries", "osd_max_pg_log_entries", "osd_backfill_scan_max"} <= names


def test_option_see_also_names_options_of_the_table():
    for opt in options.OPTIONS.values():
        assert set(opt.see_also) <= set(options.OPTIONS), opt.name


@pytest.mark.parametrize("name", sorted(options.OPTIONS))
def test_option_matches_reference(name):
    ours, ref = options.OPTIONS[name], joptions.OPTIONS[name]
    assert ours.type is ref.type
    assert ours.default == ref.default
    assert ours.runtime == ref.runtime
    assert ours.level.value == ref.level.value
    assert ours.see_also == ref.see_also
    assert ours.parse(str(ref.default)) == ref.parse(str(ref.default))


# -- pinned helpers ------------------------------------------------------------------


def _pool_script(pool_cls):
    """One sequence of DonationPool operations; returns what each observed,
    pooled buffers named by their index."""
    pool = pool_cls(cap=2)
    bufs = [torch.zeros(4 + i, dtype=torch.uint8) for i in range(6)]

    def name(buf):
        return None if buf is None else next(i for i, b in enumerate(bufs) if b is buf)

    seen = []
    pool.hold(bufs[0])
    pool.put((4, 3), bufs[0])  # refused: live
    seen.append(name(pool.take((4, 3))))
    pool.release(bufs[0])
    for b in bufs[:4]:
        pool.put((4, 3), b)  # past the cap: oldest out
    pool.put((8, 3), bufs[4])
    pool.put((2, 1), bufs[5])
    seen += [sorted(pool), len(pool), name(pool.take((4, 3))), pool.drop_batch(8),
             sorted(pool)]
    pool.hold(bufs[2])
    seen.append(name(pool.take((4, 3))))  # pooled, then held live: refused
    seen += [pool.drop_free(), len(pool)]
    return seen


def test_donation_pool_matches_reference():
    led = ledger()
    before = led.snapshot()["ec_donation"]["bytes"]
    live0 = dispatch.PIPELINE.snapshot()["donation_recycled_live"]
    assert _pool_script(DonationPool) == _pool_script(jruntime.DonationPool)
    assert led.snapshot()["ec_donation"]["bytes"] == before
    # both refusals of a live buffer were counted on the invariant gauge
    assert dispatch.PIPELINE.snapshot()["donation_recycled_live"] == live0 + 2


@pytest.mark.parametrize("cap", [1, 2, 4])
def test_pad_buckets_target_matches_reference(cap):
    rng = np.random.default_rng(cap)
    sizes = [int(s) for s in rng.choice([3, 5, 7, 11, 23, 23, 23, 40, 65, 130], 200)]
    ours, ref = _PadBuckets(), jruntime._PadBuckets()
    for s in sizes:
        static = jmc.EncodeAggregator(window=2)._pad_target(s)
        assert EncodeAggregator(window=2)._pad_target(s) == static
        assert ours.target(s, static, cap) == ref.target(s, static, cap)
        assert ours.buckets == ref.buckets
    assert ours.waste_ewma == ref.waste_ewma


class _Clock:
    def __init__(self):
        self.now = 0.0

    def __call__(self):
        return self.now


def _mclock_order(mod, profiles, seed):
    clock = _Clock()
    sched = mod.MClockScheduler(
        profiles={mod.SchedClass[k]: mod.ClientProfile(*v) for k, v in profiles.items()},
        clock=clock,
    )
    rng = np.random.default_rng(seed)
    classes = list(mod.SchedClass)
    order = []
    for step in range(300):
        clock.now = step * 0.01
        if rng.random() < 0.6:
            klass = classes[int(rng.integers(len(classes)))]
            sched.enqueue(mod.WorkItem(run=None, klass=klass,
                                       cost=int(rng.choice([4096, 65536, 1 << 20]))))
        if rng.random() < 0.5:
            item = sched.dequeue()
            order.append(None if item is None else item.klass.value)
    while len(sched):
        order.append(sched.dequeue().klass.value)
    return order


@pytest.mark.parametrize("profiles", [
    {"CLIENT": (25600.0, 2.0, 0.0), "RECOVERY": (0.0, 1.0, 0.0),
     "SCRUB": (0.0, 0.5, 0.0), "BEST_EFFORT": (0.0, 0.5, 0.0)},
    {"CLIENT": (1.0, 2.0, 0.0), "RECOVERY": (0.0, 1.0, 3.0),
     "SCRUB": (0.0, 1.0, 3.0), "BEST_EFFORT": (0.0, 1.0, 0.0)},
])
def test_mclock_dequeue_order_matches_reference(profiles):
    ours = _mclock_order(scheduler, profiles, seed=7)
    assert ours == _mclock_order(jsched, profiles, seed=7)
    assert len([c for c in ours if c]) > 50


def _counters(builder_cls):
    b = builder_cls("ec_aggregator")
    b.add_u64_counter("launches").add_u64("depth").add_time_avg("lat")
    b.add_histogram("stripes_per_launch", "occupancy", lowest=1, buckets=14)
    b.add_histogram_2d("size_lat")
    pc = b.create_perf_counters()
    for i in range(40):
        pc.inc("launches")
        pc.set("depth", i % 5)
        pc.tinc("lat", 0.001 * i)
        pc.hinc("stripes_per_launch", (i * 7) % 300)
        pc.hinc2("size_lat", 4096 * (i + 1), 1e-5 * i)
    return pc


def test_perf_counters_dump_matches_reference():
    ours, ref = _counters(PerfCountersBuilder), _counters(JBuilder)
    assert ours.dump() == ref.dump()
    assert ours.dump_histograms() == ref.dump_histograms()
    coll = PerfCountersCollection()
    coll.add(ours)
    from ceph_tpu.common.perf_counters import PerfCountersCollection as JCollection

    jcoll = JCollection()
    jcoll.add(ref)
    assert coll.prometheus_text() == jcoll.prometheus_text()


def test_throttle_admission():
    t = Throttle("t", 10)
    assert t.get_or_fail(6) and not t.get_or_fail(6)
    t.take(6)  # oversized admission past the limit
    assert t.current == 12
    t.put(12)
    t.get(30)  # larger than the limit, nothing held: admitted
    assert t.current == 30


# -- lockdep -------------------------------------------------------------------------


def test_lockdep_follows_the_switch_and_catches_an_inversion():
    import os

    assert lockdep.enabled() == (os.environ.get("CEPH_TPU_LOCKDEP", "") not in ("", "0"))
    if not lockdep.enabled():
        pytest.skip("lockdep is switched off (CEPH_TPU_LOCKDEP=0)")
    a, b = lockdep.make_lock("torch_test_a"), lockdep.make_rlock("torch_test_b")
    with a:
        with b:
            with b:  # reentrant
                pass
    with pytest.raises(lockdep.LockOrderError):
        with b:
            with a:
                pass
    assert "torch_test_b" in lockdep.graph_dump()["torch_test_a"]


# -- fault injection -----------------------------------------------------------------


def test_faultpoint_registered_and_hit_budget():
    with pytest.raises(ValueError):
        faultpoint("codec.typo")
    global_injector().inject("codec.launch", 5, hits=2)
    for _ in range(2):
        with pytest.raises(InjectedFailure):
            faultpoint("codec.launch")
    faultpoint("codec.launch")  # budget spent


# -- mempool ledger ------------------------------------------------------------------


def test_ledger_alloc_resize_free_and_peaks_match_reference():
    out = []
    for cls in (MempoolLedger, JLedger):
        led = cls()
        h1 = led.alloc("ec_donation", 100)
        h2 = led.alloc("custom_pool", 50)
        h1.resize(300)
        h1.free()
        h1.free()  # idempotent
        out.append((led.snapshot(), led.total_device_bytes(), led.peak_total_bytes(),
                    led.reconcile()))
        h2.free()
    assert out[0] == out[1]
    assert out[0][0]["ec_donation"] == {"bytes": 0, "buffers": 0, "peak_bytes": 300,
                                        "peak_buffers": 1}


def test_ledger_keys_torch_placements():
    led = MempoolLedger()
    t = torch.zeros(1000, dtype=torch.uint8)
    h = led.alloc("scratch", t.nbytes, buf=t)
    assert h.devices == ("cpu:0",)
    assert led.per_device() == {"cpu:0": 1000}
    led.alloc("scratch", 24)
    assert led.per_device() == {"cpu:0": 1000, "unplaced": 24}
    del t
    gc.collect()
    assert led.current_bytes("scratch") == 24  # the tensor's death freed its handle


def test_track_buffer_frees_on_gc_and_skips_host_arrays():
    led = ledger()
    base = led.current_bytes("scratch")
    t = track_buffer(torch.ones(4096, dtype=torch.uint8))
    assert led.current_bytes("scratch") == base + 4096
    del t
    gc.collect()
    assert led.current_bytes("scratch") == base
    track_buffer(np.ones(4096, dtype=np.uint8))
    assert led.current_bytes("scratch") == base


def test_pressure_stages_and_clear():
    from ceph_tpu_torch.ops.device_cache import device_chunk_cache

    device_chunk_cache().clear()
    led = MempoolLedger(target_bytes=1000)
    h = led.alloc("ec_pipeline_inflight", 1100)
    status = led.check_pressure()
    # stage 1 trims the device chunk cache, which is empty here
    assert status["stage"] == 3 and led.donation_capped and led.depth_clamped
    assert status["actions"]["cache_trimmed_bytes"] == 0
    h.free()
    status = led.check_pressure()
    assert status["stage"] == 0 and not led.donation_capped and not led.depth_clamped
    assert status["actions"]["clears"] == 1


# -- flight recorder -----------------------------------------------------------------


def test_new_record_has_the_reference_schema():
    ours = flight_recorder.new_record("encode", group="g", tickets=2, stripes=3)
    ref = jflight.new_record("encode", group="g", tickets=2, stripes=3)
    assert set(ours) == set(ref)
    assert ours["flags"] == ref["flags"]


def test_ring_capacity_resize_and_concurrent_commits():
    fr = flight_recorder.FlightRecorder(capacity=16)

    def commit(n):
        for i in range(n):
            rec = flight_recorder.new_record("encode", stripes=i)
            rec["h2d_s"] = 0.001
            fr.commit(rec)

    threads = [threading.Thread(target=commit, args=(25,)) for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    recs = fr.records()
    assert len(recs) == 16
    assert fr.summary()["launches"] == 100
    seqs = [r["seq"] for r in recs]
    assert len(set(seqs)) == 16 and max(seqs) == 100
    fr.configure(capacity=4)
    assert [r["seq"] for r in fr.records()] == seqs[-4:]
    util = fr.utilization()
    assert util["span_records"] == 100 and util["busy_seconds"] == pytest.approx(0.1)
    fr.reset()
    assert fr.records() == [] and fr.utilization()["span_records"] == 0


def test_active_scope_flags_the_running_record():
    fr = flight_recorder.flight_recorder()
    rec = flight_recorder.new_record("encode")
    with fr.active_scope(rec):
        fr.flag_active("timeout")
        dispatch.record_launch(2, 100, decode=True)
    assert rec["flags"]["timeout"] and rec["kind"] == "decode"
    fr.flag_active("timeout")  # no active record: a no-op
    dispatch.record_launch(1, 10, verify=True)  # outside any launch: a raw record
    raw = fr.records()[-1]
    assert raw["group"] == "#raw" and raw["kind"] == "verify"


# -- launch scheduler ----------------------------------------------------------------


def _make_sched(mod, clock, smod):
    return mod.LaunchScheduler(
        profiles={
            smod.SchedClass.CLIENT: smod.ClientProfile(reservation=1.0, weight=2.0),
            smod.SchedClass.RECOVERY: smod.ClientProfile(weight=1.0),
            smod.SchedClass.SCRUB: smod.ClientProfile(weight=0.5),
            smod.SchedClass.BEST_EFFORT: smod.ClientProfile(weight=0.5),
        },
        clock=clock,
    )


def test_client_dequeues_ahead_of_background_like_reference():
    orders = []
    for mod, smod in ((launch_scheduler, scheduler), (jlaunch, jsched)):
        sched = _make_sched(mod, lambda: 0.0, smod)
        order = []
        for i in range(20):
            sched.submit_async(smod.SchedClass.SCRUB, lambda i=i: order.append(f"bg{i}"),
                               cost=1 << 20)
        for i in range(4):
            sched.submit_async(smod.SchedClass.CLIENT, lambda i=i: order.append(f"c{i}"),
                               cost=4096)
        assert sched.queue_depths() == {"client": 4, "recovery": 0, "background": 20}
        assert sched.drain() == 24
        orders.append(order)
        dump = sched.perf_dump()
        assert dump["client.dequeued"] == 4 and dump["background.queue_depth"] == 0
    assert orders[0] == orders[1]
    assert max(orders[0].index(f"c{i}") for i in range(4)) < 5


def test_submit_runs_on_another_submitters_turn():
    sched = launch_scheduler.LaunchScheduler()
    results, errors = {}, []

    def submitter(i):
        try:
            results[i] = sched.submit(scheduler.SchedClass.CLIENT, lambda i=i: i * i)
        except BaseException as e:  # surfaced to the assertion below
            errors.append(e)

    threads = [threading.Thread(target=submitter, args=(i,)) for i in range(8)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=30)
        assert not th.is_alive()
    assert not errors and results == {i: i * i for i in range(8)}
    with pytest.raises(KeyError):
        sched.submit(scheduler.SchedClass.SCRUB, lambda: {}["missing"])
    assert launch_scheduler.lane_name(scheduler.SchedClass.BEST_EFFORT) == "background"
    assert set(sched.perf_dump()) == set(jlaunch.LaunchScheduler().perf_dump())


# -- device guard --------------------------------------------------------------------


def test_guard_deadline_raises_and_flags_the_record():
    g = guard.DeviceGuard(timeout_ms=100, probe_interval_ms=10_000)
    release = threading.Event()
    rec = flight_recorder.new_record("encode")
    try:
        with flight_recorder.flight_recorder().active_scope(rec):
            with pytest.raises(guard.DeviceTimeout):
                g.call(lambda: release.wait(5), what="wedged dispatch")
    finally:
        release.set()
    assert rec["flags"]["timeout"]
    assert g.call(lambda: 7) == 7
    with pytest.raises(ZeroDivisionError):
        g.call(lambda: 1 // 0)


def test_guard_state_machine_probe_and_heal():
    g = guard.DeviceGuard(timeout_ms=200, probe_interval_ms=60_000)
    assert g.maybe_probe() is True  # healthy: no probe
    g.mark_degraded("test")
    assert g.snapshot()["degraded"] == 1 and g.degraded_total == 1
    # the default probe runs on cuda: with no GPU it fails like every entry point
    assert g.maybe_probe() is False and g.probe_failures == 1
    assert g.maybe_probe(lambda: None) is False  # gated by the probe interval
    g.configure(probe_interval_ms=0)
    assert g.maybe_probe(lambda: None) is False  # re-probing disabled: sticky
    g.configure(probe_interval_ms=1)
    threading.Event().wait(0.01)
    assert g.maybe_probe(lambda: None) is True and not g.degraded
    assert g.probes == 2


def test_default_probe_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this check is for a host without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        guard._default_probe()


# -- dispatch gauges and the offload registry ----------------------------------------


def _run_one_encode(mc, ec):
    agg = mc.EncodeAggregator(window=2)
    data = np.random.default_rng(0).integers(0, 256, (3, 4, 4100), dtype=np.uint8)
    tickets = [agg.submit(ec, data), agg.submit(ec, data[:1])]
    out = [np.asarray(t) for t in tickets]
    agg.drain()
    return out


def test_dispatch_perf_dump_keys_match_reference():
    from ceph_tpu.codec import ErasureCodeTpuRs as JRs

    jec = JRs()
    jec.init({"k": "4", "m": "2"})
    live0 = dispatch.PIPELINE.snapshot()["donation_recycled_live"]
    ours = _run_one_encode(matrix_codec, _cpu_codec())
    ref = _run_one_encode(jmc, jec)
    assert all(np.array_equal(a, b) for a, b in zip(ours, ref))

    def keys(dump):
        # pad_waste labels and devices_per_launch widths depend on history
        return {k for k in dump if not k.startswith(("pad_waste.", "devices_per_launch."))}

    assert keys(dispatch.perf_dump()) == keys(jdispatch.perf_dump())
    dump = dispatch.perf_dump()
    assert dump["pipeline.donation_recycled_live"] == live0
    assert dump["sharded_launches"] == 0 and "devices_per_launch.1" in dump


def test_offload_registry_and_perf_dump_match_reference():
    # Registration follows import order, and a test process imports the
    # service modules in whatever order its test files do.  So the order
    # is compared in a fresh process, where each package's offload_services
    # imports its built-in services itself.
    code = (
        "from ceph_tpu.ops import offload_runtime as j\n"
        "from ceph_tpu_torch.ops import offload_runtime as t\n"
        "print(repr((t.offload_services(), j.offload_services())))\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=os.path.dirname(os.path.dirname(__file__)),
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    fresh, jfresh = ast.literal_eval(proc.stdout.strip().splitlines()[-1])
    assert fresh == ("encode", "decode", "verify", "compress", "csum")
    assert tuple(s for s in jfresh if s not in UNPORTED_SERVICES) == fresh
    services = offload_runtime.offload_services()
    assert sorted(services) == sorted(fresh)
    assert offload_runtime.service_aggregator("encode") is matrix_codec.default_encode_aggregator()
    assert offload_runtime.service("verify").lane == "background"
    again = offload_runtime.register_service("encode", lambda: None)
    assert again is offload_runtime.service("encode")
    with pytest.raises(KeyError):
        offload_runtime.service("nope")
    ours = offload_runtime.offload_perf_dump()
    ref = jruntime.offload_perf_dump()
    ref_keys = {k for k in ref if k.split(".")[0] not in UNPORTED_SERVICES}
    assert set(ours) == ref_keys
    assert ours["services"] == 5
    agg = matrix_codec.default_verify_aggregator()
    assert (agg.window, agg.max_bytes, agg.pipeline_depth) == (64, 64 << 20, 2)
