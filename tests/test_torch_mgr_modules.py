"""The port's mgr modules against the JAX package's, on the CPU."""

import asyncio
import importlib
import json
from types import SimpleNamespace

import pytest

import torch_metrics_lint
from test_metrics_lint import lint_exposition
from torch_pg_host import PgCluster
from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)
from torch_ported import collect, cpu_daemons, load  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("cpu_daemons")

CASES = {
    "test_mgr": ["TestPrometheus", "TestBalancer", "TestPgAutoscaler", "TestTelemetry",
                 "TestTelemetrySalt", "TestDashboard", "TestOrchestrator"],
    "test_iostat": ["TestIOAccountant", "TestIostatModule", "TestSLOBurnRate", "TestTraceSampling",
                    "TestSlowOpsUnderSampling", "TestZeroPayloadWriteAccounting",
                    "TestMgrAsokIostat"],
    "test_progress": ["TestPgProgressEvents", "TestProgressModule", "TestMonSurfaces"],
    "test_metrics_history": ["TestRateDerivation", "TestSentinels", "TestMonSurfaces",
                             "TestTelemetryEnvelope", "TestDashboardSurfaces",
                             "TestMgrAsokPerfHistory"],
    "test_tsdb": ["TestDownsampleOracle", "TestCardinalityCap", "TestBoundedMemory",
                  "TestQuerySurface"],
}
for _name, _cases in CASES.items():
    collect(load(_name), _cases, globals())


# -- the differential: one seeded report stream, both packages' Mgr -----------

PKG_ROOT = {"jax": "ceph_tpu", "torch": "ceph_tpu_torch"}
POOLS = [dict(name="rbd", kind="ec", k=4, m=2, pg_num=16, stripe_unit=4096, overwrites=True),
         dict(name="rbd_meta", kind="rep", size=3, pg_num=8)]
DAEMONS = ["osd.0", "osd.1", "osd.2"]
CLIENTS = ["client.admin", "client.4100", "client.77"]
TICKS = 28


class _Clock:
    """A module's `time`, with the clocks pinned: `monotonic()` and
    `time()` read what the test set; everything else is the real module's."""

    def __init__(self):
        self.now = 1000.0

    def monotonic(self):
        return self.now

    def time(self):
        return 1.7e9 + self.now

    def __getattr__(self, name):
        import time

        return getattr(time, name)


def report_stream(seed: int):
    """TICKS rounds of every daemon's (perf, status), as MMgrReports carry
    them: cumulative op, dispatch, aggregator, trace and storm counters, the
    IO accountant's pool and client blobs, PG recovery events that progress
    to done, a whole-OSD rebuild's storm bar, slow ops and store usage."""
    import numpy as np

    from ceph_tpu.common.io_accounting import IOAccountant

    rng = np.random.default_rng(seed)
    accs = {d: IOAccountant() for d in DAEMONS}
    perf = {d: {"op": 0, "op_w": 0, "op_r": 0, "ec_dispatch.bytes": 0,
                "ec_dispatch.decode_bytes": 0, "ec_dispatch.launches": 0,
                "ec_dispatch.fallback_launches": 0, "ec_dispatch.device_occupancy": 0.0,
                "ec_dispatch.flight_mean_queue_wait_ms": 0.0, "ec_aggregator.batches": 0,
                "ec_aggregator.stripes": 0, "trace.spans_started": 0,
                "recovery_storm.waves": 0, "op_latency": {"sum": 0.0, "avgcount": 0}}
            for d in DAEMONS}
    rec_total = 40
    rounds = []
    for t in range(TICKS):
        round_ = {}
        for i, d in enumerate(DAEMONS):
            acc = accs[d]
            for _ in range(int(rng.integers(5, 30))):
                pool = int(rng.integers(1, 3))
                cls = ["write", "read", "recovery"][int(rng.integers(0, 3))]
                client = "recovery" if cls == "recovery" else CLIENTS[int(rng.integers(0, 3))]
                acc.account(pool, client, cls, int(rng.integers(1, 64)) * 4096,
                            float(rng.uniform(0.0005, 0.2)) if cls != "recovery" else None)
            p = perf[d]
            launches = int(rng.integers(10, 200))
            p["op"] += launches
            p["op_w"] += launches // 2
            p["op_r"] += launches - launches // 2
            p["ec_dispatch.bytes"] += launches * 4 << 20
            p["ec_dispatch.decode_bytes"] += int(rng.integers(0, 8)) << 20
            p["ec_dispatch.launches"] += launches
            p["ec_dispatch.device_occupancy"] = float(rng.uniform(0.3, 0.9))
            p["ec_dispatch.flight_mean_queue_wait_ms"] = float(rng.uniform(0.05, 2.0))
            p["ec_aggregator.batches"] += launches // 4
            p["ec_aggregator.stripes"] += launches * 8
            p["trace.spans_started"] += int(rng.integers(0, 50))
            p["recovery_storm.waves"] += int(t > 4)
            p["op_latency"] = {"sum": p["op_latency"]["sum"] + float(rng.uniform(0, 1)),
                               "avgcount": p["op_latency"]["avgcount"] + launches}
            done = min(rec_total, max(0, (t - 4) * 3 + i))
            status = {
                "up": True, "num_pgs": 16,
                "pool_io": acc.dump_pools(), "client_io": acc.dump_clients(),
                "slow_ops": {"count": int(t == 10 and i == 1), "oldest_sec": 0.0},
                "pool_stored": {"1": 1000 * t, "2": 10 * t},
                "pool_heads": {"1": t, "2": t}, "pool_bytes": {"1": 1500 * t, "2": 30 * t},
                "tpu_backend": {"degraded": False, "degraded_for_sec": 0.0, "reason": "",
                                "fallback_launches": 0},
                "hbm_mempools": {"ec_pipeline_inflight": {"bytes": 4096 * t, "buffers": t,
                                                           "peak_bytes": 8192 * t}},
                "hbm_pressure": {"ratio": 0.1, "target_bytes": 1 << 30},
            }
            if 4 < t < 20:
                status["progress"] = {f"1.{i}": [{"kind": "recovery", "objects_done": done,
                                                  "objects_total": rec_total,
                                                  "bytes_done": done << 20,
                                                  "bytes_total": rec_total << 20}]}
                status["recovery_storm"] = {"victims": ["osd.3"], "objects_done": done,
                                            "objects_total": rec_total,
                                            "bytes_done": done << 20,
                                            "bytes_total": rec_total << 20}
            round_[d] = (json.loads(json.dumps(p)), json.loads(json.dumps(status)))
        rounds.append(round_)
    return rounds


def run_mgr(pkg: str, rounds, monkeypatch) -> dict:
    """Both packages' Mgr, fed `rounds` one a (pinned) second, every
    module registered; every module's surface at the end."""
    root = PKG_ROOT[pkg]

    def imp(name):
        return importlib.import_module(f"{root}.{name}")

    clock = _Clock()
    for mod in ("mgr.iostat", "mgr.progress", "mgr.metrics_history", "mgr.telemetry", "mgr.mgr"):
        monkeypatch.setattr(imp(mod), "time", clock)
    monkeypatch.setattr(imp("mgr.telemetry"), "secrets",
                        SimpleNamespace(token_hex=lambda n: "5a" * n))
    mgr_mod, om = imp("mgr.mgr"), imp("osd.osdmap")
    mgr = mgr_mod.Mgr("x", imp("mon.monmap").MonMap(addrs={"a": "127.0.0.1:6789"}))
    osdmap = om.OSDMap()
    osdmap.fsid = "mgr-differential"
    osdmap.crush.build_flat(6, 1)
    for i in range(6):
        osdmap.add_osd(i, addr=f"127.0.0.1:{6800 + i}", up=True)
    for spec in POOLS:
        PgCluster._create_pool(om, osdmap, spec)
    osdmap.epoch = 7
    mgr.osdmap = osdmap
    mgr.active = True
    mods = {}
    for name, cls, kw in (("prometheus", "prometheus.PrometheusModule", {}),
                          ("iostat", "iostat.IostatModule", {}),
                          ("progress", "progress.ProgressModule", {}),
                          ("metrics_history", "metrics_history.MetricsHistoryModule", {}),
                          ("telemetry", "telemetry.TelemetryModule", {"enabled": True}),
                          ("dashboard", "dashboard.DashboardModule", {}),
                          ("orchestrator", "orchestrator.OrchestratorModule", {}),
                          ("balancer", "balancer.BalancerModule", {}),
                          ("pg_autoscaler", "pg_autoscaler.PgAutoscalerModule", {}),
                          ("clog", "clog.ClogModule", {})):
        modname, clsname = cls.split(".")
        mods[name] = getattr(imp(f"mgr.{modname}"), clsname)(**kw)
        mgr.register_module(mods[name])

    async def feed():
        for round_ in rounds:
            clock.now += 1.0
            for d, (perf, status) in round_.items():
                st = mgr.daemons.setdefault(d, mgr_mod.DaemonState())
                st.perf, st.status, st.last_report = perf, status, clock.now
            for module in mgr.modules:
                if module.NAME == "clog":  # it polls the monitors: fed below
                    continue
                result = module.tick()
                if asyncio.iscoroutine(result):
                    await result

    asyncio.run(feed())
    log = imp("msg.messages").MLog(entries=json.dumps(
        [{"who": d, "seq": s, "channel": "cluster", "prio": p, "msg": f"{d} said {s}"}
         for s, p in enumerate(("info", "warn", "error", "info")) for d in DAEMONS]).encode())
    mods["clog"]._absorb(log)
    mh, io = mods["metrics_history"], mods["iostat"]
    return {
        "scrape": mods["prometheus"].scrape().splitlines(),
        "iostat": io.iostat(),
        "top_clients": [io.top_clients(by=by) for by in ("ops_rate", "bytes_rate", "p99")],
        "digest": mgr.pg_digest(),
        "health": mgr.health_checks(),
        "history_ls": mh.history_ls(),
        "history_get": [mh.history_get(s, daemon=d, window=60.0, aggregate=a)
                        for s in ("encode_gbps", "launches_per_sec", "fallback_per_sec")
                        for d in (None, "osd.0") for a in ("avg", "max")],
        "balancer": (mods["balancer"].last_plan, mods["balancer"].score()),
        "autoscaler": mods["pg_autoscaler"].last_recommendations,
        "telemetry": mods["telemetry"].compile_report(),
        "dashboard": [mods["dashboard"].render(p) for p in (
            "/", "/api/health", "/api/osds", "/api/pools", "/api/pgs", "/api/daemons",
            "/api/perf_history", "/api/log", "/nope")],
        "orchestrator": (mods["orchestrator"].ps(), mods["orchestrator"].device_ls()),
        "clog": (mods["clog"].clog_digest(), mods["clog"].prometheus_metrics()),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_every_module_surface_matches_the_reference(seed, monkeypatch):
    """Exact: the same seeded reports, with the clocks and the telemetry
    salt pinned, give equal surfaces, value for value and line for line."""
    rounds = report_stream(seed)
    ref = run_mgr("jax", rounds, monkeypatch)
    ours = run_mgr("torch", rounds, monkeypatch)
    for key in ref:
        assert ours[key] == ref[key], key
    text = "\n".join(ours["scrape"]) + "\n"
    # test_metrics_lint's rules, and chip_smoke.py's copy of them
    assert torch_metrics_lint.lint_exposition(text) == lint_exposition(text)
    # the stream reaches every surface: rates, events done, a rebuild bar
    assert ref["iostat"] and ref["top_clients"][0]
    assert any("ec_dispatch" in line for line in ref["scrape"])
    assert ref["digest"]["progress"]["completed"] >= 1
    assert ref["history_get"][2]["points"]


# -- chip_smoke.py's copy of the exposition rules -----------------------------

LINT_TEXTS = [
    '# HELP h latency\n# TYPE h histogram\nh_bucket{le="0.1"} 1\nh_bucket{le="+Inf"} 3\n'
    'h_sum 1.5\nh_count 3\n',
    '# HELP g x\n# TYPE g gauge\ng{pool="1",op="w"} 2.5\ng{pool="2",op="w"} 0\n\n',
    "m 1\n",
    "# HELP m x\n# TYPE m gauge\n# HELP m x\n# TYPE m gauge\nm 1\n",
    '# HELP h x\n# TYPE h histogram\nh_bucket{le="1"} 5\nh_bucket{le="+Inf"} 3\nh_sum 1\n'
    'h_count 3\n',
    '# HELP h x\n# TYPE h histogram\nh_bucket{le="1"} 1\nh_sum 1\nh_count 1\n',
    '# HELP h x\n# TYPE h histogram\nh_bucket{le="+Inf"} 2\nh_sum 1\nh_count 3\n',
    "# HELP m x\n# TYPE m gauge\nm 1",
    "# HELP a x\n# TYPE b gauge\na 1\n",
    "# HELP m \n# TYPE m gauge\nm 1\n",
    "# HELP m x\n# TYPE m gauge\nm one\n",
    "# HELP m x\n# TYPE m gauge\n# a comment\nm 1\n",
    "# HELP a x\n# TYPE a gauge\n# HELP b y\n# TYPE b counter\nb 1\na 1\n",
]


@pytest.mark.parametrize("text", LINT_TEXTS)
def test_the_lint_copy_rules_as_test_metrics_lint(text):
    """Exact: the copy accepts what the original accepts, with the same
    families, and rejects what it rejects, with the same message (its
    first line: pytest rewrites the asserts of test files only)."""
    def run(lint):
        try:
            return lint(text)
        except (AssertionError, ValueError) as e:
            return (type(e).__name__, str(e).split("\n")[0])

    assert run(torch_metrics_lint.lint_exposition) == run(lint_exposition)
