"""The port's mgr daemon (`ceph_tpu_torch/mgr/`) against the JAX package's,
on the CPU.

The reference's mgr-core cases (`tests/test_mgr.py`: the active election
and the daemons' reports, the PGMap digest behind `ceph df`, a deleted
pool's id-keyed record, standby failover) run on each package, over the
`inproc` messenger stack, with monitors, daemons and the small client of
`torch_daemon_host.DaemonCluster(mons=1)`.  Also, on each package: a
daemon whose device guard goes DEGRADED shows TPU_BACKEND_DEGRADED in
`ceph health` through the mgr's digest, and the check clears once the
guard is healthy; and, the port's only, a mgr with a keyring serves a
cluster that runs cephx (the reference's mgr takes no keyring)."""

import asyncio
import importlib
import json
from types import SimpleNamespace

import pytest

from test_torch_mon import PKGS, ROOT
from torch_daemon_host import DaemonCluster, wait_until


def cluster(pkg, n_osds, pools, tmp_path, **kw):
    d = tmp_path / pkg
    d.mkdir(exist_ok=True)
    return DaemonCluster(ROOT[pkg], n_osds, pools, device="cpu" if pkg == "torch" else None,
                         root_dir=str(d), mons=1, election_timeout=0.3, mgr_beacon=0.1,
                         conf={"osd_heartbeat_interval": 0.1, "osd_heartbeat_grace": 0.6}, **kw)


@pytest.mark.parametrize("pkg", PKGS)
def test_active_election_and_reports(pkg, tmp_path):
    async def run():
        c = cluster(pkg, 3, [dict(name="mp", kind="rep", size=3, pg_num=4)], tmp_path)
        try:
            await c.start()
            mgr = c.mgr
            assert mgr.active and c.monitors[0].mgrmon.map.active_name == "x"
            await wait_until(lambda: len(mgr.daemons) == 3, 5.0, "3 daemon reports")
            op = c.client.osd_op
            rep = await c.client.op("mp", "o", [op("WRITEFULL", data=b"x" * 4096)])
            assert rep.result == 0
            await wait_until(lambda: any(mgr.get_daemon_perf(d).get("op", 0) > 0
                                         for d in mgr.list_daemons()), 5.0,
                             "op counters reaching the mgr")
            assert mgr.get_daemon_status(mgr.list_daemons()[0]).get("up") is True
        finally:
            await c.stop()

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_pg_digest_feeds_ceph_df(pkg, tmp_path):
    async def run():
        c = cluster(pkg, 3, [dict(name="dfp", kind="rep", size=3, pg_num=4)], tmp_path)
        try:
            await c.start()
            op = c.client.osd_op
            for i in range(4):
                rep = await c.client.op("dfp", f"o{i}", [op("WRITEFULL", data=b"z" * 10_000)])
                assert rep.result == 0
            mon = c.monitors[0]

            def df():
                return mon.pg_digest.get("pools", {}).get("dfp")

            await wait_until(lambda: df() is not None and df()["objects"] == 4
                             and df()["used_raw"] == 120_000, 10.0, "df digest at the mon")
            assert df()["stored"] == 40_000
            _, _, out = await c.command({"prefix": "df"})
            parsed = json.loads(out)
            assert parsed["pools"]["dfp"]["stored"] == 40_000
            assert parsed["total_used_raw"] >= 120_000
            _, _, out = await c.command({"prefix": "osd df"})
            per_osd = json.loads(out)
            assert set(per_osd) == {"osd.0", "osd.1", "osd.2"}
            assert sum(per_osd.values()) >= 120_000
        finally:
            await c.stop()

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_df_deleted_pool_keeps_id_keyed_record(pkg):
    mgr_mod = importlib.import_module(f"{ROOT[pkg]}.mgr.mgr")
    monmap_mod = importlib.import_module(f"{ROOT[pkg]}.mon.monmap")
    mgr = mgr_mod.Mgr("x", monmap_mod.MonMap(addrs={"a": "127.0.0.1:6789"}))
    mgr.osdmap.pools = {1: SimpleNamespace(id=1, name="rbd"), 2: SimpleNamespace(id=2, name="7")}
    st = mgr_mod.DaemonState()
    st.status = {"pool_stored": {"1": 1000, "7": 123, "2": 50},
                 "pool_heads": {"1": 2, "7": 1, "2": 1},
                 "pool_bytes": {"1": 3000, "7": 369, "2": 150}}
    mgr.daemons["osd.0"] = st
    pools = mgr.pg_digest()["pools"]
    assert pools["rbd"] == {"stored": 1000, "objects": 2, "used_raw": 3000}
    assert pools["7"] == {"stored": 50, "objects": 1, "used_raw": 150}
    assert "pool7" not in pools
    assert pools["id:7"]["deleted"] is True and pools["id:7"]["id"] == 7
    assert pools["id:7"]["stored"] == 123 and pools["id:7"]["used_raw"] == 369


def test_digest_matches_the_reference():
    """The same daemon states give the same digest in both packages."""
    digests = []
    for pkg in PKGS:
        mgr_mod = importlib.import_module(f"{ROOT[pkg]}.mgr.mgr")
        monmap_mod = importlib.import_module(f"{ROOT[pkg]}.mon.monmap")
        mgr = mgr_mod.Mgr("x", monmap_mod.MonMap(addrs={"a": "127.0.0.1:6789"}))
        mgr.osdmap.pools = {1: SimpleNamespace(id=1, name="rbd")}
        for i in range(3):
            st = mgr_mod.DaemonState()
            st.status = {"pool_stored": {"1": 100 * i}, "pool_heads": {"1": i},
                         "pool_bytes": {"1": 300 * i},
                         "slow_ops": {"count": i, "oldest_sec": 1.5 * i},
                         "tpu_backend": {"degraded": i == 2, "degraded_for_sec": 3.0,
                                         "reason": "launch", "fallback_launches": 0},
                         "scrub_errors": {"1.0": {"errors": i}} if i == 1 else {}}
            mgr.daemons[f"osd.{i}"] = st
        digests.append((mgr.pg_digest(), mgr.health_checks()))
    assert digests[0] == digests[1]


@pytest.mark.parametrize("pkg", PKGS)
def test_standby_failover(pkg, tmp_path):
    async def run():
        c = cluster(pkg, 1, [], tmp_path)
        mgr_b = None
        try:
            await c.start()
            mon = c.monitors[0]
            mgr_mod = importlib.import_module(f"{ROOT[pkg]}.mgr.mgr")
            mgr_b = mgr_mod.Mgr("b", c.monmap, conf=c.m.config.Config(
                {"name": "mgr.b", "ms_type": "inproc"}, env=False), addr="")
            mgr_b.beacon_interval = 0.1
            await mgr_b.start()
            await wait_until(lambda: mon.mgrmon.map.standbys == {"b": mgr_b.msgr.addr}, 5.0,
                             "mgr.b standing by")
            assert not mgr_b.active
            mon.mgrmon._last_beacon["x"] = -1000.0  # expire at once
            await c.mgr.stop()
            c.mgr = None
            await mgr_b.wait_for_active(timeout=10.0)
            assert mon.mgrmon.map.active_name == "b"
        finally:
            if mgr_b is not None:
                await mgr_b.stop()
            await c.stop()

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_a_degraded_backend_reaches_health_through_the_mgr(pkg, tmp_path):
    guard = importlib.import_module(f"{ROOT[pkg]}.ops.guard").device_guard()

    async def run():
        c = cluster(pkg, 2, [], tmp_path)
        try:
            await c.start()

            async def checks():
                return (await c.health())["checks"]

            assert "TPU_BACKEND_DEGRADED" not in await checks()
            guard.mark_degraded("launch failed")
            await wait_until(lambda: c.monitors[0].pg_digest.get("tpu_degraded"), 10.0,
                             "the degraded daemons in the mgr's digest")
            got = await checks()
            assert "TPU_BACKEND_DEGRADED" in got
            guard.mark_healthy()
            await wait_until(lambda: not c.monitors[0].pg_digest.get("tpu_degraded"), 10.0,
                             "the digest clearing")
            assert "TPU_BACKEND_DEGRADED" not in await checks()
        finally:
            guard.mark_healthy()
            await c.stop()

    asyncio.run(run())


def test_a_port_mgr_with_a_keyring_serves_a_cephx_cluster(tmp_path):
    async def run():
        c = cluster("torch", 2, [], tmp_path, keyring=True)
        try:
            await c.start()
            assert c.mgr.active
            await wait_until(lambda: len(c.mgr.daemons) == 2, 5.0, "2 daemon reports over cephx")
            assert all(conn.auth_entity for conn in c.mgr.msgr._accepted)
        finally:
            await c.stop()

    asyncio.run(run())
