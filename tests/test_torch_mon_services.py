"""The port's monitor services (`ConfigMonitor`, `LogMonitor`,
`AuthMonitor`, the OSDMonitor's pool queries) against the JAX package's,
on the CPU.

The reference's cases (`tests/test_mon_services.py`: propose, commit,
every quorum member converging, pushes to subscribers, daemons consuming
them at runtime, the cluster log's bound and filters, health mutes, key
CRUD) run on each package over the `inproc` messenger stack, with a
`MonClient` where the reference's cases hold a `Rados` client and
`torch_daemon_host.DaemonCluster(mons=N)` where they hold OSD daemons.
Where a result is deterministic the two packages' are compared: the
config store and `config dump`, and the option table, whose names must be
the reference's (the port has one more, `osd_deep_scrub_interval`, which
the reference's `config set` refuses)."""

import asyncio
import base64
import json
import time

import pytest

from test_torch_mon import PKGS, ROOT, mods, monclient, start_mons, stop_mons
from torch_daemon_host import DaemonCluster, wait_until


def cluster(pkg, n_mons, n_osds, pools, tmp_path):
    d = tmp_path / pkg
    d.mkdir(exist_ok=True)
    return DaemonCluster(ROOT[pkg], n_osds, pools, device="cpu" if pkg == "torch" else None,
                         root_dir=str(d), mons=n_mons, election_timeout=0.3,
                         conf={"osd_heartbeat_interval": 0.1, "osd_heartbeat_grace": 0.6})


async def config_session(pkg):
    """The reference's config case; returns the final store and dump."""
    m = mods(pkg)
    monmap, mons = await start_mons(m, 3)
    client = monclient(m, monmap)
    rv, rs, _ = await client.command({"prefix": "config set", "who": "osd",
                                      "name": "osd_max_backfills", "value": "7"})
    assert rv == 0, rs
    rv, _, out = await client.command({"prefix": "config get", "who": "osd.1"})
    assert rv == 0 and json.loads(out)["osd_max_backfills"] == "7"
    rv, _, _ = await client.command({"prefix": "config set", "who": "osd.1",
                                     "name": "osd_max_backfills", "value": "2"})
    assert rv == 0
    _, _, out = await client.command({"prefix": "config get", "who": "osd.1"})
    assert json.loads(out)["osd_max_backfills"] == "2"
    _, _, out = await client.command({"prefix": "config get", "who": "osd.2"})
    assert json.loads(out)["osd_max_backfills"] == "7"
    await wait_until(lambda: all(mon.configmon.version == mons[0].configmon.version
                                 for mon in mons), 3.0, "config versions converge")
    assert all(mon.configmon.sections == mons[0].configmon.sections for mon in mons)
    rv, _, _ = await client.command({"prefix": "config rm", "who": "osd.1",
                                     "name": "osd_max_backfills"})
    assert rv == 0
    _, _, out = await client.command({"prefix": "config get", "who": "osd.1"})
    assert json.loads(out)["osd_max_backfills"] == "7"
    _, _, dump = await client.command({"prefix": "config dump"})
    assert json.loads(dump)["sections"]["osd"]["osd_max_backfills"] == "7"
    rv, rs, _ = await client.command({"prefix": "config set", "who": "osd",
                                      "name": "osd_max_backfils", "value": "3"})
    assert rv < 0 and "unrecognized" in rs
    rv, rs, _ = await client.command({"prefix": "config set", "who": "osd",
                                      "name": "osd_max_backfills", "value": "nope"})
    assert rv < 0 and "invalid value" in rs
    sections = mons[0].configmon.sections
    await client.msgr.shutdown()
    await stop_mons(mons)
    return sections, dump


@pytest.mark.parametrize("pkg", PKGS)
def test_set_get_dump_rm_quorum_converges(pkg):
    asyncio.run(config_session(pkg))


def test_config_store_and_dump_match_the_reference():
    assert asyncio.run(config_session("torch")) == asyncio.run(config_session("jax"))


@pytest.mark.parametrize("pkg", PKGS)
def test_osd_consumes_pushed_config_at_runtime(pkg, tmp_path):
    async def run():
        c = cluster(pkg, 1, 2, [], tmp_path)
        try:
            await c.start()
            osds = c.osds
            observed = []
            osds[0].conf.add_observer(["osd_recovery_max_active"],
                                      lambda n, v: observed.append((n, v)))
            await c.config_set("osd", "osd_recovery_max_active", 11)
            await wait_until(lambda: all(o.conf.get("osd_recovery_max_active") == 11
                                         for o in osds), 3.0, "config push to OSDs")
            assert ("osd_recovery_max_active", 11) in observed
            await c.config_set("osd.1", "osd_recovery_max_active", 3)
            await wait_until(lambda: osds[1].conf.get("osd_recovery_max_active") == 3, 3.0,
                             "named config push")
            assert osds[0].conf.get("osd_recovery_max_active") == 11
            for who in ("osd.1", "osd"):
                await c.command({"prefix": "config rm", "who": who,
                                 "name": "osd_recovery_max_active"})
            default = osds[0].conf.get_option("osd_recovery_max_active").default
            await wait_until(lambda: all(o.conf.get("osd_recovery_max_active") == default
                                         for o in osds), 3.0, "config revert to default")
        finally:
            await c.stop()

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_clog_error_reaches_log_last(pkg, tmp_path):
    async def run():
        c = cluster(pkg, 3, 1, [], tmp_path)
        try:
            await c.start()
            mons = c.monitors
            c.osds[0].clog_error("pg 1.0 scrub: oid inconsistent on shard 2")
            await wait_until(lambda: any("inconsistent" in e["msg"] for mon in mons
                                         for e in mon.logmon.entries), 3.0, "clog entry committed")
            await wait_until(lambda: all(mon.logmon.version == mons[0].logmon.version
                                         for mon in mons), 3.0, "log versions converge")
            _, _, out = await c.command({"prefix": "log last", "num": 10})
            got = json.loads(out)
            entry = next(e for e in got["entries"] if "inconsistent" in e["msg"])
            assert entry["prio"] == "error" and entry["who"] == "osd.0"
            _, _, out = await c.command({"prefix": "log last", "num": 10, "level": "info"})
            assert not any("inconsistent" in e["msg"] for e in json.loads(out)["entries"])
            _, _, out = await c.command({"prefix": "log last", "num": 0})
            probe = json.loads(out)
            assert probe["entries"] == [] and probe["version"] >= 1
        finally:
            await c.stop()

    asyncio.run(run())


def _slo_digest(*pools: str) -> dict:
    return {"slo": {"breaches": {
        str(7 + i): {"pool": p, "target_ms": 10.0, "burn_fast": 2.0, "burn_slow": 1.5,
                     "p99_ms": 50.0}
        for i, p in enumerate(pools)}}}


def _entry(who, i, msg, prio="info", channel="cluster"):
    return {"prio": prio, "channel": channel, "who": who, "seq": i + 1, "stamp": time.time(),
            "msg": msg}


@pytest.mark.parametrize("pkg", PKGS)
def test_log_flood_bounded_and_quorum_identical(pkg):
    m = mods(pkg)

    async def run():
        monmap, mons = await start_mons(m, 3)
        assert mons[0].conf.get_option("mon_log_max").default == 500
        for mon in mons:
            mon.conf.set("mon_log_max", 40)
        client = monclient(m, monmap)
        for i in range(120):
            await client.send_log([_entry("client.flood", i, f"flood entry {i}",
                                          "error" if i % 3 == 0 else "info",
                                          "audit" if i % 5 == 0 else "cluster")])
        await wait_until(lambda: any("flood entry 119" in e["msg"]
                                     for e in mons[0].logmon.entries), 5.0, "flood committed")
        await wait_until(lambda: all(mon.logmon.version == mons[0].logmon.version
                                     for mon in mons), 3.0, "log versions converge")
        lead = [(e["who"], e.get("seq"), e["msg"]) for e in mons[0].logmon.entries]
        for mon in mons:
            assert 0 < len(mon.logmon.entries) <= 40
            assert [(e["who"], e.get("seq"), e["msg"]) for e in mon.logmon.entries] == lead
        rv, _, out = await client.command({"prefix": "log last", "num": 1000,
                                           "channel": "audit"})
        got = json.loads(out)["entries"]
        assert rv == 0 and got and all(e["channel"] == "audit" for e in got)
        _, _, out = await client.command({"prefix": "log last", "num": 1000, "level": "error"})
        got = json.loads(out)["entries"]
        assert got and all(e["prio"] == "error" for e in got)
        await client.msgr.shutdown()
        await stop_mons(mons)

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_election_preserves_committed_entries(pkg):
    m = mods(pkg)

    async def run():
        monmap, mons = await start_mons(m, 3)
        client = monclient(m, monmap)
        for i in range(10):
            await client.send_log([_entry("client.pre", i, f"pre-election {i}")])
        await wait_until(lambda: all(any("pre-election 9" in e["msg"] for e in mon.logmon.entries)
                                     for mon in mons), 5.0, "entries committed everywhere")
        committed = [e["msg"] for e in mons[1].logmon.entries
                     if e["msg"].startswith("pre-election")]
        assert len(committed) == 10
        await mons[0].stop()
        mons[1].elector.start()
        await wait_until(lambda: any(mon.is_leader() for mon in mons[1:]), 5.0, "re-election")
        for mon in mons[1:]:
            msgs = [e["msg"] for e in mon.logmon.entries]
            assert all(c in msgs for c in committed)
        rv, _, _ = await client.command({"prefix": "health"})
        assert rv == 0
        await client.send_log([_entry("client.post", 0, "post-election entry")])
        await wait_until(lambda: all(any("post-election" in e["msg"] for e in mon.logmon.entries)
                                     for mon in mons[1:]), 5.0, "post-election append")
        await client.msgr.shutdown()
        await stop_mons(mons[1:])

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_health_mute_ttl_worsen_sticky(pkg):
    m = mods(pkg)

    async def run():
        monmap, mons = await start_mons(m, 1)
        mon = mons[0]
        mon.conf.set("mon_tick_interval", 0.05)
        client = monclient(m, monmap)
        mon.pg_digest = _slo_digest("cacheA")
        await wait_until(lambda: "SLO_LATENCY_BREACH" in mon.logmon.active_checks, 5.0,
                         "SLO check raised")
        _, _, out = await client.command({"prefix": "health"})
        h = json.loads(out)
        assert h["status"] == "HEALTH_WARN" and "SLO_LATENCY_BREACH" in h["checks"]
        rv, rs, _ = await client.command({"prefix": "health mute",
                                          "code": "SLO_LATENCY_BREACH", "ttl": "1s"})
        assert rv == 0 and "muted" in rs, rs
        _, _, out = await client.command({"prefix": "health"})
        h = json.loads(out)
        assert h["status"] == "HEALTH_OK" and "SLO_LATENCY_BREACH" in h["muted"]
        assert "SLO_LATENCY_BREACH" not in h["checks"]
        assert "SLO_LATENCY_BREACH" in mon.health_checks()[0]
        await wait_until(lambda: "SLO_LATENCY_BREACH" not in mon.logmon.mutes, 5.0,
                         "ttl expiry committed")
        _, _, out = await client.command({"prefix": "health"})
        assert json.loads(out)["status"] == "HEALTH_WARN"
        assert any("health mute SLO_LATENCY_BREACH expired" in e["msg"]
                   for e in mon.logmon.entries)
        rv, _, _ = await client.command({"prefix": "health mute", "code": "SLO_LATENCY_BREACH"})
        assert rv == 0 and "SLO_LATENCY_BREACH" in mon.logmon.mutes
        mon.pg_digest = _slo_digest("cacheA", "cacheB")
        await wait_until(lambda: "SLO_LATENCY_BREACH" not in mon.logmon.mutes, 5.0,
                         "worsen auto-unmute")
        assert any("check worsened (1 -> 2)" in e["msg"] for e in mon.logmon.entries)
        rv, _, _ = await client.command({"prefix": "health mute", "code": "SLO_LATENCY_BREACH",
                                         "sticky": True})
        assert rv == 0
        mon.pg_digest = _slo_digest("cacheA", "cacheB", "cacheC")
        await asyncio.sleep(0.4)
        assert "SLO_LATENCY_BREACH" in mon.logmon.mutes
        _, _, out = await client.command({"prefix": "health"})
        assert json.loads(out)["status"] == "HEALTH_OK"
        _, _, out = await client.command({"prefix": "health history"})
        body = json.loads(out)
        assert body["events_total"] >= 2
        kinds = {(ev["type"], ev["code"]) for ev in body["events"]}
        assert ("raise", "SLO_LATENCY_BREACH") in kinds
        assert ("update", "SLO_LATENCY_BREACH") in kinds
        assert body["mutes"]["SLO_LATENCY_BREACH"]["sticky"] is True
        rv, _, _ = await client.command({"prefix": "health unmute", "code": "SLO_LATENCY_BREACH"})
        assert rv == 0
        rv, _, _ = await client.command({"prefix": "health unmute", "code": "SLO_LATENCY_BREACH"})
        assert rv == -2
        rv, _, _ = await client.command({"prefix": "health mute", "code": ""})
        assert rv == -22
        await client.msgr.shutdown()
        await stop_mons(mons)

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_muted_check_survives_election(pkg):
    m = mods(pkg)

    async def run():
        monmap, mons = await start_mons(m, 3)
        for mon in mons:
            mon.conf.set("mon_tick_interval", 0.05)
            mon.pg_digest = _slo_digest("hotpool")
        client = monclient(m, monmap)
        await wait_until(lambda: "SLO_LATENCY_BREACH" in mons[0].logmon.active_checks, 5.0,
                         "SLO check raised")
        rv, rs, _ = await client.command({"prefix": "health mute", "code": "SLO_LATENCY_BREACH"})
        assert rv == 0, rs
        _, _, out = await client.command({"prefix": "health"})
        h = json.loads(out)
        assert h["status"] == "HEALTH_OK" and "SLO_LATENCY_BREACH" in h["muted"]
        await wait_until(lambda: all("SLO_LATENCY_BREACH" in mon.logmon.mutes for mon in mons),
                         3.0, "mute replicated to quorum")
        assert "SLO_LATENCY_BREACH" in mons[0].health_checks()[0]
        await wait_until(lambda: any(e["channel"] == "audit" and "health mute" in e["msg"]
                                     for e in mons[1].logmon.entries), 3.0, "mute audited")
        await mons[0].stop()
        mons[1].elector.start()
        await wait_until(lambda: any(mon.is_leader() for mon in mons[1:]), 5.0, "re-election")
        for mon in mons[1:]:
            assert "SLO_LATENCY_BREACH" in mon.logmon.mutes
        _, _, out = await client.command({"prefix": "health"})
        h = json.loads(out)
        assert "SLO_LATENCY_BREACH" in h["muted"] and "SLO_LATENCY_BREACH" not in h["checks"]
        await client.msgr.shutdown()
        await stop_mons(mons[1:])

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_key_crud_replicates(pkg):
    m = mods(pkg)

    async def run():
        monmap, mons = await start_mons(m, 3)
        client = monclient(m, monmap)
        rv, _, out = await client.command({"prefix": "auth get-or-create",
                                           "entity": "client.admin"})
        assert rv == 0
        created = json.loads(out)
        assert len(base64.b64decode(created["key"])) == 16
        _, _, out = await client.command({"prefix": "auth get-or-create",
                                          "entity": "client.admin"})
        assert json.loads(out)["key"] == created["key"]
        _, _, out = await client.command({"prefix": "auth get", "entity": "client.admin"})
        assert json.loads(out)["key"] == created["key"]
        rv, rs, _ = await client.command({"prefix": "auth add", "entity": "osd.0"})
        assert rv == 0, rs
        rv, _, _ = await client.command({"prefix": "auth add", "entity": "osd.0"})
        assert rv == -17
        _, _, out = await client.command({"prefix": "auth ls"})
        assert set(json.loads(out)) == {"client.admin", "osd.0"}
        await wait_until(lambda: all(
            mon.authmon.keyring.dumps() == mons[0].authmon.keyring.dumps()
            and len(mon.authmon.keyring) == 2 for mon in mons), 3.0, "keyrings converge")
        rv, _, _ = await client.command({"prefix": "auth del", "entity": "osd.0"})
        assert rv == 0
        rv, _, _ = await client.command({"prefix": "auth get", "entity": "osd.0"})
        assert rv == -2
        await client.msgr.shutdown()
        await stop_mons(mons)

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_osd_pool_get(pkg, tmp_path):
    async def run():
        c = cluster(pkg, 1, 3, [dict(name="gp", kind="rep", size=2, pg_num=4)], tmp_path)
        try:
            await c.start()
            _, _, out = await c.command({"prefix": "osd pool get", "pool": "gp", "var": "size"})
            assert json.loads(out) == {"size": 2}
            _, _, out = await c.command({"prefix": "osd pool get", "pool": "gp"})
            allinfo = json.loads(out)
            assert allinfo["pg_num"] > 0 and allinfo["quota_max_objects"] == 0
            rv, _, _ = await c.monc.command({"prefix": "osd pool get", "pool": "gp",
                                             "var": "bogus"})
            assert rv != 0
            rv, _, _ = await c.monc.command({"prefix": "osd pool get", "pool": "nope"})
            assert rv != 0
        finally:
            await c.stop()

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_pool_application_and_health(pkg, tmp_path):
    async def run():
        c = cluster(pkg, 1, 3, [dict(name="appp", kind="rep", size=2, pg_num=4)], tmp_path)
        try:
            await c.start()
            await c.command({"prefix": "osd pool application enable", "pool": "appp",
                             "app": "rbd"})
            _, _, out = await c.command({"prefix": "osd pool application get", "pool": "appp"})
            assert json.loads(out) == {"application": "rbd"}
            rv, _, _ = await c.monc.command({"prefix": "osd pool application enable",
                                             "pool": "appp", "app": "rgw"})
            assert rv != 0

            def tagged():
                p = c.client.osdmap.get_pool("appp")
                return p is not None and p.application == "rbd"

            await wait_until(tagged, 5.0, "application tag in the client's map")
            _, _, out = await c.command({"prefix": "health"})
            assert json.loads(out)["status"] in ("HEALTH_OK", "HEALTH_WARN")
        finally:
            await c.stop()

    asyncio.run(run())


def test_option_names_match_the_reference():
    from ceph_tpu.common.options import OPTIONS as REF

    from ceph_tpu_torch.common.options import OPTIONS

    assert set(OPTIONS) - set(REF) == {"osd_deep_scrub_interval"}
    assert set(REF) <= set(OPTIONS)
    for name, opt in REF.items():
        ours = OPTIONS[name]
        assert (ours.type, ours.default, ours.level.value, ours.runtime, ours.see_also) == (
            opt.type, opt.default, opt.level.value, opt.runtime, opt.see_also), name


@pytest.mark.parametrize("pkg", PKGS)
def test_config_set_of_the_port_only_option(pkg):
    """`osd_deep_scrub_interval` is in the port's table only: its
    `config set` succeeds in the port and is refused by the reference."""
    m = mods(pkg)

    async def run():
        monmap, mons = await start_mons(m, 1)
        client = monclient(m, monmap)
        rv, rs, _ = await client.command({"prefix": "config set", "who": "osd",
                                          "name": "osd_deep_scrub_interval", "value": "2"})
        assert (rv == 0) == (pkg == "torch"), rs
        await client.msgr.shutdown()
        await stop_mons(mons)

    asyncio.run(run())
