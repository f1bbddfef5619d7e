"""The daemon's own machinery, in the port and in the JAX package, on the
CPU: the recovery-storm controller's waves on an out, a hedged read that
beats a shard the `ec.sub_read` delay mode slows, and the admin socket's
dumps (their keys equal the reference's).

Each test runs a cluster of each package (`torch_daemon_host`, daemons on
MemStores over `inproc`, cephx on).  The hedge case depends on time by
nature: the slow shard answers 1.5 s late and the hedge fires after the
10 ms floor, so the read must come back well inside the delay."""

import asyncio
import time

import pytest

from test_torch_ec_backend import _pin_reference  # noqa: F401 (autouse)
from test_torch_osd import daemon_conf, make_cluster, settle
from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

PKGS = ("jax", "torch")
EC = [dict(name="ec", kind="ec", k=4, m=2, pg_num=8, stripe_unit=4096)]


def data(n, seed):
    return bytes((i * 131 + seed) % 251 for i in range(n))


def test_recovery_storm_waves_on_an_out(tmp_path):
    """osd.3 stopped, down and out with 24 objects on RS(4,2) over 7
    daemons: the primaries' storm controllers engage and rebuild in waves
    (`recovery_wave` flight records), and every store ends as the
    reference's."""
    victim = 3

    def conf(pkg):
        return {**daemon_conf(pkg), "osd_recovery_storm_min_objects": 2,
                "osd_recovery_storm_wave_objects": 4}

    async def body(pkg, c):
        cl = c.client
        for i in range(24):
            rep = await cl.op("ec", f"o{i}", [cl.osd_op("WRITEFULL", data=data(16384, i))])
            assert rep.result == 0
        fr = c.m.osd.__name__.rsplit(".", 2)[0]
        flight = __import__(f"{fr}.ops.flight_recorder", fromlist=["flight_recorder"])
        flight.flight_recorder().reset()
        await c.stop_osd(victim)
        c.mon.mark_down(victim)
        c.mon.mark_out(victim)
        await c.wait_clean(30)
        await settle(c)
        waves = sum(o.recovery_storm.perf_dump()["waves"] for o in c.running())
        kinds = [r["kind"] for r in flight.flight_recorder().dump()["records"]]
        reads = [bytes((await cl.op("ec", f"o{i}", [cl.osd_op("READ", off=0, len=0)]))
                       .outdata[0]) for i in range(24)]
        return {"waves": waves, "wave_records": kinds.count("recovery_wave"),
                "reads": reads, "stores": c.stores()}

    got = {pkg: asyncio.run(_run_one(pkg, tmp_path, body, pools=EC, n_osds=7, conf=conf(pkg)))
           for pkg in PKGS}
    for pkg in PKGS:
        assert got[pkg]["waves"] > 0 and got[pkg]["wave_records"] > 0, pkg
        assert got[pkg]["reads"] == [data(16384, i) for i in range(24)]
    assert got["torch"]["stores"] == got["jax"]["stores"]


async def _run_one(pkg, tmp_path, body, **kw):
    c = make_cluster(pkg, tmp_path, **kw)
    try:
        await c.start(30)
        return await body(pkg, c)
    finally:
        await c.stop()


def test_hedged_read_beats_a_delayed_shard(tmp_path):
    """`ec.sub_read` armed on one daemon through its admin socket in delay
    mode (1.5 s): a read whose plan includes that daemon's shard hedges
    to a spare shard after the 10 ms floor and completes long before the
    slow reply, in both packages, with the same bytes."""

    def conf(pkg):
        return {**daemon_conf(pkg), "osd_ec_hedge_quantile": 3.0,
                "osd_ec_hedge_min_ms": 10.0}

    async def body(pkg, c):
        cl = c.client
        payload = data(65536, 5)
        assert (await cl.op("ec", "hot", [cl.osd_op("WRITEFULL", data=payload)])).result == 0
        pgid, primary = cl.target("ec", "hot")
        acting = c.mon.osdmap.pg_to_up_acting_osds(pgid.pool, pgid.ps)[2]
        slow = next(o for o in acting[:4] if o != primary)
        await c.asok(slow, "injectargs", point="ec.sub_read", delay_ms=1500.0,
                     who=f"osd.{slow}")
        t0 = time.monotonic()
        rep = await cl.op("ec", "hot", [cl.osd_op("READ", off=0, len=0)])
        took = time.monotonic() - t0
        await c.asok(slow, "injectargs", clear=True)
        perf = c.osds[primary].perf
        return {"data": bytes(rep.outdata[0]), "took": took,
                "hedges": perf.get("ec_hedge_reads"), "wins": perf.get("ec_hedge_wins")}

    got = {pkg: asyncio.run(_run_one(pkg, tmp_path, body, pools=EC, conf=conf(pkg),
                                     admin_sockets=True)) for pkg in PKGS}
    for pkg in PKGS:
        g = got[pkg]
        assert g["data"] == data(65536, 5)
        assert g["took"] < 1.0 and g["hedges"] >= 1 and g["wins"] >= 1, (pkg, g)


ASOK = ["perf dump", "dump_flight", "dump_mempools", "dump_recovery_storm",
        "dump_historic_ops", "dump_historic_slow_ops", "dump_ops_in_flight",
        "dump_blocked_ops", "dump_tracer", "dump_io_accounting", "dump_histograms",
        "config diff"]


def _shape(v, depth=2):
    """The keys of a dump, nested `depth` deep (dicts only)."""
    if isinstance(v, dict) and depth:
        return {k: _shape(x, depth - 1) for k, x in v.items()}
    return type(v).__name__ if not isinstance(v, (int, float)) else "number"


def test_admin_socket_dumps_have_the_reference_keys(tmp_path):
    async def body(pkg, c):
        cl = c.client
        for i in range(3):
            await cl.op("ec", f"o{i}", [cl.osd_op("WRITEFULL", data=data(8192, i))])
            await cl.op("ec", f"o{i}", [cl.osd_op("READ", off=0, len=0)])
        out = {}
        pgid, primary = cl.target("ec", "o0")
        for prefix in ASOK:
            out[prefix] = await c.asok(primary, prefix)
        out["injectargs"] = await c.asok(primary, "injectargs", conf={"osd_op_complaint_time": 31})
        out["list_unfound"] = await c.asok(primary, "list_unfound", pool=pgid.pool, ps=pgid.ps)
        status = c.status(primary)
        records = out["dump_flight"].get("records") or []
        return {
            "keys": {p: sorted(v) if isinstance(v, dict) else type(v).__name__
                     for p, v in out.items()},
            "flight_record_keys": sorted(records[0]) if records else [],
            "status": _shape(status, 1),
            "tpu_backend": sorted(status["tpu_backend"]),
            "fallback": status["tpu_backend"]["fallback_launches"],
            "mempools": sorted(out["dump_mempools"]),
            "storm": _shape(out["dump_recovery_storm"], 2),
        }

    got = {pkg: asyncio.run(_run_one(pkg, tmp_path, body, pools=EC, admin_sockets=True))
           for pkg in PKGS}
    ours, ref = got["torch"], got["jax"]
    assert ours["keys"] == ref["keys"]
    assert ours["flight_record_keys"] and ours["flight_record_keys"] == ref["flight_record_keys"]
    # the port's status blob adds one key, its MonClient's hunts and the
    # passes that found no monitor (ROADMAP C18)
    assert ours["status"] == {**ref["status"], "monclient": "dict"}
    assert ours["tpu_backend"] == ref["tpu_backend"]
    assert ours["mempools"] == ref["mempools"]
    assert ours["storm"] == ref["storm"]
    assert ours["fallback"] == 0
