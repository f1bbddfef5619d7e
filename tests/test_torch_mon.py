"""The port's monitor (`ceph_tpu_torch/mon/`) against the JAX package's, on
the CPU.

The reference's monitor cases (`tests/test_mon.py`: elections, Paxos
replication, EC profile commands, pool create, subscriptions, the failure
quorum, the admin socket, health, a restarted monitor's catch-up) run on
each package, over the `inproc` messenger stack; the cases with OSD
daemons use `torch_daemon_host.DaemonCluster(mons=N)`.  Two
differentials hold the port to the reference's bytes:

- (a) Paxos and the elector of three monitors on a seeded in-process
  transport that delivers the queued messages in a seeded order (each
  sender-to-receiver link in order, as a connection keeps it): an
  election, proposals, a peon cut off, a fresh peon and a second
  election.  Every message sent (sender, receiver, bytes) and every
  committed value must match.  The lease is the port's and is driven by
  the monitor's tick, which this transport never runs.
- (b) A single-monitor quorum fed a seeded script of commands, boots and
  failure reports: every reply (retval, rs, outbl) and every committed
  osdmap value (an encoded `Incremental`) must match.  `status` is
  compared without its log tail (the entries carry wall-clock stamps)
  and the cluster-log service's commits are not compared for the same
  reason.  The tick is held off (`mon_tick_interval` 3600 s) so no
  timer commits.  `config set` of `osd_deep_scrub_interval`, an option
  only the port's table has, is left out of the script.
"""

import asyncio
import importlib
import json
import uuid
from types import SimpleNamespace

import numpy as np
import pytest

from torch_daemon_host import DaemonCluster, wait_until

ROOT = {"jax": "ceph_tpu", "torch": "ceph_tpu_torch"}
PKGS = ["jax", "torch"]


def mods(pkg: str) -> SimpleNamespace:
    root = ROOT[pkg]

    def imp(name):
        return importlib.import_module(f"{root}.{name}")

    return SimpleNamespace(
        pkg=pkg, root=root, mon=imp("mon"), monitor=imp("mon.monitor"),
        client=imp("mon.client"), messages=imp("msg.messages"), osdmap=imp("osd.osdmap"),
        elector=imp("mon.elector"), paxos=imp("mon.paxos"), config=imp("common.config"),
        admin_socket=imp("common.admin_socket"),
    )


def inproc_addrs(n: int) -> dict:
    tag = uuid.uuid4().hex[:8]
    return {chr(ord("a") + i): f"inproc:mon-{tag}-{chr(ord('a') + i)}" for i in range(n)}


def make_mon(m, name, monmap, timeout=0.3, conf=None, **kw):
    if m.pkg == "torch":
        kw.setdefault("device", "cpu")
    if conf is not None:
        kw["conf"] = m.config.Config({"name": f"mon.{name}", **conf}, env=False)
    return m.mon.Monitor(name, monmap, election_timeout=timeout, stack="inproc", **kw)


async def start_mons(m, n, timeout=0.3, conf=None):
    monmap = m.mon.MonMap(addrs=inproc_addrs(n))
    mons = [make_mon(m, name, monmap, timeout, conf) for name in monmap.ranks]
    for mon in mons:
        await mon.start()
    for mon in mons:
        await mon.wait_for_quorum()
    return monmap, mons


async def stop_mons(mons):
    for mon in mons:
        await mon.stop()
    await asyncio.sleep(0.05)


def monclient(m, monmap, name="client.test"):
    return m.client.MonClient(name, monmap, stack="inproc")


# -- the reference's cases, on each package -----------------------------------------


@pytest.mark.parametrize("pkg", PKGS)
def test_bootstrap_and_commands(pkg):
    m = mods(pkg)

    async def run():
        monmap, mons = await start_mons(m, 1)
        mon = mons[0]
        assert mon.is_leader()
        client = monclient(m, monmap)
        rv, rs, _ = await client.command({"prefix": "osd erasure-code-profile set",
                                          "name": "p42", "profile": ["k=4", "m=2", "plugin=tpu"]})
        assert rv == 0, rs
        rv, _, out = await client.command({"prefix": "osd erasure-code-profile get", "name": "p42"})
        assert rv == 0
        prof = json.loads(out)
        assert prof["k"] == "4" and prof["m"] == "2"
        rv, _, out = await client.command({"prefix": "osd erasure-code-profile ls"})
        assert "p42" in json.loads(out)
        rv, rs, _ = await client.command({"prefix": "osd pool create", "pool": "ecpool",
                                          "pool_type": "erasure", "erasure_code_profile": "p42"})
        assert rv == 0, rs
        rv, _, out = await client.command({"prefix": "osd dump"})
        dump = json.loads(out)
        pool = next(p for p in dump["pools"].values() if p["name"] == "ecpool")
        assert pool["size"] == 6
        assert pool["stripe_width"] == 4 * 4096
        rv, rs, _ = await client.command({"prefix": "osd erasure-code-profile rm", "name": "p42"})
        assert rv < 0 and "in use" in rs
        await client.msgr.shutdown()
        await stop_mons(mons)

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_bad_profile_rejected(pkg):
    m = mods(pkg)

    async def run():
        monmap, mons = await start_mons(m, 1)
        client = monclient(m, monmap)
        rv, rs, _ = await client.command({"prefix": "osd erasure-code-profile set",
                                          "name": "bad", "profile": ["k=0", "m=2"]})
        assert rv < 0
        await client.msgr.shutdown()
        await stop_mons(mons)

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_osd_boot_and_subscription(pkg):
    m = mods(pkg)

    async def run():
        monmap, mons = await start_mons(m, 1)
        mon = mons[0]
        client = monclient(m, monmap, "osd.0")
        maps = []
        client.on_osdmap = maps.append
        await client.subscribe("osdmap", 0)
        await wait_until(lambda: maps, 5.0, "the initial map")
        for osd in range(3):
            await client.msgr.send_to(monmap.addr_of_rank(0), m.messages.MOSDBoot(
                osd=osd, addr=f"127.0.0.1:{7000 + osd}", epoch=0))
        await wait_until(lambda: mon.osdmon.osdmap.num_up_osds() == 3, 5.0, "3 OSDs up")
        await wait_until(lambda: len(maps) >= 2 and (
            max(maps[-1].maps or {0: 0}) == mon.osdmon.osdmap.epoch
            or max(maps[-1].incrementals or {0: 0}) == mon.osdmon.osdmap.epoch),
            5.0, "the subscriber's new epochs")
        last = maps[-1]
        if last.maps:
            decoded = m.osdmap.OSDMap.frombytes(last.maps[max(last.maps)])
            assert decoded.epoch == mon.osdmon.osdmap.epoch
        await client.msgr.shutdown()
        await stop_mons(mons)

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_election_and_replication(pkg):
    m = mods(pkg)

    async def run():
        monmap, mons = await start_mons(m, 3)
        leader = [mon for mon in mons if mon.is_leader()]
        assert len(leader) == 1
        assert leader[0].rank == 0  # lowest rank wins
        client = monclient(m, monmap)
        rv, rs, _ = await client.command({"prefix": "osd erasure-code-profile set",
                                          "name": "rep3", "profile": ["k=2", "m=1"]})
        assert rv == 0, rs
        await wait_until(lambda: all("rep3" in mon.osdmon.osdmap.erasure_code_profiles
                                     for mon in mons), 5.0, "the profile on every monitor")
        await client.msgr.shutdown()
        await stop_mons(mons)

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_leader_failover(pkg):
    m = mods(pkg)

    async def run():
        monmap, mons = await start_mons(m, 3, timeout=0.2)
        assert mons[0].is_leader()
        client = monclient(m, monmap)
        rv, _, _ = await client.command({"prefix": "osd erasure-code-profile set",
                                         "name": "before", "profile": ["k=2", "m=1"]})
        assert rv == 0
        await wait_until(lambda: all("before" in mon.osdmon.osdmap.erasure_code_profiles
                                     for mon in mons), 5.0, "the profile everywhere")
        # the leader dies; survivors elect rank 1 (called by hand, as the
        # reference's case does)
        await mons[0].stop()
        mons[1].elector.start()
        await wait_until(lambda: mons[1].is_leader() and len(mons[1].quorum) == 2, 5.0,
                         "rank 1 leading")
        client._cur_rank = 1
        rv, _, out = await client.command({"prefix": "osd erasure-code-profile ls"})
        assert rv == 0 and "before" in json.loads(out)
        rv, rs, _ = await client.command({"prefix": "osd erasure-code-profile set",
                                          "name": "after", "profile": ["k=3", "m=2"]})
        assert rv == 0, rs
        await wait_until(lambda: "after" in mons[2].osdmon.osdmap.erasure_code_profiles,
                         5.0, "the new profile on rank 2")
        await client.msgr.shutdown()
        await stop_mons(mons[1:])

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_failure_report_quorum(pkg):
    m = mods(pkg)

    async def run():
        monmap, mons = await start_mons(m, 1)
        mon = mons[0]
        client = monclient(m, monmap, "osd.9")
        for osd in range(3):
            await client.msgr.send_to(monmap.addr_of_rank(0), m.messages.MOSDBoot(
                osd=osd, addr=f"127.0.0.1:{7100 + osd}", epoch=0))
        await wait_until(lambda: mon.osdmon.osdmap.num_up_osds() == 3, 5.0, "3 OSDs up")
        fail = m.messages.MOSDFailure(target=2, target_addr="", failed_for=25.0, epoch=0)
        fail.src = "osd.0"
        mon.osdmon.prepare_failure(fail, reporter="osd.0")
        await asyncio.sleep(0.05)
        assert mon.osdmon.osdmap.is_up(2)  # one reporter is not enough
        mon.osdmon.prepare_failure(fail, reporter="osd.1")
        await wait_until(lambda: not mon.osdmon.osdmap.is_up(2), 5.0, "osd.2 down")
        await client.msgr.shutdown()
        await stop_mons(mons)

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_status_and_paxos_dumps(pkg, tmp_path):
    m = mods(pkg)

    async def run():
        admin_command = m.admin_socket.admin_command
        monmap = m.mon.MonMap(addrs=inproc_addrs(3))
        path = str(tmp_path / "mon.a.asok")
        mons = [make_mon(m, name, monmap, admin_socket=path if i == 0 else "")
                for i, name in enumerate(monmap.ranks)]
        for mon in mons:
            await mon.start()
        for mon in mons:
            await mon.wait_for_quorum()
        loop = asyncio.get_running_loop()
        deadline = loop.time() + 8.0
        while True:
            st = await loop.run_in_executor(None, lambda: admin_command(path, "mon_status"))
            if st["state"] in ("leader", "peon") and st["quorum"] == [0, 1, 2]:
                break
            assert loop.time() < deadline, f"mon never settled: {st}"
            await asyncio.sleep(0.05)
        assert st["name"] == mons[0].name
        assert st["rank"] in st["quorum"]
        q = await loop.run_in_executor(None, lambda: admin_command(path, "quorum_status"))
        assert q["leader"] is not None and q["quorum"] == [0, 1, 2]
        assert q["epoch"] >= 1
        p = await loop.run_in_executor(None, lambda: admin_command(path, "paxosinfo"))
        assert p["last_committed"] >= 0
        for mon in mons:
            await mon.stop()

    asyncio.run(run())


POOL_REP = [dict(name="rp", kind="rep", size=2, pg_num=4)]
FAST_OSD = {"osd_heartbeat_interval": 0.1, "osd_heartbeat_grace": 0.6}


def cluster(pkg, n_osds, pools, tmp_path, **kw):
    d = tmp_path / pkg
    d.mkdir(exist_ok=True)
    kw.setdefault("conf", dict(FAST_OSD))
    return DaemonCluster(ROOT[pkg], n_osds, pools, device="cpu" if pkg == "torch" else None,
                         root_dir=str(d), election_timeout=0.3, **kw)


@pytest.mark.parametrize("pkg", PKGS)
def test_health_summary_reflects_down_osds(pkg, tmp_path):
    async def run():
        c = cluster(pkg, 3, POOL_REP, tmp_path, mons=1)
        try:
            await c.start()
            _, _, out = await c.command({"prefix": "status"})
            st = json.loads(out.decode())
            assert st["health"]["status"] == "HEALTH_OK"
            assert st["quorum"] == [0]
            await c.stop_osd(2)
            await wait_until(lambda: not c.osdmap.is_up(2), 8.0, "osd.2 marked down")
            _, _, out = await c.command({"prefix": "status"})
            st = json.loads(out.decode())
            assert st["health"]["status"] == "HEALTH_WARN"
            assert "osd.2" in st["health"]["checks"]["OSD_DOWN"]
        finally:
            await c.stop()

    asyncio.run(run())


@pytest.mark.parametrize("pkg", PKGS)
def test_restarted_mon_catches_up_via_paxos(pkg, tmp_path):
    """A peon restarting with an empty store rejoins and catches up every
    committed version from its peers (collect / LAST / COMMIT)."""

    async def run():
        c = cluster(pkg, 2, [], tmp_path, mons=3)

        async def pool_create(name):
            await c.command({"prefix": "osd pool create", "pool": name,
                             "pool_type": "replicated", "size": 2, "pg_num": 4})

        try:
            await c.start()
            await pool_create("before")
            victim = next(mon for mon in c.monitors if not mon.is_leader())
            await c.stop_mon(victim.name)
            await pool_create("while-down")
            revived = await c.restart_mon(victim.name)
            await revived.wait_for_quorum()
            await wait_until(lambda: revived.osdmon.osdmap.get_pool("while-down") is not None,
                             10.0, "the revived monitor catching up")
            assert revived.osdmon.osdmap.get_pool("before") is not None
            await pool_create("after")
            await wait_until(lambda: revived.osdmon.osdmap.get_pool("after") is not None,
                             10.0, "the revived monitor applying new commits")
        finally:
            await c.stop()

    asyncio.run(run())


# -- (a) Paxos and the elector on a seeded transport ---------------------------------


class SeededQuorum:
    """Electors and Paxos instances of one package, wired through a queue
    of encoded messages that `deliver` drains in a seeded order."""

    def __init__(self, m, n: int, seed: int):
        self.m = m
        self.n = n
        self.rng = np.random.default_rng(seed)
        self.queue: list = []
        self.trace: list = []
        self.commits: list = []
        self.cut: set[int] = set()
        self.electors = [None] * n
        self.paxos = [None] * n
        for r in range(n):
            self.fresh(r)

    def fresh(self, r: int) -> None:
        """(Re)build rank r with an empty store."""
        m = self.m
        if self.electors[r] is not None:
            self.electors[r].cancel()

        def send(dst, msg, src=r):
            self.queue.append((src, dst, msg))

        def on_commit(v, value, rank=r):
            self.commits.append((rank, v, bytes(value)))

        paxos = m.paxos.Paxos(r, send, on_commit)
        elector = m.elector.Elector(
            r, self.n, send,
            on_win=lambda epoch, quorum, p=paxos: p.leader_init(quorum),
            on_lose=lambda epoch, leader, quorum=None, p=paxos: p.peon_init(leader))
        self.electors[r], self.paxos[r] = elector, paxos

    def deliver(self, limit: int | None = None) -> None:
        count = 0
        while self.queue and (limit is None or count < limit):
            # a seeded pick among the queued messages, each link kept in
            # order as a connection keeps it
            src, dst, _ = self.queue[int(self.rng.integers(len(self.queue)))]
            first = next(i for i, (a, b, _) in enumerate(self.queue) if (a, b) == (src, dst))
            src, dst, msg = self.queue.pop(first)
            raw = msg.tobytes()
            self.trace.append((src, dst, type(msg).__name__, raw))
            count += 1
            if src in self.cut or dst in self.cut:
                continue  # lost on the wire
            got = type(msg).frombytes(raw)
            if isinstance(got, self.m.messages.MMonElection):
                self.electors[dst].handle(got)
            else:
                self.paxos[dst].handle(got, src)

    def leader(self) -> int:
        leaders = [r for r in range(self.n) if self.paxos[r].leading
                   and self.electors[r].leader == r and not self.electors[r].electing]
        assert len(leaders) == 1, leaders
        return leaders[0]

    def propose(self, values) -> None:
        for value in values:
            self.paxos[self.leader()].propose(value)
            self.deliver(int(self.rng.integers(0, 5)))
        self.deliver()

    def close(self) -> None:
        for e in self.electors:
            e.cancel()


def run_seeded_quorum(pkg: str, seed: int) -> SeededQuorum:
    m = mods(pkg)
    vrng = np.random.default_rng(seed + 77)

    def values(k):
        return [vrng.integers(0, 256, int(vrng.integers(1, 64)), dtype=np.uint8).tobytes()
                for _ in range(k)]

    async def run():
        q = SeededQuorum(m, 3, seed)
        for e in q.electors:
            e.start()
        q.deliver()
        q.propose(values(6))
        q.cut = {2}  # a peon cut off: the majority still commits
        q.propose(values(4))
        q.deliver()
        q.cut = set()
        q.fresh(2)  # it comes back with an empty store; rank 1 calls an election
        q.electors[2].start()
        q.electors[1].start()
        q.deliver()
        q.propose(values(3))
        q.close()
        await asyncio.sleep(0)
        return q

    return asyncio.run(run())


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_paxos_and_elector_match_the_reference_on_a_seeded_transport(seed):
    ref, ours = run_seeded_quorum("jax", seed), run_seeded_quorum("torch", seed)
    assert len(ours.trace) == len(ref.trace) and len(ref.trace) > 40
    for i, (a, b) in enumerate(zip(ours.trace, ref.trace)):
        assert a == b, f"message {i} differs: {a[:3]} vs {b[:3]}"
    assert ours.commits == ref.commits
    # every monitor ends with the same store, the fresh one caught up
    assert ours.paxos[0].store == ours.paxos[1].store == ours.paxos[2].store
    assert len(ours.paxos[2].store) == 13
    assert [p.store for p in ours.paxos] == [p.store for p in ref.paxos]


# -- (b) one monitor and a seeded script ----------------------------------------------


class FakeConn:
    """A connection that records the monitor's replies."""

    def __init__(self, peer_name: str):
        self.peer_name = peer_name
        self.peer_addr = f"inproc:{peer_name}"
        self.sent: list = []

    async def send_message(self, msg) -> None:
        self.sent.append(msg)


def gen_script(seed: int) -> list:
    """Commands, boots and failure reports as plain data."""
    rng = np.random.default_rng(seed)
    script = []
    osds = [int(x) for x in rng.permutation(6)]
    for o in osds:
        script.append(("boot", o))
    k, mm = int(rng.integers(2, 6)), int(rng.integers(1, 4))
    script += [
        ("cmd", {"prefix": "osd erasure-code-profile set", "name": "p1",
                 "profile": [f"k={k}", f"m={mm}", "plugin=tpu"]}),
        ("cmd", {"prefix": "osd erasure-code-profile set", "name": "bad",
                 "profile": ["k=0", "m=1"]}),
        ("cmd", {"prefix": "osd erasure-code-profile get", "name": "p1"}),
        ("cmd", {"prefix": "osd erasure-code-profile get", "name": "nope"}),
        ("cmd", {"prefix": "osd erasure-code-profile ls"}),
        ("cmd", {"prefix": "osd pool create", "pool": "ec", "pool_type": "erasure",
                 "erasure_code_profile": "p1", "pg_num": int(rng.integers(4, 33)),
                 "allow_ec_overwrites": bool(seed % 2)}),
        ("cmd", {"prefix": "osd pool create", "pool": "rep", "size": int(rng.integers(2, 4)),
                 "pg_num": int(rng.integers(4, 33))}),
        ("cmd", {"prefix": "osd pool create", "pool": "ec2", "pool_type": "erasure",
                 "erasure_code_profile": "missing"}),
        ("cmd", {"prefix": "osd pool ls"}),
        ("cmd", {"prefix": "osd pool get", "pool": "rep", "var": "size"}),
        ("cmd", {"prefix": "osd pool get", "pool": "ec"}),
        ("cmd", {"prefix": "osd pool application enable", "pool": "rep", "app": "rbd"}),
        ("cmd", {"prefix": "osd pool application enable", "pool": "rep", "app": "rgw"}),
        ("cmd", {"prefix": "osd pool application get", "pool": "rep"}),
        ("cmd", {"prefix": "osd blocklist add", "entity": "client.9"}),
        ("cmd", {"prefix": "osd blocklist ls"}),
        ("cmd", {"prefix": "osd pool set-quota", "pool": "rep", "field": "max_objects",
                 "val": int(rng.integers(1, 100))}),
        ("cmd", {"prefix": "osd pool selfmanaged-snap-create", "pool": "rep"}),
        ("cmd", {"prefix": "osd pool create", "pool": "hot", "size": 2, "pg_num": 4}),
        ("cmd", {"prefix": "osd tier add", "pool": "rep", "tierpool": "hot"}),
        ("cmd", {"prefix": "osd tier cache-mode", "pool": "hot", "mode": "writeback"}),
        ("cmd", {"prefix": "osd tier set-overlay", "pool": "rep", "overlaypool": "hot"}),
        ("cmd", {"prefix": "osd tier remove", "pool": "rep", "tierpool": "hot"}),
        ("cmd", {"prefix": "osd tier remove-overlay", "pool": "rep"}),
        ("cmd", {"prefix": "osd tier remove", "pool": "rep", "tierpool": "hot"}),
        ("cmd", {"prefix": "osd pool set", "pool": "rep", "var": "min_size", "val": 1}),
        ("cmd", {"prefix": "osd pool set", "pool": "rep", "var": "pg_num", "val": 8}),
        ("cmd", {"prefix": "osd out", "id": osds[0]}),
        ("cmd", {"prefix": "osd reweight", "id": osds[1], "weight": 0.5}),
        ("cmd", {"prefix": "osd reweight", "id": osds[1], "weight": 1.5}),
        ("fail", osds[2], f"osd.{osds[3]}"),
        ("fail", osds[2], f"osd.{osds[4]}"),
        ("cmd", {"prefix": "osd in", "id": osds[0]}),
        ("cmd", {"prefix": "config set", "who": "osd", "name": "osd_max_backfills",
                 "value": str(int(rng.integers(1, 9)))}),
        ("cmd", {"prefix": "config set", "who": "osd.1", "name": "osd_max_backfills",
                 "value": "2"}),
        ("cmd", {"prefix": "config set", "who": "osd", "name": "osd_max_backfils",
                 "value": "3"}),
        ("cmd", {"prefix": "config get", "who": "osd.1"}),
        ("cmd", {"prefix": "config rm", "who": "osd.1", "name": "osd_max_backfills"}),
        ("cmd", {"prefix": "config dump"}),
        ("cmd", {"prefix": "osd dump"}),
        ("cmd", {"prefix": "health", "detail": True}),
        ("cmd", {"prefix": "status"}),
        ("cmd", {"prefix": "quorum_status"}),
        ("cmd", {"prefix": "df"}),
        ("cmd", {"prefix": "osd blocklist rm", "entity": "client.9"}),
        ("cmd", {"prefix": "osd pool rm", "pool": "hot"}),
        ("cmd", {"prefix": "osd erasure-code-profile rm", "name": "p1"}),
        ("cmd", {"prefix": "no such command"}),
        ("boot", osds[2]),
    ]
    return script


def run_script(pkg: str, seed: int):
    m = mods(pkg)

    async def run():
        monmap = m.mon.MonMap(addrs=inproc_addrs(1))
        mon = make_mon(m, "a", monmap, conf={"mon_tick_interval": 3600.0})
        await mon.start()
        await mon.wait_for_quorum()
        conn = FakeConn("client.admin")
        replies, prefixes = [], {}
        for tid, step in enumerate(gen_script(seed), 1):
            if step[0] == "boot":
                msg = m.messages.MOSDBoot(osd=step[1], addr=f"127.0.0.1:{6800 + step[1]}",
                                          epoch=0)
                mon.ms_dispatch(FakeConn(f"osd.{step[1]}"), msg)
            elif step[0] == "fail":
                msg = m.messages.MOSDFailure(target=step[1], target_addr="", failed_for=20.0,
                                             epoch=0)
                msg.src = step[2]
                mon.ms_dispatch(FakeConn(step[2]), msg)
            else:
                prefixes[tid] = step[1]["prefix"]
                mon.ms_dispatch(conn, m.messages.MMonCommand(tid=tid, cmd=json.dumps(step[1])))
            for _ in range(4):
                await asyncio.sleep(0)
        await asyncio.sleep(0.01)
        for ack in conn.sent:
            outbl = bytes(ack.outbl)
            if prefixes[ack.tid] == "status":
                body = json.loads(outbl)
                body.pop("log")
                outbl = json.dumps(body).encode()
            replies.append((ack.tid, ack.retval, ack.rs, outbl))
        osd_commits = [(v, bytes(val)) for v, val in sorted(mon.paxos.store.items())
                       if bytes(val).startswith(b"osd\x00")]
        await mon.stop()
        return replies, osd_commits, mon.osdmon.osdmap.tobytes()

    return asyncio.run(run())


@pytest.mark.parametrize("seed", [0, 1])
def test_one_monitor_answers_a_seeded_script_as_the_reference(seed):
    ref, ours = run_script("jax", seed), run_script("torch", seed)
    ref_replies, ref_commits, ref_map = ref
    replies, commits, osdmap = ours
    assert len(replies) == len(ref_replies) > 40
    for a, b in zip(replies, ref_replies):
        assert a == b, f"reply to command {a[0]} differs: {a} vs {b}"
    assert len(commits) == len(ref_commits) > 10
    for (v, a), (rv, b) in zip(commits, ref_commits):
        assert (v, a) == (rv, b), f"committed osdmap value v{v} differs"
    assert osdmap == ref_map


@pytest.mark.parametrize("pkg", PKGS)
def test_operator_commands_through_the_monitors(pkg, tmp_path):
    """`DaemonCluster(mons=1)`'s out, in and tier commands reach the map as
    the map service's direct edits did."""

    async def run():
        c = cluster(pkg, 3, [dict(name="base", kind="rep", size=2, pg_num=4),
                             dict(name="hot", kind="rep", size=2, pg_num=4)], tmp_path, mons=1)
        try:
            await c.start()
            await c.mark_out(2)
            assert c.osdmap.osds[2].weight == 0
            await c.mark_in(2)
            assert c.osdmap.osds[2].weight > 0
            await c.set_tier("base", "hot", "writeback", target_max_objects=3)
            base, hot = c.osdmap.get_pool("base"), c.osdmap.get_pool("hot")
            assert (hot.tier_of, base.tiers, hot.cache_mode) == (base.id, [hot.id], "writeback")
            assert (base.read_tier, hot.target_max_objects) == (hot.id, 3)
            await wait_until(lambda: c.client.osdmap.epoch == c.osdmap.epoch, 5.0,
                             "the client's map")
        finally:
            await c.stop()

    asyncio.run(run())
