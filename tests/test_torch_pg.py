"""The port's placement-group layer (`ceph_tpu_torch/osd/pg.py`, peering,
the reservers, the PG log and the replicated backend) against the JAX
package's, on the CPU.

The differential runs the same seeded plan through an in-process cluster
of each package (`torch_pg_host.PgCluster`: 8 OSDs on MemStores, pools EC
RS(4,2) append-only, EC RS(4,2) with `allow_ec_overwrites` and replicated
size 3, each with pg_num 8, a log trimmed past 3 entries so that rejoining
OSDs backfill): client ops (writefull, offset writes, appends, truncates,
removes, reads, stats, xattrs, omap, self-managed snapshots with clone,
rollback, reads at a snap and snap trim, an unknown object class, resends
of earlier ops) interleaved with map changes (an OSD down, up, out and
in, each settled to clean through peering, recovery and backfill), then a
deep scrub of every PG.  It compares every reply, every message (maps,
client ops and cluster messages, by their bytes, in order), each PG's
peering state, info, log, missing sets and backfill cursors after every
phase, every scrub result and every store's objects at the end.  Both
packages are pinned alike: the reference at dispatch width 1, the device
chunk cache and the RMW delta path off (on in the `_with_cache_and_delta`
case), the reference's hedged reads off (the port has none) and the
stalled-push retry off in both (it runs on the host's clock).

The rest are the reference's unit tests of the same modules
(tests/test_backfill.py: reserver, log trim, backfill driver;
tests/test_advice_fixes.py: divergent-log rewind, dup window), run
against each package, and the port's own: `PG(..., device=None)` needs a
GPU, the paths it does not port answer -EOPNOTSUPP, a failed launch
fails the op with EIO, and where the reference's EC rebuild has too few
sources after an out (ROADMAP C13) the port's rebuilds."""

import asyncio
import importlib
from types import SimpleNamespace

import numpy as np
import pytest

from ceph_tpu.common.encoding import encode_kv_map

from test_torch_ec_backend import _pin_reference, set_cache_and_delta  # noqa: F401 (autouse)
from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)
from torch_pg_host import PgCluster

PKGS = ("jax", "torch")
ROOT = {"jax": "ceph_tpu", "torch": "ceph_tpu_torch"}
DEVICE = {"jax": None, "torch": "cpu"}

N_OSDS = 8
SU = 4096
SW = 4 * SU
POOLS = [
    dict(name="ec", kind="ec", k=4, m=2, pg_num=8, stripe_unit=SU),
    dict(name="ecow", kind="ec", k=4, m=2, pg_num=8, stripe_unit=SU, overwrites=True),
    dict(name="rep", kind="rep", size=3, pg_num=8),
]
OBJECTS = [f"obj{i}" for i in range(6)]


def imp(pkg, name):
    return importlib.import_module(f"{ROOT[pkg]}.{name}")


def conf_for(pkg: str) -> dict:
    conf = {
        "osd_recovery_push_retry_sec": 0,
        "osd_min_pg_log_entries": 1,
        "osd_max_pg_log_entries": 3,
        "osd_backfill_scan_max": 2,
    }
    if pkg == "jax":
        conf["osd_ec_hedge_quantile"] = 0
    return conf


# -- the seeded plan ------------------------------------------------------------------


def gen_op(rng, snaps: dict, n_ops: int):
    """One step of a batch as plain data: ("op", pool, oid, [(code,
    kwargs)], snap_id), ("snap", pool) (a new self-managed snap) or
    ("resend", j) (op j again, with its tid)."""
    pool = POOLS[int(rng.integers(0, len(POOLS)))]["name"]
    oid = OBJECTS[int(rng.integers(0, len(OBJECTS)))]

    def data(n):
        return rng.integers(0, 256, size=int(n), dtype=np.uint8).tobytes()

    kind = rng.choice([
        "writefull", "writefull", "write", "append", "truncate", "delete", "read", "read",
        "stat", "xattr", "compound", "snap", "rollback", "read_snap", "trim", "omap", "call",
        "resend",
    ])
    ops, snap_id = [], 0
    if kind == "writefull":
        ops = [("WRITEFULL", {"data": data(rng.integers(0, 2 * SW + 700))})]
    elif kind == "write":
        ops = [("WRITE", {"off": int(rng.integers(0, 2 * SW)), "data": data(rng.integers(1, SW))})]
    elif kind == "append":
        ops = [("APPEND", {"data": data(rng.integers(1, SW + 300))})]
    elif kind == "truncate":
        ops = [("TRUNCATE", {"off": int(rng.integers(0, 2 * SW))})]
    elif kind == "delete":
        ops = [("DELETE", {})]
    elif kind == "read":
        ops = [("READ", {"off": int(rng.integers(0, SW)), "len": int(rng.integers(0, 2 * SW))})]
    elif kind == "stat":
        ops = [("STAT", {}), ("GETXATTR", {"name": "color"})]
    elif kind == "xattr":
        ops = [("SETXATTR", {"name": "color", "data": data(rng.integers(1, 40))})]
    elif kind == "compound":
        ops = [("SETXATTR", {"name": "tag", "data": b"t"}),
               ("WRITE", {"off": 0, "data": data(rng.integers(1, 3000))}),
               ("CMPXATTR", {"name": "tag", "data": b"t", "off": 1})]
    elif kind == "snap":
        return ("snap", pool)
    elif kind in ("rollback", "read_snap", "trim"):
        if not snaps.get(pool):
            return gen_op(rng, snaps, n_ops)
        snap = int(rng.choice(snaps[pool]))
        if kind == "rollback":
            ops = [("ROLLBACK", {"off": snap})]
        elif kind == "read_snap":
            ops, snap_id = [("READ", {"off": 0, "len": 0})], snap
        else:
            ops, snap_id = [("DELETE", {})], snap
    elif kind == "omap":
        if rng.integers(0, 2):
            ops = [("OMAPSETVALS", {"data": encode_kv_map({f"k{int(rng.integers(0, 4))}":
                                                          data(rng.integers(1, 20))})})]
        else:
            ops = [("OMAPGETVALS", {})]
    elif kind == "call":
        ops = [("CALL", {"name": "nosuch.method", "data": b"in"})]
    else:  # resend an earlier op with its tid (a client resend after a lost reply)
        if not n_ops:
            return gen_op(rng, snaps, n_ops)
        return ("resend", int(rng.integers(0, n_ops)))
    return ("op", pool, oid, ops, snap_id)


def make_plan(seed: int) -> list:
    rng = np.random.default_rng(seed)
    a, b = (int(x) for x in rng.choice(N_OSDS, size=2, replace=False))
    steps, snaps, op_keys = [], {}, []
    for change in (None, ("mark_down", a), ("mark_up", a), ("mark_out", b), ("mark_in", b)):
        if change is not None:
            steps.append(("map",) + change)
        for _batch in range(6):
            batch, oids = [], set()
            for _ in range(int(rng.integers(1, 5))):
                op = gen_op(rng, snaps, len(op_keys))
                if op[0] == "snap":
                    snaps.setdefault(op[1], []).insert(0, len(snaps.get(op[1], [])) + 1)
                    batch.append(op)
                    continue
                # ops in flight together touch distinct objects (a pipelined
                # RMW of one object is where the two packages differ: C5)
                key = op[1:3] if op[0] == "op" else op_keys[op[1]]
                if key in oids:
                    continue
                oids.add(key)
                batch.append(op)
                if op[0] == "op":
                    op_keys.append(key)
            steps.append(("batch", batch))
    steps.append(("scrub",))
    return steps


async def run_plan(pkg: str, seed: int) -> dict:
    c = PgCluster(ROOT[pkg], N_OSDS, POOLS, conf=conf_for(pkg), device=DEVICE[pkg])
    await c.settle()
    snapc: dict[str, tuple[int, list[int]]] = {}
    sent_ops: list = []  # op index -> (pool, oid, ops, snap_id, snapc, tid)
    states, scrubs = [], []
    for step in make_plan(seed):
        if step[0] == "map":
            getattr(c, step[1])(step[2])
            await c.settle()
            states.append(c.pg_states())
        elif step[0] == "batch":
            for op in step[1]:
                if op[0] == "snap":
                    seq, snaps = snapc.get(op[1], (0, []))
                    snapc[op[1]] = (seq + 1, [seq + 1] + snaps)
                    continue
                if op[0] == "resend":
                    pool, oid, ops, snap_id, sc, tid = sent_ops[op[1]]
                else:
                    _, pool, oid, ops, snap_id = op
                    sc, tid = snapc.get(pool, (0, [])), None
                built = [c.osd_op(code, **kw) for code, kw in ops]
                c.op(pool, oid, built, snap_id=snap_id, snapc=sc, tid=tid)
                if op[0] == "op":
                    sent_ops.append((pool, oid, ops, snap_id, sc, c.tid))
            await c.pump()
        else:
            await c.settle()
            for pg in list(c.primaries()):
                out = []
                assert pg.scrub(deep=True, on_done=out.append)
                await c.pump()
                assert len(out) == 1, pg.pgid
                r = out[0]
                scrubs.append((repr(pg.pgid), r.deep, r.objects_scrubbed, r.errors,
                               r.inconsistent, r.repaired, r.aborted, sorted(r.unrepairable)))
    await c.settle()
    states.append(c.pg_states())
    return {
        "sent": c.sent,
        "replies": c.replies,
        "dropped": c.dropped,
        "states": states,
        "scrubs": scrubs,
        "stores": c.stores(),
        "clog": [h.clog for h in c.hosts],
        "ops": len(sent_ops),
    }


def differential(seed: int) -> dict:
    got = {pkg: asyncio.run(run_plan(pkg, seed)) for pkg in PKGS}
    j, t = got["jax"], got["torch"]
    assert t["ops"] == j["ops"] > 20
    assert len(t["sent"]) == len(j["sent"])
    for n, (a, b) in enumerate(zip(t["sent"], j["sent"])):
        assert a == b, f"message {n} differs: {a[:3]} vs {b[:3]}"
    assert t["replies"] == j["replies"]
    assert t["dropped"] == j["dropped"]
    for a, b in zip(t["states"], j["states"]):
        assert a == b
    assert len(t["states"]) == len(j["states"]) == 5
    assert t["scrubs"] == j["scrubs"]
    # No scrub aborts.  The inconsistencies the scrubs find are ROADMAP
    # C11, the reference's and reproduced: a PG that rejoins an OSD with
    # an empty log trusts the stale objects in that OSD's store.
    assert not any(s[6] for s in t["scrubs"]), t["scrubs"]
    assert t["stores"] == j["stores"]
    assert t["clog"] == j["clog"]
    # the plan reached the snap machinery (clones in the stores) and the
    # scrubs saw objects
    assert any("@" in oid for store in t["stores"] for objs in store.values() for oid in objs)
    assert sum(s[2] for s in t["scrubs"]) > 0
    return t


@pytest.mark.parametrize("seed", [0, 1])
def test_pg_differential(seed):
    t = differential(seed)
    kinds = {name for _src, _dst, name, _blob in t["sent"]}
    # the plan reaches peering, both backends' writes and recovery
    assert {"MOSDMap", "MOSDOp", "MOSDPGQuery", "MOSDPGNotify", "MOSDPGLog",
            "MOSDECSubOpWrite", "MOSDRepOp", "MOSDPGPush"} <= kinds, kinds


def test_pg_differential_with_cache_and_delta():
    set_cache_and_delta(True)
    differential(2)


def test_pg_differential_reaches_backfill():
    """A seed whose out/in remaps PGs past the trimmed log: the new
    members backfill under the reservers."""
    t = differential(3)
    kinds = {name for _src, _dst, name, _blob in t["sent"]}
    assert "MBackfillReserve" in kinds, kinds


# -- the reference's unit tests, against each package ----------------------------------


class FakeOsd:
    """The minimal host of tests/test_backfill.py."""

    def __init__(self, pkg, conf=None):
        m = SimpleNamespace(config=imp(pkg, "common.config"), reserver=imp(pkg, "osd.reserver"),
                            perf=imp(pkg, "common.perf_counters"), memstore=imp(pkg, "os.memstore"))
        self.whoami = 0
        self.store = m.memstore.MemStore()
        self.store.mount()
        self.conf = m.config.Config(conf or {"osd_backfill_scan_max": 4}, env=False)
        self.local_reserver = m.reserver.Reserver(lambda: self.conf.get("osd_max_backfills"))
        self.remote_reserver = m.reserver.Reserver(lambda: self.conf.get("osd_max_backfills"))
        b = m.perf.PerfCountersBuilder("osd.0")
        b.add_u64_counter("backfill_pushes")
        self.perf = b.create_perf_counters()
        self.sent = []

    def send_cluster(self, osd, msg):
        self.sent.append((osd, msg))

    def clog_error(self, msg):
        pass


def make_pg(pkg, osd, pool, profiles=None, **kw):
    if pkg == "torch":
        kw.setdefault("device", "cpu")
    return imp(pkg, "osd.pg").PG(osd, pool, 0, profiles or {}, **kw)


def backfilling_pg(pkg, n_objects=10):
    Transaction = imp(pkg, "os.transaction").Transaction
    PeerState = imp(pkg, "osd.peering").PeerState
    shard_coll = imp(pkg, "osd.pg_backend").shard_coll
    osd = FakeOsd(pkg)
    pool = imp(pkg, "osd.osdmap").PgPool(id=1, name="p", size=2, min_size=1)
    pg = make_pg(pkg, osd, pool)
    coll = shard_coll(pg.pgid, -1)
    t = Transaction().create_collection(coll)
    for i in range(n_objects):
        t.write(coll, f"o{i:03d}", 0, b"x")
    osd.store.queue_transaction(t)
    pg._acting = [0, 1]
    pg._epoch = 5
    p = pg.peering
    p.epoch, p.acting, p.primary, p.state = 5, [0, 1], 0, PeerState.ACTIVE
    p.backfill_targets = {1}
    p.last_backfill = {1: ""}
    pg._pending_pushes = []
    pg.backend.recover_object = lambda oid, missing_on, cb: pg._pending_pushes.append((oid, cb))
    return pg, osd


def reserve(pkg, op, epoch=5, from_osd=1, pg=None):
    R = imp(pkg, "msg.messages").MBackfillReserve
    return R(pgid=pg.pgid, op=getattr(R, op), epoch=epoch, from_osd=from_osd)


@pytest.mark.parametrize("pkg", PKGS)
class TestReserver:
    def test_slots_bound_and_idempotent(self, pkg):
        r = imp(pkg, "osd.reserver").Reserver(lambda: 2)
        assert r.try_reserve("a") and r.try_reserve("a") and r.try_reserve("b")
        assert not r.try_reserve("c")
        r.release("a")
        assert r.try_reserve("c")
        assert not r.release("missing")

    def test_runtime_slot_growth(self, pkg):
        slots = {"n": 1}
        r = imp(pkg, "osd.reserver").Reserver(lambda: slots["n"])
        assert r.try_reserve("a") and not r.try_reserve("b")
        slots["n"] = 2
        assert r.try_reserve("b")

    def test_preemption_fires_once_and_ties_never_preempt(self, pkg):
        r = imp(pkg, "osd.reserver").Reserver(lambda: 1)
        fired = []
        assert r.try_reserve("bf", priority=0, on_preempt=lambda: fired.append("bf"))
        assert not r.try_reserve("peer", priority=0)
        assert r.try_reserve("rec", priority=5)
        assert fired == ["bf"] and r.holders() == {"rec": 5} and r.preemptions == 1
        assert not r.release("bf")


@pytest.mark.parametrize("pkg", PKGS)
def test_log_trim_advances_tail_and_bounds_entries(pkg):
    pl = imp(pkg, "osd.pg_log")
    log = pl.PGLog()
    for i in range(1, 21):
        log.append(pl.LogEntry(oid=f"o{i}", op=1, version=pl.Eversion(1, i),
                               prior_version=pl.Eversion()))
    log.trim(pl.Eversion(1, 15))
    assert log.tail == pl.Eversion(1, 15) and len(log.entries) == 5
    assert not log.can_catch_up(pl.Eversion(1, 10)) and log.can_catch_up(pl.Eversion(1, 15))
    assert [e.oid for e in log.entries_after(pl.Eversion(1, 18))] == ["o19", "o20"]
    assert sorted(log.missing_from(pl.Eversion(1, 17)).items) == ["o18", "o19", "o20"]


@pytest.mark.parametrize("pkg", PKGS)
class TestBackfillDriver:
    def test_reject_surrenders_local_slot(self, pkg):
        pg, osd = backfilling_pg(pkg)
        R = imp(pkg, "msg.messages").MBackfillReserve
        pg._kick_backfill()
        assert pg._bf_local_reserved
        assert any(m.op == R.REQUEST for _, m in osd.sent)
        pg.on_backfill_reserve(reserve(pkg, "REJECT", pg=pg))
        assert not pg._bf_local_reserved and osd.local_reserver.held() == 0
        pg._kick_backfill()
        assert pg._bf_local_reserved

    def test_failed_push_caps_cursor_and_retries(self, pkg):
        pg, osd = backfilling_pg(pkg, n_objects=6)
        pg._kick_backfill()
        pg.on_backfill_reserve(reserve(pkg, "GRANT", pg=pg))
        assert len(pg._pending_pushes) == 4
        for oid, cb in pg._pending_pushes:
            cb(5 if oid == "o001" else 0)
        assert pg.peering.last_backfill[1] == "o000" and 1 in pg.peering.backfill_targets
        pg._pending_pushes.clear()
        pg._kick_backfill()
        assert [oid for oid, _ in pg._pending_pushes][0] == "o001"
        guard = 0
        while 1 in pg.peering.backfill_targets:
            guard += 1
            assert guard < 100, "backfill never completed"
            if not pg._pending_pushes:
                pg._kick_backfill()
            pending, pg._pending_pushes = pg._pending_pushes, []
            for _oid, cb in pending:
                cb(0)
        assert osd.local_reserver.held() == 0
        assert osd.perf.dump()["backfill_pushes"] >= 6

    def test_stale_grant_sends_release_back(self, pkg):
        pg, osd = backfilling_pg(pkg)
        R = imp(pkg, "msg.messages").MBackfillReserve
        pg.on_backfill_reserve(reserve(pkg, "GRANT", epoch=3, pg=pg))
        rel = [m for tgt, m in osd.sent if tgt == 1]
        assert rel and rel[-1].op == R.RELEASE

    def test_straggler_callback_after_interval_change_is_inert(self, pkg):
        pg, osd = backfilling_pg(pkg)
        pg._kick_backfill()
        pg.on_backfill_reserve(reserve(pkg, "GRANT", pg=pg))
        stragglers = list(pg._pending_pushes)
        assert stragglers
        pg._reset_backfill()
        pg._pending_pushes.clear()
        for _, cb in stragglers:
            cb(0)
        assert not pg._pending_pushes and not pg._bf_local_reserved

    def test_reads_exclude_stale_backfill_shard(self, pkg):
        pg, _osd = backfilling_pg(pkg)
        pg.peering.last_backfill[1] = "o003"
        assert pg.get_shard_missing("o002") == set() == pg.get_shard_missing("o003")
        assert pg.get_shard_missing("o007") == {1}
        assert not pg.peering.object_missing_anywhere("o007")


def _entry(pl, oid, epoch, version, prior=None, reqid=("", 0)):
    return pl.LogEntry(oid=oid, version=pl.Eversion(epoch, version),
                       prior_version=prior or pl.Eversion(), reqid=reqid)


def _peering(pkg, log, dropped=None):
    return imp(pkg, "osd.peering").PeeringState(
        imp(pkg, "msg.messages").PgId(1, 0, -1), whoami=0, log=log,
        info=imp(pkg, "osd.pg_log").PgInfo(), send=lambda osd, msg: None,
        on_active=lambda: None, list_local_objects=lambda: [],
        drop_local_object=None if dropped is None else dropped.append)


@pytest.mark.parametrize("pkg", PKGS)
class TestDivergentRewind:
    def test_divergent_entries_rewound_and_marked_missing(self, pkg):
        pl = imp(pkg, "osd.pg_log")
        log = pl.PGLog()
        log.append(_entry(pl, "a", 1, 1))
        log.append(_entry(pl, "b", 1, 2))
        log.append(_entry(pl, "b", 1, 3, prior=pl.Eversion(1, 2)))
        ps = _peering(pkg, log)
        ps._merge_log([], auth_last=pl.Eversion(1, 2))
        assert ps.log.head == pl.Eversion(1, 2)
        assert "b" in ps.missing and "a" not in ps.missing

    def test_divergence_across_epochs(self, pkg):
        pl = imp(pkg, "osd.pg_log")
        log = pl.PGLog()
        log.append(_entry(pl, "a", 1, 6))
        log.append(_entry(pl, "x", 1, 7))
        dropped = []
        ps = _peering(pkg, log, dropped)
        ps._merge_log([_entry(pl, "b", 2, 8)], auth_last=pl.Eversion(2, 8),
                      since=pl.Eversion(1, 6))
        versions = [e.version for e in ps.log.entries]
        assert pl.Eversion(1, 7) not in versions and pl.Eversion(2, 8) in versions
        assert dropped == ["x"] and "x" not in ps.missing

    def test_common_point_rewinds_unknown_head(self, pkg):
        pl = imp(pkg, "osd.pg_log")
        log = pl.PGLog()
        log.append(_entry(pl, "a", 1, 6))
        log.append(_entry(pl, "b", 2, 8))
        ps = _peering(pkg, log)
        assert ps._common_point(pl.Eversion(1, 7)) == pl.Eversion(1, 6)
        assert ps._common_point(pl.Eversion(2, 8)) == pl.Eversion(2, 8)


@pytest.mark.parametrize("pkg", PKGS)
class TestDupWindowRebuild:
    def _pg(self, pkg):
        osd = FakeOsd(pkg)
        pool = imp(pkg, "osd.osdmap").PgPool(id=1, name="p", size=2, min_size=1)
        return make_pg(pkg, osd, pool)

    def test_rebuild_from_pg_log_on_activation(self, pkg):
        pl = imp(pkg, "osd.pg_log")
        pg = self._pg(pkg)
        pg._epoch = 3
        pg.pg_log.append(_entry(pl, "obj1", 2, 7, reqid=("client.4", 11)))
        pg.pg_log.append(_entry(pl, "obj2", 2, 8, reqid=("client.4", 12)))
        pg._rebuild_dup_window()
        rep = pg._reqid_results[("client.4", 11)]
        assert rep.result == 0 and rep.version == 7
        assert ("client.4", 12) in pg._reqid_results

    def test_entries_without_reqid_skipped(self, pkg):
        pl = imp(pkg, "osd.pg_log")
        pg = self._pg(pkg)
        pg.pg_log.append(_entry(pl, "obj1", 2, 7))
        pg._rebuild_dup_window()
        assert pg._reqid_results == {}


# -- the port's own -------------------------------------------------------------------


def test_pg_without_device_needs_a_gpu():
    """`PG(..., device=None)` makes its EC codec on cuda: with no GPU it
    raises instead of running on the CPU."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    om = imp("torch", "osd.osdmap")
    pool = om.PgPool(id=1, name="ec", type=om.POOL_TYPE_ERASURE, size=6, pg_num=1,
                     erasure_code_profile="p", stripe_width=SW)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        imp("torch", "osd.pg").PG(FakeOsd("torch"), pool, 0,
                                  {"p": {"plugin": "tpu", "k": "4", "m": "2"}})


def _active_primary(pkg, pool):
    pg = make_pg(pkg, FakeOsd(pkg), pool)
    pg.on_new_interval(1, [0])  # alone in its acting set: active at once
    assert pg.peering.is_primary() and pg.peering.is_active()
    return pg


@pytest.mark.parametrize("code", ["COPY_FROM", "WATCH", "NOTIFY", "LIST_WATCHERS"])
def test_unported_ops_answer_eopnotsupp(code):
    """COPY_FROM (the daemon's objecter leg) and watch/notify (client
    sessions) are not ported: the op fails whole with -EOPNOTSUPP and
    leaves nothing behind."""
    msgs = imp("torch", "msg.messages")
    om = imp("torch", "osd.osdmap")
    pg = _active_primary("torch", om.PgPool(id=1, name="p", size=1, min_size=1))
    replies = []
    op = msgs.OSDOp(op=getattr(msgs.OSDOp, code), name="src", off=1, len=1)
    pg.do_op(msgs.MOSDOp(reqid=msgs.ReqId("client.1", 1), pgid=pg.pgid, oid="o", ops=[op]),
             replies.append)
    assert [r.result for r in replies] == [-imp("torch", "common.errs").EOPNOTSUPP]
    assert not pg._inflight_reqids and not pg.osd.store.list_objects("1.0")


def test_cache_tier_pool_answers_eopnotsupp():
    """Cache tiering promotes and flushes through the daemon's objecter:
    every op on a cache-tier pool answers -EOPNOTSUPP."""
    msgs = imp("torch", "msg.messages")
    om = imp("torch", "osd.osdmap")
    pool = om.PgPool(id=2, name="cache", size=1, min_size=1, tier_of=1, cache_mode="writeback")
    pg = _active_primary("torch", pool)
    for code in ("WRITEFULL", "READ", "CACHE_FLUSH"):
        replies = []
        op = msgs.OSDOp(op=getattr(msgs.OSDOp, code), data=b"abc")
        pg.do_op(msgs.MOSDOp(reqid=msgs.ReqId("client.1", 1), pgid=pg.pgid, oid="o", ops=[op]),
                 replies.append)
        assert [r.result for r in replies] == [-95], code
    assert not pg.osd.store.list_objects("2.0")


def test_host_module_imports_neither_package():
    """tests/torch_pg_host.py, which chip_smoke.py loads, names no package."""
    import ast
    from pathlib import Path

    tree = ast.parse((Path(__file__).parent / "torch_pg_host.py").read_text())
    names = {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
    names |= {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom) and n.module}
    assert not {n.split(".")[0] for n in names} & {"jax", "ceph_tpu", "ceph_tpu_torch", "torch"}


def test_failed_launch_under_a_pg_fails_the_op_with_eio():
    """A failed encode launch under `PG.do_op` answers the client op with
    -EIO (no host recompute): no shard stores it, no log entry is kept
    (only the version it took is spent), the reqid is not remembered, and
    once a probe heals the guard the client's resend of the same op
    commits."""
    from ceph_tpu_torch.common.fault_injector import global_injector
    from ceph_tpu_torch.ops import dispatch
    from ceph_tpu_torch.ops.guard import device_guard

    async def run():
        c = PgCluster(ROOT["torch"], 6, POOLS[:1], conf=conf_for("torch"), device="cpu")
        await c.settle()
        before, states = c.stores(), c.pg_states()
        fb0 = dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
        device_guard().configure(probe_interval_ms=10_000_000)
        global_injector().inject("codec.launch", 5, hits=1)
        data = bytes(range(256)) * 80
        rep = c.op("ec", "obj", [c.osd_op("WRITEFULL", data=data)])
        await c.pump()
        assert [r.result for r in rep] == [-imp("torch", "common.errs").EIO]
        # nothing moved but the version counter the write took (index 13)
        drop = lambda st: {k: v[:13] + v[14:] for k, v in st.items()}  # noqa: E731
        assert c.stores() == before and drop(c.pg_states()) == drop(states)
        assert any("encode launch for obj failed" in e for h in c.hosts for e in h.clog)
        assert dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fb0
        assert device_guard().degraded
        device_guard().configure(probe_interval_ms=1)
        await asyncio.sleep(0.01)
        assert device_guard().maybe_probe(lambda: None) is True
        again = c.op("ec", "obj", [c.osd_op("WRITEFULL", data=data)], tid=c.tid)
        await c.pump()
        assert [r.result for r in again] == [0]
        read = c.op("ec", "obj", [c.osd_op("READ", off=0, len=0)])
        await c.pump()
        assert read[0].outdata == [data]

    asyncio.run(run())


def test_moved_slots_without_holders_rebuild_in_the_port():
    """ROADMAP C13, the port's policy.  12 OSDs, EC RS(8,3), pg_num 32:
    osd.3 down, then out.  CRUSH refills PG 1.12's slots by moving three
    survivors, and its new primary (osd.11) has no holder table, so four
    slots need a rebuild and only seven shards have a source.  The
    reference's rebuild fails with EIO on every tick and the PG never gets
    clean; the port takes the moved members' old slots as their holders
    after the first failure, gets clean and reads every object back."""
    pools = [dict(name="rbd", kind="ec", k=8, m=3, pg_num=32, stripe_unit=SU, overwrites=True)]

    async def run(pkg):
        c = PgCluster(ROOT[pkg], 12, pools, conf=conf_for(pkg), device=DEVICE[pkg])
        await c.settle()
        pool_id = c.osdmap.get_pool("rbd").id
        names = [n for n in (f"rbd_data.1.{i:016x}" for i in range(4000))
                 if c.osdmap.object_to_pg(pool_id, n) == (pool_id, 12)][:3]
        data = {n: bytes([i + 1]) * (8 * SU) for i, n in enumerate(names)}
        for n, d in data.items():
            c.op("rbd", n, [c.osd_op("WRITEFULL", data=d)])
        await c.pump()
        c.mark_down(3)
        await c.settle()
        assert c.placement(c.osdmap)[(pool_id, 12)][3] == 4
        c.mark_out(3)
        try:
            await c.settle(rounds=8)
        except AssertionError as e:
            return "unclean", str(e), c
        assert c.placement(c.osdmap)[(pool_id, 12)][3] == 11
        reads = [c.op("rbd", n, [c.osd_op("READ", off=0, len=0)]) for n in data]
        await c.pump()
        assert [r[0].outdata for r in reads] == [[d] for d in data.values()]
        return "clean", "", c

    assert asyncio.run(run("torch"))[0] == "clean"
    state, why, c = asyncio.run(run("jax"))
    assert state == "unclean" and "1.12" in why, why
    assert any("recovery of rbd_data.1." in e and "failed: -5" in e for h in c.hosts for e in h.clog)
