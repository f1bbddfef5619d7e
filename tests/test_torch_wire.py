"""The port's wire encodings and write planning against the JAX package:
`Transaction`, `LogEntry`, `Eversion`, `ObjectInfo`, `PgId`, `ReqId`,
`PushOp`, the four EC sub-op messages, the recovery pushes
(`MOSDPGPush`, `MOSDPGPushReply`), the scrub messages (`MOSDRepScrub`,
`MOSDRepScrubMap`) and the placement-group layer's (`OSDOp`, `MOSDOp`,
`MOSDOpReply`, `MOSDMap`, `MOSDPGQuery`, `MOSDPGNotify`, `MOSDPGLog`,
`MOSDRepOp`, `MOSDRepOpReply`, `MOSDPGPull`, `MBackfillReserve`, and the
PG log's `PgInfo`) give the reference's bytes for seeded values,
and each package decodes the other's; `get_write_plan` and `merge_writes`
give the reference's plans and merged bytes on 200 seeded cases; and the
copied helpers are pinned to the reference (`PgPool`'s fields and
defaults, the pool constants, the new fault points' texts, and the
ExtentCache's pin, present and release results)."""

import dataclasses

import numpy as np
import pytest

from ceph_tpu.common import fault_injector as jfault
from ceph_tpu.common.encoding import Encoder as JEncoder
from ceph_tpu.msg import messages as jmsg
from ceph_tpu.os import transaction as jtx
from ceph_tpu.osd import ec_transaction as jet
from ceph_tpu.osd import extent_cache as jext
from ceph_tpu.osd import osdmap as jmap
from ceph_tpu.osd import pg_log as jlog
from ceph_tpu.stripe import StripeInfo as JStripeInfo

from ceph_tpu_torch.common import fault_injector
from ceph_tpu_torch.common.encoding import Encoder
from ceph_tpu_torch.msg import messages as msg
from ceph_tpu_torch.os import transaction as tx
from ceph_tpu_torch.osd import ec_transaction as et
from ceph_tpu_torch.osd import extent_cache as ext
from ceph_tpu_torch.osd import osdmap
from ceph_tpu_torch.osd import pg_log
from ceph_tpu_torch.stripe import StripeInfo


def _rbytes(rng, n):
    return rng.integers(0, 256, n, dtype=np.uint8).tobytes()


def _txn(mod, seed):
    rng = np.random.default_rng(seed)
    t = mod.Transaction()
    t.create_collection("1.0s2").touch("1.0s2", "o")
    t.write("1.0s2", "o", int(rng.integers(1 << 20)), _rbytes(rng, 300), hints=3)
    t.append("1.0s2", "o", _rbytes(rng, 77))
    t.zero("1.0s2", "o", 5, 9).truncate("1.0s2", "o", int(rng.integers(1 << 16)))
    t.setattr("1.0s2", "o", "_", _rbytes(rng, 20)).rmattr("1.0s2", "o", "hinfo_key")
    t.omap_setkeys("1.0s2", "o", {"b": _rbytes(rng, 3), "a": b""})
    t.omap_rmkeys("1.0s2", "o", ["x", "y"]).omap_clear("1.0s2", "o")
    t.clone("1.0s2", "o", "o.snap").remove("1.0s2", "o").remove_collection("1.0s2")
    return t


def _values(seed):
    """Seeded wire values, built by each package from the same numbers."""
    rng = np.random.default_rng(seed)
    ints = [int(x) for x in rng.integers(0, 1 << 30, 8)]
    blob = _rbytes(rng, 64)

    def build(m, log, txmod, etmod):
        pgid = m.PgId(ints[0] % 9, ints[1], ints[2] % 11)
        reqid = m.ReqId(f"client.{ints[3]}", ints[4])
        entry = log.LogEntry(
            op=log.LOG_DELETE if seed % 2 else log.LOG_MODIFY,
            oid=f"obj{ints[5]}",
            version=log.Eversion(3, ints[6]),
            prior_version=log.Eversion(2, ints[7]),
            reqid=reqid.key(),
        )
        return {
            "transaction": _txn(txmod, seed),
            "log_entry": entry,
            "pgid": pgid,
            "reqid": reqid,
            "sub_write": m.MOSDECSubOpWrite(
                pgid=pgid, from_osd=ints[1] % 64, tid=ints[2], reqid=reqid,
                txn=_txn(txmod, seed + 1).tobytes(), at_version=ints[6],
                log_entries=[entry.tobytes(), entry.tobytes()],
            ),
            "sub_write_reply": m.MOSDECSubOpWriteReply(
                pgid=pgid, from_osd=ints[3] % 64, tid=ints[4], committed=bool(seed % 2)
            ),
            "sub_read": m.MOSDECSubOpRead(
                pgid=pgid, from_osd=ints[5] % 64, tid=ints[6],
                to_read={"o1": [[0, 4096], [8192, 4096]], "o0": [[ints[7], 128]]},
                subchunks={"o1": [[0, 1]], "o0": [[0, 1]]},
                attrs_to_read=["o0"] if seed % 2 else [],
            ),
            "sub_read_reply": m.MOSDECSubOpReadReply(
                pgid=pgid, from_osd=ints[0] % 64, tid=ints[1],
                buffers={"o1": [[(4096).to_bytes(8, "little"), blob]]},
                attrs={"o1": {"_": blob[:9], "hinfo_key": blob[9:]}},
                errors={"o2": -5} if seed % 2 else {},
            ),
            "object_info": etmod.ObjectInfo(size=ints[2], version=ints[3]),
            "push_op": m.PushOp(
                oid=f"obj{ints[4]}", data=blob, attrs={"_": blob[:9], "hinfo_key": blob[9:]},
                version=ints[5], omap={"k": blob[:3]} if seed % 2 else None,
            ),
            "push": m.MOSDPGPush(
                pgid=pgid,
                pushes=[m.PushOp(oid=f"o{i}", data=blob[i:], attrs={"_": blob[:i]},
                                 version=ints[i]) for i in range(1 + seed % 2 * 2)],
                epoch=ints[6] % 1000, from_osd=ints[7] % 64,
            ),
            "push_reply": m.MOSDPGPushReply(
                pgid=pgid, oids=[f"o{i}" for i in range(1 + seed)],
                epoch=ints[0] % 1000, from_osd=ints[1] % 64,
            ),
            "rep_scrub": m.MOSDRepScrub(
                pgid=pgid, epoch=ints[2] % 1000, from_osd=ints[3] % 64,
                deep=bool(seed % 2), scrub_tid=ints[4],
                chunk_start=f"rbd_data.{ints[5]:016x}",
                chunk_end=f"rbd_data.{ints[6]:016x}" if seed % 2 else "",
            ),
            "rep_scrub_map": m.MOSDRepScrubMap(
                pgid=pgid, epoch=ints[7] % 1000, from_osd=ints[0] % 64,
                scrub_tid=ints[1],
                scrub_map=b'{"o1": {"size": %d, "digest": %d}}' % (ints[2], ints[3]) + blob,
            ),
            "osd_op": m.OSDOp(op=m.OSDOp.WRITE, off=ints[1], len=ints[2], data=blob,
                              name="color" if seed % 2 else ""),
            "op": m.MOSDOp(
                reqid=reqid, pgid=pgid, oid=f"rbd_data.{ints[3]:x}",
                ops=[m.OSDOp(op=m.OSDOp.WRITEFULL, data=blob),
                     m.OSDOp(op=m.OSDOp.SETXATTR, name="a", data=blob[:5])],
                epoch=ints[4] % 1000, snap_seq=3 if seed % 2 else 0,
                snaps=[3, 1] if seed % 2 else [], snap_id=ints[5] % 7,
            ),
            "op_reply": m.MOSDOpReply(reqid=reqid, result=-2 if seed % 2 else 0,
                                      outdata=[blob, b""], version=ints[6], epoch=ints[7] % 99),
            "osdmap": m.MOSDMap(fsid=f"fsid{ints[0]}", maps={ints[1] % 50: blob},
                                incrementals={ints[2] % 50: blob[:7], 3: b""}),
            "pg_query": m.MOSDPGQuery(pgid=pgid, op=m.MOSDPGQuery.LOG if seed % 2 else
                                      m.MOSDPGQuery.INFO, epoch=ints[3] % 1000,
                                      from_osd=ints[4] % 64, since_epoch=ints[5] % 9,
                                      since_ver=ints[6]),
            "pg_notify": m.MOSDPGNotify(pgid=pgid, info=blob[:40], epoch=ints[7] % 1000,
                                        from_osd=ints[0] % 64),
            "pg_log": m.MOSDPGLog(pgid=pgid, info=blob[:40], log=blob, epoch=ints[1] % 1000,
                                  from_osd=ints[2] % 64, since_epoch=ints[3] % 9,
                                  since_ver=ints[4]),
            "pg_info": log.PgInfo(last_update=log.Eversion(4, ints[5]),
                                  last_complete=log.Eversion(3, ints[6]),
                                  log_tail=log.Eversion(1, ints[7]),
                                  last_epoch_started=ints[0] % 1000),
            "rep_op": m.MOSDRepOp(pgid=pgid, from_osd=ints[1] % 64, tid=ints[2], reqid=reqid,
                                  txn=_txn(txmod, seed + 2).tobytes(),
                                  log_entries=[entry.tobytes()]),
            "rep_op_reply": m.MOSDRepOpReply(pgid=pgid, from_osd=ints[3] % 64, tid=ints[4]),
            "pg_pull": m.MOSDPGPull(pgid=pgid, oid=f"obj{ints[5]}", epoch=ints[6] % 1000,
                                    from_osd=ints[7] % 64),
            "backfill_reserve": m.MBackfillReserve(
                pgid=pgid, op=m.MBackfillReserve.GRANT if seed % 2 else
                m.MBackfillReserve.RELEASE, epoch=ints[0] % 1000, from_osd=ints[1] % 64),
        }

    return build(jmsg, jlog, jtx, jet), build(msg, pg_log, tx, et)


def _bytes(value):
    return value.encode() if isinstance(value, (et.ObjectInfo, jet.ObjectInfo)) else value.tobytes()


def _decode(sample, data):
    if isinstance(sample, (et.ObjectInfo, jet.ObjectInfo)):
        return type(sample).decode(data)
    return type(sample).frombytes(data)


KINDS = ["transaction", "log_entry", "pgid", "reqid", "sub_write", "sub_write_reply",
         "sub_read", "sub_read_reply", "object_info", "push_op", "push", "push_reply",
         "rep_scrub", "rep_scrub_map", "osd_op", "op", "op_reply", "osdmap", "pg_query",
         "pg_notify", "pg_log", "pg_info", "rep_op", "rep_op_reply", "pg_pull",
         "backfill_reserve"]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", KINDS)
def test_encoding_matches_reference_both_ways(kind, seed):
    ref, ours = (v[kind] for v in _values(seed))
    assert _bytes(ours) == _bytes(ref)
    # each package decodes the other's bytes back to the same bytes
    assert _bytes(_decode(ours, _bytes(ref))) == _bytes(ref)
    assert _bytes(_decode(ref, _bytes(ours))) == _bytes(ours)


def test_eversion_and_message_type_numbers_match_reference():
    for epoch, version in [(0, 0), (1, 2), (7, (1 << 40) + 3)]:
        e1, e2 = Encoder(), JEncoder()
        pg_log.Eversion(epoch, version).encode(e1)
        jlog.Eversion(epoch, version).encode(e2)
        assert e1.tobytes() == e2.tobytes()
    for name in ("MOSDECSubOpWrite", "MOSDECSubOpWriteReply", "MOSDECSubOpRead",
                 "MOSDECSubOpReadReply", "MOSDPGPush", "MOSDPGPushReply",
                 "MOSDRepScrub", "MOSDRepScrubMap", "MOSDOp", "MOSDOpReply", "MOSDMap",
                 "MOSDPGQuery", "MOSDPGNotify", "MOSDPGLog", "MOSDRepOp", "MOSDRepOpReply",
                 "MOSDPGPull", "MBackfillReserve"):
        ours, ref = getattr(msg, name), getattr(jmsg, name)
        assert (ours.TYPE, ours.VERSION, ours.priority) == (ref.TYPE, ref.VERSION, ref.priority)
        assert [f for f, _ in ours.FIELDS] == [f for f, _ in ref.FIELDS]
    assert (pg_log.LOG_MODIFY, pg_log.LOG_DELETE) == (jlog.LOG_MODIFY, jlog.LOG_DELETE)
    codes = {k: v for k, v in vars(jmsg.OSDOp).items() if k.isupper() and isinstance(v, int)}
    assert codes and all(getattr(msg.OSDOp, k) == v for k, v in codes.items())
    assert [f for f, _ in msg.OSDOp.FIELDS] == [f for f, _ in jmsg.OSDOp.FIELDS]
    for name in ("REQUEST", "GRANT", "REJECT", "RELEASE"):
        assert getattr(msg.MBackfillReserve, name) == getattr(jmsg.MBackfillReserve, name)
    assert (msg.MOSDPGQuery.INFO, msg.MOSDPGQuery.LOG) == (jmsg.MOSDPGQuery.INFO,
                                                           jmsg.MOSDPGQuery.LOG)
    assert (et.OI_ATTR, et.HINFO_ATTR) == (jet.OI_ATTR, jet.HINFO_ATTR)


# -- write planning -----------------------------------------------------------------


def _plan_case(seed):
    rng = np.random.default_rng(1000 + seed)
    k = int(rng.choice([2, 4, 8]))
    sw = k * int(rng.choice([128, 4096]))
    overwrites = bool(rng.integers(2))
    size = int(rng.integers(0, 4 * sw)) if rng.integers(4) else 0
    padded = -(-size // sw) * sw
    writes = []
    for _ in range(int(rng.integers(0, 4))):
        if overwrites:
            off = int(rng.integers(0, size + 2 * sw))
            ln = int(rng.integers(1, 3 * sw))
        else:
            off = int(rng.choice([0, padded, padded + sw, int(rng.integers(0, size + 1))]))
            ln = int(rng.integers(1, 3 * sw))
        writes.append((off, _rbytes(rng, ln)))
    truncate = int(rng.integers(0, size + 2 * sw)) if rng.integers(3) == 0 else None
    delete = bool(rng.integers(12) == 0)
    return sw, k, overwrites, size, writes, truncate, delete


@pytest.mark.parametrize("seed", range(200))
def test_write_plan_and_merge_match_reference(seed):
    sw, k, overwrites, size, writes, truncate, delete = _plan_case(seed)
    results = []
    for pkg, sinfo, mod in (("jax", JStripeInfo(sw, sw // k), jet),
                            ("torch", StripeInfo(sw, sw // k), et)):
        pgt = mod.PGTransaction("o", truncate=truncate, delete=delete)
        for off, data in writes:
            pgt.write(off, data)
        try:
            plan = mod.get_write_plan(sinfo, pgt, size, overwrites)
        except Exception as e:  # noqa: BLE001  (compared across packages)
            results.append(("raise", type(e).__name__, getattr(e, "errno", None)))
            continue
        read_rng = np.random.default_rng(seed)
        read_data = {off: _rbytes(read_rng, ln) for off, ln in plan.to_read}
        merged = mod.merge_writes(pgt, plan, size, read_data)
        results.append((dataclasses.asdict(plan), {o: bytes(b) for o, b in merged.items()}))
    assert results[0] == results[1]


@pytest.mark.parametrize("k,m", [(4, 2), (8, 3)])
def test_generate_transactions_matches_reference(k, m):
    """The synchronous launch + finish composition: an append onto an
    object with hinfo, and a partial overwrite that drops it, give the
    reference's per-shard transaction bytes, hinfo and merged bytes."""
    from ceph_tpu.codec import registry as jregistry
    from ceph_tpu.parallel import dispatch as jshard
    from ceph_tpu.stripe import HashInfo as JHashInfo

    from ceph_tpu_torch.codec import registry
    from ceph_tpu_torch.stripe import HashInfo

    settings = jshard.settings()
    jshard.configure(devices=1)
    try:
        profile = {"k": str(k), "m": str(m)}
        sw = k * 4096
        rng = np.random.default_rng(k)
        colls = {s: f"1.0s{s}" for s in range(k + m)}
        base = _rbytes(rng, 2 * sw)
        out = []
        for sinfo, mod, ec, hinfo_cls in (
            (JStripeInfo(sw, 4096), jet, jregistry.instance().factory("tpu", dict(profile)), JHashInfo),
            (StripeInfo(sw, 4096), et, registry.instance().factory("tpu", dict(profile), device="cpu"),
             HashInfo),
        ):
            hinfo = hinfo_cls(k + m)
            hinfo.append(0, {s: b"\x07" * (2 * 4096) for s in range(k + m)})
            got = []
            for pgt, overwrites, read in (
                (mod.PGTransaction("o").write(2 * sw, _rbytes(np.random.default_rng(1), sw)), False, {}),
                (mod.PGTransaction("o").write(100, b"z" * 300), True, {0: base[:sw]}),
            ):
                plan = mod.get_write_plan(sinfo, pgt, 2 * sw, overwrites)
                txns, new_hinfo, merged = mod.generate_transactions(
                    pgt, plan, sinfo, ec, colls, 2 * sw, read, hinfo, 7
                )
                got.append(([txns[s].tobytes() for s in sorted(txns)],
                            None if new_hinfo is None else new_hinfo.encode(), merged))
            out.append(got)
        assert out[0] == out[1]
        assert out[1][0][1] is not None and out[1][1][1] is None
    finally:
        jshard.configure(*settings)


# -- pins on the copied helpers --------------------------------------------------------


def test_pg_pool_fields_defaults_and_constants_match_reference():
    ours = [(f.name, f.type, f.default, f.default_factory) for f in dataclasses.fields(osdmap.PgPool)]
    ref = [(f.name, f.type, f.default, f.default_factory) for f in dataclasses.fields(jmap.PgPool)]
    assert [o[:3] for o in ours] == [r[:3] for r in ref]
    assert [o[3] is dataclasses.MISSING for o in ours] == [r[3] is dataclasses.MISSING for r in ref]
    assert osdmap.PgPool(id=1, name="p") == osdmap.PgPool(
        **dataclasses.asdict(jmap.PgPool(id=1, name="p"))
    )
    for name in ("PG_NONE", "FLAG_EC_OVERWRITES", "FLAG_FULL_QUOTA", "POOL_TYPE_ERASURE",
                 "POOL_TYPE_REPLICATED"):
        assert getattr(osdmap, name) == getattr(jmap, name), name
    assert osdmap.PgPool(id=1, name="p", type=osdmap.POOL_TYPE_ERASURE).is_erasure()


def test_new_fault_points_carry_the_reference_texts():
    for point in ("os.read", "os.write", "ec.sub_read", "ec.recover_push", "peering.msg"):
        assert fault_injector.FAULT_POINTS[point] == jfault.FAULT_POINTS[point]


def test_os_fault_seams_raise_store_errors():
    from ceph_tpu_torch.os.memstore import MemStore
    from ceph_tpu_torch.os.objectstore import StoreError

    store = MemStore()
    store.queue_transaction(tx.Transaction().create_collection("c").write("c", "o", 0, b"abc"))
    inj = fault_injector.global_injector()
    try:
        inj.inject("os.read", 5, hits=1)
        with pytest.raises(StoreError):
            store.read("c", "o")
        assert store.read("c", "o") == b"abc"
        inj.inject("os.write", 5, hits=1)
        with pytest.raises(StoreError):
            store.queue_transaction(tx.Transaction().write("c", "o", 0, b"xyz"))
        assert store.read("c", "o") == b"abc"
    finally:
        inj.clear()


@pytest.mark.parametrize("seed", range(4))
def test_extent_cache_sequence_matches_reference(seed):
    rng = np.random.default_rng(seed)
    caches = (ext.ExtentCache(), jext.ExtentCache())
    pins: list[tuple] = []
    for _ in range(60):
        action = int(rng.integers(3))
        oid = f"o{int(rng.integers(2))}"
        if action == 0 or not pins:
            off = int(rng.integers(0, 64)) * 512
            data = _rbytes(rng, int(rng.integers(1, 8)) * 512)
            pair = tuple(c.prepare_pin() for c in caches)
            for c, p in zip(caches, pair):
                c.pin_extent(p, oid, off, data)
            pins.append(pair)
        elif action == 1:
            pair = pins.pop(int(rng.integers(len(pins))))
            for c, p in zip(caches, pair):
                c.release_pin(p)
        off = int(rng.integers(0, 80)) * 256
        ln = int(rng.integers(1, 16)) * 256
        assert caches[0].present(oid, off, ln) == caches[1].present(oid, off, ln)
        assert caches[0].empty() == caches[1].empty()
    for pair in pins:
        for c, p in zip(caches, pair):
            c.release_pin(p)
    assert caches[0].empty() and caches[1].empty()
