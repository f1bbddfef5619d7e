"""The port's OSDMap (`ceph_tpu_torch/osd/osdmap.py`) against the JAX
package's: the same maps built through both packages encode to the same
bytes and decode across, `Incremental.apply_to` and `advance_map` move
both to equal maps, and `object_to_pg`, `pg_to_raw_osds` and
`pg_to_up_acting_osds` agree for every PG of every pool after every
change (OSDs down, up, out, in and reweighted)."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest

from ceph_tpu.msg import messages as jmsgs
from ceph_tpu.osd import osdmap as jmap

from ceph_tpu_torch.msg import messages as tmsgs
from ceph_tpu_torch.osd import osdmap as tmap

PKGS = {"jax": jmap, "torch": tmap}
SEEDS = (0, 1, 2)


def build(mod, n_osds=10, per_host=2):
    m = mod.OSDMap()
    m.fsid = "osdmap-test"
    m.crush.build_flat(n_osds, per_host)
    for o in range(n_osds):
        m.add_osd(o, addr=f"10.0.0.{o}:6800")
    ec_rule = m.crush.add_simple_rule("ec_rs42", failure_domain="osd", mode="indep")
    rep_rule = m.crush.add_simple_rule("replicated_rule", failure_domain="host", mode="firstn")
    m.erasure_code_profiles["rs42"] = {"plugin": "tpu", "k": "4", "m": "2"}
    m.create_pool("ec", mod.POOL_TYPE_ERASURE, size=6, min_size=5, pg_num=16, crush_rule=ec_rule,
                  erasure_code_profile="rs42", stripe_width=4 * 4096,
                  flags=mod.FLAG_EC_OVERWRITES)
    m.create_pool("rep", mod.POOL_TYPE_REPLICATED, size=3, pg_num=8, crush_rule=rep_rule)
    cache = m.create_pool("cache", mod.POOL_TYPE_REPLICATED, size=2, pg_num=4,
                          crush_rule=rep_rule)
    # the versioned trailers: tiering, quotas, blocklist, application tags
    cache.tier_of, cache.cache_mode, cache.target_max_objects = 2, "writeback", 100
    m.pools[2].tiers, m.pools[2].read_tier = [3], 3
    m.pools[2].quota_max_bytes, m.pools[2].quota_max_objects = 1 << 30, 1000
    m.pools[1].application = "rbd"
    m.blocklist = {"client.9", "client.7"}
    m.epoch = 1
    return m


def mapping(m) -> dict:
    out = {}
    for pool in m.pools.values():
        for ps in range(pool.pg_num):
            out[(pool.id, ps)] = (m.pg_to_raw_osds(pool.id, ps),
                                  m.pg_to_up_acting_osds(pool.id, ps))
    return out


def pools(m) -> dict:
    return {pid: dataclasses.asdict(p) for pid, p in m.pools.items()}


def test_full_map_bytes_equal_and_decode_across():
    j, t = build(jmap), build(tmap)
    blob = t.tobytes()
    assert blob == j.tobytes()
    back = tmap.OSDMap.frombytes(j.tobytes())
    jback = jmap.OSDMap.frombytes(blob)
    assert back.tobytes() == jback.tobytes() == blob
    assert pools(back) == pools(jback) == pools(t)
    assert back.blocklist == jback.blocklist == {"client.7", "client.9"}
    assert mapping(back) == mapping(jback) == mapping(t)


def test_object_to_pg_equal():
    j, t = build(jmap), build(tmap)
    for n in range(300):
        name = f"rbd_data.1f2e.{n:016x}"
        for pid in (1, 2, 3):
            assert t.object_to_pg(pid, name) == j.object_to_pg(pid, name)
            assert t.pools[pid].raw_pg_to_pps(n) == j.pools[pid].raw_pg_to_pps(n)


def _changes(seed, n_osds=10, steps=8):
    """Seeded incrementals: each marks an OSD down or up, or sets a
    reweight (0 = out, 0x10000 = in, or a partial weight)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        osd = int(rng.integers(0, n_osds))
        kind = int(rng.integers(0, 4))
        if kind == 0:
            out.append({"new_down": [osd]})
        elif kind == 1:
            out.append({"new_up": {osd: f"10.0.1.{osd}:6800"}})
        else:
            out.append({"new_weights": {osd: int(rng.choice([0, 0x10000, 0x8000, 0x3000]))}})
    return out


@pytest.mark.parametrize("seed", SEEDS)
def test_incrementals_apply_equal(seed):
    maps = {pkg: build(mod) for pkg, mod in PKGS.items()}
    for delta in _changes(seed):
        blobs = {}
        for pkg, mod in PKGS.items():
            inc = mod.Incremental(epoch=maps[pkg].epoch + 1, **delta)
            blobs[pkg] = inc.tobytes()
            maps[pkg] = mod.Incremental.frombytes(blobs[pkg]).apply_to(maps[pkg])
        assert blobs["torch"] == blobs["jax"]
        assert maps["torch"].tobytes() == maps["jax"].tobytes()
        assert mapping(maps["torch"]) == mapping(maps["jax"])
        assert maps["torch"].num_up_osds() == maps["jax"].num_up_osds()
    # a stale incremental is refused by both
    for pkg, mod in PKGS.items():
        with pytest.raises(ValueError):
            mod.Incremental(epoch=maps[pkg].epoch + 2).apply_to(maps[pkg])


@pytest.mark.parametrize("seed", SEEDS)
def test_advance_map_equal(seed):
    """advance_map over an MOSDMap of both packages: a full map, then a
    run of incrementals with one gap filled by a later full map."""
    deltas = _changes(seed, steps=6)
    results = {}
    for pkg, mod, msgs in (("jax", jmap, jmsgs), ("torch", tmap, tmsgs)):
        base = build(mod)
        full1 = base.tobytes()
        incs, cur = {}, mod.OSDMap.frombytes(full1)
        for delta in deltas:
            inc = mod.Incremental(epoch=cur.epoch + 1, **delta)
            incs[inc.epoch] = inc.tobytes()
            cur = mod.Incremental.frombytes(incs[inc.epoch]).apply_to(cur)
        last = cur.epoch
        fulls = {1: full1, last: cur.tobytes()}
        gapped = {e: b for e, b in incs.items() if e != 4}
        seen = []
        m = mod.OSDMap()
        for msg in (msgs.MOSDMap(fsid="f", maps={1: full1}, incrementals={}),
                    msgs.MOSDMap(fsid="f", maps={}, incrementals={e: b for e, b in gapped.items()
                                                                   if e <= 5}),
                    msgs.MOSDMap(fsid="f", maps=fulls, incrementals=gapped),
                    SimpleNamespace(maps={}, incrementals=incs)):
            seen.append(msg.tobytes() if hasattr(msg, "tobytes") else None)
            m = mod.advance_map(m, msg)
            seen.append((m.epoch, m.tobytes(), mapping(m)))
        results[pkg] = seen
    assert results["torch"] == results["jax"]
