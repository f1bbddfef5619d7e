"""The port's CRUSH (`ceph_tpu_torch/crush`) against the JAX package's.

The hashes (`crush_hash32`, `crush_hash32_2`, `crush_hash32_3`,
`str_hash`), the fixed-point ln table, straw2 bucket choice and whole-rule
placement (`firstn` and `indep`, host and osd failure domains) over
seeded trees, CRUSH weights and reweights must agree exactly, and a
CrushWrapper must encode to the same bytes and decode back."""

import numpy as np
import pytest

from ceph_tpu import crush as jcrush
from ceph_tpu.common.encoding import Decoder as JDecoder, Encoder as JEncoder
from ceph_tpu.crush import crush as jcore

from ceph_tpu_torch import crush as tcrush
from ceph_tpu_torch.common.encoding import Decoder as TDecoder, Encoder as TEncoder
from ceph_tpu_torch.crush import crush as tcore

SEEDS = (0, 1, 2, 3)


def test_hashes_equal_over_seeded_inputs():
    rng = np.random.default_rng(7)
    words = [int(w) for w in rng.integers(0, 1 << 32, size=(3000, 3), dtype=np.uint64).ravel()]
    for a, b, c in zip(words[0::3], words[1::3], words[2::3]):
        assert tcrush.crush_hash32(a) == jcrush.crush_hash32(a)
        assert tcrush.crush_hash32_2(a, b) == jcrush.crush_hash32_2(a, b)
        assert tcrush.crush_hash32_3(a, b, c) == jcrush.crush_hash32_3(a, b, c)
    for n in range(200):
        name = f"rbd_data.{n:x}.{n * 7919:016x}"
        assert tcrush.str_hash(name) == jcrush.str_hash(name)
        assert tcrush.str_hash(name.encode()) == jcrush.str_hash(name.encode())
    assert tcrush.str_hash("") == jcrush.str_hash("")


def test_ln_table_and_constants_equal():
    assert tcore.LN16 == jcore.LN16
    assert (tcore.WEIGHT_ONE, tcore.CRUSH_ITEM_NONE) == (jcore.WEIGHT_ONE, jcore.CRUSH_ITEM_NONE)
    assert tcore.tdiv(-7, 2) == jcore.tdiv(-7, 2) == -3


@pytest.mark.parametrize("seed", SEEDS)
def test_straw2_bucket_choice_equal(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(2, 12))
    weights = [int(w) for w in rng.integers(1, 4 * 0x10000, size=n)]
    tb = tcore.Bucket(id=-1, type_id=1, alg="straw2", items=list(range(n)), weights=weights)
    jb = jcore.Bucket(id=-1, type_id=1, alg="straw2", items=list(range(n)), weights=weights)
    for x in range(2000):
        r = x % 5
        assert tcore.bucket_choose(tb, x, r) == jcore.bucket_choose(jb, x, r)


def _wrappers(seed):
    """The same random tree built through both packages' CrushWrapper:
    hosts of 1-4 OSDs with random CRUSH weights, a replicated (firstn)
    and an EC (indep) rule at host level and one of each at osd level."""
    rng = np.random.default_rng(seed)
    per_host = [int(p) for p in rng.integers(1, 5, size=int(rng.integers(3, 9)))]
    weights = [float(w) for w in rng.choice([0.5, 1.0, 1.0, 2.0, 3.5], size=sum(per_host))]
    out = []
    for mod in (tcrush, jcrush):
        cw = mod.CrushWrapper()
        root = cw.add_bucket("default", "root")
        osd = 0
        for h, count in enumerate(per_host):
            hid = cw.add_bucket(f"host{h}", "host")
            for _ in range(count):
                cw.add_item(hid, osd, weights[osd])
                osd += 1
            cw.add_item(root, hid, sum(weights[osd - count:osd]))
        rules = [cw.add_simple_rule("rep", failure_domain="host", mode="firstn"),
                 cw.add_simple_rule("ec", failure_domain="host", mode="indep"),
                 cw.add_simple_rule("rep_osd", failure_domain="osd", mode="firstn"),
                 cw.add_simple_rule("ec_osd", failure_domain="osd", mode="indep")]
        out.append((cw, rules))
    return out, sum(per_host), rng


@pytest.mark.parametrize("seed", SEEDS)
def test_rule_placement_equal_with_reweights(seed):
    ((tcw, trules), (jcw, jrules)), n_osds, rng = _wrappers(seed)
    assert trules == jrules
    reweight_sets = [None]
    for _ in range(2):
        rew = {o: 0x10000 for o in range(n_osds)}
        for o in rng.choice(n_osds, size=min(2, n_osds), replace=False):
            rew[int(o)] = int(rng.choice([0, 0x8000, 0x4000]))
        reweight_sets.append(rew)
    for rule in trules:
        for size in (3, 6):
            for rew in reweight_sets:
                for x in range(0, 96, 4):
                    pps = tcrush.crush_hash32_2(x, seed + 1)
                    got = tcw.do_rule(rule, pps, size, rew)
                    want = jcw.do_rule(rule, pps, size, rew)
                    assert got == want, (rule, size, x, rew)


@pytest.mark.parametrize("seed", SEEDS)
def test_wrapper_encoding_equal_and_round_trips(seed):
    ((tcw, _tr), (jcw, _jr)), n_osds, _rng = _wrappers(seed)
    tenc, jenc = TEncoder(), JEncoder()
    tcw.encode(tenc)
    jcw.encode(jenc)
    blob, jblob = tenc.tobytes(), jenc.tobytes()
    assert blob == jblob
    back = tcrush.CrushWrapper.decode(TDecoder(jblob))
    jback = jcrush.CrushWrapper.decode(JDecoder(blob))
    for rule in back.map.rules:
        for x in range(64):
            assert back.do_rule(rule, x, 4) == jback.do_rule(rule, x, 4) == tcw.do_rule(rule, x, 4)
    assert back.bucket_id("host0") == tcw.bucket_id("host0")
    assert back.rule_id("ec_osd") == jback.rule_id("ec_osd")
