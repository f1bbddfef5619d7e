"""The port's codec plugins against the JAX package's, on the CPU.

For each plugin and profile of the reference's test_jerasure.py,
test_shec.py, test_lrc.py and test_clay.py (and the `isa` alias and the
`xor` example), built through each package's registry (the port's with
`device="cpu"`): the encoded chunks, every erasure pattern up to m that
the reference's `minimum_to_decode` accepts (decoded bytes, or the same
errno where the reference's decode refuses), the
`minimum_to_decode` answers themselves, and the profile after the
round trip must be the reference's; every profile the reference rejects
the port rejects with the same errno.  One parametrised test per
property, so each case counts.  The reference runs at dispatch width 1
(its tests run on an 8-device CPU mesh)."""

import itertools

import numpy as np
import pytest

from ceph_tpu.codec import registry as jregistry
from ceph_tpu.codec.interface import EcError as JEcError
from ceph_tpu.parallel import dispatch as jshard

from ceph_tpu_torch.codec import registry
from ceph_tpu_torch.codec.interface import EcError

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _pin_reference():
    settings = jshard.settings()
    jshard.configure(devices=1)
    yield
    jshard.configure(*settings)


def _bm(technique, k, w, packetsize=8, **extra):
    return ("jerasure", {"technique": technique, "k": str(k), "m": "2", "w": str(w),
                         "packetsize": str(packetsize), **extra})


PROFILES = {
    # test_jerasure.py: the matrix techniques, defaults included
    "jerasure-reed_sol_van-4-2": ("jerasure", {"k": "4", "m": "2"}),
    "jerasure-reed_sol_van-default": ("jerasure", {}),
    "jerasure-reed_sol_r6_op-4-2": ("jerasure", {"technique": "reed_sol_r6_op", "k": "4",
                                                 "m": "2"}),
    "jerasure-cauchy_orig-4-2": ("jerasure", {"technique": "cauchy_orig", "k": "4", "m": "2"}),
    "jerasure-cauchy_good-4-2": ("jerasure", {"technique": "cauchy_good", "k": "4", "m": "2"}),
    "jerasure-cauchy_good-6-3": ("jerasure", {"technique": "cauchy_good", "k": "6", "m": "3",
                                              "packetsize": "32"}),
    # test_jerasure.py: the bit-matrix techniques
    "liberation-2-3": _bm("liberation", 2, 3),
    "liberation-5-5": _bm("liberation", 5, 5),
    "liberation-7-7": _bm("liberation", 7, 7),
    "liberation-4-7-p32": _bm("liberation", 4, 7, packetsize=32),
    "liberation-4-5-mapped": _bm("liberation", 4, 5, mapping="_DDDD_"),
    "blaum_roth-4-4": _bm("blaum_roth", 4, 4),
    "blaum_roth-6-6": _bm("blaum_roth", 6, 6),
    "blaum_roth-7-10": _bm("blaum_roth", 7, 10),
    "blaum_roth-3-7-legacy": _bm("blaum_roth", 3, 7),
    "liber8tion-2-8": _bm("liber8tion", 2, 8),
    "liber8tion-6-8": _bm("liber8tion", 6, 8),
    "liber8tion-8-8": _bm("liber8tion", 8, 8),
    # the isa alias and the xor example
    "isa-8-3": ("isa", {"k": "8", "m": "3"}),
    "isa-4-2-cauchy": ("isa", {"k": "4", "m": "2", "technique": "cauchy"}),
    "xor-4": ("xor", {"k": "4"}),
    "xor-default": ("xor", {}),
    # test_shec.py
    "shec-4-3-2": ("shec", {"k": "4", "m": "3", "c": "2"}),
    "shec-4-3-2-single": ("shec", {"k": "4", "m": "3", "c": "2", "technique": "single"}),
    "shec-6-3-2": ("shec", {"k": "6", "m": "3", "c": "2"}),
    "shec-default": ("shec", {}),
    # test_lrc.py
    "lrc-4-2-3": ("lrc", {"k": "4", "m": "2", "l": "3"}),
    "lrc-6-3-3": ("lrc", {"k": "6", "m": "3", "l": "3"}),
    "lrc-layers": ("lrc", {
        "mapping": "DD__DD__",
        "layers": '[ [ "DDc_DDc_", "" ], [ "DDDc____", "" ], [ "____DDDc", "" ] ]',
    }),
    "lrc-layers-plugin-spec": ("lrc", {
        "mapping": "DD__DD__",
        "layers": ('[ [ "DDc_DDc_", "plugin=tpu technique=cauchy" ],'
                   '  [ "DDDc____", "" ], [ "____DDDc", "" ] ]'),
    }),
    # test_clay.py
    "clay-4-2-5": ("clay", {"k": "4", "m": "2", "d": "5"}),
    "clay-3-3-5": ("clay", {"k": "3", "m": "3", "d": "5"}),
    "clay-4-3-6": ("clay", {"k": "4", "m": "3", "d": "6"}),
    "clay-4-2-default-d": ("clay", {"k": "4", "m": "2"}),
    "clay-4-2-isa-cauchy": ("clay", {"k": "4", "m": "2", "scalar_mds": "isa",
                                     "technique": "cauchy"}),
}

REJECTED = {
    "jerasure-w16": ("jerasure", {"k": "4", "m": "2", "w": "16"}),
    "jerasure-r6-m3": ("jerasure", {"technique": "reed_sol_r6_op", "k": "4", "m": "3"}),
    "jerasure-k+m>256": ("jerasure", {"k": "250", "m": "8"}),
    "jerasure-unknown-technique": ("jerasure", {"technique": "nope", "k": "4", "m": "2"}),
    "jerasure-k-not-int": ("jerasure", {"k": "four", "m": "2"}),
    "liberation-m3": ("jerasure", {"technique": "liberation", "k": "3", "m": "3", "w": "5"}),
    "liberation-w6": ("jerasure", {"technique": "liberation", "k": "3", "m": "2", "w": "6"}),
    "liberation-k>w": ("jerasure", {"technique": "liberation", "k": "6", "m": "2", "w": "5"}),
    "blaum_roth-w8": ("jerasure", {"technique": "blaum_roth", "k": "3", "m": "2", "w": "8"}),
    "liber8tion-w7": ("jerasure", {"technique": "liber8tion", "k": "3", "m": "2", "w": "7"}),
    "liberation-packetsize6": ("jerasure", {"technique": "liberation", "k": "3", "m": "2",
                                            "w": "5", "packetsize": "6"}),
    "isa-van-m5": ("isa", {"k": "4", "m": "5"}),
    "xor-k1": ("xor", {"k": "1"}),
    "shec-k13": ("shec", {"k": "13", "m": "3", "c": "2"}),
    "shec-k+m>20": ("shec", {"k": "12", "m": "9", "c": "2"}),
    "shec-c>m": ("shec", {"k": "4", "m": "3", "c": "4"}),
    "shec-m>k": ("shec", {"k": "3", "m": "4", "c": "2"}),
    "shec-c-missing": ("shec", {"k": "4", "m": "3"}),
    "shec-technique": ("shec", {"k": "4", "m": "3", "c": "2", "technique": "nope"}),
    "lrc-l4": ("lrc", {"k": "4", "m": "2", "l": "4"}),
    "lrc-l-missing": ("lrc", {"k": "4", "m": "2"}),
    "lrc-mapping-with-kml": ("lrc", {"k": "4", "m": "2", "l": "3", "mapping": "x"}),
    "lrc-no-layers": ("lrc", {"mapping": "DD__"}),
    "lrc-bad-layer-length": ("lrc", {"mapping": "DD_", "layers": '[ [ "DDc_", "" ] ]'}),
    "clay-d3": ("clay", {"k": "4", "m": "2", "d": "3"}),
    "clay-d6": ("clay", {"k": "4", "m": "2", "d": "6"}),
    "clay-shec": ("clay", {"k": "4", "m": "2", "scalar_mds": "shec"}),
    "clay-scalar-unknown": ("clay", {"k": "4", "m": "2", "scalar_mds": "nope"}),
    "unknown-plugin": ("nope", {"k": "4", "m": "2"}),
}


_CODECS: dict = {}


def codecs(name):
    """(reference codec, port codec) for a PROFILES entry, each made through
    its package's registry from its own copy of the profile."""
    if name not in _CODECS:
        plugin, prof = PROFILES[name]
        ref = jregistry.instance().factory(plugin, dict(prof))
        ours = registry.instance().factory(plugin, dict(prof), device="cpu")
        _CODECS[name] = (ref, ours)
    return _CODECS[name]


def _payload(ec, seed, stripes=2):
    size = ec.get_chunk_size(1) * ec.get_data_chunk_count() * stripes - 17
    return np.random.default_rng(seed).integers(0, 256, size, dtype=np.uint8).tobytes()


def _patterns(ref):
    """Every erasure set of size 1..m that the reference can decode."""
    n, m = ref.get_chunk_count(), ref.get_coding_chunk_count()
    out = []
    for r in range(1, m + 1):
        for er in itertools.combinations(range(n), r):
            try:
                ref.minimum_to_decode(set(er), set(range(n)) - set(er))
            except JEcError:
                continue
            out.append(set(er))
    return out


@pytest.mark.parametrize("name", PROFILES)
def test_encode_matches_reference(name):
    ref, ours = codecs(name)
    n = ref.get_chunk_count()
    assert ours.get_chunk_count() == n
    assert ours.get_data_chunk_count() == ref.get_data_chunk_count()
    assert ours.get_sub_chunk_count() == ref.get_sub_chunk_count()
    for seed, stripes in ((1, 1), (2, 3)):
        data = _payload(ref, seed, stripes)
        assert ours.get_chunk_size(len(data)) == ref.get_chunk_size(len(data))
        want, got = ref.encode(set(range(n)), data), ours.encode(set(range(n)), data)
        assert set(got) == set(want)
        for i in want:
            assert np.array_equal(got[i], np.asarray(want[i])), (name, i)


@pytest.mark.parametrize("name", PROFILES)
def test_every_decodable_pattern_matches_reference(name):
    ref, ours = codecs(name)
    n = ref.get_chunk_count()
    enc = ref.encode(set(range(n)), _payload(ref, 3))
    enc = {i: np.asarray(c) for i, c in enc.items()}
    patterns = _patterns(ref)
    assert patterns
    for er in patterns:
        avail = {i: c for i, c in enc.items() if i not in er}
        try:
            want = ref.decode(er, dict(avail), len(enc[0]))
        except JEcError as e:
            # blaum_roth's legacy w = 7 decodes single erasures only
            with pytest.raises(EcError) as got_err:
                ours.decode(er, dict(avail), len(enc[0]))
            assert got_err.value.errno == e.errno, (name, sorted(er))
            continue
        got = ours.decode(er, dict(avail), len(enc[0]))
        for e in er:
            assert np.array_equal(got[e], np.asarray(want[e])), (name, sorted(er), e)
            assert np.array_equal(got[e], enc[e]), (name, sorted(er), e)


@pytest.mark.parametrize("name", PROFILES)
def test_minimum_to_decode_matches_reference(name):
    ref, ours = codecs(name)
    n = ref.get_chunk_count()
    for r in range(0, ref.get_coding_chunk_count() + 2):
        for er in itertools.combinations(range(n), r):
            avail = set(range(n)) - set(er)
            for want in ({min(er)} if er else {0}, set(er) or {n - 1}, set(range(n))):
                try:
                    expect = ("ok", dict(ref.minimum_to_decode(set(want), set(avail))))
                except JEcError as e:
                    expect = ("raise", e.errno)
                try:
                    got = ("ok", dict(ours.minimum_to_decode(set(want), set(avail))))
                except EcError as e:
                    got = ("raise", e.errno)
                assert got == expect, (name, sorted(want), sorted(avail))


@pytest.mark.parametrize("name", PROFILES)
def test_profile_round_trip_matches_reference(name):
    """The profile each registry hands back (defaults filled in, kml keys
    hidden) is the reference's, and the device is no profile key."""
    ref, ours = codecs(name)
    assert ours.get_profile() == ref.get_profile()
    assert "device" not in ours.get_profile()
    assert ours.device.type == "cpu"
    assert ours.get_chunk_mapping() == ref.get_chunk_mapping()


@pytest.mark.parametrize("name", REJECTED)
def test_rejected_profile_errno_matches_reference(name):
    plugin, prof = REJECTED[name]
    with pytest.raises(JEcError) as want:
        jregistry.instance().factory(plugin, dict(prof))
    with pytest.raises(EcError) as got:
        registry.instance().factory(plugin, dict(prof), device="cpu")
    assert got.value.errno == want.value.errno


@pytest.mark.parametrize("name", [n for n in PROFILES if n.startswith("clay")])
def test_clay_fragment_repair_matches_reference(name):
    """CLAY's single-chunk repair from d helpers' sub-chunk fragments, one
    stripe at a time (`decode` with the true chunk size) and all stripes
    in one batch (`decode_fragments_batch`), gives the reference's bytes
    and the lost chunk."""
    ref, ours = codecs(name)
    n, stripes = ref.get_chunk_count(), 3
    cs = ref.get_chunk_size(1)
    # each stripe is its own codeword, as the stripe layer encodes it
    coded = [ref.encode(set(range(n)), _payload(ref, 5 + s, 1)) for s in range(stripes)]
    enc = {i: np.concatenate([np.asarray(c[i]) for c in coded]) for i in range(n)}
    sc = cs // ref.get_sub_chunk_count()
    for lost in range(n):
        avail = set(range(n)) - {lost}
        minimum = ours.minimum_to_decode({lost}, avail)
        assert minimum == ref.minimum_to_decode({lost}, avail)
        frags = {
            node: np.stack([
                np.concatenate([enc[node][s * cs + o * sc : s * cs + (o + c) * sc]
                                for o, c in runs])
                for s in range(stripes)
            ])
            for node, runs in minimum.items()
        }
        got = ours.decode_fragments_batch({lost}, frags, cs)[lost]
        want = np.asarray(ref.decode_fragments_batch({lost}, frags, cs)[lost])
        assert np.array_equal(got, want) and got.tobytes() == enc[lost].tobytes(), lost
        one = ours.decode({lost}, {i: f[1] for i, f in frags.items()}, chunk_size=cs)[lost]
        assert np.array_equal(one, enc[lost][cs : 2 * cs]), lost
