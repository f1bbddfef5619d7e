"""The golden corpus through the port: every stored `tests/corpus` fixture
(clay, the four jerasure techniques, lrc, shec, the two of plugin `tpu`,
and xor) is encoded and decoded by the port's plugin (`device="cpu"`), and
the matrix-code fixtures also through the EC aggregators; every chunk must
equal the stored bytes (the fixtures were written by the JAX package's
plugins)."""

import itertools
import os

import numpy as np
import pytest

from ceph_tpu_torch.codec import registry
from ceph_tpu_torch.codec.interface import EcError
from ceph_tpu_torch.codec.matrix_codec import DecodeAggregator, EncodeAggregator

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

BASE = os.path.join(os.path.dirname(__file__), "corpus")
FIXTURES = sorted(os.listdir(BASE))
# the fixtures of MDS matrix codes, which the EC aggregators take
MATRIX_FIXTURES = [
    "plugin=jerasure stripe-width=4096 k=4 m=2 technique=reed_sol_van",
    "plugin=tpu stripe-width=4096 k=8 m=3 technique=cauchy",
    "plugin=tpu stripe-width=4096 k=10 m=4 technique=reed_sol_van",
]


def _load(name):
    directory = os.path.join(BASE, name)
    plugin = name.split()[0].split("=", 1)[1]
    profile = dict(kv.split("=", 1) for kv in name.split()[2:])
    ec = registry.instance().factory(plugin, dict(profile), device="cpu")
    n = ec.get_chunk_count()
    with open(os.path.join(directory, "content"), "rb") as f:
        content = f.read()
    chunks = {}
    for i in range(n):
        with open(os.path.join(directory, f"chunk.{i}"), "rb") as f:
            chunks[i] = np.frombuffer(f.read(), dtype=np.uint8)
    return ec, content, chunks


@pytest.mark.parametrize("name", FIXTURES)
def test_encode_equals_stored_chunks(name):
    ec, content, chunks = _load(name)
    got = ec.encode(set(chunks), content)
    assert set(got) == set(chunks)
    for i, want in chunks.items():
        assert np.array_equal(got[i], want), i


@pytest.mark.parametrize("name", FIXTURES)
def test_decode_equals_stored_chunks(name):
    """Every erasure set of size 1 and 2, and one of size m, that the
    codec's minimum_to_decode accepts (all of them for an MDS code)."""
    ec, _content, chunks = _load(name)
    n, m = ec.get_chunk_count(), ec.get_coding_chunk_count()
    sets = [set(e) for r in (1, 2) for e in itertools.combinations(range(n), r)]
    sets.append(set(range(n - m, n)) if m % 2 else set(range(m)))
    decoded = 0
    for erasures in sets:
        try:
            ec.minimum_to_decode(erasures, set(range(n)) - erasures)
        except EcError:
            continue
        decoded += 1
        avail = {i: c for i, c in chunks.items() if i not in erasures}
        got = ec.decode(erasures, avail, len(chunks[0]))
        for e in erasures:
            assert np.array_equal(got[e], chunks[e]), (sorted(erasures), e)
    assert decoded >= n


@pytest.mark.parametrize("name", MATRIX_FIXTURES)
def test_aggregated_encode_and_decode_equal_stored_chunks(name):
    ec, _content, chunks = _load(name)
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    full = np.stack([chunks[i] for i in range(n)])[None]  # one stripe: (1, n, L)
    enc = EncodeAggregator(window=4)
    dec = DecodeAggregator(window=4)
    enc_tickets = [enc.submit(ec, full[:, :k]) for _ in range(3)]
    patterns = [[0], [k], [1, n - 1], list(range(n - k))]
    dec_tickets = [(p, dec.submit(ec, p, full[:, ec.decode_index(p)])) for p in patterns]
    for t in enc_tickets:
        assert np.array_equal(t.result(), full[:, k:])
    for p, t in dec_tickets:
        assert np.array_equal(t.result(), full[:, p]), p
    assert enc.perf.get("launches") == 1 and enc.perf.get("flush_reap") == 1
