"""The port's `tpu` plugin, end to end on the CPU, held byte for byte against
the JAX package's `tpu` plugin."""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.codec import registry as jregistry

from ceph_tpu_torch.codec import registry
from ceph_tpu_torch.codec.interface import EcError
from ceph_tpu_torch.codec.matrix_codec import dense_aligned
from ceph_tpu_torch.codec.rs import ErasureCodeTpuRs

GEOMETRIES = [(4, 2, "reed_sol_van"), (4, 2, "cauchy"),
              (8, 3, "reed_sol_van"), (8, 3, "cauchy")]


def _pair(profile):
    ours = registry.instance().factory("tpu", dict(profile), device="cpu")
    ref = jregistry.instance().factory("tpu", dict(profile))
    return ours, ref


def _object(k, seed, extra=77):
    """An object that is not a multiple of k * 128 bytes (exercises padding)."""
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, k * 128 * 2 + extra, dtype=np.uint8).tobytes()


@pytest.mark.parametrize("k,m,technique", GEOMETRIES)
def test_encode_matches_reference(k, m, technique):
    profile = {"k": str(k), "m": str(m), "technique": technique}
    ours, ref = _pair(profile)
    assert np.array_equal(ours.distribution_matrix(), ref.distribution_matrix())
    for extra in (1, 77, 1000):
        obj = _object(k, k * m + extra, extra)
        got = ours.encode(set(range(k + m)), obj)
        want = ref.encode(set(range(k + m)), obj)
        assert set(got) == set(want)
        for i in want:
            assert got[i].dtype == np.uint8
            assert np.array_equal(got[i], np.asarray(want[i])), (extra, i)
        assert len(got[0]) % 128 == 0


@pytest.mark.parametrize("k,m,technique", GEOMETRIES)
def test_decode_every_erasure_set(k, m, technique):
    """Every erasure set of size <= m is rebuilt to the reference's bytes;
    a sample of sets also goes through the reference's decode."""
    profile = {"k": str(k), "m": str(m), "technique": technique}
    ours, ref = _pair(profile)
    n = k + m
    obj = _object(k, 5 * k + m)
    enc = {i: np.asarray(c) for i, c in ref.encode(set(range(n)), obj).items()}
    sets = [e for r in range(1, m + 1) for e in itertools.combinations(range(n), r)]
    for erasures in sets:
        avail = {i: enc[i] for i in range(n) if i not in erasures}
        dec = ours.decode(set(erasures), avail)
        for e in erasures:
            assert np.array_equal(dec[e], enc[e]), erasures
    for erasures in sets[:: max(1, len(sets) // 6)]:
        avail = {i: enc[i] for i in range(n) if i not in erasures}
        want = ref.decode(set(erasures), avail)
        got = ours.decode(set(erasures), avail)
        for e in erasures:
            assert np.array_equal(got[e], np.asarray(want[e])), erasures


@pytest.mark.parametrize("k,m,technique", GEOMETRIES)
def test_decode_concat_matches_reference(k, m, technique):
    ours, ref = _pair({"k": str(k), "m": str(m), "technique": technique})
    n = k + m
    obj = _object(k, 9 * k + m, extra=300)
    enc = {i: np.asarray(c) for i, c in ref.encode(set(range(n)), obj).items()}
    for erasures in ((), (0,), (1, n - 1), tuple(range(m))):
        avail = {i: enc[i] for i in range(n) if i not in erasures}
        got = ours.decode_concat(avail)
        assert np.array_equal(got, np.asarray(ref.decode_concat(avail)))
        assert got[: len(obj)].tobytes() == obj


def test_minimum_to_decode_matches_reference():
    ours, ref = _pair({"k": "4", "m": "2"})
    cases = [({0, 1}, {0, 1, 2, 3, 4, 5}), ({0}, {1, 2, 3, 4, 5}),
             ({0, 5}, {1, 2, 3, 4}), ({2}, {0, 2})]
    for want, avail in cases:
        assert ours.minimum_to_decode(want, avail) == ref.minimum_to_decode(want, avail)
        assert ours.minimum_to_decode_with_cost(
            want, dict.fromkeys(avail, 1)
        ) == ref.minimum_to_decode_with_cost(want, dict.fromkeys(avail, 1))
    with pytest.raises(EcError) as e:
        ours.minimum_to_decode({0}, {1, 2, 3})
    assert e.value.errno == -5  # EIO


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy"])
def test_single_parity_xor_path(technique):
    """m == 1: parity is the XOR of the data chunks whatever the technique."""
    ours, ref = _pair({"k": "4", "m": "1", "technique": technique})
    obj = _object(4, 41)
    got = ours.encode(set(range(5)), obj)
    want = ref.encode(set(range(5)), obj)
    data = np.stack([got[i] for i in range(4)])
    assert np.array_equal(got[4], np.bitwise_xor.reduce(data, axis=0))
    for i in range(5):
        assert np.array_equal(got[i], np.asarray(want[i]))
    for e in range(5):
        avail = {i: got[i] for i in range(5) if i != e}
        assert np.array_equal(ours.decode({e}, avail)[e], got[e])


def test_mapping_remaps_chunks():
    profile = {"k": "4", "m": "2", "mapping": "_DD_DD"}
    ours, ref = _pair(profile)
    assert ours.get_chunk_mapping() == ref.get_chunk_mapping() == [1, 2, 4, 5, 0, 3]
    obj = _object(4, 77)
    got = ours.encode(set(range(6)), obj)
    want = ref.encode(set(range(6)), obj)
    for i in range(6):
        assert np.array_equal(got[i], np.asarray(want[i]))
    for erasures in ((0,), (1,), (0, 3), (2, 5)):
        avail = {i: got[i] for i in range(6) if i not in erasures}
        dec = ours.decode(set(erasures), avail)
        for e in erasures:
            assert np.array_equal(dec[e], got[e])
        assert ours.decode_concat(avail)[: len(obj)].tobytes() == obj


@pytest.mark.parametrize("L", [128, 200])
def test_encode_array_tiers_match_reference(L):
    """Aligned chunks take the SWAR wrapper (its plain version on the CPU),
    unaligned ones xor_matmul; both equal the reference and the oracle."""
    ours, ref = _pair({"k": "8", "m": "3", "technique": "cauchy"})
    rng = np.random.default_rng(L)
    data = rng.integers(0, 256, (3, 8, L), dtype=np.uint8)
    got = ours.encode_array(data)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), np.asarray(ref.encode_array(data)))
    assert np.array_equal(got.numpy(), ours.encode_array_host(data))
    erasures = [0, 9]
    idx = ours.decode_index(erasures)
    full = np.concatenate([data, got.numpy()], axis=1)
    rec = ours.decode_array(erasures, full[:, idx])
    assert np.array_equal(rec.numpy(), full[:, erasures])
    assert np.array_equal(ours.decode_array_host(erasures, full[:, idx]), full[:, erasures])


def test_registry_error_contract():
    reg = registry.instance()
    with pytest.raises(EcError) as e:
        reg.factory("no_such_plugin", {"k": "2", "m": "1"}, device="cpu")
    assert e.value.errno == -2  # ENOENT
    with pytest.raises(EcError) as e:
        reg.add("tpu", reg.load("tpu"))
    assert e.value.errno == -17  # EEXIST
    reg.preload("tpu, tpu")
    profile = {"k": "4", "m": "2"}
    ec = reg.factory("tpu", profile, device="cpu")
    assert ec.get_profile() == profile
    # defaults are written back into the profile, as in the reference
    empty: dict = {}
    ec = reg.factory("tpu", empty, device="cpu")
    assert empty == {"k": "7", "m": "3"} and ec.get_profile() == empty
    with pytest.raises(EcError) as e:
        reg.factory("tpu", {"k": "40", "m": "3"}, device="cpu")
    assert e.value.errno == -22  # EINVAL: Vandermonde envelope
    with pytest.raises(EcError):
        reg.factory("tpu", {"k": "4", "m": "2", "technique": "liberation"}, device="cpu")


@pytest.mark.parametrize("k,m,technique", GEOMETRIES + [(4, 1, "cauchy")])
def test_from_distribution_matrix(k, m, technique):
    """A codec built from the JAX package's matrix codes the same bytes."""
    ref = jregistry.instance().factory(
        "tpu", {"k": str(k), "m": str(m), "technique": technique}
    )
    ours = ErasureCodeTpuRs.from_distribution_matrix(
        np.asarray(ref.distribution_matrix()), k, m, device="cpu"
    )
    obj = _object(k, 3 * k + m)
    got = ours.encode(set(range(k + m)), obj)
    want = ref.encode(set(range(k + m)), obj)
    for i in range(k + m):
        assert np.array_equal(got[i], np.asarray(want[i]))
    avail = {i: got[i] for i in range(k + m) if i not in range(m)}
    assert ours.decode_concat(avail)[: len(obj)].tobytes() == obj
    with pytest.raises(EcError):
        ErasureCodeTpuRs.from_distribution_matrix(
            np.asarray(ref.distribution_matrix())[::-1], k, m, device="cpu"
        )


def test_no_cuda_and_no_cpu_request_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        registry.instance().factory("tpu", {"k": "8", "m": "3"})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ErasureCodeTpuRs(device="cuda")
    assert ErasureCodeTpuRs(device="cpu").device == torch.device("cpu")


def _views():
    """A strided view (data chunks of whole codewords) and a dense view one
    byte past an aligned base, as a caller may slice them."""
    cw = torch.from_numpy(np.random.default_rng(11).integers(0, 256, (2, 11, 4096), dtype=np.uint8))
    buf = torch.from_numpy(np.random.default_rng(12).integers(0, 256, 4113, dtype=np.uint8))
    return {"strided": cw[:, :8], "misaligned": buf[1:4097]}


@pytest.mark.parametrize("kind", ["strided", "misaligned"])
def test_dense_aligned_copies_what_the_kernel_refuses(kind):
    view = _views()[kind]
    assert not view.is_contiguous() or view.data_ptr() % 16
    got = dense_aligned(view)
    assert got.is_contiguous() and got.data_ptr() % 16 == 0
    assert got.data_ptr() != view.data_ptr() and torch.equal(got, view)


def test_dense_aligned_passes_an_aligned_tensor_through():
    dense = torch.zeros((2, 8, 4096), dtype=torch.uint8)
    assert dense.data_ptr() % 16 == 0
    assert dense_aligned(dense) is dense


@pytest.mark.parametrize("kind", ["strided", "misaligned"])
def test_encode_array_of_a_view_matches_reference(kind):
    """The case of the reference's verify, which slices codewords: the
    port codes a strided or misaligned view as the reference codes it."""
    ours, ref = _pair({"k": "8", "m": "3"})
    view = _views()[kind]
    if kind == "misaligned":
        view = view.view(1, 8, 512)
    got = ours.encode_array(view)
    want = np.asarray(ref.encode_array_host(view.numpy()))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    idx = ours.decode_index([0, 9])
    full = torch.cat([view, got], dim=-2)
    rec = ours.decode_array([0, 9], full[..., idx, :])
    assert np.array_equal(rec.numpy(), full[..., [0, 9], :].numpy())
