"""The port's GF(2) bit-matrix machinery against the JAX package's, on the CPU.

`gf/gf2.py`'s matrices (liberation, blaum_roth, liber8tion and the RAID-6
assembly), inverses and products must equal the reference's copies;
`PLAN_CACHE.gf2_decode_plan` must give the reference's decode matrices; and
`gf2_plane_matmul_reference` — and the wrapper, which takes it for a CPU
tensor — must equal the JAX `gf2_plane_matmul` byte for byte on seeded
numpy planes, over the matrices and shapes chip_smoke.py's phase 10a holds
the kernel to on the card (scaled to CPU sizes), a strided view among
them."""

import itertools

import numpy as np
import pytest
import torch

from ceph_tpu.codec.matrix_codec import PLAN_CACHE as J_PLAN_CACHE
from ceph_tpu.gf import gf2 as jgf2
from ceph_tpu.ops import xor_mm as jxor

from ceph_tpu_torch.codec.matrix_codec import PLAN_CACHE
from ceph_tpu_torch.gf import gf2
from ceph_tpu_torch.ops import xor_mm

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

LIBERATION = [(k, w) for w in (3, 5, 7, 11) for k in range(1, w + 1)]
BLAUM_ROTH = [(k, w) for w in (4, 6, 7, 10, 12) for k in range(1, w + 1)]
LIBER8TION = list(range(1, 9))


@pytest.mark.parametrize("k,w", LIBERATION)
def test_liberation_bitmatrix_matches_reference(k, w):
    assert np.array_equal(gf2.liberation_bitmatrix(k, w), jgf2.liberation_bitmatrix(k, w))


@pytest.mark.parametrize("k,w", BLAUM_ROTH)
def test_blaum_roth_bitmatrix_matches_reference(k, w):
    assert np.array_equal(gf2.blaum_roth_bitmatrix(k, w), jgf2.blaum_roth_bitmatrix(k, w))


@pytest.mark.parametrize("k", LIBER8TION)
def test_liber8tion_bitmatrix_matches_reference(k):
    assert np.array_equal(gf2.liber8tion_bitmatrix(k), jgf2.liber8tion_bitmatrix(k))


@pytest.mark.parametrize("call", [
    lambda g: g.liberation_bitmatrix(3, 4), lambda g: g.liberation_bitmatrix(6, 5),
    lambda g: g.liberation_bitmatrix(2, 2), lambda g: g.blaum_roth_bitmatrix(3, 8),
    lambda g: g.blaum_roth_bitmatrix(9, 7), lambda g: g.liber8tion_bitmatrix(9),
], ids=["liberation-w4", "liberation-k>w", "liberation-w2", "blaum_roth-w8",
        "blaum_roth-k>w", "liber8tion-k9"])
def test_rejected_parameters_match_reference(call):
    with pytest.raises(ValueError) as want:
        call(jgf2)
    with pytest.raises(ValueError) as got:
        call(gf2)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("n,seed", [(n, s) for n in (1, 2, 5, 14, 16, 49, 64) for s in (0, 1)])
def test_gf2_inv_and_matmul_match_reference(n, seed):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 2, (n, n), dtype=np.uint8)
    inv, jinv = gf2.gf2_inv(mat), jgf2.gf2_inv(mat)
    assert (inv is None) == (jinv is None)
    if inv is not None:
        assert np.array_equal(inv, jinv)
        assert np.array_equal(gf2.gf2_matmul(mat, inv), np.eye(n, dtype=np.uint8))
    other = rng.integers(0, 2, (n, 3), dtype=np.uint8)
    assert np.array_equal(gf2.gf2_matmul(mat, other), jgf2.gf2_matmul(mat, other))
    assert [gf2.is_prime(i) for i in range(40)] == [jgf2.is_prime(i) for i in range(40)]


def _decode_plans(k, w, bm, jbm):
    n = k + 2
    for r in (1, 2):
        for er in itertools.combinations(range(n), r):
            yield list(er), PLAN_CACHE.gf2_decode_plan(bm, k, w, list(er)), \
                J_PLAN_CACHE.gf2_decode_plan(jbm, k, w, list(er))


@pytest.mark.parametrize("technique,k,w", [("liberation", 4, 7), ("liberation", 7, 7),
                                           ("blaum_roth", 4, 6), ("liber8tion", 8, 8)])
def test_gf2_decode_plan_matches_reference(technique, k, w):
    make = {"liberation": lambda g: g.liberation_bitmatrix(k, w),
            "blaum_roth": lambda g: g.blaum_roth_bitmatrix(k, w),
            "liber8tion": lambda g: g.liber8tion_bitmatrix(k)}[technique]
    for er, (dec, idx), (jdec, jidx) in _decode_plans(k, w, make(gf2), make(jgf2)):
        assert idx == jidx, er
        assert np.array_equal(dec, np.asarray(jdec)), er


def _matrices():
    """Phase 10a's matrices: the encode matrices of liberation (k = 4, 7;
    w = 7), blaum_roth (k = 4, w = 6) and liber8tion (k = 4, 8), and the
    decode plan of every one- and two-erasure pattern of liberation k = 4."""
    out = {
        "liberation-4-7": gf2.liberation_bitmatrix(4, 7),
        "liberation-7-7": gf2.liberation_bitmatrix(7, 7),
        "blaum_roth-4-6": gf2.blaum_roth_bitmatrix(4, 6),
        "liber8tion-4": gf2.liber8tion_bitmatrix(4),
        "liber8tion-8": gf2.liber8tion_bitmatrix(8),
    }
    bm = out["liberation-4-7"]
    for r in (1, 2):
        for er in itertools.combinations(range(6), r):
            dec, _ = PLAN_CACHE.gf2_decode_plan(bm, 4, 7, list(er))
            out[f"liberation-4-7-decode-{'-'.join(map(str, er))}"] = dec
    return out


MATRICES = _matrices()
# (P, S): phase 10a's packet sizes {4, 8, 32, 2048, 2052} and stripe counts
# {1, 3, 256}, at CPU sizes (256 stripes with the short packets only)
SHAPES = [(4, 1), (4, 256), (8, 3), (32, 256), (2048, 1), (2052, 3)]


def _planes(q, P, S, seed):
    return np.random.default_rng(seed).integers(0, 256, (S, q, P), dtype=np.uint8)


@pytest.mark.parametrize("P,S", SHAPES)
@pytest.mark.parametrize("name", list(MATRICES))
def test_plane_matmul_reference_matches_jax(name, P, S):
    bm = MATRICES[name]
    planes = _planes(bm.shape[1], P, S, seed=P + S)
    want = np.asarray(jxor.gf2_plane_matmul(bm, planes))
    got = xor_mm.gf2_plane_matmul_reference(bm, torch.from_numpy(planes))
    assert got.dtype == torch.uint8 and np.array_equal(got.numpy(), want)
    # the wrapper takes the plain version for a CPU tensor, and counts no launch
    launches = xor_mm.gf2_plane_matmul.launches
    assert np.array_equal(xor_mm.gf2_plane_matmul(bm, torch.from_numpy(planes)).numpy(), want)
    assert xor_mm.gf2_plane_matmul.launches == launches


def test_plane_matmul_strided_view_and_lead_axes():
    """A strided (S, Q, P) view (every other plane of a wider batch, and a
    packet slice) and extra lead axes give the JAX package's bytes."""
    bm = MATRICES["liberation-4-7"]
    wide = _planes(2 * bm.shape[1], 40, 3, seed=9)
    view = torch.from_numpy(wide)[:, ::2, 4:36]
    want = np.asarray(jxor.gf2_plane_matmul(bm, np.ascontiguousarray(view.numpy())))
    assert np.array_equal(xor_mm.gf2_plane_matmul(bm, view).numpy(), want)
    lead = _planes(bm.shape[1], 8, 6, seed=10).reshape(2, 3, bm.shape[1], 8)
    want = np.asarray(jxor.gf2_plane_matmul(bm, lead))
    got = xor_mm.gf2_plane_matmul(torch.from_numpy(bm), torch.from_numpy(lead))
    assert got.shape == (2, 3, bm.shape[0], 8) and np.array_equal(got.numpy(), want)


def test_plane_matmul_rejects_misfits():
    bm = MATRICES["liberation-4-7"]
    with pytest.raises(ValueError):
        xor_mm.gf2_plane_matmul(bm, torch.zeros((2, bm.shape[1] + 1, 8), dtype=torch.uint8))
    with pytest.raises(TypeError):
        xor_mm.gf2_plane_matmul(bm, torch.zeros((2, bm.shape[1], 8), dtype=torch.int32))


@pytest.mark.parametrize("k,m", [(4, 2), (8, 3)])
def test_encode_full_matches_reference(k, m):
    from ceph_tpu.gf import expand_matrix, isa_rs_vandermonde_matrix

    bm = expand_matrix(isa_rs_vandermonde_matrix(k, m)[k:])
    data = np.random.default_rng(k).integers(0, 256, (3, k, 64), dtype=np.uint8)
    want = np.asarray(jxor.encode_full(bm, data, k=k, m=m))
    got = xor_mm.encode_full(torch.from_numpy(bm), torch.from_numpy(data), k=k, m=m)
    assert np.array_equal(got.numpy(), want)
