"""The port's numpy GF core and kernel-planning helpers equal the JAX
package's, exactly."""

import numpy as np
import pytest

import ceph_tpu.gf as jgf
from ceph_tpu.ops import pallas_gf as jpallas

import ceph_tpu_torch.gf as tgf
from ceph_tpu_torch.ops import swar_gf as tswar

# k x m grid inside the Vandermonde MDS envelope (k <= 32, m <= 4, k <= 21
# at m = 4), the grid the JAX package's own GF tests cover.
KM = [(k, m) for k in (2, 4, 5, 8, 12) for m in (1, 2, 3, 4)]


def test_tables_equal():
    assert tgf.GF_POLY == jgf.GF_POLY == 0x11D
    assert np.array_equal(tgf.GF_MUL_TABLE, jgf.GF_MUL_TABLE)
    for a in (1, 2, 3, 0x1D, 0x80, 0xFF):
        assert tgf.gf_inv(a) == jgf.gf_inv(a)


@pytest.mark.parametrize("k,m", KM)
def test_matrices_equal(k, m):
    for name in ("isa_rs_vandermonde_matrix", "isa_cauchy_matrix"):
        ours = getattr(tgf, name)(k, m)
        ref = getattr(jgf, name)(k, m)
        assert ours.dtype == ref.dtype == np.uint8
        assert np.array_equal(ours, ref), name
        assert np.array_equal(tgf.expand_matrix(ours[k:]), jgf.expand_matrix(ref[k:]))
        survivors = ref[m:]  # drop the first m rows: a mixed k x k submatrix
        inv_ours = tgf.gf_invert_matrix(survivors)
        inv_ref = jgf.gf_invert_matrix(survivors)
        assert (inv_ours is None) == (inv_ref is None)
        if inv_ref is not None:
            assert np.array_equal(inv_ours, inv_ref)


@pytest.mark.parametrize("k,m", KM)
def test_decode_matrices_equal(k, m):
    for build in ("isa_rs_vandermonde_matrix", "isa_cauchy_matrix"):
        full = getattr(jgf, build)(k, m)
        n = k + m
        patterns = {(0,), (n - 1,), tuple(range(m)), tuple(range(n - m, n)),
                    tuple(sorted({0, k // 2, n - 1}))[:m]}
        for erasures in patterns:
            ours = tgf.isa_decode_matrix(full, list(erasures), k)
            ref = jgf.isa_decode_matrix(full, list(erasures), k)
            if ref is None:
                assert ours is None
                continue
            assert np.array_equal(ours[0], ref[0]), (build, erasures)
            assert ours[1] == ref[1]
            assert np.array_equal(tgf.expand_matrix(ours[0]), jgf.expand_matrix(ref[0]))


@pytest.mark.parametrize("k,m", [(8, 3), (4, 2), (5, 2), (12, 4)])
def test_schedule_from_matrix_equal(k, m):
    for build in (jgf.isa_rs_vandermonde_matrix, jgf.isa_cauchy_matrix):
        coding = build(k, m)[k:]
        assert tswar.schedule_from_matrix(coding) == jpallas.schedule_from_matrix(coding)


def test_pick_geometry_equal():
    lengths = list(range(0, 8192 + 1, 16)) + [100, 128 * 1024, 512 * 1024, 4 << 20, 128 * 66]
    for L in lengths:
        assert tswar.pick_geometry(L) == jpallas.pick_geometry(L), L
        assert (tswar.pick_geometry(L) is not None) == (L > 0 and L % 128 == 0), L


def test_rs83_schedule_density():
    """The op counts the kernel's bound note rests on: 401 ones in the
    bit-expanded RS(8,3) Vandermonde parity matrix, 795 for Cauchy."""
    van = tswar.schedule_from_matrix(tgf.isa_rs_vandermonde_matrix(8, 3)[8:])
    cau = tswar.schedule_from_matrix(tgf.isa_cauchy_matrix(8, 3)[8:])
    assert sum(len(r) for r in van) == 401
    assert sum(len(r) for r in cau) == 795
    assert len({t for r in van for t in r}) == 64
