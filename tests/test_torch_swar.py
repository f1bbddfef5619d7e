"""The port's SWAR coding (plain version of the hand kernel) and plain-torch
XOR ops against the JAX package: the Pallas kernel itself in interpret mode,
the jnp ops, and the numpy oracle.  All comparisons are byte-exact."""

import numpy as np
import pytest
import torch

from ceph_tpu.gf import isa_cauchy_matrix, isa_decode_matrix, isa_rs_vandermonde_matrix
from ceph_tpu.ops import xor_mm as jxor
from ceph_tpu.ops.pallas_gf import CodingPlan as PallasPlan

from ceph_tpu_torch.gf import expand_matrix, xor_matmul_host_batch
from ceph_tpu_torch.ops import swar_gf, xor_mm

CPU = torch.device("cpu")


def _rs83(technique):
    build = isa_rs_vandermonde_matrix if technique == "van" else isa_cauchy_matrix
    return build(8, 3)


def _matrix(technique, erasures):
    """RS(8,3) encode rows (erasures None) or the decode matrix for erasures."""
    full = _rs83(technique)
    if erasures is None:
        return full[8:]
    c, _ = isa_decode_matrix(full, list(erasures), 8)
    return c


MATRICES = [
    ("van", None), ("cauchy", None),
    ("van", (0, 9)), ("cauchy", (0, 5, 10)), ("van", (9, 10)),
]


@pytest.mark.parametrize("technique,erasures", MATRICES)
@pytest.mark.parametrize("S,L", [(1, 128), (2, 512), (1, 4096)])
def test_reference_matches_pallas_interpret(technique, erasures, S, L):
    mat = _matrix(technique, erasures)
    rng = np.random.default_rng([S, L, len(technique), *(erasures or ())])
    data = rng.integers(0, 256, (S, mat.shape[1], L), dtype=np.uint8)
    pallas = np.asarray(PallasPlan(mat, interpret=True)(data))
    ours = swar_gf.swar_code_reference(
        swar_gf.schedule_from_matrix(mat), torch.from_numpy(data)
    ).numpy()
    assert np.array_equal(ours, pallas)
    assert np.array_equal(ours, xor_matmul_host_batch(expand_matrix(mat), data))


@pytest.mark.parametrize("k,m", [(8, 3), (4, 2), (5, 2), (6, 6), (4, 1), (3, 9)])
def test_reference_matches_oracle(k, m):
    rng = np.random.default_rng(100 * k + m)
    mat = isa_cauchy_matrix(k, m)[k:]
    data = rng.integers(0, 256, (2, 3, k, 256), dtype=np.uint8)  # two lead dims
    plan = swar_gf.CodingPlan(mat, device=CPU)
    ours = plan(torch.from_numpy(data)).numpy()
    assert ours.shape == (2, 3, m, 256)
    assert np.array_equal(ours, xor_matmul_host_batch(expand_matrix(mat), data))


def _byte_parity(x):
    x = x ^ (x >> 4)
    x = x ^ (x >> 2)
    x = x ^ (x >> 1)
    return x & np.uint32(0x01010101)


def _merge(a, b, s, lo):
    """One level of csrc/swar_gf.cu's parity butterfly."""
    s, lo = np.uint32(s), np.uint32(lo)
    return ((a ^ (a >> s)) & lo) | ((b ^ (b << s)) & ~lo)


def _butterfly(t):
    """The kernel's joint parity fold of 8 accumulators, all three levels:
    pairs (r, r+4) at s = 4, (r, r+2) at s = 2, (0, 1) at s = 1."""
    y = [_merge(t[p], t[p + 4], 4, 0x0F0F0F0F) for p in range(4)]
    return _fold(y)


def _fold(y):
    """Levels s = 2 and s = 1, on y_p = merge_4(t_p, t_{p+4})."""
    z = [_merge(y[p], y[p + 2], 2, 0x33333333) for p in range(2)]
    return _merge(z[0], z[1], 1, 0x55555555)


def _nibble_swap(w):
    return ((w >> np.uint32(4)) & np.uint32(0x0F0F0F0F)) | (
        (w << np.uint32(4)) & np.uint32(0xF0F0F0F0))


def _cuda_formulation(masks, m, data):
    """numpy model of csrc/swar_gf.cu on its schedule operand: for each pass
    and output row, y_p = XOR_j (w_j & A_p) ^ (nibble_swap(w_j) & B_p) (the
    butterfly's first level, done in the accumulate), then levels s = 2 and
    s = 1 of the fold."""
    S, k, L = data.shape
    words = data.view(np.uint32)
    passes, rows = swar_gf.pass_geometry(m)
    assert masks.shape == (passes, k, rows, 8) and masks.dtype == np.uint32
    assert not masks.transpose(0, 2, 1, 3).reshape(passes * rows, -1)[m:].any()
    out = np.zeros((S, passes * rows, L // 4), dtype=np.uint32)
    for g in range(passes):
        for i in range(rows):
            y = [np.zeros((S, L // 4), dtype=np.uint32) for _ in range(4)]
            for j in range(k):
                w = words[:, j]
                ws = _nibble_swap(w)
                for p in range(4):
                    y[p] ^= (w & masks[g, j, i, 2 * p]) ^ (ws & masks[g, j, i, 2 * p + 1])
            out[:, g * rows + i] = _fold(y)
    return np.ascontiguousarray(out[:, :m]).view(np.uint8)


def test_butterfly_places_row_parity_on_its_bit():
    """Bit r of each byte of the joint fold is the parity of accumulator
    r's byte, for random words."""
    rng = np.random.default_rng(5)
    t = rng.integers(0, 2**32, (8, 4096), dtype=np.uint32)
    want = np.zeros(4096, dtype=np.uint32)
    for r in range(8):
        want |= _byte_parity(t[r]) << np.uint32(r)
    assert np.array_equal(_butterfly(t), want)


@pytest.mark.parametrize("k,m", [(8, 3), (3, 1), (5, 6)])
def test_operand_does_first_butterfly_level(k, m):
    """The (A, B) operand on the words and their nibble swaps gives the
    first butterfly level of the accumulators t_r = XOR_j (w_j & M[r][j])."""
    rng = np.random.default_rng(31 * k + m)
    mat = rng.integers(0, 256, (m, k), dtype=np.uint8)
    masks = swar_gf.schedule_masks(mat)
    _, rows = swar_gf.pass_geometry(m)
    bits = expand_matrix(mat).reshape(m, 8, k, 8)
    words = rng.integers(0, 2**32, (k, 1024), dtype=np.uint32)
    for o in range(m):
        g, i = divmod(o, rows)
        t = [np.zeros(1024, dtype=np.uint32) for _ in range(8)]
        for r in range(8):
            for j in range(k):
                rep = np.uint32(sum(1 << b for b in range(8) if bits[o, r, j, b]) * 0x01010101)
                t[r] ^= words[j] & rep
        for p in range(4):
            y = np.zeros(1024, dtype=np.uint32)
            for j in range(k):
                a, b = masks[g, j, i, 2 * p], masks[g, j, i, 2 * p + 1]
                y ^= (words[j] & a) ^ (_nibble_swap(words[j]) & b)
            assert np.array_equal(y, _merge(t[p], t[p + 4], 4, 0x0F0F0F0F))


@pytest.mark.parametrize("m,geometry", [
    (1, (1, 1)), (3, (1, 3)), (4, (1, 4)), (5, (2, 3)), (6, (2, 3)), (8, (2, 4)), (9, (3, 3)),
])
def test_pass_geometry(m, geometry):
    assert swar_gf.pass_geometry(m) == geometry


@pytest.mark.parametrize("k,m", [(8, 3), (5, 2), (4, 5), (2, 8), (10, 4), (6, 6), (1, 1), (16, 4)])
def test_kernel_schedule_operand(k, m):
    """The hand kernel's schedule operand and arithmetic, modelled in
    numpy (the CUDA source itself runs only on the card: chip_smoke.py),
    give the plain version's bytes, the Pallas kernel's (interpret mode) and
    the bitslice oracle's."""
    rng = np.random.default_rng(7 * k + m)
    mat = rng.integers(0, 256, (m, k), dtype=np.uint8)
    masks = swar_gf.schedule_masks(mat)
    data = rng.integers(0, 256, (2, k, 128), dtype=np.uint8)
    want = swar_gf.swar_code_reference(
        swar_gf.schedule_from_matrix(mat), torch.from_numpy(data)
    ).numpy()
    assert np.array_equal(_cuda_formulation(masks, m, data), want)
    assert np.array_equal(want, np.asarray(PallasPlan(mat, interpret=True)(data)))
    assert np.array_equal(want, xor_matmul_host_batch(expand_matrix(mat), data))


def test_cpu_wrapper_counts_no_launch():
    mat = _matrix("van", None)
    plan = swar_gf.CodingPlan(mat, device=CPU)
    before = swar_gf.launches
    data = torch.zeros((1, 8, 128), dtype=torch.uint8)
    assert plan(data).shape == (1, 3, 128)
    assert swar_gf.launches == before
    assert plan.masks is None  # the kernel operand is built only for CUDA


def test_wrapper_rejects_bad_input():
    plan = swar_gf.CodingPlan(_matrix("van", None), device=CPU)
    with pytest.raises(TypeError):
        plan(torch.zeros((1, 8, 128), dtype=torch.int32))
    with pytest.raises(ValueError):
        plan(torch.zeros((1, 7, 128), dtype=torch.uint8))


@pytest.mark.parametrize("lead", [(), (3,), (2, 2)])
@pytest.mark.parametrize("L", [128, 96, 200])
def test_xor_matmul_matches_jnp(lead, L):
    rng = np.random.default_rng(len(lead) * 1000 + L)
    k, m = 5, 3
    bm = expand_matrix(isa_cauchy_matrix(k, m)[k:])
    data = rng.integers(0, 256, (*lead, k, L), dtype=np.uint8)
    ours = xor_mm.xor_matmul(torch.from_numpy(bm), torch.from_numpy(data)).numpy()
    ref = np.asarray(jxor.xor_matmul(bm, data))
    assert ours.dtype == np.uint8 and ours.shape == (*lead, m, L)
    assert np.array_equal(ours, ref)


@pytest.mark.parametrize("lead", [(), (4,)])
def test_xor_reduce_matches_jnp(lead):
    rng = np.random.default_rng(11 + len(lead))
    data = rng.integers(0, 256, (*lead, 6, 300), dtype=np.uint8)
    ours = xor_mm.xor_reduce(torch.from_numpy(data)).numpy()
    assert np.array_equal(ours, np.asarray(jxor.xor_reduce(data)))
    assert ours.shape == (*lead, 300)
