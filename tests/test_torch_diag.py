"""The port's kernel experiments (ceph_tpu_torch/diag) against the TPU ones
(benchmarks/diag/kern_exp2-4.py), whose Pallas kernels run here in
interpret mode, and against the GF(2^8) table product.  All comparisons
are byte-exact.  The CUDA kernels themselves run only on the card
(chip_smoke.py phase 5); here their wrappers take the plain versions."""

import functools
import re
from pathlib import Path

import jax.experimental.pallas as pl
import numpy as np
import pytest
import torch

from ceph_tpu.gf import gf_matmul, isa_cauchy_matrix, isa_decode_matrix, isa_rs_vandermonde_matrix

from ceph_tpu_torch.diag import kern_exp2, kern_exp3, kern_exp4, kern_exp5, swar_program
from ceph_tpu_torch.ops.swar_gf import schedule_from_matrix

ROOT = Path(__file__).resolve().parents[1]


def _van83():
    return isa_rs_vandermonde_matrix(8, 3)[8:]


def _decode83():
    c, _ = isa_decode_matrix(isa_rs_vandermonde_matrix(8, 3), [0, 5, 10], 8)
    return c


MATRICES = {
    "rs83-van": _van83,
    "rs83-cauchy": lambda: isa_cauchy_matrix(8, 3)[8:],
    "rs83-decode-0-5-10": _decode83,
    "rs42-van": lambda: isa_rs_vandermonde_matrix(4, 2)[4:],
}


@pytest.fixture(scope="module")
def tpu_diag():
    """The TPU scripts as modules, their pallas_call in interpret mode; the
    patch and the scripts' sys.path edits are undone after this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        mp.syspath_prepend(str(ROOT / "benchmarks" / "diag"))
        import kern_exp2 as tpu2
        import kern_exp3 as tpu3
        import kern_exp4 as tpu4

        yield tpu2, tpu3, tpu4


def _data(S, k, L, seed):
    return np.random.default_rng(seed).integers(0, 256, (S, k, L), dtype=np.uint8)


def _oracle(mat, data):
    return np.stack([gf_matmul(mat, d) for d in data])


@pytest.mark.parametrize("S,k,L,tile", [(2, 8, 1024, 256), (1, 4, 512, 128)])
def test_copy_matches_tpu(tpu_diag, S, k, L, tile):
    data = _data(S, k, L, tile)
    tpu = np.asarray(tpu_diag[2].make_copy(tile)(data))
    ours = kern_exp4.make_copy(tile)(torch.from_numpy(data)).numpy()
    assert np.array_equal(ours, tpu)
    assert np.array_equal(kern_exp4.copy_reference(torch.from_numpy(data)).numpy(), data[:, :3])


@pytest.mark.parametrize("name", MATRICES)
def test_swar_matches_tpu(tpu_diag, name):
    mat = MATRICES[name]()
    data = _data(2, mat.shape[1], 1024, len(name))
    tpu = np.asarray(tpu_diag[0].make_swar(mat, 8)(data))
    ours = kern_exp2.make_swar(mat, 8)(torch.from_numpy(data)).numpy()
    assert np.array_equal(ours, tpu)
    assert np.array_equal(ours, _oracle(mat, data))


@pytest.mark.parametrize("name,rows,cols", [(n, 4, 128) for n in MATRICES] + [("rs83-van", 8, 128)])
def test_swar3_matches_tpu(tpu_diag, name, rows, cols):
    mat = MATRICES[name]()
    data = _data(2, mat.shape[1], 1024, rows + len(name))
    tpu = np.asarray(tpu_diag[1].make_swar3(mat, rows, cols)(data))
    ours = kern_exp3.make_swar3(mat, rows, cols)(torch.from_numpy(data)).numpy()
    assert np.array_equal(ours, tpu)
    assert np.array_equal(ours, _oracle(mat, data))


@pytest.mark.parametrize("name", MATRICES)
def test_schedule_matches_kern_exp2(tpu_diag, name):
    mat = MATRICES[name]()
    ours = [list(row) for row in schedule_from_matrix(mat)]
    assert ours == tpu_diag[0].schedule_from_matrix(mat)


@pytest.mark.parametrize("k,m,seed", [(8, 3, 0), (5, 2, 1), (3, 9, 2), (4, 4, 3)])
def test_program_matches_table_product(k, m, seed):
    rng = np.random.default_rng(seed)
    mat = rng.integers(0, 256, (m, k), dtype=np.uint8)
    mat[m // 2] = 0  # an output with no terms: the "zero" op
    data = rng.integers(0, 256, (2, k, 256), dtype=np.uint8)
    ops = swar_program.program_from_schedule(schedule_from_matrix(mat))
    got = swar_program.run_program(ops, data.view(np.uint32)).view(np.uint8)
    assert np.array_equal(got, _oracle(mat, data))


@pytest.mark.parametrize("name", MATRICES)
def test_program_of_codec_matrices(name):
    mat = MATRICES[name]()
    data = _data(1, mat.shape[1], 512, 7)
    ops = swar_program.program_from_schedule(schedule_from_matrix(mat))
    got = swar_program.run_program(ops, data.view(np.uint32)).view(np.uint8)
    assert np.array_equal(got, _oracle(mat, data))


def test_vandermonde_program_counts():
    """The op counts the kernel notes and PERF.md quote for RS(8,3)."""
    ops = swar_program.program_from_schedule(schedule_from_matrix(_van83()))
    assert swar_program.op_counts(ops) == {
        "cuts": 120, "xors": 377, "placements": 42, "total": 539}


def _byte_perm(x, y, sel):
    """numpy model of CUDA's __byte_perm(x, y, sel) (no sign replication)."""
    pool = (np.asarray(y, np.uint64) << np.uint64(32)) | np.asarray(x, np.uint64)
    out = np.zeros(np.shape(x), dtype=np.uint32)
    for n in range(4):
        b = (sel >> (4 * n)) & 7
        out |= ((pool >> np.uint64(8 * b)) & np.uint64(0xFF)).astype(np.uint32) << np.uint32(8 * n)
    return out


def _transpose4(a):
    p = swar_program.BYTE_PERM
    t0 = _byte_perm(a[0], a[1], p["kPermLo"])
    t1 = _byte_perm(a[2], a[3], p["kPermLo"])
    t2 = _byte_perm(a[0], a[1], p["kPermHi"])
    t3 = _byte_perm(a[2], a[3], p["kPermHi"])
    return [_byte_perm(t0, t1, p["kPermEven"]), _byte_perm(t0, t1, p["kPermOdd"]),
            _byte_perm(t2, t3, p["kPermEven"]), _byte_perm(t2, t3, p["kPermOdd"])]


@pytest.mark.parametrize("rows,cols", [(8, 128), (16, 64)])
def test_swar3_kernel_grouping(rows, cols):
    """numpy model of csrc/swar3_baked.cu on one tile: read 4 row words of
    each chunk, transpose them with the emitted __byte_perm selectors into
    the TPU's column words, run the program, transpose back.  Random data,
    so a wrong selector cannot pass on symmetric bytes."""
    mat = _van83()
    data = _data(1, 8, rows * cols, rows + cols)
    sched = schedule_from_matrix(mat)
    ops = swar_program.program_from_schedule(sched)
    tile = data[0].reshape(8, rows, cols)
    out = np.zeros((3, rows, cols), dtype=np.uint8)
    for g in range(rows // 4):
        for c in range(0, cols, 4):
            a = [tile[:, 4 * g + p, c:c + 4].copy().view(np.uint32)[:, 0] for p in range(4)]
            words = _transpose4(a)  # words[q][j]: column c + q of chunk j
            for q in range(4):
                # the TPU's word: rows 4g..4g+3 of one column, row 4g+p in byte p
                want = tile[:, 4 * g:4 * g + 4, c + q].copy().view(np.uint32)[:, 0]
                assert np.array_equal(words[q], want)
            y = [swar_program.run_program(ops, w[:, None])[:, 0] for w in words]
            rows_out = _transpose4([np.array([y[q][i] for i in range(3)], np.uint32) for q in range(4)])
            for p in range(4):
                out[:, 4 * g + p, c:c + 4] = rows_out[p].view(np.uint8).reshape(3, 4)
    assert np.array_equal(out.reshape(1, 3, -1), _oracle(mat, data))
    ref = kern_exp3.swar3_reference(sched, torch.from_numpy(data), rows, cols).numpy()
    assert np.array_equal(ref, out.reshape(1, 3, -1))


def test_slab_geometry():
    """Every tile of the scripts fits the shared-memory stage for RS(8,3)."""
    assert kern_exp3.slab_bytes(8) == 2048 and 2 * 8 * kern_exp3.slab_bytes(8) <= 48 * 1024
    for rows, cols in kern_exp3.GEOMETRIES + kern_exp5.SWAR3_GEOMETRIES:
        r = kern_exp3.make_swar3(_van83(), rows, cols).slab_rows
        assert r % 4 == 0 and rows % r == 0 and r * cols <= 2048


@pytest.mark.parametrize("make,shape", [
    (lambda: kern_exp4.make_copy(256), (1, 8, 1000)),      # L % tile
    (lambda: kern_exp4.make_copy(256), (1, 2, 512)),       # k < 3
    (lambda: kern_exp4.make_copy(100), None),              # tile % 16
    (lambda: kern_exp2.make_swar(_van83(), 8), (1, 8, 1000)),   # L % 32
    (lambda: kern_exp2.make_swar(_van83(), 8), (1, 8, 800)),    # (L/32) % wt
    (lambda: kern_exp2.make_swar(_van83(), 6), None),           # wt % 4
    (lambda: kern_exp2.make_swar(_van83(), 8), (1, 7, 1024)),   # k != matrix k
    (lambda: kern_exp3.make_swar3(_van83(), 6, 128), None),     # rows % 4
    (lambda: kern_exp3.make_swar3(_van83(), 4, 128), (1, 8, 768)),  # L % tile
    (lambda: kern_exp3.make_swar3(_van83(), 4, 1024), None),    # 4 rows > slab
])
def test_invalid_shapes_raise(make, shape):
    with pytest.raises(ValueError):
        fn = make()
        fn(torch.zeros(shape, dtype=torch.uint8))


def test_cpu_wrappers_launch_nothing():
    data = torch.from_numpy(_data(1, 8, 1024, 3))
    before = (kern_exp2.launches, kern_exp3.launches, kern_exp4.launches)
    kern_exp2.make_swar(_van83(), 32)(data)
    kern_exp3.make_swar3(_van83(), 4, 256)(data)
    kern_exp4.make_copy(1024)(data)
    assert (kern_exp2.launches, kern_exp3.launches, kern_exp4.launches) == before


def test_bitcast_only_is_slice_copy():
    data = torch.from_numpy(_data(2, 8, 256, 4))
    out = kern_exp2.make_bitcast_only()(data)
    assert torch.equal(out, data[:, :3]) and out.data_ptr() != data.data_ptr()


def test_mains_need_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (lambda: kern_exp2.main([]), lambda: kern_exp3.main([]),
                 kern_exp4.main, kern_exp5.main):
        with pytest.raises(RuntimeError):
            main()


def test_generated_source_bakes_the_matrix():
    mat = _van83()
    src = swar_program.generated_source(kern_exp3.SOURCE, mat, {"kSlabBytes": 2048})
    assert "constexpr int kK = 8;" in src and "constexpr int kM = 3;" in src
    assert "constexpr int kSlabBytes = 0x800;" in src
    assert '#line 1 "ceph_tpu_torch/csrc/swar3_baked.cu"' in src
    assert len(re.findall(r"^  y\[\d\] = v\d+;$", src, re.M)) == 3
    other = swar_program.generated_source(kern_exp3.SOURCE, isa_cauchy_matrix(8, 3)[8:], {})
    assert other != src
