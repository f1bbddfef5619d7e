"""The port of benchmarks/diag/kern_exp.py (ceph_tpu_torch/diag/kern_exp.py)
against the TPU script, whose Pallas kernels run here in interpret mode,
and against the GF(2^8) table product and a numpy popcount.  All
comparisons are byte-exact.  The CUDA kernels run only on the card
(chip_smoke.py phase 6); here the wrappers take their plain versions."""

import functools
from pathlib import Path

import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.gf import gf_matmul, isa_cauchy_matrix, isa_decode_matrix, isa_rs_vandermonde_matrix

from ceph_tpu_torch.diag import kern_exp

ROOT = Path(__file__).resolve().parents[1]


def _van83():
    return isa_rs_vandermonde_matrix(8, 3)[8:]


MATRICES = {
    "rs83-van": _van83,
    "rs83-cauchy": lambda: isa_cauchy_matrix(8, 3)[8:],
    "rs83-decode-0-5-10": lambda: isa_decode_matrix(isa_rs_vandermonde_matrix(8, 3), [0, 5, 10], 8)[0],
    "rs42-van": lambda: isa_rs_vandermonde_matrix(4, 2)[4:],
    # mm_only's geometry: 8k = 40 pads K to 48; 8m = 32 with 8k = 80;
    # 8m = 8 with 8k = 24 padded to 32
    "rs52-van": lambda: isa_rs_vandermonde_matrix(5, 2)[5:],
    "rs104-van": lambda: isa_rs_vandermonde_matrix(10, 4)[10:],
    "rs31-van": lambda: isa_rs_vandermonde_matrix(3, 1)[3:],
}
JAX_OPERANDS = {"bf16": jnp.bfloat16, "int8": jnp.int8}


@pytest.fixture(scope="module")
def tpu_kern_exp():
    """The TPU script as a module, its pallas_call in interpret mode; the
    patch and the script's sys.path edits are undone after this module."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(pl, "pallas_call", functools.partial(pl.pallas_call, interpret=True))
        mp.syspath_prepend(str(ROOT / "benchmarks" / "diag"))
        import kern_exp as tpu

        yield tpu


def _data(S, k, L, seed):
    return np.random.default_rng(seed).integers(0, 256, (S, k, L), dtype=np.uint8)


def _oracle(mat, data):
    return np.stack([gf_matmul(mat, d) for d in data])


GROUPED_CASES = [("rs83-van", g, dn) for g in (1, 2, 4, 8) for dn in JAX_OPERANDS] + [
    ("rs83-cauchy", 2, "bf16"), ("rs83-decode-0-5-10", 4, "int8"), ("rs42-van", 8, "bf16")]


@pytest.mark.parametrize("name,g,dn", GROUPED_CASES)
def test_grouped_matches_tpu(tpu_kern_exp, name, g, dn):
    mat = MATRICES[name]()
    data = _data(8, mat.shape[1], 1024, 10 * g + len(name))
    tpu = np.asarray(tpu_kern_exp.make_grouped(mat, g, JAX_OPERANDS[dn], 512)(data))
    ours = kern_exp.make_grouped(mat, g, kern_exp.OPERANDS[dn], 512)(torch.from_numpy(data))
    assert np.array_equal(ours.numpy(), tpu)
    assert np.array_equal(tpu, _oracle(mat, data))


@pytest.mark.parametrize("name", ["rs83-van", "rs42-van", "rs52-van", "rs104-van", "rs31-van"])
def test_mm_only_matches_tpu(tpu_kern_exp, name):
    mat = MATRICES[name]()
    data = _data(2, mat.shape[1], 1024, len(name))
    planes = kern_exp.bit_planes(torch.from_numpy(data), torch.bfloat16)
    jplanes = jnp.asarray(kern_exp.bit_planes(torch.from_numpy(data), torch.uint8).numpy())
    tpu = np.asarray(tpu_kern_exp.make_mm_only(mat, 512)(jplanes.astype(jnp.bfloat16)))
    ours = kern_exp.make_mm_only(mat, 512)(planes).numpy()
    assert np.array_equal(ours, tpu)
    # counts, not parity: the 0/1 product in integers
    bm = kern_exp.arrange_dense_matrix(mat).astype(np.int64)
    counts = np.einsum("rc,scl->srl", bm, kern_exp.bit_planes(
        torch.from_numpy(data), torch.int64).numpy())
    assert np.array_equal(ours, counts.astype(np.uint8)) and ours.max() > 1


@pytest.mark.parametrize("name", ["rs83-van", "rs42-van", "rs52-van", "rs104-van", "rs31-van"])
def test_mm_only_padded_operand(name):
    """The operand the kernel gets: arrange_dense_matrix top left, zero
    columns up to the next multiple of mma's K step of 16."""
    bm = kern_exp.arrange_dense_matrix(MATRICES[name]())
    mm = kern_exp.make_mm_only(MATRICES[name](), 512)
    padded = mm.padded.matrix
    rows, cols = bm.shape
    assert padded.dtype == torch.bfloat16 and padded.is_contiguous()
    assert padded.shape[0] == rows and padded.shape[1] % 16 == 0
    assert cols <= padded.shape[1] < cols + 16
    assert np.array_equal(padded[:, :cols].float().numpy(), bm)
    assert not padded[:, cols:].any()
    assert torch.equal(mm.operand.matrix, torch.from_numpy(bm).to(torch.bfloat16))


@pytest.mark.parametrize("k", [8, 4])
def test_expand_only_matches_tpu(tpu_kern_exp, k):
    data = _data(2, k, 8192, k)
    tpu = np.asarray(tpu_kern_exp.make_expand_only(4096)(data))
    ours = kern_exp.make_expand_only(4096)(torch.from_numpy(data)).numpy()
    assert np.array_equal(ours, tpu)
    popcount = np.unpackbits(data[..., None], axis=-1).sum(axis=(1, 3), dtype=np.int64)
    assert np.array_equal(ours[:, 0], popcount.astype(np.uint8))


def test_bit_planes_match_the_script():
    """Bit-major rows, as the script builds mm_only's planes (:209-211)."""
    data = _data(2, 8, 64, 5)
    want = np.concatenate([(data.astype(np.int32) >> b) & 1 for b in range(8)], axis=1)
    assert np.array_equal(kern_exp.bit_planes(torch.from_numpy(data), torch.int32).numpy(), want)


@pytest.mark.parametrize("name", MATRICES)
def test_helpers_match_the_script(tpu_kern_exp, name):
    mat = MATRICES[name]()
    ours = kern_exp.arrange_dense_matrix(mat)
    want = tpu_kern_exp.arrange_dense_matrix(mat)
    assert ours.dtype == want.dtype and np.array_equal(ours, want)
    for g in (1, 3, 8):
        assert np.array_equal(kern_exp.block_diag(ours, g), tpu_kern_exp.block_diag(want, g))


def test_probe_fits_every_variant(tpu_kern_exp):
    """main()'s probe is divided by every grouped variant, unlike the
    script's (2, 1024) probe, on which the script's own kernel writes
    nothing and misses the oracle."""
    assert len(kern_exp.GROUPED_VARIANTS) == 13
    for g, dn, tile in kern_exp.GROUPED_VARIANTS:
        assert kern_exp.PROBE_S % g == 0 and kern_exp.PROBE_L % tile == 0
        assert kern_exp.PROBE_L >= tile
    assert kern_exp.CHUNK % kern_exp.MM_TILE == 0 and kern_exp.CHUNK % kern_exp.EXPAND_TILE == 0
    mat = _van83()
    small = _data(2, 8, 1024, 9)
    tpu = np.asarray(tpu_kern_exp.make_grouped(mat, 2, jnp.int8, 2048)(small))
    assert not tpu.any() and not np.array_equal(tpu, _oracle(mat, small))


@pytest.mark.parametrize("make,shape", [
    (lambda: kern_exp.make_grouped(_van83(), 4, torch.int8, 512), (6, 8, 1024)),   # S % g
    (lambda: kern_exp.make_grouped(_van83(), 2, torch.bfloat16, 512), (2, 8, 768)),  # L % tile
    (lambda: kern_exp.make_grouped(_van83(), 1, torch.int8, 2048), (2, 8, 1024)),  # L < tile
    (lambda: kern_exp.make_grouped(_van83(), 2, torch.int8, 512), (2, 7, 1024)),   # k
    (lambda: kern_exp.make_grouped(_van83(), 2, torch.float32, 512), None),        # dtype
    (lambda: kern_exp.make_grouped(_van83(), 16, torch.int8, 512), None),          # g·k > 96
    (lambda: kern_exp.make_expand_only(4096), (2, 8, 2048)),                       # L < tile
    (lambda: kern_exp.make_expand_only(4096), (2, 8, 6144)),                       # L % tile
    (lambda: kern_exp.make_expand_only(100), None),                                # tile % 16
])
def test_invalid_shapes_raise(make, shape):
    with pytest.raises(ValueError):
        make()(torch.zeros(shape, dtype=torch.uint8))


@pytest.mark.parametrize("shape,dtype,tile", [
    ((2, 64, 768), torch.bfloat16, 512),   # L % tile
    ((2, 64, 256), torch.bfloat16, 512),   # L < tile
    ((2, 32, 1024), torch.bfloat16, 512),  # 8k
    ((2, 64, 1024), torch.float32, 512),   # dtype
    ((2, 64, 768), torch.bfloat16, 192),   # tile % 128 (a ring stage is 128 columns)
    ((2, 64, 1024), torch.bfloat16, 64),   # tile < 128
])
def test_mm_only_invalid_shapes_raise(shape, dtype, tile):
    with pytest.raises(ValueError):
        kern_exp.make_mm_only(_van83(), tile)(torch.zeros(shape, dtype=dtype))


def test_cpu_wrappers_launch_nothing():
    data = torch.from_numpy(_data(2, 8, 1024, 3))
    before = dict(kern_exp.launches)
    kern_exp.make_grouped(_van83(), 2, torch.int8, 512)(data)
    kern_exp.make_mm_only(_van83(), 512)(kern_exp.bit_planes(data, torch.bfloat16))
    kern_exp.make_expand_only(512)(data)
    assert kern_exp.launches == before


def test_main_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        kern_exp.main([])


# The int8 grouped kernel (tensor cores, grouped_imma_kernel in
# csrc/bitmatrix.cu): the file's matrices, one with m > 4 (two passes: 4 and 2
# output chunks) and one with k > 32 (two chunk groups).
IMMA_MATRICES = dict(MATRICES, **{
    "rs66-cauchy": lambda: isa_cauchy_matrix(6, 6)[6:],
    "rs402-van": lambda: isa_rs_vandermonde_matrix(40, 2)[40:],
})


@pytest.mark.parametrize("name", IMMA_MATRICES)
def test_imma_operand_layout(name):
    """Column 32t + 4b + i of the operand is column b·k + 4t + i of the
    bit-matrix (bit b of chunk 4t + i), zero past k; whole k-steps of 4
    chunks, in chunk groups of at most 8 steps."""
    mat = IMMA_MATRICES[name]()
    m, k = mat.shape
    bm = kern_exp.arrange_dense_matrix(mat)
    op = kern_exp.imma_operand(bm, k)
    steps = kern_exp.imma_steps(k)
    assert op.dtype == np.int8 and op.flags.c_contiguous and op.shape == (8 * m, 32 * steps)
    assert -(-k // 4) <= steps < -(-k // 4) + -(-k // 32)
    for t in range(steps):
        for b in range(8):
            for i in range(4):
                col = op[:, 32 * t + 4 * b + i]
                if 4 * t + i < k:
                    assert np.array_equal(col, bm[:, b * k + 4 * t + i])
                else:
                    assert not col.any()
    assert torch.equal(kern_exp.make_grouped(mat, 1, torch.int8, 512).imma.matrix,
                       torch.from_numpy(op))


def _imma_model(mat, data, seed):
    """The int8 grouped kernel's arithmetic in numpy: words W[t] of the
    bytes of chunks 4t..4t+3 (chunks past k nonzero garbage), element (t, b,
    i) = byte i of W[t] >> b with its 7 garbage bits, times imma_operand in
    int64, `& 1`, packed LSB-first."""
    S, k, L = data.shape
    op = kern_exp.imma_operand(kern_exp.arrange_dense_matrix(mat), k).astype(np.int64)
    steps = op.shape[1] // 32
    garbage = np.random.default_rng(seed).integers(1, 256, (S, 4 * steps - k, L), dtype=np.uint8)
    chunks = np.concatenate([data, garbage], axis=1).astype(np.uint64).reshape(S, steps, 4, L)
    words = (chunks << (8 * np.arange(4, dtype=np.uint64))[:, None]).sum(2)  # (S, T, L)
    shifted = words[:, :, None] >> np.arange(8, dtype=np.uint64)[:, None]  # (S, T, 8, L)
    elems = (shifted[:, :, :, None] >> (8 * np.arange(4, dtype=np.uint64))[:, None]) & 0xFF
    planes = elems.reshape(S, 32 * steps, L).astype(np.int64)
    assert (planes > 1).any()  # the garbage bits are there
    bits = (np.einsum("rc,scl->srl", op, planes) & 1).reshape(S, -1, 8, L)
    return (bits << np.arange(8)[:, None]).sum(2).astype(np.uint8)


IMMA_CASES = [("rs83-van", 1), ("rs83-cauchy", 2), ("rs83-decode-0-5-10", 4), ("rs42-van", 8),
              ("rs52-van", 1), ("rs104-van", 2), ("rs66-cauchy", 1), ("rs402-van", 2)]


@pytest.mark.parametrize("name,g", IMMA_CASES)
def test_imma_model_matches_tpu(tpu_kern_exp, name, g):
    mat = IMMA_MATRICES[name]()
    data = _data(8, mat.shape[1], 1024, 20 + g + len(name))
    tpu = np.asarray(tpu_kern_exp.make_grouped(mat, g, jnp.int8, 512)(data))
    model = _imma_model(mat, data, g)
    assert np.array_equal(model, tpu)
    assert np.array_equal(model, _oracle(mat, data))


def test_split_grouped_counters_stay_zero_on_cpu():
    data = torch.from_numpy(_data(2, 8, 1024, 4))
    assert {"bitmatrix_grouped_int8", "bitmatrix_grouped_bf16"} <= set(kern_exp.launches)
    assert "bitmatrix_grouped" not in kern_exp.launches
    before = dict(kern_exp.launches)
    for dtype in (torch.int8, torch.bfloat16):
        kern_exp.make_grouped(_van83(), 2, dtype, 512)(data)
    assert kern_exp.launches == before


@pytest.mark.parametrize("name,g,shape,tile", [
    ("rs83-van", 1, (2, 8, 4112), 1028),   # tile not a multiple of 16
    ("rs83-van", 2, (4, 8, 1024), 4),      # the smallest tile
    ("rs66-cauchy", 1, (2, 6, 1024), 512),  # m > 4
    ("rs402-van", 2, (4, 40, 1024), 512),  # k > 32
    ("rs104-van", 8, (8, 10, 512), 512),   # g·k = 80
])
def test_int8_grouped_domain(name, g, shape, tile):
    """Every shape the int8 wrapper took before still codes."""
    mat = IMMA_MATRICES[name]()
    data = _data(*shape, seed=len(name) + g)
    got = kern_exp.make_grouped(mat, g, torch.int8, tile)(torch.from_numpy(data)).numpy()
    assert np.array_equal(got, _oracle(mat, data))


@pytest.mark.parametrize("g,shape,tile", [
    (3, (6, 40, 1024), 512),   # g·k = 120 > 96
    (1, (2, 8, 1024), 6),      # tile % 4
    (2, (3, 8, 1024), 512),    # S % g
    (1, (2, 8, 1000), 512),    # L % tile
])
def test_int8_grouped_still_raises(g, shape, tile):
    mat = (IMMA_MATRICES["rs402-van"] if shape[1] == 40 else _van83)()
    with pytest.raises(ValueError):
        kern_exp.make_grouped(mat, g, torch.int8, tile)(torch.zeros(shape, dtype=torch.uint8))


# The bf16 grouped kernel (tensor cores, grouped_hgmma_kernel in
# csrc/bitmatrix.cu).
HGMMA_MATRICES = dict(IMMA_MATRICES, **{
    "rs1004-van": lambda: isa_rs_vandermonde_matrix(96, 4)[96:],
})


@pytest.mark.parametrize("name", ["rs83-van", "rs52-van", "rs104-van", "rs66-cauchy", "rs31-van",
                                  "rs402-van", "rs1004-van"])
def test_hgmma_operand_layout(name):
    """Column 16j + q of the operand (k16 step j = 2w + o) is column b·k + c
    of the bit-matrix scaled by 2^-b, b = (q % 8) // 2 + 4·(q // 8) and c =
    4w + o + 2·(q % 2), zero where c >= k; whole words of 4 chunks, in chunk
    groups of at most 4 words."""
    mat = HGMMA_MATRICES[name]()
    m, k = mat.shape
    bm = kern_exp.arrange_dense_matrix(mat)
    op = kern_exp.hgmma_operand(bm, k)
    words = kern_exp.hgmma_words(k)
    assert op.dtype == np.float32 and op.flags.c_contiguous and op.shape == (8 * m, 32 * words)
    assert -(-k // 4) <= words < -(-k // 4) + -(-k // 16)
    for j in range(2 * words):
        for q in range(16):
            b, c = (q % 8) // 2 + 4 * (q // 8), 4 * (j // 2) + j % 2 + 2 * (q % 2)
            col = op[:, 16 * j + q]
            if c < k:
                assert np.array_equal(col, bm[:, b * k + c] / 2 ** b)
            else:
                assert not col.any()
    # exact in bf16: every entry is 0 or a power of two
    hg = kern_exp.make_grouped(mat, 1, torch.bfloat16, 512).hgmma.matrix
    assert hg.dtype == torch.bfloat16 and torch.equal(hg.float(), torch.from_numpy(op))


def _hgmma_slot(n):
    """(output chunk of the pass, bit) of the kernel's N index n: n8 block i
    holds bits 2i, 2i + 1 of the pass's 4 chunks, lane tig those of chunk
    tig."""
    i, tig, e = n // 8, (n % 8) // 2, n % 2
    return tig, 2 * i + e


def _bf16_values(bits):
    """uint16 bf16 bit patterns -> float64 values."""
    return (bits.astype(np.uint32) << 16).view(np.float32).astype(np.float64)


def _hgmma_model(mat, data, seed, tile=512):
    """The bf16 grouped kernel's arithmetic in numpy.  Words W[w] of chunks
    4w..4w+3 (chunks past k nonzero garbage); k16 step 2w + o takes y = W >>
    8o; the bf16 pair of element bit s is (y & mask_s) ^ base_s (mask_s
    keeps bits s..6 of bytes 0 and 2, base 128; for s = 7 bit 7, base 256),
    so the element is 128 + v (v a multiple of 2^s, its bit s the plane bit)
    or, for s = 7, 256 or 128.  Times hgmma_operand (2^-s or 0) summed
    exactly.  Then the carried sums: with one chunk group, the two sets of
    sums start a 256-column stage at 2^23 and each keeps adding its m-tiles
    (16 columns; set mt % 2), so the low bit of a sum's float32 XOR that of
    the set's previous sum is the m-tile's parity; with chunk groups each
    m-tile starts at 2^23.  Then the epilogue: passes of 4 chunks, B's N
    permutation, and each lane's 8 bits gathered into its chunk's byte."""
    S, k, L = data.shape
    m = mat.shape[0]
    op = kern_exp.hgmma_operand(kern_exp.arrange_dense_matrix(mat), k).astype(np.float64)
    words = op.shape[1] // 32
    garbage = np.random.default_rng(seed).integers(1, 256, (S, 4 * words - k, L), dtype=np.uint8)
    chunks = np.concatenate([data, garbage], axis=1).astype(np.uint32).reshape(S, words, 4, L)
    W = (chunks << (8 * np.arange(4, dtype=np.uint32))[:, None]).sum(2, dtype=np.uint32)
    elems = np.zeros((S, 2 * words, 16, L))
    for q in range(16):
        s, e = (q % 8) // 2 + 4 * (q // 8), q % 2
        mask = (0x7F >> s << s) if s < 7 else 0x80
        base = 0x4300 if s < 7 else 0x4380
        for o in range(2):
            half = ((W >> (8 * o + 16 * e)) & 0xFFFF).astype(np.uint16)
            elems[:, o::2, q] = _bf16_values((half & mask) ^ base)
    assert set(np.unique(elems)) <= set(range(128, 257))
    sums = np.einsum("rc,scl->srl", op, elems.reshape(S, 32 * words, L))
    assert np.array_equal(sums, np.round(sums))
    if words <= kern_exp.HGMMA_MAX_WORDS:  # one chunk group: carried over a stage
        assert tile % 256 == 0
        chains = sums.reshape(S, 8 * m, L // 256, 8, 2, 16)  # stage, mt // 2, set, column
        carried = np.cumsum(chains, axis=3)
        before = np.concatenate([np.zeros_like(carried[:, :, :, :1]), carried[:, :, :, :-1]], 3)
    else:
        carried, before = sums, np.zeros_like(sums)
    assert carried.max() < 2 ** 23
    low = [((x.astype(np.float32) + np.float32(2 ** 23)).view(np.uint32) & 1).astype(np.int64)
           for x in (carried, before)]
    low = (low[0] ^ low[1]).reshape(S, 8 * m, L)
    out = np.zeros((S, m, L), dtype=np.int64)
    for first in range(0, m, 4):
        bit = np.zeros((S, 32, L), dtype=np.int64)  # N index n's low bit
        for n in range(32):
            chunk, b = _hgmma_slot(n)
            if first + chunk < m:
                bit[:, n] = low[:, 8 * (first + chunk) + b]
        # lane tig's byte: pair i from n8 block i at bits 2i, 2i + 1
        for tig in range(min(4, m - first)):
            out[:, first + tig] = sum(bit[:, 8 * i + 2 * tig + e] << (2 * i + e)
                                      for i in range(4) for e in (0, 1))
    return out.astype(np.uint8)


HGMMA_CASES = [("rs83-van", 1), ("rs83-van", 2), ("rs83-cauchy", 2), ("rs83-decode-0-5-10", 1),
               ("rs42-van", 2), ("rs52-van", 1), ("rs52-van", 2), ("rs104-van", 2),
               ("rs66-cauchy", 1), ("rs66-cauchy", 2), ("rs31-van", 1), ("rs31-van", 2),
               ("rs402-van", 2)]


@pytest.mark.parametrize("name,g", HGMMA_CASES)
def test_hgmma_model_matches_tpu(tpu_kern_exp, name, g):
    mat = HGMMA_MATRICES[name]()
    data = _data(8, mat.shape[1], 1024, 40 + g + len(name))
    tpu = np.asarray(tpu_kern_exp.make_grouped(mat, g, jnp.bfloat16, 512)(data))
    model = _hgmma_model(mat, data, g)
    assert np.array_equal(model, tpu)
    assert np.array_equal(model, _oracle(mat, data))


@pytest.mark.parametrize("name,g,shape,tile", [
    ("rs83-van", 1, (2, 8, 4112), 1028),   # tile not a multiple of 16
    ("rs83-van", 2, (4, 8, 1024), 4),      # the smallest tile
    ("rs52-van", 1, (2, 5, 1028), 4),      # the smallest tile, L not a multiple of 16
    ("rs31-van", 4, (8, 3, 1024), 256),    # m = 1
    ("rs66-cauchy", 1, (2, 6, 1024), 512),  # m > 4
    ("rs402-van", 2, (4, 40, 1024), 512),  # k > 16: chunk groups
    ("rs104-van", 8, (8, 10, 512), 512),   # g·k = 80
    ("rs1004-van", 1, (2, 96, 256), 256),  # g·k = 96
])
def test_bf16_grouped_domain(name, g, shape, tile):
    """Every shape the bf16 wrapper took before still codes, here on its
    plain path (CPU tensors); chip_smoke.py's phase 6a holds the kernel to
    the plain version at these geometries on the card."""
    mat = HGMMA_MATRICES[name]()
    data = _data(*shape, seed=len(name) + g)
    got = kern_exp.make_grouped(mat, g, torch.bfloat16, tile)(torch.from_numpy(data)).numpy()
    assert np.array_equal(got, _oracle(mat, data))


@pytest.mark.parametrize("g,shape,tile", [
    (3, (6, 40, 1024), 512),   # g·k = 120 > 96
    (1, (2, 8, 1024), 6),      # tile % 4
    (1, (2, 8, 1024), 0),      # tile 0
    (2, (3, 8, 1024), 512),    # S % g
    (1, (2, 8, 1000), 512),    # L % tile
    (1, (2, 8, 256), 512),     # L < tile
])
def test_bf16_grouped_still_raises(g, shape, tile):
    mat = (IMMA_MATRICES["rs402-van"] if shape[1] == 40 else _van83)()
    with pytest.raises(ValueError):
        kern_exp.make_grouped(mat, g, torch.bfloat16, tile)(torch.zeros(shape, dtype=torch.uint8))
