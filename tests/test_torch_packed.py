"""The port's packed plane programs (ops/packed_gf.py) and the codec paths on
them (the packed tier, verify, RMW delta), on the CPU, held byte for byte
against the JAX package: its generators, its numpy oracles, and its jitted
device programs run on the CPU.  The tolerance of every check is 0 bytes.

The full (k, m) grid runs against the numpy oracle; the comparisons with
the jitted JAX programs (one XLA compile per program and shape) are kept
to a handful of geometries."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu.codec import registry as jregistry
from ceph_tpu.gf import gf_matmul, isa_cauchy_matrix, isa_decode_matrix, isa_rs_vandermonde_matrix
from ceph_tpu.ops import packed_gf as jpacked

from ceph_tpu_torch.codec import matrix_codec, registry
from ceph_tpu_torch.ops import dispatch, packed_gf, swar_gf

GRID = [(k, m) for k in (2, 4, 8, 12) for m in (1, 2, 3, 4)]
# the widest profiles ISA's Vandermonde codes take (k <= 21 at m = 4, k <= 32)
WIDE = [(21, 4), (32, 3)]


def _matrices(k, m):
    """Encode rows of both techniques and one decode matrix (erasures
    0..m-1) of the Vandermonde code."""
    van = isa_rs_vandermonde_matrix(k, m)
    mats = [("van", van[k:]), ("cauchy", isa_cauchy_matrix(k, m)[k:])]
    mats.append(("van-decode", isa_decode_matrix(van, list(range(m)), k)[0]))
    return mats


def _data(shape, seed):
    return np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8)


def _model(lowered, data):
    """numpy model of csrc/packed_gf.cu on the lowered operand: the k
    inputs into their slots, each op from its slot operands or the
    accumulator (a = -1), its result stored only where dst >= 0."""
    S, _, L = data.shape
    slots = [None] * lowered.nslots
    for j, sl in enumerate(lowered.in_slots):
        if sl >= 0:
            slots[sl] = data[:, j]
    acc = None
    for kind, dst, a, b in lowered.ops:
        x = acc if a < 0 else slots[a]
        acc = x ^ slots[b] if kind == packed_gf.OP_XOR else packed_gf._xtime_host(x)
        if dst >= 0:
            slots[dst] = acc
    return np.stack([np.zeros((S, L), np.uint8) if sl < 0 else slots[sl]
                     for sl in lowered.out_slots], axis=1)


def test_constants_match_reference():
    assert packed_gf._XTIME_RED == jpacked._XTIME_RED == 0x1D
    assert packed_gf.PACKED_MIN_BYTES == jpacked.PACKED_MIN_BYTES


@pytest.mark.parametrize("k,m", GRID)
def test_generators_match_reference(k, m):
    """Each copied generator gives the reference's program tuple, and
    best_program the same choice at the same cost."""
    for label, mat in _matrices(k, m):
        assert packed_gf.plane_schedule(mat) == jpacked.plane_schedule(mat), label
        for name in ("naive_program", "cse_program", "ring_program", "best_program"):
            ours = getattr(packed_gf, name)(mat)
            assert ours == getattr(jpacked, name)(mat), (label, name)
        best = packed_gf.best_program(mat)
        assert packed_gf.program_cost(best) == jpacked.program_cost(jpacked.best_program(mat))
        assert packed_gf.is_program(best) and not packed_gf.is_program(
            packed_gf.plane_schedule(mat))


@pytest.mark.parametrize("k,m", GRID)
@pytest.mark.parametrize("L", [128, 131])
def test_plain_versions_match_host_oracle(k, m, L):
    """packed_code_reference (and the wrapper on a CPU tensor) equal the
    reference's packed_code_host for every construction; the verify and
    delta plain versions equal their host oracles."""
    for n, (label, mat) in enumerate(_matrices(k, m)):
        data = _data((2, k, L), [k, m, L, n])
        want = jpacked.packed_code_host(mat, data)
        assert np.array_equal(packed_gf.packed_code_host(mat, data), want)
        for gen in (packed_gf.naive_program, packed_gf.cse_program, packed_gf.ring_program):
            got = packed_gf.packed_code_reference(gen(mat), torch.from_numpy(data))
            assert np.array_equal(got.numpy(), want), (label, gen.__name__)
        got = packed_gf.packed_code(packed_gf.best_program(mat), torch.from_numpy(data))
        assert np.array_equal(got.numpy(), want), label
        new = _data((2, k, L), [k, m, L, n, 1])
        parity = _data((2, m, L), [k, m, L, n, 2])
        got = packed_gf.packed_delta(packed_gf.best_program(mat), torch.from_numpy(data),
                                     torch.from_numpy(new), torch.from_numpy(parity))
        assert np.array_equal(got.numpy(), jpacked.packed_delta_host(mat, data, new, parity))
        cw = np.concatenate([data, want], axis=1)
        cw[1, (k + n) % (k + m), L // 2] ^= 0x40
        got = packed_gf.packed_verify(packed_gf.best_program(mat), torch.from_numpy(cw))
        assert np.array_equal(got.numpy(), jpacked.packed_verify_host(mat, cw))


@pytest.mark.parametrize("k,m", GRID + WIDE)
def test_lowered_operand_model(k, m):
    """The kernel's operand (slots by liveness, the accumulator, stores
    elided) computes the program's bytes, for every construction; and the
    construction a plan gives the kernels fits a full block: best_program's
    where that fits, the cheapest that fits otherwise (Cauchy(21,4)'s
    encode and the RS(21,4) and RS(32,3) decodes need the ring program)."""
    for label, mat in _matrices(k, m):
        data = _data((3, k, 37), [k, m, len(label)])
        want = jpacked.packed_code_host(mat, data)
        for gen in (packed_gf.naive_program, packed_gf.cse_program, packed_gf.ring_program):
            lowered = packed_gf.LoweredProgram(gen(mat))
            assert lowered.nslots <= packed_gf.MAX_SLOTS
            assert lowered.threads == packed_gf.block_threads(
                len(lowered.ops), lowered.nslots, k, m) > 0
            assert np.array_equal(_model(lowered, data), want), (label, gen.__name__)
            host = lowered.operand(torch.device("cpu")).numpy()
            assert host.size == 4 * len(lowered.ops) + k + m
            assert np.array_equal(host[: 4 * len(lowered.ops)], lowered.ops.ravel())
        chosen = packed_gf.PackedPlan(mat).lowered
        assert chosen.threads == packed_gf.BLOCK_THREADS, label
        assert np.array_equal(_model(chosen, data), want), label
        best = packed_gf.LoweredProgram(packed_gf.best_program(mat))
        if best.threads == packed_gf.BLOCK_THREADS:
            assert chosen.prog == best.prog, label
        else:
            assert chosen.prog == packed_gf.ring_program(mat), label


def test_lowering_reuses_slots_and_uses_the_accumulator():
    """RS(8,3)'s ring program: 47 ops, a slot for each of the 8 inputs and
    for the 3 outputs at most (dead slots reused), most first operands from
    the accumulator."""
    mat = isa_rs_vandermonde_matrix(8, 3)[8:]
    lowered = packed_gf.lower_program(packed_gf.best_program(mat))
    assert len(lowered.ops) == 47
    assert lowered.nslots == 11
    assert int((lowered.ops[:, 2] < 0).sum()) == 39
    assert packed_gf.lower_program(lowered) is lowered


def test_lowering_refuses_a_program_past_the_slot_limit():
    """A program whose slots do not fit shared memory at MIN_THREADS a block
    raises when it is lowered for a kernel (400 slots fit 32 threads); a
    plan of it still builds and runs its plain version."""
    assert packed_gf.MAX_SLOTS == packed_gf.SMEM_LIMIT // (16 * packed_gf.MIN_THREADS)
    mat = np.ones((1, packed_gf.MAX_SLOTS + 2), np.uint8)
    with pytest.raises(ValueError, match="live slots"):
        packed_gf.LoweredProgram(packed_gf.best_program(mat))
    fits = packed_gf.LoweredProgram(packed_gf.best_program(mat[:, :400]))
    assert fits.threads == packed_gf.MIN_THREADS
    plan = packed_gf.PackedPlan(mat)
    data = _data((1, mat.shape[1], 8), 13)
    got = plan(torch.from_numpy(data))
    assert np.array_equal(got.numpy(), np.bitwise_xor.reduce(data, axis=1)[:, None])
    with pytest.raises(ValueError, match="fits the kernels"):
        plan.lowered


JAX_GEOMETRIES = [(8, 3, "van", 4096), (8, 3, "cauchy", 131), (4, 2, "van-decode", 200),
                  (12, 4, "van", 96)]


@pytest.mark.parametrize("k,m,label,L", JAX_GEOMETRIES)
def test_plain_versions_match_jax_programs(k, m, label, L):
    """The plain versions against the reference's jitted `_packed_code`,
    `_packed_verify`, `_packed_delta` and `_packed_delta_flat` on the CPU."""
    mat = dict(_matrices(k, m))[label]
    prog = packed_gf.best_program(mat)
    kw = dict(sched=jpacked.best_program(mat), k=k, m=m)
    data = _data((2, k, L), [k, m, L])
    new = _data((2, k, L), [k, m, L, 1])
    parity = _data((2, m, L), [k, m, L, 2])
    got = packed_gf.packed_code(prog, torch.from_numpy(data)).numpy()
    assert np.array_equal(got, np.asarray(jpacked._packed_code(jnp.asarray(data), **kw)))
    cw = np.concatenate([data, got], axis=1)
    cw[0, k - 1, 0] ^= 1
    cw[1, k + m - 1, L - 1] ^= 0x80
    got_v = packed_gf.packed_verify(prog, torch.from_numpy(cw)).numpy()
    assert np.array_equal(got_v, np.asarray(jpacked._packed_verify(jnp.asarray(cw), **kw)))
    got_d = packed_gf.packed_delta(prog, *(torch.from_numpy(a) for a in (data, new, parity)))
    assert np.array_equal(got_d.numpy(), np.asarray(jpacked._packed_delta(
        jnp.asarray(data), jnp.asarray(new), jnp.asarray(parity), **kw)))
    bufs = [np.ascontiguousarray(a[:, j]).reshape(-1) for a in (data, new, parity)
            for j in range(a.shape[1])]
    got_f = packed_gf.packed_delta_flat(
        prog, *([torch.from_numpy(b) for b in bufs[s]] for s in
                (slice(0, k), slice(k, 2 * k), slice(2 * k, None))), L)
    want_f = jpacked._packed_delta_flat(
        tuple(jnp.asarray(b) for b in bufs[:k]), tuple(jnp.asarray(b) for b in bufs[k:2 * k]),
        tuple(jnp.asarray(b) for b in bufs[2 * k:]), chunk=L, **kw)
    assert np.array_equal(got_f.numpy(), np.asarray(want_f))
    assert np.array_equal(got_f.numpy(), got_d.numpy())


@pytest.mark.parametrize("L", [64, 131])
def test_legacy_row_schedule(L):
    """A (chunk, power) row schedule is lowered to the tower program: the
    reference's legacy branch gives the same bytes."""
    mat = isa_cauchy_matrix(8, 3)[8:]
    rows = packed_gf.plane_schedule(mat)
    data = _data((2, 8, L), L)
    want = np.asarray(jpacked._packed_code(jnp.asarray(data), sched=rows, k=8, m=3))
    assert np.array_equal(packed_gf.packed_code(rows, torch.from_numpy(data)).numpy(), want)
    assert np.array_equal(want, jpacked.packed_code_host(mat, data))
    lowered = packed_gf.lower_program(rows, 8)
    assert lowered.prog == packed_gf.naive_program(mat)
    assert np.array_equal(_model(lowered, data), want)
    cw = torch.from_numpy(np.concatenate([data, want], axis=1))
    assert not packed_gf.packed_verify(lowered, cw).any()


def test_wrappers_take_views_and_out():
    """A strided slice of codewords is coded as its dense copy; `out` is
    written when it fits and ignored when it does not."""
    mat = isa_rs_vandermonde_matrix(8, 3)[8:]
    plan = packed_gf.PackedPlan(mat)
    cw = torch.from_numpy(_data((2, 11, 300), 5))
    want = packed_gf.packed_code_host(mat, cw[:, :8].numpy())
    out = torch.empty((2, 3, 300), dtype=torch.uint8)
    got = plan(cw[:, :8], out=out)
    assert got is out and np.array_equal(out.numpy(), want)
    wrong = torch.empty((2, 3, 299), dtype=torch.uint8)
    got = plan(cw[:, :8], out=wrong)
    assert got is not wrong and np.array_equal(got.numpy(), want)


def test_wrappers_refuse_other_devices():
    """No fallback: a tensor that is neither on the CPU nor on CUDA raises."""
    mat = isa_rs_vandermonde_matrix(4, 2)[4:]
    data = torch.empty((1, 4, 16), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        packed_gf.packed_code(packed_gf.best_program(mat), data)
    with pytest.raises(TypeError):
        packed_gf.packed_code(packed_gf.best_program(mat), torch.zeros((1, 4, 16)))


def _pair(k=8, m=3, technique="reed_sol_van"):
    profile = {"k": str(k), "m": str(m), "technique": technique}
    return (registry.instance().factory("tpu", dict(profile), device="cpu"),
            jregistry.instance().factory("tpu", dict(profile)))


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy"])
def test_verify_array_every_shard_position(technique):
    """A one-byte corruption at every shard position, data and parity: the
    bitmap equals the reference's verify_array_host and the expected bits
    (data chunk j: the rows whose coefficient on j is nonzero; parity row
    i: bit i); a clean codeword gives 0."""
    ours, ref = _pair(technique=technique)
    k, m = 8, 3
    mat = ours.distribution_matrix()[k:]
    data = _data((k + m + 1, k, 256), 7)
    parity = ours.encode_array(data).numpy()
    cw = np.concatenate([data, parity], axis=1)
    for pos in range(k + m):
        cw[pos, pos, 17 * pos] ^= 1 << (pos % 8)
    before = dispatch.VERIFY_LAUNCHES.snapshot()["launches"]
    got = ours.verify_array(cw).numpy()
    assert dispatch.VERIFY_LAUNCHES.snapshot()["launches"] == before + 1
    assert np.array_equal(got, ref.verify_array_host(cw))
    assert np.array_equal(got, ours.verify_array_host(cw))
    for pos in range(k + m):
        want = (sum(1 << i for i in range(m) if mat[i, pos]) if pos < k else 1 << (pos - k))
        assert got[pos] == want, pos
    assert got[k + m] == 0


def test_verify_array_matches_jax_verify_array():
    ours, ref = _pair()
    data = _data((4, 8, 128), 9)
    cw = np.concatenate([data, ours.encode_array_host(data)], axis=1)
    cw[2, 3, 5] ^= 0xFF
    assert np.array_equal(ours.verify_array(cw).numpy(), np.asarray(ref.verify_array(cw)))


@pytest.mark.parametrize("chunk", [4096, 300])
def test_encode_delta_device(chunk):
    """The RMW delta over flat per-shard buffers equals the reference's
    encode_delta_host and a full re-encode of the new data, counted as one
    dispatch."""
    ours, ref = _pair()
    k, m, S = 8, 3, 3
    old = _data((S, k, chunk), [chunk, 1])
    new = _data((S, k, chunk), [chunk, 2])
    parity = ours.encode_array(old).numpy()
    shards = lambda a: [torch.from_numpy(np.ascontiguousarray(a[:, j]).reshape(-1))
                        for j in range(a.shape[1])]
    before = dispatch.LAUNCHES.snapshot()["launches"]
    got = ours.encode_delta_device(shards(old), shards(new), shards(parity), chunk).numpy()
    assert dispatch.LAUNCHES.snapshot()["launches"] == before + 1
    assert np.array_equal(got, ref.encode_delta_host(old, new, parity))
    assert np.array_equal(got, ours.encode_delta_host(old, new, parity))
    assert np.array_equal(got, ref.encode_array_host(new))


def test_encode_array_host_is_the_packed_program():
    ours, ref = _pair(technique="cauchy")
    data = _data((2, 8, 200), 3)
    assert np.array_equal(ours.encode_array_host(data), ref.encode_array_host(data))
    assert np.array_equal(ours.encode_array_host(data),
                          jpacked.packed_code_host(ours.distribution_matrix()[8:], data))


@pytest.mark.parametrize("L,tier", [(4096, "swar"), (8200, "packed"), (200, "xor_matmul")])
def test_device_coder_tier_choice(monkeypatch, L, tier):
    """L % 128 == 0 takes the SWAR tier, a ragged L with at least
    PACKED_MIN_BYTES of input the packed tier, a smaller one xor_matmul;
    each call counts one launch (decode: also DECODE_LAUNCHES), and each
    equals the reference byte for byte."""
    calls = {"swar": 0, "packed": 0, "xor_matmul": 0}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(swar_gf, "swar_code_reference",
                        counted("swar", swar_gf.swar_code_reference))
    monkeypatch.setattr(packed_gf, "packed_code_reference",
                        counted("packed", packed_gf.packed_code_reference))
    monkeypatch.setattr(matrix_codec, "xor_matmul", counted("xor_matmul", matrix_codec.xor_matmul))
    ours, ref = _pair()
    S = 1 if tier == "xor_matmul" else 2
    data = _data((S, 8, L), L)
    assert (data.size >= packed_gf.PACKED_MIN_BYTES) == (tier != "xor_matmul")
    snap = lambda: [c.snapshot()["launches"] for c in
                    (dispatch.LAUNCHES, dispatch.DECODE_LAUNCHES, dispatch.VERIFY_LAUNCHES)]
    before = snap()
    parity = ours.encode_array(data)
    assert np.array_equal(parity.numpy(), ref.encode_array_host(data))
    assert snap() == [before[0] + 1, before[1], before[2]]
    assert calls == {name: int(name == tier) for name in calls}
    erasures = [0, 9]
    full = np.concatenate([data, parity.numpy()], axis=1)
    rec = ours.decode_array(erasures, full[:, ours.decode_index(erasures)])
    assert np.array_equal(rec.numpy(), full[:, erasures])
    assert snap() == [before[0] + 2, before[1] + 1, before[2]]
    assert calls == {name: 2 * int(name == tier) for name in calls}
    out = torch.empty((S, 3, L), dtype=torch.uint8)
    got = ours.encode_array(data, out=out)
    assert np.array_equal(got.numpy(), parity.numpy())
    assert (got is out) == (tier == "packed")


# The corners of the profiles plugin `tpu` takes (Cauchy has no k, m cap; k +
# m <= 256): the widest encode of each shape class and a 16-erasure decode.
def _wide_matrix(label):
    k, m = (int(x) for x in label.split("-")[0][1:].split("_"))
    full = isa_cauchy_matrix(k, m)
    if label.endswith("-decode"):
        return isa_decode_matrix(full, list(range(m)), k)[0]
    return full[k:]


# label -> threads a block of its ring program (its outputs stay live to the
# end, so about k + m + 3 slots: 128 threads hold 113, 64 hold 227)
WIDE_CAUCHY = {"c128_16": 64, "c96_8": 128, "c248_8": 32, "c200_56": 32, "c2_254": 32,
               "c128_16-decode": 64}


@pytest.mark.parametrize("label", WIDE_CAUCHY)
def test_wide_cauchy_ring_program_fits_the_kernels(label):
    """Every profile corner lowers with no op limit: the ring program fits a
    block (Cauchy(96,8)'s 2984 ops: one 16 KB tile of op rows beside 104
    slots at 128 threads), its operand computes the reference's bytes
    (`gf_matmul`) on a small stripe, and the delta's 2k + 2m rows fit
    MAX_ROWS."""
    mat = _wide_matrix(label)
    m, k = mat.shape
    ring = packed_gf.LoweredProgram(packed_gf.ring_program(mat))
    assert ring.threads == WIDE_CAUCHY[label]
    assert packed_gf.shared_bytes(len(ring.ops), k, m, ring.nslots,
                                  ring.threads) <= packed_gf.SMEM_LIMIT
    data = _data((1, k, 7), [k, m])
    assert np.array_equal(_model(ring, data)[0], gf_matmul(mat, data[0]))
    assert 2 * (k + m) <= packed_gf.MAX_ROWS


def test_kernel_program_of_a_wide_cauchy_code_skips_cse(monkeypatch):
    """Cauchy(128,16): the tower leaves (1024) cannot fit a block of the ring
    program's threads, so kernel_program builds neither the CSE nor the
    tower program (CSE alone takes minutes there), and memoizes its choice."""
    def refuse(_mat):
        raise AssertionError("cse_program called")

    monkeypatch.setattr(packed_gf, "cse_program", refuse)
    monkeypatch.setattr(packed_gf, "naive_program", refuse)
    monkeypatch.setattr(packed_gf, "_KERNEL_MEMO", {})
    mat = _wide_matrix("c128_16")
    assert packed_gf.tower_leaves(mat) == 1024
    lowered = packed_gf.kernel_program(mat)
    assert lowered.prog == packed_gf.ring_program(mat)
    assert packed_gf.kernel_program(mat) is lowered


def _row_table(*groups):
    """The (address, stripe stride) rows the kernels read: one entry per row
    of each (S, n, L) tensor, in order."""
    return [(g.data_ptr() + i * g.stride(1), g.stride(0)) for g in groups
            for i in range(g.shape[1])]


def _expand(descriptors):
    """The row table csrc/packed_gf.cu builds from group descriptors."""
    return [(base + i * rstride, sstride) for base, sstride, rstride, rows in descriptors
            for i in range(rows)]


def test_group_descriptors_give_the_row_table():
    """Group descriptors expand to one (address, stripe stride) row per row
    of a dense tensor, of a strided view of codewords, and of 22 flat shard
    buffers (the delta's old, new and parity of RS(8,3), and its output)."""
    dense = torch.zeros((4, 11, 300), dtype=torch.uint8)
    view = packed_gf._stripes(dense[:, :8], 8)
    assert view.data_ptr() == dense.data_ptr()
    for t in (dense, view):
        assert _expand([packed_gf.group(t)]) == _row_table(t)
    bufs = [torch.zeros(3 * 4096, dtype=torch.uint8).view(-1, 1, 4096) for _ in range(19)]
    out = torch.zeros((3, 3, 4096), dtype=torch.uint8)
    groups = [packed_gf.group(b) for b in (*bufs, out)]
    assert len(_expand(groups)) == 22
    assert _expand(groups) == _row_table(*bufs, out)


def test_plan_builds_best_program_only_for_the_cpu(monkeypatch):
    """A plan builds best_program at its first CPU use, never before (so a
    CUDA plan of a wide code never runs cse_program)."""
    calls = []
    best = packed_gf.best_program
    monkeypatch.setattr(packed_gf, "best_program", lambda mat: calls.append(1) or best(mat))
    mat = isa_rs_vandermonde_matrix(8, 3)[8:]
    plan = packed_gf.PackedPlan(mat)
    verify = packed_gf.PackedVerifyPlan(mat)
    assert not calls
    assert plan.lowered.prog == best(mat)
    assert not calls
    data = _data((1, 8, 64), 21)
    got = plan(torch.from_numpy(data))
    assert calls == [1]
    assert np.array_equal(got.numpy(), jpacked.packed_code_host(mat, data))
    cw = np.concatenate([data, got.numpy()], axis=1)
    assert not verify(torch.from_numpy(cw)).any()
    assert calls == [1, 1]
