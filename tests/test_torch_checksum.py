"""The port's checksum service (`ops/checksum_offload.py`) on the CPU,
held against the JAX package's under JAX_PLATFORMS=cpu.

The copies of the reference's jax-free helpers (`_contribution_matrix`,
`_zero_const`, `crc32c_host_rows`) are pinned to its output; the plain
version equals the reference's `crc32c_device` on JAX's CPU backend and the
host oracle; a numpy walk of csrc/crc32c.cu's decomposition (its
shared-memory image of 5-bit and nibble tables and the addresses it reads
them at, the masked aligned vectors, two vectors a lane a step, each
lane's fold shift and the tail's inverse shift) gives crc32c at every
length and alignment;
`checksum_blocks` and the aggregator launch, record and count as the
reference's do (the reference at dispatch width 1, deltas compared); and a
failed or refused launch is EIO with the backend DEGRADED and nothing
recomputed on the host (ROADMAP fault C8)."""

import numpy as np
import pytest
import torch

import ceph_tpu.ops.checksum_offload as jco
import ceph_tpu.ops.dispatch as jdispatch
import ceph_tpu.ops.offload_runtime as jruntime
from ceph_tpu.parallel import dispatch as jshard

import ceph_tpu_torch.ops.checksum_offload as tco
from ceph_tpu_torch.codec.interface import EcError
from ceph_tpu_torch.common.errs import EIO
from ceph_tpu_torch.common.fault_injector import global_injector
from ceph_tpu_torch.ops import dispatch as tdispatch
from ceph_tpu_torch.ops import offload_runtime as truntime
from ceph_tpu_torch.ops.flight_recorder import flight_recorder
from ceph_tpu_torch.ops.guard import device_guard
from ceph_tpu_torch.utils.crc32c import crc32c

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

LENGTHS = (1, 3, 64, 100, 4095, 4096, 4097)


@pytest.fixture(autouse=True)
def _pin_reference():
    settings = jshard.settings()
    jshard.configure(devices=1)
    yield
    jshard.configure(*settings)
    global_injector().clear()
    g = device_guard()
    g.mark_healthy()
    g.configure(timeout_ms=20000, probe_interval_ms=2000)


@pytest.mark.parametrize("L", LENGTHS)
def test_helpers_match_reference(L):
    assert np.array_equal(tco._contribution_matrix(L), jco._contribution_matrix(L))
    assert tco._zero_const(L) == jco._zero_const(L)
    rows = np.random.default_rng(L).integers(0, 256, (3, L), dtype=np.uint8)
    assert np.array_equal(tco.crc32c_host_rows(rows), jco.crc32c_host_rows(rows))


@pytest.mark.parametrize("S", [1, 5, 64])
@pytest.mark.parametrize("L", [1, 3, 100, 4096, 4097])
def test_plain_matches_reference_device_and_host(S, L):
    rows = np.random.default_rng(S * 7919 + L).integers(0, 256, (S, L), dtype=np.uint8)
    ours = tco.crc32c_device(torch.from_numpy(rows))
    assert ours.dtype == torch.int64 and tuple(ours.shape) == (S,)
    ref = np.asarray(jco.crc32c_device(rows))
    host = tco.crc32c_host_rows(rows)
    assert np.array_equal(ours.numpy(), ref.astype(np.int64))
    assert np.array_equal(ours.numpy(), host.astype(np.int64))


def _tables(image, w, bits, to, stride, n, base):
    """XOR of lookups 0 .. n - 1 the way the kernel's `look` makes them, for
    every lane at once: field f (bits `bits` f ..) of the little-endian
    words w (a list of per-lane arrays) moved to bit `to` of the byte
    address ((x & mask) | base) + f stride (a funnel shift where it
    straddles two words), and that word of the image read."""
    out = np.zeros_like(w[0])
    mask = ((1 << bits) - 1) << to
    for f in range(n):
        word, off = divmod(bits * f, 32)
        if off + bits > 32 and word + 1 < len(w):
            x = ((w[word + 1] << 32 | w[word]) >> (off - to)) & 0xFFFFFFFF
        elif off >= to:
            x = w[word] >> (off - to)
        else:
            x = (w[word] << (to - off)) & 0xFFFFFFFF
        out ^= image[(((x & mask) | base) + f * stride) >> 2]
    return out


def kernel_walk(buf: bytes, base: int, L: int) -> int:
    """crc32c of buf[base:base + L] computed the way csrc/crc32c.cu walks
    a row whose address is `base` modulo 16: the shared-memory image built
    from the operand as the kernel builds it, every lookup through the
    kernel's address, the 32 lanes side by side, each taking two vectors
    of every 64."""
    image = tco.kernel_image(tco.kernel_tables()).astype(np.int64)
    lanes = np.arange(32, dtype=np.int64)
    end = base + L
    abase, aend = base & ~15, (end + 15) & ~15
    nvec, head, tail = (aend - abase) // 16, base - abase, aend - end
    lead = (64 - nvec % 64) % 64
    masked = np.zeros(16 * nvec, dtype=np.uint8)
    masked[head:16 * nvec - tail] = np.frombuffer(buf, dtype=np.uint8)[base:end]
    words = np.concatenate([np.zeros((lead, 4), dtype=np.int64),
                            masked.view("<u4").reshape(nvec, 4).astype(np.int64)])
    acc = np.zeros(32, dtype=np.int64)
    for step in range((nvec + lead) // 64):
        piece = words[64 * step: 64 * step + 64].reshape(32, 8)  # lane i: vectors 2i, 2i + 1
        acc = (_tables(image, [acc], 5, 2, 128, tco.S_TABLES, 4 * tco.IMG_S)
               ^ _tables(image, list(piece.T), 5, 2, 128, tco.L_TABLES, 4 * tco.IMG_L))
    fold = _tables(image, [acc], 4, 7, 2048, 8, 4 * tco.IMG_FOLD + 4 * lanes)
    lin = int(np.bitwise_xor.reduce(fold))
    u = image[tco.IMG_UNSHIFT + 128 * tail:]
    r = 0
    for k in range(8):
        r ^= int(u[16 * k + ((lin >> (4 * k)) & 15)])
    return r ^ tco._zero_const(L)


@pytest.mark.parametrize("L", [1, 3, 15, 16, 17, 100, 511, 512, 513, 4095, 4096, 4097])
def test_kernel_decomposition_gives_crc32c(L):
    """The kernel's arithmetic, walked in numpy over its operand: every
    length, at every alignment of the row's start modulo 16."""
    op = tco.kernel_tables()
    assert op.shape == (tco.KERNEL_WORDS,) and op.dtype == np.uint32
    assert tco.kernel_image(op).shape == (tco.IMG_UNSHIFT + 16 * 8 * 16,)
    buf = np.random.default_rng(L).integers(0, 256, L + 48, dtype=np.uint8).tobytes()
    for base in (0, 1, 5, 15, 16, 31):
        assert kernel_walk(buf, base, L) == crc32c(buf[base:base + L]), base


@pytest.mark.parametrize("pattern", ["zero", "constant", "zero-heavy"])
@pytest.mark.parametrize("L", [1024, 4097])
def test_kernel_decomposition_on_broadcast_rows(pattern, L):
    """The kernel's arithmetic on the rows whose table reads broadcast
    (every lane reads one entry): all zero, one constant byte, and random
    bytes among long zero runs."""
    rng = np.random.default_rng(L)
    if pattern == "zero":
        data = np.zeros(L + 48, dtype=np.uint8)
    elif pattern == "constant":
        data = np.full(L + 48, 0xA7, dtype=np.uint8)
    else:
        data = rng.integers(0, 256, L + 48, dtype=np.uint8)
        data[rng.random(L + 48) < 0.95] = 0
    buf = data.tobytes()
    for base in (0, 7, 16):
        assert kernel_walk(buf, base, L) == crc32c(buf[base:base + L]), base


def _chunks(seed):
    """Blocks of mixed lengths (BlueStore groups stored forms by length),
    empty ones included, interleaved so that input order matters."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(24):
        n = [4096, 4096, 1500, 0, 4096, 77][i % 6]
        out.append(rng.integers(0, 256, n, dtype=np.uint8).tobytes())
    return out


@pytest.mark.parametrize("offload", [False, True])
def test_checksum_blocks_matches_reference(offload):
    chunks = _chunks(3)
    ours = tco.checksum_blocks(chunks, offload=offload, device="cpu")
    assert ours == jco.checksum_blocks(chunks, offload=offload)
    assert ours == [crc32c(c) for c in chunks]
    # under CSUM_OFFLOAD_MIN_BYTES the host loop runs, no launch
    agg = tco.default_csum_aggregator()
    l0 = agg.perf.get("launches")
    small = [b"x" * 100, b"", b"y" * 1000]
    assert tco.checksum_blocks(small, device="cpu") == [crc32c(c) for c in small]
    assert agg.perf.get("launches") == l0
    assert tco.checksum_blocks([], device="cpu") == []


def test_aggregator_launches_records_and_perf_match_reference():
    """One window of submissions of three lengths, then the reaps: launch
    counts, dispatch counters, flight records and perf keys move alike in
    both packages."""
    jagg, tagg = jco.default_csum_aggregator(), tco.default_csum_aggregator()
    before = {"jax": jagg.perf.dump(), "torch": tagg.perf.dump()}
    d0 = {"jax": jdispatch.LAUNCHES.snapshot(), "torch": tdispatch.LAUNCHES.snapshot()}
    flight_recorder().reset()
    for chunks in (_chunks(4), _chunks(5)):
        assert tco.checksum_blocks(chunks, device="cpu") == jco.checksum_blocks(chunks)
    after = {"jax": jagg.perf.dump(), "torch": tagg.perf.dump()}

    def moved(pkg):
        return {k: v - before[pkg][k] for k, v in after[pkg].items()
                if isinstance(v, (int, float))}

    assert moved("torch") == moved("jax")
    assert moved("torch")["launches"] == 6
    for pkg, mod in (("jax", jdispatch), ("torch", tdispatch)):
        d1 = mod.LAUNCHES.snapshot()
        assert d1["launches"] - d0[pkg]["launches"] == 6
    assert (tdispatch.LAUNCHES.snapshot()["stripes"] - d0["torch"]["stripes"]
            == jdispatch.LAUNCHES.snapshot()["stripes"] - d0["jax"]["stripes"])
    records = flight_recorder().records()
    assert len(records) == 6 and not any(r["flags"]["error"] for r in records)
    ours, ref = truntime.offload_perf_dump(), jruntime.offload_perf_dump()
    assert {k for k in ours if k.startswith("csum.")} == {k for k in ref if k.startswith("csum.")}
    assert truntime.service("csum").lane == jruntime.service("csum").lane == "background"


def test_failed_launch_is_eio_degraded_and_not_recomputed(monkeypatch):
    """Fault C8: an armed launch fault raises EIO to every rider and marks
    the backend DEGRADED; while DEGRADED (the probe fails: no card) the
    next launch is refused with EIO; the host oracle is never called."""
    def no_host(*args, **kwargs):
        raise AssertionError("a launch fell to the host")

    monkeypatch.setattr(tco, "crc32c_host_rows", no_host)
    chunks = [bytes([i]) * 4096 for i in range(8)]
    fb0 = tdispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
    global_injector().inject("codec.launch", 5, hits=1)
    with pytest.raises(EcError) as e:
        tco.checksum_blocks(chunks, device="cpu")
    assert e.value.errno == -EIO and device_guard().degraded
    with pytest.raises(EcError):
        tco.checksum_blocks(chunks, device="cpu")
    assert tdispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fb0
    assert tco.default_csum_aggregator().perf.get("host_fallbacks") == 0
    device_guard().mark_healthy()
    assert tco.checksum_blocks(chunks, device="cpu") == [crc32c(c) for c in chunks]


def test_cuda_tensor_raises_without_a_card():
    """A CUDA tensor launches the kernel or raises; with no card there is
    no CUDA tensor to make, and the default device raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: chip_smoke.py holds the kernel")
    with pytest.raises(RuntimeError):
        tco.default_csum_aggregator().submit_blocks(np.zeros((2, 4096), np.uint8))
