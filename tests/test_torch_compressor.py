"""The port's compressor family (`compressor/registry.py`,
`compressor/device.py`) on the CPU, held against the JAX package's under
JAX_PLATFORMS=cpu.

The registry resolves the same names and refuses the same unknown ones;
the host oracle `transform_rows` (a copy of a jax-free helper of the
reference) and the plain version equal the reference's `transform_rows` and
its `transform_rows_device` on JAX's CPU backend, at lengths whose 64-byte
cells fall inside one plane and lengths where they straddle two; blobs are
byte-identical both ways and each package decompresses the other's;
a numpy walk of csrc/compress_transform.cu's tile path (its schedule,
staging offsets, __byte_perm selectors and flag placement) equals both
host transforms; a CPU tensor takes the plain version at every length
the kernel's two paths take, and counts no launch on either;
`compress_batch` equals `compress` and launches as the reference's does;
a truncated blob is loud; and a failed transform launch is EIO with the
backend DEGRADED and nothing recomputed on the host (ROADMAP fault C8)."""

import importlib.util

import numpy as np
import pytest
import torch

import ceph_tpu.compressor.device as jdev
from ceph_tpu.compressor import get_compressor as j_get
from ceph_tpu.parallel import dispatch as jshard

import ceph_tpu_torch.compressor.device as tdev
from ceph_tpu_torch.codec.interface import EcError
from ceph_tpu_torch.common.errs import EIO
from ceph_tpu_torch.common.fault_injector import global_injector
from ceph_tpu_torch.compressor import get_compressor as t_get
from ceph_tpu_torch.ops import dispatch as tdispatch
from ceph_tpu_torch.ops.guard import device_guard

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

LPS = (64, 128, 192, 4032, 4096, 4160)
HAVE_ZSTD = importlib.util.find_spec("zstandard") is not None


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


def rows_of(seed, S, Lp):
    """Sparse rows: whole zero planes and zero cells, so flags vary."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (S, Lp), dtype=np.uint8)
    rows[:, (np.arange(Lp) % 64) >= 16] = 0
    rows[::3] = 0
    return rows


@pytest.mark.parametrize("name", ["none", "zlib", "zstd", "device"])
def test_registry_matches_reference(name):
    if name == "zstd" and not HAVE_ZSTD:
        pytest.skip("the zstandard module is not installed")
    ours, ref = t_get(name), j_get(name)
    assert ours.name == ref.name == name and t_get(name) is ours
    data = b"compress me " * 500 + b"\x00" * 100
    assert ours.compress(data) == ref.compress(data)
    assert ours.decompress(ref.compress(data)) == data


def test_unknown_compressor_raises():
    for get in (t_get, j_get):
        with pytest.raises(ValueError):
            get("snappy")


@pytest.mark.parametrize("Lp", LPS)
def test_transforms_match_reference(Lp):
    rows = rows_of(Lp, 5, Lp)
    want = jdev.transform_rows(rows)
    assert np.array_equal(tdev.transform_rows(rows), want)
    assert np.array_equal(np.asarray(jdev.transform_rows_device(rows)), want)
    plain = tdev.transform_rows_device(torch.from_numpy(rows))
    assert plain.dtype == torch.uint8 and np.array_equal(plain.numpy(), want)
    assert np.array_equal(tdev.transform_rows_plain(torch.from_numpy(rows)).numpy(), want)


def byte_perm(x, y, sel):
    """CUDA's __byte_perm(x, y, sel) on uint32 arrays: byte n of the result
    is byte (sel >> 4n) & 7 of the 8 bytes y:x."""
    pool = [(x >> (8 * k)) & 0xFF for k in range(4)] + [(y >> (8 * k)) & 0xFF for k in range(4)]
    return sum(pool[(sel >> (4 * n)) & 7] << (8 * n) for n in range(4))


def transpose4(a0, a1, a2, a3):
    """The kernel's 4x4 byte transpose: 8 __byte_perm with its selectors."""
    t0, t1 = byte_perm(a0, a1, 0x5140), byte_perm(a0, a1, 0x7362)
    t2, t3 = byte_perm(a2, a3, 0x5140), byte_perm(a2, a3, 0x7362)
    return (byte_perm(t0, t2, 0x5410), byte_perm(t0, t2, 0x7632),
            byte_perm(t1, t3, 0x5410), byte_perm(t1, t3, 0x7632))


def tile_walk(rows: np.ndarray, warps: int) -> np.ndarray:
    """csrc/compress_transform.cu's tile path walked in numpy, 32 lanes side
    by side: `warps` persistent warps step through the tiles by (s, j)
    increments as the kernel does, stage each into the skewed buffer, read
    and transpose its words with the kernel's selectors, store 16 bytes a
    plane and lane at the kernel's offsets, and OR and write the flags as
    it does.  Bytes no store reaches keep a poison value."""
    S, Lp = rows.shape
    m = Lp // 4096
    out = np.full((S, Lp + Lp // 64), 0xA5, dtype=np.uint8)
    lane = np.arange(32)
    rq, q = lane & 3, lane >> 2
    words = rows.view("<u4").astype(np.int64)  # (S, Lp // 4)
    ds, dj = warps // m, warps % m
    for t0 in range(warps):
        s, j, t = t0 // m, t0 % m, t0
        while t < S * m:
            buf = np.zeros(4 * 264, dtype=np.int64)
            for k in range(8):
                idx = 32 * k + lane
                r, g = idx >> 2, idx & 3
                for x in range(4):
                    buf[16 * r + 8 * (r >> 4) + 4 * g + x] = words[s, 1024 * j + 16 * r + 4 * g + x]
            bits = np.zeros(32, dtype=np.int64)
            for u in range(2):
                a = [buf[264 * rq + q + 16 * i + 8 * u] for i in range(16)]
                cols = [transpose4(*a[4 * k: 4 * k + 4]) for k in range(4)]  # [block][c]
                for c in range(4):
                    p = 4 * (q + 8 * u) + c
                    v = np.stack([cols[k][c] for k in range(4)], axis=1)  # (32, 4) words
                    vb = v.astype("<u4").view(np.uint8).reshape(32, 16)
                    for ln in range(32):
                        off = 64 * j + 16 * rq[ln] + 64 * m * p[ln]
                        out[s, off: off + 16] = vb[ln]
                    bits |= (v != 0).any(axis=1).astype(np.int64) << (4 * u + c)
            bits |= bits[lane ^ 1]
            bits |= bits[lane ^ 2]
            for ln in np.flatnonzero(rq < 2):
                nib = (int(bits[ln]) >> (4 * int(rq[ln]))) & 15
                base = Lp + j + m * (32 * int(rq[ln]) + 4 * int(q[ln]))
                if m == 1:
                    word = (nib * 0x204081) & 0x01010101
                    out[s, base: base + 4] = np.frombuffer(word.to_bytes(4, "little"), np.uint8)
                else:
                    for c in range(4):
                        out[s, base + m * c] = (nib >> c) & 1
            ns, nj = s + ds, j + dj
            if nj >= m:
                ns, nj = ns + 1, nj - m
            s, j, t = ns, nj, t + warps
    return out


@pytest.mark.parametrize("Lp,S,warps", [(4096, 5, 3), (8192, 5, 4), (262144, 2, 24)])
def test_tile_walk_matches_reference(Lp, S, warps):
    """The tile path's arithmetic, byte for byte against both packages'
    host transform; every output byte written once by some warp."""
    rows = rows_of(Lp + 1, S, Lp)
    rows[0, 64:128] = 0    # a whole zero row of the first tile: no plane all zero
    rows[1, :] = 7         # a constant row: every flag 1
    got = tile_walk(rows, warps)
    want = jdev.transform_rows(rows)
    assert np.array_equal(tdev.transform_rows(rows), want)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("Lp", LPS + (8192, 65536, 262144, 12288))
def test_cpu_rows_count_no_kernel_launch(Lp):
    """At the lengths of both kernel paths, a CPU tensor takes the plain
    version (the reference's transform, read through a strided view too)
    and moves neither the launch count nor either path's count."""
    rows = rows_of(Lp + 2, 3, Lp + 1)
    launches = tdev.transform_rows_device.launches
    paths = dict(tdev.transform_rows_device.path_launches)
    for start in (0, 1):
        view = rows[:, start:start + Lp]
        got = tdev.transform_rows_device(torch.from_numpy(rows)[:, start:start + Lp])
        assert np.array_equal(got.numpy(), jdev.transform_rows(np.ascontiguousarray(view)))
    assert tdev.transform_rows_device.launches == launches
    assert tdev.transform_rows_device.path_launches == paths
    assert set(paths) == {"tiles", "general"}


@pytest.mark.parametrize("n", [1, 63, 64, 100, 4096, 4103])
def test_blobs_identical_and_cross_decompress(n):
    rng = np.random.default_rng(n)
    ours, ref = t_get("device"), j_get("device")
    for data in (bytes(n), rng.bytes(n), b"\x07" * n, rows_of(n, 1, 64 * -(-n // 64))
                 .tobytes()[:n]):
        blob = ours.compress(data)
        assert blob == ref.compress(data)
        assert ours.decompress(blob) == data and ref.decompress(blob) == data
        assert ours.decompress(ref.compress(data)) == data


def test_compress_batch_matches_compress_and_reference():
    """Small batches take the host transform; a batch over
    COMPRESS_OFFLOAD_MIN_BYTES rides the aggregator, one launch a length
    group, in both packages."""
    ours = t_get("device")
    small = [b"a" * 100, bytes(64)]
    assert ours.compress_batch(small, device="cpu") == [ours.compress(b) for b in small]
    blocks = [rows_of(i, 1, 4096).tobytes() for i in range(10)] + [b"\x01" * 4000] * 3
    tagg, jagg = tdev.default_compress_aggregator(), jdev.default_compress_aggregator()
    t0, j0 = tagg.perf.get("launches"), jagg.perf.get("launches")
    d0 = tdispatch.LAUNCHES.snapshot()["launches"]
    blobs = ours.compress_batch(blocks, device="cpu")
    assert blobs == [ours.compress(b) for b in blocks]
    assert blobs == j_get("device").compress_batch(blocks)
    assert all(ours.decompress(x) == b for x, b in zip(blobs, blocks))
    assert tagg.perf.get("launches") - t0 == jagg.perf.get("launches") - j0 == 2
    assert tdispatch.LAUNCHES.snapshot()["launches"] - d0 == 2


def test_truncated_blob_is_loud():
    ours = t_get("device")
    blob = ours.compress(rows_of(1, 2, 4096)[1].tobytes())
    with pytest.raises(ValueError):
        ours.decompress(blob[:-1])
    with pytest.raises(ValueError):
        ours.decompress(b"XXXX" + blob[4:])
    with pytest.raises(ValueError):
        tdev.transform_rows_device(torch.zeros((2, 100), dtype=torch.uint8))


def test_failed_compress_launch_is_eio(monkeypatch):
    def no_host(*args, **kwargs):
        raise AssertionError("a launch fell to the host")

    blocks = [rows_of(i, 1, 4096).tobytes() for i in range(10)]
    monkeypatch.setattr(tdev, "transform_rows", no_host)
    global_injector().inject("codec.launch", 5, hits=1)
    with pytest.raises(EcError) as e:
        t_get("device").compress_batch(blocks, device="cpu")
    assert e.value.errno == -EIO and device_guard().degraded
    assert tdev.default_compress_aggregator().perf.get("host_fallbacks") == 0
    device_guard().mark_healthy()
    monkeypatch.undo()
    assert t_get("device").compress_batch(blocks, device="cpu") == [
        t_get("device").compress(b) for b in blocks]
