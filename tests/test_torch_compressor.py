"""The port's compressor family (`compressor/registry.py`,
`compressor/device.py`) on the CPU, held against the JAX package's under
JAX_PLATFORMS=cpu.

The registry resolves the same names and refuses the same unknown ones;
the host oracle `transform_rows` (a copy of a jax-free helper of the
reference) and the plain version equal the reference's `transform_rows` and
its `transform_rows_device` on JAX's CPU backend, at lengths whose 64-byte
cells fall inside one plane and lengths where they straddle two; blobs are
byte-identical both ways and each package decompresses the other's;
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
