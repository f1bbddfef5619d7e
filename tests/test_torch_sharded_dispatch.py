"""The reference's sharded-dispatch cases (`tests/test_sharded_dispatch.py`)
on the port, through `tests/torch_ported.py`: plugin `tpu`'s codecs on the
CPU (`cpu_tools`) and an 8-entry CPU mesh for the policy
(`use_devices([cpu] * 8)`), the port's counterpart of the reference's 8
virtual devices.  Then the port's own: the width-1 witness (with no mesh
the codec's launches stay on one device), the packed path's donation
into `out` over a mesh, and the dry run `dryrun_multichip`."""

import numpy as np
import pytest
import torch

from ceph_tpu_torch import graft_entry
from ceph_tpu_torch.codec import ErasureCodeTpuRs
from ceph_tpu_torch.gf import gf_matmul, isa_rs_vandermonde_matrix
from ceph_tpu_torch.ops import packed_gf, swar_gf
from ceph_tpu_torch.ops.dispatch import DEVICES_PER_LAUNCH, LAUNCHES, SHARDED_LAUNCHES
from ceph_tpu_torch.ops.guard import DeviceError
from ceph_tpu_torch.parallel import dispatch as shard_dispatch

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)
from torch_ported import collect, cpu_tools, load  # noqa: F401  (fixture)

CPU8 = [torch.device("cpu")] * 8

_ref = load("test_sharded_dispatch")
_shard_policy = _ref._shard_policy  # the reference's autouse fixture
collect(_ref, ["TestShardedEncode", "TestShardedAggregatorPath", "TestShardPolicy"], globals())


@pytest.fixture(autouse=True)
def _cpu_mesh(cpu_tools):
    """The port's codecs on the CPU, and eight CPU entries as the devices
    a mesh may span; the policy's defaults restored after."""
    with shard_dispatch.use_devices(CPU8):
        yield
    shard_dispatch.reset_for_tests()


def _rs(k=8, m=3):
    ec = ErasureCodeTpuRs(device="cpu")
    ec.init({"k": str(k), "m": str(m)})
    return ec


def _host_parity(ec, data):
    gfm = isa_rs_vandermonde_matrix(ec.k, ec.m)[ec.k:]
    return np.stack([gf_matmul(gfm, stripe) for stripe in data])


def _batch(S, k, L, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (S, k, L), dtype=np.uint8)


def test_width_one_witness_without_a_mesh():
    """With the default policy and no device list, the CPU sees no CUDA
    device: no mesh is built, every launch lands on bucket 1 and
    SHARDED_LAUNCHES does not move, and the SWAR tier runs as it did."""
    ec = _rs()
    data = _batch(64, 8, 4096, seed=60)
    with shard_dispatch.use_devices([]):
        assert shard_dispatch.shard_mesh(64) is None
        s0, d0 = SHARDED_LAUNCHES.snapshot(), DEVICES_PER_LAUNCH.snapshot()
        t0 = LAUNCHES.snapshot()
        parity = ec.encode_array(data).numpy()
        assert SHARDED_LAUNCHES.snapshot() == s0
        d1 = DEVICES_PER_LAUNCH.snapshot()
        assert {n: d1.get(n, 0) - d0.get(n, 0) for n in d1} == {**{n: 0 for n in d1}, 1: 1}
        assert LAUNCHES.snapshot()["launches"] - t0["launches"] == 1
    assert np.array_equal(parity, _host_parity(ec, data))


def test_width_one_witness_default_policy(monkeypatch):
    """The policy as a process without a device list sees it: the CUDA
    device count, 0 here and 1 on a one-card host, builds no mesh."""
    shard_dispatch.reset_for_tests()
    for count in (0, 1):
        monkeypatch.setattr(torch.cuda, "device_count", lambda count=count: count)
        shard_dispatch.reset_for_tests()
        assert shard_dispatch.shard_mesh(4096) is None
    shard_dispatch.reset_for_tests()


def test_use_devices_restores_the_list():
    with shard_dispatch.use_devices(CPU8[:2]):
        assert shard_dispatch.shard_mesh(64).size == 2
    mesh = shard_dispatch.shard_mesh(64)  # the fixture's eight again
    assert mesh is not None and mesh.size == 8


def test_a_coder_off_the_mesh_stays_on_its_device():
    """A mesh whose first device is not the coder's leaves the coder's
    launches on its device."""
    from ceph_tpu_torch.codec.matrix_codec import PLAN_CACHE

    ec = _rs()
    coder = PLAN_CACHE.encode_coder(ec.distribution_matrix()[8:], ec.device)
    assert coder.shard_mesh_for((64, 8, 4096)) is not None
    with shard_dispatch.use_devices([torch.device("meta")] * 8):
        assert shard_dispatch.shard_mesh(64) is not None
        assert coder.shard_mesh_for((64, 8, 4096)) is None


@pytest.mark.parametrize("S", [32, 37])
def test_packed_path_over_the_mesh(S):
    """L not a multiple of 128: every shard runs the packed kernel's plain
    version, and a dead `out` is written in place only with no padding."""
    ec = _rs()
    shard_dispatch.configure(min_batch=16)
    data = _batch(S, 8, 4100, seed=61)
    assert ec.encode_donatable(data.shape) == (S % 8 == 0)
    out = torch.empty((S, 3, 4100), dtype=torch.uint8)
    k0, w0 = packed_gf.launches["packed_code"], swar_gf.launches
    calls = []
    real = packed_gf.packed_code_reference
    packed_gf.packed_code_reference = lambda *a: calls.append(1) or real(*a)
    try:
        s0 = SHARDED_LAUNCHES.snapshot()["launches"]
        parity = ec.encode_array(data, out=out)
    finally:
        packed_gf.packed_code_reference = real
    assert SHARDED_LAUNCHES.snapshot()["launches"] - s0 == 1
    assert len(calls) == 8
    assert (parity.data_ptr() == out.data_ptr()) == (S % 8 == 0)
    assert np.array_equal(parity.numpy(), _host_parity(ec, data))
    # the CPU runs the plain versions: no kernel launch is counted
    assert (packed_gf.launches["packed_code"], swar_gf.launches) == (k0, w0)


def test_decode_classes_over_the_mesh():
    """One pattern of each erasure class decodes as one sharded launch,
    byte-exact against the single-device path."""
    ec = _rs()
    shard_dispatch.configure(min_batch=16)
    data = _batch(32, 8, 4096, seed=62)
    full = np.concatenate([data, _host_parity(ec, data)], axis=1)
    for erasures in ([0], [9], [0, 9], [0, 5, 10]):
        idx = ec.decode_index(erasures)
        survivors = np.ascontiguousarray(full[:, idx, :])
        s0 = SHARDED_LAUNCHES.snapshot()["launches"]
        rec = ec.decode_array(erasures, survivors).numpy()
        assert SHARDED_LAUNCHES.snapshot()["launches"] - s0 == 1
        with shard_dispatch.use_devices([]):
            single = ec.decode_array(erasures, survivors).numpy()
        assert np.array_equal(rec, full[:, erasures, :])
        assert np.array_equal(rec, single)


@pytest.mark.parametrize("n", [8, 4])
def test_dryrun_multichip_on_a_cpu_mesh(n):
    d0 = DEVICES_PER_LAUNCH.snapshot()
    got = graft_entry.dryrun_multichip(n, devices=CPU8[:n])
    assert got["live_sharded_launches"] == 2
    assert got["mesh"]["stripe"] * got["mesh"]["lane"] == n
    assert got["pod_mesh"]["pod"] == 2
    assert DEVICES_PER_LAUNCH.snapshot().get(n, 0) - d0.get(n, 0) >= 2
    assert shard_dispatch.settings() == (shard_dispatch.DEFAULT_MIN_BATCH,
                                         shard_dispatch.DEFAULT_DEVICES)


def test_dryrun_multichip_without_a_gpu_raises():
    with pytest.raises(DeviceError):
        graft_entry.dryrun_multichip(8)
    with pytest.raises(DeviceError):
        graft_entry.dryrun_multichip(2)
