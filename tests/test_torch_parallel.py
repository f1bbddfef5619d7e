"""The port's stripe-parallel layer (`ceph_tpu_torch/parallel/`) against the
JAX package's (`ceph_tpu/parallel/`), case by case of the reference's
`tests/test_parallel.py`: the reference on its conftest's 8 virtual CPU
devices (Pallas plans in interpret mode), the port on an 8-entry CPU mesh
(`devices=[cpu] * 8`), the same seeded numpy inputs into both.  Every
output is byte-exact between the two and against the host oracle; scrub
counts and masks are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ops.pallas_gf import CodingPlan as JCodingPlan
from ceph_tpu.parallel import mesh as jmesh
from ceph_tpu.parallel import sharded as jsharded

from ceph_tpu_torch.gf import (
    expand_matrix,
    isa_decode_matrix,
    isa_rs_vandermonde_matrix,
    xor_matmul_host_batch,
)
from ceph_tpu_torch.ops import swar_gf
from ceph_tpu_torch.ops.guard import DeviceError
from ceph_tpu_torch.ops.swar_gf import CodingPlan, pick_geometry
from ceph_tpu_torch.parallel import sharded
from ceph_tpu_torch.parallel.mesh import LANE_AXIS, POD_AXIS, STRIPE_AXIS, Mesh, make_mesh

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

CPU8 = [torch.device("cpu")] * 8


def _meshes(n=8, **kw):
    """(reference mesh on its virtual devices, port mesh on [cpu] * n)."""
    return jmesh.make_mesh(n, **kw), make_mesh(n, devices=CPU8[:n], **kw)


def _bit_matrix(k, m) -> np.ndarray:
    return np.asarray(expand_matrix(isa_rs_vandermonde_matrix(k, m)[k:]), dtype=np.uint8)


def _host_parity(k, m, data):
    return xor_matmul_host_batch(_bit_matrix(k, m), data)


def _batch(S, k, L, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (S, k, L), dtype=np.uint8)


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _encode_both(k, m, data, **mesh_kw):
    jm, pm = _meshes(**mesh_kw)
    bm = _bit_matrix(k, m)
    ref = jsharded.sharded_encode(jnp.asarray(bm), jsharded.shard_batch(jnp.asarray(data), jm), jm)
    ours = sharded.sharded_encode(torch.from_numpy(bm), sharded.shard_batch(data, pm), pm)
    return _np(ref), _np(ours)


class TestMesh:
    def test_default_axes(self):
        jm, pm = _meshes()
        assert pm.shape == dict(jm.shape) == {STRIPE_AXIS: 4, LANE_AXIS: 2}
        assert pm.axis_names == tuple(jm.axis_names)

    @pytest.mark.parametrize("lane", [1, 2, 4, 8])
    def test_lane_override(self, lane):
        jm, pm = _meshes(lane_parallelism=lane)
        assert pm.shape == dict(jm.shape)
        assert pm.shape[LANE_AXIS] == lane and pm.shape[STRIPE_AXIS] == 8 // lane

    def test_subset_of_devices(self):
        jm, pm = _meshes(4)
        assert pm.shape == dict(jm.shape)
        assert pm.size == 4

    def test_pod_mesh_axes(self):
        jm, pm = _meshes(pods=2)
        assert pm.shape == dict(jm.shape)
        assert pm.shape[POD_AXIS] == 2
        assert pm.axis_names == (POD_AXIS, STRIPE_AXIS, LANE_AXIS)

    def test_grid_holds_the_devices_in_order(self):
        devs = [torch.device("cpu")] * 4
        pm = make_mesh(devices=devs, lane_parallelism=2)
        assert isinstance(pm, Mesh) and pm.devices.shape == (2, 2)
        assert list(pm.devices.flat) == devs

    def test_bad_splits_raise(self):
        with pytest.raises(ValueError):
            make_mesh(6, pods=4, devices=CPU8)
        with pytest.raises(ValueError):
            make_mesh(8, lane_parallelism=3, devices=CPU8)
        with pytest.raises(ValueError):
            make_mesh(9, devices=CPU8)


class TestNoGpu:
    def test_make_mesh_without_devices_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
        with pytest.raises(DeviceError):
            make_mesh()
        with pytest.raises(DeviceError):
            make_mesh(2)

    def test_make_mesh_with_too_few_gpus_raises(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        with pytest.raises(DeviceError):
            make_mesh(2)


class TestShardedEncodeDecode:
    def test_encode_matches_host(self):
        data = _batch(8, 8, 1024)
        ref, ours = _encode_both(8, 3, data)
        assert np.array_equal(ours, ref)
        assert np.array_equal(ours, _host_parity(8, 3, data))

    def test_encode_uneven_stripe_shards(self):
        data = _batch(5, 4, 512, seed=1)
        ref, ours = _encode_both(4, 2, data)
        assert ours.shape == ref.shape == (8, 2, 512)
        assert np.array_equal(ours, ref)
        assert np.array_equal(ours[:5], _host_parity(4, 2, data))

    def test_encode_uneven_lane_shards(self):
        data = _batch(4, 4, 250, seed=2)
        ref, ours = _encode_both(4, 2, data, lane_parallelism=4)
        assert ours.shape == ref.shape == (4, 2, 252)
        assert np.array_equal(ours, ref)
        assert np.array_equal(ours[:, :, :250], _host_parity(4, 2, data))

    def test_lane_only_mesh(self):
        data = _batch(2, 8, 4096, seed=3)
        ref, ours = _encode_both(8, 3, data, lane_parallelism=8)
        assert np.array_equal(ours, ref)
        assert np.array_equal(ours, _host_parity(8, 3, data))

    def test_m_exceeds_row_group(self):
        data = _batch(8, 4, 256, seed=4)
        ref, ours = _encode_both(4, 5, data)
        assert np.array_equal(ours, ref)
        assert np.array_equal(ours, _host_parity(4, 5, data))

    def test_unplaced_input_is_padded_and_sliced_back(self):
        # the port's functions also take a batch that does not divide the
        # mesh: padded inside, the result sliced back to the input's shape
        _, pm = _meshes()
        data = _batch(5, 4, 250, seed=12)
        ours = _np(sharded.sharded_encode(torch.from_numpy(_bit_matrix(4, 2)), data, pm))
        assert ours.shape == (5, 2, 250)
        assert np.array_equal(ours, _host_parity(4, 2, data))

    def test_decode_rebuilds_erasures(self):
        k, m = 8, 3
        jm, pm = _meshes()
        coeff = isa_rs_vandermonde_matrix(k, m)
        data = _batch(8, k, 1024, seed=5)
        chunks = np.concatenate([data, _host_parity(k, m, data)], axis=1)
        erasures = [1, 9]
        c, decode_index = isa_decode_matrix(coeff, erasures, k)
        dec_bm = np.asarray(expand_matrix(c), dtype=np.uint8)
        survivors = np.ascontiguousarray(chunks[:, decode_index, :])
        ref = _np(jsharded.sharded_decode(
            jnp.asarray(dec_bm), jsharded.shard_batch(jnp.asarray(survivors), jm), jm))
        ours = _np(sharded.sharded_decode(
            torch.from_numpy(dec_bm), sharded.shard_batch(survivors, pm), pm))
        assert np.array_equal(ours, ref)
        assert np.array_equal(ours, chunks[:, erasures, :])


def _scrub_both(k, m, chunks, **mesh_kw):
    jm, pm = _meshes(**mesh_kw)
    bm = _bit_matrix(k, m)
    rc, rmask = jsharded.scrub_step(
        jnp.asarray(bm), jsharded.shard_batch(jnp.asarray(chunks), jm), k, jm)
    oc, omask = sharded.scrub_step(torch.from_numpy(bm), sharded.shard_batch(chunks, pm), k, pm)
    assert int(oc) == int(rc)
    assert np.array_equal(_np(omask), _np(rmask))
    return int(oc), _np(omask)


class TestScrub:
    def test_clean_batch(self):
        k, m = 4, 2
        data = _batch(8, k, 512, seed=6)
        chunks = np.concatenate([data, _host_parity(k, m, data)], axis=1)
        count, mask = _scrub_both(k, m, chunks)
        assert count == 0 and not mask.any()

    def test_detects_corrupt_stripe(self):
        k, m = 4, 2
        data = _batch(8, k, 512, seed=7)
        chunks = np.concatenate([data, _host_parity(k, m, data)], axis=1)
        chunks[3, k + 1, 100] ^= 0xFF  # silent parity corruption
        count, mask = _scrub_both(k, m, chunks)
        assert count == 1 and mask[3] and mask.sum() == 1

    def test_detects_corrupt_data_chunk(self):
        k, m = 4, 2
        data = _batch(4, k, 256, seed=8)
        chunks = np.concatenate([data, _host_parity(k, m, data)], axis=1)
        chunks[0, 2, 0] ^= 0x01
        count, _ = _scrub_both(k, m, chunks)
        assert count == 1

    def test_corruption_in_one_lane_counts_its_stripe_once(self):
        # both lane shards of stripe 6 corrupt: the lane OR counts it once
        k, m = 4, 2
        data = _batch(8, k, 512, seed=13)
        chunks = np.concatenate([data, _host_parity(k, m, data)], axis=1)
        chunks[6, k, 3] ^= 0x10
        chunks[6, k, 500] ^= 0x10
        count, mask = _scrub_both(k, m, chunks)
        assert count == 1 and mask[6]


class TestTablesHeld:
    """The reference holds one compiled executable a mesh; the port holds
    each device's copy of a plan's tables in sharded.py's LRU."""

    def test_tables_are_held_across_calls(self):
        _, pm = _meshes()
        plan = CodingPlan(isa_rs_vandermonde_matrix(4, 2)[4:], device="cpu")
        data = _batch(8, 4, 1024, seed=9)
        first = sharded.sharded_plan_encode(plan, data, pm)
        held = dict(sharded._plan_execs)
        for _ in range(3):
            assert torch.equal(sharded.sharded_plan_encode(plan, data, pm), first)
        assert all(sharded._plan_execs.get(key) is val for key, val in held.items())

    def test_lru_is_bounded(self, monkeypatch):
        monkeypatch.setattr(sharded, "_PLAN_EXEC_CAPACITY", 2)
        for key in range(5):
            sharded._cached_exec(("test", key), lambda key=key: key)
        assert len(sharded._plan_execs) <= 2
        assert sharded._cached_exec(("test", 4), lambda: None) == 4


def test_plan_executable_cache_content_keyed():
    """Equal matrices share one per-device copy of the tables even across
    distinct CodingPlan instances (content-keyed, not identity-keyed)."""
    mat = isa_rs_vandermonde_matrix(4, 2)[4:]
    p1 = CodingPlan(mat, device="cpu")
    p2 = CodingPlan(mat.copy(), device="cpu")
    cpu = torch.device("cpu")
    assert sharded._plan_tables(p1, cpu) is sharded._plan_tables(p2, cpu)
    assert sharded._plan_bit_matrix(p1, cpu) is sharded._plan_bit_matrix(p2, cpu)
    assert sharded._plan_packed(p1) is sharded._plan_packed(p2)


class TestClayMeshRepair:
    def test_repair_planes_sharded_over_mesh(self, monkeypatch):
        """CLAY single-chunk repair with the inner-MDS decode launched
        mesh-sharded, in both packages: bytes equal between them and to
        the originally encoded chunk."""
        from ceph_tpu.codec import matrix_codec as jmc
        from ceph_tpu.codec.registry import instance as jinstance

        from ceph_tpu_torch.codec import matrix_codec as mc
        from ceph_tpu_torch.codec.registry import instance

        jm, pm = _meshes()
        calls = {"ref": 0, "port": 0}

        def ref_call(self, data, out=None):
            calls["ref"] += 1
            placed = jsharded.shard_batch(jnp.asarray(data, dtype=jnp.uint8), jm)
            return jsharded.sharded_decode(jnp.asarray(self.bm, dtype=jnp.uint8), placed, jm)

        def port_call(self, data, out=None):
            calls["port"] += 1
            return sharded.sharded_decode(self.bm, sharded.shard_batch(data, pm), pm)

        monkeypatch.setattr(jmc._DeviceCoder, "__call__", ref_call)
        monkeypatch.setattr(mc._DeviceCoder, "__call__", port_call)
        k, m = 4, 2
        raw = np.random.default_rng(10).integers(0, 256, 4096, dtype=np.uint8).tobytes()
        lost = 2
        repaired = {}
        for side, factory in (("ref", jinstance().factory),
                              ("port", lambda *a: instance().factory(*a, device="cpu"))):
            ec = factory("clay", {"k": "4", "m": "2", "d": "5"})
            encoded = ec.encode(set(range(k + m)), raw)
            chunk_size = ec.get_chunk_size(len(raw))
            sc = chunk_size // ec.sub_chunk_no
            minimum = ec.minimum_to_decode({lost}, set(range(k + m)) - {lost})
            helpers = {node: np.concatenate([np.asarray(encoded[node])[off * sc:(off + n) * sc]
                                             for off, n in runs])
                       for node, runs in minimum.items()}
            got = np.asarray(ec.decode({lost}, helpers, chunk_size=chunk_size)[lost])
            assert np.array_equal(got, np.asarray(encoded[lost]))
            repaired[side] = got
        assert np.array_equal(repaired["port"], repaired["ref"])
        assert calls["ref"] > 0 and calls["port"] > 0


def _plan_encode_both(k, m, data, **mesh_kw):
    jm, pm = _meshes(**mesh_kw)
    mat = isa_rs_vandermonde_matrix(k, m)[k:]
    ref = jsharded.sharded_plan_encode(
        JCodingPlan(mat, interpret=True), jsharded.shard_batch(jnp.asarray(data), jm), jm)
    ours = sharded.sharded_plan_encode(
        CodingPlan(mat, device="cpu"), sharded.shard_batch(data, pm), pm)
    return _np(ref), _np(ours)


class TestPlanSharded:
    def test_plan_encode_matches_host(self):
        data = _batch(8, 8, 1024)
        ref, ours = _plan_encode_both(8, 3, data)
        assert np.array_equal(ours, ref)
        assert np.array_equal(ours, _host_parity(8, 3, data))

    def test_plan_decode_rebuilds(self):
        k, m = 8, 3
        jm, pm = _meshes()
        coeff = isa_rs_vandermonde_matrix(k, m)
        data = _batch(4, k, 1024, seed=7)
        full = np.concatenate([data, _host_parity(k, m, data)], axis=1)
        erasures = [1, 9]
        c, idx = isa_decode_matrix(coeff, erasures, k)
        survivors = np.ascontiguousarray(full[:, idx, :])
        ref = _np(jsharded.sharded_plan_decode(
            JCodingPlan(c, interpret=True), jsharded.shard_batch(jnp.asarray(survivors), jm), jm))
        ours = _np(sharded.sharded_plan_decode(
            CodingPlan(c, device="cpu", decode=True), sharded.shard_batch(survivors, pm), pm))
        assert np.array_equal(ours, ref)
        assert np.array_equal(ours, full[:, erasures, :])

    def test_plan_small_tile_falls_back(self, monkeypatch):
        # a lane shard of 64 bytes has no SWAR geometry: xor_matmul there,
        # as the reference plan does; bytes still exact
        assert pick_geometry(64) is None
        calls = []
        real = swar_gf.swar_gf
        monkeypatch.setattr(sharded, "swar_gf", lambda *a, **kw: calls.append(1) or real(*a, **kw))
        data = _batch(4, 4, 128)
        ref, ours = _plan_encode_both(4, 2, data, lane_parallelism=2)
        assert np.array_equal(ours, ref)
        assert np.array_equal(ours, _host_parity(4, 2, data))
        assert not calls

    def test_plan_unaligned_tile_takes_the_packed_kernel(self, monkeypatch):
        # a tile of at least PACKED_MIN_BYTES with no SWAR geometry takes
        # packed_code, as the reference plan's packed fallback does
        calls = []
        real = sharded.packed_code
        monkeypatch.setattr(sharded, "packed_code",
                            lambda *a, **kw: calls.append(1) or real(*a, **kw))
        data = _batch(32, 8, 4100, seed=14)
        ref, ours = _plan_encode_both(8, 3, data, lane_parallelism=1)
        assert np.array_equal(ours, ref)
        assert np.array_equal(ours, _host_parity(8, 3, data))
        assert len(calls) == 8


class TestPodMesh:
    def test_pod_encode_matches_host(self):
        data = _batch(8, 8, 512)
        ref, ours = _encode_both(8, 3, data, pods=2)
        assert np.array_equal(ours, ref)
        assert np.array_equal(ours, _host_parity(8, 3, data))

    def test_pod_plan_encode_matches_host(self):
        data = _batch(8, 8, 1024)
        ref, ours = _plan_encode_both(8, 3, data, pods=2)
        assert np.array_equal(ours, ref)
        assert np.array_equal(ours, _host_parity(8, 3, data))

    def test_pod_scrub_detects_corruption(self):
        k, m = 4, 2
        data = _batch(8, k, 512, seed=3)
        chunks = np.concatenate([data, _host_parity(k, m, data)], axis=1)
        chunks[5, 1, 17] ^= 0xFF
        count, mask = _scrub_both(k, m, chunks, pods=2)
        assert count == 1 and mask[5]


class TestPlanScrub:
    @pytest.mark.parametrize("pods", [1, 2])
    def test_plan_scrub_detects_corruption(self, pods):
        k, m = 4, 2
        jm, pm = _meshes(pods=pods)
        mat = isa_rs_vandermonde_matrix(k, m)[k:]
        jplan, plan = JCodingPlan(mat, interpret=True), CodingPlan(mat, device="cpu")
        data = _batch(8, k, 1024, seed=11)
        chunks = np.concatenate([data, _host_parity(k, m, data)], axis=1)

        def both(chunks):
            rc, rmask = jsharded.plan_scrub_step(
                jplan, jsharded.shard_batch(jnp.asarray(chunks), jm), k, jm)
            oc, omask = sharded.plan_scrub_step(plan, sharded.shard_batch(chunks, pm), k, pm)
            assert int(oc) == int(rc)
            assert np.array_equal(_np(omask), _np(rmask))
            return int(oc), _np(omask)

        count, mask = both(chunks)
        assert count == 0 and not mask.any()
        chunks[2, k, 77] ^= 0x5A  # a parity chunk
        chunks[6, 1, 900] ^= 0x01  # a data chunk
        count, mask = both(chunks)
        assert count == 2 and mask[2] and mask[6]

    def test_plan_scrub_rejects_a_k_the_plan_does_not_have(self):
        _, pm = _meshes()
        plan = CodingPlan(isa_rs_vandermonde_matrix(4, 2)[4:], device="cpu")
        with pytest.raises(ValueError):
            sharded.plan_scrub_step(plan, _batch(8, 6, 256), 3, pm)
