"""The driver entry points: one RS(8,3) encode of a batch, and the
multi-device dry run.

The port's counterpart of `__graft_entry__.py::entry` (the JAX package's
single-chip compile check): `entry()` returns `(fn, args)` such that
`fn(*args)` is the flagship coding step, the bitsliced GF(2) product of
RS(8,3)'s parity bit-matrix with a (16, 8, 4096) uint8 batch (16 stripes,
8 data chunks of 4 KiB each) drawn from `np.random.default_rng(0)` —
the same matrix and bytes as the reference's.  `fn` is
`ops/xor_mm.py::xor_matmul`, plain torch, as the JAX package computes
it in plain jnp outside any Pallas kernel; the hand kernel of the path
(`csrc/swar_gf.cu`) runs when the same batch goes through plugin `tpu`'s
`encode_array`, which `chip_smoke.py`'s phase 21 holds it against.

The tensors are on `cuda` unless the caller names another device; with
no GPU and no `device="cpu"`, `entry()` raises (the port never picks the
CPU on its own).

`dryrun_multichip(n, devices=None)` is the port of the reference's
`__graft_entry__.py::dryrun_multichip`: on an n-device mesh
(`parallel/mesh.py`) it runs one whole sharded pipeline step on small
shapes (sharded encode, a scrub that finds nothing, a 2-erasure rebuild,
the SWAR kernel on every shard with its plan scrub, a 2-pod mesh) and
then the live dispatch through plugin `tpu`, which must shard one encode
and one decode over the mesh, byte-exact.  `devices=None` means the
first n CUDA devices and raises with fewer; a list may repeat one device
(`[torch.device("cpu")] * 8` on the CPU, `["cuda:0"] * 8` on one card).
"""

from __future__ import annotations

import numpy as np

K, M = 8, 3
BATCH = (16, K, 4096)


def entry(device=None):
    """`(xor_matmul, (bit_matrix, data))` on `device` (None: cuda)."""
    import torch

    from .codec.base import resolve_device
    from .gf import expand_matrix, isa_rs_vandermonde_matrix
    from .ops.xor_mm import xor_matmul

    dev = resolve_device(device)
    bit_matrix = torch.from_numpy(
        expand_matrix(isa_rs_vandermonde_matrix(K, M)[K:]).astype(np.uint8)
    ).to(dev)
    rng = np.random.default_rng(0)
    data = torch.from_numpy(
        rng.integers(0, 256, BATCH).astype(np.uint8)
    ).to(dev)
    return xor_matmul, (bit_matrix, data)


def _expect(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_devices: int, devices=None) -> dict:
    """The reference's six dry-run steps on an n-device mesh; raises on the
    first that fails, else returns what ran (mesh shapes, batch shape,
    the live path's sharded launches)."""
    import torch

    from .codec import ErasureCodeTpuRs
    from .gf import expand_matrix, gf_matmul, isa_decode_matrix, isa_rs_vandermonde_matrix
    from .ops.dispatch import SHARDED_LAUNCHES
    from .ops.swar_gf import CodingPlan
    from .parallel import dispatch as shard_dispatch
    from .parallel.mesh import make_mesh
    from .parallel.sharded import (
        plan_scrub_step,
        scrub_step,
        shard_batch,
        sharded_decode,
        sharded_encode,
        sharded_plan_encode,
    )

    mesh = make_mesh(n_devices, devices=devices)
    first = mesh.devices.flat[0]
    k, m = K, M
    coeff = isa_rs_vandermonde_matrix(k, m)
    enc_bm = torch.from_numpy(expand_matrix(coeff[k:])).to(first)
    stripe_shards, lane_shards = mesh.shape["stripe"], mesh.shape["lane"]
    S, L = 2 * stripe_shards, 256 * lane_shards
    rng = np.random.default_rng(0)
    data = shard_batch(rng.integers(0, 256, (S, k, L), dtype=np.uint8), mesh)

    # 1. sharded bulk encode, no communication
    parity = sharded_encode(enc_bm, data, mesh)
    chunks = torch.cat([data, parity], dim=1)
    # 2. deep-scrub verify: the cross-device reduction finds nothing
    bad, _ = scrub_step(enc_bm, chunks, k, mesh)
    _expect(int(bad) == 0, "scrub found parity mismatches")
    # 3. erase two chunks, rebuild through the sharded decode
    erasures = [1, 9]
    c, decode_index = isa_decode_matrix(coeff, erasures, k)
    dec_bm = torch.from_numpy(expand_matrix(c)).to(first)
    rebuilt = sharded_decode(dec_bm, chunks[:, decode_index, :], mesh)
    _expect(torch.equal(rebuilt, chunks[:, erasures, :]), "sharded rebuild mismatch")
    # 4. the SWAR kernel on every shard, and its plan scrub
    kplan = CodingPlan(coeff[k:], device=first)
    plan_parity = sharded_plan_encode(kplan, data, mesh)
    _expect(torch.equal(plan_parity, parity), "plan/matmul mismatch")
    pcount, _ = plan_scrub_step(kplan, torch.cat([data, plan_parity], dim=1), k, mesh)
    _expect(int(pcount) == 0, "plan scrub mismatch")
    # 5. a 2-pod mesh: stripes over (pod, stripe); the scrub verdict is
    # the only cross-pod reduction
    pod_shape = None
    if n_devices % 2 == 0:
        pod_mesh = make_mesh(n_devices, pods=2, devices=devices)
        pod_shape = dict(pod_mesh.shape)
        pdata = shard_batch(rng.integers(0, 256, (S, k, L), dtype=np.uint8), pod_mesh)
        pparity = sharded_encode(enc_bm, pdata, pod_mesh)
        pcount, _ = scrub_step(enc_bm, torch.cat([pdata, pparity], dim=1), k, pod_mesh)
        _expect(int(pcount) == 0, "pod-mesh scrub mismatch")
    # 6. the live dispatch: an aggregated-size batch through plugin tpu's
    # encode and decode is ONE sharded launch each over the mesh's devices
    saved = shard_dispatch.settings()
    with shard_dispatch.use_devices(list(mesh.devices.flat)):
        shard_dispatch.configure(min_batch=n_devices, devices=0)
        try:
            ec = ErasureCodeTpuRs(device=first)
            ec.init({"k": str(k), "m": str(m)})
            live = rng.integers(0, 256, (2 * n_devices, k, 8192), dtype=np.uint8)
            s0 = SHARDED_LAUNCHES.snapshot()["launches"]
            live_parity = ec.encode_array(live).cpu().numpy()
            s1 = SHARDED_LAUNCHES.snapshot()["launches"]
            _expect(s1 == s0 + 1, "live dispatch did not shard")
            _expect(np.array_equal(live_parity[0], gf_matmul(coeff[k:], live[0])),
                    "sharded live-dispatch parity mismatch")
            idx = ec.decode_index(erasures)
            live_full = np.concatenate([live, live_parity], axis=1)
            rec = ec.decode_array(erasures, live_full[:, idx, :].copy()).cpu().numpy()
            s2 = SHARDED_LAUNCHES.snapshot()["launches"]
            _expect(s2 == s1 + 1, "live decode did not shard")
            _expect(np.array_equal(rec, live_full[:, erasures, :]),
                    "sharded live-dispatch decode mismatch")
        finally:
            shard_dispatch.configure(*saved)
    return {"mesh": dict(mesh.shape), "pod_mesh": pod_shape, "batch": (S, k, L),
            "device": str(first), "live_sharded_launches": s2 - s0}
