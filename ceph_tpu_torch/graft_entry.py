"""The single-card entry: one RS(8,3) encode of a batch.

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
CPU on its own).  The multi-card half of the reference's entry,
`dryrun_multichip`, waits for the stripe-parallel layer (ROADMAP A8).
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
