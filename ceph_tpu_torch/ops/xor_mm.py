"""GF(2^8) coding as a bitsliced XOR-matmul, and the XOR fold, in plain torch.

The port of `ceph_tpu/ops/xor_mm.py::xor_matmul` and `xor_reduce`.  The JAX
package computes both in plain jnp outside any Pallas kernel, so plain torch
is their port.

- `xor_matmul` applies an (8m, 8k) GF(2) bit-matrix (gf.bitslice.expand_matrix
  of the (m, k) coding matrix, a runtime operand) to (..., k, L) uint8
  chunks: bit-expand, matmul, keep the parity bit, fold back to bytes.  It is
  `_DeviceCoder`'s tier for chunk lengths that are not a multiple of 128.
  The product runs in float32 on 0/1 planes; it is exact because every sum
  is at most 8k <= 2^24.  TF32 is switched off here all the same, so the
  product is plain float32 whatever the process had set.
- `xor_reduce` is the XOR fold over the chunk axis: the m == 1 parity and
  the single-erasure decode path of codecs whose first parity row is all
  ones (Ceph's `region_xor`, isa/xor_op.cc).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False


def _bit_shifts(device: torch.device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device).view(8, 1)


def xor_matmul(bit_matrix: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Apply an (8m, 8k) 0/1 bit-matrix to (..., k, L) uint8 chunks.

    Returns (..., m, L) uint8 on data's device."""
    *lead, k, L = data.shape
    m8, k8 = bit_matrix.shape
    if k8 != 8 * k:
        raise ValueError(f"bit-matrix {tuple(bit_matrix.shape)} does not fit k={k}")
    shifts = _bit_shifts(data.device)
    planes = ((data[..., :, None, :] >> shifts) & 1).reshape(*lead, 8 * k, L)
    acc = torch.matmul(bit_matrix.to(torch.float32), planes.to(torch.float32))
    bits = (acc.to(torch.int32) & 1).reshape(*lead, m8 // 8, 8, L)
    return (bits << shifts.to(torch.int32)).sum(dim=-2).to(torch.uint8)


def xor_reduce(data: torch.Tensor) -> torch.Tensor:
    """XOR-fold chunks: (..., k, L) uint8 -> (..., L) uint8."""
    acc = data[..., 0, :].clone()
    for j in range(1, data.shape[-2]):
        acc ^= data[..., j, :]
    return acc
