"""The port's single-card entry (`ceph_tpu_torch/graft_entry.py`) against
the JAX package's `__graft_entry__.py::entry`, on the CPU: the same
RS(8,3) bit-matrix and (16, 8, 4096) batch, and `fn(*args)` byte-equal
to the host oracle and to the reference's output.  Without a GPU, and
without `device="cpu"`, the entry raises."""

import numpy as np
import pytest
import torch

import __graft_entry__ as reference
from ceph_tpu_torch import graft_entry
from ceph_tpu_torch.gf import xor_matmul_host_batch
from ceph_tpu_torch.ops.guard import DeviceError


def test_entry_on_the_cpu_matches_the_host_oracle_and_the_reference():
    fn, (bit_matrix, data) = graft_entry.entry(device="cpu")
    assert bit_matrix.device.type == data.device.type == "cpu"
    assert tuple(bit_matrix.shape) == (24, 64) and tuple(data.shape) == (16, 8, 4096)
    out = fn(bit_matrix, data).numpy()
    assert out.shape == (16, 3, 4096) and out.dtype == np.uint8
    assert np.array_equal(out, xor_matmul_host_batch(bit_matrix.numpy(), data.numpy()))
    ref_fn, (ref_bm, ref_data) = reference.entry()
    assert np.array_equal(np.asarray(ref_bm), bit_matrix.numpy())
    assert np.array_equal(np.asarray(ref_data), data.numpy())
    assert np.array_equal(np.asarray(ref_fn(ref_bm, ref_data)), out)


def test_entry_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceError):
        graft_entry.entry()
