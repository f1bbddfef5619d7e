"""The port's XOR fold (`ops/xor_mm.py::xor_reduce`) on the CPU, held
against the JAX package's `xor_reduce` under JAX_PLATFORMS=cpu: k from 1 to
11 chunks, lead shapes of rank 0 to 2, and strided views (a chunk subset of
a wider stack, a view of every other stripe, a view at an odd byte offset).
A CPU tensor takes the plain version; csrc/xor_reduce.cu, which a CUDA
tensor launches, is held against it on the card by chip_smoke.py."""

import numpy as np
import pytest
import torch

from ceph_tpu.ops import xor_mm as jxor

from ceph_tpu_torch.ops import xor_mm as txor

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)


@pytest.mark.parametrize("k", [1, 2, 3, 8, 11])
@pytest.mark.parametrize("lead", [(), (3,), (2, 4)], ids=["rank0", "rank1", "rank2"])
def test_plain_matches_reference(k, lead):
    data = np.random.default_rng(k * 31 + len(lead)).integers(
        0, 256, (*lead, k, 4100), dtype=np.uint8)
    want = np.asarray(jxor.xor_reduce(data))
    got = txor.xor_reduce_plain(torch.from_numpy(data))
    assert got.shape == want.shape and np.array_equal(got.numpy(), want)
    launches = txor.xor_reduce.launches
    assert np.array_equal(txor.xor_reduce(torch.from_numpy(data)).numpy(), want)
    assert txor.xor_reduce.launches == launches  # the plain version counts none


@pytest.mark.parametrize("k", [1, 2, 8, 11])
def test_strided_views_match_reference(k):
    stack = np.random.default_rng(k).integers(0, 256, (6, k + 3, 4113), dtype=np.uint8)
    views = {
        "chunk subset": (stack[:, 1:k + 1, :4096], torch.from_numpy(stack)[:, 1:k + 1, :4096]),
        "every other stripe": (stack[::2, :k], torch.from_numpy(stack)[::2, :k]),
        "odd offset": (stack[:, :k, 3:4100], torch.from_numpy(stack)[:, :k, 3:4100]),
    }
    for name, (host, view) in views.items():
        want = np.asarray(jxor.xor_reduce(np.ascontiguousarray(host)))
        assert np.array_equal(txor.xor_reduce(view).numpy(), want), name


def test_wrong_dtype_raises():
    with pytest.raises(TypeError):
        txor.xor_reduce(torch.zeros((2, 8), dtype=torch.int32))
