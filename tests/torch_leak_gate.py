"""The port's leak gate: after each test of a file that imports
`port_leak_gate`, the port's aggregators are drained and the port mempool
ledger's in-flight pools must read 0.  The gate in tests/conftest.py reads
the JAX package's ledger only; this is its twin for `ceph_tpu_torch`."""

import pytest
import torch

from ceph_tpu_torch.common.mempool import ledger
from ceph_tpu_torch.ops.offload_runtime import drain_all_aggregators

INFLIGHT_POOLS = ("ec_pipeline_inflight", "verify", "offload_inflight")

# the port's tests use small tensors: one intra-op thread keeps them from
# spinning cores that the suite's timing-sensitive cluster tests share
torch.set_num_threads(1)


def held_bytes() -> int:
    led = ledger()
    return sum(led.current_bytes(pool) for pool in INFLIGHT_POOLS)


@pytest.fixture(autouse=True)
def port_leak_gate():
    yield
    # sticky launch errors settle too (they stay sticky for their reaps)
    drain_all_aggregators()
    held = held_bytes()
    assert held == 0, (
        f"port mempool leak: {held} bytes still held in the in-flight pools "
        f"after drain (reconcile: {ledger().reconcile()})"
    )
