"""The port's MDS (`ceph_tpu_torch/mds/`) and its client, on the CPU.

- The reference's cases of `tests/test_mds.py` (namespace, journal
  replay, caps, symlinks, exactly-once retries) and of
  `tests/test_mds_failover.py` (the FSMap, standby failover with journal
  replay, the fence of a zombie active) run on the port through
  `torch_ported.load`: the same text with its imports pointed at
  `ceph_tpu_torch`, against the port's monitors and daemons on the CPU
  (the failover cases boot their cluster through the port's
  `tools.vstart.DevCluster`).  The reference runs them on itself in
  their own files.
"""

import pytest

from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)
from torch_ported import collect, cpu_daemons, load  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("cpu_daemons")

collect(load("test_mds"), ["TestMdsNamespace", "TestMdsJournal", "TestCapabilities",
                           "TestSymlinks", "TestExactlyOnceRetries"], globals())
collect(load("test_mds_failover"), [
    "test_fs_new_requires_pools", "test_fsmap_ranks_and_status",
    "test_multiple_filesystems_independent_namespaces",
    "test_zombie_active_is_fenced_before_standby_promotion",
    "test_active_mds_failover_with_journal_replay"], globals())
