"""The port's `fs/` library and striper under it, against the JAX
package's, on the CPU.

- The reference's cases of `tests/test_access_layers.py` for the
  striper and the file system (TestStripePolicy, TestStriper,
  TestFileSystem) run on the port through `torch_ported.load`: the same
  text with its imports pointed at `ceph_tpu_torch`, against a cluster of
  the port's monitors and daemons on the CPU.
"""

import pytest

from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)
from torch_ported import collect, cpu_daemons, load  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("cpu_daemons")

collect(load("test_access_layers"), ["TestStripePolicy", "TestStriper", "TestFileSystem"],
        globals())
