"""The port's cluster tools (`ceph_tpu_torch/tools/`: `vstart`, the
`ceph`, `rados`, `rbd` and `radosgw-admin` command lines, and the
objectstore tool), on the CPU.

- Every class of the reference's `tests/test_tools_cluster.py` runs on
  the port through `torch_ported.load`: the same text with its imports,
  and the modules its subprocesses run (`python -m
  ceph_tpu.tools.<name>`), pointed at `ceph_tpu_torch`.  The dev
  cluster's monitors and OSDs are the port's, on the CPU
  (`cpu_daemons`); the command lines run as processes of their own, from
  this checkout's root and with it as their `PYTHONPATH`.
"""

import re

import pytest

from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)
from torch_ported import TESTS, collect, cpu_daemons, load, ported_text  # noqa: F401 (fixture)

pytestmark = pytest.mark.usefixtures("cpu_daemons")

collect(load("test_tools_cluster"), [
    "TestDevCluster", "TestPgls", "TestCephCliCmdBuilder", "TestObjectstoreTool",
    "TestCliSubprocess", "TestVstartMds", "TestCephTell", "TestVstartRgw"], globals())


def test_the_command_lines_run_from_this_checkout():
    """Each CLI subprocess's working directory and `PYTHONPATH` is this
    checkout's root, whatever path the reference's text names, so the
    cases test this tree's `ceph_tpu_torch.tools`."""
    src = ported_text("test_tools_cluster")
    paths = re.findall(r'(?:\bcwd=|"PYTHONPATH": )(\S+?)[,}]', src)
    assert len(paths) == 2 and set(paths) == {repr(str(TESTS.parent))}
