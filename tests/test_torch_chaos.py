"""The port's chaos harness (`ceph_tpu_torch/tools/chaos.py`) runs the
reference's seed-fixed smoke, on the CPU.

The case is `tests/test_chaos_smoke.py`'s text with its imports pointed
at the port (`torch_ported.ported_text`); `cpu_daemons` and `cpu_tools`
make the port's daemons and codecs default to the CPU for its length, so
`run_chaos(seed=0xC405, smoke=True)` runs the whole harness there, the
guard's probe included.  It sits alone in its file so that the driver's
`--dist loadfile` gives it a worker of its own.

Three of the reference's assertions need a host fallback, which the
port never makes (a failed launch fails its riders with EIO, the
backend goes DEGRADED and the probe heals it; ROADMAP C32).  They are
replaced, and nothing else is changed:

- `fallback_launches >= 1` by `fallback_launches == 0` and
  `unacked_writes >= 1`: no launch was recomputed on the host, and the
  launch faults really failed client writes (each read back absent or
  whole inside the run);
- `offload_csum_fallbacks >= 1` by `offload_csum_failed >= 1`;
- `offload_compress_fallbacks >= 1` by `offload_compress_failed >= 1`.

The event count stays 13: the port's phases 3, 3.7 and 3.8 each still
append one event, worded for the port.
"""

import types

import pytest

from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)
from torch_ported import TESTS, cpu_daemons, cpu_tools, ported_text  # noqa: F401 (fixture)

REPLACED = {
    '        assert report["fallback_launches"] >= 1, report\n':
        '        assert report["fallback_launches"] == 0, report\n'
        '        assert report["unacked_writes"] >= 1, report\n',
    '        assert report["offload_csum_fallbacks"] >= 1, report\n':
        '        assert report["offload_csum_failed"] >= 1, report\n',
    '        assert report["offload_compress_fallbacks"] >= 1, report\n':
        '        assert report["offload_compress_failed"] >= 1, report\n',
}


def _smoke_module() -> types.ModuleType:
    """`test_chaos_smoke` on the port, with REPLACED's three assertions
    swapped (each must appear exactly once)."""
    src = ported_text("test_chaos_smoke")
    for old, new in REPLACED.items():
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    mod = types.ModuleType("test_chaos_smoke__torch")
    mod.__file__ = str(TESTS / "test_chaos_smoke.py")
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    return mod


_smoke = _smoke_module()


@pytest.mark.usefixtures("cpu_daemons", "cpu_tools")
class TestChaosSmoke_torch(_smoke.TestChaosSmoke):
    pass
