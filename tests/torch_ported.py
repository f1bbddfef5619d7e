"""The reference's test modules, run on the port.

`load(name)` reads `tests/<name>.py`, points every `ceph_tpu` import at
`ceph_tpu_torch` and every `from test_x import` at the port's copy of
that helper module (loaded the same way), points the working directory
and `PYTHONPATH` of the subprocesses it starts at this checkout's root,
and executes the text (`ported_text(name)`) as the module
`<name>__torch`.  The cases are the reference's, unchanged; only the
package they import differs.  `collect(mod, names, into)` hands chosen
test classes and functions to a port test file under a `_torch` suffix,
so pytest collects them there.

The port's daemons and monitors take `device=None` as cuda, where the
reference's tests build them with no device: `cpu_daemons` (a fixture
of the files that collect such cases) makes the OSD's and the monitor's
default the CPU for the test's length, which is what passing
`device="cpu"` to each would do.  The offline tools and the codec
plugins take `device=None` as cuda too: `cpu_tools` makes every codec's
default the CPU for the test's length (`codec.base.resolve_device`,
which the plugins' codecs and `bench_sweep` resolve through), which is
what passing `--device cpu` to each tool would do.
"""

from __future__ import annotations

import importlib
import re
import sys
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent
_PKG = re.compile(r"\bceph_tpu\b(?!_torch)")
_HELPER = re.compile(r"^(\s*)from (test_\w+) import", re.M)
# a subprocess's `cwd="<root>"` or `"PYTHONPATH": "<root>"`, written for
# the reference's checkout: the port's text runs from this one
_ROOT = re.compile(r'(\bcwd=|"PYTHONPATH": )"[^"]*"')


def ported_text(name: str) -> str:
    """`tests/<name>.py` on the port, before its helper imports are
    pointed at the port's copies."""
    src = _PKG.sub("ceph_tpu_torch", (TESTS / f"{name}.py").read_text())
    return _ROOT.sub(lambda m: m[1] + repr(str(TESTS.parent)), src)


def load(name: str) -> types.ModuleType:
    """The reference's `tests/<name>.py` on the port (memoized)."""
    key = f"{name}__torch"
    if key in sys.modules:
        return sys.modules[key]
    src = ported_text(name)
    mod = types.ModuleType(key)
    mod.__file__ = str(TESTS / f"{name}.py")
    sys.modules[key] = mod  # first: helpers may import each other
    # (in a function or not: the indent of the import's own line)
    helpers = [(indent.rsplit("\n", 1)[-1], h) for indent, h in _HELPER.findall(src)]
    # the helpers a module imports at its top run before it; those it
    # imports inside a function after it, so that two helpers that
    # import each other (test_mon, test_cluster) load in either order
    for helper in sorted({h for indent, h in helpers if not indent}):
        load(helper)
    src = _HELPER.sub(r"\1from \2__torch import", src)
    exec(compile(src, mod.__file__, "exec"), mod.__dict__)
    for helper in sorted({h for indent, h in helpers if indent}):
        load(helper)
    return mod


def collect(mod: types.ModuleType, names, into: dict) -> None:
    """`into[name + "_torch"] = mod.name` for each of `names`."""
    for name in names:
        into[f"{name}_torch"] = getattr(mod, name)


@pytest.fixture
def cpu_daemons(monkeypatch):
    """The port's OSDs and monitors default to the CPU (see the module
    docstring)."""
    base = importlib.import_module("ceph_tpu_torch.codec.base")

    def resolve(device=None):
        return base.resolve_device("cpu" if device is None else device)

    for mod in ("ceph_tpu_torch.osd.osd", "ceph_tpu_torch.mon.monitor"):
        monkeypatch.setattr(importlib.import_module(mod), "resolve_device", resolve)


@pytest.fixture
def cpu_tools(monkeypatch):
    """The port's codecs, and so its offline tools, default to the CPU
    (see the module docstring)."""
    base = importlib.import_module("ceph_tpu_torch.codec.base")
    resolve_device = base.resolve_device

    def resolve(device=None):
        return resolve_device("cpu" if device is None else device)

    monkeypatch.setattr(base, "resolve_device", resolve)
