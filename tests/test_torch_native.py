"""The port's native host libraries: plugin `native` (`codec/native_codec.py`,
`codec/plugins/native.py`, `csrc/ec_native.cc`), the registry's dlopen
path (`codec/registry.py::load_dynamic`), and the ctypes runtime
(`utils/native.py`, `crush/native.py`, `csrc/crush.cc`), on the CPU.

- The reference's own cases run on the port (`torch_ported.load`):
  `test_native_ec.py`'s `TestNativeCodec` and `TestHostilePlugins`,
  `test_crush.py`'s `TestNativeAgreement`, and `test_isal_golden.py`'s
  `TestCompiledForeignVectors`.  `cpu_tools` makes the codecs' default
  the CPU for a test's length.
- Reference cases that do not run on the port as written, and the port
  test of the same check: `TestNativeInvert` loads the plugin from
  `NATIVE_DIR = .../native` (`test_native_ec.py:20`), which the port
  never builds into; `TestNativeInvert_torch` points that name at the
  port's build directory.  `TestCompiledForeignVectors`' `vectors_bin`
  runs `make -C native`; `TestCompiledForeignVectors_torch` compiles
  `native/isal_scalar.c` into a temporary directory instead.
- Differentials with both packages: `load_dynamic`'s errno for each
  hostile fixture, and the `native` plugin's chunks against the JAX
  package's `tpu` plugin's over seeded objects.
- The C++ copies in `csrc/` equal `native/`'s but for their leading
  comment.
"""

import os
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest

from torch_ported import collect, cpu_tools, load  # noqa: F401 (fixture)

from ceph_tpu.codec import registry as jregistry
from ceph_tpu.codec.interface import EcError as JEcError

from ceph_tpu_torch.codec import registry
from ceph_tpu_torch.codec.interface import EcError
from ceph_tpu_torch.codec.plugins import native as native_plugin
from ceph_tpu_torch.utils import crc32c as crc_mod
from ceph_tpu_torch.utils import host_build
from ceph_tpu_torch.utils import native as native_lib

ROOT = Path(__file__).resolve().parents[1]
pytestmark = pytest.mark.usefixtures("cpu_tools")

_native = load("test_native_ec")
collect(_native, ["TestNativeCodec", "TestHostilePlugins"], globals())
collect(load("test_crush"), ["TestNativeAgreement"], globals())
_golden = load("test_isal_golden")


class TestNativeInvert_torch(_native.TestNativeInvert):
    @pytest.fixture(autouse=True)
    def _port_build(self, monkeypatch):
        monkeypatch.setattr(_native, "NATIVE_DIR", native_plugin.build_dir())


@pytest.mark.skipif(shutil.which("gcc") is None, reason="no C compiler")
class TestCompiledForeignVectors_torch(_golden.TestCompiledForeignVectors):
    @pytest.fixture(scope="class")
    def vectors_bin(self, tmp_path_factory):
        out = tmp_path_factory.mktemp("isal") / "isal_vectors"
        subprocess.run(["gcc", "-O2", "-Wall", "-Wextra", "-o", str(out),
                        str(ROOT / "native" / "isal_scalar.c")], check=True, capture_output=True)
        return str(out)


# -- the builds --------------------------------------------------------------


def _code(text: str) -> str:
    """A C++ source without its comments."""
    text = re.sub(r"/\*.*?\*/", "", text, flags=re.S)
    return "\n".join(line.split("//", 1)[0].rstrip() for line in text.splitlines()).strip()


@pytest.mark.parametrize("name", ["ec_native.cc", "crush.cc"])
def test_csrc_copies_equal_native_but_for_comments(name):
    ours = (ROOT / "ceph_tpu_torch" / "csrc" / name).read_text()
    theirs = (ROOT / "native" / name).read_text()
    assert _code(ours) == _code(theirs)
    # the leading comment is the only place they differ
    body = ours.index("#include")
    assert ours[body:] == theirs[theirs.index("#include"):]
    assert "A copy of native/" in ours[:body]


def test_libraries_build_under_build_dir_only():
    plugin_dir = Path(native_plugin.build_dir())
    assert plugin_dir.parent == host_build.BUILD_DIR
    assert (plugin_dir / "libec_native.so").exists()
    assert not (plugin_dir / f".libec_native.{os.getpid()}.so").exists()
    lib = native_lib.load()
    assert lib is native_lib.load()
    assert any(p.name.startswith("libceph_tpu_native_") for p in host_build.BUILD_DIR.iterdir())


def test_a_failed_build_raises(tmp_path, monkeypatch):
    """No silent fallback: a source g++ rejects raises, and leaves no
    library or temporary file behind."""
    bad = tmp_path / "bad.cc"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(host_build, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        host_build.build("bad", [bad])
    assert not list((tmp_path / "_build").iterdir())


def test_native_crc32c_equals_the_host_library():
    lib = native_lib.load()
    rng = np.random.default_rng(3)
    for n in (0, 1, 7, 4096, 65537):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert lib.ceph_tpu_crc32c(0, data, n) == crc_mod.crc32c(data)
        assert lib.ceph_tpu_crc32c(0xDEADBEEF, data, n) == crc_mod.crc32c(data, 0xDEADBEEF)


def test_unequal_regions_are_refused_before_the_engine_reads_them():
    ec = registry.instance().factory("native", {"k": "4", "m": "2"}, device="cpu")
    enc = ec.encode(set(range(6)), bytes(range(256)) * 64)
    avail = {i: enc[i] for i in range(6) if i not in (0, 5)}
    avail[2] = avail[2][:-128]
    with pytest.raises(EcError) as e:
        ec.decode({0, 5}, avail)
    assert e.value.errno == -22
    avail = {i: enc[i] for i in range(6) if i != 0}
    avail[3] = avail[3][:-128]
    with pytest.raises(EcError):
        ec.decode({0}, avail)  # the XOR fast path


# -- differentials -----------------------------------------------------------


@pytest.fixture
def hostile_dir(tmp_path):
    for name, src in _native.FIXTURES.items():
        cc = tmp_path / f"{name}.cc"
        cc.write_text(src or "// empty: exports nothing\n")
        subprocess.run(["g++", "-shared", "-fPIC", "-o", str(tmp_path / f"libec_{name}.so"),
                        str(cc)], check=True, capture_output=True)
    return str(tmp_path)


@pytest.mark.parametrize("name", ["nosuch", "missingversion", "badversion",
                                  "missingentrypoint", "failinit"])
def test_load_dynamic_errnos_equal_the_reference(hostile_dir, name):
    errs = []
    for load_dynamic, err in ((registry.load_dynamic, EcError),
                              (jregistry.load_dynamic, JEcError)):
        with pytest.raises(err) as e:
            load_dynamic(name, hostile_dir)
        errs.append(e.value.errno)
    assert errs[0] == errs[1] == {"nosuch": -2, "missingversion": -18, "badversion": -18,
                                  "missingentrypoint": -2, "failinit": -22}[name]
    assert registry.EC_NATIVE_ABI_VERSION == jregistry.EC_NATIVE_ABI_VERSION


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy"])
@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (8, 3), (10, 4)])
def test_native_chunks_equal_the_reference(k, m, technique):
    """The port's `native` plugin (its host chunk path and its array
    path) codes a seeded object to the JAX package's `tpu` plugin's
    chunks, which the reference's own `native` plugin equals
    (`test_native_ec.py`'s byte-identity case; building that plugin runs
    `make` in `native/`, which port tests never do); every single erasure
    and one double decode back."""
    profile = {"k": str(k), "m": str(m), "technique": technique}
    ours = registry.instance().factory("native", dict(profile), device="cpu")
    theirs = jregistry.instance().factory("tpu", dict(profile))
    obj = np.random.default_rng(k * 10 + m).integers(0, 256, 3 * 4096 * k + 77, np.uint8)
    n = k + m
    a, b = ours.encode(set(range(n)), obj.tobytes()), theirs.encode(set(range(n)), obj.tobytes())
    for i in range(n):
        assert np.array_equal(a[i], np.asarray(b[i])), i
    data = np.stack([a[i] for i in range(k)])[None]
    parity = ours.encode_array(data).numpy()
    assert np.array_equal(parity[0], np.stack([a[i] for i in range(k, n)]))
    for lost in [(e,) for e in range(n)] + [(0, n - 1)][: m - 1]:
        got = ours.decode(set(lost), {i: a[i] for i in range(n) if i not in lost})
        for e in lost:
            assert np.array_equal(got[e], a[e]), (lost, e)
