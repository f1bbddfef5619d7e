"""The `native` plugin — isa-style RS coding in C++ (libec_native.so).

The port of `ceph_tpu/codec/plugins/native.py`, the plugin shell analog
of Ceph's src/erasure-code/isa/ErasureCodePluginIsa.cc: technique
selection reed_sol_van|cauchy (:40-57), the compute engine loaded with
Ceph's entry-point contract through `registry.load_dynamic`.

`libec_native.so` is built from `csrc/ec_native.cc` at first use into a
directory of its own under the git-ignored `ceph_tpu_torch/_build/` (the
erasure_code_dir role, global.yaml.in:431), named by the sha256 of the
source; a failed build raises.  The reference runs `make` in `native/`;
the port never builds into, or loads from, that directory.
"""

from ceph_tpu_torch.codec.registry import EC_VERSION, ErasureCodePlugin, load_dynamic
from ceph_tpu_torch.utils import host_build

__erasure_code_version__ = EC_VERSION

SOURCE = host_build.CSRC / "ec_native.cc"

_lib = None


def build_dir() -> str:
    """The directory that holds this source's `libec_native.so`, built on
    demand."""
    return str(host_build.build("ec_native", [SOURCE], name="libec_native.so").parent)


def _get_lib():
    global _lib
    if _lib is None:
        _lib = load_dynamic("native", build_dir())
    return _lib


def _factory(profile, device):
    from ceph_tpu_torch.codec.native_codec import ErasureCodeNative
    from ceph_tpu_torch.codec.tracing import instrument_codec

    technique = profile.get("technique") or "reed_sol_van"
    ec = ErasureCodeNative(_get_lib(), technique=technique, device=device)
    ec.init(profile)
    # chunk-path calls (the C engine) get a single `kernel` span; the
    # inherited device paths get h2d/kernel_launch like the tpu plugin
    return instrument_codec(ec, "native")


def __erasure_code_init__(registry):
    registry.add("native", ErasureCodePlugin("native", _factory))
