"""The `jerasure` plugin of the port — jerasure-compatible techniques.

Plugin shell analog of Ceph's src/erasure-code/jerasure/
ErasureCodePluginJerasure.cc: technique selection via the `technique`
profile key (default reed_sol_van).  The device is a keyword of the
registry's factory, `cuda` unless the caller asks for `cpu`.
"""

from ceph_tpu_torch.codec.jerasure import (
    BITMATRIX_TECHNIQUES,
    ErasureCodeJerasure,
    ErasureCodeJerasureBitmatrix,
)
from ceph_tpu_torch.codec.registry import EC_VERSION, ErasureCodePlugin

__erasure_code_version__ = EC_VERSION


def _factory(profile, device):
    technique = profile.get("technique") or "reed_sol_van"
    if technique in BITMATRIX_TECHNIQUES:
        ec = ErasureCodeJerasureBitmatrix(technique, device=device)
    else:
        ec = ErasureCodeJerasure(technique=technique, device=device)
    ec.init(profile)
    return ec


def __erasure_code_init__(registry):
    registry.add("jerasure", ErasureCodePlugin("jerasure", _factory))
