"""The `shec` plugin of the port — shingled erasure codes.

Plugin shell analog of Ceph's src/erasure-code/shec/ErasureCodePluginShec.cc:
technique single|multiple, default multiple (:45-52).  The device is a
keyword of the registry's factory, `cuda` unless the caller asks for `cpu`.
"""

from ceph_tpu_torch.codec.registry import EC_VERSION, ErasureCodePlugin
from ceph_tpu_torch.codec.shec import MULTIPLE, ErasureCodeShec

__erasure_code_version__ = EC_VERSION


def _factory(profile, device):
    technique = profile.get("technique") or MULTIPLE
    ec = ErasureCodeShec(technique=technique, device=device)
    ec.init(profile)
    return ec


def __erasure_code_init__(registry):
    registry.add("shec", ErasureCodePlugin("shec", _factory))
