"""The `clay` plugin of the port — coupled-layer MSR regenerating codes.

Plugin shell analog of Ceph's src/erasure-code/clay/ErasureCodePluginClay.cc.
The device is a keyword of the registry's factory, `cuda` unless the caller
asks for `cpu`; the inner codecs are made on the same device.
"""

from ceph_tpu_torch.codec.clay import ErasureCodeClay
from ceph_tpu_torch.codec.registry import EC_VERSION, ErasureCodePlugin

__erasure_code_version__ = EC_VERSION


def _factory(profile, device):
    ec = ErasureCodeClay(device)
    ec.init(profile)
    return ec


def __erasure_code_init__(registry):
    registry.add("clay", ErasureCodePlugin("clay", _factory))
