"""The `lrc` plugin of the port — layered locally-repairable codes.

Plugin shell analog of Ceph's src/erasure-code/lrc/ErasureCodePluginLrc.cc.
The device is a keyword of the registry's factory, `cuda` unless the caller
asks for `cpu`; the layers' inner codecs are made on the same device.
"""

from ceph_tpu_torch.codec.lrc import ErasureCodeLrc
from ceph_tpu_torch.codec.registry import EC_VERSION, ErasureCodePlugin

__erasure_code_version__ = EC_VERSION


def _factory(profile, device):
    ec = ErasureCodeLrc(device)
    ec.init(profile)
    return ec


def __erasure_code_init__(registry):
    registry.add("lrc", ErasureCodePlugin("lrc", _factory))
