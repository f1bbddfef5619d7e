"""The `tpu` plugin of the port — registers the RS codec.

Plugin shell analog of Ceph's src/erasure-code/isa/ErasureCodePluginIsa.cc
(technique selection :40-57).  Profile keys: k, m, technique in
{reed_sol_van, cauchy}.  The device is a keyword of the registry's factory,
`cuda` unless the caller asks for `cpu`.
"""

from ceph_tpu_torch.codec.registry import EC_VERSION, ErasureCodePlugin
from ceph_tpu_torch.codec.rs import VANDERMONDE, ErasureCodeTpuRs
from ceph_tpu_torch.codec.tracing import instrument_codec

__erasure_code_version__ = EC_VERSION


def _factory(profile, device):
    technique = profile.get("technique") or VANDERMONDE
    ec = ErasureCodeTpuRs(technique=technique, device=device)
    ec.init(profile)
    # h2d / kernel_launch sub-spans on the device paths when an op trace
    # is active (codec/tracing.py); free when tracing is off
    return instrument_codec(ec, "tpu")


def __erasure_code_init__(registry):
    registry.add("tpu", ErasureCodePlugin("tpu", _factory))
