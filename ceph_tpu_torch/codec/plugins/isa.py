"""The `isa` plugin name of the port — an alias for the `tpu` codec.

Ceph's profiles say `plugin=isa` (src/erasure-code/isa/
ErasureCodePluginIsa.cc); the `tpu` codec's chunks are byte-identical to
ISA-L's, so such profiles load the same class the `tpu` name does, on the
device the registry's factory is given.
"""

from ceph_tpu_torch.codec.plugins.tpu import _factory
from ceph_tpu_torch.codec.registry import EC_VERSION, ErasureCodePlugin

__erasure_code_version__ = EC_VERSION


def __erasure_code_init__(registry):
    registry.add("isa", ErasureCodePlugin("isa", _factory))
