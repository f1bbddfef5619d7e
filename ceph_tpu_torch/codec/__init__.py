"""Erasure codecs of the PyTorch port: contract, base, registry, RS."""

from .base import ErasureCode
from .interface import EcError, ErasureCodeInterface, Profile
from .jerasure import ErasureCodeJerasure
from .matrix_codec import MatrixCodecMixin
from .registry import ErasureCodePlugin, ErasureCodePluginRegistry, instance
from .rs import CAUCHY, VANDERMONDE, ErasureCodeTpuRs

__all__ = [
    "ErasureCode", "EcError", "ErasureCodeInterface", "Profile",
    "ErasureCodePlugin", "ErasureCodePluginRegistry", "instance",
    "CAUCHY", "VANDERMONDE", "ErasureCodeTpuRs", "ErasureCodeJerasure",
    "MatrixCodecMixin",
]
