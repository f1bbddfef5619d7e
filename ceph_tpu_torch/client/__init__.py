"""Client I/O library — librados + Objecter analogs."""

from .objecter import Objecter
from .rados import IoCtx, Rados, RadosError

__all__ = ["Objecter", "Rados", "IoCtx", "RadosError"]
