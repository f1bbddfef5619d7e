"""File striping over RADOS objects (src/libradosstriper)."""

from .striper import StripedObject, StripePolicy

__all__ = ["StripedObject", "StripePolicy"]
