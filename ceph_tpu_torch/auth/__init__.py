"""Auth subsystem — cephx-style shared-secret authentication
(SURVEY.md §1 row 3; src/auth/)."""

from .keyring import KeyRing, generate_secret
from .cephx import AuthError, CephxAuth

__all__ = ["KeyRing", "generate_secret", "CephxAuth", "AuthError"]
