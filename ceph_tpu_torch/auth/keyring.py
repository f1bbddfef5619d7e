"""KeyRing — mirror of src/auth/KeyRing.{h,cc}.

The reference stores per-entity base64 secrets in INI-style keyring
files (`[client.admin]\\n key = <base64>`); mons hold the authoritative
copy (AuthMonitor), daemons load theirs at boot.  Same format here.
"""

from __future__ import annotations

import base64
import os
import secrets as _secrets


def generate_secret() -> bytes:
    """A fresh 16-byte secret (CryptoKey::create AES-128 key size)."""
    return _secrets.token_bytes(16)


class KeyRing:
    """entity name -> secret bytes."""

    def __init__(self) -> None:
        self._keys: dict[str, bytes] = {}

    def add(self, entity: str, secret: bytes | None = None) -> bytes:
        secret = secret if secret is not None else generate_secret()
        self._keys[entity] = secret
        return secret

    def remove(self, entity: str) -> None:
        self._keys.pop(entity, None)

    def get(self, entity: str) -> bytes | None:
        return self._keys.get(entity)

    def entities(self) -> list[str]:
        return sorted(self._keys)

    def __contains__(self, entity: str) -> bool:
        return entity in self._keys

    def __len__(self) -> int:
        return len(self._keys)

    # -- keyring file format (KeyRing::encode_plaintext) ----------------------

    def dumps(self) -> str:
        out = []
        for entity in self.entities():
            key = base64.b64encode(self._keys[entity]).decode()
            out.append(f"[{entity}]\n\tkey = {key}\n")
        return "".join(out)

    @classmethod
    def loads(cls, text: str) -> "KeyRing":
        kr = cls()
        entity = None
        for line in text.splitlines():
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            if line.startswith("[") and line.endswith("]"):
                entity = line[1:-1].strip()
            elif "=" in line and entity is not None:
                field, _, value = line.partition("=")
                if field.strip() == "key":
                    kr._keys[entity] = base64.b64decode(value.strip())
        return kr

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.dumps())
        os.chmod(path, 0o600)

    @classmethod
    def load(cls, path: str) -> "KeyRing":
        with open(path) as f:
            return cls.loads(f.read())
