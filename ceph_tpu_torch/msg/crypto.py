"""Secure/compressed on-wire session — mirror of src/msg/async/
crypto_onwire.{h,cc} + compression_onwire.{h,cc}.

After the cephx auth phase both ends hold a session key (derived from the
handshake exactly like the reference's connection_secret) and the
negotiated feature set.  Every subsequent frame is carried inside an
on-wire record:

    magic "CW" | u8 flags | u8 pad | u32 body_len | body

- COMPRESSED: the frame bytes are zlib-deflated first
  (compression_onwire's tx_handler; zlib plays the reference's
  snappy/zstd role).
- SECURE: body = 12-byte nonce || AES-128-GCM ciphertext+tag over the
  (possibly compressed) frame bytes.  The nonce is a 4-byte random salt
  plus a strictly increasing 8-byte counter per direction
  (AES128GCM_OnWireTxHandler's nonce handling); receivers reject
  non-monotonic counters, so a replayed record fails even inside the
  same session.

Tampering anywhere (ciphertext, flags, truncation) surfaces as a
decrypt/parse error and the connection faults — the reference's
ceph_msg_data integrity contract under msgr2 secure mode.
"""

from __future__ import annotations

import hmac
import hashlib
import os
import struct
import zlib

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM
except ImportError:  # plaintext/compress paths work without the package
    AESGCM = None

MAGIC = b"CW"
FLAG_SECURE = 1
FLAG_COMPRESSED = 2

_HEAD = struct.Struct("<2sBBI")  # magic, flags, pad, body_len
NONCE_LEN = 12
KEY_LEN = 16  # AES-128, the reference's connection-secret size


class OnWireError(Exception):
    pass


def derive_session_key(secret: bytes, *parts: bytes) -> bytes:
    """Session key from the auth exchange (cephx's connection_secret
    derivation: both sides know `secret` and the handshake transcript)."""
    return hmac.new(secret, b"\x00session\x00" + b"\x00".join(parts),
                    hashlib.sha256).digest()[:KEY_LEN]


MAX_FRAME = 64 << 20  # decompressed frame ceiling (bomb guard)


class OnWireSession:
    """Per-connection record codec (one per direction pair).

    Each direction runs under its OWN AES key, derived from the
    connection secret and the direction label — a reflected record (the
    sender's own ciphertext played back at it) fails authentication
    instead of decrypting as peer traffic, and the two directions can
    never collide on a nonce (the reference separates directions via its
    nonce/secret split in AES128GCM_OnWireTxHandler)."""

    def __init__(
        self, key: bytes | None, secure: bool, compress: bool,
        initiator: bool = True,
    ):
        if secure and not key:
            raise OnWireError("secure mode requires a session key")
        self.secure = secure
        self.compress = compress
        if secure:
            if AESGCM is None:
                raise OnWireError(
                    "secure mode requires the 'cryptography' package"
                )
            c2s = derive_session_key(key, b"dir:c2s")
            s2c = derive_session_key(key, b"dir:s2c")
            tx, rx = (c2s, s2c) if initiator else (s2c, c2s)
            self._tx_aead = AESGCM(tx)
            self._rx_aead = AESGCM(rx)
        else:
            self._tx_aead = self._rx_aead = None
        self._tx_salt = os.urandom(4)
        self._tx_counter = 0
        self._rx_counter = -1  # strictly increasing; replays rejected

    @property
    def active(self) -> bool:
        return self.secure or self.compress

    def wrap(self, frame_bytes: bytes) -> bytes:
        body = frame_bytes
        flags = 0
        if self.compress:
            body = zlib.compress(body, level=1)
            flags |= FLAG_COMPRESSED
        if self.secure:
            self._tx_counter += 1
            nonce = self._tx_salt + struct.pack("<Q", self._tx_counter)
            body = nonce + self._tx_aead.encrypt(nonce, body, None)
            flags |= FLAG_SECURE
        return _HEAD.pack(MAGIC, flags, 0, len(body)) + body

    def unwrap(self, body: bytes) -> bytes:
        if self.secure:
            if len(body) < NONCE_LEN + 16:
                raise OnWireError("short secure record")
            nonce, ct = body[:NONCE_LEN], body[NONCE_LEN:]
            (counter,) = struct.unpack("<Q", nonce[4:])
            if counter <= self._rx_counter:
                raise OnWireError("replayed or reordered secure record")
            try:
                body = self._rx_aead.decrypt(nonce, ct, None)
            except Exception as e:  # InvalidTag
                raise OnWireError(f"decrypt failed: {e}") from e
            self._rx_counter = counter
        if self.compress:
            try:
                # bounded inflate: a deflate bomb must not OOM the daemon
                d = zlib.decompressobj()
                body = d.decompress(body, MAX_FRAME)
                if d.unconsumed_tail:
                    raise OnWireError("decompressed frame exceeds MAX_FRAME")
            except zlib.error as e:
                raise OnWireError(f"decompress failed: {e}") from e
        return body


async def read_record(reader) -> bytes:
    """Read one on-wire record body from a StreamReader."""
    head = await reader.readexactly(_HEAD.size)
    magic, _flags, _pad, body_len = _HEAD.unpack(head)
    if magic != MAGIC:
        raise OnWireError(f"bad onwire magic {magic!r}")
    if body_len > 1 << 30:
        raise OnWireError(f"implausible record length {body_len}")
    return await reader.readexactly(body_len)
