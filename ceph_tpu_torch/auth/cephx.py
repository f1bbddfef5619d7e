"""cephx challenge/response — mirror of src/auth/cephx/.

The reference's cephx protocol (CephxProtocol.h; docs in
doc/dev/cephx_protocol.rst) is a Kerberos-like scheme: the client proves
knowledge of its secret by encrypting a server challenge, then receives
session-keyed tickets.  This module keeps the protocol shape over the
msgr2 frame channel (frames_v2.h auth frame tags) with HMAC-SHA256 as
the proof primitive instead of AES encryption:

  client                               server
    AUTH_REQUEST [entity] ---------------->
    <------------- AUTH_MORE [server_challenge]
    AUTH_MORE [client_challenge, proof] -->      proof = HMAC(secret,
    <--- AUTH_DONE [confirm, ticket]             sc || cc)
         confirm = HMAC(secret, cc || sc)        (mutual: client verifies
                                                  confirm)

A failed lookup or bad proof gets AUTH_BAD and a closed connection —
the reference's -EACCES path (CephxServiceHandler::handle_request).
Tickets are HMAC-signed {entity, expiry} blobs under the service key
(CephxSessionHandler's service secret), honored on fast reconnects.
"""

from __future__ import annotations

import hmac
import json
import hashlib
import secrets as _secrets
import time

from ..common.log import dout
from .keyring import KeyRing, generate_secret

# Auth frame tags (frames_v2.h Tag::AUTH_*)
TAG_AUTH_REQUEST = 10
TAG_AUTH_MORE = 11
TAG_AUTH_DONE = 12
TAG_AUTH_BAD = 13

CHALLENGE_LEN = 16
TICKET_VALIDITY = 3600.0  # auth_service_ticket_ttl
PROOF_FRESHNESS = 60.0  # seconds a ticket proof's timestamp stays valid


class AuthError(Exception):
    pass


def _hmac(secret: bytes, *parts: bytes) -> bytes:
    return hmac.new(secret, b"".join(parts), hashlib.sha256).digest()


class CephxAuth:
    """Both ends of the handshake; attach one to a Messenger.

    The server side needs the full keyring (mons/daemons verifying
    peers); the client side needs its own (entity, secret).
    """

    def __init__(
        self,
        entity: str,
        secret: bytes,
        keyring: KeyRing | None = None,
        service_secret: bytes | None = None,
    ):
        self.entity = entity
        self.secret = secret
        self.keyring = keyring
        self.service_secret = service_secret or generate_secret()
        # peer addr -> ticket from that peer's service (CephxTicketManager)
        self._tickets: dict[str, bytes] = {}
        # recently accepted ticket proofs (replay rejection window)
        self._seen_proofs: dict[bytes, float] = {}

    @classmethod
    def for_daemon(cls, entity: str, keyring: KeyRing) -> "CephxAuth":
        secret = keyring.get(entity)
        if secret is None:
            raise AuthError(f"no key for {entity} in keyring")
        return cls(entity, secret, keyring=keyring)

    @classmethod
    def for_client(cls, entity: str, secret: bytes) -> "CephxAuth":
        return cls(entity, secret)

    # -- client side (CephxClientHandler) --------------------------------------

    async def client_auth(
        self, send_frame, recv_frame, peer: str = ""
    ) -> tuple[bytes, bytes]:
        """Run the client handshake over frame callables; returns
        (session ticket, connection secret).  Raises AuthError on
        rejection.

        The connection secret is derived from the handshake transcript
        (the reference's CephxConnectionHandler connection_secret) and
        keys msgr2 secure mode.

        A ticket previously issued by `peer` rides in the request; if the
        server accepts it the challenge round-trip is skipped (the
        reference's ticket-based fast path, CephxTicketManager)."""
        from ..msg.crypto import derive_session_key

        cached = self._tickets.get(peer, b"")
        if cached:
            # Ticket + proof-of-secret: possession of a (plaintext-carried)
            # ticket alone must not authenticate — the proof binds it to
            # the entity key and a fresh timestamp (the reference's
            # CEPHX_V2 authorizer carries the same freshness binding).
            ts = str(time.time()).encode()
            req = [self.entity.encode(), cached, ts, _hmac(self.secret, cached, ts)]
        else:
            req = [self.entity.encode()]
        await send_frame(TAG_AUTH_REQUEST, req)
        tag, segs = await recv_frame()
        if tag == TAG_AUTH_DONE and cached:
            # Ticket accepted: server proves key knowledge over the ticket.
            confirm, ticket = segs[0], segs[1]
            if not hmac.compare_digest(confirm, _hmac(self.secret, cached)):
                raise AuthError("server failed mutual auth on ticket path")
            self._tickets[peer] = ticket
            return ticket, derive_session_key(self.secret, cached, ts)
        if tag != TAG_AUTH_MORE:
            raise AuthError(f"server rejected auth request (tag {tag})")
        server_challenge = segs[0]
        client_challenge = _secrets.token_bytes(CHALLENGE_LEN)
        proof = _hmac(self.secret, server_challenge, client_challenge)
        await send_frame(TAG_AUTH_MORE, [client_challenge, proof])
        tag, segs = await recv_frame()
        if tag != TAG_AUTH_DONE:
            raise AuthError("bad credentials (server sent AUTH_BAD)")
        confirm, ticket = segs[0], segs[1]
        expect = _hmac(self.secret, client_challenge, server_challenge)
        if not hmac.compare_digest(confirm, expect):
            raise AuthError("server failed mutual auth (wrong service key?)")
        if peer:
            self._tickets[peer] = ticket
        return ticket, derive_session_key(
            self.secret, server_challenge, client_challenge
        )

    # -- server side (CephxServiceHandler) -------------------------------------

    async def server_auth(self, send_frame, recv_frame) -> tuple[str, bytes]:
        """Run the server handshake; returns (authenticated entity name,
        connection secret).  Raises AuthError (after sending AUTH_BAD) on
        failure."""
        from ..msg.crypto import derive_session_key

        tag, segs = await recv_frame()
        if tag != TAG_AUTH_REQUEST:
            await send_frame(TAG_AUTH_BAD, [b"expected auth request"])
            raise AuthError("protocol error: no auth request")
        entity = segs[0].decode()
        secret = self.keyring.get(entity) if self.keyring else None
        if len(segs) >= 4 and secret is not None:
            # Ticket fast path: the ticket must verify AND the client must
            # prove key knowledge over (ticket, fresh timestamp); replayed
            # proofs are rejected (the reference's CEPHX_V2 nonce window).
            presented, ts, proof = segs[1], segs[2], segs[3]
            if (
                self.verify_ticket(presented) == entity
                and self._fresh(ts)
                and hmac.compare_digest(proof, _hmac(secret, presented, ts))
                and self._unseen(proof)
            ):
                confirm = _hmac(secret, presented)
                renewed = self.issue_ticket(entity)
                await send_frame(TAG_AUTH_DONE, [confirm, renewed])
                return entity, derive_session_key(secret, presented, ts)
        server_challenge = _secrets.token_bytes(CHALLENGE_LEN)
        if secret is None:
            # Don't leak which entities exist: issue a challenge anyway and
            # fail the proof (the reference logs and rejects).
            secret = _secrets.token_bytes(16)
            dout("auth", 5, f"cephx: unknown entity {entity}")
        await send_frame(TAG_AUTH_MORE, [server_challenge])
        tag, segs = await recv_frame()
        if tag != TAG_AUTH_MORE:
            await send_frame(TAG_AUTH_BAD, [b"expected proof"])
            raise AuthError("protocol error: no proof")
        client_challenge, proof = segs[0], segs[1]
        expect = _hmac(secret, server_challenge, client_challenge)
        if not hmac.compare_digest(proof, expect):
            await send_frame(TAG_AUTH_BAD, [b"bad proof"])
            raise AuthError(f"bad proof from {entity}")
        confirm = _hmac(secret, client_challenge, server_challenge)
        ticket = self.issue_ticket(entity)
        await send_frame(TAG_AUTH_DONE, [confirm, ticket])
        return entity, derive_session_key(
            secret, server_challenge, client_challenge
        )

    # -- ticket proof helpers --------------------------------------------------

    def _fresh(self, ts: bytes) -> bool:
        try:
            return abs(time.time() - float(ts.decode())) < PROOF_FRESHNESS
        except ValueError:
            return False

    def _unseen(self, proof: bytes) -> bool:
        """Reject replayed proofs inside the freshness window."""
        seen = self._seen_proofs
        now = time.time()
        for p, exp in list(seen.items()):
            if exp < now:
                del seen[p]
        if proof in seen:
            return False
        seen[proof] = now + PROOF_FRESHNESS
        return True

    # -- tickets (CephxSessionHandler) -----------------------------------------

    def issue_ticket(self, entity: str) -> bytes:
        body = json.dumps(
            {"entity": entity, "expires": time.time() + TICKET_VALIDITY}
        ).encode()
        sig = _hmac(self.service_secret, body)
        return len(body).to_bytes(4, "little") + body + sig

    def verify_ticket(self, ticket: bytes) -> str | None:
        """Entity name if the ticket is valid and unexpired, else None."""
        try:
            n = int.from_bytes(ticket[:4], "little")
            body, sig = ticket[4 : 4 + n], ticket[4 + n :]
            if not hmac.compare_digest(sig, _hmac(self.service_secret, body)):
                return None
            info = json.loads(body.decode())
            if info["expires"] < time.time():
                return None
            return info["entity"]
        except (ValueError, KeyError, json.JSONDecodeError):
            return None
