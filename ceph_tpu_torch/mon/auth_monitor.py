"""AuthMonitor — the PaxosService owning the cluster keyring.

Mirror of src/mon/AuthMonitor.{h,cc}: entity keys (`client.admin`,
`osd.0`, ...) are created, fetched, and deleted through mon commands and
replicated to every quorum member through Paxos, so any monitor can
authenticate a cephx handshake (auth/cephx.py) against the same
authoritative keyring.  `auth get-or-create` replies only after its
proposal commits — key material never reaches a client before the quorum
has durably agreed on it (AuthMonitor::prepare_command's wait-for-commit).

The keyring snapshot rides each commit in the reference's own plaintext
format (KeyRing::encode_plaintext; auth/keyring.py) — small, and keeps
peons byte-identical.
"""

from __future__ import annotations

import base64
import json

from ..auth.keyring import KeyRing, generate_secret
from ..common.log import dout
from .paxos_service import ProposalQueue


class AuthMonitor:
    def __init__(self, mon):
        self.mon = mon
        self.version = 0
        self.keyring = KeyRing()
        self._props = ProposalQueue(mon, "auth")

    def on_election_changed(self) -> None:
        self._props.reset()

    # -- commands --------------------------------------------------------------

    def command_handler(self, prefix: str):
        handlers = {
            "auth add": (self._cmd_add, True),
            "auth get-or-create": (self._cmd_get_or_create, True),
            "auth del": (self._cmd_del, True),
            "auth get": (self._cmd_get, False),
            "auth ls": (self._cmd_ls, False),
        }
        entry = handlers.get(prefix)
        if entry is None:
            return None
        fn, mutating = entry
        fn.__func__.mutating = mutating
        return fn

    def _cmd_add(self, cmd, reply) -> None:
        entity = cmd["entity"]
        if entity in self.keyring:
            reply(-17, f"entity {entity} exists")  # EEXIST
            return
        secret = (
            base64.b64decode(cmd["key"]) if "key" in cmd else generate_secret()
        )

        def mutate(kr: KeyRing):
            if entity in kr:
                return None
            out = KeyRing.loads(kr.dumps())
            out.add(entity, secret)
            return out

        self._queue(mutate, lambda v: reply(0, f"added key for {entity}"))

    def _cmd_get_or_create(self, cmd, reply) -> None:
        entity = cmd["entity"]
        existing = self.keyring.get(entity)
        if existing is not None:
            reply(0, "", self._entity_blob(entity, existing))
            return
        secret = generate_secret()

        def mutate(kr: KeyRing):
            if entity in kr:
                return None
            out = KeyRing.loads(kr.dumps())
            out.add(entity, secret)
            return out

        def on_committed(_v: int) -> None:
            # Another racing proposal may have created the key first;
            # reply with whatever the committed keyring actually holds.
            key = self.keyring.get(entity) or secret
            reply(0, "", self._entity_blob(entity, key))

        self._queue(mutate, on_committed)

    def _cmd_del(self, cmd, reply) -> None:
        entity = cmd["entity"]

        def mutate(kr: KeyRing):
            if entity not in kr:
                return None
            out = KeyRing.loads(kr.dumps())
            out.remove(entity)
            return out

        self._queue(mutate, lambda v: reply(0, f"deleted {entity}"))

    def _cmd_get(self, cmd, reply) -> None:
        entity = cmd["entity"]
        key = self.keyring.get(entity)
        if key is None:
            reply(-2, f"no key for {entity}")  # ENOENT
            return
        reply(0, "", self._entity_blob(entity, key))

    def _cmd_ls(self, cmd, reply) -> None:
        reply(0, "", json.dumps(self.keyring.entities()).encode())

    @staticmethod
    def _entity_blob(entity: str, key: bytes) -> bytes:
        return json.dumps(
            {"entity": entity, "key": base64.b64encode(key).decode()}
        ).encode()

    # -- paxos -----------------------------------------------------------------

    def _queue(self, mutate, on_committed=None) -> None:
        def make_blob():
            new_kr = mutate(self.keyring)
            if new_kr is None:
                return None
            return json.dumps(
                {"version": self.version + 1, "keyring": new_kr.dumps()}
            ).encode()

        self._props.queue(make_blob, on_committed)

    def apply_commit(self, blob: bytes) -> None:
        info = json.loads(blob.decode())
        self.version = info["version"]
        self.keyring = KeyRing.loads(info["keyring"])
        dout("mon", 10, f"auth v{self.version}: {len(self.keyring)} entities")
