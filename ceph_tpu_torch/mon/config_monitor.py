"""ConfigMonitor — the PaxosService owning the central config DB.

Mirror of src/mon/ConfigMonitor.{h,cc}: `ceph config set/rm/get/dump`
mutate a versioned key store through Paxos, and every daemon that
subscribes to "config" receives the subset relevant to it, resolved with
the reference's layering (global < daemon-type section < named daemon,
ConfigMonitor::load_config building per-entity maps).  Daemons apply the
pushed values to their runtime Config, so a `config set osd
osd_max_backfills 3` takes effect cluster-wide without restarts — the
push lands on the same observer path a local `set` uses
(common/config.py, md_config_t::apply_changes in the reference).

State is small (a few hundred options), so commits carry the full
section store rather than incrementals — same trade MgrMonitor makes.
"""

from __future__ import annotations

import json

from ..common.errs import EINVAL
from ..common.log import dout
from ..common.options import OPTIONS
from ..msg.messages import MConfig
from .paxos_service import ProposalQueue


class ConfigMonitor:
    def __init__(self, mon):
        self.mon = mon
        self.version = 0
        # section -> {option: raw value}; sections are "global", a daemon
        # type ("osd", "mon", "client", "mgr"), or a named daemon ("osd.3").
        self.sections: dict[str, dict[str, str]] = {}
        self._props = ProposalQueue(mon, "config")

    def on_election_changed(self) -> None:
        self._props.reset()

    # -- entity resolution -----------------------------------------------------

    def config_for(self, entity: str) -> dict[str, str]:
        """Layered view for one entity (ConfigMonitor's per-daemon map):
        global < type section < named section, later layers winning."""
        layers = ["global"]
        if "." in entity:
            layers.append(entity.split(".", 1)[0])
        layers.append(entity)
        out: dict[str, str] = {}
        for sec in layers:
            out.update(self.sections.get(sec, {}))
        return out

    # -- commands --------------------------------------------------------------

    def command_handler(self, prefix: str):
        handlers = {
            "config set": (self._cmd_set, True),
            "config rm": (self._cmd_rm, True),
            "config get": (self._cmd_get, False),
            "config dump": (self._cmd_dump, False),
        }
        entry = handlers.get(prefix)
        if entry is None:
            return None
        fn, mutating = entry
        fn.__func__.mutating = mutating
        return fn

    def _cmd_set(self, cmd, reply) -> None:
        who, name, value = cmd["who"], cmd["name"], str(cmd["value"])
        # Reject unknown options and type-invalid values at the command, the
        # reference's behavior (ConfigMonitor::prepare_command validates via
        # the option schema) — a committed typo that every daemon silently
        # skips would look applied while doing nothing.
        opt = OPTIONS.get(name)
        if opt is None:
            reply(-EINVAL, f"unrecognized config option '{name}'")
            return
        try:
            opt.parse(value)
        except (ValueError, TypeError) as e:
            reply(-EINVAL, f"invalid value for '{name}': {e}")
            return

        def mutate(sections):
            sec = dict(sections.get(who, {}))
            if sec.get(name) == value:
                return None
            sec[name] = value
            out = dict(sections)
            out[who] = sec
            return out

        self._queue(mutate, lambda v: reply(0, f"set {who}/{name}"))

    def _cmd_rm(self, cmd, reply) -> None:
        who, name = cmd["who"], cmd["name"]

        def mutate(sections):
            if name not in sections.get(who, {}):
                return None
            sec = dict(sections[who])
            del sec[name]
            out = dict(sections)
            if sec:
                out[who] = sec
            else:
                del out[who]
            return out

        self._queue(mutate, lambda v: reply(0, f"rm {who}/{name}"))

    def _cmd_get(self, cmd, reply) -> None:
        reply(0, "", json.dumps(self.config_for(cmd["who"])).encode())

    def _cmd_dump(self, cmd, reply) -> None:
        reply(
            0,
            "",
            json.dumps({"version": self.version, "sections": self.sections}).encode(),
        )

    # -- paxos -----------------------------------------------------------------

    def _queue(self, mutate, on_committed=None) -> None:
        def make_blob():
            new_sections = mutate(self.sections)
            if new_sections is None:
                return None
            return json.dumps(
                {"version": self.version + 1, "sections": new_sections}
            ).encode()

        self._props.queue(make_blob, on_committed)

    def apply_commit(self, blob: bytes) -> None:
        info = json.loads(blob.decode())
        self.version = info["version"]
        self.sections = {s: dict(kv) for s, kv in info["sections"].items()}
        dout("mon", 10, f"config v{self.version}: {len(self.sections)} sections")
        self.mon.publish_config()

    # -- subscriptions ---------------------------------------------------------

    def check_sub(self, conn, subs: dict[str, int]) -> None:
        """Push this entity's resolved config (MConfig) when it is behind.
        Entities are identified by the connection's hello name, e.g.
        "osd.3" (ConfigMonitor::check_sub)."""
        if self.version == 0 or subs.get("config", 0) > self.version:
            return
        subs["config"] = self.version + 1
        changes = self.config_for(conn.peer_name)
        self.mon.send_to_conn(
            conn,
            MConfig(version=self.version, changes=json.dumps(changes).encode()),
        )
