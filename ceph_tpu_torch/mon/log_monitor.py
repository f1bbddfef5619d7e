"""LogMonitor — the PaxosService owning the cluster log.

Mirror of src/mon/LogMonitor.{h,cc}: daemons' clog sinks
(common/clog.py's ClusterLogClient; the reference's LogClient) send MLog
entries to the monitors; the leader batches them through Paxos so every
quorum member holds the same bounded, versioned log; `log last [n]
[channel] [level]` reads the tail and "log" subscribers get committed
entries pushed.  This is where the EC data path's integrity complaints
land — the reference raises `clog->error() << "Bad hash for ..."` on
chunk CRC mismatch (src/osd/ECBackend.cc:1080); here the scrubber's
clog_error ends up in this service, queryable from any mon.

The service is also the cluster event timeline:

- Entries are structured: channel (`cluster` | `audit`), severity,
  entity, per-client seq, optional health-check code.  The bounded
  tail honors the runtime-mutable `mon_log_max` option.
- **Health event history**: the leader's tick diffs the mon's rendered
  health checks against the committed `active_checks` state and
  records every transition (raise / update / clear) as a timestamped
  event — queryable via `health history` — while also emitting the
  Ceph-style "Health check failed/cleared" cluster-log lines.
- **Health mute** (`health mute <code> [ttl] [--sticky]` /
  `health unmute <code>`): muted checks drop out of the health banner
  and overall_status but keep being evaluated and scraped.  TTLs
  expire, and a non-sticky mute auto-clears when the check worsens
  (its detail-line count exceeds the count at mute time) — Ceph's
  HealthMonitor mute semantics.  Mutes, events, and the active-check
  map all ride the same paxos blobs, so they are identical across the
  quorum and survive elections.
"""

from __future__ import annotations

import json
import time
from collections import deque

from ..common.health import check_severity
from ..common.log import dout
from ..msg.messages import MLog
from .paxos_service import ProposalQueue

KEEP_DEFAULT = 500  # mon_log_max default (bound re-read per commit)

# health-event history bound: transitions are far rarer than log
# entries, so a fixed generous cap keeps the state small without
# another option
EVENTS_KEEP = 200


def _parse_ttl(spec) -> float | None:
    """Mute TTL: seconds as a number, or '30s' / '5m' / '2h' strings
    (the reference's `ceph health mute <code> <ttl>` accepts the same
    suffixed durations).  None / empty = no expiry."""
    if spec is None or spec == "":
        return None
    if isinstance(spec, (int, float)):
        return float(spec)
    s = str(spec).strip().lower()
    mult = 1.0
    if s and s[-1] in "smh":
        mult = {"s": 1.0, "m": 60.0, "h": 3600.0}[s[-1]]
        s = s[:-1]
    return float(s) * mult


class LogMonitor:
    def __init__(self, mon):
        self.mon = mon
        self.version = 0
        self.entries: deque[dict] = deque(maxlen=self._keep())
        # committed health-event history + lifetime counter
        self.health_events: deque[dict] = deque(maxlen=EVENTS_KEEP)
        self.events_total = 0
        # committed rendered-check state the leader's tick diffs against
        # (code -> {severity, summary, count}); committed so a NEW
        # leader after an election diffs against the same state and
        # does not re-raise events for checks that never transitioned
        self.active_checks: dict[str, dict] = {}
        # committed mutes: code -> {sticky, ttl_expires|None, count, stamp}
        self.mutes: dict[str, dict] = {}
        self._incoming: list[dict] = []
        self._mute_ops: list[dict] = []
        self._pending_events: list[dict] = []
        self._props = ProposalQueue(mon, "logm")

    def _keep(self) -> int:
        try:
            return max(1, int(self.mon.conf.get("mon_log_max")))
        except KeyError:
            return KEEP_DEFAULT

    def on_election_changed(self) -> None:
        self._incoming.clear()
        self._mute_ops.clear()
        self._pending_events.clear()
        self._props.reset()

    # -- daemon -> mon entries -------------------------------------------------

    @staticmethod
    def _coerce(e: dict) -> dict:
        """Normalize one wire entry: legacy senders (no channel/seq)
        still land as cluster-channel entries."""
        out = {
            "prio": str(e.get("prio", "info")),
            "channel": str(e.get("channel", "cluster")),
            "who": str(e.get("who", "?")),
            "stamp": float(e.get("stamp", time.time())),
            "msg": str(e.get("msg", "")),
        }
        if e.get("seq") is not None:
            out["seq"] = int(e["seq"])
        if e.get("code"):
            out["code"] = str(e["code"])
        return out

    def prepare_log(self, msg: MLog) -> None:
        """Leader-only (LogMonitor::prepare_log): queue incoming entries
        for the next proposal."""
        try:
            entries = json.loads(msg.entries.decode())
        except json.JSONDecodeError:
            dout("mon", 5, "logm: dropping undecodable MLog")
            return
        for e in entries:
            self._incoming.append(self._coerce(e))
        self._props.queue(self._make_blob)

    def log(
        self,
        prio: str,
        who: str,
        message: str,
        channel: str = "cluster",
        code: str | None = None,
    ) -> None:
        """In-process clog entry from the mon itself (LogChannel::do_log).
        On a peon this routes like a daemon entry — forwarded to the
        leader — so it is never stranded in a local queue."""
        entry = {
            "prio": prio,
            "channel": channel,
            "who": who,
            "stamp": time.time(),
            "msg": message,
        }
        if code is not None:
            entry["code"] = code
        if self.mon.is_leader():
            self._incoming.append(entry)
            self._props.queue(self._make_blob)
        elif self.mon.leader_rank is not None:
            self.mon._send_mon(
                self.mon.leader_rank,
                MLog(version=0, entries=json.dumps([entry]).encode()),
            )

    # -- health events + mutes (leader tick) -----------------------------------

    def tick(self) -> None:
        """Leader-only, from Monitor's tick loop: diff the rendered
        health checks against committed state, recording transitions as
        events + clog lines, and expire / auto-clear mutes."""
        if not self.mon.is_leader():
            return
        now = time.time()
        checks, details = self.mon.health_checks()
        current = {
            code: {
                "severity": check_severity(code),
                "summary": summary,
                "count": len(details.get(code, ())) or 1,
            }
            for code, summary in checks.items()
        }
        events: list[dict] = []
        for code, cur in sorted(current.items()):
            prev = self.active_checks.get(code)
            if prev is None:
                events.append({"type": "raise", "code": code, **cur})
            elif prev["summary"] != cur["summary"] or prev["count"] != cur["count"]:
                events.append({"type": "update", "code": code, **cur})
        for code, prev in sorted(self.active_checks.items()):
            if code not in current:
                events.append(
                    {
                        "type": "clear",
                        "code": code,
                        "severity": prev["severity"],
                        "summary": prev["summary"],
                        "count": 0,
                    }
                )
        for ev in events:
            ev["stamp"] = now
            # the Ceph cluster-log lines health transitions produce
            if ev["type"] == "clear":
                prio, text = "info", f"Health check cleared: {ev['code']}"
            elif ev["type"] == "raise":
                prio = "error" if ev["severity"] == "HEALTH_ERR" else "warn"
                text = f"Health check failed: {ev['summary']} ({ev['code']})"
            else:
                prio = "error" if ev["severity"] == "HEALTH_ERR" else "warn"
                text = f"Health check update: {ev['summary']} ({ev['code']})"
            self._incoming.append(
                {
                    "prio": prio,
                    "channel": "cluster",
                    "who": f"mon.{self.mon.name}",
                    "stamp": now,
                    "msg": text,
                    "code": ev["code"],
                }
            )
        self._pending_events.extend(events)
        # mute maintenance: expire TTLs; auto-clear non-sticky mutes
        # whose check worsened past the mute-time count
        for code, m in sorted(self.mutes.items()):
            exp = m.get("ttl_expires")
            if exp is not None and now >= exp:
                self._queue_mute_op({"op": "unmute", "code": code}, None)
                self.log(
                    "info", f"mon.{self.mon.name}",
                    f"health mute {code} expired", code=code,
                )
            elif (
                not m.get("sticky")
                and code in current
                and current[code]["count"] > m.get("count", 0)
            ):
                self._queue_mute_op({"op": "unmute", "code": code}, None)
                self.log(
                    "warn", f"mon.{self.mon.name}",
                    f"health mute {code} cleared: check worsened "
                    f"({m.get('count', 0)} -> {current[code]['count']})",
                    code=code,
                )
        if events or self._incoming:
            self._props.queue(self._make_blob)

    def _queue_mute_op(self, op: dict, on_committed) -> None:
        self._mute_ops.append(op)
        self._props.queue(self._make_blob, on_committed)

    # -- render-time mute filtering --------------------------------------------

    def muted_codes(self, now: float | None = None) -> set[str]:
        """Codes whose mute is live right now.  TTL expiry is honored at
        render time on every member — a peon serving `health` does not
        wait for the leader's tick to commit the unmute."""
        now = time.time() if now is None else now
        return {
            code
            for code, m in self.mutes.items()
            if m.get("ttl_expires") is None or now < m["ttl_expires"]
        }

    def filter_muted(
        self, checks: dict[str, str], details: dict[str, list[str]]
    ) -> tuple[dict[str, str], dict[str, list[str]], list[str]]:
        """(visible checks, visible details, muted codes that are both
        muted and currently raised) — the banner drops muted checks but
        names them, the reference's `(muted: CODE)` status suffix."""
        muted = self.muted_codes()
        vis = {c: s for c, s in checks.items() if c not in muted}
        vdet = {c: d for c, d in details.items() if c not in muted}
        return vis, vdet, sorted(c for c in checks if c in muted)

    # -- commands --------------------------------------------------------------

    def command_handler(self, prefix: str):
        table = {
            "log last": (self._cmd_log_last, False),
            "health history": (self._cmd_health_history, False),
            "health mute": (self._cmd_health_mute, True),
            "health unmute": (self._cmd_health_unmute, True),
        }
        entry = table.get(prefix)
        if entry is None:
            return None
        fn, mutating = entry
        fn.__func__.mutating = mutating
        return fn

    def _cmd_log_last(self, cmd, reply) -> None:
        n = int(cmd.get("num", 20))
        level = cmd.get("level")
        channel = cmd.get("channel")
        tail = [
            e
            for e in self.entries
            if (level is None or e["prio"] == level)
            and (channel is None or e.get("channel", "cluster") == channel)
        ]
        # tail[-0:] would be the whole tail; n <= 0 means "no entries"
        # (version probe).
        tail = tail[-n:] if n > 0 else []
        reply(
            0,
            "",
            json.dumps({"version": self.version, "entries": tail}).encode(),
        )

    def _cmd_health_history(self, cmd, reply) -> None:
        n = int(cmd.get("num", 50))
        events = list(self.health_events)
        reply(
            0,
            "",
            json.dumps(
                {
                    "version": self.version,
                    "events": events[-n:] if n > 0 else [],
                    "events_total": self.events_total,
                    "mutes": self.mutes,
                    "active": self.active_checks,
                }
            ).encode(),
        )

    def _cmd_health_mute(self, cmd, reply) -> None:
        code = str(cmd.get("code", "")).strip()
        if not code:
            reply(-22, "health mute: a check code is required")
            return
        try:
            ttl = _parse_ttl(cmd.get("ttl"))
        except ValueError:
            reply(-22, f"health mute: invalid ttl {cmd.get('ttl')!r}")
            return
        checks, details = self.mon.health_checks()
        op = {
            "op": "mute",
            "code": code,
            "sticky": bool(cmd.get("sticky")),
            "ttl_expires": None if ttl is None else time.time() + ttl,
            "count": len(details.get(code, ())) or (1 if code in checks else 0),
            "stamp": time.time(),
        }
        self._queue_mute_op(
            op, lambda _v: reply(0, f"muted {code}")
        )
        self.log(
            "info", f"mon.{self.mon.name}",
            f"health mute {code}"
            + (f" ttl={cmd.get('ttl')}" if cmd.get("ttl") else "")
            + (" sticky" if cmd.get("sticky") else ""),
            channel="audit", code=code,
        )

    def _cmd_health_unmute(self, cmd, reply) -> None:
        code = str(cmd.get("code", "")).strip()
        if not code:
            reply(-22, "health unmute: a check code is required")
            return
        if code not in self.mutes:
            reply(-2, f"{code} is not muted")
            return
        self._queue_mute_op(
            {"op": "unmute", "code": code},
            lambda _v: reply(0, f"unmuted {code}"),
        )
        self.log(
            "info", f"mon.{self.mon.name}",
            f"health unmute {code}", channel="audit", code=code,
        )

    # -- paxos -----------------------------------------------------------------

    def _make_blob(self) -> bytes | None:
        """Drain everything accumulated since the last proposal; queued
        kicks whose payload was already taken become no-ops."""
        if not (self._incoming or self._pending_events or self._mute_ops):
            return None
        blob: dict = {"version": self.version + 1}
        if self._incoming:
            blob["append"], self._incoming = self._incoming, []
        if self._pending_events:
            blob["events"], self._pending_events = self._pending_events, []
        if self._mute_ops:
            blob["mute_ops"], self._mute_ops = self._mute_ops, []
        return json.dumps(blob).encode()

    def apply_commit(self, blob: bytes) -> None:
        info = json.loads(blob.decode())
        self.version = info["version"]
        keep = self._keep()
        if keep != self.entries.maxlen:
            self.entries = deque(self.entries, maxlen=keep)
        appended = info.get("append", [])
        self.entries.extend(appended)
        for e in appended:
            dout("mon", 10, f"clog {e['prio']} {e['who']}: {e['msg']}")
        for ev in info.get("events", []):
            self.health_events.append(ev)
            self.events_total += 1
            code = ev["code"]
            if ev["type"] == "clear":
                self.active_checks.pop(code, None)
            else:
                self.active_checks[code] = {
                    "severity": ev["severity"],
                    "summary": ev["summary"],
                    "count": ev["count"],
                }
        for op in info.get("mute_ops", []):
            if op["op"] == "mute":
                self.mutes[op["code"]] = {
                    "sticky": op.get("sticky", False),
                    "ttl_expires": op.get("ttl_expires"),
                    "count": op.get("count", 0),
                    "stamp": op.get("stamp", 0.0),
                }
            else:
                self.mutes.pop(op["code"], None)
        if appended:
            self.mon.publish_log(appended)

    # -- subscriptions ---------------------------------------------------------

    def check_sub(self, conn, subs: dict[str, int]) -> None:
        """Initial push on subscribe: the committed tail."""
        if self.version == 0 or subs.get("log", 0) > self.version:
            return
        subs["log"] = self.version + 1
        self.mon.send_to_conn(
            conn,
            MLog(
                version=self.version,
                entries=json.dumps(list(self.entries)).encode(),
            ),
        )

    def push_new(self, conn, subs: dict[str, int], appended: list[dict]) -> None:
        """Incremental push of freshly committed entries."""
        if subs.get("log", 0) > self.version:
            return
        subs["log"] = self.version + 1
        self.mon.send_to_conn(
            conn,
            MLog(version=self.version, entries=json.dumps(appended).encode()),
        )
