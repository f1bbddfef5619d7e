"""clog mgr module — the mgr-side window onto the committed cluster log.

The reference mgr subscribes to the mons' log channel (ClusterLogClient
consumers like the dashboard's audit log and the prometheus exporter's
recent-events view).  Same role here: the module subscribes to the mon
"log" stream, keeps a bounded ring of recent committed entries for the
dashboard's /api/log route, counts committed traffic per
(channel, severity) for the ceph_tpu_clog_messages_total family, and
polls the mons' `health history` for the event/mute scrape families
(ceph_tpu_health_events_total / ceph_tpu_health_muted).

The port's copy of `ceph_tpu/mgr/clog.py`.
"""

from __future__ import annotations

import json

from ..common.clog import severity_rank
from ..common.log import dout
from .modules import MgrModule

RECENT_KEEP = 100  # bounded dashboard ring (mon keeps the real tail)


class ClogModule(MgrModule):
    NAME = "clog"

    def __init__(self) -> None:
        super().__init__()
        from collections import deque

        self.recent = deque(maxlen=RECENT_KEEP)
        # committed entries by (channel, severity) — counter families must
        # only ever grow, so replayed tails (initial push after a
        # resubscribe) are deduped by each entity's monotone seq
        self.counts: dict[tuple[str, str], int] = {}
        self._seen_seq: dict[str, int] = {}  # who -> highest seq counted
        self.events_total = 0
        self.muted: dict[str, dict] = {}  # code -> mute record
        self._wired = False
        self._poll_errors = 0

    # -- log stream ------------------------------------------------------------

    def _wire(self) -> None:
        """Chain onto the mgr's MonClient log callback (keeps any
        previously installed consumer) and register the subscription;
        the beacon loop's resubscribe() carries it across mon failover."""
        monc = self.mgr.monc
        prev = monc.on_log

        def on_log(msg) -> None:
            if prev is not None:
                prev(msg)
            self._absorb(msg)

        monc.on_log = on_log
        self._wired = True

    def _absorb(self, msg) -> None:
        try:
            entries = json.loads(msg.entries.decode() or "[]")
        except json.JSONDecodeError:
            return
        for e in entries:
            if not isinstance(e, dict):
                continue
            who = str(e.get("who", "?"))
            seq = int(e.get("seq", 0))
            if seq <= self._seen_seq.get(who, -1):
                continue  # replayed tail (initial push) — already counted
            self._seen_seq[who] = seq
            key = (str(e.get("channel", "cluster")), str(e.get("prio", "info")))
            self.counts[key] = self.counts.get(key, 0) + 1
            self.recent.append(e)

    # -- tick ------------------------------------------------------------------

    async def tick(self) -> None:
        if not self._wired:
            self._wire()
            # subscribe() registers "log" in the want-set even if this
            # send is lost; the beacon loop's resubscribe() self-heals
            await self.mgr.monc.subscribe("log")
        try:
            rv, _, out = await self.mgr.mon_command(
                {"prefix": "health history", "num": 0}, timeout=2.0
            )
            if rv != 0:
                raise RuntimeError(f"rv={rv}")
            body = json.loads(out)
        except Exception as e:
            self._poll_errors += 1
            dout("mgr", 10, f"clog: health history poll failed: {e!r}")
            return
        self.events_total = max(
            self.events_total, int(body.get("events_total", 0))
        )
        self.muted = dict(body.get("mutes") or {})

    # -- surfacing -------------------------------------------------------------

    def log_last(
        self, n: int = 20, channel: str = "", severity: str = ""
    ) -> list[dict]:
        """The dashboard's /api/log slice: newest-last, same exact-match
        channel/severity filters the mon's `log last` applies."""
        out = [
            e
            for e in self.recent
            if (not channel or e.get("channel") == channel)
            and (not severity or e.get("prio") == severity)
        ]
        return out[-max(n, 0):]

    def clog_digest(self) -> dict:
        return {
            "counts": {
                f"{ch}.{prio}": n for (ch, prio), n in sorted(self.counts.items())
            },
            "events_total": self.events_total,
            "muted": sorted(self.muted),
        }

    def prometheus_metrics(self) -> list[tuple[str, str, str, list[str]]]:
        msg_rows = [
            f'ceph_tpu_clog_messages_total{{channel="{ch}",severity="{prio}"}} {n}'
            for (ch, prio), n in sorted(
                self.counts.items(),
                key=lambda kv: (kv[0][0], severity_rank(kv[0][1])),
            )
        ]
        muted_rows = [
            f'ceph_tpu_health_muted{{code="{code}"}} 1'
            for code in sorted(self.muted)
        ]
        return [
            ("ceph_tpu_clog_messages_total", "counter",
             "committed cluster-log entries by channel and severity",
             msg_rows),
            ("ceph_tpu_health_events_total", "counter",
             "health-check transitions recorded in the mon event history",
             [f"ceph_tpu_health_events_total {self.events_total}"]),
            ("ceph_tpu_health_muted", "gauge",
             "currently muted health checks (1 = muted; absent otherwise)",
             muted_rows),
        ]
