"""Cluster-log client — mirror of src/common/LogClient.{h,cc}.

Every daemon owns a `ClusterLogClient`: structured entries (channel,
severity, entity, per-client seq, optional health code) are batched and
shipped to the monitors' LogMonitor, which commits them through Paxos so
the whole quorum holds one bounded, ordered cluster timeline.

Client-side behaviors mirrored from the reference:

- **Batching** (LogClient::get_mon_log_message): entries accumulate in a
  pending queue and flush as one MLog either when the batch fills or
  after a short linger, so a burst costs one message, not N.
- **Repeat dedup** (LogChannel's "last message repeated N times"):
  consecutive identical (channel, prio, msg) entries collapse into the
  original plus one summary entry when the run breaks or flushes.
- **Rate limiting**: a token bucket caps sustained entries/sec per
  client; drops are counted (`dropped`) and surfaced as a final
  "N cluster log entries dropped (rate limited)" marker so the log
  never silently loses mass without saying so.

The `send` callable is async (MonClient.send_log); daemons pass their
monc's bound method.  Everything is best-effort — a lost entry is
re-emitted by the next transition, so there is no retry queue.
"""

from __future__ import annotations

import asyncio
import time
from typing import Awaitable, Callable

# severity names, least to most severe (LogEntry's clog_type)
SEVERITIES = ("debug", "info", "warn", "error")
CHANNELS = ("cluster", "audit")

# batching: flush when this many entries are pending, or after the
# linger elapses — whichever comes first (mon_client_log_interval's
# spirit, scaled to this port's sub-second test clusters)
BATCH_MAX = 32
BATCH_LINGER_SEC = 0.05

# token-bucket rate limiter: sustained entries/sec + burst headroom.
# Generous — the limiter exists to survive a looping daemon, not to
# shave healthy traffic.
RATE_PER_SEC = 50.0
RATE_BURST = 100.0


def severity_rank(prio: str) -> int:
    """Index into SEVERITIES; unknown strings rank as info."""
    try:
        return SEVERITIES.index(prio)
    except ValueError:
        return 1


class ClusterLogClient:
    def __init__(
        self,
        name: str,
        send: Callable[[list[dict]], Awaitable[None]] | None = None,
    ):
        self.name = name
        self._send = send
        self._pending: list[dict] = []
        self._flush_handle: asyncio.TimerHandle | None = None
        self._seq = 0
        # repeat-dedup state: the last entry key and how many times it
        # repeated beyond the first emission
        self._last_key: tuple[str, str, str] | None = None
        self._repeats = 0
        # token bucket
        self._tokens = RATE_BURST
        self._tokens_at = time.monotonic()
        self.dropped = 0
        self._dropped_noted = 0
        # (channel, severity) -> emitted count, for perf/scrape surfaces
        self.counts: dict[tuple[str, str], int] = {}

    # -- public API ------------------------------------------------------------

    def log(
        self,
        prio: str,
        message: str,
        channel: str = "cluster",
        code: str | None = None,
    ) -> None:
        """Queue one structured entry (LogChannel::do_log)."""
        if prio not in SEVERITIES:
            prio = "info"
        if channel not in CHANNELS:
            channel = "cluster"
        key = (channel, prio, message)
        if key == self._last_key:
            # consecutive identical entry: collapse into a repeat count
            self._repeats += 1
            return
        self._break_repeat_run()
        self._last_key = key
        if not self._take_token():
            self.dropped += 1
            return
        self._queue_entry(prio, channel, message, code)

    def debug(self, message: str, **kw) -> None:
        self.log("debug", message, **kw)

    def info(self, message: str, **kw) -> None:
        self.log("info", message, **kw)

    def warn(self, message: str, **kw) -> None:
        self.log("warn", message, **kw)

    def error(self, message: str, **kw) -> None:
        self.log("error", message, **kw)

    def audit(self, message: str, code: str | None = None) -> None:
        """Audit-channel entry: every mutating admin command lands here
        (the reference's `audit` LogChannel fed by the mon's forward of
        each command — here each daemon audits its own admin surface)."""
        self.log("info", message, channel="audit", code=code)

    async def flush(self) -> None:
        """Force-ship everything pending (LogClient::queue drain); used
        by tests and shutdown paths."""
        self._break_repeat_run()
        await self._flush_now()

    # -- internals -------------------------------------------------------------

    def _queue_entry(
        self, prio: str, channel: str, message: str, code: str | None
    ) -> None:
        self._seq += 1
        entry = {
            "prio": prio,
            "channel": channel,
            "who": self.name,
            "seq": self._seq,
            "stamp": time.time(),
            "msg": message,
        }
        if code is not None:
            entry["code"] = code
        self._pending.append(entry)
        k = (channel, prio)
        self.counts[k] = self.counts.get(k, 0) + 1
        self._schedule_flush()

    def _break_repeat_run(self) -> None:
        """Emit the 'last message repeated N times' summary closing a
        run of consecutive identical entries."""
        if self._repeats and self._last_key is not None:
            channel, prio, _msg = self._last_key
            n = self._repeats
            self._repeats = 0
            if self._take_token():
                self._queue_entry(
                    prio, channel, f"last message repeated {n} times", None
                )
            else:
                self.dropped += 1
        else:
            self._repeats = 0

    def _take_token(self) -> bool:
        now = time.monotonic()
        self._tokens = min(
            RATE_BURST, self._tokens + (now - self._tokens_at) * RATE_PER_SEC
        )
        self._tokens_at = now
        if self._tokens < 1.0:
            return False
        self._tokens -= 1.0
        return True

    def _schedule_flush(self) -> None:
        if len(self._pending) >= BATCH_MAX:
            self._kick_flush()
            return
        if self._flush_handle is None:
            try:
                loop = asyncio.get_event_loop()
            except RuntimeError:
                return  # no loop (sync tool context): flush() ships later
            self._flush_handle = loop.call_later(
                BATCH_LINGER_SEC, self._kick_flush
            )

    def _kick_flush(self) -> None:
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        try:
            asyncio.get_event_loop().create_task(self._flush_now())
        except RuntimeError:
            pass

    async def _flush_now(self) -> None:
        if self._flush_handle is not None:
            self._flush_handle.cancel()
            self._flush_handle = None
        if self.dropped > self._dropped_noted:
            n = self.dropped - self._dropped_noted
            self._dropped_noted = self.dropped
            self._seq += 1
            self._pending.append(
                {
                    "prio": "warn",
                    "channel": "cluster",
                    "who": self.name,
                    "seq": self._seq,
                    "stamp": time.time(),
                    "msg": f"{n} cluster log entries dropped (rate limited)",
                }
            )
        if not self._pending or self._send is None:
            return
        batch, self._pending = self._pending, []
        await self._send(batch)

    def perf_dump(self) -> dict:
        """Counters for the daemon perf/scrape surface."""
        return {
            "clog_messages": {
                f"{ch}.{prio}": n for (ch, prio), n in sorted(self.counts.items())
            },
            "clog_dropped": self.dropped,
        }
