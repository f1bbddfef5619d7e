"""Leveled subsystem logging — mirror of src/log + dout.

The port's copy of `ceph_tpu/common/log.py`, without `LogClient.from_config`
(the port has no daemon Config yet): the mempool's pressure stages log
through `dout`.

Reference: src/log/Log.h:32 (async log thread draining a
queue, in-memory ring of recent entries for crash dump),
src/log/SubsystemMap.h (per-subsystem log/gather levels 0-30), and the
`dout(n)` macro family (src/common/dout.h): a statement is *gathered* when
level <= gather_level (kept in the ring) and *emitted* when
level <= log_level.
"""

from __future__ import annotations

import collections
import os
import sys
import threading
import time
from dataclasses import dataclass

from .lockdep import make_lock


@dataclass
class LogEntry:
    stamp: float
    thread: int
    subsys: str
    level: int
    msg: str

    def format(self) -> str:
        ts = time.strftime("%Y-%m-%dT%H:%M:%S", time.localtime(self.stamp))
        frac = int((self.stamp % 1) * 1e6)
        return f"{ts}.{frac:06d} {self.thread:#x} {self.level:2d} {self.subsys}: {self.msg}"


class SubsystemMap:
    """Per-subsystem (log_level, gather_level) — SubsystemMap.h."""

    DEFAULT = (1, 5)

    def __init__(self) -> None:
        self._levels: dict[str, tuple[int, int]] = {}

    def set_log_level(self, subsys: str, log: int, gather: int | None = None) -> None:
        self._levels[subsys] = (log, gather if gather is not None else max(log, 5))

    def levels(self, subsys: str) -> tuple[int, int]:
        return self._levels.get(subsys, self.DEFAULT)

    def should_gather(self, subsys: str, level: int) -> bool:
        log, gather = self.levels(subsys)
        return level <= max(log, gather)


class Log:
    """Async log sink with a bounded recent-entry ring (Log.h:32).

    Entries are queued by producers and drained by a background thread;
    `dump_recent()` returns the ring (the crash-dump path the reference
    writes on assert failure).
    """

    def __init__(self, path: str = "", max_recent: int = 500):
        self._path = path
        self._queue: collections.deque[LogEntry] = collections.deque()
        self._recent: collections.deque[LogEntry] = collections.deque(maxlen=max_recent)
        self._cond = threading.Condition(make_lock("log_sink"))
        self._stop = False
        self._file = None
        if path:
            self._file = open(path, "a", buffering=1)
        self._thread = threading.Thread(target=self._drain, name="log", daemon=True)
        self._thread.start()

    def submit(self, entry: LogEntry, emit: bool) -> None:
        with self._cond:
            self._recent.append(entry)
            if emit:
                self._queue.append(entry)
                self._cond.notify()

    def _drain(self) -> None:
        while True:
            with self._cond:
                while not self._queue and not self._stop:
                    self._cond.wait(timeout=0.5)
                if self._stop and not self._queue:
                    return
                batch = list(self._queue)
                self._queue.clear()
            out = self._file if self._file is not None else sys.stderr
            for e in batch:
                print(e.format(), file=out)

    def flush(self) -> None:
        with self._cond:
            batch = list(self._queue)
            self._queue.clear()
        out = self._file if self._file is not None else sys.stderr
        for e in batch:
            print(e.format(), file=out)

    def dump_recent(self) -> list[str]:
        with self._cond:
            return [e.format() for e in self._recent]

    def stop(self) -> None:
        with self._cond:
            self._stop = True
            self._cond.notify()
        self._thread.join(timeout=2)
        if self._thread.is_alive():
            # Drain thread is wedged on a slow sink; leave the file open so
            # its in-progress writes don't hit a closed handle.
            return
        if self._file is not None:
            self._file.close()
            self._file = None


class LogClient:
    """The `dout` front end bound to a SubsystemMap + Log sink."""

    def __init__(self, log: Log | None = None, subsys_map: SubsystemMap | None = None):
        self.log = log or Log()
        self.subsys = subsys_map or SubsystemMap()

    def dout(self, subsys: str, level: int, msg: str) -> None:
        log_lvl, gather = self.subsys.levels(subsys)
        emit = level <= log_lvl
        if not emit and level > gather:
            return
        self.log.submit(
            LogEntry(time.time(), threading.get_ident(), subsys, level, msg),
            emit,
        )

    def derr(self, subsys: str, msg: str) -> None:
        self.dout(subsys, 0, msg)


# Process-wide default client (the reference's g_ceph_context->_log).
_default: LogClient | None = None
_default_lock = make_lock("log_default")


def default_client() -> LogClient:
    global _default
    with _default_lock:
        if _default is None:
            _default = LogClient()
            if os.environ.get("CEPH_TPU_DEBUG"):
                for sub in ("osd", "mon", "ms", "ec", "objecter", "paxos"):
                    _default.subsys.set_log_level(sub, 20, 20)
        return _default


def dout(subsys: str, level: int, msg: str) -> None:
    default_client().dout(subsys, level, msg)
