"""Runtime configuration — mirror of md_config_t / ConfigProxy.

The port of `ceph_tpu/common/config.py`, over the port's option table
(`options.py`).  Reference: src/common/config.h (md_config_t holds parsed
values layered defaults < conf file < env < cli < runtime-set) and
src/common/config_obs.h (md_config_obs_t observers notified when a
runtime-mutable key changes — e.g. mClockScheduler re-reads its QoS knobs,
src/osd/scheduler/mClockScheduler.h:72).  The mon-central config DB
(ConfigMonitor) pushes runtime `set`s through the same path.
"""

from __future__ import annotations

import os
import threading
from typing import Callable, Iterable

from .lockdep import make_rlock
from .options import OPTIONS, Option

ConfigObserver = Callable[[str, object], None]


class Config:
    """Layered typed config with change observers."""

    def __init__(
        self,
        overrides: dict[str, object] | None = None,
        conf_file: str | None = None,
        env: bool = True,
    ):
        self._lock = make_rlock("config")
        self._values: dict[str, object] = {
            name: opt.default for name, opt in OPTIONS.items()
        }
        self._observers: dict[str, list[ConfigObserver]] = {}
        if conf_file:
            self._apply_conf_file(conf_file)
        if env:
            # CEPH_TPU_<UPPER_NAME>=value overrides, like the CEPH_ARGS /
            # env override path in the reference.
            for name in OPTIONS:
                v = os.environ.get(f"CEPH_TPU_{name.upper()}")
                if v is not None:
                    self._set_locked(name, v)
        for k, v in (overrides or {}).items():
            self._set_locked(k, v)

    # -- reads ---------------------------------------------------------------

    def get(self, name: str):
        with self._lock:
            if name not in self._values:
                raise KeyError(f"unknown option {name}")
            return self._values[name]

    def __getitem__(self, name: str):
        return self.get(name)

    def get_option(self, name: str) -> Option:
        return OPTIONS[name]

    def show(self) -> dict[str, object]:
        """`config show` admin-socket command payload."""
        with self._lock:
            return dict(self._values)

    def diff(self) -> dict[str, object]:
        """`config diff`: only values that differ from defaults."""
        with self._lock:
            return {
                k: v
                for k, v in self._values.items()
                if v != OPTIONS[k].default
            }

    # -- writes --------------------------------------------------------------

    def set(self, name: str, value: object) -> None:
        """Runtime set; notifies observers (md_config_t::set_val +
        apply_changes)."""
        with self._lock:
            parsed = self._set_locked(name, value)
            observers = list(self._observers.get(name, ()))
        for obs in observers:
            obs(name, parsed)

    def _set_locked(self, name: str, value: object):
        opt = OPTIONS.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name}")
        parsed = opt.parse(value)
        self._values[name] = parsed
        return parsed

    def _apply_conf_file(self, path: str) -> None:
        """Minimal ini-ish `key = value` file, comments with #."""
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith(("#", ";", "[")):
                    continue
                key, _, val = line.partition("=")
                key = key.strip().replace(" ", "_")
                if key in OPTIONS:
                    self._set_locked(key, val.strip())

    # -- observers -----------------------------------------------------------

    def add_observer(self, names: Iterable[str], fn: ConfigObserver) -> None:
        """Register for change notifications on runtime-mutable keys
        (md_config_obs_t::get_tracked_conf_keys +
        handle_conf_change)."""
        with self._lock:
            for name in names:
                if name not in OPTIONS:
                    raise KeyError(f"unknown option {name}")
                self._observers.setdefault(name, []).append(fn)

    # -- subsystem debug levels ----------------------------------------------

    def debug_levels(self, subsys: str) -> tuple[int, int]:
        """Parse a debug_<subsys> "log/gather" pair (SubsystemMap levels)."""
        raw = str(self.get(f"debug_{subsys}"))
        log_s, _, gather_s = raw.partition("/")
        log = int(log_s)
        gather = int(gather_s) if gather_s else log
        return log, gather
