"""Byte/count throttles — mirror of src/common/Throttle.{h,cc}.

The port's copy of `ceph_tpu/common/throttle.py`.

Reference: the messenger's per-connection dispatch throttles
(`ms_dispatch_throttle_bytes`, policy throttles at
src/ceph_osd.cc:590-594) block producers once in-flight
bytes/messages exceed a limit and wake them as credit is returned.
Both a threading variant (for the sharded op path) and an asyncio variant
(for the messenger) are provided.
"""

from __future__ import annotations

import asyncio
import threading

from .lockdep import make_async_lock, make_lock


class Throttle:
    """Blocking counting throttle (Throttle.h)."""

    def __init__(self, name: str, limit: int):
        self.name = name
        self._limit = limit
        self._count = 0
        self._cond = threading.Condition(make_lock(f"throttle.{name}"))

    @property
    def current(self) -> int:
        with self._cond:
            return self._count

    @property
    def limit(self) -> int:
        with self._cond:
            return self._limit

    @limit.setter
    def limit(self, value: int) -> None:
        """Runtime-mutable bound (Throttle::reset_max): raising it wakes
        blocked producers; 0 disables the throttle."""
        with self._cond:
            self._limit = int(value)
            self._cond.notify_all()

    def take(self, amount: int = 1) -> None:
        """Unconditionally take credit, even past the limit — the
        reference's Throttle::take for work that must be admitted
        (oversized requests once nothing older remains)."""
        with self._cond:
            self._count += amount

    def get(self, amount: int = 1) -> None:
        """Take credit, blocking while over limit (Throttle::get).

        An amount larger than the limit is admitted once current usage
        drains to zero (the reference's _should_wait lets oversized
        requests through rather than wedging the dispatch path).
        """
        with self._cond:
            while (
                self._limit > 0
                and self._count > 0
                and self._count + amount > self._limit
            ):
                self._cond.wait()
            self._count += amount

    def get_or_fail(self, amount: int = 1) -> bool:
        with self._cond:
            if self._limit > 0 and self._count + amount > self._limit:
                return False
            self._count += amount
            return True

    def put(self, amount: int = 1) -> None:
        with self._cond:
            self._count -= amount
            self._cond.notify_all()


class AsyncThrottle:
    """asyncio counterpart used by the async messenger."""

    def __init__(self, name: str, limit: int):
        self.name = name
        self._limit = limit
        self._count = 0
        self._cond: asyncio.Condition | None = None

    def _condition(self) -> asyncio.Condition:
        if self._cond is None:
            # lockdep-instrumented inner lock (asyncio.Condition duck-
            # types over acquire/release/locked): the dispatch-throttle
            # lock sits on the message-delivery path and must
            # participate in lock-order validation like every other
            self._cond = asyncio.Condition(
                make_async_lock(f"async_throttle.{self.name}")
            )
        return self._cond

    @property
    def current(self) -> int:
        return self._count

    async def get(self, amount: int = 1) -> None:
        cond = self._condition()
        async with cond:
            while (
                self._limit > 0
                and self._count > 0
                and self._count + amount > self._limit
            ):
                await cond.wait()
            self._count += amount

    async def put(self, amount: int = 1) -> None:
        cond = self._condition()
        async with cond:
            self._count -= amount
            cond.notify_all()
