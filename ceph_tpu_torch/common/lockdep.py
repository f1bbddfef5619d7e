"""Lock-order validation — mirror of src/common/lockdep.{h,cc}.

The port's copy of `ceph_tpu/common/lockdep.py`, with its own registry:
the port's locks are validated against each other, under the same
`CEPH_TPU_LOCKDEP` switch.

The reference's lockdep (enabled in debug builds, CMakeLists.txt's
-DCEPH_DEBUG_MUTEX tier backing its tsan/helgrind strategy) records the
ORDER in which named mutexes are acquired and fails loudly when two
locks are ever taken in both orders — the invariant whose violation is a
latent deadlock, caught even if the interleaving that would actually
deadlock never runs.

This module keeps that design for BOTH concurrency models the framework
uses: `threading.Lock` (codec plan caches, native bindings) and
`asyncio.Lock` (daemon big locks).  Ownership context is the current
thread for the former and the current asyncio task for the latter —
coroutines interleave at awaits exactly like threads at preemption
points, so holding lock A across an await and then taking B builds the
same A→B ordering edge.

Enable with CEPH_TPU_LOCKDEP=1 (or lockdep.enable()); disabled, the
factory hands out plain locks with zero overhead — the reference gates
identically on its debug flag.  Self-deadlock (re-acquiring a held
non-reentrant lock) is also reported, like lockdep.cc's recursive check.
"""

from __future__ import annotations

import asyncio
import os
import threading
import weakref


class LockOrderError(AssertionError):
    """Two locks were acquired in both orders (latent deadlock)."""


class _Registry:
    def __init__(self) -> None:
        self._graph: dict[str, set[str]] = {}  # edge a -> b: b taken under a
        self._mutex = threading.Lock()
        self._violations = 0  # LockOrderErrors raised (lifetime)

    def clear(self) -> None:
        with self._mutex:
            self._graph.clear()

    def edges(self) -> dict[str, set[str]]:
        with self._mutex:
            return {k: set(v) for k, v in self._graph.items()}

    def violations(self) -> int:
        with self._mutex:
            return self._violations

    def _violation(self, msg: str) -> LockOrderError:
        # counted so harnesses (tools/chaos.py) can assert ZERO even when
        # a daemon task swallowed the raise with the rest of its failure
        self._violations += 1
        return LockOrderError(msg)

    def check_acquire(self, held: list[str], name: str) -> None:
        """Pre-acquire validation: raises on self-deadlock or an ordering
        cycle.  Records NOTHING — edges are committed by record_acquire
        only once the lock is actually taken, so a failed or abandoned
        acquire cannot pollute the graph."""
        if not held:
            return
        if name in held:
            with self._mutex:
                raise self._violation(
                    f"lockdep: re-acquiring held lock {name!r} "
                    "(self-deadlock)"
                )
        with self._mutex:
            for h in held:
                # would edge h -> name close a cycle? (name ~> h exists)
                if self._reaches(name, h):
                    raise self._violation(
                        f"lockdep: acquiring {name!r} while holding {h!r}, "
                        f"but {h!r} has been taken under {name!r} before — "
                        f"lock-order cycle (latent deadlock)"
                    )

    def record_acquire(self, held: list[str], name: str) -> None:
        if not held:
            return
        with self._mutex:
            for h in held:
                self._graph.setdefault(h, set()).add(name)

    def _reaches(self, src: str, dst: str) -> bool:
        seen = set()
        stack = [src]
        while stack:
            node = stack.pop()
            if node == dst:
                return True
            if node in seen:
                continue
            seen.add(node)
            stack.extend(self._graph.get(node, ()))
        return False


_REGISTRY = _Registry()
_enabled = os.environ.get("CEPH_TPU_LOCKDEP", "") not in ("", "0")

# held-lock stacks per ownership context
_thread_held = threading.local()


def enable() -> None:
    global _enabled
    _enabled = True


def disable() -> None:
    global _enabled
    _enabled = False


def enabled() -> bool:
    return _enabled


def clear() -> None:
    _REGISTRY.clear()


def edges() -> dict[str, set[str]]:
    """Observed ordering graph (lockdep's dependency dump)."""
    return _REGISTRY.edges()


def violations() -> int:
    """LockOrderErrors raised so far (process lifetime).  Harnesses
    snapshot this at run start and assert a zero delta — a violation
    that a daemon task swallowed with the rest of its failure still
    counts."""
    return _REGISTRY.violations()


def graph_dump() -> dict[str, list[str]]:
    """JSON-ready ordering graph: lock name -> sorted locks ever taken
    under it (the chaos report's `lockdep_graph` payload)."""
    return {k: sorted(v) for k, v in sorted(_REGISTRY.edges().items())}


def _thread_stack() -> list[str]:
    if not hasattr(_thread_held, "stack"):
        _thread_held.stack = []
    return _thread_held.stack


# task object -> held-lock names; weak keys mean a task that dies while
# holding a lock cannot leak its stack or bequeath it to an unrelated
# task at a recycled address (id() reuse)
_task_held: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def _task_stack() -> list[str]:
    task = asyncio.current_task()
    stack = _task_held.get(task)
    if stack is None:
        stack = _task_held[task] = []
    return stack


class DebugLock:
    """threading.Lock with ordering validation (ceph::mutex in debug).
    Validation keys off the GLOBAL enabled flag at acquire time, so a
    lock created before lockdep.enable() still instruments afterward
    (module-level singletons included)."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._owner_stack: list[str] | None = None

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _enabled:
            return self._lock.acquire(blocking, timeout)
        stack = _thread_stack()
        if blocking:
            # validate BEFORE blocking: catch the latent deadlock instead
            # of entering it
            _REGISTRY.check_acquire(stack, self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            # a successful TRYLOCK records ordering but must not raise —
            # trylocks cannot deadlock (lockdep.cc's try variant)
            _REGISTRY.record_acquire(stack, self.name)
            stack.append(self.name)
            self._owner_stack = stack
        return got

    def release(self) -> None:
        stack = self._owner_stack
        if stack is not None and self.name in stack:
            stack.remove(self.name)
        self._owner_stack = None
        self._lock.release()

    def __enter__(self) -> "DebugLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class DebugRLock:
    """threading.RLock with ordering validation.  Reentrancy is
    per-INSTANCE (like RLock itself): a nested acquire of the same
    object neither re-validates nor re-pushes the held-stack entry, so
    the reap-inside-reap patterns the aggregators rely on stay legal
    while cross-lock ordering is still checked on the outermost
    acquire."""

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.RLock()
        self._local = threading.local()  # per-thread depth on THIS object

    def _depth(self) -> int:
        return getattr(self._local, "depth", 0)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        if not _enabled:
            got = self._lock.acquire(blocking, timeout)
            if got:
                self._local.depth = self._depth() + 1
            return got
        depth = self._depth()
        if depth:  # reentrant: already validated at the outermost acquire
            got = self._lock.acquire(blocking, timeout)
            if got:
                self._local.depth = depth + 1
            return got
        stack = _thread_stack()
        if blocking:
            _REGISTRY.check_acquire(stack, self.name)
        got = self._lock.acquire(blocking, timeout)
        if got:
            _REGISTRY.record_acquire(stack, self.name)
            stack.append(self.name)
            self._local.depth = 1
        return got

    def release(self) -> None:
        depth = self._depth()
        if depth:
            self._local.depth = depth - 1
            if depth == 1:
                stack = _thread_stack()
                if self.name in stack:
                    stack.remove(self.name)
        self._lock.release()

    def __enter__(self) -> "DebugRLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class DebugAsyncLock:
    """asyncio.Lock with ordering validation; held-set is per-task.
    Cross-task release (the asyncio.Lock handoff pattern) is supported:
    release edits the ACQUIRER's stack, not the releasing task's."""

    def __init__(self, name: str):
        self.name = name
        self._lock = asyncio.Lock()
        self._owner_stack: list[str] | None = None

    async def acquire(self) -> bool:
        if not _enabled:
            await self._lock.acquire()
            return True
        stack = _task_stack()
        _REGISTRY.check_acquire(stack, self.name)
        await self._lock.acquire()
        _REGISTRY.record_acquire(stack, self.name)
        stack.append(self.name)
        self._owner_stack = stack
        return True

    def release(self) -> None:
        stack = self._owner_stack
        if stack is not None and self.name in stack:
            stack.remove(self.name)
        self._owner_stack = None
        self._lock.release()

    def locked(self) -> bool:
        return self._lock.locked()

    async def __aenter__(self) -> "DebugAsyncLock":
        await self.acquire()
        return self

    async def __aexit__(self, *exc) -> None:
        self.release()


def make_lock(name: str) -> DebugLock:
    """Factory the framework's subsystems use.  Always returns the
    instrumentable wrapper: enablement is checked per-acquire (one global
    read when off), so module-level singleton locks created at import
    time still participate when lockdep.enable() runs later."""
    return DebugLock(name)


def make_rlock(name: str) -> DebugRLock:
    """Reentrant variant for subsystems whose hold patterns re-enter
    (aggregator reap-forced launches, the config proxy)."""
    return DebugRLock(name)


def make_async_lock(name: str) -> DebugAsyncLock:
    return DebugAsyncLock(name)
