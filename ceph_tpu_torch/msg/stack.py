"""Pluggable network stacks — mirror of the reference's NetworkStack
family (src/msg/async/Stack.h; PosixStack.h, rdma/, dpdk/ selected by
`ms_type`).

The messenger talks to a `NetworkStack` for exactly two things: dial a
peer and listen for peers.  Two stacks ship:

- `posix` — asyncio TCP, the default (PosixStack analog).
- `inproc` — zero-copy in-process pipes between messengers sharing an
  interpreter.  This is the kernel-bypass member of the family: where
  the reference's dpdk/rdma stacks skip the kernel between HOSTS, this
  one skips the kernel for the many-daemons-one-process topology the
  framework actually runs (vstart dev clusters, the standalone test
  tier, and the daemons of one accelerator host), moving frames by reference
  through asyncio StreamReader buffers instead of loopback TCP.

Stacks preserve asyncio's (reader, writer) stream contract, so the
protocol layer (frames, auth, secure/compressed on-wire sessions) is
byte-identical over every stack — the same invariant the reference
keeps by running Protocol V2 unchanged over posix/rdma/dpdk.
"""

from __future__ import annotations

import asyncio
import itertools


class NetworkStack:
    """connect/listen boundary (Stack.h NetworkStack)."""

    async def connect(self, addr: str):
        """-> (StreamReader, StreamWriter-like) for a dialed peer."""
        raise NotImplementedError

    async def listen(self, addr: str, client_cb) -> tuple[object, str]:
        """Start accepting; `client_cb(reader, writer)` per peer.
        -> (server-like with close()/wait_closed(), bound address)."""
        raise NotImplementedError


def _split(addr: str) -> tuple[str, int]:
    host, _, port = addr.rpartition(":")
    return host or "127.0.0.1", int(port)


class PosixStack(NetworkStack):
    """asyncio TCP (PosixStack.h)."""

    async def connect(self, addr: str):
        return await asyncio.open_connection(*_split(addr))

    async def listen(self, addr: str, client_cb):
        host, port = _split(addr)
        server = await asyncio.start_server(client_cb, host, port)
        actual = server.sockets[0].getsockname()[1]
        return server, f"{host}:{actual}"


class _PipeReader(asyncio.StreamReader):
    """StreamReader that publishes its own buffered-byte count and signals
    consumption, so the writing side gets real backpressure without
    poking at StreamReader privates."""

    def __init__(self):
        super().__init__()
        self.pending = 0  # bytes fed minus bytes consumed
        self.drained = asyncio.Event()

    def feed_data(self, data) -> None:
        self.pending += len(data)
        super().feed_data(data)

    def _note_consumed(self, data) -> None:
        self.pending -= len(data)
        self.drained.set()

    async def read(self, n: int = -1):
        data = await super().read(n)
        self._note_consumed(data)
        return data

    async def readexactly(self, n: int):
        data = await super().readexactly(n)
        self._note_consumed(data)
        return data

    # NOTE: no readline override — StreamReader.readline delegates to
    # self.readuntil, so overriding both would double-count consumption.

    async def readuntil(self, separator: bytes = b"\n"):
        data = await super().readuntil(separator)
        self._note_consumed(data)
        return data


class _PipeWriter:
    """StreamWriter contract over a peer's _PipeReader buffer."""

    HIGH_WATER = 4 << 20  # drain() backpressure threshold (bytes buffered)
    DRAIN_DEADLINE = 10.0  # max seconds stuck above high-water before fault

    def __init__(self, peer_reader: _PipeReader):
        self._peer = peer_reader
        self._closed = False

    def write(self, data: bytes) -> None:
        if not self._closed:
            # by-reference when already immutable; copy only mutable views
            self._peer.feed_data(
                data if isinstance(data, bytes) else bytes(data)
            )

    async def drain(self) -> None:
        # Backpressure analog of TCP's: park until the peer has consumed
        # down to the high-water mark, so a fast sender can't grow the
        # peer's buffer without bound.  A peer that is alive but wedged
        # (not reading, not faulting) must not livelock senders forever:
        # after DRAIN_DEADLINE above high-water the connection faults,
        # matching the 10 s bounds on the TCP handshake paths.
        deadline = asyncio.get_event_loop().time() + self.DRAIN_DEADLINE
        while not self._closed and self._peer.pending > self.HIGH_WATER:
            if asyncio.get_event_loop().time() >= deadline:
                self.close()
                raise ConnectionResetError(
                    "in-process peer stalled above high-water for "
                    f"{self.DRAIN_DEADLINE}s"
                )
            self._peer.drained.clear()
            try:
                await asyncio.wait_for(self._peer.drained.wait(), 0.1)
            except asyncio.TimeoutError:
                pass

    def close(self) -> None:
        if not self._closed:
            self._closed = True
            self._peer.feed_eof()

    def is_closing(self) -> bool:
        return self._closed


def _pipe_pair():
    """Two cross-connected (reader, writer) stream pairs."""
    a_reads = _PipeReader()
    b_reads = _PipeReader()
    return (a_reads, _PipeWriter(b_reads)), (b_reads, _PipeWriter(a_reads))


class _InProcListener:
    def __init__(self, stack: "InProcStack", addr: str):
        self._stack = stack
        self._addr = addr
        self._handlers: set[asyncio.Task] = set()

    def _spawn(self, client_cb, reader, writer) -> None:
        task = asyncio.get_event_loop().create_task(client_cb(reader, writer))
        self._handlers.add(task)
        task.add_done_callback(self._handlers.discard)

    def close(self) -> None:
        self._stack._listeners.pop(self._addr, None)
        for t in list(self._handlers):
            t.cancel()

    async def wait_closed(self) -> None:
        await asyncio.gather(*self._handlers, return_exceptions=True)


class InProcStack(NetworkStack):
    """In-process pipes with a process-wide listener registry.  Addresses
    are plain strings ("inproc:N" auto-assigned on bind, or any explicit
    string), carried through monmaps/OSDMaps like host:port addrs.
    Registry entries remember their event loop: a listener whose loop is
    gone (a test that died before shutdown) is stale — it is dropped
    rather than poisoning later binds/connects in the same process."""

    _listeners: dict[str, tuple[_InProcListener, object, object]] = {}
    _ports = itertools.count(1)

    @classmethod
    def _prune_stale(cls, addr: str):
        """Entry at addr, dropping it first if its loop died without
        shutdown (a failed test) — stale entries must not poison later
        binds/connects in the same process."""
        entry = cls._listeners.get(addr)
        if entry is not None and entry[2].is_closed():
            cls._listeners.pop(addr, None)
            return None
        return entry

    async def connect(self, addr: str):
        entry = self._prune_stale(addr)
        # A live listener on a FOREIGN loop is refused without touching
        # the registry: cross-loop pipes would race two schedulers.
        if entry is None or entry[2] is not asyncio.get_event_loop():
            raise ConnectionRefusedError(f"no inproc listener at {addr}")
        listener, client_cb, _loop = entry
        (c_reader, c_writer), (s_reader, s_writer) = _pipe_pair()
        listener._spawn(client_cb, s_reader, s_writer)
        return c_reader, c_writer

    async def listen(self, addr: str, client_cb):
        if not addr or addr.endswith(":0"):
            addr = f"inproc:{next(self._ports)}"
        if self._prune_stale(addr) is not None:
            raise OSError(f"inproc address {addr} in use")
        listener = _InProcListener(self, addr)
        self._listeners[addr] = (listener, client_cb, asyncio.get_event_loop())
        return listener, addr


STACKS = {"posix": PosixStack, "inproc": InProcStack}

# ms_type spellings (the reference's "async+posix" etc., ceph_osd.cc:541)
_ALIASES = {"async+posix": "posix", "async+inproc": "inproc"}


def make_stack(kind: str | NetworkStack) -> NetworkStack:
    """ms_type -> stack instance (Stack.cc NetworkStack::create)."""
    if isinstance(kind, NetworkStack):
        return kind
    kind = _ALIASES.get(kind, kind)
    cls = STACKS.get(kind)
    if cls is None:
        raise ValueError(f"unknown ms_type {kind!r} (have {sorted(STACKS)})")
    return cls()
