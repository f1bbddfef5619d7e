"""AsyncMessenger — mirror of src/msg/async/AsyncMessenger.{h,cc}.

Reference behaviors mirrored (SURVEY.md §2.5):
- `Messenger::create` + bind/listen/accept with a banner + identity
  exchange (ProtocolV2 hello phase).
- Dispatcher chain with a fast-dispatch path (`ms_fast_dispatch`
  bypasses the queue, src/osd/OSD.cc:7244) and `ms_handle_reset`
  connection-fault callbacks.
- Per-peer-type Policy (lossy vs lossless: lossless connections
  transparently reconnect and re-send queued messages).
- Dispatch throttling (`ms_dispatch_throttle_bytes`) and probabilistic
  fault injection (`ms_inject_socket_failures`,
  global.yaml.in:1240-1271).

Implementation is asyncio on TCP — the event-loop structure of the
reference's epoll workers, minus the manual buffer management that Python
streams already provide.
"""

from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass

from ..common import tracer as tracer_mod
from ..common.fault_injector import (
    InjectedFailure,
    faultpoint,
    faultpoint_delay,
)
from ..common.log import dout
from ..common.throttle import AsyncThrottle
from .crypto import (
    FLAG_COMPRESSED,
    FLAG_SECURE,
    OnWireError,
    OnWireSession,
    read_record,
)
from .frames import (
    Frame,
    TAG_HELLO,
    TAG_KEEPALIVE,
    TAG_MESSAGE,
    frame_from_bytes,
    read_frame,
    FrameError,
)
from .message import Message, decode_message, encode_message


@dataclass
class Policy:
    """Per-peer-type connection policy (src/msg/Policy.h)."""

    lossy: bool = True  # drop state on error (client->osd)
    server: bool = False  # accept-only side
    resend_on_reconnect: bool = False  # lossless peers re-queue unacked sends

    @classmethod
    def lossy_client(cls) -> "Policy":
        return cls(lossy=True)

    @classmethod
    def lossless_peer(cls) -> "Policy":
        return cls(lossy=False, resend_on_reconnect=True)

    @classmethod
    def stateless_server(cls) -> "Policy":
        return cls(lossy=True, server=True)


class Dispatcher:
    """Receiver interface (src/msg/Dispatcher.h)."""

    def ms_can_fast_dispatch(self, msg: Message) -> bool:
        return False

    def ms_fast_dispatch(self, conn: "Connection", msg: Message) -> None:
        raise NotImplementedError

    def ms_dispatch(self, conn: "Connection", msg: Message) -> bool:
        """Return True if handled."""
        return False

    def ms_handle_reset(self, conn: "Connection") -> None:
        pass

    def ms_handle_accept(self, conn: "Connection") -> None:
        pass


# Lossless resend bounds: ~4 s of backoff across 12 attempts covers any
# transient fault, and the wall-clock window caps the worst case — a
# zombie peer whose TCP accepts succeed but whose handshakes burn their
# full timeouts per attempt — so a permanently dead peer surfaces
# ConnectionError instead of pinning the connection's send lock.
_RESEND_TRIES = 12
_RESEND_WINDOW = 15.0  # seconds


class Connection:
    """One peer session (AsyncConnection).  Owns the socket streams, a
    send queue, and (for lossless policies) the unacked resend queue."""

    def __init__(self, msgr: "Messenger", peer_addr: str, policy: Policy):
        self.msgr = msgr
        self.peer_addr = peer_addr
        self.peer_name = ""  # filled by hello exchange
        self.policy = policy
        self.auth_entity = ""  # authenticated peer (cephx server side)
        # negotiated secure/compressed on-wire codec (crypto_onwire);
        # None = legacy raw frames
        self._onwire: OnWireSession | None = None
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        from ..common.lockdep import make_async_lock

        self._send_lock = make_async_lock(f"conn_send:{msgr.name}")
        self._out_seq = 0
        self._closed = False
        self._read_task: asyncio.Task | None = None
        # set when a lossless resend window gave the peer up: sends
        # before this instant fail fast instead of each serially burning
        # a fresh full retry window under the send lock
        self._dead_until = 0.0
        # set when the peer connected to us (`peer_is_up`): a resend
        # waiting out its backoff retries at once
        self._retry_now = asyncio.Event()

    def peer_is_up(self) -> None:
        """The peer has just opened a session to this messenger, so it is
        up: a resend in its backoff goes now, and sends no longer fail
        fast (the port's; a restarted monitor hears the current election
        instead of waiting out the backoff, ROADMAP C21)."""
        self._dead_until = 0.0
        self._retry_now.set()

    @property
    def connected(self) -> bool:
        return self._writer is not None and not self._closed

    # -- lifecycle -----------------------------------------------------------

    async def _attach(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        self._reader = reader
        self._writer = writer
        # the reader is BOUND at attach time: a fault can null
        # self._reader before the task's first step runs, and the task
        # must then exit, not read from None
        self._read_task = asyncio.create_task(self._read_loop(reader))

    async def _connect(self) -> None:
        reader, writer = await self.msgr.stack.connect(self.peer_addr)
        # hello: announce who we are + desired on-wire features
        # (ProtocolV2 hello/ident phase; features negotiate like
        # ProtocolV2's connection modes)
        hello = Frame(
            TAG_HELLO,
            [
                self.msgr.name.encode(),
                self.msgr.addr.encode(),
                bytes([self.msgr._feature_bits()]),
            ],
        )
        writer.write(hello.pack(self.msgr.crc_data))
        await writer.drain()
        try:
            # bounded like the accept side: a peer that accepted the
            # connection but died before replying must not wedge this
            # connection (send_message holds the send lock meanwhile)
            frame = await asyncio.wait_for(read_frame(reader), 10.0)
            if frame.tag != TAG_HELLO:
                raise FrameError(f"expected hello, got tag {frame.tag}")
            self.peer_name = frame.segments[0].decode()
            chosen = (
                frame.segments[2][0]
                if len(frame.segments) > 2 and frame.segments[2]
                else 0
            ) & self.msgr._feature_bits()
            if self.msgr.secure and not chosen & FLAG_SECURE:
                # we REQUIRE encryption (ms_mode=secure); a peer that
                # cannot do it must not get a cleartext session
                raise FrameError("peer does not support required secure mode")
            session_key = b""
            if self.msgr.auth is not None:
                # cephx handshake rides auth frames before the session
                # opens (ProtocolV2 auth phase).  Bounded: an auth-less
                # peer silently ignores auth frames, and an unbounded wait
                # here would wedge the connection's send lock forever.
                _ticket, session_key = await asyncio.wait_for(
                    self.msgr.auth.client_auth(
                        *_frame_io(reader, writer, self.msgr.crc_data),
                        peer=self.peer_addr,
                    ),
                    timeout=5.0,
                )
            # always (re)assign: a lossless reconnect may renegotiate a
            # DIFFERENT feature set than the previous session
            self._onwire = (
                OnWireSession(
                    session_key,
                    secure=bool(chosen & FLAG_SECURE),
                    compress=bool(chosen & FLAG_COMPRESSED),
                    initiator=True,
                )
                if chosen
                else None
            )
        except Exception as e:
            # close the half-open socket and keep send_message's contract:
            # connection failures surface as ConnectionError
            writer.close()
            raise ConnectionError(
                f"handshake with {self.peer_addr} failed: {e}"
            ) from e
        await self._attach(reader, writer)

    async def close(self) -> None:
        self._closed = True
        if self._read_task is not None:
            self._read_task.cancel()
            self._read_task = None
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        self._reader = None

    def _fault(self) -> None:
        """Connection error (AsyncConnection::fault): lossy connections
        reset; lossless ones reconnect lazily on next send."""
        writer, self._writer = self._writer, None
        self._reader = None
        if writer is not None:
            writer.close()
        if self.policy.lossy:
            self._closed = True
            self.msgr._drop_connection(self)
        self.msgr._notify_reset(self)

    # -- send ----------------------------------------------------------------

    async def send_message(self, msg: Message) -> None:
        """Queue-and-send (AsyncConnection::send_message).  Raises on
        lossy connections that are closed; lossless ones transparently
        reconnect and RESEND the faulted message (Policy.resend_on_
        reconnect — the reference requeues unacked messages on the new
        session), bounded by _RESEND_TRIES so a PERMANENTLY dead peer
        surfaces ConnectionError to the caller's own recovery (objecter
        resend, OSD peering) instead of wedging the send lock forever.

        Duplication: the injection checks (`msgr.send` faultpoint + the
        legacy ms_inject_socket_failures knob) run BEFORE any bytes hit
        the wire, so INJECTED faults can never duplicate a delivered
        frame.  A real socket error after a full write but before drain
        returns can resend a frame the peer already processed —
        at-least-once, like any ack-less retransmit (the reference
        closes the gap with session seq replay, which needs the ack
        machinery this model doesn't carry)."""
        async with self._send_lock:
            if msg.superseded:
                return  # a later message replaced it while it queued
            if self._closed:
                raise ConnectionError(f"connection to {self.peer_addr} closed")
            if asyncio.get_event_loop().time() < self._dead_until:
                raise ConnectionError(
                    f"peer {self.peer_addr} recently unreachable"
                )
            self._out_seq += 1
            msg.src = self.msgr.name
            msg.seq = self._out_seq
            env, payload = encode_message(msg)
            frame = Frame(TAG_MESSAGE, [env, payload])
            attempt = 0
            give_up_at = asyncio.get_event_loop().time() + _RESEND_WINDOW
            while True:
                if msg.superseded:
                    return  # replaced during a resend backoff
                if self._closed:  # closed underneath a resend backoff
                    raise ConnectionError(
                        f"connection to {self.peer_addr} closed"
                    )
                if self._writer is None and self.policy.server:
                    # accept-side connections cannot re-dial the peer:
                    # not retryable, surface immediately
                    raise ConnectionError(f"not connected to {self.peer_addr}")
                try:
                    if self._writer is None:
                        # Lazy connect (first send), and lazy REconnect for
                        # lossless policies; faulted lossy connections were
                        # marked closed in _fault() and never reach here.
                        await self._connect()
                    faultpoint("msgr.send")
                    self.msgr._maybe_inject_fault()
                    delay = faultpoint_delay("msgr.send", who=self.msgr.name)
                    if delay > 0:
                        # latency injection: a slow NIC, not a
                        # dead one — the frame still goes out, late.  The
                        # sleep holds only THIS connection's send lock
                        await asyncio.sleep(delay)
                    raw = frame.pack(self.msgr.crc_data)
                    if self._onwire is not None:
                        raw = self._onwire.wrap(raw)
                    self._writer.write(raw)
                    await self._writer.drain()
                    return
                except (ConnectionError, OSError, InjectedFailure):
                    self._fault()
                    if self.policy.lossy or not self.policy.resend_on_reconnect:
                        raise ConnectionError(
                            f"send to {self.peer_addr} failed"
                        )
                    if self._closed:
                        raise ConnectionError(
                            f"connection to {self.peer_addr} closed"
                        )
                    attempt += 1
                    # bounded by attempts AND wall clock: a zombie peer
                    # whose accepts succeed but handshakes stall would
                    # otherwise stretch 12 attempts into minutes of
                    # handshake timeouts while holding the send lock
                    if (
                        attempt > _RESEND_TRIES
                        or asyncio.get_event_loop().time() > give_up_at
                    ):
                        # peer looks permanently gone: give the message
                        # back to the caller's recovery loop, and fail
                        # queued senders fast for another window instead
                        # of each serially re-burning a full one
                        self._dead_until = (
                            asyncio.get_event_loop().time() + _RESEND_WINDOW
                        )
                        raise ConnectionError(
                            f"send to {self.peer_addr} failed after "
                            f"{attempt} resend attempts"
                        )
                    # lossless: back off briefly and resend the SAME frame
                    # (same seq) over a fresh session
                    self.msgr.resends += 1
                    if not self._retry_now.is_set():
                        try:
                            await asyncio.wait_for(
                                self._retry_now.wait(),
                                min(0.5, 0.01 * (1 << min(attempt, 6))),
                            )
                        except asyncio.TimeoutError:
                            pass
                    self._retry_now.clear()

    # -- receive -------------------------------------------------------------

    async def _read_loop(self, reader: asyncio.StreamReader) -> None:
        # bound to the reader it was attached with: a lossless reconnect
        # attaches a NEW loop, and this (stale) one must neither read the
        # fresh stream nor fault the fresh session when its dead socket
        # finally errors out
        try:
            while not self._closed and self._reader is reader:
                if self._onwire is not None:
                    body = await read_record(reader)
                    frame = frame_from_bytes(self._onwire.unwrap(body))
                else:
                    frame = await read_frame(reader)
                faultpoint("msgr.recv")
                self.msgr._maybe_inject_fault()
                if frame.tag == TAG_KEEPALIVE:
                    continue
                if frame.tag != TAG_MESSAGE:
                    continue
                msg = decode_message(frame.segments[0], frame.segments[1])
                await self.msgr._deliver(self, msg)
        except (
            asyncio.IncompleteReadError,
            ConnectionError,
            OSError,
            FrameError,
            OnWireError,
            InjectedFailure,
            asyncio.CancelledError,
        ):
            if not self._closed and self._reader is reader:
                self._fault()


def _frame_io(reader, writer, crc_data: bool):
    """(send_frame, recv_frame) pair for the auth handshake — raw tagged
    frames on the not-yet-attached stream."""

    async def send_frame(tag: int, segments: list[bytes]) -> None:
        writer.write(Frame(tag, segments).pack(crc_data))
        await writer.drain()

    async def recv_frame() -> tuple[int, list[bytes]]:
        frame = await read_frame(reader)
        return frame.tag, frame.segments

    return send_frame, recv_frame


class Messenger:
    """The endpoint: bind/listen + outgoing connection cache
    (AsyncMessenger).  One per daemon role, as in ceph_osd.cc:548-561
    (the reference creates 7; here cluster+client traffic share one)."""

    def __init__(
        self,
        name: str,
        addr: str = "",
        crc_data: bool = True,
        inject_socket_failures: int = 0,
        inject_internal_delays: float = 0.0,
        dispatch_throttle_bytes: int = 0,
        auth=None,  # CephxAuth (src/auth/cephx); None = auth_none
        secure: bool = False,  # AES-GCM sessions (ms_mode=secure)
        compress: bool = False,  # on-wire frame compression
        stack: str = "posix",  # ms_type: posix | inproc (msg/stack.py)
    ):
        from .stack import make_stack

        self.name = name  # entity name, e.g. "osd.0"
        self.addr = addr  # host:port once bound (or for identification)
        self.stack = make_stack(stack)
        self.crc_data = crc_data
        if secure and auth is None:
            raise ValueError(
                "ms_secure requires cephx auth (the session key comes from "
                "the handshake, crypto_onwire.cc)"
            )
        self.secure = secure
        self.compress = compress
        self.inject_socket_failures = inject_socket_failures
        # ms_inject_internal_delays (global.yaml.in:1271): seconds of
        # injected sleep before local delivery, runtime-mutable
        self.inject_internal_delays = float(inject_internal_delays)
        self.resends = 0  # lossless transparent resends (fault recovery)
        self._rng = random.Random(hash(name) & 0xFFFF)
        self.dispatchers: list[Dispatcher] = []
        self._conns: dict[str, Connection] = {}  # peer_addr -> conn
        self._server: asyncio.AbstractServer | None = None
        self._throttle = (
            AsyncThrottle("msgr.dispatch", dispatch_throttle_bytes)
            if dispatch_throttle_bytes
            else None
        )
        self.default_policy = Policy.lossy_client()
        self._accepted: list[Connection] = []
        # set for the length of a shutdown: an accept that completes after
        # the shutdown closed the connections it knew of closes itself
        self._stopping = False
        self.auth = auth
        # daemon-attached Tracer (common/tracer.py): when set and enabled,
        # delivery of a trace-carrying message records a messenger span
        # parent-linked to the sender's (the blkin "async messenger" hop)
        self.tracer = None

    # -- setup ---------------------------------------------------------------

    def add_dispatcher_head(self, d: Dispatcher) -> None:
        self.dispatchers.insert(0, d)

    def add_dispatcher_tail(self, d: Dispatcher) -> None:
        self.dispatchers.append(d)

    async def bind(self, addr: str) -> None:
        self._stopping = False
        self._server, self.addr = await self.stack.listen(addr, self._accept)

    async def shutdown(self) -> None:
        # Stop accepting first, then close live connections before
        # waiting on the listener: Python 3.12's Server.wait_closed()
        # blocks until every handler's transport is finished, so open
        # accepted connections would deadlock it.  A handler that was
        # mid-hello when the shutdown began attaches after the
        # connections below were closed; `_stopping` makes it close its
        # own (the port's; ROADMAP C33: a daemon's peers reconnect
        # to it every heartbeat, and such a late accept held a daemon's
        # stop for the whole 15 s bound below).
        self._stopping = True
        if self._server is not None:
            self._server.close()
        for conn in list(self._conns.values()) + self._accepted:
            await conn.close()
        self._conns.clear()
        self._accepted.clear()
        if self._server is not None:
            try:
                # belt-and-braces bound: accept handlers are themselves
                # time-bounded now, but a shutdown must never hang on a
                # straggler — abandoning it is benign once close() has
                # stopped new accepts
                await asyncio.wait_for(self._server.wait_closed(), 15.0)
            except asyncio.TimeoutError:
                dout("msgr", 1, f"{self.name}: listener straggler at shutdown")
            self._server = None
        # Let cancelled read-loop tasks and closed transports unwind.
        await asyncio.sleep(0)

    # -- connections ---------------------------------------------------------

    def get_connection(self, peer_addr: str, policy: Policy | None = None) -> Connection:
        """Get-or-create an outgoing connection (connect lazily on first
        send) — AsyncMessenger::get_connection."""
        conn = self._conns.get(peer_addr)
        if conn is None or conn._closed:
            conn = Connection(self, peer_addr, policy or self.default_policy)
            self._conns[peer_addr] = conn
        return conn

    async def send_to(self, peer_addr: str, msg: Message) -> None:
        await self.get_connection(peer_addr).send_message(msg)

    def _drop_connection(self, conn: Connection) -> None:
        existing = self._conns.get(conn.peer_addr)
        if existing is conn:
            del self._conns[conn.peer_addr]

    def _feature_bits(self) -> int:
        return (FLAG_SECURE if self.secure else 0) | (
            FLAG_COMPRESSED if self.compress else 0
        )

    async def _accept(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        try:
            # Bounded hello: a peer that connects and never speaks (e.g. a
            # daemon dying mid-teardown) must not pin this handler open —
            # Python 3.12's Server.wait_closed() waits on every handler,
            # so an unbounded await here deadlocks messenger shutdown.
            try:
                frame = await asyncio.wait_for(read_frame(reader), 10.0)
            except (asyncio.TimeoutError, asyncio.IncompleteReadError):
                writer.close()
                return
            if frame.tag != TAG_HELLO:
                writer.close()
                return
            conn = Connection(self, frame.segments[1].decode(), Policy.stateless_server())
            conn.peer_name = frame.segments[0].decode()
            peer_feat = (
                frame.segments[2][0]
                if len(frame.segments) > 2 and frame.segments[2]
                else 0
            )
            chosen = peer_feat & self._feature_bits()
            if self.secure and not chosen & FLAG_SECURE:
                # encryption is required on this endpoint; no cleartext
                # fallback for a non-secure peer
                writer.close()
                return
            reply = Frame(
                TAG_HELLO,
                [self.name.encode(), self.addr.encode(), bytes([chosen])],
            )
            writer.write(reply.pack(self.crc_data))
            await writer.drain()
            session_key = b""
            if self.auth is not None:
                try:
                    # Bounded like the client side: a stalled peer must not
                    # pin this accept task (and its socket) forever.
                    conn.auth_entity, session_key = await asyncio.wait_for(
                        self.auth.server_auth(
                            *_frame_io(reader, writer, self.crc_data)
                        ),
                        timeout=5.0,
                    )
                except Exception as e:  # AuthError, timeout, noise
                    # a rejected accept must be visible: silent drops
                    # look like a network blackhole to the operator
                    dout("ms", 1,
                         f"{self.name}: accept auth failed: {e!r}")
                    writer.close()
                    return
            if chosen:
                conn._onwire = OnWireSession(
                    session_key,
                    secure=bool(chosen & FLAG_SECURE),
                    compress=bool(chosen & FLAG_COMPRESSED),
                    initiator=False,
                )
            await conn._attach(reader, writer)
            if self._stopping:
                await conn.close()  # accepted while this messenger stopped
                return
            self._accepted.append(conn)
            out = self._conns.get(conn.peer_addr)
            if out is not None and not out._closed:
                out.peer_is_up()
            for d in self.dispatchers:
                d.ms_handle_accept(conn)
        except (
            FrameError,
            OSError,
            asyncio.IncompleteReadError,
            # malformed hellos (missing segments, non-UTF-8 names) must
            # close the socket, not kill the accept task
            IndexError,
            UnicodeDecodeError,
            ValueError,
        ):
            writer.close()

    # -- delivery ------------------------------------------------------------

    async def _deliver(self, conn: Connection, msg: Message) -> None:
        if self.inject_internal_delays > 0:
            await asyncio.sleep(self.inject_internal_delays)
        size = 64  # envelope floor; payload length dominates below
        if self._throttle is not None:
            await self._throttle.get(size)
        span = None
        if self.tracer is not None and self.tracer.enabled:
            ctx = tracer_mod.extract(msg)
            if ctx is not None:
                span = self.tracer.start_span(
                    f"msgr:{type(msg).__name__}", remote=ctx
                )
                span.keyval("src", msg.src)
        try:
            with tracer_mod.span_scope(span):
                for d in self.dispatchers:
                    if d.ms_can_fast_dispatch(msg):
                        d.ms_fast_dispatch(conn, msg)
                        return
                for d in self.dispatchers:
                    handled = d.ms_dispatch(conn, msg)
                    if asyncio.iscoroutine(handled):
                        handled = await handled
                    if handled:
                        return
            dout("ms", 0, f"{self.name}: unhandled message {msg!r} from {msg.src}")
        finally:
            if span is not None:
                span.finish()
            if self._throttle is not None:
                await self._throttle.put(size)

    def _notify_reset(self, conn: Connection) -> None:
        for d in self.dispatchers:
            d.ms_handle_reset(conn)

    def _maybe_inject_fault(self) -> None:
        if self.inject_socket_failures > 0:
            if self._rng.randrange(self.inject_socket_failures) == 0:
                raise ConnectionError("injected socket failure")
