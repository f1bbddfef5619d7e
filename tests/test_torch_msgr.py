"""The port's messenger, frames, on-wire crypto and cephx against the JAX
package's, on the CPU.

- `frames.Frame` packs to the reference's bytes, and each package parses
  the other's; an `OnWireSession` (compressed, and secure under the same
  key and salt) wraps to the reference's records, and each unwraps the
  other's.
- The cephx handshake, with the challenges and the ticket clock pinned,
  sends the reference's frames, whichever package runs either end.
- A port messenger and a reference messenger exchange messages over
  `posix` loopback in both directions with cephx on, plain, compressed
  and with `ms_secure` (AES-GCM, from `cryptography`).
- Under `ms_inject_socket_failures`-style faults on `msgr.send` a
  lossless peer delivers every message once, in order, on each stack.
"""

import asyncio
import itertools

import pytest

import ceph_tpu.auth.cephx as jcephx
import ceph_tpu.msg.crypto as jcrypto
import ceph_tpu.msg.frames as jframes
from ceph_tpu.auth.keyring import KeyRing as JKeyRing
from ceph_tpu.common.fault_injector import global_injector as jinjector
from ceph_tpu.msg import messages as jmsgs
from ceph_tpu.msg.messenger import Dispatcher as JDispatcher, Messenger as JMessenger
from ceph_tpu.msg.messenger import Policy as JPolicy

import ceph_tpu_torch.auth.cephx as cephx
import ceph_tpu_torch.msg.crypto as crypto
import ceph_tpu_torch.msg.frames as frames
from ceph_tpu_torch.auth.keyring import KeyRing
from ceph_tpu_torch.common.fault_injector import global_injector
from ceph_tpu_torch.msg import messages as msgs
from ceph_tpu_torch.msg.messenger import Dispatcher, Messenger, Policy

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

PKG = {
    "jax": dict(cephx=jcephx, crypto=jcrypto, frames=jframes, KeyRing=JKeyRing, msgs=jmsgs,
                Messenger=JMessenger, Dispatcher=JDispatcher, Policy=JPolicy, inj=jinjector),
    "torch": dict(cephx=cephx, crypto=crypto, frames=frames, KeyRing=KeyRing, msgs=msgs,
                  Messenger=Messenger, Dispatcher=Dispatcher, Policy=Policy,
                  inj=global_injector),
}


# -- frames and on-wire records ------------------------------------------------


@pytest.mark.parametrize("crc", [True, False])
@pytest.mark.parametrize("segments", [[b""], [b"head", b"payload" * 100], [b"a", b"b", b"c"]])
def test_frames_match_reference_both_ways(segments, crc):
    ours = frames.Frame(frames.TAG_MESSAGE, list(segments)).pack(crc_data=crc)
    ref = jframes.Frame(jframes.TAG_MESSAGE, list(segments)).pack(crc_data=crc)
    assert ours == ref
    assert frames.frame_from_bytes(ref).segments == list(segments)
    assert jframes.frame_from_bytes(ours).segments == list(segments)


@pytest.mark.parametrize("secure,compress", [(False, True), (True, False), (True, True)])
def test_onwire_records_match_reference_both_ways(secure, compress):
    """Same key, same salt: the same records; each package unwraps the
    other's (secure mode needs `cryptography`, which this machine has)."""
    if secure and crypto.AESGCM is None:
        pytest.skip("the cryptography package is not installed")
    key = bytes(range(16))
    tx = {p: PKG[p]["crypto"].OnWireSession(key, secure, compress, initiator=True)
          for p in PKG}
    rx = {p: PKG[p]["crypto"].OnWireSession(key, secure, compress, initiator=False)
          for p in PKG}
    for s in tx.values():
        s._tx_salt = b"salt"
    for n in (0, 1, 4096, 100000):
        frame = bytes(itertools.islice(itertools.cycle(b"ceph frame "), n))
        wire = {p: tx[p].wrap(frame) for p in PKG}
        assert wire["torch"] == wire["jax"]
        head = crypto._HEAD.size
        assert rx["torch"].unwrap(wire["jax"][head:]) == frame
        assert rx["jax"].unwrap(wire["torch"][head:]) == frame
    assert crypto.derive_session_key(key, b"x") == jcrypto.derive_session_key(key, b"x")


# -- cephx -------------------------------------------------------------------------


class _Pipe:
    """Two frame channels between a client and a server coroutine."""

    def __init__(self):
        self.c2s, self.s2c = asyncio.Queue(), asyncio.Queue()
        self.log = []

    def end(self, out_q, in_q, who):
        async def send(tag, segs):
            self.log.append((who, tag, [bytes(s) for s in segs]))
            await out_q.put((tag, list(segs)))

        async def recv():
            return await in_q.get()

        return send, recv


@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("torch", "torch"), ("torch", "jax"), ("jax", "torch")])
def test_cephx_handshake_matches_reference(monkeypatch, client_pkg, server_pkg):
    """With the challenges and the ticket clock pinned, a handshake sends
    the frames the reference's own handshake sends, the ticket fast path
    included, and both ends derive the reference's session key."""
    counter = [itertools.count(1)]  # one sequence for both modules, reset a run
    for mod in (cephx, jcephx):
        monkeypatch.setattr(mod._secrets, "token_bytes",
                            lambda n: bytes([next(counter[0])]) * n)
        monkeypatch.setattr(mod.time, "time", lambda: 1_700_000_000.0)
    secret = bytes(range(100, 116))
    service = bytes(range(50, 66))

    async def handshake(cpkg, spkg):
        counter[0] = itertools.count(1)
        kr = PKG[spkg]["KeyRing"]()
        kr.add("osd.1", secret)
        kr.add("osd.0", bytes(16))
        server = PKG[spkg]["cephx"].CephxAuth("osd.0", bytes(16), keyring=kr,
                                              service_secret=service)
        client = PKG[cpkg]["cephx"].CephxAuth.for_client("osd.1", secret)
        out = []
        for _ in range(2):  # the challenge path, then the ticket path
            pipe = _Pipe()
            c = asyncio.create_task(client.client_auth(
                *pipe.end(pipe.c2s, pipe.s2c, "c"), peer="osd.0-addr"))
            s = asyncio.create_task(server.server_auth(*pipe.end(pipe.s2c, pipe.c2s, "s")))
            (ticket, ckey), (entity, skey) = await asyncio.gather(c, s)
            assert entity == "osd.1" and ckey == skey
            out.append((pipe.log, ticket, ckey))
        return out

    got = asyncio.run(handshake(client_pkg, server_pkg))
    ref = asyncio.run(handshake("jax", "jax"))
    assert got == ref


# -- messengers of both packages over posix loopback ----------------------------------


def _collector(pkg):
    base = PKG[pkg]["Dispatcher"]

    class Collector(base):
        def __init__(self):
            self.got = []
            self.event = asyncio.Event()

        def ms_dispatch(self, conn, msg):
            self.got.append((conn.auth_entity, msg.tobytes()))
            self.event.set()
            return True

    return Collector()


def _keyring():
    kr = KeyRing()
    for ent in ("osd.0", "osd.1"):
        kr.add(ent)
    jkr = JKeyRing()
    for ent in kr.entities():
        jkr.add(ent, kr.get(ent))
    return {"torch": kr, "jax": jkr}


async def _wait(pred, timeout=20.0):
    deadline = asyncio.get_event_loop().time() + timeout
    while not pred():
        assert asyncio.get_event_loop().time() < deadline, "timed out"
        await asyncio.sleep(0.005)


def _sample_messages(pkg):
    m = PKG[pkg]["msgs"]
    return [
        m.MPing(stamp=2.5),
        m.MOSDPing(op=m.MOSDPing.PING, stamp=1.25, epoch=7, from_osd=1),
        m.MOSDBoot(osd=1, addr="127.0.0.1:6800", epoch=3),
        m.MOSDOp(reqid=m.ReqId("client.9", 4), pgid=m.PgId(2, 5, -1), oid="rbd_data.1",
                 ops=[m.OSDOp(op=m.OSDOp.WRITEFULL, data=bytes(range(256)) * 64)], epoch=9),
        m.MLog(version=0, entries=b'[{"prio": "info", "msg": "x"}]'),
    ]


@pytest.mark.parametrize("mode", ["plain", "compress", "secure"])
@pytest.mark.parametrize("server_pkg,client_pkg", [("jax", "torch"), ("torch", "jax")])
def test_messenger_interop_over_posix_with_cephx(server_pkg, client_pkg, mode):
    """A port messenger and a reference messenger exchange the daemon's
    messages over loopback TCP with cephx on, in both directions (the
    reply leg rides the accepted connection)."""
    if mode == "secure" and crypto.AESGCM is None:
        pytest.skip("the cryptography package is not installed")
    krs = _keyring()

    async def run():
        kw = dict(secure=mode == "secure", compress=mode == "compress", stack="posix")
        server = PKG[server_pkg]["Messenger"](
            "osd.0", auth=PKG[server_pkg]["cephx"].CephxAuth.for_daemon("osd.0", krs[server_pkg]),
            **kw)
        client = PKG[client_pkg]["Messenger"](
            "osd.1", auth=PKG[client_pkg]["cephx"].CephxAuth.for_daemon("osd.1", krs[client_pkg]),
            **kw)
        s_coll, c_coll = _collector(server_pkg), _collector(client_pkg)
        server.add_dispatcher_tail(s_coll)
        client.add_dispatcher_tail(c_coll)
        await server.bind("127.0.0.1:0")
        await client.bind("127.0.0.1:0")
        sent = _sample_messages(client_pkg)
        for m in sent:
            await client.send_to(server.addr, m)
        await _wait(lambda: len(s_coll.got) == len(sent))
        conn = server._accepted[0]
        back = _sample_messages(server_pkg)
        for m in back:
            await conn.send_message(m)
        await _wait(lambda: len(c_coll.got) == len(back))
        await client.shutdown()
        await server.shutdown()
        return s_coll.got, c_coll.got, [m.tobytes() for m in sent], [m.tobytes() for m in back]

    s_got, c_got, sent, back = asyncio.run(run())
    assert [b for _e, b in s_got] == sent
    assert {e for e, _b in s_got} == {"osd.1"}
    assert [b for _e, b in c_got] == back


@pytest.mark.parametrize("stack", ["posix", "inproc"])
@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_lossless_peer_keeps_order_under_injected_socket_failures(pkg, stack):
    """`msgr.send` armed one-in-three: a lossless peer reconnects and
    resends, so every message arrives once and in order (the port as the
    reference)."""
    P = PKG[pkg]

    async def run():
        server = P["Messenger"]("osd.0", stack=stack)
        client = P["Messenger"]("osd.1", stack=stack)
        client.default_policy = P["Policy"].lossless_peer()
        coll = _collector(pkg)
        server.add_dispatcher_tail(coll)
        await server.bind("127.0.0.1:0" if stack == "posix" else "")
        P["inj"]().inject_probabilistic("msgr.send", 3)
        try:
            for i in range(60):
                await client.send_to(server.addr, P["msgs"].MPing(stamp=float(i)))
        finally:
            P["inj"]().clear("msgr.send")
        await _wait(lambda: len(coll.got) >= 60)
        resends = client.resends
        await client.shutdown()
        await server.shutdown()
        return coll.got, resends

    got, resends = asyncio.run(run())
    m = P["msgs"]
    assert [b for _e, b in got] == [m.MPing(stamp=float(i)).tobytes() for i in range(60)]
    assert resends > 0
