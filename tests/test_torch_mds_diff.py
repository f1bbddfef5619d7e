"""The port's MDS and CephFS client against the JAX package's, byte for
byte, on the CPU.

- The three client messages (`MClientRequest`, `MClientReply`,
  `MClientCaps`) encode to the same bytes in both packages, for seeded
  field values, and each package decodes the other's; a version-1
  `MClientRequest` (no `client`) decodes alike.
- A seeded namespace workload runs through each package's `MDS` (the
  embedded mode: fixed pools, no monitor) and two of its `CephFSClient`s,
  against each package's daemons (`torch_daemon_host.DaemonCluster`,
  the map service, cephx), with the metadata on a replicated pool and the
  file data on an RS(4,2) overwrites pool: mkdir, whole-file writes,
  writes at offsets, truncates, renames (over files too), unlinks,
  rmdirs, symlinks, listings and stats, a conflicting open that revokes
  the other client's caps, and resends of completed requests.  Equal, in
  order: every call's result or errno, every `MClientReply` and
  `MClientCaps` the clients received and every `MClientRequest` they
  sent (encoded), every `MOSDOp` the Objecter sent, every object of both
  pools as read back (`mds_inotable`, each `dir.<ino>`, `mds_journal`,
  `mds_journal_head`, `mds_completed`, the files' data objects) with
  the journal unflushed and again after a flush, and every daemon's
  store.  Then the MDS crashes with events unflushed, a second one
  replays the journal, and its state (dirfrags, the inode table, the
  journal's sequence, the completed-request table, the inode locations)
  and its answers to resends are equal too.

Pinned alike in both packages (`torch_access_host.pin`, and here): the
Objecter's clock and reqid nonce, the client's id (`secrets.token_hex`),
and the MDS's wall clock (`time.time`, the entries' mtime).  The MDS's
periodic flush is stopped, so the journal is flushed only where the
script says.
"""

import asyncio
import importlib
import json
from types import SimpleNamespace

import numpy as np
import pytest

from test_torch_ec_backend import _pin_reference  # noqa: F401 (autouse)
from torch_access_host import ROOT, connect, make_cluster, pin, pinned_t0, pinned_wall, settle
from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)

POOLS = [dict(name="meta", kind="rep", size=3, pg_num=8),
         dict(name="data", kind="ec", k=4, m=2, pg_num=8, stripe_unit=4096, overwrites=True)]
N_OSDS = 6


def mods(pkg: str) -> SimpleNamespace:
    root = ROOT[pkg]
    imp = lambda name: importlib.import_module(f"{root}.{name}")  # noqa: E731
    return SimpleNamespace(mds=imp("mds.mds"), client=imp("mds.client"), rados=imp("client.rados"),
                           messages=imp("msg.messages"), message=imp("msg.message"))


# -- the messages --------------------------------------------------------------


def message_fields(rng) -> list:
    """(name, fields) of seeded messages of each of the three types."""
    def word(n):
        return "".join(chr(int(c)) for c in rng.integers(97, 123, n))

    out = []
    for _ in range(8):
        out.append(("MClientRequest", dict(
            tid=int(rng.integers(0, 1 << 62)), op=word(int(rng.integers(0, 12))),
            args=json.dumps({"path": "/" + word(5), "n": int(rng.integers(0, 99))}).encode(),
            client=word(int(rng.integers(0, 20))))))
        out.append(("MClientReply", dict(
            tid=int(rng.integers(0, 1 << 62)), result=-int(rng.integers(0, 125)),
            payload=rng.integers(0, 256, int(rng.integers(0, 300)), dtype=np.uint8).tobytes())))
        out.append(("MClientCaps", dict(
            op=int(rng.integers(0, 3)), ino=int(rng.integers(0, 1 << 62)),
            caps=["", "r", "w", "rw"][int(rng.integers(0, 4))],
            tid=int(rng.integers(0, 1 << 62)))))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_client_messages_encode_alike(seed):
    ref, ours = mods("jax"), mods("torch")
    for name, fields in message_fields(np.random.default_rng(seed)):
        a = getattr(ref.messages, name)(**fields)
        b = getattr(ours.messages, name)(**fields)
        for m in (a, b):
            m.src, m.seq = "client.7", 3
        env_a, pay_a = ref.message.encode_message(a)
        env_b, pay_b = ours.message.encode_message(b)
        assert (env_a, pay_a) == (env_b, pay_b), name
        back = ours.message.decode_message(env_a, pay_a)
        assert type(back).__name__ == name
        assert {k: getattr(back, k) for k in fields} == fields
        back = ref.message.decode_message(env_b, pay_b)
        assert {k: getattr(back, k) for k in fields} == fields


def test_a_version_1_request_decodes_alike():
    """A sender of the request's first version has no `client`: both
    packages read it as a request with no dedup."""
    out = {}
    for pkg in ("jax", "torch"):
        m = mods(pkg)
        enc = importlib.import_module(f"{ROOT[pkg]}.common.encoding").Encoder()
        enc.start(1, 1)
        enc.u64(9)
        enc.string("mkdir")
        enc.bytes_(b'{"path": "/a"}')
        enc.finish()
        dec = importlib.import_module(f"{ROOT[pkg]}.common.encoding").Decoder(enc.tobytes())
        msg = m.messages.MClientRequest.decode(dec)
        out[pkg] = (enc.tobytes(), msg.tid, msg.op, msg.args, msg.client)
    assert out["jax"] == out["torch"]
    assert out["torch"][1:] == (9, "mkdir", b'{"path": "/a"}', "")


# -- the namespace workload ----------------------------------------------------


def gen_script(seed: int, n: int = 60) -> list:
    """Client calls as plain data: (client, call, args).  A model of the
    namespace keeps most calls valid; some are not, on purpose."""
    rng = np.random.default_rng(seed)
    dirs, files, links = ["/"], {}, {}

    def pick(seq):
        seq = sorted(seq)
        return seq[int(rng.integers(0, len(seq)))] if seq else None

    def blob(lo, hi):
        return rng.integers(0, 256, int(rng.integers(lo, hi)), dtype=np.uint8).tobytes()

    def child(parent):
        return parent.rstrip("/") + f"/n{int(rng.integers(0, 40))}"

    script = []
    for _ in range(n):
        who = int(rng.integers(0, 2))
        kind = rng.choice(["mkdir", "write_file", "write_file", "write_at", "truncate", "read_file",
                           "rename", "unlink", "rmdir", "symlink", "listdir", "stat", "resend"])
        if kind == "mkdir":
            path = child(pick(dirs))
            script.append((who, "mkdir", (path,)))
            if path not in files and path not in dirs and path not in links:
                dirs.append(path)
        elif kind == "write_file":
            path = pick(files) if files and rng.random() < 0.3 else child(pick(dirs))
            if path in dirs or path in links:
                continue
            data = blob(0, 180_000)
            script.append((who, "write_file", (path, data)))
            files[path] = len(data)
        elif kind == "write_at" and files:
            path = pick(files)
            off = int(rng.integers(0, files[path] + 70_000))
            data = blob(1, 70_000)
            script.append((who, "write_at", (path, off, data)))
            files[path] = max(files[path], off + len(data))
        elif kind == "truncate" and files:
            path = pick(files)
            size = int(rng.integers(0, files[path] + 10_000))
            script.append((who, "truncate", (path, size)))
            files[path] = size
        elif kind == "read_file":
            script.append((who, "read_file", (pick(files) or "/nofile",)))
        elif kind == "rename" and files:
            src = pick(files)
            dst = pick(files) if rng.random() < 0.3 else child(pick(dirs))
            if dst in dirs or dst in links:
                continue
            script.append((who, "rename", (src, dst)))
            if dst != src:
                files[dst] = files.pop(src)
        elif kind == "unlink":
            path = pick(files) if files and rng.random() < 0.8 else "/ghost"
            script.append((who, "unlink", (path,)))
            files.pop(path, None)
        elif kind == "rmdir" and len(dirs) > 1:
            path = pick(dirs[1:])
            script.append((who, "rmdir", (path,)))
            if not any(p.startswith(path + "/") for p in [*dirs, *files, *links]):
                dirs.remove(path)
        elif kind == "symlink":
            path = child(pick(dirs))
            script.append((who, "symlink", (pick(files) or "/x", path)))
            if path not in files and path not in dirs and path not in links:
                links[path] = True
                script.append((who, "readlink", (path,)))
        elif kind == "listdir":
            path = pick(dirs)
            script.append((who, "listdir", (path,)))
            script.append((who, "listdir_plus", (path,)))
        elif kind == "stat":
            script.append((who, "stat", (pick([*files, *dirs]),)))
        elif kind == "resend":
            script.append((who, "resend", (int(rng.integers(1, 8)),)))
    # a conflicting open: client 0 holds the file for writing, client 1
    # opens it for writing and the MDS revokes client 0's caps
    script.append((0, "revoke", ("/contested", blob(1000, 5000))))
    return script


class Recorder:
    """Every message a client sent to the MDS and received from it,
    encoded, in order."""

    def __init__(self, m, fsc):
        self.log = []
        encode = m.message.encode_message
        dispatch, send_to = fsc.ms_dispatch, fsc.msgr.send_to

        def recording_dispatch(conn, msg):
            if type(msg).__name__ in ("MClientReply", "MClientCaps"):
                self.log.append(("in", encode(msg)))
            return dispatch(conn, msg)

        async def recording_send(addr, msg):
            self.log.append(("out", encode(msg)))
            return await send_to(addr, msg)

        fsc.ms_dispatch = recording_dispatch
        fsc.msgr.send_to = recording_send


async def resend(m, fsc, mds_addr: str, tid: int, op: str, args: dict):
    """A resend of request `tid` with its reqid (a retry after a lost
    reply): the reply's result and payload."""
    fut = asyncio.get_event_loop().create_future()
    fsc._replies[tid] = fut
    await fsc.msgr.send_to(mds_addr, m.messages.MClientRequest(
        tid=tid, op=op, args=json.dumps(args).encode(), client=fsc.client_id))
    try:
        reply = await asyncio.wait_for(fut, 10.0)
    finally:
        fsc._replies.pop(tid, None)
    return reply.result, json.loads(reply.payload.decode() or "{}")


async def call(m, fsc, mds, kind: str, args: tuple, sent: dict):
    """One scripted call: its result, or the client error's errno."""
    try:
        if kind == "write_at":
            path, off, data = args
            fh = await fsc.open(path, "w")
            try:
                await fh.write(data, off)
            finally:
                await fh.close()
            return fh.entry["size"]
        if kind == "truncate":
            path, size = args
            fh = await fsc.open(path, "w")
            try:
                await fh.truncate(size)
            finally:
                await fh.close()
            return fh.entry["size"]
        if kind == "resend":
            tid = args[0]
            if tid not in sent:
                return None
            op, op_args = sent[tid]
            return await resend(m, fsc, mds.addr, tid, op, op_args)
        if kind == "revoke":
            return await revoke(fsc, *args)
        result = await getattr(fsc, kind)(*args)
        return result
    except m.client.FsClientError as e:
        return ("errno", e.errno)


async def revoke(pair, path: str, data: bytes):
    a, b = pair
    fh_a = await a.create(path)
    await fh_a.write(data)
    fh_b = await b.open(path, "w")
    for _ in range(500):
        if not fh_a.valid:
            break
        await asyncio.sleep(0.01)
    await fh_b.write(data[::-1], 10)
    await fh_b.close()
    return (fh_a.valid, fh_b.caps, fh_b.entry["size"], await a.read_file(path))


async def pool_objects(io) -> dict:
    return {oid: await io.read(oid) for oid in sorted(await io.list_objects())}


def mds_state(mds) -> dict:
    return {"dirs": json.dumps(sorted(mds._dirs.items())), "next_ino": mds._next_ino,
            "journal_seq": mds._journal_seq, "dirty": sorted(mds._dirty),
            "completed": json.dumps(list(mds._completed.items())),
            "ino_loc": sorted(mds._ino_loc.items())}


async def workload(pkg: str, tmp_path, monkeypatch, seed: int, t0: float, wall: float) -> dict:

    m = mods(pkg)
    pin(pkg, monkeypatch, t0, wall)
    monkeypatch.setattr(m.mds, "time", SimpleNamespace(time=lambda: wall))
    c = make_cluster(pkg, tmp_path, pools=POOLS, n_osds=N_OSDS)
    r = mds = mds2 = None
    clients = []
    try:
        await c.start(30)
        r, sent_ops = await connect(pkg, c)
        meta, data = await r.open_ioctx("meta"), await r.open_ioctx("data")
        mds = m.mds.MDS(meta, data, addr="", stack="inproc")
        await mds.start()
        mds._flush_task.cancel()  # the script flushes where it says
        clients = [m.client.CephFSClient(mds.addr, data, name=f"client.fs{i}", stack="inproc")
                   for i in range(2)]
        recorders = [Recorder(m, fsc) for fsc in clients]
        requests = [{}, {}]  # per client: tid -> (op, args), to resend
        for i, fsc in enumerate(clients):
            request = fsc._request

            async def remembering(op, args, timeout=10.0, fsc=fsc, i=i, request=request):
                requests[i][fsc._tid + 1] = (op, args)
                return await request(op, args, timeout)

            fsc._request = remembering
        results = []
        for step, (who, kind, args) in enumerate(gen_script(seed)):
            target = clients if kind == "revoke" else clients[who]
            results.append((kind, await call(m, target, mds, kind, args, requests[who])))
            if step == 40:
                mid = await pool_objects(meta)
                await mds._flush()
                flushed = await pool_objects(meta)
        unflushed = await pool_objects(meta)
        await mds._flush()
        out = {"results": results, "mid": mid, "flushed": flushed, "unflushed": unflushed,
               "after": await pool_objects(meta), "data": await pool_objects(data)}
        # a few more mutations, then a crash with them in the journal
        for i, path in enumerate(("/crash0", "/crash1")):
            await clients[i].mkdir(path)
        await clients[0].write_file("/crash0/f", b"unflushed" * 100)
        await clients[1].rename("/crash0/f", "/crash1/g")
        out["journal"] = await meta.read(m.mds.JOURNAL_OID)
        await mds.stop(flush=False)
        mds2 = m.mds.MDS(meta, data, addr="", stack="inproc")
        await mds2.start()
        mds2._flush_task.cancel()
        out["replayed"] = mds_state(mds2)
        answers = []
        for i, fsc in enumerate(clients):
            for tid in sorted(requests[i])[-3:]:
                op, op_args = requests[i][tid]
                answers.append(await resend(m, fsc, mds2.addr, tid, op, op_args))
            fsc.mds_addr = mds2.addr
        answers.append(await clients[0].read_file("/crash1/g"))
        answers.append(await clients[1].listdir_plus("/crash1"))
        out["answers"] = answers
        out["messages"] = [rec.log for rec in recorders]
        out["sent"] = sent_ops
        await settle(c)
        out["stores"] = c.stores()
        return out
    finally:
        for fsc in clients:
            await fsc.shutdown()
        for d in (mds, mds2):
            if d is not None:
                await d.stop(flush=False)
        if r is not None:
            await r.shutdown()
        await c.stop()


@pytest.mark.parametrize("seed", [0, 1])
def test_the_mds_workload_matches_the_reference(tmp_path, monkeypatch, seed):
    t0, wall = pinned_t0(), pinned_wall()
    got = {pkg: asyncio.run(workload(pkg, tmp_path, monkeypatch, seed, t0, wall))
           for pkg in ("jax", "torch")}
    ref, ours = got["jax"], got["torch"]
    assert len(ours["results"]) == len(ref["results"])
    for i, (a, b) in enumerate(zip(ours["results"], ref["results"])):
        assert a == b, f"call {i}: {a[0]}"
    for key in ("mid", "flushed", "unflushed", "after", "data", "journal", "replayed", "answers"):
        assert ours[key] == ref[key], key
    for i, (a, b) in enumerate(zip(ours["messages"], ref["messages"])):
        assert a == b, f"client {i}'s messages"
    assert len(ours["sent"]) == len(ref["sent"])
    for i, (a, b) in enumerate(zip(ours["sent"], ref["sent"])):
        assert a == b, f"MOSDOp {i}"
    for i, (a, b) in enumerate(zip(ours["stores"], ref["stores"])):
        assert a == b, f"osd.{i}'s store"
    # the script did what it says: entries, file data, a journal, a revoke
    assert sum(1 for k, v in ref["results"] if isinstance(v, tuple) and v[0] == "errno") >= 3
    assert any(oid.startswith("dir.") and oid != "dir.1" for oid in ref["after"])
    assert {"mds_inotable", "mds_journal", "mds_journal_head", "mds_completed"} <= set(ref["after"])
    assert ref["mid"]["mds_journal"] and ref["flushed"]["mds_journal"] == b""
    assert len(ref["data"]) >= 4 and ref["journal"]
    assert ref["results"][-1][1][:3] == (False, "w", ref["results"][-1][1][2])
    assert ref["replayed"]["dirty"]
