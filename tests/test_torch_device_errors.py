"""ROADMAP C36 on the CPU: a device error that meets a broad handler of
the OSD's op path is answered -EIO in the port, beside the JAX package's
daemon on the same cluster and ops.

The static analysis's device rule (`ceph_tpu_torch/analysis/passes/
exceptions.py`) found four handlers of the op path that took any
exception for the client's fault or for nothing: an object-class method
that raises (a read CALL and a write CALL) and a write whose submit
raises are answered -EINVAL, and an exception that escapes `PG.do_op` is
logged by the op worker and never answered, so the client waits out its
op.  A device error is the device's failure, not the client's
(`ops.guard.is_device_error`: here torch's bare `RuntimeError` naming
CUDA, which both packages are handed alike).  The port answers each
-EIO; the reference keeps its answers.  Any other error keeps the
reference's answer in the port too.
"""

import asyncio
import importlib

import pytest

from test_torch_ec_backend import _pin_reference  # noqa: F401 (autouse)
from test_torch_osd import make_cluster
from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

EC = [dict(name="ec", kind="ec", k=4, m=2, pg_num=8, stripe_unit=4096)]
ROOT = {"jax": "ceph_tpu", "torch": "ceph_tpu_torch"}
EIO, EINVAL = 5, 22
DEVICE_ERROR = "CUDA error: an illegal memory access was encountered"


def _raise(kind: str):
    if kind == "device":
        raise RuntimeError(DEVICE_ERROR)
    raise ValueError("a bug")


async def _probe(pkg, tmp_path, monkeypatch, kind: str):
    """The replies to: a write whose submit raises, a read CALL and a write
    CALL whose method raises, a read whose `PG.do_op` raises (None: the op
    was never answered)."""
    pg_mod = importlib.import_module(f"{ROOT[pkg]}.osd.pg")
    ec_mod = importlib.import_module(f"{ROOT[pkg]}.osd.ec_backend")
    c = make_cluster(pkg, tmp_path, pools=EC, n_osds=6)
    try:
        await c.start(30)
        cl = c.client
        assert (await cl.op("ec", "o", [cl.osd_op("WRITEFULL", data=b"x" * 8192)])).result == 0
        out = []
        with monkeypatch.context() as mp:
            mp.setattr(ec_mod.ECBackend, "submit_transaction",
                       lambda self, *a, **k: _raise(kind))
            rep = await cl.op("ec", "o", [cl.osd_op("WRITEFULL", data=b"y" * 8192)])
            out.append(rep.result)
        for flags in (0, pg_mod.CLS_WR):
            with monkeypatch.context() as mp:
                mp.setattr(pg_mod, "cls_get_method",
                           lambda c_, m_, flags=flags: (flags, lambda hctx, data: _raise(kind)))
                rep = await cl.op("ec", "o", [cl.osd_op("CALL", name="drill.method", data=b"")])
                out.append(rep.result)
        with monkeypatch.context() as mp:
            mp.setattr(pg_mod.PG, "do_op", lambda self, *a, **k: _raise(kind))
            try:
                rep = await cl.op("ec", "o", [cl.osd_op("READ", off=0, len=0)], timeout=1.5)
                out.append(rep.result)
            except TimeoutError:
                out.append(None)
        back = await cl.op("ec", "o", [cl.osd_op("READ", off=0, len=0)])
        assert back.result == 0 and bytes(back.outdata[0]) == b"x" * 8192
        return out
    finally:
        await c.stop()


def test_a_device_error_on_the_op_path_is_eio_only_in_the_port(tmp_path, monkeypatch):
    ref = asyncio.run(_probe("jax", tmp_path, monkeypatch, "device"))
    port = asyncio.run(_probe("torch", tmp_path, monkeypatch, "device"))
    assert ref == [-EINVAL, -EINVAL, -EINVAL, None]
    assert port == [-EIO, -EIO, -EIO, -EIO]


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_any_other_error_keeps_the_reference_answer(tmp_path, monkeypatch, pkg):
    assert asyncio.run(_probe(pkg, tmp_path, monkeypatch, "bug")) == [
        -EINVAL, -EINVAL, -EINVAL, None]
