"""The port stands alone: neither `ceph_tpu_torch/` nor `chip_smoke.py`
imports jax, anything of the JAX package, or its `benchmarks` scripts."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "ceph_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "ceph_tpu", "benchmarks")


def _imported_modules(path: Path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
    return names


def test_port_files_found():
    assert len(PORT_FILES) >= 15
    for source in ("swar_gf.cu", "copy_floor.cu", "swar_baked.cu", "swar3_baked.cu",
                   "bitmatrix.cu", "packed_gf.cu", "crc32c_host.cc", "gf2_plane.cu",
                   "xor_reduce.cu", "crc32c.cu", "compress_transform.cu"):
        assert (ROOT / "ceph_tpu_torch" / "csrc" / source).exists()
    for module in ("gf/gf2.py", "codec/jerasure.py", "codec/shec.py", "codec/lrc.py",
                   "codec/clay.py", "codec/plugins/jerasure.py", "codec/plugins/isa.py",
                   "codec/plugins/xor.py", "codec/plugins/shec.py", "codec/plugins/lrc.py",
                   "codec/plugins/clay.py", "ops/device_cache.py", "osd/scrubber.py",
                   "os/kv.py", "os/bluestore.py", "os/filestore.py", "compressor/__init__.py",
                   "compressor/registry.py", "compressor/device.py",
                   "ops/checksum_offload.py", "crush/hash.py", "crush/crush.py",
                   "crush/wrapper.py", "osd/pg.py", "osd/peering.py", "osd/reserver.py",
                   "osd/snaps.py", "common/config.py", "cls/objclass.py",
                   "msg/frames.py", "msg/crypto.py", "msg/stack.py", "msg/messenger.py",
                   "auth/cephx.py", "auth/keyring.py", "mon/client.py", "mon/monmap.py",
                   "common/admin_socket.py", "common/op_tracker.py",
                   "common/io_accounting.py", "common/clog.py",
                   "osd/recovery_controller.py", "osd/osd.py", "common/health.py",
                   "mon/paxos.py", "mon/paxos_service.py", "mon/elector.py",
                   "mon/osd_monitor.py", "mon/auth_monitor.py", "mon/config_monitor.py",
                   "mon/log_monitor.py", "mon/mgr_monitor.py", "mon/mds_monitor.py",
                   "mon/monitor.py", "mgr/mgr.py", "mgr/modules.py",
                   "client/objecter.py", "client/rados.py", "client/__init__.py",
                   "striper/striper.py", "striper/__init__.py", "cls/log.py",
                   "cls/client.py", "common/tsdb.py", "mgr/prometheus.py",
                   "mgr/iostat.py", "mgr/progress.py", "mgr/metrics_history.py",
                   "mgr/clog.py", "mgr/balancer.py", "mgr/pg_autoscaler.py",
                   "mgr/telemetry.py", "mgr/dashboard.py", "mgr/orchestrator.py",
                   "client/absent.py", "rbd/__init__.py", "rbd/rbd.py", "rbd/mirror.py",
                   "rgw/__init__.py", "rgw/rgw.py", "rgw/http.py", "rgw/swift.py",
                   "fs/__init__.py", "fs/fs.py"):
        assert ROOT / "ceph_tpu_torch" / module in PORT_FILES, module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    for name in _imported_modules(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.relative_to(ROOT)} imports {name}"
    assert "importlib.import_module(\"jax" not in path.read_text()


def test_plugin_import_leaves_jax_out():
    code = (
        "import sys\n"
        "import ceph_tpu_torch.codec.plugins.tpu\n"
        "from ceph_tpu_torch.codec import registry\n"
        "ec = registry.instance().factory('tpu', {'k': '4', 'm': '2'}, device='cpu')\n"
        "ec.encode({0, 1, 2, 3, 4, 5}, b'x' * 1000)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ceph_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_offload_runtime_import_leaves_jax_out():
    """The offload runtime, the EC aggregators and the device guard import
    neither jax nor the JAX package, and an aggregated CPU encode runs."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "import ceph_tpu_torch.ops.offload_runtime\n"
        "import ceph_tpu_torch.ops.guard\n"
        "from ceph_tpu_torch.codec import registry\n"
        "from ceph_tpu_torch.codec.matrix_codec import (\n"
        "    default_decode_aggregator, default_encode_aggregator, default_verify_aggregator)\n"
        "ec = registry.instance().factory('tpu', {'k': '4', 'm': '2'}, device='cpu')\n"
        "data = np.arange(2 * 4 * 4096, dtype=np.uint32).astype(np.uint8).reshape(2, 4, 4096)\n"
        "parity = default_encode_aggregator().submit(ec, data).result()\n"
        "assert np.array_equal(parity, ec.encode_array_host(data))\n"
        "default_decode_aggregator(), default_verify_aggregator()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ceph_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_ec_backend_import_leaves_jax_out():
    """The EC backend, the stripe module and the modules under them import
    neither jax nor the JAX package: an RS(4,2) cluster of 6 backends on
    the CPU writes and reads back one object."""
    code = (
        "import sys\n"
        "import ceph_tpu_torch.osd.ec_backend\n"
        "import ceph_tpu_torch.stripe.stripe\n"
        "from ceph_tpu_torch.msg.messages import PgId, ReqId\n"
        "from ceph_tpu_torch.os.memstore import MemStore\n"
        "from ceph_tpu_torch.os.transaction import Transaction\n"
        "from ceph_tpu_torch.osd.ec_transaction import PGTransaction\n"
        "from ceph_tpu_torch.osd.osdmap import POOL_TYPE_ERASURE, PgPool\n"
        "from ceph_tpu_torch.osd.pg_backend import PGListener, build_pg_backend, shard_coll\n"
        "from ceph_tpu_torch.osd.pg_log import Eversion\n"
        "queue, acting, pgid = [], list(range(6)), PgId(1, 0, -1)\n"
        "class L(PGListener):\n"
        "    def __init__(self, osd): self.osd, self.pgid, self.v = osd, pgid, 0\n"
        "    def whoami(self): return self.osd\n"
        "    def whoami_shard(self): return self.osd\n"
        "    def acting(self): return acting\n"
        "    def epoch(self): return 1\n"
        "    def next_version(self):\n"
        "        self.v += 1\n"
        "        return Eversion(1, self.v)\n"
        "    def send_shard(self, osd, msg): queue.append((osd, msg))\n"
        "pool = PgPool(id=1, name='p', type=POOL_TYPE_ERASURE, size=6, pg_num=1,\n"
        "              erasure_code_profile='p', stripe_width=4 * 4096)\n"
        "backends = []\n"
        "for osd in range(6):\n"
        "    store = MemStore()\n"
        "    store.queue_transaction(Transaction().create_collection(shard_coll(pgid, osd)))\n"
        "    backends.append(build_pg_backend(\n"
        "        pool, {'p': {'plugin': 'tpu', 'k': '4', 'm': '2'}}, L(osd), store, device='cpu'))\n"
        "def pump():\n"
        "    while True:\n"
        "        for b in backends: b.flush_encodes()\n"
        "        if not queue: return\n"
        "        osd, msg = queue.pop(0)\n"
        "        backends[osd].handle_message(msg)\n"
        "data, done, out = bytes(range(256)) * 256, [], {}\n"
        "backends[0].submit_transaction(PGTransaction('o').write(0, data), ReqId('c', 1),\n"
        "                               lambda: done.append(1))\n"
        "pump()\n"
        "backends[0].objects_read_and_reconstruct({'o': [(0, len(data))]}, out.update)\n"
        "pump()\n"
        "assert done == [1] and out['o'] == (0, [data]), out\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ceph_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_codec_plugins_import_leaves_jax_out():
    """Every codec plugin of the port (jerasure with both kinds of
    technique, isa, xor, shec, lrc, clay) encodes and decodes on the CPU
    without importing jax or the JAX package."""
    code = (
        "import sys\n"
        "from ceph_tpu_torch.codec import registry\n"
        "reg = registry.instance()\n"
        "for name, prof in [('jerasure', {'k': '4', 'm': '2'}),\n"
        "                   ('jerasure', {'technique': 'liberation', 'k': '4', 'w': '7',\n"
        "                                 'packetsize': '32'}),\n"
        "                   ('isa', {'k': '4', 'm': '2'}), ('xor', {'k': '4'}),\n"
        "                   ('shec', {'k': '4', 'm': '3', 'c': '2'}),\n"
        "                   ('lrc', {'k': '4', 'm': '2', 'l': '3'}),\n"
        "                   ('clay', {'k': '4', 'm': '2', 'd': '5'})]:\n"
        "    ec = reg.factory(name, prof, device='cpu')\n"
        "    n = ec.get_chunk_count()\n"
        "    enc = ec.encode(set(range(n)), bytes(range(256)) * 40)\n"
        "    got = ec.decode({1}, {i: c for i, c in enc.items() if i != 1}, len(enc[0]))\n"
        "    assert (got[1] == enc[1]).all(), name\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ceph_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_scrub_and_device_cache_import_leaves_jax_out():
    """The device chunk cache and the scrubber import neither jax nor the
    JAX package: a CPU cache puts, fetches and invalidates, and a
    ScrubResult is made."""
    code = (
        "import sys\n"
        "import numpy as np\n"
        "from ceph_tpu_torch.ops.device_cache import DeviceChunkCache, device_chunk_cache\n"
        "from ceph_tpu_torch.osd.scrubber import CHUNK_MAX, PgScrubber, ScrubResult\n"
        "from ceph_tpu_torch.ops import dispatch\n"
        "cache = DeviceChunkCache(max_bytes=1 << 16)\n"
        "data = np.arange(4096, dtype=np.uint32).astype(np.uint8)\n"
        "assert cache.put('o', 0, 1, data, device='cpu')\n"
        "assert (cache.fetch_many('o', [0], 1)[0] == data).all()\n"
        "assert cache.invalidate_object('o') == 1\n"
        "assert ScrubResult().clean and CHUNK_MAX == 25\n"
        "assert 'cache.hits' in dispatch.perf_dump() and device_chunk_cache().enabled\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ceph_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_bluestore_and_offload_services_import_leaves_jax_out():
    """The device compressor, the checksum service and BlueStore import
    neither jax nor the JAX package: a CPU BlueStore with the checksum
    offload and the device compressor writes and reads back an object."""
    code = (
        "import sys\n"
        "import ceph_tpu_torch.compressor.device\n"
        "import ceph_tpu_torch.os.bluestore\n"
        "from ceph_tpu_torch.ops.offload_runtime import offload_services\n"
        "from ceph_tpu_torch.os import BlueStore, Transaction\n"
        "s = BlueStore(None, compression='device', csum_offload=True, device='cpu')\n"
        "s.mount()\n"
        "s.queue_transaction(Transaction().create_collection('c'))\n"
        "data = (bytes(range(16)) + bytes(48)) * 1024\n"
        "s.queue_transaction(Transaction().write('c', 'o', 0, data))\n"
        "assert s.read('c', 'o') == data\n"
        "assert sorted(offload_services()) == ['compress', 'csum', 'decode', 'encode', 'verify']\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ceph_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_pg_layer_import_leaves_jax_out():
    """CRUSH, the OSDMap, peering and the PG import neither jax nor the
    JAX package: a replicated PG alone in its acting set peers, writes
    and reads back an object through do_op."""
    code = (
        "import sys\n"
        "from types import SimpleNamespace\n"
        "from ceph_tpu_torch.common.config import Config\n"
        "from ceph_tpu_torch.msg.messages import MOSDOp, OSDOp, ReqId\n"
        "from ceph_tpu_torch.os.memstore import MemStore\n"
        "from ceph_tpu_torch.osd.osdmap import OSDMap\n"
        "from ceph_tpu_torch.osd.pg import PG\n"
        "m = OSDMap()\n"
        "m.crush.build_flat(3)\n"
        "for o in range(3): m.add_osd(o)\n"
        "pool = m.create_pool('p', size=1, pg_num=4, crush_rule=m.crush.add_simple_rule('r'))\n"
        "ps = m.object_to_pg(pool.id, 'o')[1]\n"
        "acting = m.pg_to_up_acting_osds(pool.id, ps)[2]\n"
        "store = MemStore()\n"
        "store.mount()\n"
        "host = SimpleNamespace(whoami=acting[0], store=store, conf=Config(env=False),\n"
        "                       send_cluster=lambda osd, msg: None)\n"
        "pg = PG(host, pool, ps, {}, device='cpu')\n"
        "pg.on_new_interval(1, acting)\n"
        "out = []\n"
        "w = OSDOp(op=OSDOp.WRITEFULL, data=b'hello')\n"
        "pg.do_op(MOSDOp(reqid=ReqId('c', 1), pgid=pg.pgid, oid='o', ops=[w]), out.append)\n"
        "pg.do_op(MOSDOp(reqid=ReqId('c', 2), pgid=pg.pgid, oid='o', ops=[OSDOp(op=OSDOp.READ)]),\n"
        "         out.append)\n"
        "assert [r.result for r in out] == [0, 0] and out[1].outdata == [b'hello'], out\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ceph_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("host", ["torch_pg_host.py", "torch_daemon_host.py"])
def test_test_hosts_import_neither_package_by_name(host):
    """The in-process hosts that `chip_smoke.py` loads by path take the
    package's name and import by string: neither package by name."""
    for name in _imported_modules(ROOT / "tests" / host):
        assert name.split(".")[0] not in FORBIDDEN, f"{host} imports {name}"


def test_osd_daemon_import_leaves_jax_out():
    """The OSD daemon and every module under it (the messenger, cephx,
    MonClient, the admin socket, the op tracker, the recovery-storm
    controller) import neither jax nor the JAX package: an RS(2,1)
    cluster of three daemons boots over the inproc stack with cephx on,
    against the test-side map service, and serves a write and a read."""
    code = (
        "import asyncio, sys, tempfile\n"
        "sys.path.insert(0, 'tests')\n"
        "from torch_daemon_host import DaemonCluster\n"
        "async def main():\n"
        "    c = DaemonCluster('ceph_tpu_torch', 3, [dict(name='ec', kind='ec', k=2, m=1,\n"
        "                      pg_num=2, stripe_unit=4096)], device='cpu', keyring=True,\n"
        "                      root_dir=tempfile.mkdtemp())\n"
        "    try:\n"
        "        await c.start(30)\n"
        "        cl = c.client\n"
        "        assert (await cl.op('ec', 'o', [cl.osd_op('WRITEFULL', data=b'x' * 9000)])).result == 0\n"
        "        r = await cl.op('ec', 'o', [cl.osd_op('READ', off=0, len=0)])\n"
        "        assert r.result == 0 and r.outdata[0] == b'x' * 9000\n"
        "    finally:\n"
        "        await c.stop()\n"
        "asyncio.run(main())\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ceph_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_access_layers_import_leaves_jax_out():
    """RBD, rbd-mirror, the gateway's S3 and Swift front ends and the `fs`
    library import neither jax nor the JAX package."""
    code = (
        "import sys\n"
        "import ceph_tpu_torch.rbd, ceph_tpu_torch.rbd.mirror\n"
        "import ceph_tpu_torch.rgw, ceph_tpu_torch.rgw.http, ceph_tpu_torch.rgw.swift\n"
        "import ceph_tpu_torch.fs\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'ceph_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
