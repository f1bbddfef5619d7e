"""The port's BlueStore, FileKV and FileStore on the CPU (`device="cpu"`),
held against the JAX package's under JAX_PLATFORMS=cpu.

Seeded transaction sequences (writes aligned and not, deferred and COW
overwrites, zero, truncate, clone, remove, xattrs, omap) run through a
store of each package, in memory and on disk, with compression off, zlib
and device, and the checksum offload off and on: after every transaction
the block file, the KV records and every read agree byte for byte, and so
do the checksum and compress launches.  Then WAL replay after a simulated
crash, a flipped block-file byte (EIO), the fused-csum hint, a store
written by one package mounted by the other, and fault C8: a failed
checksum or compress launch fails the transaction whole with EIO and
degrades the backend, with nothing recomputed on the host.  The reference
runs at dispatch width 1 (its tests run on an 8-device CPU mesh)."""

import os
import time
from types import SimpleNamespace

import numpy as np
import pytest

import ceph_tpu.compressor.device as j_dev
import ceph_tpu.ops.checksum_offload as j_co
import ceph_tpu.ops.dispatch as j_dispatch
import ceph_tpu.os.bluestore as j_bs
import ceph_tpu.os.filestore as j_fs
import ceph_tpu.os.kv as j_kv
import ceph_tpu.os.transaction as j_tx
from ceph_tpu.parallel import dispatch as jshard

import ceph_tpu_torch.compressor.device as t_dev
import ceph_tpu_torch.ops.checksum_offload as t_co
import ceph_tpu_torch.ops.dispatch as t_dispatch
import ceph_tpu_torch.os.bluestore as t_bs
import ceph_tpu_torch.os.filestore as t_fs
import ceph_tpu_torch.os.kv as t_kv
import ceph_tpu_torch.os.transaction as t_tx
from ceph_tpu_torch.codec.interface import EcError
from ceph_tpu_torch.common.errs import EIO
from ceph_tpu_torch.common.fault_injector import global_injector
from ceph_tpu_torch.ops.guard import device_guard

from torch_leak_gate import port_leak_gate  # noqa: F401  (autouse)

BLOCK = t_bs.BLOCK
PKG = {
    "jax": SimpleNamespace(bs=j_bs, tx=j_tx, kv=j_kv, fs=j_fs, co=j_co, dev=j_dev,
                           dispatch=j_dispatch, kw={}),
    "torch": SimpleNamespace(bs=t_bs, tx=t_tx, kv=t_kv, fs=t_fs, co=t_co, dev=t_dev,
                             dispatch=t_dispatch, kw={"device": "cpu"}),
}


@pytest.fixture(autouse=True)
def _pin_reference():
    settings = jshard.settings()
    jshard.configure(devices=1)
    yield
    jshard.configure(*settings)
    global_injector().clear()
    g = device_guard()
    g.mark_healthy()
    g.configure(timeout_ms=20000, probe_interval_ms=2000)


def make(pkg, path=None, **kw):
    s = PKG[pkg].bs.BlueStore(None if path is None else str(path), **kw, **PKG[pkg].kw)
    s.mount()
    if "c" not in s.list_collections():
        s.queue_transaction(PKG[pkg].tx.Transaction().create_collection("c"))
    return s


def block_image(s) -> bytes:
    if s.path is None:
        return s._block_f.getvalue()
    s._block_f.flush()
    with open(os.path.join(s.path, "block"), "rb") as f:
        return f.read()


def kv_records(s) -> dict:
    return dict(s.db._data)


def view(s) -> dict:
    """Every object's reads, size, xattrs and omap."""
    out = {}
    for oid in s.list_objects("c"):
        size = s.stat("c", oid)
        out[oid] = (size, s.read("c", oid), s.read("c", oid, size // 3, 5000),
                    s.getattrs("c", oid), s.omap_get("c", oid))
    return out


def launches(pkg) -> dict:
    p = PKG[pkg]
    return {"csum": int(p.co.default_csum_aggregator().perf.get("launches")),
            "compress": int(p.dev.default_compress_aggregator().perf.get("launches")),
            "dispatch": p.dispatch.LAUNCHES.snapshot()["launches"]}


def pattern(rng, kind, n):
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    if kind == "zeros":
        return bytes(n)
    # fixed-width records: 16 nonzero bytes in each 64
    rec = np.zeros((-(-n // 64), 64), dtype=np.uint8)
    rec[:, :16] = rng.integers(1, 256, (rec.shape[0], 16), dtype=np.uint8)
    return rec.tobytes()[:n]


def random_txns(seed, n=36):
    """`n` seeded transactions as (method, args) lists over four objects."""
    rng = np.random.default_rng(seed)
    oids = ["o0", "o1", "o2", "o3"]
    sizes = dict.fromkeys(oids, 0)
    txns = []
    for _ in range(n):
        ops = []
        for _ in range(int(rng.integers(1, 3))):
            oid = oids[int(rng.integers(4))]
            kind = ["big", "big", "small", "unaligned", "zero", "truncate", "clone",
                    "remove", "attr", "omap"][int(rng.integers(10))]
            data_kind = ["random", "zeros", "records"][int(rng.integers(3))]
            if kind == "big":  # COW, often past the offload size tests
                off = BLOCK * int(rng.integers(0, 4))
                data = pattern(rng, data_kind, BLOCK * int(rng.integers(1, 12)))
                ops.append(("write", ("c", oid, off, data)))
                sizes[oid] = max(sizes[oid], off + len(data))
            elif kind == "small" and sizes[oid]:  # deferred overwrite in place
                off = int(rng.integers(0, sizes[oid]))
                data = pattern(rng, data_kind, int(rng.integers(1, 3 * BLOCK)))
                ops.append(("write", ("c", oid, off, data)))
                sizes[oid] = max(sizes[oid], off + len(data))
            elif kind in ("small", "unaligned"):
                off = int(rng.integers(0, 5 * BLOCK))
                data = pattern(rng, data_kind, int(rng.integers(1, 9 * BLOCK)))
                ops.append(("write", ("c", oid, off, data)))
                sizes[oid] = max(sizes[oid], off + len(data))
            elif kind == "zero" and sizes[oid]:
                off = int(rng.integers(0, sizes[oid]))
                ops.append(("zero", ("c", oid, off, int(rng.integers(1, 2 * BLOCK)))))
            elif kind == "truncate":
                size = int(rng.integers(0, sizes[oid] + BLOCK))
                ops.append(("truncate", ("c", oid, size)))
                sizes[oid] = size
            elif kind == "clone" and sizes[oid]:
                dst = oids[int(rng.integers(4))]
                if dst != oid:
                    ops.append(("clone", ("c", oid, dst)))
                    sizes[dst] = sizes[oid]
            elif kind == "remove":
                ops.append(("remove", ("c", oid)))
                sizes[oid] = 0
            elif kind == "attr":
                ops.append(("setattr", ("c", oid, f"a{int(rng.integers(3))}",
                                        rng.bytes(int(rng.integers(0, 40))))))
                if rng.integers(2):
                    ops.append(("rmattr", ("c", oid, "a0")))
            else:
                ops.append(("omap_setkeys", ("c", oid, {f"k{int(rng.integers(5))}":
                                                       rng.bytes(8)})))
                if rng.integers(2):
                    ops.append(("omap_rmkeys", ("c", oid, ["k1", "k2"])))
        txns.append(ops)
    return txns


def build(pkg, ops):
    t = PKG[pkg].tx.Transaction()
    for name, args in ops:
        getattr(t, name)(*args)
    return t


def apply(s, pkg, ops):
    """queue_transaction; a StoreError (e.g. rmattr of a removed object)
    fails the transaction whole in both packages: report its errno."""
    try:
        s.queue_transaction(build(pkg, ops))
        return 0
    except PKG[pkg].bs.StoreError as e:
        return e.errno


def assert_same(stores):
    j, t = stores["jax"], stores["torch"]
    assert block_image(t) == block_image(j)
    assert kv_records(t) == kv_records(j)
    assert view(t) == view(j)


@pytest.mark.parametrize("disk", [False, True], ids=["mem", "disk"])
@pytest.mark.parametrize("compression", ["none", "zlib", "device"])
@pytest.mark.parametrize("offload", [False, True], ids=["host_csum", "csum_offload"])
def test_seeded_transactions_match_reference(tmp_path, disk, compression, offload):
    seed = {"none": 1, "zlib": 2, "device": 3}[compression] + 10 * offload + 100 * disk
    stores = {pkg: make(pkg, tmp_path / pkg if disk else None, compression=compression,
                        csum_offload=offload) for pkg in PKG}
    before = {pkg: launches(pkg) for pkg in PKG}
    for ops in random_txns(seed):
        errs = {pkg: apply(s, pkg, ops) for pkg, s in stores.items()}
        assert errs["torch"] == errs["jax"]
        assert_same(stores)
    moved = {pkg: {k: v - before[pkg][k] for k, v in launches(pkg).items()} for pkg in PKG}
    assert moved["torch"] == moved["jax"]
    if offload:
        assert moved["torch"]["csum"] > 0
    if compression == "device":
        assert moved["torch"]["compress"] > 0
        onodes = [t_bs.Onode.decode(blob)
                  for (prefix, _key), blob in kv_records(stores["torch"]).items()
                  if prefix == "O"]
        assert any(clen for o in onodes for _poff, _crc, clen in o.blocks.values())
    if disk:
        for s in stores.values():
            s.umount()
        assert (tmp_path / "torch" / "kv").read_bytes() == (tmp_path / "jax" / "kv").read_bytes()
        for pkg, s in stores.items():
            s.mount()
        assert_same(stores)
        for s in stores.values():
            s.umount()


@pytest.mark.parametrize("offload", [False, True], ids=["host_csum", "csum_offload"])
def test_wal_replay_after_simulated_crash(tmp_path, offload):
    """A crash between the KV commit and the deferred block writes: mount
    replays the WAL, in both packages alike."""
    stores = {pkg: make(pkg, tmp_path / pkg, csum_offload=offload) for pkg in PKG}
    base = np.random.default_rng(5).integers(0, 256, 8 * BLOCK, dtype=np.uint8).tobytes()
    for pkg, s in stores.items():
        s.queue_transaction(build(pkg, [("write", ("c", "o", 0, base))]))
        s._crash_point = "after_commit"
        with pytest.raises(PKG[pkg].bs.SimulatedCrash):
            s.queue_transaction(build(pkg, [("write", ("c", "o", 100, b"\x5a" * 3000))]))
        assert any(k[0] == "W" for k in s.db._data)
        s._block_f.close()
        s.db.close()
    expect = bytearray(base)
    expect[100:3100] = b"\x5a" * 3000
    again = {pkg: make(pkg, tmp_path / pkg, csum_offload=offload) for pkg in PKG}
    for s in again.values():
        assert s.read("c", "o") == bytes(expect)
        assert not any(k[0] == "W" for k in s.db._data)
    assert_same(again)
    for s in again.values():
        s.umount()


@pytest.mark.parametrize("offload", [False, True], ids=["host_csum", "csum_offload"])
def test_flipped_block_byte_is_eio(tmp_path, offload):
    s = make("torch", tmp_path, csum_offload=offload)
    data = np.random.default_rng(6).integers(0, 256, 8 * BLOCK, dtype=np.uint8).tobytes()
    s.queue_transaction(build("torch", [("write", ("c", "o", 0, data))]))
    poff = s._peek_onode("c", "o").blocks[3][0]
    s.umount()
    with open(tmp_path / "block", "r+b") as f:
        f.seek(poff + 77)
        byte = f.read(1)
        f.seek(poff + 77)
        f.write(bytes([byte[0] ^ 0x10]))
    s = make("torch", tmp_path, csum_offload=offload)
    with pytest.raises(t_bs.StoreError) as e:
        s.read("c", "o")
    assert e.value.errno == -EIO
    assert s.read("c", "o", 0, 3 * BLOCK) == data[: 3 * BLOCK]
    s.umount()


@pytest.mark.parametrize("writer", ["jax", "torch"])
@pytest.mark.parametrize("compression", ["none", "device"])
def test_store_written_by_one_package_mounts_in_the_other(tmp_path, writer, compression):
    """The on-disk store is the state carried across: a BlueStore, its
    FileKV alone, and a FileStore written by one package mount in the
    other and read back byte for byte, every csum verified."""
    reader = "torch" if writer == "jax" else "jax"
    s = make(writer, tmp_path / "bs", compression=compression)
    for ops in random_txns(21 if writer == "jax" else 22, n=20):
        apply(s, writer, ops)
    model = view(s)
    image, records = block_image(s), kv_records(s)
    s.umount()
    r = make(reader, tmp_path / "bs", compression=compression, csum_offload=True)
    assert view(r) == model
    assert block_image(r) == image and kv_records(r) == records
    r.queue_transaction(build(reader, [("write", ("c", "new", 0, b"n" * 9000))]))
    r.umount()
    s = make(writer, tmp_path / "bs", compression=compression)
    assert s.read("c", "new") == b"n" * 9000
    s.umount()
    # FileKV alone, with a batch and a compaction
    kv = PKG[writer].kv.FileKV(str(tmp_path / "kv" / "log"))
    kv.COMPACT_RATIO = 1
    for i in range(40):
        kv.set("p", f"k{i % 7}", bytes([i]) * i)
    kv.apply_batch([(1, "q", "a", b"1"), (2, "p", "k3", b"")])
    want = {p: list(kv.iterate(p)) for p in ("p", "q")}
    kv.close()
    other = PKG[reader].kv.FileKV(str(tmp_path / "kv" / "log"))
    assert {p: list(other.iterate(p)) for p in ("p", "q")} == want
    other.close()
    # FileStore
    fs = PKG[writer].fs.FileStore(str(tmp_path / "fs"))
    fs.mount()
    fs.queue_transaction(build(writer, [("create_collection", ("c",))]))
    fs.queue_transaction(build(writer, [("write", ("c", "o", 10, b"abc" * 999)),
                                        ("setattr", ("c", "o", "x", b"y")),
                                        ("omap_setkeys", ("c", "o", {"k": b"v"}))]))
    fs.umount()
    ofs = PKG[reader].fs.FileStore(str(tmp_path / "fs"))
    ofs.mount()
    assert ofs.read("c", "o") == b"\x00" * 10 + b"abc" * 999
    assert ofs.getattrs("c", "o") == {"x": b"y"} and ofs.omap_get("c", "o") == {"k": b"v"}
    ofs.umount()


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_fused_csums_are_trusted_only_for_aligned_raw_blocks(pkg):
    """The EC-transaction fusion hint: an aligned raw write takes the fused
    digests (csum_fused_blocks), an unaligned one and a compressed stored
    form compute their own, and `tobytes` drops the hint."""
    p = PKG[pkg]
    data = np.random.default_rng(8).integers(0, 256, 4 * BLOCK, dtype=np.uint8).tobytes()
    digests = np.array([t_co.crc32c(data[i:i + BLOCK]) for i in range(0, len(data), BLOCK)],
                       dtype=np.uint32)
    s = make(pkg, csum_offload=True)
    s.queue_transaction(p.tx.Transaction().write("c", "a", 0, data, csums=digests))
    assert s.csum_fused_blocks == 4
    s.queue_transaction(p.tx.Transaction().write("c", "b", 100, data, csums=digests))
    assert s.csum_fused_blocks == 4
    z = make(pkg, compression="zlib", csum_offload=True)
    z.queue_transaction(p.tx.Transaction().write("c", "a", 0, bytes(4 * BLOCK),
                                                 csums=np.zeros(4, np.uint32)))
    assert z.csum_fused_blocks == 0 and z.read("c", "a") == bytes(4 * BLOCK)
    assert s.read("c", "a") == data and s.read("c", "b", 100) == data
    t = p.tx.Transaction().write("c", "a", 0, data, csums=digests)
    assert p.tx.Transaction.frombytes(t.tobytes()).ops[0].csums is None


@pytest.mark.parametrize("what", ["csum", "compress"])
def test_failed_offload_launch_fails_the_transaction_whole(what):
    """Fault C8: a checksum or compress launch that fails raises EIO out of
    queue_transaction with nothing committed, the backend goes DEGRADED,
    nothing is recomputed on the host, and once a probe heals the guard
    the same transaction commits."""
    kw = {"csum_offload": True} if what == "csum" else {"compression": "device"}
    s = make("torch", **kw)
    first = pattern(np.random.default_rng(9), "records", 12 * BLOCK)
    s.queue_transaction(build("torch", [("write", ("c", "o", 0, first))]))
    image, records = block_image(s), kv_records(s)
    fb0 = t_dispatch.FALLBACK_LAUNCHES.snapshot()["launches"]
    device_guard().configure(probe_interval_ms=10_000_000)
    global_injector().inject("codec.launch", 5, hits=1)
    second = pattern(np.random.default_rng(10), "records", 12 * BLOCK)
    with pytest.raises(EcError) as e:
        s.queue_transaction(build("torch", [("write", ("c", "o", 0, second)),
                                            ("setattr", ("c", "o", "v", b"2"))]))
    assert e.value.errno == -EIO
    assert device_guard().degraded
    assert block_image(s)[: len(image)] == image and kv_records(s) == records
    # refused while DEGRADED (the probe fails: no card): EIO again
    with pytest.raises(EcError):
        s.queue_transaction(build("torch", [("write", ("c", "o", 0, second))]))
    assert t_dispatch.FALLBACK_LAUNCHES.snapshot()["launches"] == fb0
    device_guard().configure(probe_interval_ms=1)
    time.sleep(0.01)
    assert device_guard().maybe_probe(lambda: None) and not device_guard().degraded
    assert s.read("c", "o") == first and s.getattrs("c", "o") == {}
    s.queue_transaction(build("torch", [("write", ("c", "o", 0, second))]))
    assert s.read("c", "o") == second


def test_failed_csum_launch_fails_the_read():
    s = make("torch", csum_offload=True)
    data = np.random.default_rng(11).integers(0, 256, 8 * BLOCK, dtype=np.uint8).tobytes()
    s.queue_transaction(build("torch", [("write", ("c", "o", 0, data))]))
    global_injector().inject("codec.launch", 5, hits=1)
    with pytest.raises(EcError):
        s.read("c", "o")
    assert device_guard().degraded
    device_guard().mark_healthy()
    assert s.read("c", "o") == data


def test_make_store_selects_the_backend(tmp_path):
    conf = {"osd_objectstore": "bluestore", "osd_data": str(tmp_path / "b"),
            "bluestore_compression_algorithm": "zlib",
            "bluestore_compression_required_ratio": 0.5, "bluestore_csum_offload": True}
    s = t_bs.make_store(conf, device="cpu")
    assert isinstance(s, t_bs.BlueStore) and s._csum_offload and s._required_ratio == 0.5
    assert isinstance(t_bs.make_store({"osd_objectstore": "filestore",
                                       "osd_data": str(tmp_path / "f")}), t_fs.FileStore)
    assert type(t_bs.make_store({})).__name__ == "MemStore"
    with pytest.raises(ValueError):
        t_bs.make_store({"osd_objectstore": "filestore"})
