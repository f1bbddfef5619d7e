"""The port's offline tools against the JAX package's, on the CPU, and the
port's device-error policy for them (ROADMAP C31).

Differentials, the same seeded input to both packages:

- `ec_tool encode` writes the same chunk files, byte for byte, and
  `decode` the same decoded object, for RS(8,3) in both techniques,
  jerasure, isa and CLAY profiles;
- `ec_corpus --create --standard` writes the same ten directories, byte
  for byte;
- `bench_sweep --baseline --iterations 1` emits the same configs,
  workloads, erasure counts, `bytes_read`, `bytes_repaired`,
  `read_amplification` and stripes in flight (times are not compared);
- `bluestore_tool fsck [--deep]` and `show-label` print the same on a
  store the reference wrote and on one the port wrote, whichever
  package's tool reads it, clean and with a flipped byte;
- `export_chrome_trace` turns one JSON record list into equal traces.

Device errors: a `codec.launch` fault or a CUDA error ends `bench_sweep`
and `ec_corpus` with DEVICE_ERROR_EXIT and no recorded row, where the
reference's catch records a CUDA error as an `error` row and sweeps on;
a device error under `bluestore_tool fsck` is no onode's error.
"""

import filecmp
import json
import os

import numpy as np
import pytest
import torch

from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)
from torch_ported import cpu_tools  # noqa: F401 (fixture)

from ceph_tpu.os.bluestore import BlueStore as JBlueStore
from ceph_tpu.os.transaction import Transaction as JTransaction
from ceph_tpu.tools import bench_sweep as jbench_sweep
from ceph_tpu.tools import bluestore_tool as jbluestore_tool
from ceph_tpu.tools import ec_benchmark as jec_benchmark
from ceph_tpu.tools import ec_corpus as jec_corpus
from ceph_tpu.tools import ec_tool as jec_tool
from ceph_tpu.tools import trace_export as jtrace_export

from ceph_tpu_torch.codec.matrix_codec import EncodeAggregator
from ceph_tpu_torch.codec.rs import ErasureCodeTpuRs
from ceph_tpu_torch.common.fault_injector import global_injector
from ceph_tpu_torch.ops.flight_recorder import flight_recorder
from ceph_tpu_torch.ops.guard import device_guard
from ceph_tpu_torch.os.bluestore import BLOCK, BlueStore
from ceph_tpu_torch.os.transaction import Transaction
from ceph_tpu_torch.tools import bench_sweep, bluestore_tool, ec_benchmark, ec_corpus, ec_tool
from ceph_tpu_torch.tools import trace_export
from ceph_tpu_torch.tools.guarded import DEVICE_ERROR_EXIT


@pytest.fixture(autouse=True)
def _healthy_guard():
    yield
    global_injector().clear()
    device_guard().mark_healthy()


# -- ec_tool -----------------------------------------------------------------

PROFILES = [
    "plugin=tpu,technique=reed_sol_van,k=8,m=3",
    "plugin=tpu,technique=cauchy,k=8,m=3",
    "plugin=jerasure,technique=reed_sol_van,k=4,m=2",
    "plugin=isa,k=4,m=2",
    "plugin=clay,k=4,m=2,d=5",
]


@pytest.mark.parametrize("profile", PROFILES)
def test_ec_tool_encode_and_decode_write_the_same_files(tmp_path, profile):
    data = np.random.default_rng(7).integers(0, 256, 64 * 1024 + 37, np.uint8).tobytes()
    prof = dict(kv.split("=") for kv in profile.split(","))
    n = int(prof["k"]) + int(prof["m"])
    paths = []
    for tag, main, extra in (("port", ec_tool.main, ["--device", "cpu"]),
                             ("ref", jec_tool.main, [])):
        (tmp_path / tag).mkdir()
        path = str(tmp_path / tag / "obj")
        with open(path, "wb") as f:
            f.write(data)
        assert main([*extra, "encode", profile, "4096", "", path]) == 0
        for lost in (1, n - 1):
            os.unlink(f"{path}.{lost}")
        assert main([*extra, "decode", profile, "4096", "", path]) == 0
        assert main([*extra, "decode", profile, "4096", f"1,{n - 1}", path]) == 0
        paths.append(tmp_path / tag)
    names = sorted(os.listdir(paths[0]))
    assert names == sorted(os.listdir(paths[1]))
    assert len(names) == 1 + (n - 2) + 1 + 2
    match, mismatch, errors = filecmp.cmpfiles(paths[0], paths[1], names, shallow=False)
    assert not mismatch and not errors and len(match) == len(names)
    with open(paths[0] / "obj.decoded", "rb") as f:
        assert f.read()[: len(data)] == data


# -- ec_corpus ---------------------------------------------------------------


def test_ec_corpus_create_writes_the_same_directories(tmp_path):
    assert ec_corpus.main(["--create", "--standard", "--base", str(tmp_path / "port"),
                           "--device", "cpu"]) == 0
    assert jec_corpus.main(["--create", "--standard", "--base", str(tmp_path / "ref")]) == 0
    dirs = sorted(os.listdir(tmp_path / "port"))
    assert dirs == sorted(os.listdir(tmp_path / "ref"))
    assert len(dirs) == len(ec_corpus.STANDARD_CONFIGS) == len(jec_corpus.STANDARD_CONFIGS)
    for d in dirs:
        a, b = tmp_path / "port" / d, tmp_path / "ref" / d
        names = sorted(os.listdir(a))
        assert names == sorted(os.listdir(b)) and "content" in names
        match, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
        assert not mismatch and not errors, (d, mismatch, errors)
    # and both check each other's corpus clean
    assert ec_corpus.main(["--check", "--standard", "--base", str(tmp_path / "ref"),
                           "--device", "cpu"]) == 0
    assert jec_corpus.main(["--check", "--standard", "--base", str(tmp_path / "port")]) == 0


# -- bench_sweep -------------------------------------------------------------

_TIMED = ("seconds", "MBps")


def _rows(text: str) -> list[dict]:
    return [{k: v for k, v in json.loads(line).items() if k not in _TIMED}
            for line in text.strip().splitlines()]


def test_bench_sweep_baseline_emits_the_same_rows(capsys):
    assert bench_sweep.main(["--baseline", "--iterations", "1", "--device", "cpu"]) == 0
    ours = _rows(capsys.readouterr().out)
    assert jbench_sweep.main(["--baseline", "--iterations", "1"]) == 0
    theirs = _rows(capsys.readouterr().out)
    assert ours == theirs
    assert all("error" not in r and r["platform"] == "cpu" for r in ours)
    assert [r["erasures"] for r in ours if r["config"] == "rs_8_3_cauchy_1MiB"
            and r["workload"] == "decode"] == [1, 2, 3]
    clay = [r for r in ours if r["config"] == "clay_8_4_d11_subchunk_repair"]
    assert clay[0]["read_amplification"] == 2.75
    assert [r["stripes_in_flight"] for r in ours if r["workload"] == "bulk"] == [64]


def test_run_bulk_chains_each_launch_on_the_last_parity():
    """The bulk loop patches the batch in place from the previous launch's
    parity before each launch, as the reference's donated step does: each
    launch's first 128 bytes are the last parity's, xored with 1, so no
    launch repeats the one before it."""
    ec = ec_benchmark.make_codec(ec_benchmark.build_parser().parse_args(
        ["-p", "tpu", "-P", "k=4", "-P", "m=2", "--device", "cpu"]))
    ins, outs = [], []
    encode = ec.encode_array

    def spy(data, out=None):
        ins.append(data[0, 0, :128].clone())
        outs.append(encode(data, out=out))
        return outs[-1]

    ec.encode_array = spy
    seconds, total = bench_sweep.run_bulk(ec, 4 * 4096, 8, 3)
    assert seconds > 0 and total == 8 * 4 * 4096 * 3
    assert len(ins) == 2 + 3  # the first launch, the warm step, three timed
    for i in range(1, len(ins)):
        assert torch.equal(ins[i], outs[i - 1][0, 0, :128] ^ 1)
        assert not torch.equal(ins[i], ins[i - 1])


# -- bluestore_tool ----------------------------------------------------------


def _write_store(store_cls, txn_cls, path, **kw):
    s = store_cls(str(path), **kw)
    s.mount()
    txn = txn_cls().create_collection("1.0s0")
    rng = np.random.default_rng(5)
    for i in range(6):
        txn.touch("1.0s0", f"o{i}")
        txn.write("1.0s0", f"o{i}", 0, rng.integers(0, 256, BLOCK * (i + 1) + 100, np.uint8)
                  .tobytes())
    s.queue_transaction(txn)
    s.umount()


def _tool_outputs(path, capsys) -> list:
    out = []
    for main in (bluestore_tool.main, jbluestore_tool.main):
        for argv in (["--op", "fsck"], ["--op", "fsck", "--deep"], ["--op", "show-label"]):
            rc = main(["--path", str(path), *argv])
            out.append((rc, capsys.readouterr().out))
    return out


@pytest.mark.parametrize("writer", ["port", "ref", "port_csum_offload"])
def test_bluestore_tool_reads_either_package_store_alike(tmp_path, capsys, writer):
    path = tmp_path / "b"
    if writer == "ref":
        _write_store(JBlueStore, JTransaction, path)
    else:
        _write_store(BlueStore, Transaction, path, device="cpu",
                     csum_offload=writer == "port_csum_offload")
    out = _tool_outputs(path, capsys)
    assert out[:3] == out[3:]
    assert [rc for rc, _ in out[:3]] == [0, 0, 0]
    assert "6 onodes" in out[1][1] and "0 error(s)" in out[1][1]
    # a flipped byte: shallow fsck stays clean, deep fsck names the onode
    from ceph_tpu_torch.os.bluestore import _ONODE, Onode

    s = BlueStore(str(path))
    s.mount()
    poff = Onode.decode(s.db.get(_ONODE, "1.0s0\x00o3")).blocks[2][0]
    s.umount()
    with open(path / "block", "r+b") as f:
        f.seek(poff + 17)
        byte = f.read(1)
        f.seek(poff + 17)
        f.write(bytes([byte[0] ^ 0x40]))
    out = _tool_outputs(path, capsys)
    assert out[:3] == out[3:]
    assert [rc for rc, _ in out[:3]] == [0, 1, 0]
    assert "1 error(s)" in out[1][1] and "1.0s0/o3 block 2: csum mismatch" in out[1][1]


# -- trace_export ------------------------------------------------------------


def test_export_chrome_trace_equal_on_one_record_list():
    ec = ErasureCodeTpuRs(device="cpu")
    ec.init({"k": "4", "m": "2"})
    flight_recorder().reset()
    agg = EncodeAggregator(window=2)
    rng = np.random.default_rng(2)
    for t in [agg.submit(ec, rng.integers(0, 256, (2, 4, 512), dtype=np.uint8))
              for _ in range(4)]:
        t.result()
    ec.encode({0, 1, 2, 3, 4, 5}, rng.integers(0, 256, 4 * 4096, np.uint8).tobytes())
    flight_recorder().record_raw("encode", 4, 4096, devices=2)
    records = json.loads(json.dumps(flight_recorder().records()))
    wave = dict(records[0], kind="recovery_wave", group="storm:osd.3", seq=99)
    records.append(wave)
    clog = [{"stamp": 1.5, "msg": "osd.3 down", "channel": "cluster", "who": "mon.a",
             "prio": "warn"}, {"stamp": 2.0, "msg": "storm engaged", "channel": "audit",
                               "code": "TPU_STORM"}]
    ours = trace_export.export_chrome_trace(records, clog=clog)
    theirs = jtrace_export.export_chrome_trace(json.loads(json.dumps(records)), clog=clog)
    assert ours == theirs
    trace_export.validate_chrome_trace(ours)
    assert {e["pid"] for e in ours["traceEvents"]} >= {
        "devices", "aggregator", "hbm", "recovery storm", "cluster events"}
    flight_recorder().reset()


# -- device errors -----------------------------------------------------------


def test_codec_launch_fault_ends_bench_sweep_with_no_row(capsys):
    global_injector().inject("codec.launch", 5, hits=1)
    rc = bench_sweep.main(["--baseline", "--iterations", "1", "--device", "cpu"])
    captured = capsys.readouterr()
    assert rc == DEVICE_ERROR_EXIT
    assert captured.out == ""  # the first config's row is not recorded
    assert "bench_sweep: device error" in captured.err and "codec.launch" in captured.err
    assert device_guard().degraded


def test_cuda_error_ends_bench_sweep_where_the_reference_records_a_row(capsys, monkeypatch):
    def fail(ec, args):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(ec_benchmark, "run_encode", fail)
    monkeypatch.setattr(jec_benchmark, "run_encode", fail)
    monkeypatch.setattr(bench_sweep, "BASELINE_CONFIGS", bench_sweep.BASELINE_CONFIGS[:1])
    monkeypatch.setattr(jbench_sweep, "BASELINE_CONFIGS", jbench_sweep.BASELINE_CONFIGS[:1])
    assert jbench_sweep.main(["--baseline", "--iterations", "1"]) == 0
    theirs = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert [r["workload"] for r in theirs] == ["encode", "decode"]
    assert "CUDA error" in theirs[0]["error"]
    assert bench_sweep.main(["--baseline", "--iterations", "1", "--device", "cpu"]) == (
        DEVICE_ERROR_EXIT)
    assert capsys.readouterr().out == ""


def test_codec_error_is_still_a_row(capsys, monkeypatch):
    """A codec error is recorded and the sweep goes on, as in the
    reference."""
    from ceph_tpu_torch.codec.interface import EcError

    def fail(ec, args):
        raise EcError(22, "bad profile")

    monkeypatch.setattr(ec_benchmark, "run_encode", fail)
    monkeypatch.setattr(bench_sweep, "BASELINE_CONFIGS", bench_sweep.BASELINE_CONFIGS[:1])
    assert bench_sweep.main(["--baseline", "--iterations", "1", "--device", "cpu"]) == 0
    rows = [json.loads(line) for line in capsys.readouterr().out.splitlines()]
    assert "bad profile" in rows[0]["error"] and "error" not in rows[1]


def test_codec_launch_fault_ends_ec_corpus_check_with_no_failed_config(capsys):
    base = os.path.join(os.path.dirname(__file__), "corpus")
    global_injector().inject("codec.launch", 5, hits=1)
    rc = ec_corpus.main(["--check", "--standard", "--base", base, "--device", "cpu"])
    captured = capsys.readouterr()
    assert rc == DEVICE_ERROR_EXIT
    assert "FAIL" not in captured.err  # no config is read as failed
    assert "ec_corpus: device error" in captured.err
    # refused while the backend is DEGRADED, until it heals
    assert ec_corpus.main(["--check", "--standard", "--base", base, "--device", "cpu"]) == (
        DEVICE_ERROR_EXIT)
    assert "refused" in capsys.readouterr().err
    device_guard().mark_healthy()
    assert ec_corpus.main(["--check", "--standard", "--base", base, "--device", "cpu"]) == 0


def test_device_error_in_fsck_is_no_onode_error(tmp_path, capsys, monkeypatch):
    """The reference's fsck reports any exception of an onode's decode as
    that onode's error (`bluestore_tool.py:48`); the port's reports a
    device error as none: it ends the tool."""
    from ceph_tpu_torch.ops.guard import DeviceError
    from ceph_tpu_torch.os import bluestore as bluestore_mod

    _write_store(BlueStore, Transaction, tmp_path / "b", device="cpu")

    def fail(blob):
        raise DeviceError("device lost")

    monkeypatch.setattr(bluestore_mod.Onode, "decode", staticmethod(fail))
    assert bluestore_tool.main(["--path", str(tmp_path / "b"), "--op", "fsck"]) == (
        DEVICE_ERROR_EXIT)
    captured = capsys.readouterr()
    assert "undecodable" not in captured.out and "device lost" in captured.err


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a host without CUDA")
@pytest.mark.parametrize("tool,argv", [
    (ec_tool, ["validate-profile", "plugin=tpu,k=4,m=2"]),
    (ec_benchmark, ["-p", "tpu", "-P", "k=4", "-P", "m=2", "-S", "4096"]),
    (ec_corpus, ["--check", "--standard", "--base", "."]),
    (bench_sweep, ["--baseline", "--iterations", "1"]),
])
def test_the_tools_default_to_cuda(tool, argv, capsys):
    """With no `--device` every codec tool asks for cuda, and without a
    GPU it exits with DEVICE_ERROR_EXIT: nothing runs on the CPU unless
    asked."""
    assert tool.main(argv) == DEVICE_ERROR_EXIT
    captured = capsys.readouterr()
    assert "CUDA is not available" in captured.err and captured.out == ""
