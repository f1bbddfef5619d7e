"""The port's static analysis (`ceph_tpu_torch/analysis/`), on the CPU.

- The reference's `tests/test_static_analysis.py`, every class, runs on
  the port through `torch_ported.load`: the seeded trip-and-twin
  fixtures of each pass, the allowlist contracts, the CLI's exit codes,
  the live gate over `ceph_tpu_torch/` with the port's allowlists, and
  the lockdep replay of the aggregated encode stack (`cpu_tools` makes
  the codec's default device the CPU for it).  No case is set aside.
- A differential: both packages' passes over one set of seeded trees,
  which hold the reference's trip-and-twin snippets of every pass; the
  findings agree by pass id and key.
- The port's own idioms, each with a snippet that must trip its pass
  and the twins that must not: a device error swallowed in a broad
  handler, a torch device wait under a lockdep lock, an untracked device
  placement kept on an object or in a module cache, a read of the buffer
  handed to `_dispatch` or to `encode_array(out=)`, and side effects in
  `torch.compile` bodies and CUDA-graph captures.  Each trips the CLI
  too (`python -m ceph_tpu_torch.analysis --root <tree>` exits 1).
- The live tree: all six passes run, nothing is open or stale, every
  allowlist entry is the port's, and none of the bare locks this slice
  routed through `common/lockdep.py` is back.
"""

from __future__ import annotations

import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import ceph_tpu.analysis as ref_analysis
import ceph_tpu.analysis.passes as ref_passes
from ceph_tpu.analysis.passes.options_coherence import (
    OptionsCoherencePass as RefOptionsPass,
)
from ceph_tpu_torch import analysis
from ceph_tpu_torch.analysis import ALLOWLIST_DIR, SourceTree, load_allowlist, run_analysis
from ceph_tpu_torch.analysis.passes import ALL_PASSES, PASS_BY_ID
from ceph_tpu_torch.analysis.passes.donation import DonationLifetimePass
from ceph_tpu_torch.analysis.passes.exceptions import ExceptionSwallowPass
from ceph_tpu_torch.analysis.passes.ledger import LedgerDisciplinePass
from ceph_tpu_torch.analysis.passes.locks import LockDisciplinePass
from ceph_tpu_torch.analysis.passes.options_coherence import OptionsCoherencePass
from ceph_tpu_torch.analysis.passes.purity import JitPurityPass
from test_torch_isolation import PORT_FILES
from torch_ported import collect, cpu_tools, load  # noqa: F401 (fixture)

ROOT = Path(__file__).resolve().parents[1]

_sa = load("test_static_analysis")
collect(_sa, ["TestDonationPass", "TestPurityPass", "TestExceptionPass", "TestLockPass",
              "TestOptionsPass", "TestLedgerPass", "TestAllowlist", "TestCli",
              "TestLiveTreeGate"], globals())


@pytest.mark.usefixtures("cpu_tools")
class TestLockdepStackRegression_torch(_sa.TestLockdepStackRegression):
    """The replay's codec is made with no device: on the CPU here."""


def _tree(tmp_path: Path, files: dict[str, str], tree_cls=SourceTree):
    root = tmp_path / "pkg"
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return tree_cls(root, repo_root=tmp_path)


def _keys(findings) -> set[str]:
    return {f.key for f in findings}


# -- the differential --------------------------------------------------------

# The reference's trip-and-twin snippets of every pass (its
# tests/test_static_analysis.py), one tree each.
DIFF_TREES = {
    "donation-trip": {"ops/k.py": """
        import functools, jax

        @functools.partial(jax.jit, donate_argnums=(0,))
        def step(buf):
            return buf + 1

        def caller(buf):
            out = step(buf)
            return buf.sum()
    """},
    "donation-rebind": {"ops/k.py": """
        import functools, jax

        @functools.partial(jax.jit, donate_argnums=(0,))
        def step(buf):
            return buf + 1

        def caller(buf):
            buf = step(buf)
            return buf.sum()
    """},
    "donation-sibling": {"ops/k.py": """
        import jax

        def caller(f, buf, fast):
            if fast:
                exe = jax.jit(f, donate_argnums=(0,))
                out = exe(buf)
            else:
                out = f(buf)
            return out
    """},
    "donation-factory": {"parallel/s.py": """
        def caller(build, placed):
            result = build(donate=True)(placed)
            return placed[0]
    """},
    "donation-runtime": {"ops/offload_runtime.py": """
        import functools, jax

        @functools.partial(jax.jit, donate_argnums=(0,))
        def launch(buf):
            return buf + 1

        def reap(buf):
            out = launch(buf)
            return buf.nbytes
    """},
    "donation-compressor": {"compressor/device.py": """
        import functools, jax

        @functools.partial(jax.jit, donate_argnums=(0,))
        def transform(rows):
            return rows + 1

        def compress_batch(rows):
            out = transform(rows)
            return rows.sum()
    """},
    **{f"purity-{what}": {"ops/k.py": f"""
        import time, jax
        import numpy as np

        @jax.jit
        def kernel(x, lock=None, counters=None):
            {body}
            return x
    """} for what, body in [
        ("clock", "t = time.time()"), ("rng", "r = np.random.random()"),
        ("lock", "lock.acquire()"), ("faultpoint", "faultpoint('codec.launch')"),
        ("counter", "counters.inc('launches')")]},
    "purity-pure": {"ops/k.py": """
        import jax
        import jax.numpy as jnp

        @jax.jit
        def kernel(x):
            return jnp.sum(x ^ jnp.uint8(3))
    """},
    "purity-out-of-scope": {"mgr/m.py": """
        import time, jax

        @jax.jit
        def kernel(x):
            return time.time()
    """},
    "purity-wrapped": {"codec/c.py": """
        import time, jax

        def build():
            def local(x):
                time.monotonic()
                return x
            return jax.jit(local)
    """},
    "exceptions-silent": {"osd/x.py": """
        def f(store):
            try:
                return store.read()
            except Exception:
                pass
    """},
    **{f"exceptions-traced-{i}": {"osd/x.py": f"""
        def f(store, perf, guard, dout, errors=0):
            try:
                return store.read()
            except Exception as e:
                {handler}
    """} for i, handler in enumerate([
        "raise", "dout('osd', 1, 'boom')", "perf.inc('errors')", "errors += 1",
        "return repr(e)", "guard.mark_degraded('x')"])},
    "exceptions-narrow": {"osd/x.py": """
        def f(store):
            try:
                return store.read()
            except KeyError:
                pass
    """},
    **{f"locks-bare-{i}": {"ops/x.py": f"""
        import asyncio, threading

        class C:
            def __init__(self):
                self._lock = {ctor}
    """} for i, ctor in enumerate([
        "threading.Lock()", "threading.RLock()", "asyncio.Lock()", "threading.Condition()"])},
    "locks-factory": {"ops/x.py": """
        from ceph_tpu.common.lockdep import make_lock

        class C:
            def __init__(self):
                self._lock = make_lock("c")
    """},
    "locks-condition": {"ops/x.py": """
        import threading
        from ceph_tpu.common.lockdep import make_lock

        cv = threading.Condition(make_lock("cv"))
    """},
    "locks-wait": {"ops/x.py": """
        def f(self, buf):
            with self._lock:
                jax.block_until_ready(buf)
    """},
    "options": {
        "common/options.py": "OPTIONS = {}\n",
        "osd/daemon.py": """
            class D:
                def __init__(self, conf):
                    self.a = conf.get("knob_rt_initonly")
                    self.b = conf.get("knob_rt_wired")
                    conf.add_observer(["knob_rt_wired"], lambda n, v: None)

                def serve(self, conf):
                    return conf.get("knob_read")

                def typo(self, conf):
                    return conf.get("knob_typod")
        """,
    },
    "ledger-untracked": {"ops/stage.py": """
        import jax

        def stage(arr):
            return jax.device_put(arr)
    """},
    "ledger-runtime": {"ops/offload_runtime.py": """
        import jax

        def dispatch(batch):
            return jax.device_put(batch)
    """},
    "ledger-compressor": {"compressor/device.py": """
        import jax

        def transform_rows_device(rows):
            return jax.device_put(rows)
    """},
    "ledger-wrapped": {"parallel/place.py": """
        import jax
        from ceph_tpu.common.mempool import track_buffer

        def place(arr, sharding):
            return track_buffer(jax.device_put(arr, sharding), "sharded_placement")
    """},
    "ledger-alloc": {"ops/cache.py": """
        import jax

        def put(self, arr):
            buf = jax.device_put(arr)
            self.mem = ledger().alloc("device_cache", arr.nbytes, buf=buf)
            return buf
    """},
    "ledger-unrelated-alloc": {"ops/arena.py": """
        import jax

        def stage(self, arr):
            slot = self.arena.alloc(arr.nbytes)
            return jax.device_put(arr)
    """},
    "ledger-sibling": {"ops/mixed.py": """
        import jax
        from ceph_tpu.common.mempool import track_buffer

        def stage(a, b):
            placed = track_buffer(jax.device_put(a), "scratch")
            return placed, jax.device_put(b)
    """},
    "ledger-keyword": {"ops/kw.py": """
        import jax
        from ceph_tpu.common.mempool import track_buffer

        def place(arr):
            return track_buffer(buf=jax.device_put(arr))
    """},
    "ledger-out-of-scope": {"mgr/module.py": """
        import jax

        def stage(arr):
            return jax.device_put(arr)
    """},
}

# the twins: no finding in either package
DIFF_CLEAN = {"donation-rebind", "donation-sibling", "purity-pure", "purity-out-of-scope",
              "exceptions-narrow", "locks-factory", "locks-condition", "ledger-wrapped",
              "ledger-alloc", "ledger-keyword", "ledger-out-of-scope",
              *(f"exceptions-traced-{i}" for i in range(6))}

SYNTHETIC_OPTIONS = {
    "knob_read": {"runtime": False},
    "knob_unread": {"runtime": False},
    "knob_rt_wired": {"runtime": True},
    "knob_rt_initonly": {"runtime": True},
}


def _findings(pkg_passes, options_pass, tree) -> set[tuple[str, str]]:
    """Every pass's findings; config-coherence on the synthetic table, and
    only over the tree that has an options module (over any other tree
    each synthetic knob would read as unread in both packages)."""
    out = set()
    for p in pkg_passes:
        if p.PASS_ID == "config-coherence":
            if not (tree.root / "common" / "options.py").is_file():
                continue
            p = options_pass
        out |= {(f.pass_id, f.key) for f in p(tree)}
    return out


@pytest.mark.parametrize("name", sorted(DIFF_TREES))
def test_both_packages_find_the_same(tmp_path, name):
    files = DIFF_TREES[name]
    ref = _findings(ref_passes.ALL_PASSES, RefOptionsPass(options=dict(SYNTHETIC_OPTIONS)),
                    _tree(tmp_path / "ref", files, ref_analysis.SourceTree))
    port = _findings(ALL_PASSES, OptionsCoherencePass(options=dict(SYNTHETIC_OPTIONS)),
                     _tree(tmp_path / "port", files))
    assert port == ref
    assert bool(port) != (name in DIFF_CLEAN), (name, port)


# -- the port's own idioms ---------------------------------------------------

DEVICE_MODULE = """
    import torch
    from .guard import is_device_error

    def f(store, dout):
        try:
            return store.read()
        except Exception as e:
            {handler}
"""


class TestDeviceErrorRule:
    def test_logged_device_error_trips_device_key(self, tmp_path):
        tree = _tree(tmp_path, {"osd/x.py": DEVICE_MODULE.format(
            handler="dout('osd', 1, f'read failed {e!r}')")})
        assert _keys(ExceptionSwallowPass()(tree)) == {"pkg/osd/x.py::f::device"}

    def test_silent_swallow_trips_both_keys(self, tmp_path):
        tree = _tree(tmp_path, {"osd/x.py": DEVICE_MODULE.format(handler="pass")})
        assert _keys(ExceptionSwallowPass()(tree)) == {"pkg/osd/x.py::f",
                                                       "pkg/osd/x.py::f::device"}

    @pytest.mark.parametrize("handler", [
        "if is_device_error(e):\n                raise\n            dout('osd', 1, 'x')",
        "if is_device_error(e):\n                self._device_fails(e)\n            dout('osd', 1, 'x')",
        "dout('osd', 1, 'x')\n            return -errno.EIO",
    ], ids=["reraise", "hook", "eio"])
    def test_three_correct_forms_pass(self, tmp_path, handler):
        tree = _tree(tmp_path, {"osd/x.py": DEVICE_MODULE.format(handler=handler)})
        assert ExceptionSwallowPass()(tree) == []

    def test_reach_is_transitive_through_imports(self, tmp_path):
        tree = _tree(tmp_path, {
            "ops/k.py": "import torch\n",
            "ops/__init__.py": "",
            "osd/__init__.py": "",
            "osd/x.py": """
                from ..ops import k

                def f(store, dout):
                    try:
                        return store.read()
                    except Exception as e:
                        dout('osd', 1, repr(e))
            """,
            "mgr/y.py": """
                def f(store, dout):
                    try:
                        return store.read()
                    except Exception as e:
                        dout('mgr', 1, repr(e))
            """,
        })
        assert _keys(ExceptionSwallowPass()(tree)) == {"pkg/osd/x.py::f::device"}

    def test_plain_allowlist_entry_does_not_cover_the_device_key(self, tmp_path):
        tree = _tree(tmp_path, {"osd/x.py": DEVICE_MODULE.format(handler="pass")})
        adir = tmp_path / "allow"
        adir.mkdir()
        (adir / "exception-swallowing.allow").write_text(
            "pkg/osd/x.py::f | fixture: the plain silence is the point\n")
        report = run_analysis(tree, passes=[ExceptionSwallowPass()], allowlist_dir=adir)
        assert not report["ok"]
        assert [f["key"] for f in report["findings"]] == ["pkg/osd/x.py::f::device"]


class TestTorchDeviceWaits:
    @pytest.mark.parametrize("wait,attr", [
        ("event.synchronize()", "synchronize"),
        ("torch.cuda.synchronize()", "synchronize"),
        ("stream.synchronize()", "synchronize"),
        ("host = parity.cpu()", "cpu"),
        ("n = count.item()", "item"),
        ("rows = table.tolist()", "tolist"),
    ])
    def test_wait_under_lockdep_lock_trips(self, tmp_path, wait, attr):
        tree = _tree(tmp_path, {"ops/x.py": f"""
            import torch
            from ceph_tpu_torch.common.lockdep import make_lock

            class G:
                def __init__(self):
                    self.lock = make_lock("g")

                def settle(self, event, stream, parity, count, table):
                    with self.lock:
                        {wait}
        """})
        assert _keys(LockDisciplinePass()(tree)) == {f"pkg/ops/x.py::G.settle::wait.{attr}"}

    def test_wait_outside_the_lock_passes(self, tmp_path):
        tree = _tree(tmp_path, {"ops/x.py": """
            from ceph_tpu_torch.common.lockdep import make_lock

            class G:
                def __init__(self):
                    self.lock = make_lock("g")

                def settle(self, event, parity):
                    with self.lock:
                        ready = event.query()
                    event.synchronize()
                    return ready, parity.cpu()
        """})
        assert LockDisciplinePass()(tree) == []


class TestTorchPlacements:
    def test_kept_untracked_placement_trips(self, tmp_path):
        tree = _tree(tmp_path, {"ops/plan.py": """
            import torch

            class Plan:
                def __init__(self, masks):
                    self.masks = torch.from_numpy(masks).to("cuda")
        """})
        assert _keys(LedgerDisciplinePass()(tree)) == {"pkg/ops/plan.py::Plan.__init__::place.to"}

    @pytest.mark.parametrize("wrapper", ["track_buffer", "track_placement"])
    def test_track_buffer_twin_passes(self, tmp_path, wrapper):
        tree = _tree(tmp_path, {"ops/plan.py": f"""
            import torch
            from ceph_tpu_torch.common.mempool import {wrapper}

            class Plan:
                def __init__(self, masks, device):
                    self.masks = {wrapper}(torch.from_numpy(masks).to(device), "scratch")
        """})
        assert LedgerDisciplinePass()(tree) == []

    def test_track_placement_charges_only_off_the_host(self):
        import torch

        from ceph_tpu_torch.common.mempool import ledger, track_placement

        led = ledger()
        base = led.current_bytes("scratch")
        host = torch.ones(4096, dtype=torch.uint8)
        assert track_placement(host, "scratch", site="test host") is host
        assert led.current_bytes("scratch") == base
        off = track_placement(torch.empty(4096, dtype=torch.uint8, device="meta"),
                              "scratch", site="test meta")
        assert led.current_bytes("scratch") == base + 4096
        del off
        import gc

        gc.collect()
        assert led.current_bytes("scratch") == base

    def test_cached_through_a_local_trips(self, tmp_path):
        tree = _tree(tmp_path, {"codec/tables.py": """
            import torch

            _TABLES = {}

            def tables(host, device):
                dev = _TABLES.get(str(device))
                if dev is None:
                    dev = torch.as_tensor(host, device=device)
                    _TABLES[str(device)] = dev
                return dev

            def operand(self, host, device):
                t = host.cuda()
                return self._dev.setdefault(device, t)
        """})
        assert _keys(LedgerDisciplinePass()(tree)) == {
            "pkg/codec/tables.py::tables::place.as_tensor",
            "pkg/codec/tables.py::operand::place.cuda",
        }

    def test_transient_scratch_passes(self, tmp_path):
        tree = _tree(tmp_path, {"compressor/device.py": """
            import torch

            def dispatch(self, g, data):
                dev = torch.from_numpy(data).to(g.device)
                out = transform(dev)
                return out.to(torch.uint8)
        """})
        assert LedgerDisciplinePass()(tree) == []


class TestTorchDonation:
    def test_read_of_donate_after_dispatch_trips(self, tmp_path):
        tree = _tree(tmp_path, {"ops/offload_runtime.py": """
            class A:
                def launch(self, g, data, donate):
                    out = self._dispatch(g, data, donate)
                    return out, donate.sum()
        """})
        assert _keys(DonationLifetimePass()(tree)) == {"pkg/ops/offload_runtime.py::A.launch::donate"}

    def test_rebind_twin_passes(self, tmp_path):
        tree = _tree(tmp_path, {"ops/offload_runtime.py": """
            class A:
                def launch(self, g, data, donate):
                    donate = self._dispatch(g, data, donate)
                    return donate.sum()
        """})
        assert DonationLifetimePass()(tree) == []

    def test_read_of_out_after_encode_array_trips(self, tmp_path):
        tree = _tree(tmp_path, {"codec/c.py": """
            def encode(ec, data, buf):
                parity = ec.encode_array(data, out=buf)
                return buf[0]
        """})
        assert _keys(DonationLifetimePass()(tree)) == {"pkg/codec/c.py::encode::buf"}


class TestTorchTracing:
    @pytest.mark.parametrize("wrap", ["@torch.compile", "@torch.jit.script"])
    def test_side_effect_in_compiled_body_trips(self, tmp_path, wrap):
        tree = _tree(tmp_path, {"ops/k.py": f"""
            import time, torch

            {wrap}
            def kernel(x):
                time.time()
                return x
        """})
        assert JitPurityPass()(tree)

    def test_side_effect_in_graph_capture_trips(self, tmp_path):
        tree = _tree(tmp_path, {"ops/k.py": """
            import torch

            def capture(g, x, counters):
                with torch.cuda.graph(g):
                    counters.inc("launches")
                    y = x * 2
                return y
        """})
        assert _keys(JitPurityPass()(tree)) == {"pkg/ops/k.py::capture::perf-counter .inc"}

    def test_re_compile_is_not_traced(self, tmp_path):
        tree = _tree(tmp_path, {"ops/k.py": """
            import re, time

            def pattern():
                def local(x):
                    time.time()
                    return x
                return re.compile(local)
        """})
        assert JitPurityPass()(tree) == []


TORCH_SEEDS = {
    "exception-swallowing": ("osd/x.py", DEVICE_MODULE.format(handler="dout('osd', 1, 'x')")),
    "lock-discipline": ("ops/x.py", """
        from ceph_tpu_torch.common.lockdep import make_lock

        _LOCK = make_lock("l")

        def f(event):
            with _LOCK:
                event.synchronize()
    """),
    "ledger-discipline": ("ops/x.py", """
        import torch

        class P:
            def __init__(self, a):
                self.t = torch.from_numpy(a).cuda()
    """),
    "donation-lifetime": ("ops/x.py", """
        def f(self, g, data, donate):
            out = self._dispatch(g, data, donate)
            return donate
    """),
    "jit-purity": ("ops/x.py", """
        import time, torch

        @torch.compile
        def k(x):
            time.time()
            return x
    """),
    "config-coherence": ("osd/x.py", """
        def f(conf):
            return conf.get("no_such_knob_xyz")
    """),
}


@pytest.mark.parametrize("pass_id", sorted(TORCH_SEEDS))
def test_cli_exits_nonzero_on_each_torch_seed(tmp_path, pass_id):
    rel, src = TORCH_SEEDS[pass_id]
    p = tmp_path / "pkg" / rel
    p.parent.mkdir(parents=True)
    p.write_text(textwrap.dedent(src))
    r = subprocess.run([sys.executable, "-m", "ceph_tpu_torch.analysis", "--root",
                        str(tmp_path / "pkg"), "--pass", pass_id],
                       capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert r.returncode == 1, (r.stdout, r.stderr)
    assert pass_id in r.stdout


# -- the live tree -------------------------------------------------------------

# the bare locks this slice routed through common/lockdep.py
ROUTED_LOCKS = [
    "codec/registry.py::ErasureCodePluginRegistry::threading.Lock",
    "codec/registry.py::ErasureCodePluginRegistry.__init__::threading.RLock",
    "compressor/device.py::<module>::threading.Lock",
    "ops/_nvcc.py::<module>::threading.Lock",
    "ops/_nvcc.py::build::threading.Lock",
    "ops/checksum_offload.py::<module>::threading.Lock",
    "ops/packed_gf.py::<module>::threading.Lock",
    "ops/packed_gf.py::LoweredProgram.__init__::threading.Lock",
    "ops/swar_gf.py::<module>::threading.Lock",
    "ops/xor_mm.py::<module>::threading.Lock",
    "utils/crc32c.py::<module>::threading.Lock",
    "utils/host_build.py::<module>::threading.Lock",
    "utils/native.py::<module>::threading.Lock",
]


def test_live_tree_runs_all_six_passes_clean():
    report = run_analysis()
    assert report["ok"], report["findings"] + report["stale_allowlist"]
    assert report["stale_allowlist"] == []
    assert set(report["passes"]) == set(PASS_BY_ID) and len(PASS_BY_ID) == 6
    assert analysis.PKG_ROOT == ROOT / "ceph_tpu_torch"


def test_routed_locks_are_gone():
    findings = LockDisciplinePass()(SourceTree())
    keys = {f.key.removeprefix("ceph_tpu_torch/") for f in findings}
    assert not keys & set(ROUTED_LOCKS)
    assert all(f.line for f in findings)
    # what remains is the allowlisted per-group lock and its settle waits
    assert keys <= {entry.removeprefix("ceph_tpu_torch/") for entry in
                    load_allowlist(ALLOWLIST_DIR / "lock-discipline.allow")}


def test_allowlists_are_the_ports():
    for p in ALL_PASSES:
        for key, reason in load_allowlist(ALLOWLIST_DIR / f"{p.PASS_ID}.allow").items():
            assert len(reason) > 20, key
            if "/" in key.split("::")[0]:
                assert key.startswith("ceph_tpu_torch/"), key
            assert "ceph_tpu/" not in reason, key


def test_port_only_options_are_documented():
    text = (ROOT / "ceph_tpu_torch" / "OPTIONS.md").read_text()
    from ceph_tpu.common.options import OPTIONS as REF
    from ceph_tpu_torch.common.options import OPTIONS as PORT

    for name in sorted(set(PORT) - set(REF)):
        assert f"`{name}`" in text, name


def test_isolation_covers_the_new_files():
    for rel in ("analysis/__init__.py", "analysis/__main__.py", "analysis/passes/__init__.py",
                "analysis/passes/exceptions.py", "analysis/passes/locks.py",
                "analysis/passes/ledger.py", "analysis/passes/donation.py",
                "analysis/passes/purity.py", "analysis/passes/options_coherence.py",
                "graft_entry.py"):
        assert ROOT / "ceph_tpu_torch" / rel in PORT_FILES, rel
