"""The port's round comparator (`ceph_tpu_torch/tools/perf_compare.py`)
against the reference's, on the CPU.

Every case of `tests/test_perf_compare.py` runs on the port through
`torch_ported.load`, but one: `test_default_rounds_dir_is_the_repo_root`
names the reference's default, the checkout's root, whose
`BENCH_r*.json` are the JAX package's rounds (platforms `cpu` and
`tpu`).  The port's default is its own `torch_rounds/`, which no round
has entered yet; `test_default_rounds_dir_is_the_ports_own` asserts that
in its place, and that a fold with no directory named reads no file at
the root; `test_cli_check_without_rounds_fails` holds `--check` to the
reference's problem when the default holds no round.

The differential feeds both packages' `metric_slice`, `compare`,
`compare_round` and `check_corpus` the same inputs: the committed rounds
at the root, `tmp_path` corpora (malformed, drifted, empty, mixed), and
hypothesis-drawn rounds over every `METRICS` key on three platforms.
"""

import builtins
import json
import math
import os

from hypothesis import given, settings
from hypothesis import strategies as st

from torch_leak_gate import port_leak_gate  # noqa: F401 (autouse)
from torch_ported import collect, load

import ceph_tpu.tools.perf_compare as ref
import ceph_tpu_torch.tools.perf_compare as port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_mod = load("test_perf_compare")
collect(_mod, ["TestMetricSlice", "TestCompare"], globals())


class TestCommittedCorpus_torch(_mod.TestCommittedCorpus):
    # names the reference's default, the root (module docstring)
    test_default_rounds_dir_is_the_repo_root = None

    def test_default_rounds_dir_is_the_ports_own(self, monkeypatch):
        assert port.default_rounds_dir() == os.path.join(REPO, "torch_rounds")
        assert port.default_rounds_dir() != ref.default_rounds_dir()
        opened = []
        real_open = builtins.open

        def spy(path, *args, **kwargs):
            opened.append(os.path.abspath(str(path)))
            return real_open(path, *args, **kwargs)

        monkeypatch.setattr(builtins, "open", spy)
        out = port.compare_round({"platform": "gpu", "chaos": {"chaos_p99_ms": 1.0}})
        assert not [p for p in opened if os.path.dirname(p) == REPO], opened
        if not os.path.isdir(port.default_rounds_dir()):
            # the expected state until the port's benchmark writes rounds
            assert out["rounds_compared"] == [] and out["baselines"] == {}
            assert out["flagged"] == [] and out["count"] == 0
            problems = port.check_corpus()
            assert problems == [f"no BENCH_r*.json rounds under {port.default_rounds_dir()}"]

    def test_cli_check_without_rounds_fails(self, tmp_path, monkeypatch, capsys):
        """The state until the port's benchmark writes rounds: `--check`
        with no `--rounds-dir` finds none under the default and fails."""
        empty = str(tmp_path / "torch_rounds")
        monkeypatch.setattr(port, "default_rounds_dir", lambda: empty)
        assert port.main(["--check"]) == 1
        payload = json.loads(capsys.readouterr().out)
        assert payload["ok"] is False and payload["checked"] == 0
        assert payload["problems"] == [f"no BENCH_r*.json rounds under {empty}"]


def test_metrics_table_is_the_references():
    assert port.METRICS == ref.METRICS
    assert port.DEFAULT_RATIO == ref.DEFAULT_RATIO == 0.8


def test_committed_rounds_agree():
    assert port.load_rounds(REPO) == ref.load_rounds(REPO)
    assert port.check_corpus(REPO) == ref.check_corpus(REPO)
    assert port.trajectory(REPO) == ref.trajectory(REPO)
    for current in (
        {"metric": "rs_8_3_encode_GBps_per_chip", "value": 1.0, "platform": "tpu"},
        {"metric": "rs_8_3_encode_GBps_per_chip", "value": 0.01, "platform": "cpu"},
        {"platform": "gpu", "chaos": {"chaos_p99_ms": 500.0, "rebuild_seconds": 90.0}},
    ):
        assert port.compare_round(current, REPO) == ref.compare_round(current, REPO)


def _corpora(tmp_path):
    """Name -> directory of the tmp corpora both packages read."""
    out = {}

    def corpus(name, files):
        d = tmp_path / name
        d.mkdir()
        for fname, text in files.items():
            (d / fname).write_text(text)
        out[name] = str(d)

    corpus("empty", {})
    corpus("malformed", {"BENCH_r01.json": "{not json", "BENCH_r02.json": "[1, 2]"})
    corpus("drifted", {
        "BENCH_r01.json": json.dumps({"n": 1, "rc": 0, "parsed": {"speed": 3}}),
        "BENCH_r02.json": json.dumps({"n": 2, "rc": 0, "parsed": {
            "metric": "m", "value": None, "unit": "GB/s"}}),
        "BENCH_r03.json": json.dumps({"rc": 1, "parsed": "oops"}),
        "BENCH_r04.json": json.dumps({"n": 4, "rc": 0, "parsed": {
            "metric": "rs_8_3_encode_GBps_per_chip", "value": -1.0, "unit": "GB/s"}}),
    })
    corpus("mixed", {
        "BENCH_r07.json": json.dumps({"n": 7, "rc": 0, "parsed": {
            "metric": "rs_8_3_encode_GBps_per_chip", "value": 2.0, "unit": "GB/s",
            "platform": "gpu", "chaos": {"chaos_p99_ms": 40.0, "hedge_rate": 0.1}}}),
        "BENCH_r03.json": json.dumps({"n": 3, "rc": 0, "parsed": {
            "metric": "rs_8_3_encode_GBps_per_chip", "value": 9.0, "unit": "GB/s",
            "platform": "tpu", "decode": {"metric": "rs_8_3_decode_GBps_per_chip",
                                          "value": 8.0}}}),
        "BENCH_r05.json": json.dumps({"n": 5, "rc": 2, "parsed": None}),
        "notes.json": "{}",
    })
    return out


def _outcome(fn, *args):
    """What `fn(*args)` gives: its value, or the type of what it raised."""
    try:
        return "value", fn(*args)
    except Exception as e:  # the same failure in both packages is agreement
        return "raised", type(e).__name__


def test_tmp_corpora_agree(tmp_path):
    cur = {"platform": "gpu", "metric": "rs_8_3_encode_GBps_per_chip",
           "value": 1.0, "chaos": {"chaos_p99_ms": 60.0}}
    for name, d in _corpora(tmp_path).items():
        assert port.check_corpus(d) == ref.check_corpus(d), name
        assert _outcome(port.load_rounds, d) == _outcome(ref.load_rounds, d), name
        assert _outcome(port.compare_round, cur, d) == _outcome(ref.compare_round, cur, d), name
    # the malformed corpus is a problem to --check and raises on loading
    assert _outcome(port.load_rounds, str(tmp_path / "malformed"))[0] == "raised"


def test_cli_agrees_on_tmp_corpora(tmp_path, capsys):
    for name, d in _corpora(tmp_path).items():
        outs = []
        for mod in (port, ref):
            got = _outcome(mod.main, ["--check", "--rounds-dir", d])
            outs.append((got, capsys.readouterr().out))
        assert outs[0] == outs[1], name


_PLATFORMS = st.sampled_from(["cpu", "tpu", "gpu"])
_VALUES = st.one_of(
    st.floats(min_value=0.0, max_value=1e4, allow_nan=False),
    st.integers(min_value=0, max_value=10_000),
    st.just(float("inf")),
    st.just(float("nan")),
    st.none(),
    st.just("12"),
)


def _set_path(doc: dict, path, name, value) -> None:
    """Place `value` for metric `name` at `path` the way a bench line
    carries it: chaos keys as plain values, the rest as {metric, value}."""
    if not path:
        doc["metric"], doc["value"] = name, value
        return
    node = doc
    for key in path[:-1]:
        node = node.setdefault(key, {})
        if not isinstance(node, dict):
            return
    if path[0] == "chaos":
        node[path[-1]] = value
    else:
        node[path[-1]] = {"metric": name, "value": value}


@st.composite
def _parsed(draw):
    doc = {"platform": draw(_PLATFORMS)}
    names = draw(st.lists(st.sampled_from(sorted(ref.METRICS)), unique=True, max_size=8))
    for name in names:
        _set_path(doc, ref.METRICS[name][0], name, draw(_VALUES))
    if draw(st.booleans()):
        doc["decode"] = {"metric": "mislabeled", "value": 1.0}
    return doc


@settings(max_examples=150, deadline=None, database=None)
@given(current=_parsed(), history=st.lists(_parsed(), max_size=6),
       ratio=st.sampled_from([0.8, 0.5, 1.0, 0.0]))
def test_drawn_rounds_agree(current, history, ratio):
    assert port.metric_slice(current) == ref.metric_slice(current)
    rounds = [
        {"round": i + 1, "rc": 0, "platform": doc["platform"],
         "metrics": ref.metric_slice(doc)}
        for i, doc in enumerate(history)
    ]
    got, want = port.compare(current, rounds, ratio), ref.compare(current, rounds, ratio)
    assert got == want
    assert all(math.isfinite(f["value"]) for f in got["flagged"])
