"""perf_compare — round-over-round performance trajectory gating.

The port's copy of `ceph_tpu/tools/perf_compare.py`, with the
reference's metrics, platform scoping, ratio and CLI.  No device, no
torch: it parses JSON.

- ``load_rounds()`` parses a corpus of ``BENCH_r<NN>.json`` rounds
  (tolerating the legacy single-metric shape of early rounds and the
  rich multi-metric shape) into flat per-round metric slices;
- ``compare()`` diffs a current round against the trailing rounds'
  same-platform best (throughput metrics are judged platform against
  the same platform; the chaos keys across platforms) and emits a
  machine-readable ``regressions`` slice that ``tools/chaos.py`` folds
  into its report;
- ``--check`` validates a corpus (schema, parseability, finite
  numbers).

The rounds live in the port's own directory, ``torch_rounds/`` beside
``ceph_tpu_torch/`` at the checkout's root (``default_rounds_dir()``),
never in the root itself: the root's ``BENCH_r*.json`` are the JAX
package's rounds (platforms ``cpu`` and ``tpu``), and its chaos keys are
not platform-scoped, so a port report would otherwise be judged against
TPU-era figures.  Until the port's benchmark writes rounds there, the
directory does not exist: ``compare_round`` then returns no baseline
and an empty ``flagged``, and ``--check`` without ``--rounds-dir``
exits non-zero with "no BENCH_r*.json rounds under ...".  That is the
expected state until then.  ``--rounds-dir DIR`` reads any directory.

CLI:
    python -m ceph_tpu_torch.tools.perf_compare --check [--rounds-dir DIR]
    python -m ceph_tpu_torch.tools.perf_compare --current out.json [--ratio 0.8]
"""

from __future__ import annotations

import argparse
import glob
import json
import math
import os
import re
import sys

# flagging threshold: value below ratio x same-platform baseline
# (higher-is-better) or above baseline / ratio (lower-is-better)
DEFAULT_RATIO = 0.8

# metric -> (path into the parsed bench JSON, direction,
# platform_scoped).  Throughput metrics compare same-platform only;
# chaos latency runs host-side whatever platform the bench child won.
METRICS: dict[str, tuple[tuple[str, ...], str, bool]] = {
    "rs_8_3_encode_GBps_per_chip": ((), "higher", True),
    "rs_8_3_decode_GBps_per_chip": (("decode",), "higher", True),
    "rs_8_3_verify_GBps_per_chip": (("verify",), "higher", True),
    "rs_8_3_encode_GBps_per_chip_pipelined": (("pipelined",), "higher", True),
    # fusion trajectory: aggregated end-to-end throughput
    # with super-launch fusion armed (multi-submitter backlog), and the
    # bucketed pad learner's steady-state waste fraction — waste is
    # lower-is-better and platform-independent (a stripe-count ratio)
    "rs_8_3_encode_GBps_per_chip_fused": (("fused",), "higher", True),
    "padding_waste_ratio": (("pad_waste",), "lower", False),
    "rs_8_3_encode_GBps_aggregate": (("multichip",), "higher", True),
    "rs_8_3_decode_GBps_aggregate": (("multichip", "decode"), "higher", True),
    "chaos_p99_ms": (("chaos", "chaos_p99_ms"), "lower", False),
    "recovery_occupancy": (("chaos", "recovery_occupancy"), "higher", False),
    # recovery-storm trajectory: whole-OSD rebuild time and
    # client p99 under the storm, both lower-is-better, folded from the
    # chaos JSON so a PR that slows rebuild (or lets it eat client
    # latency) flags against the best round
    "chaos_rebuild_seconds": (("chaos", "rebuild_seconds"), "lower", False),
    "chaos_storm_p99_ms": (("chaos", "storm_p99_ms"), "lower", False),
    # gray-failure trajectory: client read p99 with one OSD's
    # shard reads delayed ~50x (hedged reads must keep beating the
    # injected delay round over round) and the hedge rate the window
    # paid for it — both lower-is-better, folded from the chaos JSON
    "chaos_gray_p99_ms": (("chaos", "gray_p99_ms"), "lower", False),
    "chaos_hedge_rate": (("chaos", "hedge_rate"), "lower", False),
    # write-path offload trajectory: device crc32c GB/s and
    # the fused compressor-transform + csum write path — both per-chip
    # throughputs, judged same-platform like the EC kernels
    "bluestore_csum_GBps_per_chip": (("csum",), "higher", True),
    "write_path_offload_GBps": (("offload",), "higher", True),
}

_ROUND_RE = re.compile(r"BENCH_r(\d+)\.json$")
ROUNDS_DIR_NAME = "torch_rounds"


def default_rounds_dir() -> str:
    """The port's rounds directory, ``torch_rounds/`` at the checkout's
    root (resolved relative to this file: ceph_tpu_torch/tools/ ->
    checkout), which the root's JAX-package rounds never enter."""
    return os.path.join(
        os.path.dirname(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        ),
        ROUNDS_DIR_NAME,
    )


def metric_slice(parsed: dict) -> dict[str, float]:
    """Flatten one round's parsed bench JSON into {metric: value}.

    Handles both shapes: the legacy single-metric line
    (``{"metric": ..., "value": ...}``) and the current nested one
    where decode/verify/pipelined/multichip ride sub-objects carrying
    their own ``metric``/``value`` pairs (the chaos fold carries plain
    keys).  Unknown metrics are ignored — the comparator only judges
    what it has a direction for."""
    out: dict[str, float] = {}
    if not isinstance(parsed, dict):
        return out
    for name, (path, _direction, _scoped) in METRICS.items():
        node: object = parsed
        for key in path:
            if not isinstance(node, dict):
                node = None
                break
            node = node.get(key)
        if node is None:
            continue
        if path and path[0] == "chaos":
            # chaos keys are plain values, not {metric, value} objects
            value = node
        elif isinstance(node, dict):
            if node.get("metric") != name:
                continue
            value = node.get("value")
        else:
            continue
        if isinstance(value, (int, float)) and math.isfinite(value):
            out[name] = float(value)
    return out


def load_rounds(rounds_dir: str | None = None) -> list[dict]:
    """Parse every BENCH_r*.json of the corpus into
    {round, rc, platform, metrics}, ordered by round number.  Rounds
    that failed (rc != 0 / no parsed slice) load with empty metrics —
    they are part of the trajectory, just not baselines."""
    rounds_dir = rounds_dir or default_rounds_dir()
    out: list[dict] = []
    for path in sorted(glob.glob(os.path.join(rounds_dir, "BENCH_r*.json"))):
        m = _ROUND_RE.search(os.path.basename(path))
        if m is None:
            continue
        with open(path) as f:
            doc = json.load(f)
        parsed = doc.get("parsed") or {}
        out.append({
            "round": int(m.group(1)),
            "rc": doc.get("rc"),
            "platform": parsed.get("platform"),
            "metrics": metric_slice(parsed),
        })
    out.sort(key=lambda r: r["round"])
    return out


def compare(
    current: dict,
    rounds: list[dict],
    ratio: float = DEFAULT_RATIO,
) -> dict:
    """Diff a current round's parsed slice against the trailing rounds.

    Returns the ``regressions`` slice bench/chaos fold:
    ``rounds_compared`` (which history was judged against),
    ``baselines`` (per metric: the same-platform best, with the round
    that set it), and ``flagged`` (metrics falling past ``ratio`` of
    their baseline).  A metric with no trailing baseline cannot flag —
    first rounds and platform switches compare against nothing, by
    design."""
    cur_platform = current.get("platform")
    cur_metrics = metric_slice(current)
    baselines: dict[str, dict] = {}
    for rnd in rounds:
        for name, value in rnd["metrics"].items():
            _path, direction, scoped = METRICS[name]
            if scoped and rnd["platform"] != cur_platform:
                continue
            best = baselines.get(name)
            better = (
                best is None
                or (direction == "higher" and value > best["value"])
                or (direction == "lower" and value < best["value"])
            )
            if better:
                baselines[name] = {
                    "value": value,
                    "round": rnd["round"],
                    "platform": rnd["platform"],
                }
    flagged: list[dict] = []
    for name, value in sorted(cur_metrics.items()):
        base = baselines.get(name)
        if base is None or base["value"] <= 0 or ratio <= 0:
            continue
        _path, direction, _scoped = METRICS[name]
        if direction == "higher":
            regressed = value < ratio * base["value"]
            vs = value / base["value"]
        else:
            regressed = value > base["value"] / ratio
            vs = base["value"] / value if value else 0.0
        if regressed:
            flagged.append({
                "metric": name,
                "value": value,
                "baseline": base["value"],
                "baseline_round": base["round"],
                "direction": direction,
                "vs_baseline": round(vs, 4),
            })
    return {
        "rounds_compared": [r["round"] for r in rounds],
        "platform": cur_platform,
        "ratio": ratio,
        "baselines": baselines,
        "flagged": flagged,
        "count": len(flagged),
    }


def compare_round(
    current: dict,
    rounds_dir: str | None = None,
    ratio: float = DEFAULT_RATIO,
) -> dict:
    """One-call fold for chaos.py: load the corpus and compare `current`
    (a parsed-bench-shaped dict) against it."""
    return compare(current, load_rounds(rounds_dir), ratio=ratio)


def check_corpus(rounds_dir: str | None = None) -> list[str]:
    """Schema validation of the corpus (``--check``): every
    BENCH_r*.json must parse, carry the driver keys, and — when the
    round succeeded — a parsed slice whose metric values are finite
    non-negative numbers.  Returns problem strings (empty = clean)."""
    rounds_dir = rounds_dir or default_rounds_dir()
    problems: list[str] = []
    paths = sorted(glob.glob(os.path.join(rounds_dir, "BENCH_r*.json")))
    if not paths:
        return [f"no BENCH_r*.json rounds under {rounds_dir}"]
    for path in paths:
        name = os.path.basename(path)
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            problems.append(f"{name}: unreadable/not JSON ({e})")
            continue
        if not isinstance(doc, dict):
            problems.append(f"{name}: top level is not an object")
            continue
        for key in ("n", "rc", "parsed"):
            if key not in doc:
                problems.append(f"{name}: missing driver key {key!r}")
        rc = doc.get("rc")
        parsed = doc.get("parsed")
        if rc == 0:
            if not isinstance(parsed, dict):
                problems.append(
                    f"{name}: rc=0 but parsed is not an object"
                )
                continue
            for key in ("metric", "value", "unit"):
                if key not in parsed:
                    problems.append(
                        f"{name}: parsed slice missing {key!r}"
                    )
            value = parsed.get("value")
            if not isinstance(value, (int, float)) or \
                    not math.isfinite(value) or value < 0:
                problems.append(
                    f"{name}: parsed.value {value!r} is not a finite "
                    "non-negative number"
                )
            for metric, mval in metric_slice(parsed).items():
                if mval < 0:
                    problems.append(
                        f"{name}: metric {metric} negative ({mval})"
                    )
        elif parsed not in (None, {}) and not isinstance(parsed, dict):
            problems.append(f"{name}: rc!=0 with non-object parsed slice")
    return problems


def trajectory(rounds_dir: str | None = None) -> list[dict]:
    """Per-round metric slices in round order (what `--check` prints):
    the corpus's story, machine-readable."""
    return [
        {
            "round": r["round"],
            "rc": r["rc"],
            "platform": r["platform"],
            "metrics": r["metrics"],
        }
        for r in load_rounds(rounds_dir)
    ]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds-dir", default="",
                    help="directory holding BENCH_r*.json "
                         "(default: the port's torch_rounds/)")
    ap.add_argument("--current", default="",
                    help="a bench JSON (the parsed slice / a bench "
                         "output line) to judge against the corpus")
    ap.add_argument("--ratio", type=float, default=DEFAULT_RATIO,
                    help="regression threshold as a fraction of the "
                         "baseline (default %(default)s)")
    ap.add_argument("--check", action="store_true",
                    help="validate the corpus schema and exit "
                         "nonzero on any problem")
    args = ap.parse_args(argv)
    rounds_dir = args.rounds_dir or None
    if args.check:
        problems = check_corpus(rounds_dir)
        checked = len(glob.glob(os.path.join(
            rounds_dir or default_rounds_dir(), "BENCH_r*.json"
        )))
        print(json.dumps({
            "checked": checked,
            "ok": not problems,
            "problems": problems,
            "trajectory": trajectory(rounds_dir) if not problems else [],
        }, indent=2))
        return 1 if problems else 0
    if args.current:
        with open(args.current) as f:
            current = json.load(f)
        result = compare_round(current, rounds_dir, ratio=args.ratio)
        print(json.dumps(result, indent=2))
        return 1 if result["flagged"] else 0
    print(json.dumps(trajectory(rounds_dir), indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
