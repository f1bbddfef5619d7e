"""Read the logs `sentinel_trace/sitecustomize.py` wrote and print, for
each log, the throughput ratios (recent over baseline GB/s) that each
rule of `TPU_THROUGHPUT_REGRESSION` judged, lowest first, and the
launches by kind.  A ratio is judged where all launches persist (both
windows at least the chaos harness's 0.5 a second, the recent one at
least half the baseline's) and, for the port's rules, the kind's own
launches persist too; the sentinel raises below the ratio pinned (0.2 in
`tools/chaos.py`).

    python3 sentinel_trace/rules.py sentinel_trace/logs/*.json
"""

import collections
import json
import sys

MIN_LAUNCH = 0.5
# rule: (GB/s series judged, launch series of its own gate or None)
RULES = {
    "reference encode": ("encode_gbps", None),
    "reference decode": ("decode_gbps", None),
    "port encode": ("encode_only_gbps", "encode_launches_per_sec"),
    "port decode": ("decode_gbps", "decode_launches_per_sec"),
}


def persists(cur, base) -> bool:
    return (cur is not None and base is not None and cur >= MIN_LAUNCH
            and base >= MIN_LAUNCH and cur >= 0.5 * base)


def judged(rows: list[dict], series: str, gate: str | None) -> list[tuple[float, float]]:
    out = []
    for row in rows:
        if not persists(*row["launches_per_sec"]):
            continue
        if gate is not None and not persists(*row[gate]):
            continue
        cur, base = row[series]
        if cur is not None and base:
            out.append((round(cur / base, 4), row["at_s"]))
    return sorted(out)


def main(paths: list[str]) -> int:
    for path in paths:
        with open(path) as fh:
            log = json.load(fh)
        rows = [entry[1] for entry in log if entry[0] == "E"]
        kinds = collections.Counter(entry[2] for entry in log if entry[0] == "L")
        print(f"{path}: {len(rows)} evaluations, {rows[-1]['fired'] if rows else 0} raised, "
              f"launches {dict(kinds)}")
        for name, (series, gate) in RULES.items():
            ratios = judged(rows, series, gate)
            print(f"  {name}: {len(ratios)} judged, lowest (ratio, s of history) {ratios[:3]}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
