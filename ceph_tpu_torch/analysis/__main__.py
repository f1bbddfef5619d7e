"""`python -m ceph_tpu_torch.analysis` — run every pass, print findings,
exit nonzero on any unallowlisted finding or stale allowlist entry.

    python -m ceph_tpu_torch.analysis                # human output
    python -m ceph_tpu_torch.analysis --json         # machine report to stdout
    python -m ceph_tpu_torch.analysis --json out.json
    python -m ceph_tpu_torch.analysis --pass lock-discipline
"""

from __future__ import annotations

import argparse
import sys

from . import ALLOWLIST_DIR, SourceTree, render_report, run_analysis
from .passes import ALL_PASSES, PASS_BY_ID


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m ceph_tpu_torch.analysis",
        description=__doc__.splitlines()[0],
    )
    ap.add_argument("--json", nargs="?", const="-", default=None,
                    metavar="PATH",
                    help="emit the JSON report (to PATH, or stdout)")
    ap.add_argument("--pass", dest="passes", action="append", default=None,
                    choices=sorted(PASS_BY_ID),
                    help="run only this pass (repeatable)")
    ap.add_argument("--list", action="store_true",
                    help="list the pass inventory and exit")
    ap.add_argument("--root", default=None, metavar="DIR",
                    help="package root to analyze (default: the "
                         "installed ceph_tpu_torch/); allowlists are NOT "
                         "applied to foreign roots")
    args = ap.parse_args(argv)

    if args.list:
        for p in ALL_PASSES:
            print(f"{p.PASS_ID}: {p.DESCRIBE}")
        return 0

    passes = ALL_PASSES
    if args.passes:
        passes = [PASS_BY_ID[pid] for pid in args.passes]
    if args.root is not None:
        tree, allow_dir = SourceTree(args.root), None
    else:
        tree, allow_dir = SourceTree(), ALLOWLIST_DIR
    report = run_analysis(tree, passes=passes, allowlist_dir=allow_dir)
    if args.json is not None:
        text = render_report(report, as_json=True)
        if args.json == "-":
            print(text)
        else:
            with open(args.json, "w") as f:
                f.write(text + "\n")
            print(f"report written to {args.json}")
    else:
        print(render_report(report))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
