"""The exposition rules of `tests/test_metrics_lint.py` (`lint_exposition`
and its histogram check), copied into a module that imports neither
package nor pytest, so that `chip_smoke.py` can lint the port's scrape
on the card.  `tests/test_torch_mgr_modules.py` holds this copy to the
original on well-formed and malformed texts."""

import re

_SAMPLE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)(?:\{(?P<labels>[^}]*)\})? (?P<value>\S+)$'
)


def lint_exposition(text: str) -> dict:
    """Parse and validate an exposition payload; returns
    {family: {"type", "help", "samples": [(name, labels, value)]}}.
    Raises AssertionError on any contract violation."""
    assert text.endswith("\n"), "exposition must end with a newline"
    families: dict[str, dict] = {}
    current = None  # family the last HELP/TYPE block opened
    for lineno, line in enumerate(text.splitlines(), 1):
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            _, _, rest = line.partition("# HELP ")
            name, _, help_ = rest.partition(" ")
            assert name not in families, f"line {lineno}: duplicate family {name}"
            families[name] = {"type": None, "help": help_, "samples": []}
            current = name
            continue
        if line.startswith("# TYPE "):
            _, _, rest = line.partition("# TYPE ")
            name, _, ftype = rest.partition(" ")
            assert name == current, (
                f"line {lineno}: TYPE for {name} outside its HELP block"
            )
            assert families[name]["type"] is None, (
                f"line {lineno}: duplicate TYPE for {name}"
            )
            assert ftype in ("counter", "gauge", "histogram", "summary", "untyped")
            families[name]["type"] = ftype
            continue
        assert not line.startswith("#"), f"line {lineno}: unknown comment {line!r}"
        m = _SAMPLE.match(line)
        assert m, f"line {lineno}: malformed sample {line!r}"
        name = m.group("name")
        base = name
        for suffix in ("_bucket", "_sum", "_count"):
            stripped = name.removesuffix(suffix)
            if stripped != name and stripped in families and families[
                stripped
            ]["type"] == "histogram":
                base = stripped
                break
        assert base in families, f"line {lineno}: sample {name} has no HELP/TYPE"
        assert base == current, (
            f"line {lineno}: sample {name} outside family {current} block"
        )
        float(m.group("value"))  # every value parses as a number
        labels = {}
        for part in (m.group("labels") or "").split(","):
            if part:
                k, _, v = part.partition("=")
                labels[k] = v.strip('"')
        families[base]["samples"].append((name, labels, float(m.group("value"))))
    for name, fam in families.items():
        assert fam["type"] is not None, f"family {name} has HELP but no TYPE"
        assert fam["help"].strip(), f"family {name} has empty HELP"
        if fam["type"] == "histogram":
            _check_histogram(name, fam["samples"])
    return families


def _check_histogram(name: str, samples: list) -> None:
    """Per label-set (minus `le`): buckets cumulative and non-decreasing,
    +Inf last, and _count == the +Inf bucket."""
    series: dict[tuple, dict] = {}
    for sname, labels, value in samples:
        key = tuple(sorted((k, v) for k, v in labels.items() if k != "le"))
        rec = series.setdefault(key, {"buckets": [], "sum": None, "count": None})
        if sname == f"{name}_bucket":
            assert "le" in labels, f"{name}: bucket sample without le"
            le = float("inf") if labels["le"] == "+Inf" else float(labels["le"])
            rec["buckets"].append((le, value))
        elif sname == f"{name}_sum":
            rec["sum"] = value
        elif sname == f"{name}_count":
            rec["count"] = value
    for key, rec in series.items():
        assert rec["buckets"], f"{name}{dict(key)}: histogram without buckets"
        les = [le for le, _ in rec["buckets"]]
        assert les == sorted(les), f"{name}{dict(key)}: le bounds not sorted"
        assert les[-1] == float("inf"), f"{name}{dict(key)}: missing +Inf bucket"
        counts = [c for _, c in rec["buckets"]]
        assert counts == sorted(counts), (
            f"{name}{dict(key)}: cumulative bucket counts decrease"
        )
        assert rec["sum"] is not None and rec["count"] is not None, (
            f"{name}{dict(key)}: missing _sum/_count"
        )
        assert rec["count"] == counts[-1], (
            f"{name}{dict(key)}: _count != +Inf bucket"
        )
