"""Pass-based static analysis over the ceph_tpu_torch package.

The port's copy of `ceph_tpu/analysis/`, with the reference's names,
pass ids, report shape, allowlist format and CLI.  The port's data path
rests on rules no unit test can see locally: a donated output buffer is
never read after dispatch, a device error is never swallowed (re-raised,
handed to its owner's device-fails hook, or turned into an EIO that
reaches the caller), every lock routes through the `common/lockdep.py`
factory so ordering stays validated, no device wait runs under a lock,
every device placement that outlives its call is metered by the
mempool ledger, and the option table stays coherent with the code and
docs.  The passes read source text with `ast`; nothing here imports
torch, and recognising a name such as `jax.jit` in a fixture is not
importing it.

Design:

- :class:`SourceTree` parses every package file ONCE (AST + parent
  links + scope qualnames); passes share it.
- A pass is a callable ``(tree) -> list[Finding]`` with a ``PASS_ID``
  and a one-line ``DESCRIBE``.  Each :class:`Finding` carries
  ``file:line``, the pass id, a human message, and a STABLE ``key``
  (file + enclosing scope + pass-specific detail — not the line number,
  so allowlists survive unrelated edits).
- Allowlists live in ``analysis/allowlists/<pass_id>.allow`` — one
  ``key | reason`` per line, reason MANDATORY (the loader refuses an
  entry without one).  A stale entry (matching no current finding) is
  itself a finding: suppressions must die with the code they excused.
- ``python -m ceph_tpu_torch.analysis`` runs everything and exits
  nonzero on any unallowlisted finding; ``--json`` emits the machine
  report (tests/test_torch_analysis.py and phase 21 of chip_smoke.py
  read it).
- The config-coherence pass's doc universe is ``docs/*.md`` plus the
  port's own index ``ceph_tpu_torch/OPTIONS.md``, which documents the
  options only the port has.
"""

from __future__ import annotations

import ast
import json
from dataclasses import dataclass, field
from pathlib import Path

PKG_ROOT = Path(__file__).resolve().parent.parent       # ceph_tpu_torch/
REPO_ROOT = PKG_ROOT.parent
ALLOWLIST_DIR = Path(__file__).resolve().parent / "allowlists"

_SCOPE_NODES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


@dataclass
class Finding:
    """One violation: where, which pass, what — plus the stable
    allowlist key."""

    pass_id: str
    file: str          # repo-relative path
    line: int
    key: str           # stable allowlist key (no line numbers)
    message: str
    allowed: bool = False
    reason: str = ""   # allowlist reason when allowed

    def to_json(self) -> dict:
        return {
            "pass": self.pass_id,
            "file": self.file,
            "line": self.line,
            "key": self.key,
            "message": self.message,
            "allowed": self.allowed,
            **({"reason": self.reason} if self.allowed else {}),
        }

    def __str__(self) -> str:
        flag = " [allowlisted: %s]" % self.reason if self.allowed else ""
        return f"{self.file}:{self.line}: [{self.pass_id}] {self.message}{flag}"


class SourceFile:
    """One parsed module: AST with parent links and scope qualnames."""

    def __init__(self, path: Path, rel: str):
        self.path = path
        self.rel = rel
        self.text = path.read_text()
        self.tree = ast.parse(self.text, filename=str(path))
        self.parents: dict[ast.AST, ast.AST] = {}
        for parent in ast.walk(self.tree):
            for child in ast.iter_child_nodes(parent):
                self.parents[child] = parent

    def ancestors(self, node: ast.AST) -> list[ast.AST]:
        """Chain from the module root down to (excluding) `node`."""
        chain = []
        cur = node
        while cur in self.parents:
            cur = self.parents[cur]
            chain.append(cur)
        chain.reverse()
        return chain

    def scope_of(self, node: ast.AST) -> str:
        """Qualname of the enclosing function/class scope, or
        "<module>".  The allowlist key component: stable across line
        churn, precise enough to not over-suppress."""
        names = []
        cur = node
        while cur in self.parents:
            cur = self.parents[cur]
            if isinstance(cur, _SCOPE_NODES):
                names.append(cur.name)
        if not names:
            return "<module>"
        return ".".join(reversed(names))

    def enclosing_function(
        self, node: ast.AST
    ) -> ast.FunctionDef | ast.AsyncFunctionDef | None:
        cur = node
        while cur in self.parents:
            cur = self.parents[cur]
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef)):
                return cur
        return None


class SourceTree:
    """Every .py file under a package root, parsed once and shared by
    all passes."""

    def __init__(self, root: Path | str = PKG_ROOT,
                 repo_root: Path | str | None = None):
        self.root = Path(root)
        self.repo_root = Path(repo_root) if repo_root else self.root.parent
        self.files: list[SourceFile] = []
        for path in sorted(self.root.rglob("*.py")):
            if "__pycache__" in path.parts:
                continue
            rel = str(path.relative_to(self.repo_root))
            self.files.append(SourceFile(path, rel))

    def docs_text(self) -> str:
        """Concatenated docs/*.md plus the package's own OPTIONS.md
        index (the config-coherence pass's doc universe)."""
        pages = []
        docs = self.repo_root / "docs"
        if docs.is_dir():
            pages = sorted(docs.glob("*.md"))
        own = self.root / "OPTIONS.md"
        if own.is_file():
            pages.append(own)
        return "\n".join(p.read_text() for p in pages)


def load_allowlist(path: Path) -> dict[str, str]:
    """Parse one `<key> | <reason>` allowlist file.  The reason string
    is MANDATORY — findings are never silently suppressed."""
    entries: dict[str, str] = {}
    if not path.is_file():
        return entries
    for lineno, raw in enumerate(path.read_text().splitlines(), 1):
        line = raw.strip()
        if not line or line.startswith("#"):
            continue
        key, sep, reason = line.partition("|")
        key, reason = key.strip(), reason.strip()
        if not sep or not reason:
            raise ValueError(
                f"{path.name}:{lineno}: allowlist entry {key!r} has no "
                "reason — every suppression must say why "
                "(`<key> | <reason>`)"
            )
        if key in entries:
            raise ValueError(f"{path.name}:{lineno}: duplicate key {key!r}")
        entries[key] = reason
    return entries


def run_analysis(
    tree: SourceTree | None = None,
    passes=None,
    allowlist_dir: Path | str | None = ALLOWLIST_DIR,
) -> dict:
    """Run passes over the tree; apply allowlists; return the report.

    Report shape::

        {"findings": [...unallowlisted...], "allowlisted": [...],
         "stale_allowlist": [...], "passes": {id: counts}, "ok": bool}
    """
    from .passes import ALL_PASSES

    if tree is None:
        tree = SourceTree()
    if passes is None:
        passes = ALL_PASSES
    open_findings: list[Finding] = []
    allowed: list[Finding] = []
    stale: list[dict] = []
    per_pass: dict[str, dict] = {}
    for p in passes:
        findings = p(tree)
        entries = {}
        if allowlist_dir is not None:
            entries = load_allowlist(Path(allowlist_dir) / f"{p.PASS_ID}.allow")
        used: set[str] = set()
        for f in findings:
            if f.key in entries:
                f.allowed = True
                f.reason = entries[f.key]
                used.add(f.key)
                allowed.append(f)
            else:
                open_findings.append(f)
        for key, reason in entries.items():
            if key not in used:
                stale.append({
                    "pass": p.PASS_ID,
                    "key": key,
                    "reason": reason,
                    "message": (
                        f"stale allowlist entry {key!r} matches no current "
                        "finding — delete it (suppressions die with the "
                        "code they excused)"
                    ),
                })
        per_pass[p.PASS_ID] = {
            "describe": p.DESCRIBE,
            "findings": sum(1 for f in findings if not f.allowed),
            "allowlisted": sum(1 for f in findings if f.allowed),
        }
    return {
        "findings": [f.to_json() for f in open_findings],
        "allowlisted": [f.to_json() for f in allowed],
        "stale_allowlist": stale,
        "passes": per_pass,
        "ok": not open_findings and not stale,
    }


def render_report(report: dict, as_json: bool = False) -> str:
    if as_json:
        return json.dumps(report, indent=2, sort_keys=True)
    lines = []
    for f in report["findings"]:
        lines.append(
            f"{f['file']}:{f['line']}: [{f['pass']}] {f['message']}\n"
            f"    key: {f['key']}"
        )
    for s in report["stale_allowlist"]:
        lines.append(f"[{s['pass']}] {s['message']}")
    total = len(report["findings"])
    stale = len(report["stale_allowlist"])
    lines.append(
        f"{total} finding(s), {stale} stale allowlist entr(ies), "
        f"{len(report['allowlisted'])} allowlisted"
    )
    return "\n".join(lines)
